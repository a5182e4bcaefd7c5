"""The renderer and the plain reference, at tiny sizes on the CPU."""

import math

import numpy as np
import pytest
import torch

import harness
import judge
import render
from reference import tracker as ref
from tiny import tiny_cell


def _render_numpy(k, height, width, rot, trans, waves, plane, sigmas, depth_scale):
    """The scene drawn with numpy alone, in float64: the renderer's twin."""
    cx, cy, fx, fy = k
    jj, ii = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    d_cam = np.stack([(jj - cx) / fx, (ii - cy) / fy, np.ones_like(jj)], axis=-1)
    a, b, z0 = plane
    n = np.array([-a, -b, 1.0])
    grays, depths = [], []
    for r, t, w in zip(rot, trans, waves):
        d = d_cam @ r.T
        lam = (z0 - n @ t) / (d @ n)
        pts = t + lam[..., None] * d
        tex = sum(amp * np.sin(2 * np.pi * (fx_i * pts[..., 0] + fy_i * pts[..., 1]) + ph) for fx_i, fy_i, ph, amp in w)
        spread = sigmas * np.sqrt(0.5 * np.sum(w[:, 3] ** 2))
        visible = (lam > 0.1) & (lam < 10.0)
        grays.append(np.where(visible, np.floor(np.clip(127.5 + 127.5 * tex / spread, 0, 255)), 0).astype(np.uint8))
        depths.append(np.where(visible, np.round(lam * depth_scale), 0).astype(np.int64))
    return np.stack(grays), np.stack(depths)


def test_torch_renderer_matches_numpy_at_60x80():
    _, cfg, traffic = tiny_cell("batch32_desk")
    lanes = render.draw_lanes(traffic, 2**31 + 11, 2)
    rot, trans = render.path(traffic, lanes[1])
    idx = [0, 5, 17]
    waves = np.stack([lanes[1].waves] * len(idx))
    scene = traffic["scene"]
    g, d = render.render(cfg["intrinsics"], 60, 80, torch.from_numpy(rot[idx]), torch.from_numpy(trans[idx]),
                         torch.from_numpy(waves), scene["plane"], scene["texture_sigmas"], cfg["depth_scale"])
    g_np, d_np = _render_numpy(cfg["intrinsics"], 60, 80, rot[idx], trans[idx], waves, scene["plane"],
                               scene["texture_sigmas"], cfg["depth_scale"])
    diff = np.abs(g.numpy().astype(int) - g_np.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-3  # a floor at an exact grey level may fall either side
    assert np.array_equal(d.numpy(), d_np)
    assert g.numpy().std() > 30 and d_np.min() > 0


def test_paths_close_their_loop_at_the_traffic_speed():
    for cell in ("live_xyz1_30hz", "batch32_desk", "batch32_xyz2"):
        c = harness.find_cell(harness.load_manifest(), cell)
        traffic = harness.load_json("traffic", c["traffic"])
        rot, trans = render.path(traffic, render.Lane(None, 0))
        rate = traffic["rate_hz"]
        step = np.linalg.norm(np.roll(trans, -1, axis=0) - trans, axis=1).mean()
        assert step * rate == pytest.approx(traffic["motion"]["translation_m_per_s"], rel=1e-9)
        angle = render._rotation_step(rot).mean()
        assert math.degrees(angle) * rate == pytest.approx(traffic["motion"]["rotation_deg_per_s"], rel=1e-6)
        # another starting frame is the same loop, in another order
        rot2, trans2 = render.path(traffic, render.Lane(None, 7))
        assert np.allclose(trans2, np.roll(trans, -7, axis=0)) and np.allclose(rot2, np.roll(rot, -7, axis=0))


def test_sequences_are_the_seeds():
    _, cfg, traffic = tiny_cell("batch32_desk")
    a = render.make_sequences(cfg, traffic, 5, torch.device("cpu"))
    b = render.make_sequences(cfg, traffic, 5, torch.device("cpu"))
    c = render.make_sequences(cfg, traffic, 6, torch.device("cpu"))
    assert a.grays.shape == (24, 3, 60, 80) and a.depths.dtype == np.uint16
    assert np.array_equal(a.grays, b.grays) and np.array_equal(a.depths, b.depths)
    assert not np.array_equal(a.grays, c.grays)


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    _, cfg, traffic = tiny_cell("live_xyz1_30hz")
    seqs = render.make_sequences(cfg, traffic, 3, torch.device("cpu"))
    return cfg, seqs, ref.Settings.from_config(cfg)


def _frame(seqs, f):
    return torch.from_numpy(seqs.depths[f, 0].astype(np.int32)), torch.from_numpy(seqs.grays[f, 0])


IDENTITY = (torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3))


def test_reference_against_itself(scene):
    cfg, seqs, s = scene
    kf = ref.keyframe(s, cfg["intrinsics"], *_frame(seqs, 0))
    assert [lv.xs.numel() for lv in kf][0] > 100
    first = ref.track(s, kf, _frame(seqs, 2)[1], IDENTITY)
    again = ref.track(s, ref.keyframe(s, cfg["intrinsics"], *_frame(seqs, 0)), _frame(seqs, 2)[1], IDENTITY)
    assert torch.equal(first.model[0], again.model[0]) and torch.equal(first.model[1], again.model[1])
    # the solved motion is the rendered one: keyframe -> frame = T_f^-1 T_0
    r0, t0 = seqs.rotations[0, 0], seqs.translations[0, 0]
    r2, t2 = seqs.rotations[2, 0], seqs.translations[2, 0]
    truth = r2.T @ (t0 - t2)
    assert not first.failed and np.linalg.norm(first.model[1].numpy() - truth) < 0.1 * np.linalg.norm(truth)
    # a frame against itself stays at rest and moves no pixel
    still = ref.track(s, kf, _frame(seqs, 0)[1], IDENTITY)
    assert float(torch.linalg.vector_norm(still.model[1])) < 1e-4 and still.flow < 1e-2


def test_reference_against_the_port_on_the_cpu(scene):
    """The reference and the program's plain CPU path agree at this size."""
    from visual_odometry_rs_tpu_torch.math.pose import Pose
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid as pyramid_ops

    import program

    cfg, seqs, s = scene
    config = program.tracker_config(cfg)
    depth, gray = _frame(seqs, 0)
    kf = tracker_mod.precompute_keyframe(config, program.intrinsics(cfg, "cpu"), depth,
                                         pyramid_ops.mean_pyramid(config.nb_levels, gray))
    rk = ref.keyframe(s, cfg["intrinsics"], depth, gray)
    for obs, lv in zip(kf.levels, rk):
        v = obs.valid
        assert torch.equal(obs.xs[v], lv.xs) and torch.equal(obs.ys[v], lv.ys)
        assert torch.equal(obs.idepth[v], lv.idepth) and torch.equal(obs.tmpl_vals[v], lv.tmpl)
        assert torch.allclose(obs.jacobians[v], lv.jac, rtol=1e-5, atol=1e-3)
    for f in (1, 3):
        img = _frame(seqs, f)[1]
        port = tracker_mod.track_frame(config, kf, pyramid_ops.mean_pyramid(config.nb_levels, img),
                                       Pose(*IDENTITY))
        mine = ref.track(s, rk, img, IDENTITY)
        assert torch.allclose(port.model.t, mine.model[1], atol=1e-5)
        assert torch.allclose(port.model.q, mine.model[0], atol=1e-5)
        assert float(port.flow) == pytest.approx(mine.flow, abs=1e-4)


def test_bfloat16_control_moves_the_poses(scene):
    cfg, seqs, s = scene
    kf = ref.keyframe(s, cfg["intrinsics"], *_frame(seqs, 0))
    samples, f32, bf16 = [], [], []
    for f in (1, 2, 3):
        img = _frame(seqs, f)[1]
        a, b = ref.track(s, kf, img, IDENTITY), ref.track(s, kf, img, IDENTITY, torch.bfloat16)
        f32.append(float(torch.linalg.vector_norm(a.model[1])))
        bf16.append(float(torch.linalg.vector_norm(a.model[1] - b.model[1])))
    assert min(bf16) > 1e-5 * max(f32)
    assert judge._angle(np.array([1.0, 0, 0, 0]), np.array([math.cos(0.05), math.sin(0.05), 0, 0])) == \
        pytest.approx(0.1)
