"""Lanes over the devices of a mesh (``parallel/mesh.py``), on a mesh of
CPU devices: every data-parallel path against its run without a mesh,
**bit-equal per lane** (the lanes never talk to each other, and each
device's part runs the same code on its lanes).

- ``batch.make_sharded_step`` (``tests/test_parallel.py:78``): 4 lanes of
  two 48x64 sequences over 4 devices.
- ``batch.batched_track_sequence(mesh=)`` (``tests/test_parallel.py:202``,
  ``:687``): a kidnapped lane and a healthy one with a ring of 4 over 2
  devices (``tests/test_relocalize.py``'s scenes, 120x160), and 4 lanes at
  cadence 2 over 2 devices.
- ``photometric_ba.solve_window_batched(mesh=)`` and
  ``sliding_window.BatchedSlidingWindow(mesh=)``: 4 windows over 2
  devices; 2 sliding windows over 2 devices for 6 frames.
- ``vors_batch`` and ``vors_refine --batch`` with 2 devices faked
  (``tests/test_cli.py:134``): the JAX CLIs' stderr line, and the files of
  the run without a mesh.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from test_torch_refine import FLAGS as REFINE_FLAGS
from test_torch_refine import _write_sequence

from visual_odometry_rs_tpu_torch.cli import vors_batch, vors_refine
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.models import photometric_ba as tpba
from visual_odometry_rs_tpu_torch.models import sliding_window as tsw
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyramid
from visual_odometry_rs_tpu_torch.parallel import batch as tbatch
from visual_odometry_rs_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP = [0.09, 0.01, 0.005, 0.0, 0.06, 0.0]
SMALL = [0.01, 0.002, 0.001, 0.0, 0.005, 0.0]
KIDNAP = np.asarray([STEP] * 4 + [list(-4.0 * np.asarray(STEP))] + [SMALL, SMALL], np.float32)


def _mesh(n):
    return tmesh.make_mesh((n,), ("data",), devices=[CPU] * n)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, np.ndarray):
        return [torch.from_numpy(tree)]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y) or bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), (x, y)


def _clip(seqs, frames):
    d = np.stack([np.stack([s.depths[f] for s in seqs]) for f in frames])
    g = np.stack([np.stack([s.grays[f] for s in seqs]) for f in frames])
    return d, g


def test_shard_and_gather_round_trip():
    m = _mesh(2)
    tree = (torch.arange(8.0).reshape(4, 2), torch.tensor(3.0), None, np.arange(12).reshape(2, 6))
    parts = tmesh.shard_batch(tree, m)
    assert [p[0].tolist() for p in parts] == [[[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0], [6.0, 7.0]]]
    assert parts[1][1].item() == 3.0 and parts[1][2] is None and parts[1][3].tolist() == [[6, 7, 8, 9, 10, 11]]
    _assert_bit_equal(tmesh.gather_batch(parts, CPU), tree)
    assert [p[0].shape for p in tmesh.shard_batch((torch.zeros(3, 4, 5),), m, dim=1)] == [(3, 2, 5)] * 2
    assert len(tmesh.replicated(tree, m)) == 2
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_batch(torch.zeros(3, 2), m)


def test_sharded_step_matches_unsharded():
    seqs = [tsyn.generate_sequence(nb_frames=2, height=48, width=64, seed=s) for s in (0, 1)]
    config = ttracker.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256)
    lanes = [seqs[i % 2] for i in range(4)]
    (d0, d1), (g0, g1) = _clip(lanes, (0, 1))
    state = tbatch.batched_init_state(config, seqs[0].intrinsics, d0, g0, device="cpu")
    ref = tbatch.batched_track_step(config, seqs[0].intrinsics, state, d1, g1)
    step = tbatch.make_sharded_step(config, seqs[0].intrinsics, _mesh(4))
    _assert_bit_equal(step(state, d1, g1), ref)


def test_batched_sequence_with_ring_and_kidnap_over_two_devices():
    kid = tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=120, width=160, seed=23, twist_per_frame=KIDNAP)
    ok = tsyn.generate_sequence(nb_frames=len(KIDNAP) + 1, height=120, width=160, seed=24, motion_scale=0.012)
    config = ttracker.TrackerConfig(height=120, width=160, nb_levels=3, candidate_cap=1024, relocalize_window=4,
                                    relocalize_energy_accept=150.0)
    (d0,), (g0,) = _clip([kid, ok], (0,))
    cd, cg = _clip([kid, ok], range(1, len(KIDNAP) + 1))
    state = tbatch.batched_init_state(config, kid.intrinsics, d0, g0, device="cpu")
    ring = tbatch.batched_init_ring(config, state)
    ref = tbatch.batched_track_sequence(config, kid.intrinsics, state, cd, cg, reloc_ring=ring, return_pending=True)
    got = tbatch.batched_track_sequence(config, kid.intrinsics, state, cd, cg, reloc_ring=ring, return_pending=True,
                                        mesh=_mesh(2))
    _assert_bit_equal(got, ref)
    relocalized = got[1][1].relocalized.numpy()
    assert relocalized[:, 0].any() and not relocalized[:, 1].any()


def test_batched_sequence_at_cadence_two_over_two_devices():
    seqs = [tsyn.generate_sequence(nb_frames=5, height=48, width=64, seed=30 + s,
                                   twist_per_frame=[0.02 + 0.01 * s, 0.01, 0.0, 0.0, 0.004, 0.0]) for s in range(4)]
    config = ttracker.TrackerConfig(height=48, width=64, nb_levels=3, candidate_cap=256,
                                    warm_start="constant_velocity")
    (d0,), (g0,) = _clip(seqs, (0,))
    cd, cg = _clip(seqs, range(1, 5))
    state = tbatch.batched_init_state(config, seqs[0].intrinsics, d0, g0, device="cpu")
    kwargs = dict(switch_cadence=2, frame_offset=0, return_pending=True, return_prev=True)
    ref = tbatch.batched_track_sequence(config, seqs[0].intrinsics, state, cd, cg, **kwargs)
    _assert_bit_equal(tbatch.batched_track_sequence(config, seqs[0].intrinsics, state, cd, cg, mesh=_mesh(2),
                                                    **kwargs), ref)
    assert ref[1][1].switched.any()


def _windows(B=4, h=48, w=64, F=3):
    config = ttracker.TrackerConfig(height=h, width=w, nb_levels=2, candidate_cap=128)
    wins = []
    for b in range(B):
        seq = tsyn.generate_sequence(nb_frames=F, height=h, width=w, seed=40 + b, motion_scale=0.02)
        kf = ttracker.precompute_keyframe(config, seq.intrinsics, torch.from_numpy(seq.depths[0].astype(np.int32)),
                                          tpyramid.mean_pyramid(2, torch.from_numpy(seq.grays[0])))
        rng = np.random.default_rng(b)
        xis = (rng.normal(size=(F, 6)) * 3e-3).astype(np.float32)
        xis[0] = 0.0
        rel = [tpose.compose(tpose.compose(tpose.inverse(p), seq.poses[0]), tse3.exp(torch.from_numpy(x)))
               for p, x in zip(seq.poses, xis)]
        poses = Pose(torch.stack([p.q for p in rel]), torch.stack([p.t for p in rel]))
        images = torch.from_numpy(np.stack(seq.grays).astype(np.float32))
        wins.append(tpba.window_from_tracking(config, seq.intrinsics, kf.levels, images, poses))
    return tpba.stack_windows(wins)


def test_window_batched_over_two_devices():
    wins = _windows()
    B, F = wins.poses.q.shape[:2]
    Hp = torch.zeros((B, F, 6, F, 6))
    Hp[1, 1, :, 1, :] = 50.0 * torch.eye(6)
    opts = dict(max_iterations=6, brightness=True, robust_delta=10.0)
    ref = tpba.solve_window_batched(wins, pose_prior=(Hp, wins.poses), **opts)
    _assert_bit_equal(tpba.solve_window_batched(wins, _mesh(2), pose_prior=(Hp, wins.poses), **opts), ref)
    _assert_bit_equal(tpba.solve_window_batched(wins, _mesh(4), max_iterations=4),
                      tpba.solve_window_batched(wins, max_iterations=4))


def test_batched_sliding_window_over_two_devices():
    seqs = [tsyn.generate_sequence(nb_frames=7, height=48, width=64, seed=50 + s, motion_scale=0.02) for s in (0, 1)]
    config = ttracker.TrackerConfig(height=48, width=64, nb_levels=2, candidate_cap=128)
    runs = []
    for mesh in (None, _mesh(2)):
        bsw = tsw.BatchedSlidingWindow(config, seqs[0].intrinsics, window_size=3, max_iterations=4, coarse_level=1,
                                       device="cpu", mesh=mesh)
        (d0,), (g0,) = _clip(seqs, (0,))
        bsw.start(d0, g0)
        outs = []
        for f in range(1, 7):
            (d,), (g,) = _clip(seqs, (f,))
            c2w = Pose(torch.stack([s.poses[f].q for s in seqs]), torch.stack([s.poses[f].t for s in seqs]))
            ids, refined = bsw.add_frame(d, g, c2w)
            outs.append((ids, refined))
        runs.append((outs, bsw.prior_H, bsw.idepth, bsw.keyframe_switches))
    _assert_bit_equal(runs[1], runs[0])
    assert runs[1][0][-1][0].shape == (3, 2)


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _fake_two_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "local_devices", lambda device_type="cuda": [CPU, CPU])


def test_vors_batch_spreads_lanes_over_faked_devices(tmp_path, monkeypatch):
    seqs = [tsyn.generate_sequence(nb_frames=4, height=48, width=64, seed=60 + i) for i in range(4)]
    assocs = [ttum.write_sequence(str(tmp_path / f"s{i}"), s.grays, s.depths, s.timestamps)
              for i, s in enumerate(seqs)]
    args = ["fr1", *assocs, "--cpu", "--nb-levels", "3", "--candidate-cap", "256", "--chunk", "2"]
    rc, _, err = _cli(vors_batch.main, [*args, "--out-dir", str(tmp_path / "one")])
    assert rc == 0 and "sharding" not in err
    _fake_two_devices(monkeypatch)
    rc, _, err = _cli(vors_batch.main, [*args, "--out-dir", str(tmp_path / "two")])
    assert rc == 0 and "sharding batch of 4 over 2 devices" in err
    for i in range(4):
        name = f"s{i}.txt"
        assert open(tmp_path / "two" / name).read() == open(tmp_path / "one" / name).read()
    rc, _, err = _cli(vors_batch.main, ["fr1", *assocs[:3], "--cpu", "--nb-levels", "3", "--candidate-cap", "256",
                                        "--out-dir", str(tmp_path / "odd")])
    assert rc == 0 and "sharding" not in err  # 3 lanes do not split over 2 devices


def test_vors_refine_batch_spreads_lanes_over_faked_devices(tmp_path, monkeypatch):
    pairs = []
    for i in range(2):
        _, assoc, traj, _ = _write_sequence(str(tmp_path), f"r{i}", 70 + i, 5 + i)
        pairs += [assoc, traj]
    args = ["fr1", *pairs, "--cpu", "--batch", *REFINE_FLAGS]
    rc, _, err = _cli(vors_refine.main, [*args, "--out-dir", str(tmp_path / "one")])
    assert rc == 0 and "sharding" not in err
    _fake_two_devices(monkeypatch)
    rc, _, err = _cli(vors_refine.main, [*args, "--out-dir", str(tmp_path / "two")])
    assert rc == 0 and "sharding 2 lanes over 2 devices" in err
    names = sorted(os.listdir(tmp_path / "one"))
    assert names and names == sorted(os.listdir(tmp_path / "two"))
    for name in names:
        assert open(tmp_path / "two" / name).read() == open(tmp_path / "one" / name).read()
