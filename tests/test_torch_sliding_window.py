"""The port's sliding window (``models/sliding_window.py``) and its
checkpoints against the JAX package, on the CPU.

A 64x80 sequence (3 levels, cap 256, about 2 px a frame) with a seeded
drift on its ground truth as the initialization; a window of 2 with the
coarse pose-only stage at level 1, so that every frame after the first
marginalizes one and a keyframe switches by frame 2.  The JAX window runs
once (its jitted solves, "auto" sampling: gather on the CPU); its state after frame 2 seeds
the checkpoint tests.  Tolerances, with the values measured on the CPU
beside them:

- Poses, port against JAX: ``atol=5e-4`` (measured 4.3e-7 before the
  first switch and up to 1.4e-6 after it).  A marginalization prior makes the camera
  system ill-conditioned in f32, so the packages'
  Cholesky factors round apart; over longer runs the LM decisions can then
  differ (ROADMAP C2), and the test stops after two switches and three
  marginalizations.
- ``marginalize_frame``: within ``1e-4`` of the largest entry (measured
  9.2e-8).
- A state carried across the packages by a checkpoint: bit-equal arrays.
  A resumed port window: bit-equal to the straight one.
- ``vors_refine --mode chunked`` (independent window solves, no sliding
  window) against the JAX CLI on ``tests/test_torch_refine.py``'s files and
  flags, with that file's tolerances (measured 1.0e-6); it sits here for
  the per-file time budget of the JAX compiles.
- ``BatchedSlidingWindow`` lanes against one-lane ``SlidingWindow`` runs:
  ``atol=1e-5`` (measured 1.1e-6: a product over two lanes is not always
  blocked like a product over one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.models import sliding_window as jsw
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.utils import checkpoint as jckpt
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.math.pose import Pose as TPose
from visual_odometry_rs_tpu_torch.models import sliding_window as tsw
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.parallel import mesh as tmesh
from visual_odometry_rs_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

H, W, FRAMES = 64, 80, 5
TWIST = [0.03, 0.01, 0.0, 0.0, 0.01, 0.0]
WINDOW = dict(window_size=2, max_iterations=5)
SPLIT = 2  # the checkpoint tests save after frame 2


def _sequence(seed=21, drift_seed=3):
    seq = tsyn.generate_sequence(nb_frames=FRAMES, height=H, width=W, seed=seed, twist_per_frame=TWIST)
    rng = np.random.default_rng(drift_seed)
    drift = [tpose.identity()]
    for _ in range(1, FRAMES):
        drift.append(tpose.compose(drift[-1], tse3.exp(torch.from_numpy((rng.normal(size=6) * 0.003)
                                                                        .astype(np.float32)))))
    return seq, [tpose.compose(p, d) for p, d in zip(seq.poses, drift)]


def _jpose(p):
    return JPose(jnp.asarray(p.q.numpy()), jnp.asarray(p.t.numpy()))


def _port(seq, **kw):
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)
    return tsw.SlidingWindow(config, seq.intrinsics, device="cpu", **WINDOW, **kw)


def _jax(seq):
    # the JAX package's default sampler ("auto") is gather on the CPU, and the
    # port's fingerprint stands for it
    config = jtracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)
    k = JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))
    return jsw.SlidingWindow(config, k, **WINDOW)


def _host_state(state):
    """A window state of numpy leaves, the per-slot lists flattened."""
    return jax.tree_util.tree_leaves({k: v for k, v in state.items()})


def _jax_state(j):
    """A JAX window's state as ``interop.window_state_to_numpy`` lays it out."""
    return {
        "kf_levels": jax.tree_util.tree_map(np.asarray, j.kf_levels), "kf_c2w": jax.tree_util.tree_map(np.asarray, j.kf_c2w),
        "idepth": np.asarray(j.idepth), "images": [np.asarray(x) for x in j.images],
        "images_coarse": [np.asarray(x) for x in j.images_coarse],
        "models": [jax.tree_util.tree_map(np.asarray, m) for m in j.models], "prior_H": np.asarray(j.prior_H),
        "prior_anchors": jax.tree_util.tree_map(np.asarray, j.prior_anchors),
        "frame_ids": np.array(j.frame_ids), "keyframe_switches": np.array(j.keyframe_switches),
        "_next_id": j._next_id,
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX window over the sequence (its outputs per frame, and its
    checkpoint after frame SPLIT) and the port's straight run."""
    root = tmp_path_factory.mktemp("window")
    seq, c2w = _sequence()
    j = _jax(seq)
    j.start(jnp.asarray(seq.depths[0]), jnp.asarray(seq.grays[0]), _jpose(c2w[0]))
    jax_out, jax_ckpt = [], str(root / "jax.npz")
    for f in range(1, FRAMES):
        ids, poses = j.add_frame(jnp.asarray(seq.depths[f]), jnp.asarray(seq.grays[f]), _jpose(c2w[f]))
        jax_out.append((list(ids), np.stack([np.asarray(p.t) for p in poses]),
                        np.stack([np.asarray(p.q) for p in poses]), j.keyframe_switches))
        if f == SPLIT:
            jckpt.save_sliding_window(jax_ckpt, j, {"tag": np.arange(3)})
            jax_state = _jax_state(j)
    port, port_out = _port(seq), []
    port.start(seq.depths[0], seq.grays[0], c2w[0])
    for f in range(1, FRAMES):
        ids, poses = port.add_frame(seq.depths[f], seq.grays[f], c2w[f])
        port_out.append((ids, torch.stack([p.t for p in poses]).numpy(), torch.stack([p.q for p in poses]).numpy(),
                         port.keyframe_switches))
    return dict(root=root, seq=seq, c2w=c2w, jax_out=jax_out, port_out=port_out, jax_ckpt=jax_ckpt,
                jax_state=jax_state, jax_window=j)


def _continue(sw, seq, c2w, first):
    out = []
    for f in range(first, FRAMES):
        ids, poses = sw.add_frame(seq.depths[f], seq.grays[f], c2w[f])
        out.append((ids, torch.stack([p.t for p in poses]).numpy(), torch.stack([p.q for p in poses]).numpy(),
                    sw.keyframe_switches))
    return out


def _same_frames(out, ref, atol):
    for (ids, t, q, switches), (rids, rt, rq, rswitches) in zip(out, ref):
        assert list(ids) == list(rids) and switches == rswitches
        np.testing.assert_allclose(t, rt, atol=atol)
        np.testing.assert_allclose(q, rq, atol=atol)


def test_marginalize_frame_matches_jax():
    rng = np.random.default_rng(0)
    for F, P, j in ((4, 6, 1), (3, 8, 2)):
        M = rng.normal(size=(F * P, F * P)).astype(np.float32)
        S = (M @ M.T + 0.5 * np.eye(F * P, dtype=np.float32)).reshape(F, P, F, P)
        ref = np.asarray(jax.jit(lambda s: jsw.marginalize_frame(s, j))(jnp.asarray(S)))
        got = tsw.marginalize_frame(torch.from_numpy(S), j).numpy()
        assert got.shape == ref.shape == (F - 1, 6, F - 1, 6)
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_adjoint_matches_jax():
    """``se3.adjoint`` (the prior's transport at a switch) against JAX's:
    ``atol=1e-6`` (measured 1.5e-8)."""
    from visual_odometry_rs_tpu.math import se3 as jse3

    rng = np.random.default_rng(1)
    xis = (rng.normal(size=(5, 6)) * 0.3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jse3.adjoint(jse3.exp(x)))(jnp.asarray(xis)))
    got = tse3.adjoint(tse3.exp(torch.from_numpy(xis))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sliding_window_matches_jax(run):
    """One keyframe switch and a marginalization a frame, against JAX."""
    assert run["jax_out"][-1][3] >= 1 and len(run["jax_out"][-1][0]) == 2
    _same_frames(run["port_out"], run["jax_out"], 5e-4)


def test_checkpoint_jax_to_port(run):
    """A JAX checkpoint loads into the port bit-equal (the caller's extra
    arrays too), and the port goes on within the tolerance of JAX."""
    seq, c2w = run["seq"], run["c2w"]
    sw = _port(seq)
    extra = tckpt.load_sliding_window(run["jax_ckpt"], sw)
    np.testing.assert_array_equal(extra["tag"], np.arange(3))
    for got, want in zip(_host_state(interop.window_state_to_numpy(sw)), _host_state(run["jax_state"])):
        np.testing.assert_array_equal(got, want)
    assert sw._next_id == SPLIT + 1
    _same_frames(_continue(sw, seq, c2w, SPLIT + 1), run["jax_out"][SPLIT:], 5e-4)


def test_checkpoint_port_to_jax_and_resume(run, tmp_path):
    """A port checkpoint loads into the JAX package's window bit-equal, and
    into a new port window from which the run goes on bit-equal to the
    straight one."""
    seq, c2w = run["seq"], run["c2w"]
    sw = _port(seq)
    sw.start(seq.depths[0], seq.grays[0], c2w[0])
    for f in range(1, SPLIT + 1):
        sw.add_frame(seq.depths[f], seq.grays[f], c2w[f])
    path = str(tmp_path / "port.npz")
    tckpt.save_sliding_window(path, sw)
    j = _jax(seq)
    jckpt.load_sliding_window(path, j)
    for got, want in zip(_host_state(_jax_state(j)), _host_state(interop.window_state_to_numpy(sw))):
        np.testing.assert_array_equal(got, want)
    resumed = _port(seq)
    tckpt.load_sliding_window(path, resumed)
    part = _continue(resumed, seq, c2w, SPLIT + 1)
    for (ids, t, q, sws), (rids, rt, rq, rsws) in zip(part, run["port_out"][SPLIT:]):
        assert ids == rids and sws == rsws
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(q, rq)
    other = tsw.SlidingWindow(ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=128),
                              seq.intrinsics, device="cpu", **WINDOW)
    with pytest.raises(tckpt.CheckpointMismatchError):
        tckpt.load_sliding_window(path, other)


def test_reset_policy_and_cloud(run):
    """``switch_transfer=False`` starts the window again at a switch; the
    keyframe cloud is finite and the retired clouds are collected."""
    seq, c2w = run["seq"], run["c2w"]
    sw = _port(seq, switch_transfer=False, collect_clouds=True)
    sw.start(seq.depths[0], seq.grays[0], c2w[0])
    out = _continue(sw, seq, c2w, 1)
    first_switch = next(i for i, o in enumerate(out) if o[3] >= 1)
    assert sw.keyframe_switches == len(sw.retired_clouds) >= 1
    after = out[first_switch + 1][0]
    assert len(after) == 2 and after[0] == first_switch + 1  # the switching frame keyframes a new window
    pts, inten = sw.keyframe_cloud()
    assert pts.shape[1] == 3 and len(pts) == len(inten) > 50 and np.isfinite(pts).all()


def test_batched_window_matches_per_lane(run, tmp_path):
    """Two lanes (the sequence and another seed) in lockstep against one-lane
    windows; a batched checkpoint loads into the JAX package's batched
    window bit-equal and resumes bit-equal in the port."""
    seq_a, c2w_a = run["seq"], run["c2w"]
    seq_b, c2w_b = _sequence(seed=22, drift_seed=4)
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)

    def batched():
        b = tsw.BatchedSlidingWindow(config, seq_a.intrinsics, device="cpu", **WINDOW)
        b.start(np.stack([seq_a.depths[0], seq_b.depths[0]]), np.stack([seq_a.grays[0], seq_b.grays[0]]),
                TPose(torch.stack([c2w_a[0].q, c2w_b[0].q]), torch.stack([c2w_a[0].t, c2w_b[0].t])))
        return b

    def step(b, f):
        return b.add_frame(np.stack([seq_a.depths[f], seq_b.depths[f]]), np.stack([seq_a.grays[f], seq_b.grays[f]]),
                           TPose(torch.stack([c2w_a[f].q, c2w_b[f].q]), torch.stack([c2w_a[f].t, c2w_b[f].t])))

    bsw = batched()
    lanes = [_port(seq_a), _port(seq_b)]
    for sw, seq, c2w in zip(lanes, (seq_a, seq_b), (c2w_a, c2w_b)):
        sw.start(seq.depths[0], seq.grays[0], c2w[0])
    path = str(tmp_path / "batch.npz")
    outs = []
    for f in range(1, FRAMES):
        ids, poses = step(bsw, f)
        outs.append((ids, poses))
        for b, (sw, seq, c2w) in enumerate(zip(lanes, (seq_a, seq_b), (c2w_a, c2w_b))):
            one_ids, one = sw.add_frame(seq.depths[f], seq.grays[f], c2w[f])
            assert list(ids[:, b]) == one_ids
            np.testing.assert_allclose(poses.t[b].numpy(), torch.stack([p.t for p in one]).numpy(), atol=1e-5)
            np.testing.assert_allclose(poses.q[b].numpy(), torch.stack([p.q for p in one]).numpy(), atol=1e-5)
        if f == SPLIT:
            tckpt.save_batched_window(path, bsw, {"tag": np.ones(2)})
    assert list(bsw.keyframe_switches) == [sw.keyframe_switches for sw in lanes] and bsw.keyframe_switches.min() >= 1
    jcfg = jtracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)
    jb = jsw.BatchedSlidingWindow(jcfg, JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq_a.intrinsics)), **WINDOW)
    jb.batch = 2
    assert np.array_equal(jckpt.load_batched_window(path, jb)["tag"], np.ones(2))
    resumed = tsw.BatchedSlidingWindow(config, seq_a.intrinsics, device="cpu", **WINDOW)
    tckpt.load_batched_window(path, resumed)
    jstate = {**_jax_state(jb), "kf_levels": jax.tree_util.tree_map(np.asarray, jb.kf_levels)}
    for got, want in zip(_host_state(jstate), _host_state(interop.window_state_to_numpy(resumed))):
        np.testing.assert_array_equal(got, want)
    for f in range(SPLIT + 1, FRAMES):
        ids, poses = step(resumed, f)
        np.testing.assert_array_equal(ids, outs[f - 1][0])
        np.testing.assert_array_equal(poses.t.numpy(), outs[f - 1][1].t.numpy())
        np.testing.assert_array_equal(poses.q.numpy(), outs[f - 1][1].q.numpy())


def test_vors_refine_chunked_matches_jax_cli(tmp_path):
    from test_torch_refine import FLAGS, _run, _write_sequence, jrefine, refine_against_jax, trefine

    seq, assoc, traj, drifted = _write_sequence(str(tmp_path), "a", 31, 5)
    argv = ["fr1", assoc, traj, "--cpu", "--mode", "chunked", *FLAGS]
    refine_against_jax(_run(jrefine.main, [*argv, "--interp", "gather"])[0], _run(trefine.main, argv)[0], seq,
                       drifted, False)


def test_batched_window_refusals(run):
    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)
    with pytest.raises(ValueError, match="switch_transfer"):
        tsw.BatchedSlidingWindow(config, run["seq"].intrinsics, device="cpu", switch_transfer=False)
    two = tmesh.make_mesh((2,), ("data",), devices=["cpu"] * 2)
    spread = tsw.BatchedSlidingWindow(config, run["seq"].intrinsics, device="cpu", mesh=two)
    seq = run["seq"]
    spread.start(np.stack([seq.depths[0]] * 3), np.stack([seq.grays[0]] * 3))
    ident = TPose(torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 3), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="do not split"):  # 3 lanes over 2 devices
        spread.add_frame(np.stack([seq.depths[1]] * 3), np.stack([seq.grays[1]] * 3), ident)
    with pytest.raises(ValueError, match="window_size"):
        tsw.SlidingWindow(config, run["seq"].intrinsics, window_size=1, device="cpu")
