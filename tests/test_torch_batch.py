"""The port's batched tracker (``parallel/batch.py``, ``cli/vors_batch.py``)
against the JAX package, and its own invariants.

Scenario (``tests/test_parallel.py::test_batched_switch_cadence``): B = 4
lanes moving 0.02/0.04/0.06/0.08 m per frame, F = 6 frames at 48x64, 3
levels, cap 256, ``flow_threshold`` 0.5.  The port starts from the JAX
package's initial state (``interop.track_state_from_numpy``).

Tolerances against the JAX package:
- ``batched_init_state``: as ``tests/test_torch_tracker.py``: ``xs``, ``ys``,
  ``valid``, ``template`` and the intrinsics equal; ``idepth``,
  ``tmpl_vals`` ``rtol=1e-6``; Jacobians ``rtol=1e-6`` plus ``atol`` 1e-6 of
  their largest entry.
- ``batched_track_sequence`` at cadence 1 and 3: the (F, B) ``switched`` and
  ``failed`` patterns equal; poses ``atol=5e-4`` (t, m) and ``5e-4`` (q),
  tighter than the 5e-3 of ``test_torch_tracker.py`` because the keyframes
  are bit-equal here (measured: 8e-5 m); the flow ``atol=1e-3`` px.
  ``nb_iters`` is not held equal: both packages sum the normal equations
  in another order, and in the tail of a solve, where an iteration moves
  the energy by about ``energy_tol``, that flips the continue decision (72
  per-level counts differ in 20 at cadence 1, by up to 9).  The test holds
  that at least 60% are equal.
Port-only checks are bit-equal (the CPU path is deterministic).
"""

import io
from contextlib import redirect_stderr
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.parallel import batch as jbatch
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.cli import vors_batch
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr
from visual_odometry_rs_tpu_torch.parallel import batch as tbatch

torch.set_num_threads(1)

B, F, H, W = 4, 6, 48, 64
MAGS = (0.02, 0.04, 0.06, 0.08)
KW = dict(height=H, width=W, nb_levels=3, candidate_cap=256, flow_threshold=0.5)
CONFIG = ttracker.TrackerConfig(**KW)
KF_FIELDS = ("template", "xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")


@pytest.fixture(scope="module")
def scene():
    seqs = [
        tsyn.generate_sequence(
            nb_frames=F + 1, height=H, width=W, seed=10 + i, twist_per_frame=[m, 0.0, 0.0, 0.0, 0.0, 0.0]
        )
        for i, m in enumerate(MAGS)
    ]
    return SimpleNamespace(
        intrinsics=seqs[0].intrinsics,
        d0=np.stack([s.depths[0] for s in seqs]), g0=np.stack([s.grays[0] for s in seqs]),
        cd=np.stack([np.stack([s.depths[f] for s in seqs]) for f in range(1, F + 1)]),
        cg=np.stack([np.stack([s.grays[f] for s in seqs]) for f in range(1, F + 1)]),
    )


@pytest.fixture(scope="module")
def jax_runs(scene):
    """The JAX package's initial state and its runs at cadence 1 and 3, as numpy."""
    config = jtracker.TrackerConfig(**KW)
    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in scene.intrinsics))
    state0 = jax.jit(lambda d, g: jbatch.batched_init_state(config, intr, d, g))(
        jnp.asarray(scene.d0), jnp.asarray(scene.g0)
    )
    runs = {}
    for cadence in (1, 3):
        runs[cadence] = jax.jit(
            lambda s, dd, gg, k=cadence: jbatch.batched_track_sequence(config, intr, s, dd, gg, switch_cadence=k)
        )(state0, jnp.asarray(scene.cd), jnp.asarray(scene.cg))
    return jax.tree_util.tree_map(np.asarray, (state0, runs))


@pytest.fixture(scope="module")
def port_runs(scene, jax_runs):
    """The port from the JAX initial state, at cadence 1 and 3."""
    start = interop.track_state_from_numpy(jax_runs[0])
    return start, {
        k: tbatch.batched_track_sequence(CONFIG, scene.intrinsics, start, scene.cd, scene.cg, switch_cadence=k)
        for k in (1, 3)
    }


def _assert_keyframes_equal(a, b):
    for la, lb in zip(a.levels, b.levels):
        for f in KF_FIELDS:
            assert torch.equal(getattr(la, f), getattr(lb, f)), f


def _assert_states_equal(a, b):
    _assert_keyframes_equal(a.kf, b.kf)
    for pa, pb in ((a.keyframe_pose, b.keyframe_pose), (a.current_pose, b.current_pose)):
        assert torch.equal(pa.q, pb.q) and torch.equal(pa.t, pb.t)


def _assert_outputs_equal(a, b):
    (pa, da), (pb, db) = a, b
    assert torch.equal(pa.q, pb.q) and torch.equal(pa.t, pb.t)
    for x, y in zip(da, db):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("lvl", range(3))
def test_batched_init_state_matches_jax(scene, jax_runs, lvl):
    out = interop.track_state_to_numpy(
        tbatch.batched_init_state(CONFIG, scene.intrinsics, scene.d0, scene.g0, device="cpu")
    )
    ref = jax_runs[0]
    o, r = out.kf.levels[lvl], ref.kf.levels[lvl]
    assert r.valid.all(axis=-1).any()  # a lane with more candidates than the cap
    for f in ("xs", "ys", "valid", "template"):
        np.testing.assert_array_equal(getattr(o, f), getattr(r, f), err_msg=f)
    for a, b in zip(o.intrinsics, r.intrinsics):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(o.idepth, r.idepth, rtol=1e-6)
    np.testing.assert_allclose(o.tmpl_vals, r.tmpl_vals, rtol=1e-6)
    np.testing.assert_allclose(o.jacobians, r.jacobians, rtol=1e-6, atol=1e-6 * np.abs(r.jacobians).max())
    for p, q in ((out.keyframe_pose, ref.keyframe_pose), (out.current_pose, ref.current_pose)):
        np.testing.assert_array_equal(p.q, q.q)
        np.testing.assert_array_equal(p.t, q.t)


@pytest.mark.parametrize("cadence", [1, 3])
def test_batched_track_sequence_matches_jax(jax_runs, port_runs, cadence):
    final, (poses, diags) = port_runs[1][cadence]
    ref_final, (ref_poses, ref_diags) = jax_runs[1][cadence]
    switched = diags.switched.numpy()
    np.testing.assert_array_equal(switched, ref_diags.switched)
    np.testing.assert_array_equal(diags.failed.numpy(), ref_diags.failed)
    assert not diags.relocalized.any()
    assert switched.any(axis=1).sum() >= 2  # lanes switch on different frames
    if cadence == 3:
        assert all(f % 3 == 2 for f in np.nonzero(switched.any(axis=1))[0])
    np.testing.assert_allclose(poses.t.numpy(), ref_poses.t, atol=5e-4)
    np.testing.assert_allclose(poses.q.numpy(), ref_poses.q, atol=5e-4)
    np.testing.assert_allclose(diags.flow.numpy(), ref_diags.flow, atol=1e-3)
    iters = diags.nb_iters.numpy()
    assert iters.shape == ref_diags.nb_iters.shape == (F, B, 3) and (iters >= 1).all()
    assert (iters == ref_diags.nb_iters).mean() >= 0.6
    out = interop.track_state_to_numpy(final)
    np.testing.assert_allclose(out.current_pose.t, ref_final.current_pose.t, atol=5e-4)
    np.testing.assert_allclose(out.keyframe_pose.t, ref_final.keyframe_pose.t, atol=5e-4)
    for o, r in zip(out.kf.levels, ref_final.kf.levels):  # the same keyframe images
        np.testing.assert_array_equal(o.template, r.template)


def test_cadence1_is_bit_equal_to_the_streaming_tracker(scene):
    """Per lane, the batched tracker at cadence 1 is the port's streaming
    ``Tracker`` (bucketing off), bit for bit."""
    state = tbatch.batched_init_state(CONFIG, scene.intrinsics, scene.d0, scene.g0, device="cpu")
    _, (poses, diags) = tbatch.batched_track_sequence(CONFIG, scene.intrinsics, state, scene.cd, scene.cg)
    for b in range(B):
        trk = ttracker.init_tracker(CONFIG, scene.intrinsics, 0.0, scene.d0[b], 0.0, scene.g0[b], device="cpu")
        for f in range(F):
            switches = trk.keyframe_switches
            trk.track(float(f + 1), scene.cd[f, b], float(f + 1), scene.cg[f, b])
            pose = trk.current_frame()[1]
            assert torch.equal(pose.q, poses.q[f, b]) and torch.equal(pose.t, poses.t[f, b]), (f, b)
            assert trk.keyframe_switches - switches == int(diags.switched[f, b])
            assert list(trk.last_nb_iters) == diags.nb_iters[f, b].tolist()
            assert trk.last_flow == float(diags.flow[f, b])


def test_track_sequence_is_one_lane(scene, port_runs):
    """``track_sequence`` of lane 2 alone gives lane 2 of the batch."""
    start, runs = port_runs
    lane = tbatch._map_state(lambda x: x[2], start)
    final, (poses, diags) = tbatch.track_sequence(CONFIG, scene.intrinsics, lane, scene.cd[:, 2], scene.cg[:, 2])
    ref_final, (ref_poses, ref_diags) = runs[1]
    _assert_states_equal(final, tbatch._map_state(lambda x: x[2], ref_final))
    _assert_outputs_equal((poses, diags), (Pose(ref_poses.q[:, 2], ref_poses.t[:, 2]),
                                           tbatch.StepDiagnostics(*(x[:, 2] for x in ref_diags))))


def test_chunked_carry_equals_one_run(scene, port_runs):
    """Clips of 2 frames at cadence 3, carrying ``pending0`` and
    ``frame_offset``: the same results as one clip of 6."""
    start, runs = port_runs
    state, pending, outs = start, None, []
    for first in range(0, F, 2):
        state, out, pending = tbatch.batched_track_sequence(
            CONFIG, scene.intrinsics, state, scene.cd[first:first + 2], scene.cg[first:first + 2],
            switch_cadence=3, pending0=pending, frame_offset=first, return_pending=True,
        )
        outs.append(out)
    ref_final, (ref_poses, ref_diags) = runs[3]
    _assert_states_equal(state, ref_final)
    joined = (Pose(*(torch.cat([o[0][i] for o in outs]) for i in range(2))),
              tbatch.StepDiagnostics(*(torch.cat([o[1][i] for o in outs]) for i in range(5))))
    _assert_outputs_equal(joined, (ref_poses, ref_diags))


def test_constant_velocity_chunked_carry_equals_one_run(scene, port_runs):
    start, _ = port_runs
    config = ttracker.TrackerConfig(**KW, warm_start="constant_velocity")
    ref_final, ref_out, ref_prev = tbatch.batched_track_sequence(
        config, scene.intrinsics, start, scene.cd, scene.cg, return_prev=True
    )
    state, prev, outs = start, None, []
    for first in (0, 3):
        state, out, prev = tbatch.batched_track_sequence(
            config, scene.intrinsics, state, scene.cd[first:first + 3], scene.cg[first:first + 3],
            frame_offset=first, prev_pose0=prev, return_prev=True,
        )
        outs.append(out)
    _assert_states_equal(state, ref_final)
    assert torch.equal(prev.q, ref_prev.q) and torch.equal(prev.t, ref_prev.t)
    assert torch.equal(torch.cat([o[0].t for o in outs]), ref_out[0].t)
    # the velocity prior moves the warm start: not the constant-position run
    _, (cp_poses, _) = tbatch.batched_track_sequence(CONFIG, scene.intrinsics, start, scene.cd, scene.cg)
    assert not torch.equal(cp_poses.t, ref_out[0].t)


def test_switch_subbatch_changes_nothing(scene, port_runs):
    start, runs = port_runs
    for k in (2, -1):
        final, out = tbatch.batched_track_sequence(
            CONFIG, scene.intrinsics, start, scene.cd, scene.cg, switch_subbatch=k
        )
        _assert_states_equal(final, runs[1][0])
        _assert_outputs_equal(out, runs[1][1])


def test_batched_track_step_matches_track_step_per_lane(scene, port_runs):
    """The select form (precompute every frame) over the lane axis against
    ``track_step`` lane by lane, for two frames."""
    start, _ = port_runs
    state = start
    lanes = [tbatch._map_state(lambda x, b=b: x[b], start) for b in range(B)]
    for f in range(2):
        state, diags = tbatch.batched_track_step(CONFIG, scene.intrinsics, state, scene.cd[f], scene.cg[f])
        for b in range(B):
            lanes[b], lane_diags = tbatch.track_step(CONFIG, scene.intrinsics, lanes[b], scene.cd[f, b], scene.cg[f, b])
            _assert_states_equal(lanes[b], tbatch._map_state(lambda x: x[b], state))
            for x, y in zip(lane_diags, diags):
                assert torch.equal(x, y[b])
    assert diags.switched.any()


def test_batched_precompute_is_bit_equal_to_single_lanes(scene):
    kf = ttracker.precompute_keyframe(
        CONFIG, scene.intrinsics, torch.from_numpy(scene.d0.astype(np.int32)),
        tpyr.mean_pyramid(3, torch.from_numpy(scene.g0)),
    )
    for b in range(B):
        one = ttracker.precompute_keyframe(
            CONFIG, scene.intrinsics, torch.from_numpy(scene.d0[b].astype(np.int32)),
            tpyr.mean_pyramid(3, torch.from_numpy(scene.g0[b])),
        )
        _assert_keyframes_equal(ttracker.map_keyframe(lambda x: x[b], kf), one)


def test_track_state_interop_roundtrip(jax_runs):
    state = interop.track_state_from_numpy(jax_runs[0])
    back = interop.track_state_from_numpy(interop.track_state_to_numpy(state))
    _assert_states_equal(state, back)
    bad = jax_runs[0].kf.levels[0].intrinsics
    levels = list(jax_runs[0].kf.levels)
    levels[0] = levels[0]._replace(intrinsics=bad._replace(cx=bad.cx + np.arange(B, dtype=np.float32)))
    with pytest.raises(ValueError, match="disagree"):
        interop.track_state_from_numpy(jax_runs[0]._replace(kf=jax_runs[0].kf._replace(levels=tuple(levels))))


def test_outputs_to_numpy_reads_everything(port_runs):
    _, (poses, diags) = port_runs[1][3]
    q, t, host = tbatch.outputs_to_numpy(poses, diags)
    np.testing.assert_array_equal(q, poses.q.numpy())
    np.testing.assert_array_equal(t, poses.t.numpy())
    for x, y in zip(host, diags):
        np.testing.assert_array_equal(x, y.numpy())


def test_vors_batch_cpu(tmp_path):
    """Two sequences of different lengths: one trajectory file each, one line
    per tracked frame, poses as the library call (clips of 2 frames)."""
    seqs = [tsyn.generate_sequence(nb_frames=n, height=H, width=W, seed=20 + n,
                                   twist_per_frame=[0.04, 0.0, 0.0, 0.0, 0.0, 0.0]) for n in (5, 3)]
    assocs = [ttum.write_sequence(str(tmp_path / name), s.grays, s.depths, s.timestamps)
              for name, s in zip(("seqA", "seqB"), seqs)]
    out_dir = tmp_path / "out"
    flags = ["--nb-levels", "3", "--candidate-cap", "256", "--chunk", "2"]
    with redirect_stderr(io.StringIO()):
        assert vors_batch.main(["fr1", *assocs, "--out-dir", str(out_dir), "--cpu", *flags]) == 0
    lines = [(out_dir / f"{name}.txt").read_text().splitlines() for name in ("seqA", "seqB")]
    assert [len(x) for x in lines] == [4, 2]

    config = ttracker.TrackerConfig(height=H, width=W, nb_levels=3, candidate_cap=256)
    intr = ttum.scaled_intrinsics("fr1", H, W)
    state = tbatch.batched_init_state(config, intr, np.stack([s.depths[0] for s in seqs]),
                                      np.stack([s.grays[0] for s in seqs]), device="cpu")
    # a finished lane repeats its last frame
    frames = [np.minimum(np.arange(1, 5), len(s.grays) - 1) for s in seqs]
    clip_d = np.stack([np.stack([s.depths[i[f]] for s, i in zip(seqs, frames)]) for f in range(4)])
    clip_g = np.stack([np.stack([s.grays[i[f]] for s, i in zip(seqs, frames)]) for f in range(4)])
    _, (poses, diags) = tbatch.batched_track_sequence(config, intr, state, clip_d, clip_g)
    assert diags.switched.any()
    for b, assoc in enumerate(assocs):
        stamps = [a.depth_timestamp for a in ttum.load_associations(assoc)]
        for f, line in enumerate(lines[b]):
            ref = ttum.Frame(timestamp=stamps[f + 1], pose=Pose(poses.q[f, b], poses.t[f, b]))
            assert line == ref.to_string()


def test_vors_batch_refuses_what_is_not_ported(tmp_path):
    """What the batched tracker refuses, as the JAX package does: a ring
    without a window and the host-recursion ``dso`` selector; the sharded
    step (ROADMAP A12) raises; the CLI exits 1 on a missing file, also for
    ``--save-state``/``--resume``, which are ported."""
    args = ["fr1", "/nonexistent/associations.txt", "--out-dir", str(tmp_path), "--cpu"]
    with redirect_stderr(io.StringIO()) as err:
        for flag in ([], ["--save-state", "x.npz"], ["--resume", "x.npz"]):
            assert vors_batch.main([*args, *flag]) == 1
    assert "Cannot read associations" in err.getvalue() and "ROADMAP" not in err.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            vors_batch.main(args[:-1])
    with pytest.raises(ValueError, match="relocalize_window"):
        tbatch.batched_track_sequence(CONFIG, None, None, None, None, reloc_ring=object())
    with pytest.raises(ValueError, match="relocalize_window"):
        tbatch.batched_init_ring(CONFIG, None)
    dso_config = ttracker.TrackerConfig(**KW, candidate_selector="dso")
    with pytest.raises(ValueError, match="dso"):
        tbatch.batched_track_sequence(dso_config, None, None, None, None)
    with pytest.raises(NotImplementedError, match="A12"):
        tbatch.make_sharded_step(CONFIG, None, None)


def test_vors_batch_output_names_are_unique():
    names = vors_batch._unique_names(["runs/a/assoc.txt", "runs/a/other.txt", "runs/b/assoc.txt", "runs/a/x.txt"])
    assert names == ["a.txt", "a.1.txt", "b.txt", "a.2.txt"]
