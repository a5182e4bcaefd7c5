"""The port's checkpoints (``utils/checkpoint.py``) against the JAX package's.

A checkpoint written by either package resumes in the other:
- the fingerprint strings are equal for equal configurations (five of them),
  for the tracker and for the batch;
- the leaves are in ``jax.tree_util.tree_leaves`` order, with the JAX
  package's shapes and dtypes, for the tracker and the batched state;
- streaming, 120x160, 3 levels, cap 1024, bucketing on, with and without the
  velocity carry: one package tracks 4 frames and saves, the other loads the
  file and tracks 3 more, against the writer resuming its own file.  Poses
  within ``atol=5e-4`` (m and quaternion units): the keyframe comes from the
  file, bit-equal in both, so only the order of the solver's sums differs
  (``tests/test_torch_options.py`` holds ``track_frame`` to the same);
- batched, 2 lanes, cadence 2, velocity carry: a clip of 3 frames, a save,
  and the next clip in the other package.  The switched and failed patterns
  equal, poses within ``atol=5e-4``, ``tests/test_torch_batch.py``'s
  tolerance.
Port-only checks (every ``CheckpointMismatchError``, 64-bit leaves) are
exact.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.dataset import synthetic as jsyn
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.parallel import batch as jbatch
from visual_odometry_rs_tpu.utils import checkpoint as jckpt
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.parallel import batch as tbatch
from visual_odometry_rs_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

H, W = 120, 160
KW = dict(height=H, width=W, nb_levels=3, candidate_cap=1024, bucket_candidates=True)
SAVED_AT, RESUMED = 4, 3  # frames tracked before the save, and after it
ATOL = 5e-4

CONFIGS = {
    "defaults": {},
    "huber_brightness": dict(robust_delta=10.0, brightness_model=True),
    "dso_fixed": dict(candidate_selector="dso_fixed", dso_target=300, dso_block_size=3, dso_threshold_coef_a=0.2),
    "velocity_budgets": dict(warm_start="constant_velocity", level_max_iterations=(10, 8, 6)),
    "ring": dict(relocalize_window=4, relocalize_energy_accept=400.0),
}


@pytest.fixture(scope="module")
def seq():
    return jsyn.generate_sequence(
        nb_frames=SAVED_AT + RESUMED + 1, height=H, width=W, seed=1,
        twist_per_frame=[0.03, 0.0, 0.0, 0.0, 0.003, 0.0],
    )


def _frame(seq, f):
    return float(seq.timestamps[f]), seq.depths[f], float(seq.timestamps[f]), seq.grays[f]


def _jax_tracker(seq, **options):
    config = jtracker.TrackerConfig(**KW, **options)
    ts, d, its, g = _frame(seq, 0)
    return jtracker.init_tracker(config, seq.intrinsics, ts, jnp.asarray(d), its, jnp.asarray(g))


def _port_tracker(seq, **options):
    config = ttracker.TrackerConfig(**KW, **options)
    return ttracker.init_tracker(config, interop.intrinsics_from_numpy(seq.intrinsics), *_frame(seq, 0),
                                 device="cpu")


def _track(trk, seq, frames, as_array):
    """Tracks ``frames``; the camera poses as (len, 7) numpy [q, t]."""
    out = []
    for f in frames:
        ts, d, its, g = _frame(seq, f)
        trk.track(ts, as_array(d), its, as_array(g))
        pose = trk.current_frame()[1]
        out.append(np.concatenate([np.asarray(pose.q), np.asarray(pose.t)]))
    return np.stack(out)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fingerprints_equal_jax(seq, name):
    jconfig = jtracker.TrackerConfig(**KW, **CONFIGS[name])
    tconfig = ttracker.TrackerConfig(**KW, **CONFIGS[name])
    tintr = interop.intrinsics_from_numpy(seq.intrinsics)
    expected = jckpt.config_fingerprint(jconfig, seq.intrinsics)
    assert tckpt.config_fingerprint(tconfig, tintr) == expected
    assert tckpt.config_fingerprint(tconfig) == jckpt.config_fingerprint(jconfig)
    assert tckpt.batch_fingerprint(tconfig, tintr, 4) == jckpt.batch_fingerprint(jconfig, seq.intrinsics, 4)
    # the DSO thinning seed exists in the port alone: a non-default one changes the hash
    assert tckpt.config_fingerprint(dataclasses.replace(tconfig, dso_seed=7), tintr) != expected


def _leaf_signature(leaves):
    return [(tuple(np.shape(x)), np.asarray(x).dtype) for x in leaves]


def _file_leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]


def test_tracker_leaf_order_is_jax(seq, tmp_path):
    """The port's tracker checkpoint has the leaves of the JAX package's
    tracker state, in its order, with its shapes and dtypes, and values
    within the trackers' agreement (the poses to ``ATOL``)."""
    options = dict(warm_start="constant_velocity")
    jtrk, ttrk = _jax_tracker(seq, **options), _port_tracker(seq, **options)
    for trk, as_array in ((jtrk, jnp.asarray), (ttrk, np.asarray)):
        _track(trk, seq, range(1, 3), as_array)
    path = str(tmp_path / "tracker.npz")
    tckpt.save_tracker(path, ttrk)
    ref = jax.tree_util.tree_leaves({
        "keyframe_data": jtrk.keyframe_data, "keyframe_pose": jtrk.keyframe_pose,
        "current_pose": jtrk.current_pose, "prev_pose": jtrk.prev_pose,
    })
    out = _file_leaves(path)
    assert _leaf_signature(out) == _leaf_signature(ref)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=ATOL)
        else:
            np.testing.assert_array_equal(o, r)


@pytest.fixture(scope="module")
def lanes():
    """Two lanes of different motion, 48x64; frames 0..6."""
    seqs = [
        jsyn.generate_sequence(nb_frames=7, height=48, width=64, seed=20 + i, twist_per_frame=tw)
        for i, tw in enumerate(([0.04, 0.0, 0.0, 0.0, 0.002, 0.0], [0.0, 0.03, 0.02, 0.0, 0.0, 0.002]))
    ]

    def frames(f):
        return np.stack([s.depths[f] for s in seqs]), np.stack([s.grays[f] for s in seqs])

    def clip(first, end):
        return tuple(np.stack(x) for x in zip(*(frames(f) for f in range(first, end))))

    return SimpleNamespace(jintr=seqs[0].intrinsics, intrinsics=interop.intrinsics_from_numpy(seqs[0].intrinsics),
                           first=frames(0), clip1=clip(1, 4), clip2=clip(4, 7),
                           timestamps=[list(map(float, s.timestamps)) for s in seqs])


BATCH_KW = dict(height=48, width=64, nb_levels=3, candidate_cap=256, flow_threshold=0.5,
                warm_start="constant_velocity")
CADENCE = 2


@pytest.fixture(scope="module")
def jax_batch(lanes):
    """The JAX package's batch: its initial state, the first clip (saved by
    ``save_batch``) and the second clip run straight on."""
    config = jtracker.TrackerConfig(**BATCH_KW)
    intr = lanes.jintr
    state0 = jax.jit(lambda d, g: jbatch.batched_init_state(config, intr, d, g))(*map(jnp.asarray, lanes.first))

    @jax.jit
    def run(s, dd, gg, pending, offset, prev):
        return jbatch.batched_track_sequence(
            config, intr, s, dd, gg, switch_cadence=CADENCE, pending0=pending, frame_offset=offset,
            return_pending=True, prev_pose0=prev, return_prev=True,
        )

    pending0 = jnp.zeros((2,), bool)
    first = run(state0, *map(jnp.asarray, lanes.clip1), pending0, jnp.int32(0), state0.current_pose)
    state1, _, pending1, prev1 = first
    second = run(state1, *map(jnp.asarray, lanes.clip2), pending1, jnp.int32(3), prev1)
    return SimpleNamespace(config=config, intr=intr, run=run, state0=state0, first=first, second=second)


def _batch_outputs_close(out, ref):
    """(poses, diagnostics) of the port and of the JAX package."""
    (poses, diags), (rposes, rdiags) = out, ref
    np.testing.assert_array_equal(diags.switched.numpy(), np.asarray(rdiags.switched))
    np.testing.assert_array_equal(diags.failed.numpy(), np.asarray(rdiags.failed))
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(rposes.t), atol=ATOL)
    np.testing.assert_allclose(poses.q.numpy(), np.asarray(rposes.q), atol=ATOL)


def _lane_ts(lanes, frames_done):
    return [ts[: frames_done + 1] for ts in lanes.timestamps]


def test_batch_leaf_order_is_jax(lanes, jax_batch, tmp_path):
    """``save_batch``'s leaves are those of the JAX package's checkpoint
    tree: the state in the JAX lane layout, the pending mask, the previous
    poses and the ring."""
    config = ttracker.TrackerConfig(**{**BATCH_KW, "relocalize_window": 2})
    jconfig = jtracker.TrackerConfig(**{**BATCH_KW, "relocalize_window": 2})
    state = interop.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, jax_batch.state0))
    ring = tbatch.batched_init_ring(config, state)
    pending = torch.tensor([True, False])
    path = str(tmp_path / "batch.npz")
    tckpt.save_batch(path, state, pending, ring, 0, config, lanes.intrinsics, CADENCE, _lane_ts(lanes, 0),
                     prev_pose=state.current_pose)
    jring = jbatch.batched_init_ring(jconfig, jax_batch.state0)
    ref = jax.tree_util.tree_leaves({"state": jax_batch.state0, "pending": jnp.asarray([True, False]),
                                     "prev": jax_batch.state0.current_pose, "ring": jring})
    out = _file_leaves(path)
    assert _leaf_signature(out) == _leaf_signature(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-6, atol=1e-6 * max(1.0, np.abs(np.asarray(r)).max()))


@pytest.mark.parametrize("warm_start", ["constant_position", "constant_velocity"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_streaming_resume_across_packages(seq, tmp_path, writer, warm_start):
    """One package tracks 4 frames and saves; the other loads the file and
    tracks 3 more; the writer resumes its own file and tracks the same 3."""
    jtrk, ttrk = _jax_tracker(seq, warm_start=warm_start), _port_tracker(seq, warm_start=warm_start)
    done, rest = range(1, SAVED_AT + 1), range(SAVED_AT + 1, SAVED_AT + RESUMED + 1)
    path = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        _track(jtrk, seq, done, jnp.asarray)
        jckpt.save_tracker(path, jtrk)
        assert jtrk.keyframe_switches >= 1
    else:
        _track(ttrk, seq, done, np.asarray)
        tckpt.save_tracker(path, ttrk)
        assert ttrk.keyframe_switches >= 1
    jckpt.load_tracker(path, jtrk)
    tckpt.load_tracker(path, ttrk)
    assert ttrk.keyframe_switches == jtrk.keyframe_switches
    assert ttrk.current_depth_timestamp == jtrk.current_depth_timestamp == float(seq.timestamps[SAVED_AT])
    assert ttrk.keyframe_data.levels[0].xs.shape == jtrk.keyframe_data.levels[0].xs.shape  # the bucket
    ref = _track(jtrk, seq, rest, jnp.asarray)
    out = _track(ttrk, seq, rest, np.asarray)
    assert ttrk.keyframe_switches == jtrk.keyframe_switches
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_batch_resume_jax_to_port(lanes, jax_batch, tmp_path):
    """The JAX package saves its batch after the first clip; the port loads
    it and runs the second clip, as the JAX package does straight on."""
    state1, _, pending1, prev1 = jax_batch.first
    path = str(tmp_path / "jax_batch.npz")
    jckpt.save_batch(path, state1, pending1, None, 3, jax_batch.config, jax_batch.intr, CADENCE,
                     _lane_ts(lanes, 3), prev_pose=prev1)
    config = ttracker.TrackerConfig(**BATCH_KW)
    template = tbatch.batched_init_state(config, lanes.intrinsics, *lanes.first, device="cpu")
    state, pending, ring, frames_done, lane_ts, prev = tckpt.load_batch(
        path, template, None, config, lanes.intrinsics, CADENCE
    )
    assert ring is None and frames_done == 3 and lane_ts == _lane_ts(lanes, 3)
    assert pending.any()  # a switch waits for the next check frame across the save
    np.testing.assert_array_equal(pending.numpy(), np.asarray(pending1))
    _, out, _, _ = tbatch.batched_track_sequence(
        config, lanes.intrinsics, state, *lanes.clip2, switch_cadence=CADENCE, pending0=pending,
        frame_offset=frames_done, return_pending=True, prev_pose0=prev, return_prev=True,
    )
    _batch_outputs_close(out, jax_batch.second[1])


def test_batch_resume_port_to_jax(lanes, jax_batch, tmp_path):
    """The port runs the first clip from the JAX package's initial state and
    saves; the JAX package loads the file and runs the second clip, against
    the port's own second clip."""
    config = ttracker.TrackerConfig(**BATCH_KW)
    state0 = interop.track_state_from_numpy(jax.tree_util.tree_map(np.asarray, jax_batch.state0))
    state1, out1, pending1, prev1 = tbatch.batched_track_sequence(
        config, lanes.intrinsics, state0, *lanes.clip1, switch_cadence=CADENCE,
        return_pending=True, prev_pose0=state0.current_pose, return_prev=True,
    )
    _batch_outputs_close(out1, jax_batch.first[1])
    path = str(tmp_path / "port_batch.npz")
    tckpt.save_batch(path, state1, pending1, None, 3, config, lanes.intrinsics, CADENCE, _lane_ts(lanes, 3),
                     prev_pose=prev1)
    jstate, jpending, jring, frames_done, _, jprev = jckpt.load_batch(
        path, jax_batch.state0, None, jax_batch.config, jax_batch.intr, CADENCE
    )
    assert jring is None and frames_done == 3
    _, ref, _, _ = jax_batch.run(jstate, *map(jnp.asarray, lanes.clip2), jpending, jnp.int32(3), jprev)
    _, out, _, _ = tbatch.batched_track_sequence(
        config, lanes.intrinsics, state1, *lanes.clip2, switch_cadence=CADENCE, pending0=pending1,
        frame_offset=3, return_pending=True, prev_pose0=prev1, return_prev=True,
    )
    _batch_outputs_close(out, ref)


SMALL = dict(height=48, width=64, nb_levels=3, candidate_cap=256)


@pytest.fixture(scope="module")
def small(lanes):
    config = ttracker.TrackerConfig(**SMALL)
    state = tbatch.batched_init_state(config, lanes.intrinsics, *lanes.first, device="cpu")
    return SimpleNamespace(config=config, state=state, pending=torch.zeros(2, dtype=torch.bool))


def _mismatch_version(small, lanes, path):
    trk = ttracker.init_tracker(small.config, lanes.intrinsics, 0.0, lanes.first[0][0], 0.0, lanes.first[1][0],
                                device="cpu")
    tckpt.save_tracker(path, trk)
    with np.load(path) as data:
        arrays = dict(data)
    tckpt.save_pytree(path, [arrays[f"leaf_{i}"] for i in range(len(arrays) - 1)], {"format_version": 1})
    tckpt.load_tracker(path, trk)


def _mismatch_fingerprint(small, lanes, path):
    trk = ttracker.init_tracker(small.config, lanes.intrinsics, 0.0, lanes.first[0][0], 0.0, lanes.first[1][0],
                                device="cpu")
    tckpt.save_tracker(path, trk)
    trk.config = dataclasses.replace(small.config, robust_delta=10.0)
    tckpt.load_tracker(path, trk)


def _mismatch_lanes(small, lanes, path):
    tckpt.save_batch(path, small.state, small.pending, None, 0, small.config, lanes.intrinsics, 1,
                     _lane_ts(lanes, 0))
    three = tbatch._map_state(lambda x: torch.cat([x, x[:1]]), small.state)
    tckpt.load_batch(path, three, None, small.config, lanes.intrinsics, 1)


def _mismatch_ring(small, lanes, path):
    tckpt.save_batch(path, small.state, small.pending, None, 0, small.config, lanes.intrinsics, 1,
                     _lane_ts(lanes, 0))
    ring = tbatch.batched_init_ring(dataclasses.replace(small.config, relocalize_window=2), small.state)
    tckpt.load_batch(path, small.state, ring, small.config, lanes.intrinsics, 1)


def _mismatch_prev(small, lanes, path):
    velocity = dataclasses.replace(small.config, warm_start="constant_velocity")
    tckpt.save_batch(path, small.state, small.pending, None, 0, velocity, lanes.intrinsics, 1,
                     _lane_ts(lanes, 0), prev_pose=None)
    tckpt.load_batch(path, small.state, None, velocity, lanes.intrinsics, 1)


@pytest.mark.parametrize("case, match", [
    (_mismatch_version, "version"), (_mismatch_fingerprint, "fingerprint"), (_mismatch_lanes, "batch size"),
    (_mismatch_ring, "ring"), (_mismatch_prev, "warm-start carry"),
])
def test_checkpoint_mismatch_is_refused(small, lanes, tmp_path, case, match):
    with pytest.raises(tckpt.CheckpointMismatchError, match=match):
        case(small, lanes, str(tmp_path / "ckpt.npz"))


def test_64_bit_leaves_stay_numpy(tmp_path):
    tree = {"stamps": np.array([1305031102.175304, 1305031102.211214]), "ids": np.array([2**40, 3], np.int64),
            "pose": (torch.arange(4, dtype=torch.float32), torch.tensor([True, False]))}
    path = str(tmp_path / "tree")  # no .npz added to the name
    tckpt.save_pytree(path, tree, {"k": 1})
    out, meta = tckpt.load_pytree(path, tree)
    assert meta == {"k": 1, "format_version": tckpt.FORMAT_VERSION}
    assert isinstance(out["stamps"], np.ndarray) and isinstance(out["ids"], np.ndarray)
    np.testing.assert_array_equal(out["stamps"], tree["stamps"])
    np.testing.assert_array_equal(out["ids"], tree["ids"])
    assert all(torch.equal(a, b) for a, b in zip(out["pose"], tree["pose"]))
    ref, _ = jckpt.load_pytree(path, tree)  # the JAX package reads the same leaves
    np.testing.assert_array_equal(ref["stamps"], tree["stamps"])

