"""A whole run on the CPU at a tiny size, the look for a chip skipped, with
the timed path broken underneath: ``correct`` must come out false for each
fault a cell can have, and true without one.  (The cells run on one chip,
so there is no exchange between chips to leave out.)"""

import contextlib
import time

import numpy as np
import pytest
import torch

import harness
import run
from tiny import TINY_LIMITS, tiny_cell
from visual_odometry_rs_tpu_torch.math.pose import Pose
from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
from visual_odometry_rs_tpu_torch.parallel import batch as batch_mod

LIVE = harness.load_module("drivers", "live").Driver
BATCH = harness.load_module("drivers", "offline_batch").Driver


@contextlib.contextmanager
def replaced(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _run(cell_name, driver_cls, seconds):
    torch.set_num_threads(1)
    _, cfg, traffic = tiny_cell(cell_name)
    return run.run_cell(cfg, traffic, TINY_LIMITS, [], [], 3, seconds, False, torch.device("cpu"),
                        time.perf_counter(), driver_cls=driver_cls)


# -- the live tracker -------------------------------------------------------


def _live_with(fault):
    """The live driver with ``Tracker.track`` broken from the first frame on."""
    class Broken(LIVE):
        def prepare(self):
            with self._broken():
                super().prepare()

        def run(self, seconds, trace):
            with self._broken():
                return super().run(seconds, trace)

        @staticmethod
        def _broken():
            real = tracker_mod.Tracker.track

            def track(trk, *args):
                fault(trk, lambda *a: real(trk, *a), *args)

            return replaced(tracker_mod.Tracker, "track", track)

    return Broken


def _unchanged(trk, real, *args):
    """The step returns the tracker's state as it was."""


def _altered(trk, real, *args):
    """The answer is altered where it is produced: the pose moved by 1 cm
    (the keyframes keep theirs, so only the first frame shows it)."""
    real(*args)
    trk.current_pose = Pose(trk.current_pose.q, trk.current_pose.t + 0.01)


def test_live_sound_run_is_correct():
    result = _run("live_xyz1_30hz", LIVE, 0.4)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 12 and result["failed"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _altered], ids=["state_unchanged", "answer_altered"])
def test_live_fault_is_not_correct(fault):
    result = _run("live_xyz1_30hz", _live_with(fault), 0.4)
    assert not result["correct"], result["checks"]


# -- the batched tracker ----------------------------------------------------


def _batch_with(fault):
    """The batched driver broken from its first clip on."""
    class Broken(BATCH):
        def prepare(self):
            with self._broken():
                super().prepare()

        def run(self, seconds, trace):
            with self._broken():
                return super().run(seconds, trace)

        @staticmethod
        def _broken():
            real = batch_mod.batched_track_sequence

            def broken(*args, **kwargs):
                return fault(real, *args, **kwargs)

            return replaced(batch_mod, "batched_track_sequence", broken)

    return Broken


def _stack(pose: Pose, frames: int) -> Pose:
    return Pose(pose.q[None].expand(frames, *pose.q.shape).clone(), pose.t[None].expand(frames, *pose.t.shape).clone())


def _batch_unchanged(real, config, intrinsics, state, depths, imgs, **kwargs):
    """Every lane's step returns its state as it was."""
    _, (poses, diags), pending, prev = real(config, intrinsics, state, depths, imgs, **kwargs)
    frames = imgs.shape[0]
    zero = torch.zeros_like(diags.switched)
    return state, (_stack(state.current_pose, frames), diags._replace(switched=zero)), pending, prev


def _batch_half(real, config, intrinsics, state, depths, imgs, **kwargs):
    """Half of the lanes are left out: only the first half is tracked."""
    half = state.current_pose.q.shape[0] // 2
    out_state, (poses, diags), pending, prev = real(config, intrinsics, state, depths, imgs, **kwargs)
    kept = _stack(Pose(state.current_pose.q[half:], state.current_pose.t[half:]), imgs.shape[0])
    poses = Pose(torch.cat([poses.q[:, :half], kept.q], 1), torch.cat([poses.t[:, :half], kept.t], 1))
    return out_state, (poses, diags), pending, prev


def _batch_altered(real, *args, **kwargs):
    """The answer is altered where it is produced: every pose moved by 1 cm
    (the same for all, so only a frame that starts from the initial state
    shows it)."""
    out_state, (poses, diags), pending, prev = real(*args, **kwargs)
    return out_state, (Pose(poses.q, poses.t + 0.01), diags), pending, prev


def test_batch_sound_run_is_correct():
    result = _run("batch32_desk", BATCH, 0.5)
    assert result["correct"], result["checks"]
    assert result["attempted"] % (8 * 3) == 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", [_batch_unchanged, _batch_half, _batch_altered],
                         ids=["state_unchanged", "half_the_lanes", "answer_altered"])
def test_batch_fault_is_not_correct(fault):
    result = _run("batch32_desk", _batch_with(fault), 0.5)
    assert not result["correct"], result["checks"]
    assert np.isfinite(result["checks"]["pose_t_gap_m.median"]["value"])
