"""The port's ``vors_slam --refine-window`` against the JAX package's CLI,
on the CPU.

``tests/test_torch_refine.py``'s first sequence (64x80, 9 frames at about
2 px a frame, so that keyframes switch), written as PNGs, through both
packages' ``vors_slam --cpu --nb-levels 3 --candidate-cap 256
--refine-window 3``, the JAX package's with ``--interp gather`` (the
port's sampling).  Its own file because the JAX window's compiles (about
35 s on the CPU) do not fit in that file's time budget.  Tolerances, with
the values measured on the CPU beside them:

- The trajectory, port against JAX: ``atol=5e-4`` in t and q, the bound of
  ``tests/test_torch_refine.py`` (measured 8.9e-6 in t, 1.5e-6 in q).
- The keyframe and verified loop-edge counts: equal (3 and 0).
- The ATE within 1.5x of JAX's (measured 9.906096e-3 m against
  9.906115e-3; the window raises the tracked ATE on these 9 frames in both
  packages).
- Resumed runs: bit-equal to the straight run.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.cli import vors_slam as jslam
from visual_odometry_rs_tpu_torch.cli import vors_slam as tslam
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.eval import ate as tate

torch.set_num_threads(1)

FLAGS = ["--cpu", "--nb-levels", "3", "--candidate-cap", "256"]
WINDOW = ["--refine-window", "3"]
SPLIT = 4  # the split run saves after frame 4
TWIST = [0.025, 0.01, 0.0, 0.0, 0.004, 0.0]  # tests/test_torch_refine.py's


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return out.getvalue(), err.getvalue()


def _counts(err):
    m = re.search(r"(\d+) keyframes, (\d+) verified loop edges", err)
    assert m, err
    return int(m.group(1)), int(m.group(2))


@pytest.fixture(scope="module")
def slam_window_run(tmp_path_factory):
    """The files and both packages' straight runs with the window on."""
    root = str(tmp_path_factory.mktemp("slam_window"))
    seq = tsyn.generate_sequence(nb_frames=9, height=64, width=80, seed=31, twist_per_frame=TWIST)
    assoc = ttum.write_sequence(os.path.join(root, "a"), seq.grays, seq.depths, seq.timestamps)
    return dict(seq=seq, assoc=assoc, jax=_run(jslam.main, ["fr1", assoc, *FLAGS, *WINDOW, "--interp", "gather"]),
                port=_run(tslam.main, ["fr1", assoc, *FLAGS, *WINDOW]))


def test_vors_slam_refine_window(slam_window_run, tmp_path):
    """The trajectory within ``5e-4`` of the JAX CLI's, the keyframe and
    loop-edge counts equal and the ATE within 1.5x of JAX's; the refined
    poses differ from the tracked ones, and the ``.window`` store with
    ``--resume`` prints the straight run's lines."""
    assoc = slam_window_run["assoc"]
    (out, err), (ref_out, ref_err) = slam_window_run["port"], slam_window_run["jax"]
    assert "sliding-window refinement on: window 3" in err
    assert _counts(err) == _counts(ref_err)
    frames, ref_frames = ttum.parse_trajectory(out), ttum.parse_trajectory(ref_out)
    assert len(frames) == len(ref_frames) == 8
    for f, r in zip(frames, ref_frames):
        assert f.timestamp == r.timestamp
        np.testing.assert_allclose(f.pose.t.numpy(), r.pose.t.numpy(), atol=5e-4)
        np.testing.assert_allclose(f.pose.q.numpy(), r.pose.q.numpy(), atol=5e-4)
    gt = slam_window_run["seq"].poses[1:]
    ate_port, ate_jax = (tate.ate_rmse([f.pose for f in fs], gt) for fs in (frames, ref_frames))
    assert ate_port <= 1.5 * ate_jax, (ate_port, ate_jax)
    plain, _ = _run(tslam.main, ["fr1", assoc, *FLAGS])
    assert plain != out
    lines = open(assoc).read().splitlines()
    first = os.path.join(os.path.dirname(assoc), "slam_first.txt")
    with open(first, "w") as f:
        f.write("\n".join(lines[: 1 + SPLIT + 1]) + "\n")
    ckpt = str(tmp_path / "slam.npz")
    _run(tslam.main, ["fr1", first, *FLAGS, *WINDOW, "--save-state", ckpt])
    assert os.path.exists(ckpt + ".window")
    resumed, err_r = _run(tslam.main, ["fr1", assoc, *FLAGS, *WINDOW, "--resume", ckpt])
    assert f"resumed from {ckpt}: {SPLIT} frames tracked" in err_r and resumed == out
    os.remove(ckpt + ".window")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tslam.main(["fr1", assoc, *FLAGS, *WINDOW, "--resume", ckpt]) == 1
    assert "Cannot resume window state" in err.getvalue()
