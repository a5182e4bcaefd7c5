"""The port's ``vors_refine`` against the JAX package's CLI, on the CPU.

Two sequences (64x80, 9 frames at about 2 px a frame, so that keyframes
switch) written as PNGs, each one's ground truth with a seeded cumulative
drift as its input trajectory (the form of ``tests/test_cli.py``'s drift
test), refined by both packages' CLIs with ``FLAGS`` and the JAX package's
``--interp gather`` (the port's sampling).  The window is 2 and the coarse
pre-solve off to bound the JAX package's compiles (about 20 s a mode on
the CPU); ``tests/test_torch_sliding_window.py`` holds the coarse stage.
Tolerances, with the values measured on the CPU beside them:

- Refined poses, port against JAX: ``atol=5e-4`` in t and q (measured
  2.1e-6 sliding against the JAX batch's first lane, 1.0e-6 chunked,
  8.2e-6 on the batch's lanes).  A
  window's camera system with a marginalization prior is ill-conditioned
  in f32, so longer runs than these can round apart
  (ROADMAP C2).  The refined ATE within 1.5x of JAX's and, in the sliding
  mode, below the drifted input's (measured 6.7e-3 against 7.4e-3; the
  chunked mode raises it to 1.3e-2 in both packages).  The chunked mode's
  test lives in ``tests/test_torch_sliding_window.py``, which has room in
  the per-file time budget for its JAX compile.
- ``--batch``: every lane against the port's own single-lane sliding run,
  ``atol=1e-5`` (measured 4.3e-6 on the first lane: a product over two
  lanes is not always blocked like a product over one).
- Resumed runs: bit-equal to the straight run.

``vors_slam --refine-window`` is held against the JAX CLI in
``tests/test_torch_slam_window.py``: its JAX window compiles would take
this file past its time budget.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.cli import vors_refine as jrefine
from visual_odometry_rs_tpu_torch.cli import vors_refine as trefine
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.math import pose as tpose
from visual_odometry_rs_tpu_torch.math import se3 as tse3
from visual_odometry_rs_tpu_torch.utils import pointcloud as tpc

torch.set_num_threads(1)

FLAGS = ["--nb-levels", "3", "--candidate-cap", "256", "--window", "2", "--max-iterations", "5",
         "--energy-tol", "0.05", "--coarse-level", "0"]
SPLIT = 4  # the split run saves after frame 4
TWIST = [0.025, 0.01, 0.0, 0.0, 0.004, 0.0]  # about 2 px a frame: keyframe switches


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return out.getvalue(), err.getvalue()


def _drifted(seq, seed):
    rng = np.random.default_rng(seed)
    drift = [tpose.identity()]
    for _ in range(1, len(seq.poses)):
        step = tse3.exp(torch.from_numpy((rng.normal(size=6) * 0.004).astype(np.float32)))
        drift.append(tpose.compose(drift[-1], step))
    return [tpose.compose(p, d) for p, d in zip(seq.poses, drift)]


def _write_sequence(root, name, seed, drift_seed):
    seq = tsyn.generate_sequence(nb_frames=9, height=64, width=80, seed=seed, twist_per_frame=TWIST)
    assoc = ttum.write_sequence(os.path.join(root, name), seq.grays, seq.depths, seq.timestamps)
    drifted = _drifted(seq, drift_seed)
    traj = os.path.join(root, name, "drifted.txt")
    with open(traj, "w") as f:
        for t, p in zip(seq.timestamps[1:], drifted[1:]):
            f.write(ttum.Frame(timestamp=float(t), pose=p).to_string() + "\n")
    return seq, assoc, traj, drifted


def _close(frames, ref_frames, atol):
    assert len(frames) == len(ref_frames)
    for f, r in zip(frames, ref_frames):
        assert f.timestamp == r.timestamp
        np.testing.assert_allclose(f.pose.t.numpy(), r.pose.t.numpy(), atol=atol)
        np.testing.assert_allclose(f.pose.q.numpy(), r.pose.q.numpy(), atol=atol)


def _short(assoc, traj, frames):
    """Files of the first ``frames`` frames of a sequence."""
    d = os.path.dirname(assoc)
    short, short_traj = os.path.join(d, "short.txt"), os.path.join(d, "short_traj.txt")
    with open(short, "w") as f:
        f.write("\n".join(open(assoc).read().splitlines()[: 1 + frames]) + "\n")  # the comment line first
    with open(short_traj, "w") as f:
        f.write("".join(open(traj).readlines()[: frames - 1]))
    return short, short_traj


@pytest.fixture(scope="module")
def refine_run(tmp_path_factory):
    """The files, the JAX CLI's batched run and the port's batched and
    sliding runs (the batch: the first sequence and 7 frames of a second).
    The port's sliding run is held against the JAX batch's first lane: one
    JAX compile less, and JAX's lanes are its sliding runs up to its vmap's
    lowering of the sums."""
    root = str(tmp_path_factory.mktemp("refine"))
    seq, assoc, traj, drifted = _write_sequence(root, "a", 31, 5)
    _, assoc_b, traj_b, _ = _write_sequence(root, "b", 32, 6)
    pairs = [assoc, traj, *_short(assoc_b, traj_b, 7)]
    for pkg, main, extra in (("jax", jrefine.main, ["--interp", "gather"]), ("port", trefine.main, [])):
        _run(main, ["fr1", *pairs, "--cpu", *extra, "--batch", "--out-dir", os.path.join(root, pkg), *FLAGS])
    # the JAX batch's file has no frame 0 line either: one line a frame 1..8
    runs = {"sliding": (open(os.path.join(root, "jax", "a.txt")).read(),
                        _run(trefine.main, ["fr1", assoc, traj, "--cpu", *FLAGS])[0])}
    return dict(root=root, seq=seq, assoc=assoc, traj=traj, drifted=drifted, runs=runs, pairs=pairs)


def refine_against_jax(ref_out, out, seq, drifted, below_input):
    """A refined trajectory against the JAX CLI's on the same files: poses
    within ``5e-4``, the ATE within 1.5x JAX's and, with ``below_input``,
    below the drifted input's."""
    frames, ref_frames = ttum.parse_trajectory(out), ttum.parse_trajectory(ref_out)
    assert len(frames) == 8
    _close(frames, ref_frames, 5e-4)
    gt = seq.poses[1:]
    ate_in = tate.ate_rmse(drifted[1:], gt)
    ate_port = tate.ate_rmse([f.pose for f in frames], gt)
    ate_jax = tate.ate_rmse([f.pose for f in ref_frames], gt)
    assert ate_port <= 1.5 * ate_jax, (ate_port, ate_jax)
    if below_input:
        assert ate_port < ate_in, (ate_in, ate_port)


def test_vors_refine_matches_jax_cli(refine_run):
    """The sliding mode (the chunked one: ``tests/test_torch_sliding_window.py``)."""
    refine_against_jax(*refine_run["runs"]["sliding"], refine_run["seq"], refine_run["drifted"], True)


def test_vors_refine_resume_and_cloud(refine_run, tmp_path):
    """``--save-state`` partway and ``--resume`` print the straight run's
    lines; ``--export-cloud`` writes a PLY file that reads back."""
    assoc, traj = refine_run["assoc"], refine_run["traj"]
    straight = refine_run["runs"]["sliding"][1]
    lines = open(assoc).read().splitlines()
    first = os.path.join(os.path.dirname(assoc), "first.txt")
    with open(first, "w") as f:
        f.write("\n".join(lines[: 1 + SPLIT + 1]) + "\n")  # the comment line and frames 0..SPLIT
    first_traj = os.path.join(os.path.dirname(assoc), "first_traj.txt")
    with open(first_traj, "w") as f:
        f.write("".join(open(traj).readlines()[:SPLIT]))
    ckpt = str(tmp_path / "w.npz")
    ply = str(tmp_path / "map.ply")
    _run(trefine.main, ["fr1", first, first_traj, "--cpu", *FLAGS, "--save-state", ckpt, "--export-cloud", ply])
    out, err = _run(trefine.main, ["fr1", assoc, traj, "--cpu", *FLAGS, "--resume", ckpt, "--export-cloud", ply])
    assert f"resumed from {ckpt}: {SPLIT + 1} frames already processed" in err
    assert out == straight
    pts, inten = tpc.read_ply(ply)
    assert f"exported {len(pts)} refined map points" in err and len(pts) > 100 and np.isfinite(pts).all()
    assert inten.dtype == np.uint8


def test_vors_refine_batch_matches_jax_and_single(refine_run, tmp_path):
    """``--batch`` on two sequences of different lengths: each lane's file
    within the tolerance of the JAX CLI's and of the port's single-lane
    sliding run of its pair; a run split by ``--max-frames``/``--save-state``
    and ``--resume`` writes the straight run's files."""
    root, pairs = refine_run["root"], refine_run["pairs"]
    singles = [refine_run["runs"]["sliding"][1], _run(trefine.main, ["fr1", *pairs[2:], "--cpu", *FLAGS])[0]]
    for name, single in zip(("a.txt", "b.txt"), singles):
        lanes = ttum.parse_trajectory(open(os.path.join(root, "port", name)).read())
        _close(lanes, ttum.parse_trajectory(open(os.path.join(root, "jax", name)).read()), 5e-4)
        _close(lanes, ttum.parse_trajectory(single), 1e-5)
    ckpt = str(tmp_path / "b.npz")
    split_dir = str(tmp_path / "split")
    _run(trefine.main, ["fr1", *pairs, "--cpu", "--batch", "--out-dir", split_dir, *FLAGS, "--max-frames", "3",
                        "--save-state", ckpt])
    _, err = _run(trefine.main, ["fr1", *pairs, "--cpu", "--batch", "--out-dir", split_dir, *FLAGS, "--resume", ckpt])
    assert "resumed 2 lanes at global frame 4" in err
    for name in ("a.txt", "b.txt"):
        assert open(os.path.join(split_dir, name)).read() == open(os.path.join(root, "port", name)).read()


def test_vors_refine_needs_cuda_and_refuses(refine_run, tmp_path):
    """Without ``--cpu`` the CLI needs CUDA; mismatched inputs exit 1."""
    assoc, traj = refine_run["assoc"], refine_run["traj"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trefine.main(["fr1", assoc, traj])
    short = tmp_path / "short.txt"
    short.write_text("".join(open(traj).readlines()[:3]))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert trefine.main(["fr1", assoc, str(short), "--cpu"]) == 1
        assert trefine.main(["fr1", assoc, traj, "--cpu", "--resume", str(tmp_path / "missing.npz")]) == 1
    assert "expected 8" in err.getvalue() and "Cannot resume" in err.getvalue()
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            trefine.main(["fr1", assoc, traj, "--cpu", "--mode", "chunked", "--save-state", "x.npz"])
