"""The port's ``vors_slam`` and SLAM checkpoint against the JAX package's.

- ``test_cli.py::test_cli_slam_pipeline``'s out-and-back sequence (15 frames
  at 120x160, seed 47), written as PNGs, through both packages' CLI with the
  same flags: the same keyframes, the same verified loop edges (frame pairs)
  and map point count; poses within ``atol=5e-3``, ``test_torch_cli.py``'s
  LM basin (measured 1.5e-3 on frame 13, whose tracking solve decides a
  near tie otherwise than JAX's, ROADMAP C2; 1.9e-5 elsewhere); the SLAM
  ATE at most the port's ``vors_track`` ATE + 2e-3, the JAX test's bound.
- ``--kf-store disk`` and ``memory`` print the same lines; a run split by
  ``--save-state``/``--resume`` prints the straight run's lines, both ways
  between the stores.
- ``save_slam`` of either package resumes in the other: trajectory,
  timestamps, keyframe ids and images equal, the tracker's poses within
  ``atol=5e-4`` after three more frames (``test_torch_checkpoint.py``'s
  tolerance).
"""

import contextlib
import io
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.cli import vors_slam as jslam
from visual_odometry_rs_tpu.math.pose import Pose as JPose
from visual_odometry_rs_tpu.models import tracker as jtracker
from visual_odometry_rs_tpu.utils import checkpoint as jckpt
from visual_odometry_rs_tpu_torch.cli import vors_slam as tslam
from visual_odometry_rs_tpu_torch.cli import vors_track as ttrack
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.utils import checkpoint as tckpt
from visual_odometry_rs_tpu_torch.utils import pointcloud as tpc

torch.set_num_threads(1)

FLAGS = ["--cpu", "--nb-levels", "3", "--candidate-cap", "1024", "--loop-min-gap", "6", "--loop-radius", "0.35",
         "--loop-max-candidates", "4"]
SPLIT = 8  # the split run saves after frame 8


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return out.getvalue(), err.getvalue()


def _counts(err):
    m = re.search(r"(\d+) keyframes, (\d+) verified loop edges", err)
    assert m, err
    return int(m.group(1)), int(m.group(2)), re.findall(r"loop edge: frames (\d+) <-> (\d+)", err)


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    """The sequence's files, the JAX CLI's run and the port's straight run
    (disk store), both with ``--export-cloud``."""
    root = tmp_path_factory.mktemp("slam")
    out = [[0.05, 0.004, 0.002, 0.002, -0.001, 0.001]] * 7
    back = [[-0.05, -0.004, -0.002, -0.002, 0.001, -0.001]] * 7
    seq = tsyn.generate_sequence(nb_frames=15, height=120, width=160, seed=47,
                                 twist_per_frame=np.asarray(out + back, np.float32))
    assoc = ttum.write_sequence(str(root / "seq"), seq.grays, seq.depths, seq.timestamps)
    ref = _run(jslam.main, ["fr1", assoc, *FLAGS, "--export-cloud", str(root / "jax.ply")])
    port = _run(tslam.main, ["fr1", assoc, *FLAGS, "--export-cloud", str(root / "port.ply")])
    return dict(root=root, seq=seq, assoc=assoc, ref=ref, port=port)


def test_vors_slam_matches_jax_cli(slam_run):
    seq, root = slam_run["seq"], slam_run["root"]
    (out, err), (ref_out, ref_err) = slam_run["port"], slam_run["ref"]
    nb_kf, nb_edges, pairs = _counts(err)
    assert (nb_kf, nb_edges, pairs) == _counts(ref_err)
    assert nb_kf >= 2 and nb_edges >= 1
    frames, ref_frames = ttum.parse_trajectory(out), ttum.parse_trajectory(ref_out)
    assert len(frames) == len(ref_frames) == 14
    for f, r in zip(frames, ref_frames):
        assert f.timestamp == r.timestamp
        np.testing.assert_allclose(f.pose.t.numpy(), r.pose.t.numpy(), atol=5e-3)
        np.testing.assert_allclose(f.pose.q.numpy(), r.pose.q.numpy(), atol=5e-3)
    tracked = ttum.parse_trajectory(_run(ttrack.main, ["fr1", slam_run["assoc"], *FLAGS[:5]])[0])
    gt = seq.poses[1:]
    ate_slam = tate.ate_rmse([f.pose for f in frames], gt)
    assert ate_slam <= tate.ate_rmse([f.pose for f in tracked], gt) + 2e-3
    pts, _ = tpc.read_ply(str(root / "port.ply"))
    ref_pts, _ = tpc.read_ply(str(root / "jax.ply"))
    assert len(pts) == len(ref_pts) > nb_kf * 50 and np.isfinite(pts).all()
    assert f"exported {len(pts)} map points" in err


def test_vors_slam_stores_and_resume(slam_run, tmp_path):
    assoc, straight = slam_run["assoc"], slam_run["port"][0]
    assert _run(tslam.main, ["fr1", assoc, *FLAGS, "--kf-store", "memory"])[0] == straight
    lines = open(assoc).read().splitlines()
    first = pathlib.Path(assoc).parent / "first.txt"  # paths in it are relative to its directory
    first.write_text("\n".join(lines[: 1 + SPLIT + 1]) + "\n")  # the comment line and frames 0..SPLIT
    for saved_by, resumed_by in (("memory", "disk"), ("disk", "memory")):
        ckpt = str(tmp_path / f"{saved_by}.npz")
        _run(tslam.main, ["fr1", str(first), *FLAGS, "--kf-store", saved_by, "--save-state", ckpt])
        out, err = _run(tslam.main, ["fr1", assoc, *FLAGS, "--kf-store", resumed_by, "--resume", ckpt])
        assert f"resumed from {ckpt}: {SPLIT} frames tracked" in err
        assert out == straight, (saved_by, resumed_by)


def test_vors_slam_refusals(slam_run, tmp_path):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tslam.main(["fr1", slam_run["assoc"], *FLAGS, "--resume", str(tmp_path / "missing.npz")]) == 1
        assert tslam.main(["fr1", slam_run["assoc"], *FLAGS, "--refine-window", "3", "--resume",
                           str(tmp_path / "missing.npz")]) == 1
        assert tslam.main(["fr1", str(tmp_path / "missing.txt"), "--cpu"]) == 1
    assert err.getvalue().count("Cannot resume") == 2


def _jax_tracker(seq, config_kw):
    from visual_odometry_rs_tpu.core.camera import Intrinsics as JIntrinsics

    intr = JIntrinsics(*(jnp.asarray(v.numpy()) for v in seq.intrinsics))
    return jtracker.init_tracker(jtracker.TrackerConfig(**config_kw), intr, 0.0, jnp.asarray(seq.depths[0]), 0.0,
                                 jnp.asarray(seq.grays[0]))


def _port_tracker(seq, config_kw):
    return ttracker.init_tracker(ttracker.TrackerConfig(**config_kw), seq.intrinsics, 0.0, seq.depths[0], 0.0,
                                 seq.grays[0], device="cpu")


def _slam_track(trk, seq, frames, state, as_array):
    """``vors_slam``'s tracking loop over ``frames``, on ``state`` =
    (trajectory, timestamps, keyframe ids, images)."""
    trajectory, timestamps, keyframe_ids, images = state
    for f in frames:
        before = trk.keyframe_switches
        trk.track(float(f), as_array(seq.depths[f]), float(f), as_array(seq.grays[f]))
        ts, pose = trk.current_frame()
        trajectory.append(pose)
        timestamps.append(ts)
        if trk.keyframe_switches > before:
            keyframe_ids.append(f)
            images[f] = (seq.depths[f], seq.grays[f])
    return trajectory, timestamps, keyframe_ids, images


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_slam_resumes_across_packages(slam_run, tmp_path, writer):
    seq = slam_run["seq"]
    kw = dict(height=120, width=160, nb_levels=3, candidate_cap=1024, idepth_variance=1e-4)
    jax_kw = kw  # interp_method "auto": the fingerprint the port's checkpoints carry
    packages = {
        "jax": (lambda: _jax_tracker(seq, jax_kw), jnp.asarray, jckpt,
                lambda p: JPose(jnp.asarray(p.q), jnp.asarray(p.t))),
        "port": (lambda: _port_tracker(seq, kw), np.asarray, tckpt, lambda p: p),
    }
    reader = "port" if writer == "jax" else "jax"
    make_w, arr_w, ckpt_w, _ = packages[writer]
    make_r, arr_r, ckpt_r, _ = packages[reader]
    trk = make_w()
    state = ([trk.current_frame()[1]], [0.0], [0], {0: (seq.depths[0], seq.grays[0])})
    state = _slam_track(trk, seq, range(1, SPLIT + 1), state, arr_w)
    path = str(tmp_path / "slam.npz")
    ckpt_w.save_slam(path, trk, *state, SPLIT)
    resumed = make_r()
    trajectory, timestamps, keyframe_ids, images, done = ckpt_r.load_slam(path, resumed)
    assert done == SPLIT and timestamps == state[1] and keyframe_ids == state[2] and len(keyframe_ids) >= 2
    assert set(images) == set(state[3])
    for fid, (d, g) in images.items():
        np.testing.assert_array_equal(np.asarray(d), seq.depths[fid])
        np.testing.assert_array_equal(np.asarray(g), seq.grays[fid])
    for a, b in zip(trajectory, state[0]):
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
        np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    # three more frames in both packages from the same state
    for f in range(SPLIT + 1, SPLIT + 4):
        trk.track(float(f), arr_w(seq.depths[f]), float(f), arr_w(seq.grays[f]))
        resumed.track(float(f), arr_r(seq.depths[f]), float(f), arr_r(seq.grays[f]))
        np.testing.assert_allclose(np.asarray(resumed.current_pose.t), np.asarray(trk.current_pose.t), atol=5e-4)
        np.testing.assert_allclose(np.asarray(resumed.current_pose.q), np.asarray(trk.current_pose.q), atol=5e-4)
    # the image-free (disk mode) checkpoint
    ckpt_w.save_slam(path, trk, *state[:3], None, SPLIT)
    assert ckpt_r.load_slam(path, make_r())[3] is None
    other = _port_tracker(seq, dict(kw, candidate_cap=512)) if reader == "port" else \
        _jax_tracker(seq, dict(jax_kw, candidate_cap=512))
    with pytest.raises(ckpt_r.CheckpointMismatchError):
        ckpt_r.load_slam(path, other)
