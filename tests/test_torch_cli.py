"""The port's CLI, dataset, evaluation and interop against the JAX package.

- The port CLI (``--cpu``) and the JAX CLI on the same PNG sequence: the
  same number of trajectory lines, positions within the LM stopping basin
  (``atol=5e-3``).
- ``synthetic.generate_sequence``: the same images, depths and poses for the
  same arguments (bit-equal images; poses at ``rtol=1e-6``).
- TUM parsing, the trajectory line (qw last) and the intrinsics presets:
  equal; ATE: ``rtol=1e-9`` (both are numpy f64).
"""

import io
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from visual_odometry_rs_tpu.cli import vors_track as jcli
from visual_odometry_rs_tpu.dataset import synthetic as jsyn
from visual_odometry_rs_tpu.dataset import tum_rgbd as jtum
from visual_odometry_rs_tpu.eval import ate as jate
from visual_odometry_rs_tpu_torch import interop
from visual_odometry_rs_tpu_torch.cli import vors_batch
from visual_odometry_rs_tpu_torch.cli import vors_track as tcli
from visual_odometry_rs_tpu_torch.dataset import synthetic as tsyn
from visual_odometry_rs_tpu_torch.dataset import tum_rgbd as ttum
from visual_odometry_rs_tpu_torch.eval import ate as tate
from visual_odometry_rs_tpu_torch.models import tracker as ttracker
from visual_odometry_rs_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(1)

SEQ_KW = dict(nb_frames=5, height=120, width=160, seed=5)


def _run_cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_matches_jax_cli(tmp_path):
    seq = jsyn.generate_sequence(**SEQ_KW)
    assoc = jtum.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    flags = ["--nb-levels", "3", "--candidate-cap", "1024"]
    ref = jtum.parse_trajectory(_run_cli(jcli.main, ["fr1", assoc, "--cpu", *flags]))
    out_text = _run_cli(tcli.main, ["fr1", assoc, "--cpu", *flags])
    out = jtum.parse_trajectory(out_text)
    assert len(out) == len(ref) == SEQ_KW["nb_frames"] - 1
    for o, r in zip(out, ref):
        assert o.timestamp == r.timestamp
        np.testing.assert_allclose(np.asarray(o.pose.t), np.asarray(r.pose.t), atol=5e-3)
    est = [seq.poses[0]] + [f.pose for f in out]
    assert jate.ate_rmse(est, seq.poses) < 5e-3


def test_clis_run_the_option_flags(tmp_path):
    """``vors_track`` and ``vors_batch`` on the CPU with every option flag:
    one trajectory line per tracked frame, and the poses of the library
    with the same configuration."""
    seq = tsyn.generate_sequence(nb_frames=4, height=48, width=64, seed=6,
                                 twist_per_frame=[0.02, 0.0, 0.0, 0.0, 0.0, 0.0])
    assoc = ttum.write_sequence(str(tmp_path / "seq"), seq.grays, seq.depths, seq.timestamps)
    options = ["--robust-delta", "10", "--brightness-model", "--candidate-selector", "dso_fixed",
               "--dso-target", "300", "--dso-block-size", "3", "--dso-a", "0.2",
               "--relocalize", "2", "--relocalize-energy", "400"]
    flags = ["--cpu", "--nb-levels", "3", "--candidate-cap", "256", *options]
    with redirect_stderr(io.StringIO()):
        lines = _run_cli(tcli.main, ["fr1", assoc, *flags]).splitlines()
        assert vors_batch.main(["fr1", assoc, "--out-dir", str(tmp_path / "out"), *flags]) == 0
        assert tcli.main(["fr1", assoc, "--cpu", "--nb-levels", "3", "--candidate-selector", "dso", "--dso-a", "0.2"]) == 0
    assert len(lines) == 3
    assert (tmp_path / "out" / "seq.txt").read_text().splitlines() == lines  # the same poses, one lane
    config = ttracker.TrackerConfig(
        height=48, width=64, nb_levels=3, candidate_cap=256, depth_scale=ttum.DEPTH_SCALE,
        idepth_variance=ttum.VARIANCE_TUM, bucket_candidates=True, robust_delta=10.0, brightness_model=True,
        candidate_selector="dso_fixed", dso_target=300, dso_block_size=3, dso_threshold_coef_a=0.2,
        relocalize_window=2, relocalize_energy_accept=400.0,
    )
    intr = ttum.scaled_intrinsics("fr1", 48, 64)
    trk = ttracker.init_tracker(config, intr, seq.timestamps[0], seq.depths[0], seq.timestamps[0], seq.grays[0],
                                device="cpu")
    stamps = [a.depth_timestamp for a in ttum.load_associations(assoc)]
    for f, line in enumerate(lines, start=1):
        trk.track(stamps[f], seq.depths[f], stamps[f], seq.grays[f])
        assert line == ttum.Frame(timestamp=stamps[f], pose=trk.current_frame()[1]).to_string()
    with redirect_stderr(io.StringIO()), pytest.raises(SystemExit):  # not one of vors_batch's choices
        vors_batch.main(["fr1", assoc, "--out-dir", str(tmp_path), "--cpu", "--candidate-selector", "dso"])


def test_cli_missing_file_and_no_cuda():
    assert tcli.main(["fr1", "/nonexistent/associations.txt", "--cpu"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["fr1", "/nonexistent/associations.txt"])


def test_synthetic_sequence_matches():
    kw = dict(nb_frames=3, height=60, width=80, seed=3)
    ref = jsyn.generate_sequence(**kw)
    out = tsyn.generate_sequence(**kw)
    np.testing.assert_array_equal(out.grays, ref.grays)
    np.testing.assert_array_equal(out.depths, ref.depths)
    np.testing.assert_array_equal(out.timestamps, ref.timestamps)
    np.testing.assert_allclose(out.intrinsics.vector().numpy(), np.stack(ref.intrinsics), rtol=1e-7)
    for o, r in zip(out.poses, ref.poses):
        np.testing.assert_allclose(o.q.numpy(), np.asarray(r.q), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(o.t.numpy(), np.asarray(r.t), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("camera_id", ["fr1", "fr2", "fr3", "icl"])
def test_intrinsics_presets_match(camera_id):
    for h, w in [(480, 640), (120, 160)]:
        ref = np.stack(jtum.scaled_intrinsics(camera_id, h, w))
        np.testing.assert_array_equal(ttum.scaled_intrinsics(camera_id, h, w).vector().numpy(), ref)


def test_associations_and_trajectory_lines():
    content = "# comment\n1.0 depth/a.png 1.01 rgb/a.png\n\n2.5 depth/b.png 2.49 rgb/b.png\n"
    ref = jtum.parse_associations(content)
    out = ttum.parse_associations(content)
    assert [vars(a) for a in out] == [vars(a) for a in ref]
    with pytest.raises(ValueError):
        ttum.parse_associations("1.0 depth/a.png 1.01\n")
    pose = jax.tree_util.tree_map(np.asarray, jsyn.generate_sequence(nb_frames=2, height=8, width=8).poses[1])
    line = ttum.Frame(timestamp=1.5, pose=interop.pose_from_numpy(pose)).to_string()
    assert line == jtum.Frame(timestamp=1.5, pose=pose).to_string()


def test_read_images_roundtrip(tmp_path):
    seq = tsyn.generate_sequence(nb_frames=2, height=24, width=32, seed=2)
    assoc = ttum.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    assocs = ttum.load_associations(assoc)
    for a, gray, depth in zip(assocs, seq.grays, seq.depths):
        d, g = ttum.read_images(a)
        assert d.dtype == np.uint16 and g.dtype == np.uint8
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(g, gray)


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_matches(with_scale):
    rng = np.random.default_rng(9)
    gt = [interop.pose_from_numpy(_np_pose(rng)) for _ in range(6)]
    est = [interop.pose_from_numpy(_np_pose(rng)) for _ in range(6)]
    ref = jate.ate_rmse([interop.pose_to_numpy(p) for p in est], [interop.pose_to_numpy(p) for p in gt], with_scale)
    np.testing.assert_allclose(tate.ate_rmse(est, gt, with_scale), ref, rtol=1e-9)


def _np_pose(rng):
    q = rng.normal(size=4)
    return SimpleNamespace(q=q / np.linalg.norm(q), t=rng.normal(size=3))


def test_interop_roundtrip():
    seq = tsyn.generate_sequence(nb_frames=1, height=30, width=40, seed=4)
    kf = ttracker.precompute_keyframe(
        ttracker.TrackerConfig(height=30, width=40, nb_levels=2, candidate_cap=256),
        seq.intrinsics,
        torch.from_numpy(seq.depths[0].astype(np.int32)),
        tpyr.mean_pyramid(2, torch.from_numpy(seq.grays[0])),
    )
    back = interop.keyframe_from_numpy(interop.keyframe_to_numpy(kf))
    for a, b in zip(kf.levels, back.levels):
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert torch.equal(a.intrinsics.vector(), b.intrinsics.vector())
