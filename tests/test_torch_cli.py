"""The port's CLI, dataset, evaluation and interop against the JAX package.

- The port CLI (``--cpu``) and the JAX CLI on the same PNG sequence: the
  same number of trajectory lines, positions within the LM stopping basin
  (``atol=5e-3``).
- ``synthetic.generate_sequence``: the same images, depths and poses for the
  same arguments (bit-equal images; poses at ``rtol=1e-6``).
- TUM parsing, the trajectory line (qw last) and the intrinsics presets:
  equal; ATE: ``rtol=1e-9`` (both are numpy f64).
- ``vors_track --metrics``, ``--save-state``/``--resume`` and ``--chunk``,
  ``vors_batch --save-state``/``--resume``: the port alone, bit-equal to
  the uninterrupted and streaming runs.
"""

import io
import json
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


def test_vors_slam_needs_cuda_and_names_the_window_item(tmp_path):
    """``vors_slam`` runs on CUDA unless ``--cpu`` is given, with the
    photometric window (``--refine-window``, ROADMAP A11b) too: on the CPU
    with ``--cpu`` it refines every frame in its window."""
    from visual_odometry_rs_tpu_torch.cli import vors_slam

    seq = tsyn.generate_sequence(nb_frames=3, height=48, width=64, seed=3)
    assoc = ttum.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            vors_slam.main(["fr1", assoc])
        with pytest.raises(RuntimeError, match="CUDA"):
            vors_slam.main(["fr1", assoc, "--refine-window", "3"])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert vors_slam.main(["fr1", assoc, "--cpu", "--nb-levels", "3", "--candidate-cap", "256",
                               "--refine-window", "3"]) == 0
    assert "sliding-window refinement on: window 3" in err.getvalue()
    frames = ttum.parse_trajectory(out.getvalue())
    assert len(frames) == 2 and all(np.isfinite(f.pose.t.numpy()).all() for f in frames)


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


# ---------------------------------------------------------------------------
# --metrics, --save-state/--resume and --chunk (the port alone; the CPU path
# is deterministic, so resumed and clip runs are held bit-equal)
# ---------------------------------------------------------------------------

CLI_FLAGS = ["--cpu", "--nb-levels", "3", "--candidate-cap", "256"]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cli_seq(tmp_path_factory):
    """Seven frames at 48x64 with keyframe switches; the associations file
    and its two halves split at frame 3 (frames 0-3 and 3-6)."""
    seq = tsyn.generate_sequence(nb_frames=7, height=48, width=64, seed=3,
                                 twist_per_frame=[0.05, 0.0, 0.0, 0.0, 0.004, 0.0])
    directory = tmp_path_factory.mktemp("cli") / "seq"
    assoc = ttum.write_sequence(str(directory), seq.grays, seq.depths, seq.timestamps)
    lines = open(assoc).read().splitlines()[1:]
    halves = []
    for name, part in (("first.txt", lines[:4]), ("rest.txt", lines[3:])):
        (directory / name).write_text("\n".join(part) + "\n")
        halves.append(str(directory / name))
    return assoc, halves


@pytest.mark.parametrize("warm_start", ["constant_position", "constant_velocity"])
def test_vors_track_resume_is_bit_equal(cli_seq, tmp_path, warm_start):
    assoc, (first, rest) = cli_seq
    flags = [*CLI_FLAGS, "--warm-start", warm_start]
    ckpt = str(tmp_path / "state.npz")
    rc, full, _ = _run(tcli.main, ["fr1", assoc, *flags])
    rc1, out1, _ = _run(tcli.main, ["fr1", first, *flags, "--save-state", ckpt])
    rc2, out2, err2 = _run(tcli.main, ["fr1", rest, *flags, "--resume", ckpt])
    assert rc == rc1 == rc2 == 0 and "warning" not in err2
    assert out1 + out2 == full and len(full.splitlines()) == 6
    rc, out, err = _run(tcli.main, ["fr1", assoc, *flags, "--resume", ckpt])
    assert rc == 0 and "tracked twice" in err  # the whole file again after a resume
    rc, _, err = _run(tcli.main, ["fr1", rest, *flags, "--robust-delta", "10", "--resume", ckpt])
    assert rc == 1 and "Cannot resume" in err and "fingerprint" in err
    rc, _, err = _run(tcli.main, ["fr1", rest, *flags, "--resume", str(tmp_path / "missing.npz")])
    assert rc == 1 and "Cannot read checkpoint" in err


def _metrics(err):
    records = [json.loads(line) for line in err.splitlines() if line.startswith("{")]
    return records[:-1], records[-1]


@pytest.mark.parametrize("chunk", [0, 3])
def test_vors_track_metrics_and_chunk(cli_seq, chunk):
    """``--metrics`` in streaming and clip mode; ``--chunk 3`` prints the
    lines of the streaming tracker without bucketing (the batched tracker's
    static caps)."""
    assoc, _ = cli_seq
    rc, out, err = _run(tcli.main, ["fr1", assoc, *CLI_FLAGS, "--no-bucket", "--chunk", str(chunk), "--metrics"])
    assert rc == 0
    frames, summary = _metrics(err)
    assert [f["frame_index"] for f in frames] == list(range(1, 7))
    assert set(frames[0]) == {"frame_index", "timestamp", "optical_flow", "keyframe_switched", "failed",
                              "track_seconds"}
    assert summary["frames"] == 6 and summary["failures"] == 0
    assert summary["keyframe_switches"] == sum(f["keyframe_switched"] for f in frames) >= 1
    assert [f["timestamp"] for f in frames] == [float(line.split()[0]) for line in out.splitlines()]
    _, streaming, _ = _run(tcli.main, ["fr1", assoc, *CLI_FLAGS, "--no-bucket"])
    assert out == streaming


@pytest.mark.parametrize("flags, match", [
    (["--candidate-selector", "dso"], "dso"), (["--save-state", "x.npz"], "--save-state"),
    (["--resume", "x.npz"], "--resume"), (["--relocalize", "2"], "--relocalize"),
])
def test_vors_track_chunk_refusals(cli_seq, flags, match):
    rc, out, err = _run(tcli.main, ["fr1", cli_seq[0], *CLI_FLAGS, "--chunk", "3", *flags])
    assert rc == 1 and out == "" and match in err and "--chunk" in err


def test_vors_batch_resume_is_bit_equal(tmp_path):
    """Two lanes of different lengths, cadence 2, a ring and the velocity
    carry: a run split by ``--max-frames``/``--save-state``/``--resume``
    writes the files of the straight run; a resume with other files is
    refused."""
    assocs = []
    for i, twist in enumerate(([0.05, 0.0, 0.0, 0.0, 0.004, 0.0], [0.0, 0.04, 0.01, 0.0, 0.0, 0.002])):
        seq = tsyn.generate_sequence(nb_frames=8 - i, height=48, width=64, seed=3 + i, twist_per_frame=twist)
        assocs.append(ttum.write_sequence(str(tmp_path / f"s{i}"), seq.grays, seq.depths, seq.timestamps))
    flags = [*CLI_FLAGS, "--chunk", "3", "--switch-cadence", "2", "--relocalize", "2",
             "--warm-start", "constant_velocity"]
    ckpt = str(tmp_path / "batch.npz")
    assert _run(vors_batch.main, ["fr1", *assocs, "--out-dir", str(tmp_path / "straight"), *flags])[0] == 0
    split = ["fr1", *assocs, "--out-dir", str(tmp_path / "split"), *flags, "--save-state", ckpt]
    assert _run(vors_batch.main, [*split, "--max-frames", "4"])[0] == 0
    rc, _, err = _run(vors_batch.main, [*split, "--resume", ckpt])
    assert rc == 0 and "resumed 2 lanes at global frame 4" in err
    for name, frames in (("s0.txt", 7), ("s1.txt", 6)):
        straight = (tmp_path / "straight" / name).read_text()
        assert (tmp_path / "split" / name).read_text() == straight and len(straight.splitlines()) == frames
    out = ["--out-dir", str(tmp_path / "other"), *flags, "--resume", ckpt]
    rc, _, err = _run(vors_batch.main, ["fr1", *assocs[::-1], *out])
    assert rc == 1 and "lane 0" in err and "does not match" in err
    rc, _, err = _run(vors_batch.main, ["fr1", assocs[0], assocs[0], assocs[1], *out])
    assert rc == 1 and "batch size" in err

