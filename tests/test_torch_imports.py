"""The port runs where JAX is absent: every module imports, and the CLIs
and the example programs answer ``--help``, with ``jax`` and the JAX
package blocked."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "visual_odometry_rs_tpu_torch"

_GUARD = """
import importlib, sys
sys.modules["jax"] = None
sys.modules["visual_odometry_rs_tpu"] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
from visual_odometry_rs_tpu_torch.cli import vors_batch, vors_eval, vors_refine, vors_slam, vors_track
for cli in (vors_track, vors_batch, vors_eval, vors_slam, vors_refine):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
for name in EXAMPLES:
    try:
        importlib.import_module("visual_odometry_rs_tpu_torch.examples." + name).main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
"""
EXAMPLES = ("optim_rosenbrock", "optim_regression_1d", "optim_affine2d", "candidates_coarse_to_fine", "candidates_dso",
            "dataset_tum_read_associations", "dataset_tum_read_trajectory", "track_synthetic", "relocalization",
            "slam_loop_closure", "photometric_window")


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def test_port_imports_and_cli_help_without_jax():
    modules = _modules()
    assert "visual_odometry_rs_tpu_torch.models.tracker" in modules
    assert "visual_odometry_rs_tpu_torch.parallel.batch" in modules
    for name in ("models.relocalize", "core.candidates.dso", "native", "utils.checkpoint", "utils.metrics",
                 "cli.vors_eval", "parallel.pose_graph", "models.loop_closure", "utils.pointcloud", "cli.vors_slam",
                 "models.photometric_ba", "models.sliding_window", "cli.vors_refine", "models.affine2d", "parallel.ba",
                 "utils.view", "utils.colormap", "utils.helper", "utils.image_interop", "examples",
                 "parallel.mesh", "parallel.collectives", "parallel.sharded",
                 *(f"examples.{name}" for name in EXAMPLES)):
        assert f"visual_odometry_rs_tpu_torch.{name}" in modules
    proc = subprocess.run(
        [sys.executable, "-c", f"EXAMPLES = {EXAMPLES!r}\n" + _GUARD, *modules],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "associations_file" in proc.stdout and "--switch-cadence" in proc.stdout
    for flag in ("--robust-delta", "--candidate-selector", "--dso-target", "--dso-block-size", "--dso-a",
                 "--brightness-model", "--relocalize", "--relocalize-energy"):
        assert proc.stdout.count(flag) >= 3, flag  # in the help of vors_track, vors_batch and vors_slam
    for flag in ("--save-state", "--resume"):
        assert proc.stdout.count(flag) >= 4, flag  # documented in the four CLIs' help
    for flag in ("trajectory_file", "--batch", "--out-dir", "--max-frames", "--window", "--mode",
                 "--no-marginalization", "--coarse-level", "--max-iterations", "--idepth-prior-weight",
                 "--energy-tol", "--save-every", "--export-cloud", "--cloud-voxel", "--cpu"):
        assert flag in proc.stdout, flag  # vors_refine's flags
    assert "--interp" not in proc.stdout and "8.2 vs 10.6" not in proc.stdout
    for flag in ("--loop-radius", "--loop-max-angle", "--loop-min-gap", "--loop-max-candidates",
                 "--loop-energy-accept", "--save-every", "--export-cloud", "--cloud-voxel", "--refine-window",
                 "--refine-energy-tol", "--warm-start", "--level-iterations", "--kf-store"):
        assert flag in proc.stdout, flag  # vors_slam's flags
    for flag in ("--chunk", "--metrics", "--delta", "--max-dt"):
        assert flag in proc.stdout, flag
    assert "==SUPPRESS==" not in proc.stdout
    assert proc.stdout.count("--cpu") >= len(EXAMPLES) + 1  # every example's help, and vors_refine's


def test_port_sources_name_no_jax():
    """No module of the port, nor ``chip_smoke.py``, imports ``jax`` or the
    JAX package (its ``native`` binding included), and the port builds only
    its own ``csrc`` sources."""
    for path in [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            code = line.split("#")[0].strip()
            if code.startswith(("import ", "from ")):
                assert "jax" not in code and "visual_odometry_rs_tpu." not in code, (path, line)
                assert not code.startswith(("import visual_odometry_rs_tpu ", "from visual_odometry_rs_tpu ")), line
            assert "libvors_io" not in code and "native/vors_io" not in code, (path, line)
