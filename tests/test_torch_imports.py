"""The port runs where JAX is absent: every module imports, and the CLI
answers ``--help``, with ``jax`` and the JAX package blocked."""

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
from visual_odometry_rs_tpu_torch.cli import vors_batch, vors_eval, vors_track
for cli in (vors_track, vors_batch, vors_eval):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
"""


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
                 "cli.vors_eval"):
        assert f"visual_odometry_rs_tpu_torch.{name}" in modules
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, *modules],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "associations_file" in proc.stdout and "--switch-cadence" in proc.stdout
    for flag in ("--robust-delta", "--candidate-selector", "--dso-target", "--dso-block-size", "--dso-a",
                 "--brightness-model", "--relocalize", "--relocalize-energy"):
        assert proc.stdout.count(flag) >= 2, flag  # in both CLIs' help
    for flag in ("--save-state", "--resume"):
        assert proc.stdout.count(flag) >= 2, flag  # documented in both CLIs' help
    for flag in ("--chunk", "--metrics", "--delta", "--max-dt"):
        assert flag in proc.stdout, flag
    assert "==SUPPRESS==" not in proc.stdout


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
