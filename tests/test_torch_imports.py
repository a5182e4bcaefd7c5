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
from visual_odometry_rs_tpu_torch.cli import vors_track
try:
    vors_track.main(["--help"])
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
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, *modules],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "associations_file" in proc.stdout


def test_port_sources_name_no_jax():
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            code = line.split("#")[0].strip()
            if code.startswith(("import ", "from ")):
                assert "jax" not in code and "visual_odometry_rs_tpu." not in code, (path, line)
