"""Shared CLI plumbing of the port (``visual_odometry_rs_tpu/cli/_common.py``
without the JAX compilation cache)."""

from __future__ import annotations


def parse_level_iterations(spec, nb_levels: int):
    """Parse ``--level-iterations "N0,N1,..."`` into a per-level tuple,
    finest first.

    ``None``/empty returns ``None`` (the single cap of the reference).
    Raises ``SystemExit`` with a usage message on malformed input, like
    argparse.
    """
    if not spec:
        return None
    try:
        caps = tuple(int(tok) for tok in str(spec).split(","))
    except ValueError:
        raise SystemExit(f"--level-iterations must be comma-separated integers, got {spec!r}")
    if len(caps) != nb_levels or any(c < 1 for c in caps):
        raise SystemExit(
            f"--level-iterations needs {nb_levels} caps >= 1 (one per "
            f"pyramid level, finest first), got {spec!r}"
        )
    return caps
