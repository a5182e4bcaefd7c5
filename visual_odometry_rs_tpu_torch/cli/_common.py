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


def add_option_flags(parser, selectors) -> None:
    """The tracker-option flags of the JAX CLIs, with their defaults;
    ``selectors`` are the ``--candidate-selector`` choices."""
    parser.add_argument(
        "--robust-delta", type=float, default=0.0,
        help="Huber robust weighting threshold in intensity units (0 = reference-exact L2)",
    )
    parser.add_argument(
        "--candidate-selector", choices=list(selectors), default="coarse_to_fine",
        help="keyframe candidate picker: " + ", ".join(selectors) + " (dso: the DSO picker with "
        "its host recursion on the block size; dso_fixed: one pass at --dso-block-size)",
    )
    parser.add_argument("--dso-target", type=int, default=2000,
                        help="DSO point-count target (dso_fixed: sets the thinning ratio)")
    parser.add_argument("--dso-block-size", type=int, default=4,
                        help="dso_fixed: the block size (4 = the DSO paper's base)")
    parser.add_argument("--dso-a", type=float, default=1.0,
                        help="DSO regional threshold coefficient a in a*(mean3x3(median)+b)^2")
    parser.add_argument(
        "--brightness-model", action="store_true",
        help="estimate a per-frame affine brightness (gain, bias) with the pose",
    )
    parser.add_argument(
        "--relocalize", type=int, default=0, metavar="K",
        help="keep the last K keyframes and recover a lost frame (solver failure or energy "
        "above --relocalize-energy) against them; 0 = off",
    )
    parser.add_argument("--relocalize-energy", type=float, default=150.0,
                        help="mean squared intensity above which a frame counts as lost")


def option_fields(args) -> dict:
    """The ``TrackerConfig`` fields of the option flags."""
    return dict(
        robust_delta=args.robust_delta,
        brightness_model=args.brightness_model,
        relocalize_window=max(0, args.relocalize),
        relocalize_energy_accept=args.relocalize_energy,
        candidate_selector=args.candidate_selector,
        dso_target=args.dso_target,
        dso_block_size=args.dso_block_size,
        dso_threshold_coef_a=args.dso_a,
    )


def lane_mesh(nb_lanes: int, device, message: str):
    """A ``data`` mesh over the local devices of ``device``'s type when
    there are several and they divide the lane count (the JAX CLIs' rule
    with ``jax.local_device_count()``), with ``message`` on stderr; else
    None."""
    import sys

    from ..parallel import mesh as mesh_mod

    devices = mesh_mod.local_devices(device.type)
    if len(devices) < 2 or nb_lanes % len(devices):
        return None
    print(message.format(lanes=nb_lanes, devices=len(devices)), file=sys.stderr)
    return mesh_mod.make_mesh((len(devices),), ("data",), devices=devices)
