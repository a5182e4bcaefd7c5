#!/usr/bin/env python3
"""The JAX package's ATE on ``chip_smoke.py``'s streaming sequences (CPU).

    JAX_PLATFORMS=cpu python3 chip_smoke_reference.py \
        [plain|huber+brightness|dso_fixed|relocalize|slam|refine|refine_chunked|slam_refine ...]

``chip_smoke.py`` holds the port's ATE on the card within 1.5x of these
numbers (``JAX_ATE`` for phase 4, ``JAX_ATE_OPTIONS`` for phase 7).  Each
run tracks the 40 frames that the smoke test tracks, at 640x480 with 6
levels and cap 8192, bucketing on and gather sampling, through the JAX
package's host ``Tracker``, and prints one JSON line.  ``slam`` runs the JAX
package's ``vors_slam`` on phase 9's sequence from PNG files and prints the
keyframe, loop-edge and map-point counts and the ATE (``JAX_SLAM``).  ``refine`` and
``refine_chunked`` run the JAX package's ``vors_refine`` (sliding and chunked, its default
flags) on phase 10's files, phase 4's 41 frames with a seeded drift on their ground truth, and
print the refined ATE (``JAX_REFINE``); ``slam_refine`` runs ``vors_slam --refine-window 6``
on phase 9's files (``JAX_SLAM_REFINE``).  A run holds a few GiB of host memory; the script
stops itself if it passes ``MEMORY_LIMIT_GIB``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import chip_smoke as smoke

MEMORY_LIMIT_GIB = 16.0
RUNS = {
    "plain": ("phase4", {}),
    "huber+brightness": ("drift", smoke.OPTIONS["huber+brightness"]),
    "dso_fixed": ("phase4", dict(candidate_selector="dso_fixed", dso_threshold_coef_a=smoke.DSO_A)),
    "relocalize": ("kidnap", dict(relocalize_window=smoke.RELOC_WINDOW)),
}


def _watch_memory():
    """Ends the process when its resident memory passes the limit."""
    while True:
        with open("/proc/self/status") as f:
            rss_kib = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
        if rss_kib > MEMORY_LIMIT_GIB * 2**20:
            print(f"resident memory {rss_kib / 2**20:.1f} GiB above {MEMORY_LIMIT_GIB} GiB: stopping",
                  file=sys.stderr, flush=True)
            os._exit(3)
        time.sleep(0.2)


def sequence(kind):
    """(grays, depths, ground-truth poses, intrinsics) of one of the smoke
    test's streaming sequences, from the port's generator (bit-equal to the
    JAX package's)."""
    from visual_odometry_rs_tpu_torch.dataset import synthetic

    if kind == "kidnap":
        seq = synthetic.generate_sequence(
            nb_frames=smoke.FRAMES, height=smoke.HEIGHT, width=smoke.WIDTH, seed=smoke.KIDNAP_SEED,
            twist_per_frame=smoke.kidnap_twists(smoke.FRAMES),
        )
    else:
        seq = synthetic.generate_sequence(
            nb_frames=smoke.FRAMES, height=smoke.HEIGHT, width=smoke.WIDTH, seed=0, twist_per_frame=smoke.TWIST
        )
    grays = smoke.drift_grays(seq.grays) if kind == "drift" else seq.grays
    return grays, seq.depths, seq.poses, seq.intrinsics


def jax_ate(kind, overrides) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from visual_odometry_rs_tpu.core.camera import Intrinsics
    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math.pose import Pose
    from visual_odometry_rs_tpu.models import tracker

    grays, depths, poses, intr = sequence(kind)
    config = tracker.TrackerConfig(
        height=smoke.HEIGHT, width=smoke.WIDTH, nb_levels=smoke.LEVELS, candidate_cap=smoke.CAP,
        bucket_candidates=True, interp_method="gather", **overrides,
    )
    trk = tracker.init_tracker(
        config, Intrinsics(*(jnp.asarray(v.numpy()) for v in intr)), 0.0, jnp.asarray(depths[0]),
        0.0, jnp.asarray(grays[0]),
    )
    est = [trk.current_frame()[1]]
    for f in range(1, len(grays)):
        trk.track(float(f), jnp.asarray(depths[f]), float(f), jnp.asarray(grays[f]))
        est.append(trk.current_frame()[1])
    truth = [Pose(np.asarray(p.q.numpy()), np.asarray(p.t.numpy())) for p in poses]
    return float(ate.ate_rmse(est, truth))


def jax_slam(refine_window: int = 0) -> dict:
    """The JAX package's ``vors_slam`` through its ``main`` on phase 9's
    sequence written as PNGs by the port's writer: keyframes, verified loop
    edges, map points (``--cloud-voxel 0``) and the ATE of frames 1.. ."""
    import contextlib
    import io
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from visual_odometry_rs_tpu.cli import vors_slam

    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd
    from visual_odometry_rs_tpu_torch.eval import ate

    seq = smoke.slam_sequence()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reference_") as root:
        assoc = tum_rgbd.write_sequence(os.path.join(root, "seq"), seq.grays, seq.depths, seq.timestamps)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = vors_slam.main(["fr1", assoc, "--cpu", "--interp", "gather", "--nb-levels", str(smoke.LEVELS),
                                 "--candidate-cap", str(smoke.CAP), "--loop-max-candidates",
                                 str(smoke.SLAM_MAX_CANDIDATES), "--export-cloud", os.path.join(root, "map.ply"),
                                 "--refine-window", str(refine_window)])
    if rc != 0:
        raise RuntimeError(f"vors_slam exited {rc}: {err.getvalue()[-2000:]}")
    keyframes, edges, points = smoke.slam_counts(err.getvalue())
    frames = tum_rgbd.parse_trajectory(out.getvalue())
    return {"keyframes": keyframes, "edges": edges, "points": points,
            "ate": float(ate.ate_rmse([f.pose for f in frames], seq.poses[1:]))}


def _run_cli(main, argv):
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{main.__module__} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def jax_refine(mode) -> dict:
    """The JAX package's ``vors_refine --mode MODE`` (its defaults, gather
    sampling) on phase 10's files: the drifted input's and the refined ATE."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from visual_odometry_rs_tpu.cli import vors_refine

    from visual_odometry_rs_tpu_torch.dataset import synthetic, tum_rgbd
    from visual_odometry_rs_tpu_torch.eval import ate

    seq = synthetic.generate_sequence(nb_frames=smoke.FRAMES, height=smoke.HEIGHT, width=smoke.WIDTH, seed=0,
                                      twist_per_frame=smoke.TWIST)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reference_") as root:
        assoc, traj, drifted = smoke.write_refine_inputs(root, seq.grays, seq.depths, seq.timestamps, seq.poses)
        out, _ = _run_cli(vors_refine.main, ["fr1", assoc, traj, "--cpu", "--interp", "gather", "--mode", mode])
    frames = tum_rgbd.parse_trajectory(out)
    return {"drifted_ate": float(ate.ate_rmse(drifted[1:], seq.poses[1:])),
            "ate": float(ate.ate_rmse([f.pose for f in frames], seq.poses[1:]))}


def main(argv) -> int:
    threading.Thread(target=_watch_memory, daemon=True).start()
    for name in argv or [*RUNS, "slam", "refine", "refine_chunked", "slam_refine"]:
        start = time.time()
        if name in ("slam", "slam_refine"):
            value = jax_slam(smoke.REFINE_WINDOW if name == "slam_refine" else 0)
            print(json.dumps({"run": name, "jax_slam": value, "seconds": round(time.time() - start, 1)}), flush=True)
            continue
        if name in ("refine", "refine_chunked"):
            value = jax_refine("chunked" if name == "refine_chunked" else "sliding")
            print(json.dumps({"run": name, "jax_refine": value, "seconds": round(time.time() - start, 1)}),
                  flush=True)
            continue
        kind, overrides = RUNS[name]
        value = jax_ate(kind, overrides)
        print(json.dumps({"run": name, "jax_ate": value, "seconds": round(time.time() - start, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
