#!/usr/bin/env python3
"""The JAX package's ATE on ``chip_smoke.py``'s streaming sequences (CPU).

    JAX_PLATFORMS=cpu python3 chip_smoke_reference.py \
        [plain|huber+brightness|dso_fixed|relocalize|slam|refine|refine_chunked|slam_refine|affine|ba ...]

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
on phase 9's files (``JAX_SLAM_REFINE``).  ``affine`` runs the JAX package's ``affine2d.align`` on
phase 11a's 640x480 image and template and prints its parameters (``JAX_AFFINE``); ``ba`` runs its
``parallel/ba.solve`` on phase 11b's window (``tests/test_ba.py::make_problem`` at K=16, P=4096) and
prints the energy, the LM iterations and the ATE with scale (``JAX_BA``); ``examples`` runs the
JAX package's four tracking example programs (``track_synthetic``, ``relocalization``,
``slam_loop_closure``, ``photometric_window``) and prints the numbers they print (``JAX_EXAMPLES``).  A run holds a few GiB of host memory; the script
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


def jax_affine() -> list:
    """The JAX package's ``align`` on phase 11a's image and template."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from visual_odometry_rs_tpu.models import affine2d

    from visual_odometry_rs_tpu_torch.dataset import synthetic

    img = synthetic.smooth_image(smoke.HEIGHT, smoke.WIDTH, seed=smoke.AFFINE_IMAGE_SEED)
    template, _ = affine2d.random_template(img, seed=smoke.AFFINE_TEMPLATE_SEED)
    params, failed = affine2d.align(jnp.asarray(template), jnp.asarray(img),
                                    affine2d.default_nb_levels(smoke.HEIGHT, smoke.WIDTH))
    assert not bool(failed)
    return [float(v) for v in params]


def jax_ba() -> dict:
    """The JAX package's ``solve`` on phase 11b's window."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math.pose import Pose
    from visual_odometry_rs_tpu.parallel import ba

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_ba import make_problem

    problem, gt_poses, _ = make_problem(K=smoke.BA_K, P=smoke.BA_P, seed=smoke.BA_SEED, perturb=smoke.BA_PERTURB,
                                        noise_px=smoke.BA_NOISE_PX)
    res = ba.solve(problem)
    poses = [Pose(np.asarray(res.poses.q[k]), np.asarray(res.poses.t[k])) for k in range(smoke.BA_K)]
    gt = [Pose(np.asarray(gt_poses.q[k]), np.asarray(gt_poses.t[k])) for k in range(smoke.BA_K)]
    return {"energy": float(res.energy), "nb_iter": int(res.nb_iter),
            "ate": float(ate.ate_rmse(poses, gt, with_scale=True))}


def jax_examples() -> dict:
    """The numbers that the JAX package's four tracking examples print, run
    as programs."""
    import contextlib
    import io
    import re
    import runpy

    import jax

    jax.config.update("jax_platforms", "cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    printed = {}
    for name in ("track_synthetic", "relocalization", "slam_loop_closure", "photometric_window"):
        out, err = io.StringIO(), io.StringIO()
        saved = sys.argv
        sys.argv = [name]
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                runpy.run_path(os.path.join(root, "examples", f"{name}.py"), run_name="__main__")
        finally:
            sys.argv = saved
        printed[name] = out.getvalue() + err.getvalue()
    track, reloc = printed["track_synthetic"], printed["relocalization"]
    slam, window = printed["slam_loop_closure"], printed["photometric_window"]
    summary = json.loads(re.search(r"(\{.*\})", track.split("ATE RMSE")[1]).group(1))
    rows = re.findall(r"^\s+(\d+)\s+([\d.]+)\s+([\d.]+)", reloc, re.M)
    return {
        "track_synthetic": {
            "trajectory": [[float(x) for x in line.split()] for line in track.splitlines()[:7]],
            "ate_mm": float(re.search(r"ATE RMSE: ([\d.]+) mm", track).group(1)),
            "keyframe_switches": summary["keyframe_switches"], "failures": summary["failures"],
            "mean_flow": summary["mean_flow"],
        },
        "relocalization": {
            "errors_off": [float(r[1]) for r in rows], "errors_on": [float(r[2]) for r in rows],
            "relocalizations": int(re.search(r"relocalizations fired: (\d+)", reloc).group(1)),
        },
        "slam_loop_closure": {
            "edges": re.search(r"verified loop edges: (.*)", slam).group(1),
            "ate_before_cm": float(re.search(r"ATE before loop closure: ([\d.]+) cm", slam).group(1)),
            "ate_after_cm": float(re.search(r"ATE after  loop closure: ([\d.]+) cm", slam).group(1)),
        },
        "photometric_window": {
            "candidates": int(re.search(r"window of \d+ frames, (\d+) candidates", window).group(1)),
            "iterations": int(re.search(r"LM iterations: (\d+)", window).group(1)),
            "energy": float(re.search(r"final energy ([\d.]+)", window).group(1)),
            "idepth_error": [float(x) for x in re.search(r"\|error\|: ([\d.]+) -> ([\d.]+)", window).groups()],
            "pose_error_mm": float(re.search(r"\|t error\|: ([\d.]+) mm", window).group(1)),
        },
    }


def main(argv) -> int:
    threading.Thread(target=_watch_memory, daemon=True).start()
    for name in argv or [*RUNS, "slam", "refine", "refine_chunked", "slam_refine", "affine", "ba", "examples"]:
        start = time.time()
        if name in ("affine", "ba", "examples"):
            value = {"affine": jax_affine, "ba": jax_ba, "examples": jax_examples}[name]()
            print(json.dumps({"run": name, f"jax_{name}": value, "seconds": round(time.time() - start, 1)}), flush=True)
            continue
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
