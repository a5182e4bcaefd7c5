#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (``vors_track``'s streaming tracker) on the card
at 640x480 with 6 pyramid levels and 8192 candidates per level, and fails
(non-zero exit, no result line) unless every phase passes:

1. Build the fused LM evaluation kernel (``csrc/residual_reduce.cu``) from the
   sources, and hold it against its plain torch twin at every level shape of
   a 640x480 keyframe, at a ragged candidate count and with no valid
   candidate.  Time both per evaluation (CUDA events, median of 100).
2. Track 40 frames of a synthetic 640x480 sequence through ``init_tracker``
   and ``Tracker.track`` on CUDA, with bucketing on.  Every ``_eval_full``
   call must launch the kernel once; no frame may fail; at least one keyframe
   switch; the ATE must stay within 1.5x the JAX package's ATE on the same
   sequence.
3. Track the first frames again on the CPU (the twins) and compare poses.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HEIGHT, WIDTH, LEVELS, CAP = 480, 640, 6, 8192
FRAMES = 41  # frame 0 initializes, 40 are tracked
TWIST = [0.01, 0.004, 0.0, 0.0, 0.002, 0.001]  # per frame: about 5 keyframe switches
# ATE of the JAX package (visual_odometry_rs_tpu, CPU backend, gather
# sampling, bucketing on) on this exact sequence and configuration
JAX_ATE = 0.001173417615140308
ATE_BOUND = 1.5 * JAX_ATE
CPU_FRAMES = 5  # frames re-tracked on the CPU in phase 3
# kernel against twin: energy rtol; g and H after scaling by their max
E_RTOL, GH_RTOL, GH_ATOL = 1e-5, 1e-4, 1e-5
POSE_ATOL = 5e-3


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _check_close(name, got, ref, n_valid):
    """Kernel output against the twin's, as the CPU tests compare the twin
    with the JAX package.  Returns the max abs error after scaling."""
    import torch

    (m, rsq, cnt), (m_ref, rsq_ref, cnt_ref) = got, ref
    if float(cnt) != float(cnt_ref):
        raise AssertionError(f"{name}: inside count {float(cnt)} != {float(cnt_ref)}")
    if n_valid == 0:
        if float(cnt) != 0.0 or float(rsq) != 0.0 or not torch.isnan(rsq / cnt):
            raise AssertionError(f"{name}: all-invalid case must give count 0 and NaN energy")
        return 0.0
    e, e_ref = float(rsq / cnt), float(rsq_ref / cnt_ref)
    if abs(e - e_ref) > E_RTOL * abs(e_ref):
        raise AssertionError(f"{name}: energy {e} vs {e_ref}")
    err = 0.0
    for part, ref_part in ((m[:, 6], m_ref[:, 6]), (m[:, :6], m_ref[:, :6])):
        scale = float(ref_part.abs().max()) + 1.0
        a, b = part / scale, ref_part / scale
        if not torch.allclose(a, b, rtol=GH_RTOL, atol=GH_ATOL):
            raise AssertionError(f"{name}: normal equations differ beyond tolerance")
        err = max(err, float((a - b).abs().max()))
    return err


def _time_ms(fn, reps=100, warmup=10) -> float:
    """Median milliseconds of one call, between CUDA events around it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(seq, dev):
    """Kernel against twin at every level shape; returns (max err, timings)."""
    import torch

    from visual_odometry_rs_tpu_torch.math import se3
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid, residual

    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP)
    kf = tracker_mod.precompute_keyframe(
        config, seq.intrinsics.to(dev),
        torch.from_numpy(seq.depths[0].astype("int32")).to(dev),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]).to(dev)),
    )
    pyr1 = pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1]).to(dev))
    model = se3.exp(torch.tensor([0.005, -0.003, 0.002, 0.001, 0.002, -0.001], device=dev))
    max_err, timings = 0.0, []
    for lvl, obs in enumerate(kf.levels):
        params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
        cases = [("level", obs)]
        if lvl == 0:
            cut = obs.xs.shape[0] - 192  # not a multiple of the 256-thread block
            cases.append(("ragged", obs._replace(**{
                f: getattr(obs, f)[:cut] for f in ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")
            })))
            cases.append(("all-invalid", obs._replace(valid=torch.zeros_like(obs.valid))))
        for label, o in cases:
            args = (pyr1[lvl], o.xs, o.ys, o.idepth, o.tmpl_vals, o.valid, o.jacobians, params)
            got = residual.residual_reduce(*args)
            ref = residual.residual_reduce_reference(*args)
            torch.cuda.synchronize()
            n_valid = int(o.valid.sum())
            err = _check_close(f"level {lvl} {label}", got, ref, n_valid)
            max_err = max(max_err, err)
            print(f"kernel-vs-twin level {lvl} {label}: image {tuple(pyr1[lvl].shape)} N={o.xs.shape[0]} "
                  f"valid={n_valid} scaled_max_abs_err={err:.3e} ok")
        args = (pyr1[lvl], obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params)
        k_ms = _time_ms(lambda: residual.residual_reduce(*args))
        t_ms = _time_ms(lambda: residual.residual_reduce_reference(*args))
        timings.append((lvl, tuple(pyr1[lvl].shape), obs.xs.shape[0], k_ms, t_ms))
        print(f"time per evaluation level {lvl} image {tuple(pyr1[lvl].shape)} N={obs.xs.shape[0]}: "
              f"kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms (CUDA events, median of 100)")
    print(f"tolerance: energy rtol {E_RTOL}; g, H rtol {GH_RTOL} atol {GH_ATOL} after scaling by max|twin|+1; "
          f"inside count equal")
    return max_err, timings


def _track(seq, frames, device):
    """Tracks ``frames`` frames through init_tracker/Tracker.track; returns
    (tracker, poses, per-frame seconds)."""
    import torch

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

    config = tracker_mod.TrackerConfig(
        height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP, bucket_candidates=True
    )
    ts = seq.timestamps
    trk = tracker_mod.init_tracker(
        config, seq.intrinsics, float(ts[0]), seq.depths[0], float(ts[0]), seq.grays[0], device=device
    )
    poses, seconds = [trk.current_frame()[1]], []
    for f in range(1, frames):
        start = time.perf_counter()
        trk.track(float(ts[f]), seq.depths[f], float(ts[f]), seq.grays[f])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        if trk.last_failed:
            raise AssertionError(f"frame {f} failed on {device}")
        poses.append(trk.current_frame()[1])
    return trk, poses, seconds


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU", file=sys.stderr)
        return 1
    from visual_odometry_rs_tpu_torch.dataset import synthetic
    from visual_odometry_rs_tpu_torch.eval import ate
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import residual

    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's matmul in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}")

    _, build_s, ptxas = residual.build_library()
    print(f"kernel build: {build_s:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    seq = synthetic.generate_sequence(
        nb_frames=FRAMES, height=HEIGHT, width=WIDTH, seed=0, twist_per_frame=TWIST
    )

    # phase 1: kernel against twin
    max_err, timings = phase_kernel(seq, dev)

    # phase 2: the main path on CUDA; count the evaluations it makes
    eval_full = tracker_mod._eval_full
    evals = [0]

    def counted_eval_full(*args):
        evals[0] += 1
        return eval_full(*args)

    tracker_mod._eval_full = counted_eval_full
    residual.residual_reduce.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        trk, poses, seconds = _track(seq, FRAMES, dev)
    finally:
        tracker_mod._eval_full = eval_full
    launches = residual.residual_reduce.launches
    if launches != evals[0] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != _eval_full calls {evals[0]}")
    if trk.keyframe_switches < 1:
        raise AssertionError("no keyframe switch")
    err = ate.ate_rmse(poses, seq.poses)
    ms = [1e3 * s for s in seconds]
    steady = ms[1:]
    print(f"track: {len(ms)} frames at {WIDTH}x{HEIGHT}, {LEVELS} levels, cap {CAP}, bucketing on; "
          f"keyframe switches {trk.keyframe_switches}; _eval_full calls {evals[0]}, kernel launches {launches}")
    print(f"per-frame ms: first {ms[0]:.2f}, median {statistics.median(steady):.2f}, "
          f"mean {statistics.mean(steady):.2f}, max {max(steady):.2f} (frames 2..{len(ms)}); "
          f"fps {1e3 / statistics.mean(steady):.1f}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"ATE {err:.6e} m; bound {ATE_BOUND:.6e} m = 1.5 x JAX package ATE {JAX_ATE:.6e} m")
    if not err <= ATE_BOUND:
        raise AssertionError(f"ATE {err} above bound {ATE_BOUND}")

    # phase 3: the same first frames on the CPU (the twins)
    _, cpu_poses, _ = _track(seq, CPU_FRAMES, torch.device("cpu"))
    diff = max(float((g.t.cpu() - c.t).abs().max()) for g, c in zip(poses[:CPU_FRAMES], cpu_poses))
    print(f"CUDA vs CPU over {CPU_FRAMES} frames: max |dt| {diff:.3e} m (atol {POSE_ATOL})")
    if not diff <= POSE_ATOL:
        raise AssertionError(f"CUDA and CPU poses differ by {diff}")

    lvl0 = timings[0]
    print(json.dumps({"kernels": [{
        "name": "residual_reduce",
        "route": "cuda",
        "source": "visual_odometry_rs_tpu_torch/csrc/residual_reduce.cu",
        "replaces": "visual_odometry_rs_tpu/ops/pallas/residual_kernel.py:53",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": lvl0[3],
        "plain_ms": lvl0[4],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
