#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (``vors_track``'s streaming tracker) on the card
at 640x480 with 6 pyramid levels and 8192 candidates per level, and fails
(non-zero exit, no result line) unless every phase passes:

0. Build the CUDA sources (``csrc/residual_reduce.cu``, ``csrc/lm_solve.cu``
   and the empty kernel ``csrc/launch_floor.cu``), one ``nvcc`` each, all
   started together.
1. Hold the fused LM evaluation ``residual_reduce`` against its plain torch
   twin at every level shape of a 640x480 keyframe (at the level caps and at
   the buckets the tracker slices them to), at a ragged candidate count and
   with no valid candidate.  Time both per evaluation (CUDA events, median
   of 100), beside an empty kernel's launch-to-completion time.
2. Hold the per-level LM solver ``lm_solve_level`` against its plain version
   ``solve_level_reference`` (the Python LM loop) at every level shape and
   on the edge cases: no valid candidate, an iteration cap of 1, a frame
   whose coarsest level fails.  Two runs of a solve must be bit-equal.  Time
   both per solve.
3. The per-evaluation path: track 8 frames on CUDA with the Python LM
   loop, every evaluation one ``residual_reduce`` launch.
4. The main path: track 40 frames of a synthetic 640x480 sequence through
   ``init_tracker`` and ``Tracker.track`` on CUDA, with bucketing on.  Every
   level of every frame must be exactly one ``lm_solve_level`` launch and no
   ``residual_reduce`` launch; no frame may fail; at least one keyframe
   switch; the ATE must stay within 1.5x the JAX package's ATE on the same
   sequence.  Then 10 more steady frames under ``torch.profiler`` count the
   kernel launches and the device→host copies per frame.
5. Track the first frames again on the CPU (the plain versions) and compare
   poses.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit, and the one before that lists the kernels with
their launches, errors, times and bounds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HEIGHT, WIDTH, LEVELS, CAP = 480, 640, 6, 8192
FRAMES = 41  # frame 0 initializes, 40 are tracked
PROFILED_FRAMES = 10  # tracked after the 40, under the profiler
PROFILER_ATTEMPTS = 3  # the tracer now and then records nothing: such a run is made again
REFERENCE_FRAMES = 9  # frame 0 + 8 tracked by the per-evaluation path
TWIST = [0.01, 0.004, 0.0, 0.0, 0.002, 0.001]  # per frame: about 5 keyframe switches
# ATE of the JAX package (visual_odometry_rs_tpu, CPU backend, gather
# sampling, bucketing on) on this exact sequence and configuration
JAX_ATE = 0.001173417615140308
ATE_BOUND = 1.5 * JAX_ATE
CPU_FRAMES = 5  # frames re-tracked on the CPU in the last phase
# evaluation kernel against twin: energy rtol; g and H after scaling by their max
E_RTOL, GH_RTOL, GH_ATOL = 1e-5, 1e-4, 1e-5
# solver kernel against the Python loop: the scalar step differs by ulps (FMA
# contraction, another Cholesky), which moves the pose by far less than this,
# and may flip one accept/continue decision within an ulp of energy_tol
SOLVE_T_ATOL, SOLVE_Q_ATOL, SOLVE_E_RTOL, SOLVE_ITER_SLACK = 1e-5, 1e-6, 1e-3, 1
FLOW_RTOL = 1e-4  # the kernel's flow against torch's, on poses that differ by the above
POSE_ATOL = 5e-3
SOURCES = ("residual_reduce", "lm_solve", "launch_floor")
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
# f32 operations of one evaluation, counted in csrc/residual_eval.cuh: warp and
# domain test for every candidate, sampling and the 29 sums for inside ones
FLOPS_WARP, FLOPS_INSIDE = 47, 71
CANDIDATE_BYTES = 4 * 4 + 1 + 6 * 4  # xs, ys, idepth, tmpl; valid; a Jacobian row
FIELDS = ("xs", "ys", "idepth", "valid", "tmpl_vals", "jacobians")


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


def _device_us(fn, kernel_name, reps=50) -> float:
    """Device microseconds of one launch of the kernel whose name contains
    ``kernel_name``: the mean over the launches that a ``torch.profiler`` run
    of ``reps`` calls recorded.  The tracer now and then drops a launch or a
    whole run, so a run that recorded fewer than half is made again."""
    from visual_odometry_rs_tpu_torch.utils import profiling

    for _ in range(PROFILER_ATTEMPTS):
        prof = profiling.profile_device(lambda: [fn() for _ in range(reps)])
        calls = sum(n for name, n in prof.kernel_calls.items() if kernel_name in name)
        if reps // 2 <= calls <= reps:
            return 1e3 * sum(ms for name, ms in prof.kernel_ms.items() if kernel_name in name) / calls
    raise AssertionError(f"profiler: {PROFILER_ATTEMPTS} runs recorded no {reps} launches of {kernel_name}")


def _bound(n, image_shape, inside, evaluations, out_floats):
    """Least time the card could take: ``(ms, "bytes" | "operations")``.
    Every input read once (candidates, the u8 image, 12 or 13 parameters),
    the output written once; the operations of ``evaluations`` evaluations
    with ``inside`` candidates in the domain."""
    nbytes = n * CANDIDATE_BYTES + image_shape[0] * image_shape[1] + 4 * 13 + 4 * out_floats
    flops = evaluations * (n * FLOPS_WARP + inside * FLOPS_INSIDE)
    by_bytes, by_ops = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _level_sets(seq, dev):
    """The keyframe of frame 0 at the level caps and as the tracker buckets
    it, the pyramid of frame 1 and a pose near the solution."""
    import torch

    from visual_odometry_rs_tpu_torch.math import se3
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid

    kwargs = dict(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP)
    kf = tracker_mod.precompute_keyframe(
        tracker_mod.TrackerConfig(**kwargs), seq.intrinsics.to(dev),
        torch.from_numpy(seq.depths[0].astype("int32")).to(dev),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[0]).to(dev)),
    )
    ts = float(seq.timestamps[0])
    bucketed = tracker_mod.init_tracker(
        tracker_mod.TrackerConfig(**kwargs, bucket_candidates=True), seq.intrinsics,
        ts, seq.depths[0], ts, seq.grays[0], device=dev,
    ).keyframe_data
    pyr1 = pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[1]).to(dev))
    model = se3.exp(torch.tensor([0.005, -0.003, 0.002, 0.001, 0.002, -0.001], device=dev))
    return kf, bucketed, pyr1, model


def _launch_floor_ms(dev) -> float:
    """An empty kernel's launch-to-completion time: median of 200, each timed
    on the host clock from the launch call to the end of a synchronize."""
    import ctypes

    import torch

    from visual_odometry_rs_tpu_torch.ops import build

    lib = build.load("launch_floor")
    lib.vors_empty_launch.argtypes = [ctypes.c_void_p]
    lib.vors_empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = []
    for i in range(220):
        torch.cuda.synchronize()
        start = time.perf_counter()
        err = lib.vors_empty_launch(stream)
        torch.cuda.synchronize()
        if i >= 20:
            times.append(1e3 * (time.perf_counter() - start))
        if err != 0:
            raise AssertionError(f"empty kernel launch failed: CUDA error {err}")
    return statistics.median(times)


def phase_evaluation(kf, bucketed, pyr1, model):
    """``residual_reduce`` against its twin; returns (max err, timing rows)."""
    import torch

    from visual_odometry_rs_tpu_torch.ops import residual

    max_err, rows = 0.0, []
    for lvl in range(LEVELS):
        image = pyr1[lvl]
        params = torch.cat([model.q, model.t, kf.levels[lvl].intrinsics.vector()])
        cases = [("cap", kf.levels[lvl]), ("bucket", bucketed.levels[lvl])]
        if lvl == 0:
            obs = kf.levels[0]
            cut = obs.xs.shape[0] - 192  # not a multiple of the 256-thread block
            cases.append(("ragged", obs._replace(**{f: getattr(obs, f)[:cut] for f in FIELDS})))
            cases.append(("all-invalid", obs._replace(valid=torch.zeros_like(obs.valid))))
        for label, o in cases:
            args = (image, o.xs, o.ys, o.idepth, o.tmpl_vals, o.valid, o.jacobians, params)
            got = residual.residual_reduce(*args)
            ref = residual.residual_reduce_reference(*args)
            torch.cuda.synchronize()
            n_valid = int(o.valid.sum())
            err = _check_close(f"level {lvl} {label}", got, ref, n_valid)
            max_err = max(max_err, err)
            print(f"evaluation kernel-vs-twin level {lvl} {label}: image {tuple(image.shape)} "
                  f"N={o.xs.shape[0]} valid={n_valid} scaled_max_abs_err={err:.3e} ok")
            if label in ("cap", "bucket"):
                out = torch.empty(residual.OUT_SIZE, device=image.device)
                k_ms = _time_ms(lambda: residual.residual_reduce(*args, out=out))
                t_ms = _time_ms(lambda: residual.residual_reduce_reference(*args))
                d_us = _device_us(lambda: residual.residual_reduce(*args, out=out), "residual_reduce_kernel")
                n = o.xs.shape[0]
                b_ms, b_by = _bound(n, image.shape, float(got[2]), 1, residual.OUT_SIZE)
                rows.append(dict(level=lvl, shape=label, n=n, ms=k_ms, plain_ms=t_ms,
                                 bound_ms=b_ms, bound_by=b_by))
                print(f"time per evaluation level {lvl} {label} N={n}: kernel {k_ms:.4f} ms, twin "
                      f"{t_ms:.4f} ms (CUDA events around one call, median of 100); on the device "
                      f"{d_us:.2f} us (profiler, mean of 50); bound {b_ms:.6f} ms by {b_by}")
    print(f"tolerance: energy rtol {E_RTOL}; g, H rtol {GH_RTOL} atol {GH_ATOL} after scaling by "
          f"max|twin|+1; inside count equal")
    return max_err, rows


def _compare_solves(name, out, ref):
    """The solver kernel's result against the Python loop's; returns the
    largest pose difference."""
    import torch

    nb_iter, failed = int(out.nb_iter), bool(out.failed)
    if failed != bool(ref.failed):
        raise AssertionError(f"{name}: failed {failed} vs {ref.failed}")
    if abs(nb_iter - int(ref.nb_iter)) > SOLVE_ITER_SLACK:
        raise AssertionError(f"{name}: nb_iter {nb_iter} vs {ref.nb_iter}")
    dt = float((out.state.model.t - ref.state.model.t).abs().max())
    dq = float((out.state.model.q - ref.state.model.q).abs().max())
    if not (dt <= SOLVE_T_ATOL and dq <= SOLVE_Q_ATOL):
        raise AssertionError(f"{name}: pose differs, |dt| {dt} |dq| {dq}")
    e, e_ref = float(out.state.energy), float(ref.state.energy)
    both_nan = e != e and e_ref != e_ref
    if not (both_nan or abs(e - e_ref) <= SOLVE_E_RTOL * abs(e_ref)):
        raise AssertionError(f"{name}: energy {e} vs {e_ref}")
    print(f"solver kernel-vs-loop {name}: nb_iter {nb_iter}/{int(ref.nb_iter)} failed {failed} "
          f"energy {e:.6g}/{e_ref:.6g} |dt| {dt:.3e} |dq| {dq:.3e} ok")
    return max(dt, dq)


def phase_solver(config, kf, bucketed, pyr1, model):
    """``lm_solve_level`` against ``solve_level_reference``; returns
    (max pose err, timing rows)."""
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve

    dev = model.q.device
    identity = pose_mod.identity(device=dev)
    max_err, rows = 0.0, []
    for lvl in reversed(range(LEVELS)):
        image = pyr1[lvl]
        for label, obs in (("cap", kf.levels[lvl]), ("bucket", bucketed.levels[lvl])):
            for start_name, start in (("identity", identity), ("near", model)):
                out = tracker_mod.solve_level(obs, image, start)
                again = tracker_mod.solve_level(obs, image, start)
                ref = tracker_mod.solve_level_reference(obs, image, start)
                torch.cuda.synchronize()
                name = f"level {lvl} {label} N={obs.xs.shape[0]} from {start_name}"
                max_err = max(max_err, _compare_solves(name, out, ref))
                if not (torch.equal(out.state.model.q, again.state.model.q)
                        and torch.equal(out.state.model.t, again.state.model.t)
                        and torch.equal(out.state.energy, again.state.energy)):
                    raise AssertionError(f"{name}: two runs of the same solve are not bit-equal")
            # time the solve from identity: the start of a frame after a switch
            n = obs.xs.shape[0]
            record = torch.empty(lm_solve.RECORD_SIZE, device=dev)
            state_in, intr = tracker_mod._start_state(identity), obs.intrinsics.vector()

            def launch(cluster=None):
                lm_solve.lm_solve_level(
                    image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
                    intr, state_in, record, lm_coef_init=0.1, max_iterations=20, energy_tol=1.0,
                    cluster=cluster)

            k_ms = _time_ms(launch)
            d_us = _device_us(launch, "lm_solve_level_kernel")
            p_ms = _time_ms(lambda: tracker_mod.solve_level_reference(obs, image, identity),
                            reps=5, warmup=1)
            evals = int(record[lm_solve.NB_EVALS])
            inside = _inside_count(obs, image, identity)  # at the start pose
            b_ms, b_by = _bound(n, image.shape, inside, evals, lm_solve.RECORD_SIZE)
            rows.append(dict(level=lvl, shape=label, n=n, ms=k_ms, plain_ms=p_ms, evals=evals,
                             bound_ms=b_ms, bound_by=b_by))
            print(f"time per solve level {lvl} {label} N={n} from identity, {evals} evaluations: "
                  f"kernel {k_ms:.4f} ms (median of 100), Python loop {p_ms:.3f} ms (median of 5), "
                  f"CUDA events around one call; on the device {d_us:.2f} us (profiler, mean of 50); "
                  f"bound {b_ms:.6f} ms by {b_by}")
            load, sums, reduce, scalar, whole = record[lm_solve.PHASE_CYCLES].tolist()
            print(f"  clock cycles of thread 0: candidates loaded in {load:.0f}; per evaluation "
                  f"sums {sums / evals:.0f}, reduction {reduce / evals:.0f}, scalar step "
                  f"{scalar / evals:.0f}; whole kernel {whole:.0f}")
            if (lvl, label) == (1, "cap"):  # one block striding over the level against the cluster
                one_us = _device_us(lambda: launch(1), "lm_solve_level_kernel")
                print(f"  the same solve as one block of 256 threads (cluster of 1): {one_us:.2f} us "
                      f"on the device against {d_us:.2f} us as a cluster of 8")

    # edge cases
    lvl = 2
    obs, image = bucketed.levels[lvl], pyr1[lvl]
    invalid = obs._replace(valid=torch.zeros_like(obs.valid))
    out = tracker_mod.solve_level(invalid, image, model)
    ref = tracker_mod.solve_level_reference(invalid, image, model)
    _compare_solves("no valid candidate", out, ref)
    if not (bool(out.failed) and int(out.nb_iter) == 1 and torch.equal(out.state.model.t, model.t)
            and torch.equal(out.state.model.q, model.q) and bool(torch.isnan(out.state.energy))):
        raise AssertionError("no valid candidate: expected failed at iteration 1, NaN energy, pose kept")
    out = tracker_mod.solve_level(obs, image, identity, max_iterations=1)
    ref = tracker_mod.solve_level_reference(obs, image, identity, max_iterations=1)
    max_err = max(max_err, _compare_solves("iteration cap 1", out, ref))
    if int(out.nb_iter) != 2:
        raise AssertionError(f"iteration cap 1: nb_iter {int(out.nb_iter)}, expected 2")
    # a whole frame: six chained launches, the flow computed by the last one
    out = tracker_mod.track_frame(config, bucketed, pyr1, identity)
    ref = tracker_mod.track_frame_reference(config, bucketed, pyr1, identity)
    torch.cuda.synchronize()
    dt = float((out.model.t - ref.model.t).abs().max())
    flow, flow_ref = float(out.flow), float(ref.flow)
    iters, ref_iters = out.nb_iters.tolist(), ref.nb_iters.tolist()
    if (bool(out.failed) or bool(ref.failed) or dt > SOLVE_T_ATOL
            or abs(flow - flow_ref) > FLOW_RTOL * abs(flow_ref)
            or any(abs(a - b) > SOLVE_ITER_SLACK for a, b in zip(iters, ref_iters))):
        raise AssertionError(f"frame: |dt| {dt}, flow {flow} vs {flow_ref}, nb_iters {iters} vs {ref_iters}")
    max_err = max(max_err, dt)
    print(f"solver kernel-vs-loop whole frame: nb_iters {iters}/{ref_iters} |dt| {dt:.3e} "
          f"flow {flow:.6f}/{flow_ref:.6f} px (rtol {FLOW_RTOL}) ok")
    # a frame whose coarsest level fails: the pose stays frozen, later levels report iterations
    levels = list(bucketed.levels)
    levels[-1] = levels[-1]._replace(valid=torch.zeros_like(levels[-1].valid))
    broken = tracker_mod.KeyframeData(levels=tuple(levels))
    out = tracker_mod.track_frame(config, broken, pyr1, model)
    ref = tracker_mod.track_frame_reference(config, broken, pyr1, model)
    torch.cuda.synchronize()
    if not (bool(out.failed) and bool(ref.failed) and torch.equal(out.model.t, model.t)
            and torch.equal(out.model.q, model.q)):
        raise AssertionError("failed coarsest level: the frame must fail and keep its pose")
    iters, ref_iters = out.nb_iters.tolist(), ref.nb_iters.tolist()
    if iters[-1] != 1 or min(iters) < 1 or any(abs(a - b) > SOLVE_ITER_SLACK for a, b in zip(iters, ref_iters)):
        raise AssertionError(f"failed coarsest level: nb_iters {iters} vs {ref_iters}")
    print(f"solver kernel-vs-loop failed coarsest level: failed, pose frozen, nb_iters {iters}/{ref_iters} ok")
    print(f"tolerance: failed equal; |nb_iter difference| <= {SOLVE_ITER_SLACK}; t atol {SOLVE_T_ATOL} m; "
          f"q atol {SOLVE_Q_ATOL}; energy rtol {SOLVE_E_RTOL}; two runs bit-equal")
    return max_err, rows


def _inside_count(obs, image, model) -> float:
    import torch

    from visual_odometry_rs_tpu_torch.ops import residual

    params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
    return float(residual.residual_reduce_reference(
        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params)[2])


def _track(seq, frames, device, tracker_class=None, tracker=None, first=1):
    """Tracks frames ``first..frames-1`` through ``Tracker.track`` (a new
    tracker from frame 0 unless one is given); returns (tracker, poses,
    per-frame seconds, evaluations)."""
    import torch

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

    config = tracker_mod.TrackerConfig(
        height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP, bucket_candidates=True
    )
    ts = seq.timestamps
    trk = tracker
    if trk is None:
        trk = (tracker_class or tracker_mod.Tracker)(
            config, seq.intrinsics, float(ts[0]), seq.depths[0], float(ts[0]), seq.grays[0], device=device
        )
    poses, seconds, evaluations = [trk.current_frame()[1]], [], 0
    for f in range(first, frames):
        start = time.perf_counter()
        trk.track(float(ts[f]), seq.depths[f], float(ts[f]), seq.grays[f])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        if trk.last_failed:
            raise AssertionError(f"frame {f} failed on {device}")
        evaluations += sum(trk.last_nb_evals)
        poses.append(trk.current_frame()[1])
    return trk, poses, seconds, evaluations


def _frame_times(label, seconds):
    ms = [1e3 * s for s in seconds]
    steady = ms[1:]
    print(f"{label} per-frame ms: first {ms[0]:.2f}, median {statistics.median(steady):.3f}, "
          f"mean {statistics.mean(steady):.3f}, max {max(steady):.3f} (frames 2..{len(ms)}); "
          f"fps {1e3 / statistics.mean(steady):.1f}")


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
    from visual_odometry_rs_tpu_torch.ops import build, lm_solve, residual
    from visual_odometry_rs_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's matmul in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}")

    # phase 0: build
    start = time.perf_counter()
    built = build.build_all(SOURCES)
    print(f"kernel build: {len(SOURCES)} sources in parallel, {time.perf_counter() - start:.2f} s")
    for name, (_, build_s, ptxas) in built.items():
        print(f"  {name}: {build_s:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    seq = synthetic.generate_sequence(
        nb_frames=FRAMES + PROFILER_ATTEMPTS * PROFILED_FRAMES, height=HEIGHT, width=WIDTH, seed=0, twist_per_frame=TWIST
    )
    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP)
    kf, bucketed, pyr1, model = _level_sets(seq, dev)

    # phases 1 and 2: each kernel against its plain version
    floor_ms = _launch_floor_ms(dev)
    print(f"empty kernel, launch to completion (host clock, median of 200): {floor_ms:.4f} ms")
    eval_err, eval_rows = phase_evaluation(kf, bucketed, pyr1, model)
    solve_err, solve_rows = phase_solver(config, kf, bucketed, pyr1, model)

    # phase 3: the per-evaluation path (Python LM loop) on CUDA
    class ReferenceTracker(tracker_mod.Tracker):
        _track_frame = staticmethod(tracker_mod.track_frame_reference)

    residual.residual_reduce.launches = 0
    lm_solve.lm_solve_level.launches = 0
    _, ref_poses, ref_seconds, ref_evals = _track(seq, REFERENCE_FRAMES, dev, ReferenceTracker)
    eval_launches = residual.residual_reduce.launches
    if eval_launches != ref_evals or eval_launches == 0 or lm_solve.lm_solve_level.launches != 0:
        raise AssertionError(f"per-evaluation path: {eval_launches} launches for {ref_evals} evaluations")
    print(f"per-evaluation path: {REFERENCE_FRAMES - 1} frames, {ref_evals} evaluations = "
          f"{eval_launches} residual_reduce launches")
    _frame_times("per-evaluation path", ref_seconds)

    # phase 4: the main path on CUDA
    residual.residual_reduce.launches = 0
    lm_solve.lm_solve_level.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trk, poses, seconds, evaluations = _track(seq, FRAMES, dev)
    solve_launches = lm_solve.lm_solve_level.launches
    if solve_launches != LEVELS * (FRAMES - 1):
        raise AssertionError(f"lm_solve_level launches {solve_launches} != {LEVELS} x {FRAMES - 1}")
    if residual.residual_reduce.launches != 0:
        raise AssertionError("the main path launched residual_reduce: it ran the Python loop")
    if evaluations <= 0:
        raise AssertionError("the device reported no evaluation")
    if trk.keyframe_switches < 1:
        raise AssertionError("no keyframe switch")
    err = ate.ate_rmse(poses, seq.poses[:FRAMES])
    print(f"track: {FRAMES - 1} frames at {WIDTH}x{HEIGHT}, {LEVELS} levels, cap {CAP}, bucketing on; "
          f"keyframe switches {trk.keyframe_switches}; failed frames 0; lm_solve_level launches "
          f"{solve_launches}; evaluations reported by the device {evaluations}")
    _frame_times("main path", seconds)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"ATE {err:.6e} m; bound {ATE_BOUND:.6e} m = 1.5 x JAX package ATE {JAX_ATE:.6e} m")
    if not err <= ATE_BOUND:
        raise AssertionError(f"ATE {err} above bound {ATE_BOUND}")
    drift = max(float((a.t - b.t).abs().max()) for a, b in zip(poses, ref_poses))
    print(f"main path vs per-evaluation path over {REFERENCE_FRAMES - 1} frames: max |dt| {drift:.3e} m "
          f"(atol {POSE_ATOL})")
    if not drift <= POSE_ATOL:
        raise AssertionError(f"the two CUDA paths differ by {drift}")

    # the same tracker goes on for 10 frames under the profiler; a run in
    # which the tracer lost events is made again on the next 10 frames
    for attempt in range(PROFILER_ATTEMPTS):
        switches = trk.keyframe_switches
        first = FRAMES + attempt * PROFILED_FRAMES
        prof = profiling.profile_device(
            lambda: _track(seq, first + PROFILED_FRAMES, dev, tracker=trk, first=first)
        )
        switched = trk.keyframe_switches - switches
        copies = prof.device_to_host_copies
        solves = sum(n for name, n in prof.kernel_calls.items() if "lm_solve_level_kernel" in name)
        print(f"profile of {PROFILED_FRAMES} more frames ({switched} keyframe switches): "
              f"{prof.launches / PROFILED_FRAMES:.1f} kernel launches per frame; {copies} device-to-host "
              f"copies = {copies / PROFILED_FRAMES:.1f} host reads per frame; {solves} solver kernels; "
              f"device busy {100 * prof.busy_share:.2f}% of {prof.wall_ms:.1f} ms (profiler on)")
        if solves == LEVELS * PROFILED_FRAMES and copies == PROFILED_FRAMES + switched:
            break
    else:
        raise AssertionError(
            f"expected {LEVELS} solver kernels and one host read per frame, and one more read per "
            f"keyframe switch, in {PROFILER_ATTEMPTS} profiled runs"
        )

    # phase 5: the same first frames on the CPU (the plain versions)
    _, cpu_poses, _, _ = _track(seq, CPU_FRAMES, torch.device("cpu"))
    diff = max(float((g.t.cpu() - c.t).abs().max()) for g, c in zip(poses[:CPU_FRAMES], cpu_poses))
    print(f"CUDA vs CPU over {CPU_FRAMES} frames: max |dt| {diff:.3e} m (atol {POSE_ATOL})")
    if not diff <= POSE_ATOL:
        raise AssertionError(f"CUDA and CPU poses differ by {diff}")

    def row(rows):  # level 0 as the tracker buckets it
        return next(r for r in rows if r["level"] == 0 and r["shape"] == "bucket")

    replaces = "visual_odometry_rs_tpu/ops/pallas/residual_kernel.py:53"
    kernels = []
    for name, source, launches, max_err, r in (
        ("residual_reduce", "residual_reduce.cu", eval_launches, eval_err, row(eval_rows)),
        ("lm_solve_level", "lm_solve.cu", solve_launches, solve_err, row(solve_rows)),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"visual_odometry_rs_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
