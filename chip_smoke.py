#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main path (``vors_track``'s streaming tracker) on the card
at 640x480 with 6 pyramid levels and 8192 candidates per level, and fails
(non-zero exit, no result line) unless every phase passes:

0. Build the CUDA sources (``csrc/residual_reduce.cu``, ``csrc/lm_solve.cu``
   and the empty kernel ``csrc/launch_floor.cu``), one ``nvcc`` each, and
   the PNG library ``csrc/vors_io.cpp`` with ``g++``, all started together.
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
6. The batched tracker (``parallel.batch``, the ``vors_batch`` path) at the
   width of ``bench.py``'s ``fps_scan_b32_diverse`` row: 32 diverse lanes at
   640x480, 6 levels, cap 4096, 10 tracked frames in clips of 8, at cadence
   1 and 4.  Every frame must make exactly 6 ``lm_solve_level`` launches for
   the whole batch; the host may read the device only on check frames and
   once per clip (profiler counts; a steady frame runs under CUDA's sync
   debug mode); cadence 1 must be bit-equal per lane to the streaming
   ``Tracker`` on the card; at cadence 4 switches only on frames with
   ``(t + 1) % 4 == 0``; no lane may fail.  The lane-axis launch is held
   against ``track_frame_reference`` lane by lane on 2 lanes x 3 frames.
   Prints the card's frames per second at both cadences beside the
   streaming tracker's, the launches, host reads and busy share of a steady
   and a check frame, batched against single-lane precomputes, and the
   device time of one lane-axis solve per level against its bound.

7. The tracker options.  (a) Each option's instantiation of both kernels
   (Huber weights with delta 10, the brightness model, both) against its
   plain version at the six level shapes, with phases 1 and 2's tolerances,
   two runs bit-equal, and the registers and local memory of each build;
   the lost-frame detector against ``_eval_energy`` and its cost; three
   keyframes tracking one frame through the image index, one lane inactive,
   against one-lane launches.  The per-evaluation path with each option.
   (b) Three 40-frame streaming runs at 640x480, cap 8192, bucketing on,
   each beside the default configuration on the same frames: Huber +
   brightness on an exposure drift, ``dso_fixed`` with a = 0.2, and
   relocalization (K = 4) on the kidnap of ``tests/test_relocalize.py``;
   one solver launch per level and frame (and per relocalization attempt),
   no ``residual_reduce``, no failed frame but the jump, the ATE within 1.5x
   the JAX package's (``chip_smoke_reference.py``), the kidnap relocalized.
   Huber alone and brightness alone are timed too.  (c) Phase 6's 32 lanes
   with Huber, ``dso_fixed`` and a ring of 4, one lane kidnapped: 12 solver
   launches a frame, only that lane relocalized, no other lane failed, a
   steady frame without a host read under CUDA's sync debug mode; wall
   times against the same options without the ring and the default.
8. The front end from files (phase 0 also builds the port's PNG library,
   ``csrc/vors_io.cpp``, with ``g++``; it must load).  (a) The library must
   be available.  (b) Phase 4's 41 frames and ground truth written as PNGs
   by the port's writer, read back bit-equal; decode ms per depth+gray pair
   on one thread and through the prefetching loader.  (c) ``vors_track fr1``
   through its ``main`` on the files: the 40 poses bit-equal to phase 4's
   and six solver launches a frame; its wall and ``--metrics`` times beside
   phase 4's.  (d) ``--save-state`` after frame 20 and ``--resume`` to frame
   40, with and without the velocity carry: bit-equal to the uninterrupted
   runs; the checkpoint's bytes and save and load ms.  (e) ``--chunk 8``:
   bit-equal to the streaming CLI with ``--no-bucket``, within phase 4's
   tolerance of (c).  (f) ``vors_batch`` on phase 6's 32 lanes as PNGs with
   ``--chunk 8 --switch-cadence 4 --relocalize 4``: every lane's file of a
   run split at frame 5 by ``--save-state``/``--resume`` equal to the
   straight run's.  (g) ``vors_eval`` on (c)'s trajectory: the ATE equal to
   phase 4's to 1e-9 relative.

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
# phase 6: bench.py's fps_scan_b32_diverse lanes (bench.py:110-145)
LANES, LANE_FRAMES, LANE_CAP, LANE_CHUNK = 32, 10, 4096, 8
LANE_CADENCES = (1, 4)
LANE_TIMED_RUNS = 3  # timed runs of each cadence, in turns
PRECOMPUTE_LANES = (1, 4, 32)
PLAIN_LANES, PLAIN_FRAMES = 2, 3  # the lane-axis launch against the per-lane loop
# phase 7: the tracker options
OPTIONS = {  # the solver instantiations beside the plain one
    "huber": dict(robust_delta=10.0),
    "brightness": dict(brightness_model=True),
    "huber+brightness": dict(robust_delta=10.0, brightness_model=True),
}
EVAL_AB = (1.1, -6.0)  # the gain and bias the evaluations are held at
AB_RTOL, AB_ATOL = 1e-4, 1e-3  # a brightness solve's (a, b) against the Python loop's
# an option's solve against the Python loop: the pose and energy tolerances
# of phase 2; nb_iter within 2, not 1: on an exposure-drifted frame the
# brightness solve has a flat tail where new_energy > energy is decided
# within ulps, and one flipped accept/reject changes lambda tenfold (first
# seen on the card: Huber + brightness at level 5, 11 against 13 iterations,
# with the pose within the tolerances)
OPTION_ITER_SLACK = 2
# f32 operations per inside candidate and evaluation, counted in
# csrc/residual_eval.cuh: the plain 71; Huber adds |r|, the test, a division,
# a max, w J and w r; brightness 15 more sums and a T + b
FLOPS_INSIDE_OF = {"plain": 71, "huber": 82, "brightness": 107, "huber+brightness": 120}
DSO_A = 0.2  # the DSO threshold coefficient of the accuracy matrix's dso rows
RELOC_WINDOW = 4
# tests/test_relocalize.py:93: four steps away, a jump back to the start, then small steps
KIDNAP_STEP = [0.09, 0.01, 0.005, 0.0, 0.06, 0.0]
KIDNAP_SMALL = [0.01, 0.002, 0.001, 0.0, 0.005, 0.0]
KIDNAP_SEED, KIDNAP_JUMP = 23, 5  # frame 5 is the jump back
# ATE of the JAX package (CPU backend, gather sampling, bucketing on) on
# phase 7's sequences, by chip_smoke_reference.py
JAX_ATE_OPTIONS = {
    "huber+brightness": 0.0007520390074865462,
    "dso_fixed": 0.0024236515889716815,
    "relocalize": 0.18893304635673777,
}
OPTION_PROFILED_FRAMES = 10  # the last frames of a run, under the profiler
# the batched run: phase 6's lanes with Huber, dso_fixed and a ring; lane 5
# shows the kidnap scene instead: carried away on frames 2-7 in six kidnap
# steps (Huber follows four back without a relocalization) and returned on
# frame 8 to where it was on frame 1
BATCH_KIDNAP_LANE, BATCH_KIDNAP_STEPS = 5, 6
# phase 8: the front end from files
NATIVE = "vors_io"  # the port's PNG library, host C++ (csrc/vors_io.cpp)
RESUME_AT = 20  # the streaming CLI saves after frame 20 and resumes from there
LANE_SPLIT = 5  # the batch CLI saves after frame 5 (--max-frames) and resumes
PREFETCH_THREADS = 4
CKPT_REPS = 5  # timed saves and loads of a checkpoint


def drift_grays(grays):
    """An auto-exposure drift over a sequence: frame f scaled by 1 + 0.2
    sin(2 pi f / 16) and offset by 12 sin(2 pi f / 11 + 1) (frame 0 as it
    is), clipped to u8."""
    import numpy as np

    f = np.arange(len(grays), dtype=np.float64)[:, None, None]
    gain = 1.0 + 0.2 * np.sin(2 * np.pi * f / 16)
    bias = 12.0 * np.sin(2 * np.pi * f / 11 + 1.0) * (f > 0)
    return np.clip(gain * grays.astype(np.float64) + bias, 0, 255).astype(np.uint8)


def kidnap_twists(frames):
    """Twists of a kidnap: four steps away, one jump back to the start, then
    small steps, ``frames - 1`` twists in all."""
    import numpy as np

    step = np.asarray(KIDNAP_STEP)
    return np.asarray([step] * 4 + [-4.0 * step] + [KIDNAP_SMALL] * (frames - 6), np.float32)


def batch_kidnap_twists():
    """The batched run's kidnapped lane: a small step, the kidnap steps, the
    jump back, small steps (``LANE_FRAMES`` twists)."""
    import numpy as np

    step, n = np.asarray(KIDNAP_STEP), BATCH_KIDNAP_STEPS
    return np.asarray([KIDNAP_SMALL] + [step] * n + [-n * step] + [KIDNAP_SMALL] * (LANE_FRAMES - n - 2), np.float32)


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
    for part, ref_part in ((m[:, -1], m_ref[:, -1]), (m[:, :-1], m_ref[:, :-1])):
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


def _bound(n, image_shape, inside, evaluations, out_floats, flops_inside=FLOPS_INSIDE):
    """Least time the card could take: ``(ms, "bytes" | "operations")``.
    Every input read once (candidates, the u8 image, 12 or 13 parameters),
    the output written once; the operations of ``evaluations`` evaluations
    with ``inside`` candidates in the domain (``flops_inside`` each, the
    option's count).  For a launch of several lanes ``inside`` and
    ``evaluations`` are lists, one entry a lane."""
    import numpy as np

    inside, evaluations = np.atleast_1d(inside), np.atleast_1d(evaluations)
    nbytes = len(inside) * (n * CANDIDATE_BYTES + image_shape[0] * image_shape[1] + 4 * 13 + 4 * out_floats)
    flops = float(np.sum(evaluations * (n * FLOPS_WARP + inside * flops_inside)))
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


def _solved_pose(model):
    """The pose of a solve's model: itself, or a brightness state's pose."""
    return getattr(model, "pose", model)


def _compare_solves(name, out, ref, iter_slack=SOLVE_ITER_SLACK):
    """The solver kernel's result against the Python loop's; returns the
    largest pose difference."""
    import torch

    nb_iter, failed = int(out.nb_iter), bool(out.failed)
    if failed != bool(ref.failed):
        raise AssertionError(f"{name}: failed {failed} vs {ref.failed}")
    if abs(nb_iter - int(ref.nb_iter)) > iter_slack:
        raise AssertionError(f"{name}: nb_iter {nb_iter} vs {ref.nb_iter}")
    got, want = _solved_pose(out.state.model), _solved_pose(ref.state.model)
    dt = float((got.t - want.t).abs().max())
    dq = float((got.q - want.q).abs().max())
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


def _track(seq, frames, device, tracker_class=None, tracker=None, first=1, grays=None, may_fail=(), **options):
    """Tracks frames ``first..frames-1`` through ``Tracker.track`` (a new
    tracker from frame 0 unless one is given, with the configuration's
    ``options``; ``grays`` replaces the sequence's images); a frame not in
    ``may_fail`` must not fail.  Returns (tracker, poses, per-frame seconds,
    evaluations)."""
    import torch

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

    config = tracker_mod.TrackerConfig(
        height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP, bucket_candidates=True, **options
    )
    ts = seq.timestamps
    grays = seq.grays if grays is None else grays
    trk = tracker
    if trk is None:
        trk = (tracker_class or tracker_mod.Tracker)(
            config, seq.intrinsics, float(ts[0]), seq.depths[0], float(ts[0]), grays[0], device=device
        )
    poses, seconds, evaluations = [trk.current_frame()[1]], [], 0
    for f in range(first, frames):
        start = time.perf_counter()
        trk.track(float(ts[f]), seq.depths[f], float(ts[f]), grays[f])
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        if trk.last_failed and f not in may_fail:
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


def _diverse_lanes():
    """``bench.py``'s diverse lanes (bench.py:130-145): a magnitude ladder of
    0.004-0.04 m per frame, a direction and a rotation of 0.002 rad scale
    from ``default_rng(42)``, texture seed 100 + lane, the fr1 intrinsics.
    Returns the intrinsics and (F + 1, B, H, W) depths and grays."""
    import numpy as np

    from visual_odometry_rs_tpu_torch.dataset import synthetic

    rng = np.random.default_rng(42)
    seqs = []
    for lane in range(LANES):
        mag = 0.004 + 0.036 * lane / (LANES - 1)
        direction = rng.normal(size=3)
        direction = mag * direction / np.linalg.norm(direction)
        rot = 0.002 * rng.normal(size=3)
        seqs.append(synthetic.generate_sequence(
            nb_frames=LANE_FRAMES + 1, height=HEIGHT, width=WIDTH, seed=100 + lane,
            twist_per_frame=np.concatenate([direction, rot]),
        ))
    return (seqs[0].intrinsics, np.stack([s.depths for s in seqs], axis=1),
            np.stack([s.grays for s in seqs], axis=1))


def _check_frames(cadence):
    """Frames of a run on which the host reads the switch mask."""
    return sum((t + 1) % cadence == 0 for t in range(LANE_FRAMES))


def _batched_run(config, intrinsics, state, depths, grays, cadence, ring=None):
    """Tracks frames 1..F of every lane through ``batched_track_sequence``
    in clips of ``LANE_CHUNK`` frames, carrying the pending mask, the global
    frame index, the warm start and the relocalization ``ring`` if given;
    each clip's poses and diagnostics come back in one read.  Returns (q, t,
    diagnostics as numpy (F, B, …), seconds)."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.parallel import batch

    pending = prev = None
    parts = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for f0 in range(0, LANE_FRAMES, LANE_CHUNK):
        f1 = min(f0 + LANE_CHUNK, LANE_FRAMES)
        state, (poses, diags), pending, prev, *rest = batch.batched_track_sequence(
            config, intrinsics, state, depths[1 + f0:1 + f1], grays[1 + f0:1 + f1],
            switch_cadence=cadence, pending0=pending, frame_offset=f0, return_pending=True,
            reloc_ring=ring, prev_pose0=prev, return_prev=True,
        )
        ring = rest[0] if rest else None
        parts.append(batch.outputs_to_numpy(poses, diags))  # the clip's one read
    seconds = time.perf_counter() - start
    diags = batch.StepDiagnostics(*(np.concatenate(x) for x in zip(*(p[2] for p in parts))))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]), diags, seconds


def _lane_obs(obs, b):
    return obs._replace(**{f: getattr(obs, f)[b] for f in FIELDS})


def phase_lanes_vs_plain(config, intrinsics, depths, grays):
    """The lane-axis launch (``track_frame`` on a lane axis) against
    ``track_frame_reference`` lane by lane, on the first lanes and frames;
    returns the largest pose difference."""
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid
    from visual_odometry_rs_tpu_torch.parallel import batch

    dev = depths.device
    state = batch.batched_init_state(config, intrinsics, depths[0, :PLAIN_LANES], grays[0, :PLAIN_LANES], device=dev)
    one = pose_mod.identity(dev)
    start = pose_mod.Pose(one.q.expand(PLAIN_LANES, 4).contiguous(), one.t.expand(PLAIN_LANES, 3).contiguous())
    max_err = 0.0
    for f in range(1, PLAIN_FRAMES + 1):
        pyr = pyramid.mean_pyramid(LEVELS, grays[f, :PLAIN_LANES])
        out = tracker_mod.track_frame(config, state.kf, pyr, start)
        ref = tracker_mod.track_frame_reference(config, state.kf, pyr, start)
        torch.cuda.synchronize()
        dt = float((out.model.t - ref.model.t).abs().max())
        dq = float((out.model.q - ref.model.q).abs().max())
        flow, flow_ref = out.flow.tolist(), ref.flow.tolist()
        iters, ref_iters = out.nb_iters.tolist(), ref.nb_iters.tolist()
        if (out.failed.tolist() != ref.failed.tolist() or any(out.failed.tolist()) or dt > SOLVE_T_ATOL
                or dq > SOLVE_Q_ATOL or any(abs(a - b) > FLOW_RTOL * abs(b) for a, b in zip(flow, flow_ref))
                or any(abs(a - b) > SOLVE_ITER_SLACK for x, y in zip(iters, ref_iters) for a, b in zip(x, y))):
            raise AssertionError(f"lane axis vs per-lane loop, frame {f}: |dt| {dt} |dq| {dq} flow {flow} vs "
                                 f"{flow_ref} nb_iters {iters} vs {ref_iters}")
        max_err = max(max_err, dt, dq)
        print(f"lane-axis launch vs per-lane loop, {PLAIN_LANES} lanes, frame {f} from identity: nb_iters "
              f"{iters}/{ref_iters} |dt| {dt:.3e} |dq| {dq:.3e} flow {flow}/{flow_ref} ok")
    return max_err


def _streaming(config, intrinsics, depths, grays):
    """Every lane through the streaming ``Tracker`` on the card, one after
    the other: (q (F, B, 4), t (F, B, 3), switched (F, B), seconds)."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

    q = np.zeros((LANE_FRAMES, LANES, 4), np.float32)
    t = np.zeros((LANE_FRAMES, LANES, 3), np.float32)
    switched = np.zeros((LANE_FRAMES, LANES), bool)
    seconds = 0.0
    for b in range(LANES):
        trk = tracker_mod.init_tracker(config, intrinsics, 0.0, depths[0, b], 0.0, grays[0, b], device=depths.device)
        for f in range(LANE_FRAMES):
            switches = trk.keyframe_switches
            torch.cuda.synchronize()
            start = time.perf_counter()
            trk.track(float(f + 1), depths[f + 1, b], float(f + 1), grays[f + 1, b])
            seconds += time.perf_counter() - start  # the track's own read waits for the device
            if trk.last_failed:
                raise AssertionError(f"streaming lane {b} frame {f + 1} failed")
            pose = trk.current_frame()[1]
            q[f, b], t[f, b] = pose.q.numpy(), pose.t.numpy()
            switched[f, b] = trk.keyframe_switches > switches
    return q, t, switched, seconds


def _profiled(fn, expected_solves):
    """``fn`` under the profiler, made again if the tracer lost solver
    launches; returns (profile, fn's result)."""
    from visual_odometry_rs_tpu_torch.utils import profiling

    for _ in range(PROFILER_ATTEMPTS):
        box = []
        prof = profiling.profile_device(lambda: box.append(fn()))
        solves = sum(n for name, n in prof.kernel_calls.items() if "lm_solve_level_kernel" in name)
        if solves == expected_solves:
            return prof, box[0]
    raise AssertionError(f"profiler: {PROFILER_ATTEMPTS} runs did not record {expected_solves} solver launches")


def phase_batched(card, intrinsics, depths_np, grays_np, dev):
    """Phase 6; returns the kernel row of the lane-axis solver."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, pyramid, residual
    from visual_odometry_rs_tpu_torch.parallel import batch

    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP)
    intrinsics = intrinsics.to(dev)
    depths = torch.from_numpy(depths_np.astype(np.int32)).to(dev)  # uploads are set-up, not timed
    grays = torch.from_numpy(grays_np).to(dev)
    for lvl, n in enumerate(config.level_caps()):
        cluster = residual.cluster_size(n)
        print(f"level {lvl} N={n}: clusters of {cluster} blocks, {lm_solve.max_active_clusters(cluster)} "
              f"resident at once (cudaOccupancyMaxActiveClusters) for {LANES} lanes")
    plain_err = phase_lanes_vs_plain(config, intrinsics, depths, grays)
    state0 = batch.batched_init_state(config, intrinsics, depths[0], grays[0], device=dev)

    # the streaming tracker over the same 320 frames (bucketing off, so that
    # its solves have the batched shapes)
    s_q, s_t, s_switched, s_seconds = _streaming(config, intrinsics, depths, grays)
    frames = LANES * LANE_FRAMES
    print(f"streaming Tracker, {LANES} lanes one after the other, {LANE_FRAMES} frames each: "
          f"{1e3 * s_seconds:.1f} ms, {frames / s_seconds:.1f} fps; switches {int(s_switched.sum())}")

    # the main path: counts from 0, then cadence 1 and 4 in turns
    chunks = -(-LANE_FRAMES // LANE_CHUNK)
    residual.residual_reduce.launches = 0
    lm_solve.lm_solve_level.launches = 0
    q1, t1, diags1, _ = _batched_run(config, intrinsics, state0, depths, grays, 1)
    launches = lm_solve.lm_solve_level.launches
    if launches != LEVELS * LANE_FRAMES or residual.residual_reduce.launches != 0:
        raise AssertionError(f"batched cadence 1: {launches} lm_solve_level launches for {LANE_FRAMES} frames, "
                             f"{residual.residual_reduce.launches} residual_reduce")
    if not (np.array_equal(q1, s_q) and np.array_equal(t1, s_t) and np.array_equal(diags1.switched, s_switched)):
        raise AssertionError(f"batched cadence 1 is not bit-equal to the streaming Tracker: max |dt| "
                             f"{np.abs(t1 - s_t).max()}, switches {diags1.switched.sum()} vs {s_switched.sum()}")
    print(f"batched cadence 1: {launches} lm_solve_level launches for {LANE_FRAMES} frames of {LANES} lanes; "
          f"poses and switches bit-equal to the streaming Tracker per lane; switches per frame "
          f"{diags1.switched.sum(axis=1).tolist()}")
    runs = {}
    for cadence in LANE_CADENCES:
        q, t, diags, _ = _batched_run(config, intrinsics, state0, depths, grays, cadence)
        if diags.failed.any():
            raise AssertionError(f"cadence {cadence}: failed lanes {np.argwhere(diags.failed).tolist()}")
        bad = [f for f in np.nonzero(diags.switched.any(axis=1))[0] if (f + 1) % cadence]
        if bad or not diags.switched.any():
            raise AssertionError(f"cadence {cadence}: switches on frames {bad} off the check frames (or none)")
        runs[cadence] = (q, t, diags, [])
    for _ in range(LANE_TIMED_RUNS):
        for cadence in LANE_CADENCES:
            q, t, _, seconds = _batched_run(config, intrinsics, state0, depths, grays, cadence)
            if not (np.array_equal(q, runs[cadence][0]) and np.array_equal(t, runs[cadence][1])):
                raise AssertionError(f"cadence {cadence}: two runs are not bit-equal")
            runs[cadence][3].append(seconds)
    fps = {}
    for cadence in LANE_CADENCES:
        q, t, diags, seconds = runs[cadence]
        fps[cadence] = frames / statistics.median(seconds)
        print(f"batched cadence {cadence}: {LANES} lanes x {LANE_FRAMES} frames in clips of {LANE_CHUNK}: "
              f"wall {', '.join(f'{1e3 * x:.1f}' for x in seconds)} ms ({LANE_TIMED_RUNS} runs); "
              f"{fps[cadence]:.1f} fps of the card (median run) against {frames / s_seconds:.1f} streaming; "
              f"switches per frame {diags.switched.sum(axis=1).tolist()}; failed 0; "
              f"max |t - streaming t| {np.abs(t - s_t).max():.3e} m")

    # host reads and launches: whole runs, then frame by frame
    for cadence in LANE_CADENCES:
        prof, _ = _profiled(lambda c=cadence: _batched_run(config, intrinsics, state0, depths, grays, c),
                            LEVELS * LANE_FRAMES)
        reads = _check_frames(cadence) + chunks
        print(f"profile, cadence {cadence}: {prof.device_to_host_copies} device-to-host copies for "
              f"{_check_frames(cadence)} check frames and {chunks} clips; {prof.launches} kernel launches; "
              f"device busy {100 * prof.busy_share:.2f}% of {prof.wall_ms:.1f} ms (profiler on)")
        if prof.device_to_host_copies != reads:
            raise AssertionError(f"cadence {cadence}: {prof.device_to_host_copies} host reads, expected {reads}")
    cadence = LANE_CADENCES[-1]
    state, pending, prev = state0, None, None
    for f in range(LANE_FRAMES):
        check = (f + 1) % cadence == 0

        def frame():
            return batch.batched_track_sequence(
                config, intrinsics, state, depths[f + 1:f + 2], grays[f + 1:f + 2], switch_cadence=cadence,
                pending0=pending, frame_offset=f, return_pending=True, prev_pose0=prev, return_prev=True,
            )

        def steady_frame():
            torch.cuda.set_sync_debug_mode("error")  # raises if the frame waits for the device
            try:
                return frame()
            finally:
                torch.cuda.set_sync_debug_mode("default")

        prof, (state, _, pending, prev) = _profiled(frame if check else steady_frame, LEVELS)
        expected = 1 if check else 0  # the check frame's read of the switch mask
        kind = "check" if check else "steady"
        print(f"cadence {cadence} frame {f + 1} ({kind}): {prof.launches} kernel launches, "
              f"{prof.device_to_host_copies} device-to-host copies, device busy {100 * prof.busy_share:.2f}% of "
              f"{prof.wall_ms:.2f} ms (profiler on)")
        if prof.device_to_host_copies != expected:
            raise AssertionError(f"{kind} frame {f + 1}: {prof.device_to_host_copies} host reads, expected {expected}")

    # precompute: k lanes batched against k single-lane precomputes
    pyr0 = pyramid.mean_pyramid(LEVELS, grays[0])
    for k in PRECOMPUTE_LANES:
        batched_ms = _time_ms(lambda: tracker_mod.precompute_keyframe(
            config, intrinsics, depths[0, :k], [p[:k] for p in pyr0]), reps=5, warmup=1)
        singles_ms = _time_ms(lambda: [tracker_mod.precompute_keyframe(
            config, intrinsics, depths[0, b], [p[b] for p in pyr0]) for b in range(k)], reps=3, warmup=1)
        print(f"keyframe precompute of {k} lanes: batched {batched_ms:.2f} ms, {k} single-lane "
              f"{singles_ms:.2f} ms (CUDA events around the call, median)")

    # one lane-axis solve per level at B = 32, from identity, frame 1
    pyr1 = pyramid.mean_pyramid(LEVELS, grays[1])
    one = pose_mod.identity(dev)
    identity = pose_mod.Pose(one.q.expand(LANES, 4).contiguous(), one.t.expand(LANES, 3).contiguous())
    state_in = tracker_mod._start_state(identity)
    row = None
    for lvl in reversed(range(LEVELS)):
        obs, image = state0.kf.levels[lvl], pyr1[lvl]
        record = torch.empty((LANES, lm_solve.RECORD_SIZE), device=dev)

        def launch():
            lm_solve.lm_solve_level(
                image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
                obs.intrinsics.vector(), state_in, record, lm_coef_init=0.1, max_iterations=20, energy_tol=1.0)

        k_ms = _time_ms(launch, reps=20, warmup=3)
        d_us = _device_us(launch, "lm_solve_level_kernel", reps=20)
        evals = [int(e) for e in record[:, lm_solve.NB_EVALS].tolist()]
        insides = [_inside_count(_lane_obs(obs, b), image[b], one) for b in range(LANES)]
        n = obs.xs.shape[-1]
        b_ms, b_by = _bound(n, image.shape[-2:], insides, evals, lm_solve.RECORD_SIZE)
        print(f"lane-axis solve level {lvl}, {LANES} lanes N={n} from identity: {sum(evals)} evaluations "
              f"(lanes {min(evals)}-{max(evals)}); on the device {d_us:.2f} us (profiler, mean of 20), per call "
              f"{k_ms:.4f} ms (CUDA events, median of 20); bound {b_ms:.6f} ms by {b_by} "
              f"({100 * b_ms / (d_us / 1e3):.4f}% of the device time)")
        if lvl == 0:
            p_ms = _time_ms(lambda: [tracker_mod.solve_level_reference(_lane_obs(obs, b), image[b], one)
                                     for b in range(LANES)], reps=1, warmup=0)
            print(f"  the plain version, the Python LM loop lane by lane: {p_ms:.1f} ms")
            row = dict(launches=launches, max_abs_err=plain_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"batched fps of the card: cadence 1 {fps[1]:.1f}, cadence 4 {fps[4]:.1f}; streaming "
          f"{frames / s_seconds:.1f} ({card})")
    return row


# ---------------------------------------------------------------------------
# Phase 7: the tracker options
# ---------------------------------------------------------------------------


def _option_solvers(name, obs, image, dev):
    """(solve on the card, solve by the Python loop) of one level from the
    start of a frame, with option ``name``."""
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod

    opts = OPTIONS[name]
    delta = opts.get("robust_delta", 0.0)
    identity = pose_mod.identity(dev)
    if not opts.get("brightness_model", False):
        return (lambda: tracker_mod.solve_level(obs, image, identity, robust_delta=delta),
                lambda: tracker_mod.solve_level_reference(obs, image, identity, robust_delta=delta))
    start = tracker_mod.BrightnessState(identity, torch.tensor([1.0, 0.0], device=dev))
    return (lambda: tracker_mod.solve_level_brightness(obs, image, start, robust_delta=delta),
            lambda: tracker_mod.solve_level_brightness_reference(obs, image, start, robust_delta=delta))


def phase_option_kernels(kf, bucketed, pyr1, pyr1_drift, model, dev):
    """Phase 7a: each option's instantiation of ``residual_reduce`` and
    ``lm_solve_level`` against its plain version at the six level shapes,
    caps and buckets (brightness on an exposure-drifted frame); two runs of a
    solve bit-equal.  Returns {option: (evaluation error, solve error,
    evaluation row, solver row)}, the rows at level 0 as bucketed."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual

    identity = pose_mod.identity(dev)
    results = {}
    for name, opts in OPTIONS.items():
        delta = opts.get("robust_delta", 0.0)
        bright = opts.get("brightness_model", False)
        kw = dict(robust_delta=delta, ab=torch.tensor(EVAL_AB, device=dev) if bright else None)
        pyr = pyr1_drift if bright else pyr1
        eval_err = solve_err = 0.0
        eval_row = solve_row = None
        for lvl in reversed(range(LEVELS)):
            image = pyr[lvl]
            for label, obs in (("cap", kf.levels[lvl]), ("bucket", bucketed.levels[lvl])):
                n = obs.xs.shape[0]
                params = torch.cat([model.q, model.t, obs.intrinsics.vector()])
                args = (image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, params)
                got = residual.residual_reduce(*args, **kw)
                ref = residual.residual_reduce_reference(*args, **kw)
                torch.cuda.synchronize()
                tag = f"{name} level {lvl} {label} N={n}"
                eval_err = max(eval_err, _check_close(tag, got, ref, int(obs.valid.sum())))
                solve, reference = _option_solvers(name, obs, image, dev)
                out, again, want = solve(), solve(), reference()
                torch.cuda.synchronize()
                solve_err = max(solve_err, _compare_solves(tag, out, want, OPTION_ITER_SLACK))
                if not (torch.equal(_solved_pose(out.state.model).t, _solved_pose(again.state.model).t)
                        and torch.equal(_solved_pose(out.state.model).q, _solved_pose(again.state.model).q)
                        and torch.equal(out.state.energy, again.state.energy)):
                    raise AssertionError(f"{tag}: two runs of the same solve are not bit-equal")
                if bright:
                    ab, ab_ref = out.state.model.ab.cpu().numpy(), want.state.model.ab.cpu().numpy()
                    if not np.allclose(ab, ab_ref, rtol=AB_RTOL, atol=AB_ATOL):
                        raise AssertionError(f"{tag}: (a, b) {ab} vs {ab_ref}")
                if label != "bucket":
                    continue
                record = torch.empty(lm_solve.RECORD_SIZE, device=dev)
                state_in = tracker_mod._start_state(identity)

                def launch():
                    lm_solve.lm_solve_level(
                        image, obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians,
                        obs.intrinsics.vector(), state_in, record, lm_coef_init=0.1, max_iterations=20,
                        energy_tol=1.0, robust_delta=delta, brightness=bright)

                k_ms = _time_ms(launch, reps=50, warmup=5)
                d_us = _device_us(launch, "lm_solve_level_kernel", reps=20)
                evals = int(record[lm_solve.NB_EVALS])
                b_ms, b_by = _bound(n, image.shape, _inside_count(obs, image, identity), evals,
                                    lm_solve.RECORD_SIZE, FLOPS_INSIDE_OF[name])
                print(f"{name} solve level {lvl} N={n} from identity, {evals} evaluations: kernel {k_ms:.4f} ms "
                      f"per call (median of 50), {d_us:.2f} us on the device (profiler, mean of 20); bound "
                      f"{b_ms:.6f} ms by {b_by}")
                if lvl == 0:
                    p_ms = _time_ms(reference, reps=3, warmup=1)
                    solve_row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
                    buf = torch.empty(residual.OUT_SIZE_BRIGHTNESS if bright else residual.OUT_SIZE, device=dev)
                    e_ms = _time_ms(lambda: residual.residual_reduce(*args, out=buf, **kw))
                    e_plain = _time_ms(lambda: residual.residual_reduce_reference(*args, **kw), reps=20)
                    e_bound, e_by = _bound(n, image.shape, float(got[2]), 1, buf.numel(), FLOPS_INSIDE_OF[name])
                    eval_row = dict(ms=e_ms, plain_ms=e_plain, bound_ms=e_bound, bound_by=e_by)
                    print(f"{name} at level 0 N={n}: solve, Python loop {p_ms:.3f} ms (median of 3); one "
                          f"evaluation, kernel {e_ms:.4f} ms, twin {e_plain:.4f} ms, bound {e_bound:.6f} ms by {e_by}")
        for kernel_name, resources in (("lm_solve_level", lm_solve.resources), ("residual_reduce", residual.resources)):
            regs, local = resources(brightness=bright, robust=delta > 0.0)
            print(f"{kernel_name} ({name}): {regs} registers, {local} bytes of local memory a thread "
                  f"(cudaFuncGetAttributes)")
        print(f"{name}: evaluations against the twin at 12 shapes, max scaled error {eval_err:.3e}; solves "
              f"against the Python loop, max pose error {solve_err:.3e}; two runs bit-equal")
        results[name] = (eval_err, solve_err, eval_row, solve_row)
    print(f"tolerance: the evaluation's and the solver's of phases 1 and 2, nb_iter within {OPTION_ITER_SLACK}; "
          f"(a, b) rtol {AB_RTOL} atol {AB_ATOL}")
    return results


def phase_detector_and_lanes(config, seq, bucketed, pyr1, dev):
    """Phase 7a, continued: the lost-frame detector against ``_eval_energy``
    and its cost; the image-index and active-flag lanes against one-lane
    launches.  Returns the detector's relative energy error."""
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, pyramid

    identity = pose_mod.identity(dev)
    out = tracker_mod.track_frame(config, bucketed, pyr1, identity, detector=True)
    energy, _, inside = tracker_mod._eval_energy(bucketed.levels[0], pyr1[0], out.model)
    det = out.detector.tolist()
    err = abs(det[0] - float(energy)) / abs(float(energy))
    if not (err <= E_RTOL and det[1] == float(inside.sum()) and det[2] == float(bucketed.levels[0].valid.sum())):
        raise AssertionError(f"detector {det} vs energy {float(energy)}, inside {float(inside.sum())}")
    obs = bucketed.levels[0]
    record = torch.empty(lm_solve.RECORD_SIZE, device=dev)
    state_in = tracker_mod._start_state(identity)
    timings = {}
    for detector in (False, True, False, True):
        timings.setdefault(detector, []).append(_device_us(lambda: lm_solve.lm_solve_level(
            pyr1[0], obs.xs, obs.ys, obs.idepth, obs.tmpl_vals, obs.valid, obs.jacobians, obs.intrinsics.vector(),
            state_in, record, lm_coef_init=0.1, max_iterations=20, energy_tol=1.0, detector=detector),
            "lm_solve_level_kernel", reps=20))
    print(f"detector: energy {det[0]:.6g} vs _eval_energy {float(energy):.6g} (rel err {err:.2e}), inside "
          f"{det[1]:.0f}, valid {det[2]:.0f}; the finest solve (N={obs.xs.shape[0]}) on the device "
          f"{min(timings[False]):.2f} us without the detector, {min(timings[True]):.2f} us with it (profiler, "
          f"best of two means of 20)")
    # three keyframes tracking one frame through the image index, the middle lane inactive
    frames = (0, 8, 16)
    kfs = [tracker_mod.precompute_keyframe(
        config, seq.intrinsics.to(dev), torch.from_numpy(seq.depths[f].astype("int32")).to(dev),
        pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[f]).to(dev))) for f in frames]
    stacked = tracker_mod.map_keyframe(lambda *xs: torch.stack(xs), *kfs)
    pyr = pyramid.mean_pyramid(LEVELS, torch.from_numpy(seq.grays[17]).to(dev))
    index = torch.zeros(3, dtype=torch.int32, device=dev)
    active = torch.tensor([True, False, True], device=dev)
    lanes = tracker_mod.track_frame(config, stacked, [p[None] for p in pyr], tracker_mod.identity_lanes(3, dev),
                                    detector=True, image_index=index, active=active)
    for b in (0, 2):
        one = tracker_mod.track_frame(config, kfs[b], pyr, identity, detector=True)
        if not (torch.equal(lanes.model.t[b], one.model.t) and torch.equal(lanes.model.q[b], one.model.q)
                and torch.equal(lanes.nb_iters[b], one.nb_iters) and torch.equal(lanes.detector[b], one.detector)):
            raise AssertionError(f"image-index lane {b} differs from its one-lane frame")
    if not (torch.equal(lanes.model.t[1], identity.t) and lanes.nb_iters[1].tolist() == [0] * LEVELS
            and bool(lanes.detector[1, 0].isnan()) and not bool(lanes.failed[1])):
        raise AssertionError("the inactive lane is not a pass-through")
    print(f"image index and active flag: 3 keyframes (frames {frames}) on frame 17 in one launch a level, "
          f"lanes 0 and 2 bit-equal to one-lane frames, lane 1 inactive and passed through ok")
    return err


def _option_run(seq, grays, options, dev, may_fail=()):
    """A 40-frame streaming run with ``options`` on ``grays``: the last
    ``OPTION_PROFILED_FRAMES`` frames under the profiler.  Returns a dict of
    what the checks and the report need."""
    import torch

    from visual_odometry_rs_tpu_torch.eval import ate
    from visual_odometry_rs_tpu_torch.models import relocalize, tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual
    from visual_odometry_rs_tpu_torch.utils import profiling

    attempts = []
    attempt = relocalize.attempt

    def counted(*args, **kwargs):
        attempts.append(1)
        return attempt(*args, **kwargs)

    relocalize.attempt = counted
    residual.residual_reduce.launches = 0
    lm_solve.lm_solve_level.launches = 0
    lm_solve.lm_solve_level.variant_launches = {}
    try:
        split = FRAMES - OPTION_PROFILED_FRAMES
        trk, poses, seconds, _ = _track(seq, split, dev, grays=grays, may_fail=may_fail, **options)
        box = []
        prof = profiling.profile_device(lambda: box.append(
            _track(seq, FRAMES, dev, tracker=trk, first=split, grays=grays, may_fail=may_fail, **options)))
        poses += box[0][1][1:]
    finally:
        relocalize.attempt = attempt
    torch.cuda.synchronize()
    return dict(
        tracker=trk, ate=ate.ate_rmse(poses, seq.poses[:FRAMES]), poses=poses, seconds=seconds,
        solves=lm_solve.lm_solve_level.launches, variants=dict(lm_solve.lm_solve_level.variant_launches),
        evaluations=residual.residual_reduce.launches, attempts=len(attempts), profile=prof,
    )


def _frame_report(label, run):
    prof = run["profile"]
    ms = [1e3 * x for x in run["seconds"][1:]]
    return (f"{label}: per-frame ms median {statistics.median(ms):.3f}, mean {statistics.mean(ms):.3f} (frames "
            f"2..{len(ms) + 1}); profiled frames {FRAMES - OPTION_PROFILED_FRAMES}..{FRAMES - 1}: "
            f"{prof.launches / OPTION_PROFILED_FRAMES:.1f} kernel launches and "
            f"{prof.device_to_host_copies / OPTION_PROFILED_FRAMES:.1f} host reads a frame, device busy "
            f"{100 * prof.busy_share:.2f}%; solver launches {run['solves']} for {FRAMES - 1} frames")


def phase_option_streaming(seq, dev):
    """Phase 7b: three 40-frame runs of the streaming tracker with options,
    each beside the default configuration on the same frames.  Returns the
    solver launches of each instantiation on these main paths."""
    import numpy as np

    from visual_odometry_rs_tpu_torch.dataset import synthetic

    start = time.perf_counter()
    kidnap = synthetic.generate_sequence(nb_frames=FRAMES, height=HEIGHT, width=WIDTH, seed=KIDNAP_SEED,
                                         twist_per_frame=kidnap_twists(FRAMES))
    drift = drift_grays(seq.grays[:FRAMES])
    print(f"rendered the kidnap sequence ({FRAMES} frames) in {time.perf_counter() - start:.1f} s")
    runs = (
        ("huber+brightness", seq, drift, OPTIONS["huber+brightness"], ()),
        ("dso_fixed", seq, seq.grays[:FRAMES], dict(candidate_selector="dso_fixed", dso_threshold_coef_a=DSO_A), ()),
        ("relocalize", kidnap, kidnap.grays, dict(relocalize_window=RELOC_WINDOW), (KIDNAP_JUMP,)),
    )
    launches = {}
    for name, s, grays, options, may_fail in runs:
        base = _option_run(s, grays, {}, dev, may_fail=range(FRAMES) if name == "relocalize" else ())
        run = _option_run(s, grays, options, dev, may_fail=may_fail)
        trk = run["tracker"]
        if run["solves"] != LEVELS * (FRAMES - 1 + run["attempts"]) or run["evaluations"] != 0:
            raise AssertionError(f"{name}: {run['solves']} lm_solve_level launches for {FRAMES - 1} frames and "
                                 f"{run['attempts']} relocalization attempts, {run['evaluations']} residual_reduce")
        for variant, count in run["variants"].items():
            launches[variant] = launches.get(variant, 0) + count
        bound = 1.5 * JAX_ATE_OPTIONS[name]
        print(f"{name}: {FRAMES - 1} frames at {WIDTH}x{HEIGHT}, cap {CAP}, bucketing on: solver launches "
              f"{run['variants']}, {run['attempts']} relocalization attempts (one launch a level each), 0 "
              f"residual_reduce; keyframe switches {trk.keyframe_switches}; ATE {run['ate']:.6e} m, bound "
              f"{bound:.6e} m = 1.5 x JAX package ATE {JAX_ATE_OPTIONS[name]:.6e} m; the default configuration "
              f"on the same frames: ATE {base['ate']:.6e} m")
        print("  " + _frame_report(f"{name}", run))
        print("  " + _frame_report("default", base))
        if not run["ate"] <= bound:
            raise AssertionError(f"{name}: ATE {run['ate']} above {bound}")
        if name == "relocalize":
            errors = [float(np.linalg.norm(run["poses"][f].t.numpy() - s.poses[f].t.numpy()))
                      for f in range(KIDNAP_JUMP, KIDNAP_JUMP + 3)]
            print(f"  relocalizations {trk.relocalizations}; error after the jump (frames {KIDNAP_JUMP}-"
                  f"{KIDNAP_JUMP + 2}): {', '.join(f'{e:.4f}' for e in errors)} m; without relocalization "
                  f"{float(np.linalg.norm(base['poses'][KIDNAP_JUMP + 2].t.numpy() - s.poses[KIDNAP_JUMP + 2].t.numpy())):.4f} m")
            if trk.relocalizations < 1 or max(errors) > 0.02:
                raise AssertionError(f"relocalize: {trk.relocalizations} relocalizations, post-jump errors {errors}")
    # Huber alone and brightness alone on the drifting frames, for their times and launches
    for name in ("huber", "brightness"):
        run = _option_run(seq, drift, OPTIONS[name], dev)
        if run["solves"] != LEVELS * (FRAMES - 1):
            raise AssertionError(f"{name}: {run['solves']} solver launches for {FRAMES - 1} frames")
        for variant, count in run["variants"].items():
            launches[variant] = launches.get(variant, 0) + count
        print("  " + _frame_report(f"{name} alone on the drifting frames, ATE {run['ate']:.6e} m", run))
    return launches


def phase_option_evaluations(seq, dev):
    """The per-evaluation path with each option (the Python LM loop on the
    card, every evaluation one ``residual_reduce`` launch of the option's
    instantiation); returns the launches by instantiation."""
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual

    class ReferenceTracker(tracker_mod.Tracker):
        _track_frame = staticmethod(tracker_mod.track_frame_reference)

    drift = drift_grays(seq.grays[:REFERENCE_FRAMES])
    residual.residual_reduce.variant_launches = {}
    for name, options in OPTIONS.items():
        before, solves = residual.residual_reduce.launches, lm_solve.lm_solve_level.launches
        _, _, _, evaluations = _track(seq, 4, dev, ReferenceTracker, grays=drift, **options)
        launched = residual.residual_reduce.launches - before
        if launched != evaluations or lm_solve.lm_solve_level.launches != solves:
            raise AssertionError(f"{name} per-evaluation path: {launched} launches for {evaluations} evaluations")
    print(f"per-evaluation path, 3 frames a option: residual_reduce launches {residual.residual_reduce.variant_launches}")
    return dict(residual.residual_reduce.variant_launches)


def phase_option_batched(card, intrinsics, depths_np, grays_np, dev):
    """Phase 7c: the batched driver with Huber, dso_fixed and a ring of
    ``RELOC_WINDOW``, one lane kidnapped.  Returns the solver launches of
    the Huber instantiation."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.dataset import synthetic
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual
    from visual_odometry_rs_tpu_torch.parallel import batch

    lane = BATCH_KIDNAP_LANE
    kid = synthetic.generate_sequence(nb_frames=LANE_FRAMES + 1, height=HEIGHT, width=WIDTH, seed=KIDNAP_SEED,
                                      twist_per_frame=batch_kidnap_twists())
    depths_np, grays_np = depths_np.copy(), grays_np.copy()
    depths_np[:, lane], grays_np[:, lane] = kid.depths, kid.grays
    intrinsics = intrinsics.to(dev)
    depths = torch.from_numpy(depths_np.astype(np.int32)).to(dev)
    grays = torch.from_numpy(grays_np).to(dev)
    options = dict(robust_delta=10.0, candidate_selector="dso_fixed", dso_threshold_coef_a=DSO_A)
    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP,
                                       relocalize_window=RELOC_WINDOW, **options)
    no_ring = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP,
                                        **options)
    default = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP)
    cadence = LANE_CADENCES[-1]
    state0 = batch.batched_init_state(config, intrinsics, depths[0], grays[0], device=dev)
    ring0 = batch.batched_init_ring(config, state0)
    plain0 = batch.batched_init_state(default, intrinsics, depths[0], grays[0], device=dev)

    residual.residual_reduce.launches = 0
    lm_solve.lm_solve_level.launches = 0
    lm_solve.lm_solve_level.variant_launches = {}
    q, t, diags, _ = _batched_run(config, intrinsics, state0, depths, grays, cadence, ring=ring0)
    solves, huber = lm_solve.lm_solve_level.launches, lm_solve.lm_solve_level.variant_launches.get("huber", 0)
    if solves != 2 * LEVELS * LANE_FRAMES or huber != solves or residual.residual_reduce.launches != 0:
        raise AssertionError(f"batched options: {lm_solve.lm_solve_level.variant_launches} solver launches for "
                             f"{LANE_FRAMES} frames, {residual.residual_reduce.launches} residual_reduce")
    others = np.arange(LANES) != lane
    if not diags.relocalized[:, lane].any() or diags.relocalized[:, others].any() or diags.failed[:, others].any():
        raise AssertionError(f"batched options: relocalized {np.argwhere(diags.relocalized).tolist()}, failed "
                             f"{np.argwhere(diags.failed).tolist()}")
    bad = [f for f in np.nonzero(diags.switched.any(axis=1))[0] if (f + 1) % cadence]
    if bad:
        raise AssertionError(f"batched options: switches on frames {bad} off the check frames")
    errors = np.linalg.norm(t[:, lane] - np.stack([p.t.numpy() for p in kid.poses[1:]]), axis=-1)
    print(f"batched, {LANES} lanes, cap {LANE_CAP}, cadence {cadence}, Huber + dso_fixed (a = {DSO_A}) + ring of "
          f"{RELOC_WINDOW}: {solves} lm_solve_level launches for {LANE_FRAMES} frames (the frame's six and the "
          f"recovery's six); lane {lane} kidnapped on frames 2-{BATCH_KIDNAP_STEPS + 1}, relocalized on frames "
          f"{(np.nonzero(diags.relocalized[:, lane])[0] + 1).tolist()}, error {', '.join(f'{e:.3f}' for e in errors)} m; "
          f"no other lane relocalized or failed; switches per frame {diags.switched.sum(axis=1).tolist()}")
    # wall times in turns: the ring, no ring, the default configuration
    seconds = {"ring": [], "no ring": [], "default": []}
    for _ in range(2):
        seconds["ring"].append(_batched_run(config, intrinsics, state0, depths, grays, cadence, ring=ring0)[3])
        seconds["no ring"].append(_batched_run(no_ring, intrinsics, state0, depths, grays, cadence)[3])
        seconds["default"].append(_batched_run(default, intrinsics, plain0, depths, grays, cadence)[3])
    frames = LANES * LANE_FRAMES
    print("batched wall, " + "; ".join(f"{k} {', '.join(f'{1e3 * x:.1f}' for x in v)} ms = "
                                       f"{frames / min(v):.1f} fps of the card (best)" for k, v in seconds.items()))
    # one steady frame (no check) of each, under the profiler and CUDA's sync debug mode
    for label, cfg, state, ring, expected in (("ring", config, state0, ring0, 2 * LEVELS),
                                              ("no ring", no_ring, state0, None, LEVELS),
                                              ("default", default, plain0, None, LEVELS)):
        def steady():
            torch.cuda.set_sync_debug_mode("error")  # raises if the frame waits for the device
            try:
                return batch.batched_track_sequence(cfg, intrinsics, state, depths[1:2], grays[1:2],
                                                    switch_cadence=cadence, reloc_ring=ring)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        prof, _ = _profiled(steady, expected)
        if prof.device_to_host_copies != 0:
            raise AssertionError(f"steady frame ({label}): {prof.device_to_host_copies} host reads")
        print(f"steady batched frame ({label}): {prof.launches} kernel launches, 0 host reads, device busy "
              f"{prof.device_busy_ms * 1e3:.1f} us of {prof.wall_ms:.2f} ms (profiler on)")
    return huber


# ---------------------------------------------------------------------------
# Phase 8: the front end from files
# ---------------------------------------------------------------------------


def _cli(main, argv):
    """Runs a CLI's ``main(argv)``; returns (stdout, stderr, seconds) and
    fails unless it exits with 0."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    seconds = time.perf_counter() - start
    if rc != 0:
        raise AssertionError(f"{main.__module__} {' '.join(argv)} exited {rc}:\n{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), seconds


def _poses_of(text):
    """The (F, 7) [q, t] float32 poses of a TUM trajectory text."""
    import torch

    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd

    return torch.stack([torch.cat([f.pose.q, f.pose.t]) for f in tum_rgbd.parse_trajectory(text)])


def _write_subset(path, assoc_lines, first, last):
    with open(path, "w") as f:
        f.write("\n".join(assoc_lines[first:last + 1]) + "\n")
    return path


def _decode_report(assocs, seq_depths, seq_grays):
    """(b): the native readers bit-equal to the arrays; ms per depth+gray
    pair on one thread and through the prefetching loader."""
    import numpy as np

    from visual_odometry_rs_tpu_torch import native
    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd

    start = time.perf_counter()
    for a, depth, gray in zip(assocs, seq_depths, seq_grays):
        if not (np.array_equal(native.read_png_16bits(a.depth_file_path), depth)
                and np.array_equal(native.read_gray(a.color_file_path), gray)):
            raise AssertionError(f"PNG round trip differs at {a.depth_file_path}")
    single_ms = 1e3 * (time.perf_counter() - start) / len(assocs)
    start = time.perf_counter()
    frames = list(tum_rgbd.frame_loader(assocs, num_threads=PREFETCH_THREADS))
    prefetch_ms = 1e3 * (time.perf_counter() - start) / len(assocs)
    if not all(np.array_equal(d, depth) and np.array_equal(g, gray)
               for (d, g), depth, gray in zip(frames, seq_depths, seq_grays)):
        raise AssertionError("the prefetching loader's frames differ from the arrays")
    return single_ms, prefetch_ms


def phase_front_end(seq, trk4, poses4, seconds4, ate4, lane_depths, lane_grays, dev):
    """Phase 8; returns the ``lm_solve_level`` launches of the streaming
    CLIs and of the batch CLI."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch import native
    from visual_odometry_rs_tpu_torch.cli import vors_batch, vors_eval, vors_track
    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual
    from visual_odometry_rs_tpu_torch.parallel import batch
    from visual_odometry_rs_tpu_torch.utils import checkpoint

    # (a) the native loader: the card's machine has no libpng headers, and a
    # failed build would leave the readers on PIL
    if not native.available():
        raise AssertionError("the native PNG library did not build or load")
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        # (b) phase 4's sequence as PNGs, written by the port
        start = time.perf_counter()
        assoc = tum_rgbd.write_sequence(os.path.join(root, "seq"), seq.grays[:FRAMES], seq.depths[:FRAMES],
                                        seq.timestamps[:FRAMES])
        write_s = time.perf_counter() - start
        assocs = tum_rgbd.load_associations(assoc)
        pair_bytes = np.mean([os.path.getsize(a.depth_file_path) + os.path.getsize(a.color_file_path)
                              for a in assocs])
        single_ms, prefetch_ms = _decode_report(assocs, seq.depths[:FRAMES], seq.grays[:FRAMES])
        print(f"PNG files: {FRAMES} depth+gray pairs written in {write_s:.2f} s, {pair_bytes / 1e3:.1f} kB a "
              f"pair, read back bit-equal; decode {single_ms:.3f} ms a pair on one thread, {prefetch_ms:.3f} ms a "
              f"pair through the prefetching loader ({PREFETCH_THREADS} threads)")
        lines = open(assoc).read().splitlines()[1:]  # without the comment
        ground_truth = os.path.join(root, "groundtruth.txt")
        with open(ground_truth, "w") as f:
            f.write("\n".join(tum_rgbd.Frame(timestamp=a.depth_timestamp, pose=p).to_string()
                              for a, p in zip(assocs, seq.poses[:FRAMES])) + "\n")

        device_flags = [] if dev.type == "cuda" else ["--cpu"]
        flags = [*device_flags, "--nb-levels", str(LEVELS), "--candidate-cap", str(CAP)]
        ref = torch.stack([torch.cat([p.q, p.t]) for p in poses4[1:]])
        stream_launches = 0

        def track(argv, expect_frames):
            nonlocal stream_launches
            lm_solve.lm_solve_level.launches = 0
            residual.residual_reduce.launches = 0
            out, err, seconds = _cli(vors_track.main, ["fr1", *argv])
            launches = lm_solve.lm_solve_level.launches
            stream_launches += launches
            if dev.type == "cuda" and (launches != LEVELS * expect_frames or residual.residual_reduce.launches):
                raise AssertionError(f"vors_track {argv[1:]}: {launches} solver launches for {expect_frames} "
                                     f"frames, {residual.residual_reduce.launches} residual_reduce")
            return out, err, seconds

        # (c) vors_track on the files: phase 4's configuration and frames;
        # the time the tracking loop waits for each decoded frame is measured
        # around the loader's iterator
        waits, real_loader = [], tum_rgbd.frame_loader

        def timed_loader(assocs_, **kwargs):
            frames = real_loader(assocs_, **kwargs)
            while True:
                start = time.perf_counter()
                item = next(frames, None)
                if item is None:
                    return
                waits.append(time.perf_counter() - start)
                yield item

        tum_rgbd.frame_loader = timed_loader
        try:
            out_c, err_c, wall_c = track([assoc, *flags, "--metrics"], FRAMES - 1)
        finally:
            tum_rgbd.frame_loader = real_loader
        poses_c = _poses_of(out_c)
        if not torch.equal(poses_c, ref):
            raise AssertionError(f"vors_track from files vs phase 4: max diff {float((poses_c - ref).abs().max())}")
        records = [json.loads(x) for x in err_c.splitlines() if x.startswith("{")]
        track_ms = [1e3 * r["track_seconds"] for r in records[:-1]]
        steady, steady4 = track_ms[1:], [1e3 * x for x in seconds4[1:]]
        print(f"vors_track fr1 from files: {FRAMES - 1} poses bit-equal to phase 4's Tracker, "
              f"{LEVELS * (FRAMES - 1)} solver launches; wall {1e3 * wall_c:.1f} ms = "
              f"{1e3 * wall_c / (FRAMES - 1):.3f} ms a frame, of which Tracker.track {sum(track_ms):.1f} ms "
              f"(--metrics; median {statistics.median(steady):.3f} ms, mean {statistics.mean(steady):.3f} ms over "
              f"frames 2..{FRAMES - 1}, against phase 4's median {statistics.median(steady4):.3f} ms and mean "
              f"{statistics.mean(steady4):.3f} ms), waiting for decoded frames {1e3 * sum(waits):.1f} ms (the first "
              f"{1e3 * waits[0]:.2f} ms, the rest median {1e3 * statistics.median(waits[1:]):.3f} ms, max "
              f"{1e3 * max(waits[1:]):.3f} ms), the rest {1e3 * (wall_c - sum(waits)) - sum(track_ms):.1f} ms "
              f"(start-up, output); session {records[-1]}")

        # (d) resume in the streaming CLI, without and with the velocity carry
        first = _write_subset(os.path.join(root, "seq", "first.txt"), lines, 0, RESUME_AT)
        rest = _write_subset(os.path.join(root, "seq", "rest.txt"), lines, RESUME_AT, FRAMES - 1)
        ckpt = os.path.join(root, "tracker.npz")
        for warm in ("constant_position", "constant_velocity"):
            warm_flags = [*flags, "--warm-start", warm]
            straight = out_c if warm == "constant_position" else track([assoc, *warm_flags], FRAMES - 1)[0]
            out1 = track([first, *warm_flags, "--save-state", ckpt], RESUME_AT)[0]
            out2, err2, _ = track([rest, *warm_flags, "--resume", ckpt], FRAMES - 1 - RESUME_AT)
            if "warning" in err2 or out1 + out2 != straight:
                raise AssertionError(f"vors_track --save-state/--resume ({warm}) differs from the straight run")
            print(f"vors_track --save-state after frame {RESUME_AT}, --resume to frame {FRAMES - 1} ({warm}): "
                  f"{FRAMES - 1} poses bit-equal to the uninterrupted run")
        save_ms, load_ms = [], []
        for _ in range(CKPT_REPS):
            start = time.perf_counter()
            checkpoint.save_tracker(ckpt, trk4)
            save_ms.append(1e3 * (time.perf_counter() - start))
            start = time.perf_counter()
            checkpoint.load_tracker(ckpt, trk4)
            _sync(dev)
            load_ms.append(1e3 * (time.perf_counter() - start))
        print(f"tracker checkpoint ({WIDTH}x{HEIGHT}, bucketed keyframe): {os.path.getsize(ckpt)} bytes; save "
              f"{statistics.median(save_ms):.3f} ms, load {statistics.median(load_ms):.3f} ms (median of {CKPT_REPS})")

        # (e) the clip mode: bit-equal to the streaming CLI without bucketing,
        # within phase 4's tolerances of the bucketed run
        unbucketed = track([assoc, *flags, "--no-bucket"], FRAMES - 1)[0]
        out_e, _, wall_e = track([assoc, *flags, "--chunk", str(LANE_CHUNK)], FRAMES - 1)
        if out_e != unbucketed:
            raise AssertionError("vors_track --chunk differs from the streaming CLI with --no-bucket")
        diff = float((_poses_of(out_e) - poses_c).abs().max())
        if not diff <= POSE_ATOL:
            raise AssertionError(f"vors_track --chunk vs the bucketed run: {diff} > {POSE_ATOL}")
        print(f"vors_track --chunk {LANE_CHUNK}: bit-equal to --no-bucket, max |d| {diff:.3e} from the bucketed "
              f"run (atol {POSE_ATOL}); wall {1e3 * wall_e / (FRAMES - 1):.3f} ms a frame")

        # (f) vors_batch on phase 6's lanes from files, straight and split by a resume
        start = time.perf_counter()
        lane_assocs = [
            tum_rgbd.write_sequence(os.path.join(root, f"lane{b:02d}"), lane_grays[:, b], lane_depths[:, b],
                                    np.arange(LANE_FRAMES + 1) / 30.0)
            for b in range(LANES)
        ]
        print(f"{LANES} lanes x {LANE_FRAMES + 1} frames written as PNGs in {time.perf_counter() - start:.1f} s")
        batch_flags = [*device_flags, "--nb-levels", str(LEVELS), "--candidate-cap", str(LANE_CAP), "--chunk",
                       str(LANE_CHUNK), "--switch-cadence", "4", "--relocalize", str(RELOC_WINDOW)]
        batch_ckpt = os.path.join(root, "batch.npz")
        batch_launches, walls = 0, {}
        for name, extra in (("straight", []), ("split", ["--max-frames", str(LANE_SPLIT), "--save-state", batch_ckpt]),
                            ("resumed", ["--resume", batch_ckpt])):
            lm_solve.lm_solve_level.launches = 0
            out_dir = os.path.join(root, "straight" if name == "straight" else "split")
            _, err, walls[name] = _cli(vors_batch.main, ["fr1", *lane_assocs, "--out-dir", out_dir, *batch_flags,
                                                         *extra])
            batch_launches += lm_solve.lm_solve_level.launches
        for b in range(LANES):
            name = f"lane{b:02d}.txt"
            a, c = (open(os.path.join(root, d, name)).read() for d in ("straight", "split"))
            if a != c or len(a.splitlines()) != LANE_FRAMES:
                raise AssertionError(f"vors_batch lane {b}: the resumed trajectory differs from the straight one")
        if dev.type == "cuda" and batch_launches != 2 * 2 * LEVELS * LANE_FRAMES:
            raise AssertionError(f"vors_batch: {batch_launches} solver launches, expected "
                                 f"{2 * 2 * LEVELS * LANE_FRAMES} (two runs of {LANE_FRAMES} frames, 12 a frame)")
        config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP,
                                           relocalize_window=RELOC_WINDOW)
        intrinsics = tum_rgbd.scaled_intrinsics("fr1", HEIGHT, WIDTH)
        live = batch.batched_init_state(config, intrinsics, lane_depths[0], lane_grays[0], device=dev)
        live_ring = batch.batched_init_ring(config, live)
        save_ms, load_ms = [], []
        for _ in range(CKPT_REPS):
            start = time.perf_counter()
            state, pending, ring, done, lane_ts, _ = checkpoint.load_batch(
                batch_ckpt, live, live_ring, config, intrinsics, 4)
            _sync(dev)
            load_ms.append(1e3 * (time.perf_counter() - start))
            start = time.perf_counter()
            checkpoint.save_batch(batch_ckpt, state, pending, ring, done, config, intrinsics, 4, lane_ts)
            save_ms.append(1e3 * (time.perf_counter() - start))
        print(f"vors_batch, {LANES} lanes from files, --chunk {LANE_CHUNK} --switch-cadence 4 --relocalize "
              f"{RELOC_WINDOW}: every lane's trajectory bit-equal between the straight run and the run split at "
              f"frame {LANE_SPLIT} by --save-state/--resume; {batch_launches} solver launches; wall straight "
              f"{walls['straight']:.2f} s, split {walls['split']:.2f} + {walls['resumed']:.2f} s; batch checkpoint "
              f"(ring of {RELOC_WINDOW}) {os.path.getsize(batch_ckpt)} bytes, save {statistics.median(save_ms):.1f} "
              f"ms, load {statistics.median(load_ms):.1f} ms (median of {CKPT_REPS})")

        # (g) vors_eval on (c)'s trajectory, with frame 0's identity pose
        # first, as phase 4's ATE counts it
        trajectory = os.path.join(root, "trajectory.txt")
        with open(trajectory, "w") as f:
            f.write(tum_rgbd.Frame(timestamp=assocs[0].depth_timestamp, pose=poses4[0]).to_string() + "\n" + out_c)
        out_g, _, _ = _cli(vors_eval.main, [ground_truth, trajectory])
        printed = json.loads(out_g)
        gt, est = (tum_rgbd.parse_trajectory(open(p).read()) for p in (ground_truth, trajectory))
        exact = vors_eval.evaluate(gt, est, vors_eval.associate(gt, est, 0.02))
        if (printed["matched_frames"] != FRAMES or abs(exact["ate_rmse_m"] - ate4) > 1e-9 * ate4
                or printed["ate_rmse_m"] != round(ate4, 6)):
            raise AssertionError(f"vors_eval {printed} (unrounded {exact['ate_rmse_m']}) vs phase 4's ATE {ate4}")
        print(f"vors_eval: {out_g.strip()}; ATE {exact['ate_rmse_m']:.9e} m = phase 4's {ate4:.9e} m")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return stream_launches, batch_launches



def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

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
    from visual_odometry_rs_tpu_torch.ops import build, lm_solve, pyramid, residual
    from visual_odometry_rs_tpu_torch.utils import profiling

    script_start = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's matmul in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}")

    # phase 0: build the kernels and the PNG library
    start = time.perf_counter()
    built = build.build_all(SOURCES + (NATIVE,))
    print(f"build: {len(SOURCES)} CUDA sources and {NATIVE}.cpp in parallel, {time.perf_counter() - start:.2f} s")
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

    # phase 6: the batched tracker
    start = time.perf_counter()
    lane_intrinsics, lane_depths, lane_grays = _diverse_lanes()
    print(f"rendered {LANES} lanes x {LANE_FRAMES + 1} frames at {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - start:.1f} s")
    lane_row = phase_batched(card, lane_intrinsics, lane_depths, lane_grays, dev)

    # phase 7: the tracker options
    seven = time.perf_counter()
    drifted = torch.from_numpy(drift_grays(seq.grays[:2])[1]).to(dev)
    option_results = phase_option_kernels(kf, bucketed, pyr1, pyramid.mean_pyramid(LEVELS, drifted), model, dev)
    detector_err = phase_detector_and_lanes(config, seq, bucketed, pyr1, dev)
    option_evals = phase_option_evaluations(seq, dev)
    option_solves = phase_option_streaming(seq, dev)
    option_solves["huber"] = option_solves.get("huber", 0) + phase_option_batched(
        card, lane_intrinsics, lane_depths, lane_grays, dev)
    print(f"phase 7 (options): {time.perf_counter() - seven:.1f} s")

    # phase 8: the front end from files
    eight = time.perf_counter()
    cli_launches, batch_cli_launches = phase_front_end(seq, trk, poses, seconds, err, lane_depths, lane_grays, dev)
    solve_launches += cli_launches
    lane_row["launches"] += batch_cli_launches
    print(f"phase 8 (the front end from files): {time.perf_counter() - eight:.1f} s")

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
    kernels.append({
        "name": f"lm_solve_level (lane axis, {LANES} lanes)", "route": "cuda",
        "source": "visual_odometry_rs_tpu_torch/csrc/lm_solve.cu", "replaces": replaces, **lane_row,
        "library_ms": None,
    })
    for name, (eval_err, solve_err, eval_row, solve_row) in option_results.items():
        for kernel, source, launches, max_err, r in (
            ("residual_reduce", "residual_reduce.cu", option_evals.get(name, 0), eval_err, eval_row),
            ("lm_solve_level", "lm_solve.cu", option_solves.get(name, 0), max(solve_err, detector_err), solve_row),
        ):
            if launches == 0:
                raise AssertionError(f"{kernel} ({name}) was not launched on its path")
            kernels.append({
                "name": f"{kernel} ({name})", "route": "cuda", "source": f"visual_odometry_rs_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": max_err, **r, "library_ms": None,
            })
    print(f"chip_smoke: {time.perf_counter() - script_start:.1f} s from the build to the kernels line")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
