#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's main paths (``vors_track``'s streaming tracker, the
batched driver, the options, the CLIs from files, ``vors_slam``, the
photometric window of ``vors_refine``, affine alignment, the window BA and
the example programs) on the card
at 640x480 with 6 pyramid levels and 8192 candidates per level, and fails
(non-zero exit, no result line) unless every phase passes:

0. Build the CUDA sources (``csrc/residual_reduce.cu``, ``csrc/lm_solve.cu``,
   the keyframe precompute ``csrc/precompute.cu`` and the empty kernel
   ``csrc/launch_floor.cu``), one ``nvcc`` each, and
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
   sequence; each keyframe (the first and every switch) exactly two
   precompute launches.  Then 10 more steady frames under ``torch.profiler`` count the
   kernel launches and the device→host copies per frame.
5. Track the first frames again on the CPU (the plain versions) and compare
   poses.
6. The batched tracker (``parallel.batch``, the ``vors_batch`` path) at the
   width of ``bench.py``'s ``fps_scan_b32_diverse`` row: 32 diverse lanes at
   640x480, 6 levels, cap 4096, 10 tracked frames in clips of 8, at cadence
   1 and 4.  Every frame must make exactly 6 ``lm_solve_level`` launches for
   the whole batch, and each frame on which a lane switches two precompute
   launches; the host may read the device only on check frames and
   once per clip (profiler counts; a steady frame runs under CUDA's sync
   debug mode); cadence 1 must be bit-equal per lane to the streaming
   ``Tracker`` on the card; at cadence 4 switches only on frames with
   ``(t + 1) % 4 == 0``; no lane may fail.  The lane-axis launch is held
   against ``track_frame_reference`` lane by lane on 2 lanes x 3 frames.
   Prints the card's frames per second at both cadences beside the
   streaming tracker's, the launches, host reads and busy share of a steady
   and a check frame, and the device time of one lane-axis solve per level
   against its bound.  The keyframe precompute's two kernels
   (``precompute_keyframe_counts``) against its plain version
   (``precompute_keyframe_reference``) on the same card inputs at 1, 9 and
   32 lanes, the config's caps: every leaf and the per-level counts
   bit-equal; each kernel's device time against its bytes bound, the call
   against the plain version and against single-lane calls.

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
9. The SLAM back end.  (a) The pose graph in plain torch on the card:
   ``tests/test_ba.py``'s 60-node graph with 4 loops (dense and sparse
   solves) and 320-node graph with 8 loops (sparse), built from its numpy
   seed: two runs bit-equal, each solve within ``PGO_E_RTOL`` and
   ``PGO_NODE_ATOL`` of the port's CPU run, sparse against dense likewise,
   the 320-node energy under 1% of its start; ms (host clock, second run),
   launches and host reads a solve (profiler), beside the CPU's ms.  (b) An
   out-and-back sequence at 640x480 (``slam_sequence``, 25 frames), its
   ground truth drifted: loop verification of the 16 closest pairs as lanes
   of exactly six ``lm_solve_level`` launches, each lane's model within
   phase 2's tolerance of a one-lane solve of its pair, every verified
   ``Z_ij`` within ``tests/test_loop_closure.py``'s ground-truth
   tolerances.  (c) ``vors_slam fr1`` through its ``main`` on the sequence's
   PNGs: the JAX package's keyframe, loop-edge and map-point counts
   (``JAX_SLAM``, ``chip_smoke_reference.py``), the ATE within 1.5x of
   JAX's and at most ``vors_track --no-bucket``'s + 2e-3, six solver
   launches a tracked frame and six for the verification; ``--kf-store
   memory`` and a ``--save-state``/``--resume`` split print the straight
   run's lines; the wall a frame split into tracking, loop closure, pose
   graph and export.
10. The photometric window (plain torch, no kernel of its own) at
   ``vors_refine``'s defaults: 640x480, 6 levels, cap 2048, a window of 6.
   (a) ``solve_window`` on frames 0..5 of phase 4's sequence, the poses of
   its ground truth with a seeded cumulative drift (``refine_drifted``):
   the card within ``WINDOW_CARD_ATOL`` of the CPU in as many LM
   iterations, two card runs bit-equal, ms a solve (CUDA events),
   launches, host reads and the device's busy share (``profile_device``); plain and with brightness and
   Huber.  (b) ``vors_refine`` on phase 4's 41 frames as PNGs with that
   drifted trajectory, sliding and chunked: the refined ATE below the
   drifted input's and within 1.5x the JAX package's on the same files
   (``JAX_REFINE``, ``chip_smoke_reference.py``); a run split by
   ``--save-state``/``--resume`` prints the straight run's lines and writes
   its PLY file, which reads back.  (c) ``vors_refine --batch`` on phase
   6's first 4 lanes: each lane within ``WINDOW_LANE_ATOL`` of its one-lane
   sliding run.  (d) ``vors_slam --refine-window 6`` on phase 9's files:
   JAX's counts and the ATE within 1.5x of JAX's (``JAX_SLAM_REFINE``), six
   solver launches a tracked frame and six for the verification, the
   ``.window`` store with ``--resume`` bit-equal to the straight run.
11. The rest of the single-device surface (plain torch, no kernel of its
   own but the tracking examples' solver).  (a) ``affine2d.align`` at
   640x480 (``tests/test_affine2d.py``'s smooth image, seed 1, its random
   template, seed 2, 6 levels): two card runs bit-equal, the card within
   ``AFFINE_CARD_ATOL`` of the CPU and ``AFFINE_JAX_ATOL`` of the JAX
   package's parameters (``JAX_AFFINE``, ``chip_smoke_reference.py``), the
   warp within ``tests/test_affine2d.py``'s bounds of the ground truth.
   (b) ``parallel/ba.solve`` on ``tests/test_ba.py::make_problem``'s layout
   at K=16 keyframes x P=4096 points (seed 5, perturb 0.01, 0.5 px noise):
   two card runs bit-equal, the card within ``BA_CARD_ATOL`` of the CPU,
   the energy below half its start, the ATE within 1.5x of JAX's
   (``JAX_BA``).  (a) and (b) print ms a call (CUDA events), launches, host
   reads and the device's busy share (``profile_device``).  (c) The 11
   example programs through their ``main`` on the card, each against its
   CPU run, the four tracking examples also against what the JAX
   package's print (``JAX_EXAMPLES``, ``chip_smoke_reference.py``): ``track_synthetic`` one ``lm_solve_level``
   launch a level and frame (35), ``relocalization`` one a level and frame of both runs plus
   one a level per relocalization attempt, ``slam_loop_closure`` one a
   level for all its pairs (3), the others none.

12. The multi-GPU layer (``parallel/mesh.py``, ``collectives.py``,
   ``sharded.py`` and the sharded solves), on the one card.  (a) A world of
   one rank on NCCL in this process, which runs every sharded path with
   n = 1: the point-sharded level solve at 640x480, level 0 as the tracker
   buckets it, bit-equal to the Python LM loop (``solve_level_reference``,
   the same ``residual_reduce`` kernel) and within phase 2's tolerance of
   ``lm_solve_level``; BA at K=16 x P=4096 with ``psum`` and ``ring``, the
   window at 6 x 2048 and the 320-node sparse pose graph, each bit-equal
   to its single-device solve; ms a call of each against it.  (b) Two
   ranks on the card over gloo (spawned processes; gloo's collectives go
   through host copies): each rank launches ``residual_reduce`` on its
   half of the level, the kernel within phase 1's tolerance of
   ``residual_reduce_reference`` on that half, the pose within phase 2's of
   the unsharded loop, the same on both ranks; the rings against the
   fixed-order sum; BA (both assemblies), the window and the pose graph
   within their CPU tests' tolerances of the single-device solves.  (c)
   Lanes over a mesh of the card twice (two threads): 8 of phase 6's lanes
   through ``batched_track_sequence(mesh=)`` and ``make_sharded_step``,
   bit-equal per lane to the run without a mesh, 6 ``lm_solve_level``
   launches a frame on each half; two windows through
   ``solve_window_batched(mesh=)`` within the sharded window's tolerances
   of the batch (the card's sums block by the lanes of a launch).

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
SOURCES = ("residual_reduce", "lm_solve", "launch_floor", "precompute")
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
PRECOMPUTE_LANES = (1, 9, 32)
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
# phase 9: the SLAM back end.  An out-and-back sequence: SLAM_LEG frames out
# along SLAM_TWIST, as many back, at 640x480 (7 keyframes, loops between
# the legs); vors_slam's default loop gates
SLAM_LEG, SLAM_SEED = 12, 47
SLAM_TWIST = [0.035, 0.004, 0.002, 0.002, -0.001, 0.001]
SLAM_MAX_CANDIDATES = 16
# the drift injected into the ground truth for (b), tests/test_loop_closure.py's
SLAM_DRIFT_BIAS, SLAM_DRIFT_NOISE, SLAM_DRIFT_SEED = [0.004, -0.002, 0.001, 0.0008, 0.0005, -0.0004], 0.001, 8
LOOP_T_ATOL, LOOP_Q_ATOL = 8e-3, 4e-3  # verified Z_ij against the ground truth (tests/test_loop_closure.py)
# the pose graph: tests/test_ba.py::_loopy_graph's 60 nodes with 4 loops and
# 320 nodes with 8; dense against sparse, energy rtol 1e-3 (test_ba) and the
# nodes within PGO_NODE_ATOL: the LM stops in a flat tail where the last
# polishing step (1.8e-5 on the 60-node graph) is accepted or rejected on f32
# rounding of the energy, which another order of summation decides
# otherwise (ROADMAP C2; 1.4e-5 measured on the CPU)
PGO_GRAPHS = ((60, 4), (320, 8))
PGO_E_RTOL, PGO_NODE_ATOL = 1e-3, 5e-5
# the JAX package's vors_slam (CPU, gather sampling) on phase 9's files, by
# chip_smoke_reference.py
JAX_SLAM = {"keyframes": 7, "edges": 10, "points": 22276, "ate": 0.0017311276198341981}
# phase 10: the photometric window at vors_refine's defaults (cap 2048, a
# window of 6) on phase 4's 41 frames; the input trajectory is the ground
# truth with a seeded cumulative drift (tests/test_cli.py's form, each twist
# component N(0, REFINE_DRIFT) a frame: about 0.5 px a frame at 640x480)
REFINE_CAP, REFINE_WINDOW = 2048, 6
REFINE_DRIFT, REFINE_DRIFT_SEED = 0.001, 5
REFINE_SPLIT = 20  # the split run saves after frame 20
REFINE_LANES = 4  # (c): phase 6's first lanes
# the card against the CPU (measured 2.4e-7 m plain, 3.1e-7 with brightness
# and Huber), and --batch lanes against one-lane runs (measured 4.7e-7): the
# bounds of tests/test_torch_kernel_cuda.py and of the CPU batch tests, far
# below the drift the solve removes (REFINE_DRIFT a component a frame)
WINDOW_CARD_ATOL, WINDOW_LANE_ATOL = 1e-4, 1e-5
WINDOW_SOLVE_REPS = 5
# the JAX package's vors_refine and vors_slam --refine-window (CPU, gather
# sampling) on phase 10's files, by chip_smoke_reference.py
# (drifted input 2.8421928787715537e-3 m)
JAX_REFINE = {"sliding": 0.001547715942726918, "chunked": 0.0027843104853928348}
JAX_SLAM_REFINE = {"keyframes": 7, "edges": 10, "points": 22276, "ate": 0.00018647929686623144}
# phase 11: the rest of the single-device surface.  (a) tests/test_affine2d.py's
# smooth image at full width, its random template, default_nb_levels = 6
AFFINE_IMAGE_SEED, AFFINE_TEMPLATE_SEED = 1, 2
AFFINE_LINEAR_ATOL, AFFINE_TRANSLATION_ATOL = 5e-3, 0.5  # tests/test_affine2d.py's bounds
AFFINE_CARD_ATOL = 1e-4  # the card against the CPU (the CPU tests hold the CPU at 1e-4 of JAX)
AFFINE_JAX_ATOL = 1e-3  # the card against the JAX package's parameters
AFFINE_REPS = 5
# (b) tests/test_ba.py::make_problem's layout at a keyframe window a VO back
# end runs: every point seen in every keyframe, M = K P observations
BA_K, BA_P, BA_SEED, BA_PERTURB, BA_NOISE_PX = 16, 4096, 5, 0.01, 0.5
BA_CARD_ATOL = 1e-4  # poses, the card against the CPU
BA_REPS = 3
# the JAX package's align and solve (CPU) on these inputs, by chip_smoke_reference.py
JAX_AFFINE = [-0.2853770852088928, 0.14704251289367676, -0.14576895534992218, -0.288555383682251,
              80.38162994384766, 26.56746482849121]
JAX_BA = {"energy": 29703.966796875, "nb_iter": 6, "ate": 0.000756545999256274}
EXAMPLES = ("optim_rosenbrock", "optim_regression_1d", "optim_affine2d", "candidates_coarse_to_fine", "candidates_dso",
            "dataset_tum_read_associations", "dataset_tum_read_trajectory", "track_synthetic", "relocalization",
            "slam_loop_closure", "photometric_window")
EXAMPLE_ATE_RTOL = 0.05  # a tracking example's ATE on the card against the CPU's
# what the JAX package's four tracking examples print (CPU), by
# chip_smoke_reference.py: the card and the CPU tests hold the port's to them
JAX_EXAMPLES = {
    "track_synthetic": {
        "trajectory": [  # timestamp tx ty tz qx qy qz qw of frames 1..7
            [0.03333333333333333, 0.0006884660106152296, -0.0008125060703605413, 0.006391104776412249, 0.0003152650606352836, -0.0009590806439518929, 0.0007242383435368538, 0.9999992251396179],
            [0.06666666666666667, 0.013815865851938725, 0.00822421908378601, -0.0006216329638846219, -0.002315310062840581, -0.0022225494030863047, 0.000796156411524862, 0.9999945163726807],
            [0.1, -0.007908039726316929, 0.004671408329159021, -0.013170908205211163, -0.004034523386508226, -0.0036027098540216684, 0.00016787182539701462, 0.9999853372573853],
            [0.13333333333333333, -0.00436442531645298, 0.014555158093571663, -0.014501689001917839, -0.0014436427736654878, -0.004815912339836359, 0.0008729408727958798, 0.999987006187439],
            [0.16666666666666666, 0.0059846979565918446, 0.01656184159219265, -0.021738169714808464, -0.0030011397320777178, -0.005970308091491461, 0.0013179857051, 0.9999768137931824],
            [0.2, -0.005704227369278669, 0.01421407237648964, -0.023523179814219475, -0.0020245446357876062, -0.005227954592555761, 0.002022226108238101, 0.9999822378158569],
            [0.23333333333333334, -0.012325357645750046, 0.013248473405838013, -0.015774045139551163, 0.0010444280924275517, -0.007732165977358818, 0.005077276844531298, 0.9999566674232483]
        ],
        "ate_mm": 0.802, "keyframe_switches": 0, "failures": 0, "mean_flow": 0.3209,
    },
    "relocalization": {
        "errors_off": [0.0009, 0.0017, 0.0022, 0.0029, 0.3381, 0.3374, 0.3382],
        "errors_on": [0.0009, 0.0017, 0.0022, 0.0029, 0.0012, 0.0007, 0.0028], "relocalizations": 1,
    },
    "slam_loop_closure": {"edges": "[(12, 3), (13, 2), (14, 1), (12, 2), (14, 2), (13, 3)]", "ate_before_cm": 2.03,
                          "ate_after_cm": 0.19},
    "photometric_window": {"candidates": 1024, "iterations": 7, "energy": 1639.7, "idepth_error": [0.0193, 0.0057],
                           "pose_error_mm": 0.89},
}
EXAMPLE_T_ATOL, EXAMPLE_Q_ATOL = 1e-4, 1e-5  # track_synthetic's trajectory against JAX's
EXAMPLE_RELOC_ATOL = 2e-3  # relocalization's position errors against JAX's printed ones
# phase 12: the multi-GPU layer on one card
SHARD_RANKS = 2  # gloo ranks spawned on the card
SHARD_REPS = 5  # timed calls of each sharded solve
PROFILE_TOP = 10  # events of a phase-12 profile printed, by time
SHARD_LANES, SHARD_FRAMES = 8, 4  # phase 6's lanes over a mesh of the card twice
SHARD_PGO = (320, 8)
# tests/test_torch_sharded.py's tolerances, which the JAX package's tests set; the
# BA poses at tests/test_torch_ba.py's for a noisy problem (0.5 px, as phase 11's),
# where a sum in another order walks the poses along the free scale
SHARD_BA_T_ATOL, SHARD_BA_E_RTOL = 2e-3, 0.3
SHARD_WINDOW_ATOL, SHARD_WINDOW_E_RTOL = 1e-4, 1e-3
SHARD_PGO_E_RTOL, SHARD_PGO_NODE_ATOL = 1e-4, 1e-5


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


def slam_sequence():
    """Phase 9's out-and-back sequence (frame 0 initializes)."""
    import numpy as np

    from visual_odometry_rs_tpu_torch.dataset import synthetic

    out = np.asarray(SLAM_TWIST, np.float32)
    twists = np.asarray([out] * SLAM_LEG + [-out] * SLAM_LEG, np.float32)
    return synthetic.generate_sequence(nb_frames=2 * SLAM_LEG + 1, height=HEIGHT, width=WIDTH, seed=SLAM_SEED,
                                       twist_per_frame=twists)


def refine_drifted(poses, seed=REFINE_DRIFT_SEED, scale=REFINE_DRIFT):
    """Camera-to-world poses with a seeded cumulative drift: pose_f ∘ D_f,
    D_f = D_{f-1} ∘ exp(xi_f), xi_f ~ N(0, scale) per component."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.math import se3

    rng = np.random.default_rng(seed)
    drift = [pose_mod.identity()]
    for _ in range(1, len(poses)):
        step = se3.exp(torch.from_numpy((rng.normal(size=6) * scale).astype(np.float32)))
        drift.append(pose_mod.compose(drift[-1], step))
    return [pose_mod.compose(p, d) for p, d in zip(poses, drift)]


def write_refine_inputs(root, grays, depths, timestamps, poses, seed=REFINE_DRIFT_SEED):
    """A sequence as PNGs and its drifted trajectory (one TUM line a frame
    after the first): ``(associations, trajectory, drifted poses)``."""
    import os

    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd

    assoc = tum_rgbd.write_sequence(root, grays, depths, timestamps)
    drifted = refine_drifted(poses, seed)
    traj = os.path.join(root, "drifted.txt")
    with open(traj, "w") as f:
        f.write("".join(tum_rgbd.Frame(timestamp=float(t), pose=p).to_string() + "\n"
                        for t, p in zip(timestamps[1:], drifted[1:])))
    return assoc, traj, drifted


def slam_counts(err: str):
    """(keyframes, verified loop edges, map points) of a vors_slam stderr."""
    import re

    m = re.search(r"(\d+) keyframes, (\d+) verified loop edges", err)
    points = re.search(r"exported (\d+) map points", err)
    if not m:
        raise AssertionError(f"vors_slam printed no keyframe count:\n{err[-2000:]}")
    return int(m.group(1)), int(m.group(2)), int(points.group(1)) if points else None


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


def _diverse_lanes(nb_lanes=LANES, with_poses=False):
    """``bench.py``'s diverse lanes (bench.py:130-145): a magnitude ladder of
    0.004-0.04 m per frame, a direction and a rotation of 0.002 rad scale
    from ``default_rng(42)``, texture seed 100 + lane, the fr1 intrinsics.
    Returns the intrinsics and (F + 1, B, H, W) depths and grays of the
    first ``nb_lanes`` lanes (and, ``with_poses``, their ground truths)."""
    import numpy as np

    from visual_odometry_rs_tpu_torch.dataset import synthetic

    rng = np.random.default_rng(42)
    seqs = []
    for lane in range(nb_lanes):
        mag = 0.004 + 0.036 * lane / (LANES - 1)
        direction = rng.normal(size=3)
        direction = mag * direction / np.linalg.norm(direction)
        rot = 0.002 * rng.normal(size=3)
        seqs.append(synthetic.generate_sequence(
            nb_frames=LANE_FRAMES + 1, height=HEIGHT, width=WIDTH, seed=100 + lane,
            twist_per_frame=np.concatenate([direction, rot]),
        ))
    out = (seqs[0].intrinsics, np.stack([s.depths for s in seqs], axis=1), np.stack([s.grays for s in seqs], axis=1))
    return (*out, [s.poses for s in seqs]) if with_poses else out


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


def _keyframe_diff(kf, ref) -> float:
    """The largest difference of a keyframe's leaves from the reference's;
    raises unless every leaf is bit-equal."""
    import torch

    err = 0.0
    for lvl, (obs, want) in enumerate(zip(kf.levels, ref.levels)):
        for f in FIELDS:
            got, exp = getattr(obs, f), getattr(want, f)
            if got.dtype == torch.bool:
                got, exp = got.to(torch.int32), exp.to(torch.int32)
            if got.shape != exp.shape:
                raise AssertionError(f"precompute level {lvl} {f}: shape {tuple(got.shape)} != {tuple(exp.shape)}")
            diff = float((got - exp).abs().max()) if got.numel() else 0.0
            if not torch.equal(got, exp):
                raise AssertionError(f"precompute level {lvl} {f}: not bit-equal to the plain version "
                                     f"(max diff {diff})")
            err = max(err, diff)
    return err


def phase_precompute(config, intrinsics, depths, grays):
    """Phase 6's keyframe precompute: the kernels against the plain version
    at each of ``PRECOMPUTE_LANES`` lanes; returns the kernel row's numbers
    (at the most lanes)."""
    import torch

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid

    pyr0 = pyramid.mean_pyramid(LEVELS, grays[0])
    caps = config.level_caps()
    levels = tracker_mod.level_intrinsics(intrinsics, LEVELS)
    row = None
    for k in PRECOMPUTE_LANES:
        depth, pyr = depths[0, :k], [p[:k] for p in pyr0]

        def kernels():
            return tracker_mod.precompute_keyframe_counts(config, levels, depth, pyr)

        def plain():
            return tracker_mod.precompute_keyframe_reference(config, intrinsics, depth, pyr)

        (kf, counts), ref = kernels(), plain()
        err = _keyframe_diff(kf, ref)
        want = torch.stack([obs.valid.sum(dim=-1) for obs in ref.levels], dim=-1).to(torch.int32)
        if not torch.equal(counts, want):
            raise AssertionError(f"precompute of {k} lanes: counts {counts.tolist()} != {want.tolist()}")
        k_ms = _time_ms(kernels, reps=20, warmup=3)
        p_ms = _time_ms(plain, reps=5, warmup=1)
        singles_ms = _time_ms(lambda: [tracker_mod.precompute_keyframe_counts(
            config, levels, depth[b], [p[b] for p in pyr]) for b in range(k)], reps=3, warmup=1)
        maps_us = _device_us(kernels, "maps_kernel", reps=20)
        cand_us = _device_us(kernels, "candidates_kernel", reps=20)
        # the u8 pyramid and the int32 depth read once; the slots and the counts written once
        nbytes = k * (sum(p[0].numel() for p in pyr) + depth[0].numel() * 4 + sum(caps) * CANDIDATE_BYTES
                      + 4 * LEVELS)
        b_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        print(f"keyframe precompute of {k} lanes, caps {caps}: every leaf and the counts bit-equal to the "
              f"plain version; valid {want.sum(dim=0).tolist()}; on the device "
              f"maps_kernel {maps_us:.2f} us, candidates_kernel {cand_us:.2f} us (profiler, mean of 20); "
              f"bound {b_ms:.6f} ms by bytes ({nbytes} B; {100 * b_ms / ((maps_us + cand_us) / 1e3):.2f}% of "
              f"the two); per call {k_ms:.3f} ms, plain version {p_ms:.2f} ms, {k} single-lane calls "
              f"{singles_ms:.2f} ms (CUDA events, median)")
        row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by="bytes")
    return row


def phase_batched(card, intrinsics, depths_np, grays_np, dev):
    """Phase 6; returns the kernel rows of the lane-axis solver and of the
    keyframe precompute."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, pyramid, residual
    from visual_odometry_rs_tpu_torch.ops import precompute as precompute_ops
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
    pre_before = precompute_ops.keyframe_levels.launches
    q1, t1, diags1, _ = _batched_run(config, intrinsics, state0, depths, grays, 1)
    launches = lm_solve.lm_solve_level.launches
    if launches != LEVELS * LANE_FRAMES or residual.residual_reduce.launches != 0:
        raise AssertionError(f"batched cadence 1: {launches} lm_solve_level launches for {LANE_FRAMES} frames, "
                             f"{residual.residual_reduce.launches} residual_reduce")
    pre_launches = precompute_ops.keyframe_levels.launches - pre_before
    switch_frames = int(diags1.switched.any(axis=1).sum())
    if pre_launches != 2 * switch_frames:
        raise AssertionError(f"batched cadence 1: {pre_launches} precompute launches for {switch_frames} frames "
                             "with a switch, expected two each")
    print(f"batched cadence 1: {pre_launches} precompute launches for {switch_frames} frames with a switch")
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

    # the keyframe precompute's kernels against the plain version
    pre_row = dict(launches=pre_launches, **phase_precompute(config, intrinsics, depths, grays))

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
    return row, pre_row


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


def _loopy_nodes(n, nloops, seed=0, drift_scale=0.01):
    """tests/test_ba.py::_loopy_graph in the port's math on the host: the
    drifted chain's nodes and the ground-truth loop edges."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.math import se3

    rng = np.random.default_rng(seed)

    def exp(scale):
        return se3.exp(torch.tensor(rng.normal(size=6) * scale, dtype=torch.float32))

    gt = [pose_mod.identity()]
    for _ in range(1, n):
        gt.append(pose_mod.compose(gt[-1], exp(0.05)))
    drift = [pose_mod.identity()]
    for _ in range(1, n):
        drift.append(pose_mod.compose(drift[-1], exp(drift_scale)))
    est = [pose_mod.compose(p, d) for p, d in zip(gt, drift)]
    loops = []
    for _ in range(nloops):
        i, j = int(rng.integers(n // 2, n)), int(rng.integers(0, n // 4))
        loops.append((i, j, pose_mod.compose(pose_mod.inverse(gt[i]), gt[j])))
    return pose_mod.Pose(torch.stack([p.q for p in est]), torch.stack([p.t for p in est])), loops


def _solve_report(name, solver, graph, dev):
    """Two runs of a solve on ``dev`` (bit-equal), the second timed, then its
    launches and host reads (a third run under the profiler); returns
    (result, ms)."""
    import torch

    from visual_odometry_rs_tpu_torch.utils import profiling

    first = solver(graph, max_iterations=20)  # also the first use of the linear algebra libraries
    _sync(dev)
    start = time.perf_counter()
    second = solver(graph, max_iterations=20)
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - start)
    if not (torch.equal(first.nodes.q, second.nodes.q) and torch.equal(first.nodes.t, second.nodes.t)
            and torch.equal(first.energy, second.energy)):
        raise AssertionError(f"{name}: two runs on the card differ")
    prof = profiling.profile_device(lambda: solver(graph, max_iterations=20))
    print(f"{name}: energy {float(first.energy):.6e} after {int(first.nb_iter)} LM iterations; {ms:.1f} ms "
          f"(host clock to a synchronize); {prof.launches} kernel launches and {prof.device_to_host_copies} host "
          f"reads a solve, device busy {prof.device_busy_ms:.1f} ms of {prof.wall_ms:.1f} (profiler on); two runs "
          f"bit-equal")
    return first, ms


def _close(name, a, b, rtol=PGO_E_RTOL, atol=PGO_NODE_ATOL):
    de = abs(float(a.energy) - float(b.energy))
    dn = max(float((a.nodes.q.cpu() - b.nodes.q.cpu()).abs().max()),
             float((a.nodes.t.cpu() - b.nodes.t.cpu()).abs().max()))
    if not (de <= rtol * abs(float(b.energy)) + 1e-8 and dn <= atol):
        raise AssertionError(f"{name}: energy {float(a.energy)} vs {float(b.energy)}, nodes differ by {dn}")
    print(f"{name}: energies {float(a.energy):.6e} / {float(b.energy):.6e}, nodes max |d| {dn:.3e} "
          f"(energy rtol {rtol}, nodes atol {atol})")
    return dn


def phase_pose_graph(dev):
    """Phase 9a: the pose graph on the card against its CPU run."""
    import torch

    from visual_odometry_rs_tpu_torch.parallel import pose_graph

    rows = []
    for n, nloops in PGO_GRAPHS:
        nodes, loops = _loopy_nodes(n, nloops)
        graph = pose_graph.odometry_graph(nodes.to(dev), loop_edges=loops)
        graph_cpu = pose_graph.odometry_graph(nodes, loop_edges=loops)
        r = pose_graph.residuals(graph, graph.nodes)
        e0 = float(torch.sum(r * r))
        solvers = [("dense", pose_graph.solve)] if n <= 64 else []
        solvers.append(("sparse", pose_graph.solve_sparse))
        results = {}
        for label, solver in solvers:
            name = f"pose graph {n} nodes {nloops} loops, {label}"
            results[label], ms = _solve_report(name, solver, graph, dev)
            start = time.perf_counter()
            on_cpu = solver(graph_cpu, max_iterations=20)
            cpu_ms = 1e3 * (time.perf_counter() - start)
            print(f"{name} on the host CPU ({torch.get_num_threads()} threads): {cpu_ms:.1f} ms, "
                  f"{cpu_ms / ms:.2f}x the card's time")
            _close(f"{name}, card vs CPU", results[label], on_cpu)
            rows.append(dict(nodes=n, solver=label, ms=ms, cpu_ms=cpu_ms))
        if "dense" in results:
            _close(f"pose graph {n} nodes, sparse vs dense on the card", results["sparse"], results["dense"])
        energy = float(results["sparse"].energy)
        print(f"pose graph {n} nodes: energy {e0:.4e} -> {energy:.4e} ({100 * energy / e0:.3f}% of the start)")
        if n > 64 and not energy < 0.01 * e0:  # tests/test_ba.py's bar for the 320-node graph
            raise AssertionError(f"pose graph {n} nodes: energy {energy} not under 1% of {e0}")
    return rows


def _drifted(poses):
    """The ground truth with tests/test_loop_closure.py's injected drift."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.math import se3

    rng = np.random.default_rng(SLAM_DRIFT_SEED)
    bias = np.asarray(SLAM_DRIFT_BIAS, np.float32)
    drift = [pose_mod.identity()]
    for _ in range(1, len(poses)):
        step = se3.exp(torch.as_tensor(bias + rng.normal(size=6) * SLAM_DRIFT_NOISE, dtype=torch.float32))
        drift.append(pose_mod.compose(drift[-1], step))
    return [pose_mod.compose(p, d) for p, d in zip(poses, drift)]


def phase_loop_closure(seq, dev):
    """Phase 9b: loop verification at full width; returns the solver
    launches of the verification."""
    import contextlib
    import io

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.models import loop_closure
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve

    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=CAP)
    drifted = _drifted(seq.poses)
    lc = loop_closure.LoopClosureConfig(max_candidates=SLAM_MAX_CANDIDATES)
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        pairs = loop_closure.propose_candidates(drifted, lc)
    lm_solve.lm_solve_level.launches = 0
    _sync(dev)
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        edges = loop_closure.detect_loops(config, seq.intrinsics, drifted, seq.depths, seq.grays, lc, device=dev)
    wall_ms = 1e3 * (time.perf_counter() - start)
    launches = lm_solve.lm_solve_level.launches
    if dev.type == "cuda" and launches != LEVELS:
        raise AssertionError(f"loop verification of {len(pairs)} pairs: {launches} solver launches, not {LEVELS}")
    if len(pairs) != SLAM_MAX_CANDIDATES or not edges:
        raise AssertionError(f"loop closure: {len(pairs)} pairs verified, {len(edges)} edges")
    print(f"loop closure over {len(seq.poses)} drifted poses at {WIDTH}x{HEIGHT}, cap {CAP}: {note.getvalue().strip()}; "
          f"{len(pairs)} pairs verified as lanes of {launches} lm_solve_level launches, {len(edges)} edges accepted; "
          f"{wall_ms:.1f} ms (precompute of the unique keyframes, the six launches, one host read)")
    # every lane against a one-lane solve of its pair (not counted)
    ver = loop_closure.verify_pairs(config, seq.intrinsics, drifted, seq.depths, seq.grays, pairs, device=dev)
    worst, equal = 0.0, 0
    for k, pair in enumerate(pairs):
        one = loop_closure.verify_pairs(config, seq.intrinsics, drifted, seq.depths, seq.grays, [pair], device=dev)
        dt = float((one.model.t[0] - ver.model.t[k]).abs().max())
        dq = float((one.model.q[0] - ver.model.q[k]).abs().max())
        if not (dt <= SOLVE_T_ATOL and dq <= SOLVE_Q_ATOL and bool(one.failed[0] == ver.failed[k])):
            raise AssertionError(f"loop lane {k} {pair}: |dt| {dt} |dq| {dq} from its one-lane solve")
        worst = max(worst, dt, dq)
        equal += int(dt == 0.0 and dq == 0.0)
    print(f"loop lanes vs one-lane solves of each pair: {equal} of {len(pairs)} bit-equal, max |d| {worst:.3e} "
          f"(atol t {SOLVE_T_ATOL} q {SOLVE_Q_ATOL})")
    err_t = err_q = 0.0
    for i, j, z, energy in edges:
        gt = pose_mod.compose(pose_mod.inverse(seq.poses[i]), seq.poses[j])
        dt, dq = float((z.t - gt.t).abs().max()), float((z.q - gt.q).abs().max())
        if not (dt <= LOOP_T_ATOL and dq <= LOOP_Q_ATOL):
            raise AssertionError(f"loop edge {i} <-> {j}: Z_ij off the ground truth by |dt| {dt} |dq| {dq}")
        err_t, err_q = max(err_t, dt), max(err_q, dq)
    print(f"verified Z_ij against the ground truth: max |dt| {err_t:.3e} (atol {LOOP_T_ATOL}), max |dq| {err_q:.3e} "
          f"(atol {LOOP_Q_ATOL}); energies {[round(e, 3) for *_, e in edges]}")
    return launches


class _Timed:
    """Wraps module functions with a host clock that ends in a synchronize;
    ``seconds[name]`` sums their calls."""

    def __init__(self, dev, targets):
        self.dev, self.targets, self.seconds, self.saved = dev, targets, {}, []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            real = getattr(owner, attr)
            self.saved.append((owner, attr, real))
            self.seconds[name] = 0.0

            def timed(*args, _real=real, _name=name, **kwargs):
                start = time.perf_counter()
                out = _real(*args, **kwargs)
                _sync(self.dev)
                self.seconds[_name] += time.perf_counter() - start
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in self.saved:
            setattr(owner, attr, real)


def phase_slam(seq, dev):
    """Phase 9c: vors_slam from PNG files through its main; returns the
    solver launches of its runs."""
    import os
    import shutil
    import tempfile

    from visual_odometry_rs_tpu_torch.cli import vors_slam, vors_track
    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd
    from visual_odometry_rs_tpu_torch.eval import ate
    from visual_odometry_rs_tpu_torch.models import loop_closure
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve
    from visual_odometry_rs_tpu_torch.parallel import pose_graph
    from visual_odometry_rs_tpu_torch.utils import pointcloud

    frames = len(seq.poses)
    split = SLAM_LEG  # the split run saves at the turn
    root = tempfile.mkdtemp(prefix="chip_smoke_slam_")
    try:
        assoc = tum_rgbd.write_sequence(os.path.join(root, "seq"), seq.grays, seq.depths, seq.timestamps)
        lines = open(assoc).read().splitlines()
        first = _write_subset(os.path.join(root, "seq", "first.txt"), lines, 0, 1 + split)
        track_flags = ["--nb-levels", str(LEVELS), "--candidate-cap", str(CAP),
                       *([] if dev.type == "cuda" else ["--cpu"])]
        flags = [*track_flags, "--loop-max-candidates", str(SLAM_MAX_CANDIDATES)]
        total = 0

        def slam(argv, expect_frames):
            """A vors_slam run: six solver launches a tracked frame, six more
            for the verification when an edge was verified."""
            nonlocal total
            lm_solve.lm_solve_level.launches = 0
            out, err, seconds = _cli(vors_slam.main, ["fr1", *argv, *flags])
            launches = lm_solve.lm_solve_level.launches
            total += launches
            expect = LEVELS * (expect_frames + int(slam_counts(err)[1] > 0))
            if dev.type == "cuda" and launches != expect:
                raise AssertionError(f"vors_slam {argv[1:]}: {launches} solver launches, expected {expect}")
            return out, err, seconds

        ply = os.path.join(root, "map.ply")
        timers = {
            "tracking": (tracker_mod.Tracker, "track"),
            "loop closure": (loop_closure, "detect_loops"),
            "pose graph": (pose_graph, "solve"),
            "pose graph (sparse)": (pose_graph, "solve_sparse"),
            "export": (pointcloud, "keyframe_clouds"),
        }
        with _Timed(dev, timers) as timed:
            out, err, wall = slam([assoc, "--export-cloud", ply, "--cloud-voxel", "0"], frames - 1)
        keyframes, edges, points = slam_counts(err)
        est = tum_rgbd.parse_trajectory(out)
        err_slam = ate.ate_rmse([f.pose for f in est], seq.poses[1:])
        tracked, _, _ = _cli(vors_track.main, ["fr1", assoc, *track_flags, "--no-bucket"])
        err_track = ate.ate_rmse([f.pose for f in tum_rgbd.parse_trajectory(tracked)], seq.poses[1:])
        split_s = {k: v for k, v in timed.seconds.items() if v}
        rest = wall - sum(split_s.values())
        print(f"vors_slam fr1 from files, {frames - 1} frames at {WIDTH}x{HEIGHT}: {keyframes} keyframes, {edges} "
              f"verified loop edges, {points} map points (--cloud-voxel 0); wall {1e3 * wall:.1f} ms = "
              f"{1e3 * wall / (frames - 1):.3f} ms a frame, of which "
              + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in split_s.items())
              + f", the rest {1e3 * rest:.1f} ms (start-up, decode waits, output)")
        print(f"vors_slam ATE {err_slam:.6e} m against vors_track's (--no-bucket) {err_track:.6e} m; the JAX "
              f"package's vors_slam: {JAX_SLAM}")
        if (keyframes, edges, points) != (JAX_SLAM["keyframes"], JAX_SLAM["edges"], JAX_SLAM["points"]):
            raise AssertionError(f"vors_slam counts {(keyframes, edges, points)} differ from the JAX package's")
        if not (err_slam <= 1.5 * JAX_SLAM["ate"] and err_slam <= err_track + 2e-3):
            raise AssertionError(f"vors_slam ATE {err_slam} above 1.5 x {JAX_SLAM['ate']} or {err_track} + 2e-3")
        if len(pointcloud.read_ply(ply)[0]) != points:
            raise AssertionError("the PLY file does not hold the points vors_slam reported")
        if slam([assoc, "--kf-store", "memory"], frames - 1)[0] != out:
            raise AssertionError("vors_slam --kf-store memory differs from --kf-store disk")
        ckpt = os.path.join(root, "slam.npz")
        slam([first, "--save-state", ckpt], split)
        resumed, err_r, _ = slam([assoc, "--resume", ckpt], frames - 1 - split)
        if resumed != out or f"resumed from {ckpt}: {split} frames tracked" not in err_r:
            raise AssertionError("vors_slam --save-state/--resume differs from the straight run")
        print(f"vors_slam --kf-store memory and a run split at frame {split} by --save-state/--resume "
              f"({os.path.getsize(ckpt)} bytes): stdout bit-equal to the straight run; {total} solver launches in "
              f"phase 9c's four vors_slam runs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total

# ---------------------------------------------------------------------------
# Phase 10: the photometric window
# ---------------------------------------------------------------------------


def _full_width_window(seq, device):
    """(a)'s window: frames 0..5 of phase 4's sequence at 640x480, the
    keyframe's candidates at cap 2048, the keyframe->frame motions of the
    drifted ground truth (``refine_drifted``)."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.math.pose import Pose
    from visual_odometry_rs_tpu_torch.models import photometric_ba
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import pyramid
    from visual_odometry_rs_tpu_torch.utils.types import depth_tensor, image_tensor

    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=REFINE_CAP)
    intrinsics = seq.intrinsics.to(device)
    pyr = pyramid.mean_pyramid(LEVELS, image_tensor(seq.grays[0], device))
    kf = tracker_mod.precompute_keyframe(config, intrinsics, depth_tensor(seq.depths[0], device), pyr)
    drifted = refine_drifted(seq.poses[:REFINE_WINDOW])
    rel = [pose_mod.compose(pose_mod.inverse(c), drifted[0]) for c in drifted]
    poses = Pose(torch.stack([p.q for p in rel]).to(device), torch.stack([p.t for p in rel]).to(device))
    images = torch.from_numpy(np.stack(seq.grays[:REFINE_WINDOW]).astype(np.float32)).to(device)
    return photometric_ba.window_from_tracking(config, intrinsics, kf.levels, images, poses)


def phase_window_solve(seq, dev):
    """Phase 10a: ``solve_window`` at full width on the card against the
    CPU, two card runs bit-equal, ms, launches, host reads and busy share
    a solve; plain and with brightness and Huber."""
    import torch

    from visual_odometry_rs_tpu_torch.models import photometric_ba
    from visual_odometry_rs_tpu_torch.utils import profiling

    win, win_cpu = _full_width_window(seq, dev), _full_width_window(seq, torch.device("cpu"))
    photometric_ba.solve_window(win)  # the linear-algebra libraries' first use is slow
    _sync(dev)
    rows = {}
    for name, opts in (("plain", {}), ("brightness + Huber 10", {"brightness": True, "robust_delta": 10.0})):
        a, b = photometric_ba.solve_window(win, **opts), photometric_ba.solve_window(win, **opts)
        for x, y in zip((a.poses.q, a.poses.t, a.idepth, a.energy, a.ab, a.nb_iter),
                        (b.poses.q, b.poses.t, b.idepth, b.energy, b.ab, b.nb_iter)):
            if not torch.equal(x, y):
                raise AssertionError(f"solve_window ({name}): two runs on the card differ")
        start = time.perf_counter()
        cpu = photometric_ba.solve_window(win_cpu, **opts)
        cpu_ms = 1e3 * (time.perf_counter() - start)
        dt = float((a.poses.t.cpu() - cpu.poses.t).abs().max())
        dq = float((a.poses.q.cpu() - cpu.poses.q).abs().max())
        if not (max(dt, dq) <= WINDOW_CARD_ATOL and int(a.nb_iter) == int(cpu.nb_iter)):
            raise AssertionError(f"solve_window ({name}): card against CPU |dt| {dt}, |dq| {dq}, LM iterations "
                                 f"{int(a.nb_iter)} against {int(cpu.nb_iter)}")
        ms = _time_ms(lambda: photometric_ba.solve_window(win, **opts), reps=WINDOW_SOLVE_REPS, warmup=1)
        for _ in range(PROFILER_ATTEMPTS):
            prof = profiling.profile_device(lambda: photometric_ba.solve_window(win, **opts))
            if prof.launches > 0 and prof.device_to_host_copies > 0:
                break
        iters = int(a.nb_iter)
        rows[name] = dict(ms=ms, cpu_ms=cpu_ms, launches=prof.launches, reads=prof.device_to_host_copies,
                          busy=prof.busy_share, iters=iters)
        print(f"solve_window ({name}), {REFINE_WINDOW} frames x {REFINE_CAP} candidates at {WIDTH}x{HEIGHT}: "
              f"{iters} LM iterations (CPU {int(cpu.nb_iter)}), energy {float(a.energy):.1f} (CPU "
              f"{float(cpu.energy):.1f}); card against CPU |dt| {dt:.3e} m, |dq| {dq:.3e} (atol {WINDOW_CARD_ATOL}); "
              f"two card runs bit-equal; {ms:.3f} ms a solve (CUDA events, median of {WINDOW_SOLVE_REPS}) against "
              f"{cpu_ms:.1f} ms on the host CPU; {prof.launches} launches = {prof.launches / max(iters, 1):.0f} an "
              f"iteration, {prof.device_to_host_copies} host reads, device busy {100 * prof.busy_share:.2f}% of "
              f"{prof.wall_ms:.1f} ms (profiler on)")
        top = sorted(prof.host_op_calls.items(), key=lambda kv: -kv[1])[:12]
        print("  host operators a solve, most called first: " + ", ".join(f"{k} {v}" for k, v in top))
    return rows


def _ply_count(err, what="refined map points"):
    import re

    m = re.search(rf"exported (\d+) {what}", err)
    if not m:
        raise AssertionError(f"no export count in:\n{err[-2000:]}")
    return int(m.group(1))


def phase_refine(seq, slam_seq, dev):
    """Phase 10b-d: ``vors_refine`` (sliding, chunked, resume, export,
    ``--batch``) and ``vors_slam --refine-window`` from PNG files; returns
    the ``lm_solve_level`` launches of the ``vors_slam`` runs."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from visual_odometry_rs_tpu_torch.cli import vors_refine, vors_slam
    from visual_odometry_rs_tpu_torch.dataset import tum_rgbd
    from visual_odometry_rs_tpu_torch.eval import ate
    from visual_odometry_rs_tpu_torch.ops import lm_solve
    from visual_odometry_rs_tpu_torch.utils import pointcloud

    device_flags = [] if dev.type == "cuda" else ["--cpu"]
    # vors_refine's defaults at 640x480, written out
    refine_flags = [*device_flags, "--nb-levels", str(LEVELS), "--candidate-cap", str(REFINE_CAP), "--window",
                    str(REFINE_WINDOW)]
    root = tempfile.mkdtemp(prefix="chip_smoke_refine_")
    try:
        # (b) phase 4's 41 frames, the drifted ground truth; vors_refine's defaults
        assoc, traj, drifted = write_refine_inputs(os.path.join(root, "seq"), seq.grays[:FRAMES],
                                                   seq.depths[:FRAMES], seq.timestamps[:FRAMES], seq.poses[:FRAMES])
        truth = seq.poses[1:FRAMES]
        ate_in = ate.ate_rmse(drifted[1:], truth)
        ply = os.path.join(root, "map.ply")
        outs = {}
        for mode in ("sliding", "chunked"):
            extra = ["--export-cloud", ply] if mode == "sliding" else []
            out, err, wall = _cli(vors_refine.main, ["fr1", assoc, traj, *refine_flags, "--mode", mode, *extra])
            if mode == "sliding":
                points = _ply_count(err)
            err_mode = ate.ate_rmse([f.pose for f in tum_rgbd.parse_trajectory(out)], truth)
            ref = JAX_REFINE[mode]
            print(f"vors_refine --mode {mode} fr1 from files, {FRAMES - 1} frames at {WIDTH}x{HEIGHT}, cap "
                  f"{REFINE_CAP}, window {REFINE_WINDOW}: ATE {err_mode:.6e} m from the drifted input's {ate_in:.6e}; "
                  f"the JAX package's {ref}; wall {wall:.2f} s = {1e3 * wall / (FRAMES - 1):.1f} ms a frame")
            if not (err_mode < ate_in and err_mode <= 1.5 * ref):
                raise AssertionError(f"vors_refine {mode}: ATE {err_mode} not below {ate_in} or above 1.5 x {ref}")
            outs[mode] = out
        pts, inten = pointcloud.read_ply(ply)
        if not (len(pts) == points > 0 and np.isfinite(pts).all()):
            raise AssertionError(f"the PLY file holds {len(pts)} points, vors_refine exported {points}")
        ply_bytes = open(ply, "rb").read()
        lines = open(assoc).read().splitlines()
        first = _write_subset(os.path.join(root, "seq", "first.txt"), lines, 0, 1 + REFINE_SPLIT)
        first_traj = os.path.join(root, "seq", "first_traj.txt")
        with open(first_traj, "w") as f:
            f.write("".join(open(traj).readlines()[:REFINE_SPLIT]))
        ckpt = os.path.join(root, "window.npz")
        _cli(vors_refine.main, ["fr1", first, first_traj, *refine_flags, "--save-state", ckpt, "--export-cloud", ply])
        resumed, err_r, _ = _cli(vors_refine.main, ["fr1", assoc, traj, *refine_flags, "--resume", ckpt,
                                                    "--export-cloud", ply])
        if resumed != outs["sliding"] or open(ply, "rb").read() != ply_bytes or "resumed from" not in err_r:
            raise AssertionError("vors_refine --save-state/--resume differs from the straight run")
        print(f"vors_refine split at frame {REFINE_SPLIT} by --save-state/--resume ({os.path.getsize(ckpt)} bytes): "
              f"stdout and the PLY file ({points} refined map points, read back) bit-equal to the straight run")

        # (c) --batch on phase 6's first lanes against one-lane sliding runs
        _, lane_depths, lane_grays, lane_poses = _diverse_lanes(REFINE_LANES, with_poses=True)
        pairs, singles = [], []
        for b in range(REFINE_LANES):
            a, t, _ = write_refine_inputs(os.path.join(root, f"lane{b}"), lane_grays[:, b], lane_depths[:, b],
                                          np.arange(LANE_FRAMES + 1) / 30.0, lane_poses[b], seed=REFINE_DRIFT_SEED + b)
            pairs += [a, t]
            singles.append(_cli(vors_refine.main, ["fr1", a, t, *refine_flags])[0])
        out_dir = os.path.join(root, "batch")
        _, _, wall_b = _cli(vors_refine.main, ["fr1", *pairs, *refine_flags, "--batch", "--out-dir", out_dir])
        worst = 0.0
        for b in range(REFINE_LANES):
            lane = _poses_of(open(os.path.join(out_dir, f"lane{b}.txt")).read())
            worst = max(worst, float((lane - _poses_of(singles[b])).abs().max()))
        if not worst <= WINDOW_LANE_ATOL:
            raise AssertionError(f"vors_refine --batch: a lane differs from its one-lane run by {worst}")
        print(f"vors_refine --batch, {REFINE_LANES} of phase 6's lanes x {LANE_FRAMES} frames: every lane within "
              f"{worst:.3e} of its one-lane sliding run (atol {WINDOW_LANE_ATOL}); wall {wall_b:.2f} s for the "
              f"batch")

        # (d) vors_slam --refine-window on phase 9's files
        slam_assoc = tum_rgbd.write_sequence(os.path.join(root, "slam"), slam_seq.grays, slam_seq.depths,
                                             slam_seq.timestamps)
        slam_flags = [*device_flags, "--nb-levels", str(LEVELS), "--candidate-cap", str(CAP),
                      "--loop-max-candidates", str(SLAM_MAX_CANDIDATES), "--refine-window", str(REFINE_WINDOW)]
        frames = len(slam_seq.poses)
        total = 0

        def slam(argv, expect_frames):
            nonlocal total
            lm_solve.lm_solve_level.launches = 0
            out, err, seconds = _cli(vors_slam.main, ["fr1", *argv, *slam_flags])
            launches = lm_solve.lm_solve_level.launches
            total += launches
            expect = LEVELS * (expect_frames + int(slam_counts(err)[1] > 0))
            if dev.type == "cuda" and launches != expect:
                raise AssertionError(f"vors_slam --refine-window {argv[1:]}: {launches} solver launches, "
                                     f"expected {expect}")
            return out, err, seconds

        slam_ply = os.path.join(root, "slam.ply")
        out, err, wall = slam([slam_assoc, "--export-cloud", slam_ply, "--cloud-voxel", "0"], frames - 1)
        counts = slam_counts(err)
        err_slam = ate.ate_rmse([f.pose for f in tum_rgbd.parse_trajectory(out)], slam_seq.poses[1:])
        print(f"vors_slam --refine-window {REFINE_WINDOW} fr1 from files, {frames - 1} frames: {counts[0]} keyframes, "
              f"{counts[1]} verified loop edges, {counts[2]} map points; ATE {err_slam:.6e} m; the JAX package's "
              f"{JAX_SLAM_REFINE}; wall {wall:.2f} s = {1e3 * wall / (frames - 1):.1f} ms a frame")
        if counts != (JAX_SLAM_REFINE["keyframes"], JAX_SLAM_REFINE["edges"], JAX_SLAM_REFINE["points"]):
            raise AssertionError(f"vors_slam --refine-window counts {counts} differ from the JAX package's")
        if not err_slam <= 1.5 * JAX_SLAM_REFINE["ate"]:
            raise AssertionError(f"vors_slam --refine-window ATE {err_slam} above 1.5 x {JAX_SLAM_REFINE['ate']}")
        slam_lines = open(slam_assoc).read().splitlines()
        slam_first = _write_subset(os.path.join(root, "slam", "first.txt"), slam_lines, 0, 1 + SLAM_LEG)
        slam_ckpt = os.path.join(root, "slam.npz")
        slam([slam_first, "--save-state", slam_ckpt], SLAM_LEG)
        if not os.path.exists(slam_ckpt + ".window"):
            raise AssertionError("vors_slam --refine-window --save-state wrote no .window store")
        resumed, err_r, _ = slam([slam_assoc, "--resume", slam_ckpt], frames - 1 - SLAM_LEG)
        if resumed != out or f"resumed from {slam_ckpt}: {SLAM_LEG} frames tracked" not in err_r:
            raise AssertionError("vors_slam --refine-window --save-state/--resume differs from the straight run")
        print(f"vors_slam --refine-window split at frame {SLAM_LEG} by --save-state/--resume (window store "
              f"{os.path.getsize(slam_ckpt + '.window')} bytes): stdout bit-equal to the straight run; {total} solver "
              f"launches in the three runs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def _profiled_part(label, fn, reps):
    """ms a call (CUDA events, median of ``reps``), and one call under the
    profiler: launches, host reads and the device's busy share."""
    from visual_odometry_rs_tpu_torch.utils import profiling

    ms = _time_ms(fn, reps=reps, warmup=1)
    for _ in range(PROFILER_ATTEMPTS):
        prof = profiling.profile_device(fn)
        if prof.launches > 0:
            break
    print(f"  {label}: {ms:.3f} ms a call (CUDA events, median of {reps}); {prof.launches} launches, "
          f"{prof.device_to_host_copies} host reads, device busy {100 * prof.busy_share:.2f}% of "
          f"{prof.wall_ms:.1f} ms (profiler on)")
    top = sorted(prof.host_op_calls.items(), key=lambda kv: -kv[1])[:8]
    print("    host operators a call, most called first: " + ", ".join(f"{k} {v}" for k, v in top))
    return dict(ms=ms, launches=prof.launches, reads=prof.device_to_host_copies, busy=prof.busy_share)


def phase_affine(dev):
    """Phase 11a: ``affine2d.align`` at 640x480 on the card."""
    import numpy as np
    import torch

    from visual_odometry_rs_tpu_torch.dataset import synthetic
    from visual_odometry_rs_tpu_torch.models import affine2d

    img = synthetic.smooth_image(HEIGHT, WIDTH, seed=AFFINE_IMAGE_SEED)
    template, affine_gt = affine2d.random_template(img, seed=AFFINE_TEMPLATE_SEED)
    levels = affine2d.default_nb_levels(HEIGHT, WIDTH)
    t_card, i_card = torch.from_numpy(template).to(dev), torch.from_numpy(img).to(dev)
    affine2d.align(t_card, i_card, levels)  # the linear-algebra libraries' first use is slow
    (a, failed_a), (b, failed_b) = affine2d.align(t_card, i_card, levels), affine2d.align(t_card, i_card, levels)
    if failed_a or failed_b or not torch.equal(a, b):
        raise AssertionError(f"align: failed {failed_a}/{failed_b}, or two runs on the card differ")
    start = time.perf_counter()
    cpu, failed_cpu = affine2d.align(torch.from_numpy(template), torch.from_numpy(img), levels)
    cpu_ms = 1e3 * (time.perf_counter() - start)
    card_cpu = float((a.cpu() - cpu).abs().max())
    card_jax = float((a.cpu() - torch.tensor(JAX_AFFINE)).abs().max())
    w = affine2d.warp_matrix(a).cpu().numpy()[:2]
    lin, trans = float(np.abs(w[:, :2] - affine_gt[:, :2]).max()), float(np.abs(w[:, 2] - affine_gt[:, 2]).max())
    print(f"align at {WIDTH}x{HEIGHT}, {levels} levels (level 0: {HEIGHT * WIDTH} pixels): card against CPU "
          f"{card_cpu:.3e} (atol {AFFINE_CARD_ATOL}), against JAX {card_jax:.3e} (atol {AFFINE_JAX_ATOL}); the "
          f"ground truth within {lin:.3e} (linear, atol {AFFINE_LINEAR_ATOL}) and {trans:.3e} px (translation, "
          f"atol {AFFINE_TRANSLATION_ATOL}); two card runs bit-equal; the host CPU {cpu_ms:.1f} ms")
    if failed_cpu or not (card_cpu <= AFFINE_CARD_ATOL and card_jax <= AFFINE_JAX_ATOL
                          and lin <= AFFINE_LINEAR_ATOL and trans <= AFFINE_TRANSLATION_ATOL):
        raise AssertionError("align: outside its tolerances")
    return _profiled_part("align", lambda: affine2d.align(t_card, i_card, levels), AFFINE_REPS)


def phase_ba(dev):
    """Phase 11b: window BA at K=16, P=4096 on the card."""
    import torch

    from visual_odometry_rs_tpu_torch.eval import ate
    from visual_odometry_rs_tpu_torch.math.pose import Pose
    from visual_odometry_rs_tpu_torch.parallel import ba

    def problem(device):
        return ba.synthetic_problem(K=BA_K, P=BA_P, seed=BA_SEED, perturb=BA_PERTURB, noise_px=BA_NOISE_PX,
                                    device=device)

    prob, gt_poses, _ = problem(dev)
    ba.solve(prob, max_iterations=1)  # the linear-algebra libraries' first use is slow
    a, b = ba.solve(prob), ba.solve(prob)
    for x, y in zip((a.poses.q, a.poses.t, a.points, a.energy), (b.poses.q, b.poses.t, b.points, b.energy)):
        if not torch.equal(x, y):
            raise AssertionError("BA solve: two runs on the card differ")
    cpu_prob = problem(torch.device("cpu"))[0]
    start = time.perf_counter()
    cpu = ba.solve(cpu_prob)
    cpu_ms = 1e3 * (time.perf_counter() - start)
    e0 = float(ba._energy(prob, prob.poses, prob.points))
    dt = float((a.poses.t.cpu() - cpu.poses.t).abs().max())
    poses = [Pose(a.poses.q[k].cpu(), a.poses.t[k].cpu()) for k in range(BA_K)]
    gt = [Pose(gt_poses.q[k].cpu(), gt_poses.t[k].cpu()) for k in range(BA_K)]
    err = ate.ate_rmse(poses, gt, with_scale=True)
    print(f"BA solve, K={BA_K} keyframes x P={BA_P} points = {BA_K * BA_P} observations ({BA_NOISE_PX} px noise): "
          f"{int(a.nb_iter)} LM iterations (CPU {int(cpu.nb_iter)}, JAX {JAX_BA['nb_iter']}), energy {e0:.1f} -> "
          f"{float(a.energy):.3f} (CPU {float(cpu.energy):.3f}, JAX {JAX_BA['energy']:.3f}); card against CPU "
          f"|dt| {dt:.3e} m (atol {BA_CARD_ATOL}); ATE {err:.6e} m (JAX {JAX_BA['ate']:.6e}, bound 1.5x); two card "
          f"runs bit-equal; the host CPU {cpu_ms:.1f} ms")
    if not (dt <= BA_CARD_ATOL and float(a.energy) < 0.5 * e0 and err <= 1.5 * JAX_BA["ate"]):
        raise AssertionError("BA solve: outside its tolerances")
    row = _profiled_part("BA solve", lambda: ba.solve(prob), BA_REPS)
    row["iters"] = int(a.nb_iter)
    return row


def _example(name, argv):
    """An example's ``main(argv)`` with its output captured: (value, stdout, stderr)."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"visual_odometry_rs_tpu_torch.examples.{name}").main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        value = main(argv)
    return value, out.getvalue(), err.getvalue()


def phase_examples(dev):
    """Phase 11c: the 11 example programs through their ``main`` on the
    card, each against its run on the CPU, and the four tracking examples
    against the JAX package's (``JAX_EXAMPLES``); returns the solver
    launches."""
    import re
    import tempfile

    import numpy as np

    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual
    from visual_odometry_rs_tpu_torch.utils import profiling

    attempts = [0]
    real_attempt = tracker_mod.Tracker._try_relocalize

    def counted_attempt(self, pyr):
        attempts[0] += 1
        return real_attempt(self, pyr)

    total = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as root:
        for name in EXAMPLES:
            out_dir = name.startswith("candidates")  # the overlays go to a directory of their own
            cpu = _example(name, ["--cpu"] + (["--out-dir", f"{root}/cpu_{name}"] if out_dir else []))
            card_args = ["--out-dir", f"{root}/card_{name}"] if out_dir else []
            lm_solve.lm_solve_level.launches = 0
            residual.residual_reduce.launches = 0
            attempts[0] = 0
            tracker_mod.Tracker._try_relocalize = counted_attempt
            try:
                box = {}
                prof = profiling.profile_device(lambda: box.setdefault("run", _example(name, card_args)))
            finally:
                tracker_mod.Tracker._try_relocalize = real_attempt
            launches = lm_solve.lm_solve_level.launches
            (value, out, err), (cpu_value, cpu_text, _) = box["run"], cpu
            expected = {"track_synthetic": 5 * 7, "relocalization": 3 * (2 * 7 + attempts[0]),
                        "slam_loop_closure": 3}.get(name, 0)
            if launches != expected or residual.residual_reduce.launches != 0:
                raise AssertionError(f"example {name}: {launches} lm_solve_level launches, expected {expected}; "
                                     f"{residual.residual_reduce.launches} residual_reduce launches, expected 0")
            if name == "track_synthetic":
                ref = JAX_EXAMPLES[name]
                traj = np.array([[float(x) for x in line.split()] for line in out.splitlines()])
                jax_traj = np.array(ref["trajectory"])
                dt, dq = np.abs(traj[:, 1:4] - jax_traj[:, 1:4]).max(), np.abs(traj[:, 4:] - jax_traj[:, 4:]).max()
                ok = abs(value - cpu_value) <= EXAMPLE_ATE_RTOL * cpu_value and \
                    abs(1e3 * value - ref["ate_mm"]) <= EXAMPLE_ATE_RTOL * ref["ate_mm"] and \
                    dt <= EXAMPLE_T_ATOL and dq <= EXAMPLE_Q_ATOL and np.array_equal(traj[:, 0], jax_traj[:, 0])
                detail = (f"ATE {1e3 * value:.3f} mm (CPU {1e3 * cpu_value:.3f}, JAX {ref['ate_mm']}), trajectory "
                          f"within {dt:.2e} m and {dq:.2e} of JAX's")
            elif name == "relocalization":
                ref = JAX_EXAMPLES[name]
                d = max(np.abs(np.array(value[0]) - ref["errors_off"]).max(),
                        np.abs(np.array(value[1]) - ref["errors_on"]).max())
                ok = value[2] == ref["relocalizations"] and value[1][-1] < 0.05 < value[0][-1] and \
                    d <= EXAMPLE_RELOC_ATOL
                detail = (f"relocalizations {value[2]} (JAX {ref['relocalizations']}), post-kidnap error "
                          f"{value[1][-1]:.4f} m against {value[0][-1]:.4f}; errors within {d:.1e} m of JAX's")
            elif name == "slam_loop_closure":
                ref = JAX_EXAMPLES[name]
                edges = re.search(r"verified loop edges: (.*)", out).group(1)
                after = float(re.search(r"ATE after  loop closure: ([\d.]+) cm", out).group(1))
                ok = value < 0.5 and edges == ref["edges"] and abs(after - ref["ate_after_cm"]) <= 0.05 and \
                    edges == re.search(r"verified loop edges: (.*)", cpu_text).group(1)
                detail = (f"ATE ratio {value:.3f} (CPU {cpu_value:.3f}), after {after:.2f} cm (JAX "
                          f"{ref['ate_after_cm']:.2f}); verified edges {edges} as the CPU's and JAX's")
            elif name == "photometric_window":
                ref = JAX_EXAMPLES[name]
                iters = int(re.search(r"LM iterations: (\d+)", out).group(1))
                energy = float(re.search(r"final energy ([\d.]+)", out).group(1))
                ok = value[1] < 0.5 * value[0] and abs(value[1] - cpu_value[1]) <= 1e-3 and \
                    abs(iters - ref["iterations"]) <= 2 and abs(energy - ref["energy"]) <= 1e-3 * ref["energy"] and \
                    abs(value[1] - ref["idepth_error"][1]) <= 1e-3 and abs(1e3 * value[2] - ref["pose_error_mm"]) <= 0.1
                detail = (f"inverse-depth error {value[0]:.4f} -> {value[1]:.4f} (CPU -> {cpu_value[1]:.4f}, JAX -> "
                          f"{ref['idepth_error'][1]}), {iters} LM iterations (JAX {ref['iterations']}), energy "
                          f"{energy} (JAX {ref['energy']}), pose error {1e3 * value[2]:.2f} mm (JAX "
                          f"{ref['pose_error_mm']})")
            elif name == "optim_affine2d":
                gt, computed, failed = value
                ok = not failed and np.abs(computed[:, :2] - gt[:, :2]).max() <= AFFINE_LINEAR_ATOL and \
                    np.abs(computed[:, 2] - gt[:, 2]).max() <= AFFINE_TRANSLATION_ATOL and \
                    np.abs(computed - cpu_value[1]).max() <= AFFINE_CARD_ATOL
                detail = f"warp within {np.abs(computed - gt).max():.3e} of the ground truth"
            elif name.startswith("optim_"):
                model = value.state.model.cpu().numpy()
                ok = np.allclose(model, cpu_value.state.model.numpy(), atol=1e-5)
                detail = f"{int(value.nb_iter)} iterations (CPU {int(cpu_value.nb_iter)}), model {model.tolist()}"
            elif name.startswith("candidates"):
                ok = value == cpu_value
                detail = f"candidates {value} (CPU {cpu_value})"
            else:
                ok = out == cpu_text
                detail = f"{len(out.splitlines())} lines as on the CPU"
            if not ok:
                raise AssertionError(f"example {name} on the card: {detail}\n{out[-1500:]}\n{err[-1500:]}")
            total += launches
            print(f"  example {name}: {detail}; {launches} lm_solve_level launches; {prof.wall_ms:.1f} ms, "
                  f"{prof.launches} launches, {prof.device_to_host_copies} host reads, device busy "
                  f"{100 * prof.busy_share:.2f}% (profiler on)")
    return total


def _by_point(problem, n):
    """A BA problem with its observations in point order, each rank's
    ``obs_pt`` indices into its own ``P/n`` points (the sharded solve's
    input, as ``tests/test_ba.py`` builds it)."""
    import torch

    order = torch.argsort(problem.obs_pt, stable=True)
    shard = problem.points.shape[0] // n
    return problem._replace(obs_kf=problem.obs_kf[order], obs_pt=problem.obs_pt[order] % shard,
                            obs_uv=problem.obs_uv[order], obs_mask=problem.obs_mask[order])


def _shard_inputs(bucketed, pyr1, seq, model, dev):
    """Phase 12's problems on the card: the bucketed level 0 and frame 1's
    image (solved from the identity; the kernel checked at phase 1's pose
    near the solution, ``model``, off the candidates' integer pixels), the
    BA window, the photometric window and the pose graph."""
    from visual_odometry_rs_tpu_torch.math import pose as pose_mod
    from visual_odometry_rs_tpu_torch.parallel import ba, pose_graph

    nodes, loops = _loopy_nodes(*SHARD_PGO)
    return dict(
        obs=bucketed.levels[0], image=pyr1[0], model0=pose_mod.identity(dev), model=model,
        ba=ba.synthetic_problem(K=BA_K, P=BA_P, seed=BA_SEED, perturb=BA_PERTURB, noise_px=BA_NOISE_PX,
                                device=dev)[0],
        window=_full_width_window(seq, dev), graph=pose_graph.odometry_graph(nodes.to(dev), loop_edges=loops),
    )


def _run_timed(calls):
    """Each call once for its result, then timed (CUDA events, median of
    ``SHARD_REPS``; the pose graph's one call is its timed one): (results,
    ms a call, ``residual_reduce`` launches of the first calls)."""
    from visual_odometry_rs_tpu_torch.ops import residual

    results, ms = {}, {}
    residual.residual_reduce.launches = 0
    for name, fn in calls.items():
        box = {}
        first = _time_ms(lambda: box.update(out=fn()), reps=1, warmup=0)
        results[name] = box["out"]
        ms[name] = first if name == "pgo" else None
    launches = residual.residual_reduce.launches
    for name, fn in calls.items():
        if ms[name] is None:
            ms[name] = _time_ms(fn, reps=SHARD_REPS, warmup=0)
    return results, ms, launches


def _sharded_solves(inputs, mesh, axis):
    """Every sharded path of the port on ``mesh[axis]``, by ``_run_timed``."""
    from visual_odometry_rs_tpu_torch.models import photometric_ba
    from visual_odometry_rs_tpu_torch.parallel import ba, pose_graph, sharded

    n = mesh.shape[axis]
    problem = _by_point(inputs["ba"], n)
    calls = {
        "level": lambda: sharded.solve_level_point_sharded(inputs["obs"], inputs["image"], inputs["model0"], mesh,
                                                           axis),
        "ba_psum": lambda: ba.solve_point_sharded(problem, mesh, axis, assembly="psum"),
        "ba_ring": lambda: ba.solve_point_sharded(problem, mesh, axis, assembly="ring"),
        "window": lambda: photometric_ba.solve_window_sharded(inputs["window"], mesh, axis),
        "pgo": lambda: pose_graph.solve_sparse_sharded(inputs["graph"], mesh, axis),
    }
    return _run_timed(calls)


def _shard_rank(rank, where, device):
    """A spawned rank of phase 12b: the gloo group on ``device`` (the card),
    every sharded path, its results and counts saved for the parent."""
    import torch
    import torch.distributed as dist

    from visual_odometry_rs_tpu_torch.ops import residual
    from visual_odometry_rs_tpu_torch.parallel import collectives
    from visual_odometry_rs_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_rs_tpu_torch.parallel import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    mesh_mod.init_distributed(backend="gloo", init_method=f"file://{where}/store", world_size=SHARD_RANKS,
                              rank=rank, device=dev)
    mesh = mesh_mod.make_mesh((SHARD_RANKS,), ("points",), devices=[dev], groups={"points": dist.group.WORLD})
    inputs = _moved(torch.load(f"{where}/inputs.pt", weights_only=False), dev)
    results, ms, launches = _sharded_solves(inputs, mesh, "points")
    # this rank's half of the level through the kernel and its twin
    local = sharded.shard_level(inputs["obs"], mesh, "points")
    params = torch.cat([inputs["model"].q, inputs["model"].t, local.intrinsics.vector()])
    args = (inputs["image"], local.xs, local.ys, local.idepth, local.tmpl_vals, local.valid, local.jacobians, params)
    got, ref = residual.residual_reduce(*args), residual.residual_reduce_reference(*args)
    err = _check_close(f"rank {rank}: its {local.xs.shape[0]} candidates", got, ref, int(local.valid.sum()))
    kernel = dict(n=local.xs.shape[0], inside=float(got[2]), err=err)
    x = torch.arange(SHARD_RANKS * 12, dtype=torch.float32, device=dev).reshape(SHARD_RANKS * 4, 3) * (rank + 0.5)
    ring_equal = torch.equal(collectives.ring_all_reduce(x, mesh, "points"), collectives.psum(x, mesh, "points"))
    torch.save(dict(results=_moved(results, "cpu"), ms=ms, launches=launches, kernel=kernel, ring_equal=ring_equal),
               f"{where}/rank{rank}.pt")
    dist.barrier()  # no rank tears its connections down while another still uses them
    dist.destroy_process_group()


def _moved(tree, device):
    """Every tensor of a tree of dicts, tuples and NamedTuples on ``device``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_moved(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moved(x, device) for x in tree)
    return tree


def _max_diff(a, b) -> float:
    import torch

    if isinstance(a, torch.Tensor):
        return float((a.float().cpu() - b.float().cpu()).abs().max()) if a.numel() else 0.0
    return max((_max_diff(x, y) for x, y in zip(a, b)), default=0.0)


def _bit_equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, (tuple, list)):
        return all(_bit_equal(x, y) for x, y in zip(a, b))
    return a == b


def _singles(inputs, dev):
    """The single-device solves that phase 12 holds the sharded ones
    against, with ms a call."""
    from visual_odometry_rs_tpu_torch.models import photometric_ba
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.parallel import ba, pose_graph

    problem = _by_point(inputs["ba"], 1)
    pose_graph.solve_sparse(inputs["graph"], max_iterations=1)  # the linear-algebra libraries' first use is slow
    calls = {
        "level": lambda: tracker_mod.solve_level_reference(inputs["obs"], inputs["image"], inputs["model0"]),
        "level_kernel": lambda: tracker_mod.solve_level(inputs["obs"], inputs["image"], inputs["model0"]),
        "ba": lambda: ba.solve(problem),
        "window": lambda: photometric_ba.solve_window(inputs["window"]),
        "pgo": lambda: pose_graph.solve_sparse(inputs["graph"]),
    }
    return _run_timed(calls)[:2]


def phase_multi_gpu(seq, bucketed, pyr1, model, lane_intrinsics, lane_depths, lane_grays, dev):
    """Phase 12; returns the kernel row of ``residual_reduce`` as the
    point-sharded solve launches it, per rank."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from visual_odometry_rs_tpu_torch.models import photometric_ba
    from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod
    from visual_odometry_rs_tpu_torch.ops import lm_solve, residual
    from visual_odometry_rs_tpu_torch.parallel import batch
    from visual_odometry_rs_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_rs_tpu_torch.parallel import sharded
    from visual_odometry_rs_tpu_torch.utils import profiling

    inputs = _shard_inputs(bucketed, pyr1, seq, model, dev)
    obs = inputs["obs"]
    singles, single_ms = _singles(inputs, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as where:
        # (a) a world of one rank on NCCL, in this process
        mesh_mod.init_distributed(init_method=f"file://{where}/store1", world_size=1, rank=0, device=dev)
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"the world of one rank on {dev} runs {dist.get_backend()}")
        world = mesh_mod.make_mesh((1,), ("points",), devices=[dev], groups={"points": dist.group.WORLD})
        one, one_ms, launches = _sharded_solves(inputs, world, "points")
        profiles = {
            "the point-sharded solve on one NCCL rank": profiling.profile_device(
                lambda: sharded.solve_level_point_sharded(obs, inputs["image"], inputs["model0"], world, "points")),
            "the Python loop": profiling.profile_device(
                lambda: tracker_mod.solve_level_reference(obs, inputs["image"], inputs["model0"])),
        }
        reads = profiles["the point-sharded solve on one NCCL rank"].device_to_host_copies
        dist.destroy_process_group()
        (model, failed, nb_iter), ref = one["level"], singles["level"]
        if not (_bit_equal(model, ref.state.model) and failed == ref.failed and nb_iter == ref.nb_iter):
            raise AssertionError("point-sharded solve on one rank: not bit-equal to solve_level_reference")
        kernel_solve = singles["level_kernel"]
        dt = float((model.t - kernel_solve.state.model.t).abs().max())
        dq = float((model.q - kernel_solve.state.model.q).abs().max())
        slack = abs(nb_iter - int(kernel_solve.nb_iter))
        if not (dt <= SOLVE_T_ATOL and dq <= SOLVE_Q_ATOL and slack <= SOLVE_ITER_SLACK and not failed):
            raise AssertionError(f"point-sharded solve against lm_solve_level: |dt| {dt} |dq| {dq}, nb_iter {nb_iter} "
                                 f"vs {int(kernel_solve.nb_iter)}, failed {failed}")
        if launches != nb_iter + 1:  # the start and every iteration's evaluation
            raise AssertionError(f"point-sharded solve: {launches} residual_reduce launches for {nb_iter} iterations")
        for name, single in (("ba_psum", singles["ba"]), ("ba_ring", singles["ba"]), ("window", singles["window"]),
                             ("pgo", singles["pgo"])):
            if not _bit_equal(tuple(one[name]), tuple(single)):
                raise AssertionError(f"{name} on one rank: not bit-equal to the single-device solve")
        print(f"one NCCL rank: the point-sharded level solve at {WIDTH}x{HEIGHT} level 0, N={obs.xs.shape[0]} "
              f"(bucketed): {nb_iter} iterations, {launches} residual_reduce launches, bit-equal to "
              f"solve_level_reference, |dt| {dt:.3e} |dq| {dq:.3e} from lm_solve_level (atol {SOLVE_T_ATOL}, "
              f"{SOLVE_Q_ATOL}); {reads} host reads a solve (profiler); BA psum and ring, the window and the "
              f"{SHARD_PGO[0]}-node pose graph bit-equal to their single-device solves")
        print(f"  level: {one_ms['level']:.3f} ms a call on one NCCL rank against {single_ms['level']:.3f} ms for "
              f"the Python loop and {single_ms['level_kernel']:.3f} ms for lm_solve_level (CUDA events, median of "
              f"{SHARD_REPS})")
        for label, prof in profiles.items():
            host = sorted(prof.host_ms.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
            kernels = sorted(prof.kernel_ms.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
            print(f"  profile of {label} (profiler on): wall {prof.wall_ms:.3f} ms, device busy "
                  f"{prof.device_busy_ms:.3f} ms, {prof.launches} launches, {prof.device_to_host_copies} host reads; "
                  f"host ms by event (nested events overlap): {'; '.join(f'{n} {t:.3f}' for n, t in host)}; "
                  f"device ms by kernel: {'; '.join(f'{n[:70]} {t:.3f} x{prof.kernel_calls[n]}' for n, t in kernels)}")
        for name, single in (("ba_psum", "ba"), ("ba_ring", "ba"), ("window", "window"), ("pgo", "pgo")):
            print(f"  {name}: {one_ms[name]:.3f} ms a call on one NCCL rank against {single_ms[single]:.3f} ms "
                  f"single-device (CUDA events, median of {1 if name == 'pgo' else SHARD_REPS})")

        # (b) two ranks on the card over gloo
        torch.save(_moved(inputs, "cpu"), f"{where}/inputs.pt")
        start = time.perf_counter()
        mp.start_processes(_shard_rank, args=(where, str(dev)), nprocs=SHARD_RANKS, start_method="spawn", join=True)
        spawn_s = time.perf_counter() - start
        ranks = [torch.load(f"{where}/rank{r}.pt", weights_only=False) for r in range(SHARD_RANKS)]
    for r in ranks[1:]:
        if not _bit_equal(tuple(r["results"]["level"]), tuple(ranks[0]["results"]["level"])):
            raise AssertionError("the two gloo ranks disagree on the level solve")
    if not all(r["ring_equal"] for r in ranks):
        raise AssertionError("ring all-reduce of two ranks differs from the fixed-order sum")
    (model2, failed2, iters2), ref_model = ranks[0]["results"]["level"], singles["level"].state.model
    dt2 = float((model2.t - ref_model.t.cpu()).abs().max())
    dq2 = float((model2.q - ref_model.q.cpu()).abs().max())
    if failed2 or dt2 > SOLVE_T_ATOL or dq2 > SOLVE_Q_ATOL or abs(iters2 - singles["level"].nb_iter) > SOLVE_ITER_SLACK:
        raise AssertionError(f"two gloo ranks: level solve |dt| {dt2} |dq| {dq2}, nb_iter {iters2}")
    per_rank = [r["launches"] for r in ranks]
    if any(n != iters2 + 1 for n in per_rank):
        raise AssertionError(f"two gloo ranks: residual_reduce launches {per_rank} for {iters2} iterations")
    res2 = ranks[0]["results"]
    ba_dt = max(float((res2[k].poses.t - singles["ba"].poses.t.cpu()).abs().max()) for k in ("ba_psum", "ba_ring"))
    ba_de = max(abs(float(res2[k].energy) / float(singles["ba"].energy) - 1) for k in ("ba_psum", "ba_ring"))
    win_dt = float((res2["window"].poses.t - singles["window"].poses.t.cpu()).abs().max())
    win_de = abs(float(res2["window"].energy) / float(singles["window"].energy) - 1)
    pgo_dt = float((res2["pgo"].nodes.t - singles["pgo"].nodes.t.cpu()).abs().max())
    pgo_de = abs(float(res2["pgo"].energy) / float(singles["pgo"].energy) - 1)
    print(f"two gloo ranks on the card (spawned, {spawn_s:.1f} s with their start): level solve {iters2} iterations "
          f"(single {singles['level'].nb_iter}), |dt| {dt2:.3e} |dq| {dq2:.3e} (atol {SOLVE_T_ATOL}, {SOLVE_Q_ATOL}); "
          f"residual_reduce launches per rank {per_rank}; the kernel on each half against its twin "
          f"{', '.join(format(r['kernel']['err'], '.3e') for r in ranks)}; BA |dt| {ba_dt:.3e} (atol "
          f"{SHARD_BA_T_ATOL}), energy {ba_de:.3e} relative (rtol {SHARD_BA_E_RTOL}); window |dt| {win_dt:.3e} (atol {SHARD_WINDOW_ATOL}), "
          f"energy {win_de:.3e} (rtol {SHARD_WINDOW_E_RTOL}); pose graph |dt| {pgo_dt:.3e} (atol "
          f"{SHARD_PGO_NODE_ATOL}), energy {pgo_de:.3e} (rtol {SHARD_PGO_E_RTOL}); the rings equal the fixed-order sum")
    for name in ("level", "ba_psum", "ba_ring", "window", "pgo"):
        print(f"  {name}: {statistics.median(r['ms'][name] for r in ranks):.3f} ms a call on two gloo ranks "
              f"(median of the ranks' CUDA-event medians)")
    if not (ba_dt <= SHARD_BA_T_ATOL and ba_de <= SHARD_BA_E_RTOL and win_dt <= SHARD_WINDOW_ATOL
            and win_de <= SHARD_WINDOW_E_RTOL and pgo_dt <= SHARD_PGO_NODE_ATOL and pgo_de <= SHARD_PGO_E_RTOL):
        raise AssertionError("two gloo ranks: a sharded solve outside its tolerance")

    # (c) lanes over a mesh of the card twice: two threads, two halves of the lanes
    lanes = mesh_mod.make_mesh((2,), ("data",), devices=[dev, dev])
    config = tracker_mod.TrackerConfig(height=HEIGHT, width=WIDTH, nb_levels=LEVELS, candidate_cap=LANE_CAP)
    intrinsics = lane_intrinsics.to(dev)
    depths = torch.from_numpy(lane_depths[: SHARD_FRAMES + 1, :SHARD_LANES].astype(np.int32)).to(dev)
    grays = torch.from_numpy(lane_grays[: SHARD_FRAMES + 1, :SHARD_LANES]).to(dev)
    state = batch.batched_init_state(config, intrinsics, depths[0], grays[0], device=dev)
    plain = batch.batched_track_sequence(config, intrinsics, state, depths[1:], grays[1:])
    lm_solve.lm_solve_level.launches = 0
    spread = batch.batched_track_sequence(config, intrinsics, state, depths[1:], grays[1:], mesh=lanes)
    lane_launches = lm_solve.lm_solve_level.launches
    step_equal = _bit_equal(batch.make_sharded_step(config, intrinsics, lanes)(state, depths[1], grays[1]),
                            batch.batched_track_step(config, intrinsics, state, depths[1], grays[1]))
    if not (_bit_equal(spread, plain) and step_equal):
        raise AssertionError(f"lanes over the mesh: not bit-equal to the run without it "
                             f"(max |d| {_max_diff(spread, plain):.3e})")
    if lane_launches != 2 * LEVELS * SHARD_FRAMES:
        raise AssertionError(f"lanes over the mesh: {lane_launches} lm_solve_level launches, expected "
                             f"{2 * LEVELS * SHARD_FRAMES}")
    # a second lane: the same frames with the depth anchors 1% further
    win = inputs["window"]
    wins = photometric_ba.stack_windows([win, win._replace(idepth=win.idepth * 1.01)])
    w_plain = photometric_ba.solve_window_batched(wins, max_iterations=5)
    w_spread = photometric_ba.solve_window_batched(wins, lanes, max_iterations=5)
    w_pose = max(_max_diff(w_spread.poses, w_plain.poses), _max_diff(w_spread.idepth, w_plain.idepth),
                 _max_diff(w_spread.ab, w_plain.ab))
    w_energy = float(((w_spread.energy - w_plain.energy).abs() / w_plain.energy.abs()).max())
    w_equal = _bit_equal(tuple(w_spread), tuple(w_plain))
    print(f"lanes over the card twice: {SHARD_LANES} lanes x {SHARD_FRAMES} frames, bit-equal per lane to the "
          f"run without a mesh ({lane_launches} lm_solve_level launches, {LEVELS} a frame on each half), "
          f"make_sharded_step bit-equal; two windows over the mesh against the batch: "
          f"{'bit-equal' if w_equal else 'not bit-equal'}, poses, depths and brightness within {w_pose:.3e} (atol "
          f"{SHARD_WINDOW_ATOL}), energy {w_energy:.3e} relative (rtol {SHARD_WINDOW_E_RTOL}), LM iterations "
          f"{w_spread.nb_iter.tolist()} and {w_plain.nb_iter.tolist()}")
    # the card's sums over a lane's pairs block by the number of lanes a
    # launch holds, so half the lanes sum in another order: the sharded
    # window's tolerances, not bit-equality
    if not (w_pose <= SHARD_WINDOW_ATOL and w_energy <= SHARD_WINDOW_E_RTOL
            and torch.equal(w_spread.nb_iter.cpu(), w_plain.nb_iter.cpu())):
        raise AssertionError("windows over the mesh: outside the tolerance of the batch")

    # the kernel row: residual_reduce at rank 0's half of the level, timed
    # here after the ranks have exited, so that no other rank shares the card
    k = ranks[0]["kernel"]
    half = [getattr(obs, f)[: k["n"]].contiguous() for f in ("xs", "ys", "idepth", "tmpl_vals", "valid", "jacobians")]
    args = (inputs["image"], *half, torch.cat([inputs["model"].q, inputs["model"].t, obs.intrinsics.vector()]))
    out = torch.empty(residual.OUT_SIZE, device=dev)
    k_ms = _time_ms(lambda: residual.residual_reduce(*args, out=out))
    k_plain_ms = _time_ms(lambda: residual.residual_reduce_reference(*args))
    b_ms, b_by = _bound(k["n"], inputs["image"].shape, k["inside"], 1, residual.OUT_SIZE)
    print(f"residual_reduce per rank (N={k['n']}, rank 0's half): kernel {k_ms:.4f} ms, twin {k_plain_ms:.4f} ms "
          f"(CUDA events, median of 100, in this process after the ranks exit); bound {b_ms:.6f} ms by {b_by}")
    return dict(launches=launches + sum(per_rank), max_abs_err=max(r["kernel"]["err"] for r in ranks), ms=k_ms,
                plain_ms=k_plain_ms, bound_ms=b_ms, bound_by=b_by)


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
    from visual_odometry_rs_tpu_torch.ops import precompute as precompute_ops
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
    precompute_ops.keyframe_levels.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trk, poses, seconds, evaluations = _track(seq, FRAMES, dev)
    solve_launches = lm_solve.lm_solve_level.launches
    pre_launches = precompute_ops.keyframe_levels.launches
    if pre_launches != 2 * (1 + trk.keyframe_switches):
        raise AssertionError(f"{pre_launches} precompute launches for {1 + trk.keyframe_switches} keyframes")
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
          f"{solve_launches}; precompute launches {pre_launches}; evaluations reported by the device "
          f"{evaluations}")
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
    lane_row, pre_row = phase_batched(card, lane_intrinsics, lane_depths, lane_grays, dev)
    pre_row["launches"] += pre_launches

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

    # phase 9: the SLAM back end
    nine = time.perf_counter()
    phase_pose_graph(dev)
    slam_seq = slam_sequence()
    solve_launches += phase_loop_closure(slam_seq, dev)
    solve_launches += phase_slam(slam_seq, dev)
    print(f"phase 9 (the SLAM back end): {time.perf_counter() - nine:.1f} s")

    # phase 10: the photometric window
    ten = time.perf_counter()
    phase_window_solve(seq, dev)
    solve_launches += phase_refine(seq, slam_seq, dev)
    print(f"phase 10 (the photometric window): {time.perf_counter() - ten:.1f} s")

    # phase 11: the rest of the single-device surface
    eleven = time.perf_counter()
    phase_affine(dev)
    phase_ba(dev)
    solve_launches += phase_examples(dev)
    print(f"phase 11 (affine alignment, window BA, the examples): {time.perf_counter() - eleven:.1f} s")

    # phase 12: the multi-GPU layer
    twelve = time.perf_counter()
    shard_row = phase_multi_gpu(seq, bucketed, pyr1, model, lane_intrinsics, lane_depths, lane_grays, dev)
    print(f"phase 12 (the multi-GPU layer): {time.perf_counter() - twelve:.1f} s")

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
    kernels.append({
        "name": f"maps_kernel + candidates_kernel (keyframe precompute, {PRECOMPUTE_LANES[-1]} lanes)",
        "route": "cuda", "source": "visual_odometry_rs_tpu_torch/csrc/precompute.cu",
        "replaces": "visual_odometry_rs_tpu/models/tracker.py:456", **pre_row, "library_ms": None,
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
    kernels.append({
        "name": "residual_reduce (point-sharded, per rank)", "route": "cuda",
        "source": "visual_odometry_rs_tpu_torch/csrc/residual_reduce.cu", "replaces": replaces, **shard_row,
        "library_ms": None,
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
