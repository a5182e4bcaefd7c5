"""Closed-loop batch: many recorded sequences tracked together through
``parallel.batch.batched_track_sequence``, in clips handed over as host
numpy stacks (frames, lanes, H, W), as ``cli/vors_batch.py`` hands over
decoded frames, with the pending mask, the frame index and the warm start
carried from clip to clip.

Each lane repeats its closed loop; the state is initialised on frame 0 and
warmed up on the next clips before the window.  The window runs clips back
to back until its seconds are up, and ends when the last clip's poses are
on the host.  A clip is a view of the host arrays (the loop is a multiple
of the clip), so the benchmark copies nothing a clip.  The first clip
tracks frame 0 again, in the warm-up.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
import judge
import program
import render
from visual_odometry_rs_tpu_torch.parallel import batch as batch_mod


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.loop = int(self.traffic["loop_frames"])
        self.chunk = int(self.cfg["chunk"])
        if self.loop % self.chunk:
            raise ValueError(f"loop_frames {self.loop} is not a multiple of the clip {self.chunk}")
        self.clips = []  # per clip: (first step, q (F, B, 4), t (F, B, 3), diagnostics)

    def prepare(self):
        ctx = self.ctx
        seqs = render.make_sequences(self.cfg, self.traffic, ctx.seed, ctx.device)
        if ctx.device.type == "cuda":  # the peak is the program's, not the renderer's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(ctx.device)
        # frame 0 initialises, and clip k tracks loop frames chunk k onwards
        self.seqs = seqs
        self.grays, self.depths = seqs.grays, seqs.depths
        self.config = program.tracker_config(self.cfg)
        self.intrinsics = program.intrinsics(self.cfg, "cpu")
        self.state = batch_mod.batched_init_state(self.config, self.intrinsics, seqs.depths[0], seqs.grays[0],
                                                  device=ctx.device)
        self.pending = torch.zeros(int(self.cfg["lanes"]), dtype=torch.bool, device=ctx.device)
        self.prev = self.state.current_pose
        self.tracked = 0  # frames tracked a lane
        for _ in range(int(self.traffic["warmup_clips"])):
            self._clip()
        self._sync()

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _clip(self):
        """Track the next clip; returns its host diagnostics."""
        s = self.tracked % self.loop
        clip_d, clip_g = self.depths[s:s + self.chunk], self.grays[s:s + self.chunk]
        self.state, (poses, diags), self.pending, self.prev = batch_mod.batched_track_sequence(
            self.config, self.intrinsics, self.state, clip_d, clip_g,
            switch_cadence=int(self.cfg["switch_cadence"]), pending0=self.pending, frame_offset=self.tracked,
            return_pending=True, prev_pose0=self.prev, return_prev=True,
        )
        q, t, host = batch_mod.outputs_to_numpy(poses, diags)  # the clip's one read
        self.clips.append((self.tracked, q, t, host))
        self.tracked += self.chunk
        return host

    def run(self, seconds: float, trace: bool) -> dict:
        traced = int(self.traffic["trace_clips"]) if trace else 0
        self.first_window_clip = len(self.clips)
        lanes = int(self.cfg["lanes"])
        levels = list(zip(self.config.level_caps(), self.config.level_shapes()))
        clips, launches = [], []
        trace_record = prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end or len(clips) < traced:
            c0 = time.perf_counter()
            if len(clips) < traced:
                with record_function("vo_bench.clip"):
                    host = self._clip()
                for f in range(self.chunk):
                    evals = host.nb_iters[f] + 1 - host.failed[f][:, None]  # (B, levels)
                    launches.extend({"n": n, "height": h, "width": w, "lanes": lanes,
                                     "evaluations": int(evals[:, lvl].sum())}
                                    for lvl, (n, (h, w)) in enumerate(levels))
            else:
                host = self._clip()
            clips.append({"start": c0, "end": time.perf_counter(), "lane_frames": host.failed.size,
                          "failed": int(host.failed.sum()), "switched": int(host.switched.sum()),
                          "steps_switching": int(host.switched.any(axis=1).sum()), "traced": len(clips) < traced})
            if len(clips) == traced:
                self._sync()
                prof.__exit__(None, None, None)
                trace_record = harness.reduce_profile(prof)
        seconds = time.perf_counter() - start
        spans = harness.spans_named(trace_record, "vo_bench.clip") if trace_record else []
        return {"kind": "offline_batch", "seconds": seconds, "clips": clips, "trace": trace_record,
                "trace_spans": spans, "solver_launches": launches,
                "trace_window": (spans[0][0], spans[-1][1]) if spans else None,
                "traced_lane_frames": traced * self.chunk * lanes, "device_name": self.ctx.device_name}

    @staticmethod
    def end_to_end(record: dict) -> dict:
        done = sum(c["lane_frames"] - c["failed"] for c in record["clips"])
        return {"frames_per_s": done / record["seconds"]}

    @staticmethod
    def counts(record: dict):
        return sum(c["lane_frames"] for c in record["clips"]), sum(c["failed"] for c in record["clips"])

    def samples(self, count: int, seed: int, starts: int):
        steps = []
        for ci, (first, q, t, host) in enumerate(self.clips):
            for f in range(q.shape[0]):
                steps.extend(
                    judge.Step(b, (first + f) % self.loop, np.concatenate([q[f, b], t[f, b]]).astype(np.float32),
                               float(host.flow[f, b]), bool(host.switched[f, b]), bool(host.failed[f, b]),
                               ci >= self.first_window_clip)
                    for b in range(q.shape[1]))
        return judge.chain_samples(steps, count, starts, seed)

    def free(self):
        self.state = self.pending = self.prev = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
