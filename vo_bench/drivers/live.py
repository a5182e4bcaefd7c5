"""Open-loop live stream: one camera's frames handed to ``Tracker.track`` as
they fall due, as ``cli/vors_track.py`` hands over decoded frames.

Frame ``f`` of the window is due at ``t0 + f / rate``; it is handed over
as host arrays when it is due, or at once if the tracker is late.  Its
latency runs from its due time to its pose being on the host (``track``
ends in its device read).  The sequence is the traffic's closed loop,
repeated; the tracker is initialised on frame 0 and warmed up on the next
frames, unpaced, before the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
import judge
import program
import render
from visual_odometry_rs_tpu_torch.models import tracker as tracker_mod


def _pose7(p) -> np.ndarray:
    return np.concatenate([p.q.numpy(), p.t.numpy()]).astype(np.float32)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.rate = float(self.traffic["rate_hz"])
        self.loop = int(self.traffic["loop_frames"])
        self.steps = []  # (loop frame, pose, flow, switched, failed)

    # -- set-up ------------------------------------------------------------

    def prepare(self):
        ctx = self.ctx
        self.seqs = render.make_sequences(self.cfg, self.traffic, ctx.seed, ctx.device)
        if ctx.device.type == "cuda":  # the peak is the program's, not the renderer's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(ctx.device)
        self.config = program.tracker_config(self.cfg)
        g, d = self.seqs.grays[0, 0], self.seqs.depths[0, 0]
        self.trk = tracker_mod.init_tracker(self.config, program.intrinsics(self.cfg, "cpu"), 0.0, d, 0.0, g,
                                            device=ctx.device)
        self.step = 0
        for _ in range(int(self.traffic["warmup_frames"])):  # a second of the loop: several switches
            self._track()
        self._sync()

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _track(self):
        """Track the next frame of the loop; returns (switched, failed)."""
        trk = self.trk
        self.step += 1
        frame = self.step % self.loop
        switches = trk.keyframe_switches
        trk.track(self.step / self.rate, self.seqs.depths[frame, 0], self.step / self.rate,
                  self.seqs.grays[frame, 0])
        switched = trk.keyframe_switches != switches
        self.steps.append((frame, trk.current_pose, trk.last_flow, switched, trk.last_failed))
        return switched, trk.last_failed

    # -- the window --------------------------------------------------------

    def run(self, seconds: float, trace: bool) -> dict:
        n = int(round(seconds * self.rate))
        traced = min(int(self.traffic["trace_frames"]), n) if trace else 0
        self.first_window_step = self.step + 1
        frames, launches = [], []
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter() + 0.02
        trace_record = None
        for f in range(n):
            due = t0 + f / self.rate
            wait = due - time.perf_counter()
            if wait > 0.002:
                time.sleep(wait - 0.001)
            while time.perf_counter() < due:
                pass
            if f < traced:
                levels = [(obs.xs.shape[0], *obs.template.shape) for obs in self.trk.keyframe_data.levels]
                start = time.perf_counter()
                with record_function("vo_bench.frame"):
                    switched, failed = self._track()
                end = time.perf_counter()
                launches.extend(
                    {"n": nn, "height": h, "width": w, "lanes": 1, "evaluations": e}
                    for (nn, h, w), e in zip(levels, self.trk.last_nb_evals))
            else:
                start = time.perf_counter()
                switched, failed = self._track()
                end = time.perf_counter()
            frames.append({"due": due, "start": start, "end": end, "switched": switched, "failed": failed,
                           "traced": f < traced})
            if f + 1 == traced:
                self._sync()
                prof.__exit__(None, None, None)
                trace_record = harness.reduce_profile(prof)
                prof = None
        self._sync()
        spans = harness.spans_named(trace_record, "vo_bench.frame") if trace_record else []
        return {"kind": "live", "seconds": seconds, "frames": frames, "trace": trace_record,
                "trace_spans": spans, "solver_launches": launches,
                "trace_window": (spans[0][0], spans[-1][1]) if spans else None,
                "device_name": self.ctx.device_name}

    # -- results -----------------------------------------------------------

    @staticmethod
    def end_to_end(record: dict) -> dict:
        # a failed frame never got its pose: it counts as late as the whole window
        missing = 1e3 * record["seconds"]
        lat = [1e3 * (fr["end"] - fr["due"]) if not fr["failed"] else missing for fr in record["frames"]]
        return {"frame_ms_p50": harness.percentile(lat, 50), "frame_ms_p95": harness.percentile(lat, 95)}

    @staticmethod
    def counts(record: dict):
        frames = record["frames"]
        return len(frames), sum(fr["failed"] for fr in frames)

    def samples(self, count: int, seed: int, starts: int):
        steps = [judge.Step(0, frame, _pose7(pose), float(flow), bool(sw), bool(fl), step >= self.first_window_step)
                 for step, (frame, pose, flow, sw, fl) in enumerate(self.steps, start=1)]
        return judge.chain_samples(steps, count, starts, seed)

    def free(self):
        self.trk = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
