"""The comparison that decides ``correct``.

After the window closes, a sample of the frames the program tracked in it,
drawn from the seed, is tracked again by the plain reference
(``reference/tracker.py``) from the same rendered images and depths.  The
reference follows the program step by step from the program's outputs:
each sampled frame starts from the pose the program gave the frame before
it, and from the keyframe the program's switch decisions made (the frame
it switched on and the pose it gave that frame); the reference works out
the keyframe's candidates and the frame's solve again.

The tracker's result is not a smooth function of rounding: a candidate on
the sampling domain's border and the LM's accept and stop tests are
thresholds, so in a few frames in a hundred a rounding-sized difference
makes one side take an LM step the other does not, and the two poses part
by a whole step (up to millimetres).  So the gaps are compared as
quantiles over the sample, which a fault that moves most frames still
moves, and not as a widest gap.  Five numbers, each with its limit from
``limits/<cell>.json``:

- ``pose_t_gap_m.median`` and ``pose_t_gap_m.q75``: the median and the
  third quartile of the gap between the program's camera position and the
  reference's, in metres;
- ``pose_r_gap_rad.median``: the median angle between the orientations;
- ``start_t_gap_m``: the median position gap of a sample of the frames
  tracked against a lane's initial keyframe, whose pose is the identity
  and not one of the program's outputs: the start of the chain, which
  anchors it (a pose moved by the same offset everywhere keeps every later
  step consistent and shows only here);
- ``decision_flips``: frames whose keyframe switch or failure the program
  decided otherwise than the reference, where the reference's flow lies
  farther than ``flow_band_px`` from the threshold.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from reference import tracker as ref

NUMBERS = ("pose_t_gap_m.median", "pose_t_gap_m.q75", "pose_r_gap_rad.median", "start_t_gap_m",
           "decision_flips")


class Sample(NamedTuple):
    """One tracked frame of the program and the state it started from."""

    lane: int
    frame: int  # index in the lane's loop of the frame tracked
    kf_frame: int  # index in the lane's loop of its keyframe
    kf_pose: np.ndarray  # (7,) q wxyz, t: the keyframe's camera-to-world pose
    prev_pose: np.ndarray  # (7,) the pose before the frame
    pose: np.ndarray  # (7,) the program's pose after it
    flow: float
    switched: bool
    failed: bool
    start: bool  # tracked against the lane's initial keyframe (a start sample)


class Step(NamedTuple):
    """One lane-frame the program tracked, as its outputs give it."""

    lane: int
    frame: int  # index in the lane's loop
    pose: np.ndarray  # (7,) q wxyz, t
    flow: float
    switched: bool
    failed: bool
    in_window: bool


IDENTITY = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)


def chain_samples(steps: List[Step], count: int, starts: int, seed: int) -> List[Sample]:
    """From the program's steps in the order it tracked them: ``starts`` of
    the lane-frames tracked against their lane's initial keyframe (frame 0,
    at the identity) and ``count`` of the window's lane-frames, drawn from
    the seed, each with the state that the program's outputs give it: the
    lane's pose before it, and the frame and pose of its last switch."""
    keyframe, prev, first, window = {}, {}, [], []
    for st in steps:
        kf_frame, kf_pose = keyframe.get(st.lane, (0, IDENTITY))
        sample = Sample(st.lane, st.frame, kf_frame, kf_pose, prev.get(st.lane, IDENTITY), st.pose, st.flow,
                        st.switched, st.failed, st.lane not in keyframe)
        if sample.start:
            first.append(sample)
        if st.in_window:
            window.append(sample._replace(start=False))
        if st.switched:
            keyframe[st.lane] = (st.frame, st.pose)
        prev[st.lane] = st.pose
    return draw(first, starts, seed + 1) + draw(window, count, seed)


def draw(candidates: List[Sample], count: int, seed: int) -> List[Sample]:
    """A sample drawn from the seed, in the order the frames were tracked."""
    if len(candidates) <= count:
        return list(candidates)
    rng = np.random.default_rng([seed, 7])
    keep = np.sort(rng.choice(len(candidates), size=count, replace=False))
    return [candidates[i] for i in keep]


def _pose(p: np.ndarray):
    t = torch.as_tensor(np.asarray(p, np.float32))
    return t[:4], t[4:7]


def _angle(q1: np.ndarray, q2: np.ndarray) -> float:
    q1 = np.asarray(q1, np.float64) / np.linalg.norm(q1)
    q2 = np.asarray(q2, np.float64) / np.linalg.norm(q2)
    w = q1[0] * q2[0] + q1[1:] @ q2[1:]
    v = q1[0] * q2[1:] - q2[0] * q1[1:] - np.cross(q1[1:], q2[1:])
    return 2.0 * math.atan2(float(np.linalg.norm(v)), abs(float(w)))


class Reading(NamedTuple):
    pose: np.ndarray
    flow: float
    switched: bool
    failed: bool


def reference_readings(settings: ref.Settings, k, seqs, samples: List[Sample], device,
                       eval_dtype=ref.F32) -> List[Reading]:
    """The reference's pose, flow and decisions on every sample."""
    out = []
    cache_key, kf = None, None
    for s in samples:
        if (s.lane, s.kf_frame) != cache_key:
            depth = torch.from_numpy(seqs.depths[s.kf_frame, s.lane].astype(np.int32)).to(device)
            img = torch.from_numpy(seqs.grays[s.kf_frame, s.lane]).to(device)
            kf, cache_key = ref.keyframe(settings, k, depth, img), (s.lane, s.kf_frame)
        kf_pose, prev = _pose(s.kf_pose), _pose(s.prev_pose)
        res = ref.track(settings, kf, torch.from_numpy(seqs.grays[s.frame, s.lane]).to(device),
                        ref.warm_start(kf_pose, prev), eval_dtype)
        q, t = ref.frame_pose(kf_pose, prev, res)
        out.append(Reading(torch.cat([q, t]).numpy().astype(np.float64), res.flow,
                           res.flow >= settings.flow_threshold, res.failed))
    return out


def gaps(samples: List[Sample], readings: List[Reading]):
    """Per sample: (position gap m, angle rad, flow gap px)."""
    out = []
    for s, r in zip(samples, readings):
        prog = np.asarray(s.pose, np.float64)
        flow = 0.0 if math.isnan(s.flow) and math.isnan(r.flow) else abs(s.flow - r.flow)
        out.append((float(np.linalg.norm(prog[4:7] - r.pose[4:7])), _angle(prog[:4], r.pose[:4]), flow))
    return out


def compare(settings: ref.Settings, samples: List[Sample], readings: List[Reading], flow_band: float):
    """The numbers of the program's samples against the reference's readings."""
    g = np.asarray(gaps(samples, readings)).reshape(-1, 3)
    flips = 0
    for s, r in zip(samples, readings):
        near = math.isfinite(r.flow) and abs(r.flow - settings.flow_threshold) <= flow_band
        if (s.switched != r.switched and not near) or s.failed != r.failed:
            flips += 1
    t_gap = np.nan_to_num(g[:, 0], nan=np.inf)
    starts = [t for t, s in zip(t_gap, samples) if s.start]
    return {"pose_t_gap_m.median": float(np.quantile(t_gap, 0.5)),
            "pose_t_gap_m.q75": float(np.quantile(t_gap, 0.75)),
            "pose_r_gap_rad.median": float(np.quantile(np.nan_to_num(g[:, 1], nan=np.inf), 0.5)),
            "start_t_gap_m": float(np.quantile(starts, 0.5)) if starts else math.inf,
            "decision_flips": float(flips)}


def as_samples(samples: List[Sample], readings: List[Reading]) -> List[Sample]:
    """The readings in the program's place (the control)."""
    return [s._replace(pose=r.pose, flow=r.flow, switched=r.switched, failed=r.failed)
            for s, r in zip(samples, readings)]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
