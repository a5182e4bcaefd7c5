"""Per-frame metrics and their session summary.

The port of ``visual_odometry_rs_tpu/utils/metrics.py``.  The reference
prints the optical flow and the keyframe switches to stderr
(inverse_compositional.rs:222,229) and the trajectory to stdout; here a
frame is a structured record, the CLIs print each one as a JSON line to
stderr (``--metrics``) and a summary at the end.

``Timer`` is a host clock.  ``Tracker.track`` ends in its one device→host
read, so a timer around it times the frame on the card; in the clip mode of
``vors_track --chunk`` the clip's one read ends the timed window, and each
frame of the clip gets its share.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import asdict, dataclass, field
from typing import List


@dataclass
class FrameMetrics:
    """One tracked frame's diagnostics."""

    frame_index: int
    timestamp: float
    optical_flow: float
    keyframe_switched: bool
    failed: bool
    track_seconds: float

    def to_json(self) -> str:
        return json.dumps(asdict(self))


@dataclass
class SessionMetrics:
    """The frames of a tracking session and their summary."""

    frames: List[FrameMetrics] = field(default_factory=list)

    def record(self, m: FrameMetrics) -> None:
        self.frames.append(m)

    @property
    def nb_frames(self) -> int:
        return len(self.frames)

    @property
    def nb_keyframe_switches(self) -> int:
        return sum(1 for f in self.frames if f.keyframe_switched)

    @property
    def nb_failures(self) -> int:
        return sum(1 for f in self.frames if f.failed)

    @property
    def mean_fps(self) -> float:
        total = sum(f.track_seconds for f in self.frames)
        return len(self.frames) / total if total > 0 else 0.0

    def summary(self) -> dict:
        return {
            "frames": self.nb_frames,
            "keyframe_switches": self.nb_keyframe_switches,
            "failures": self.nb_failures,
            "mean_fps": round(self.mean_fps, 2),
            "mean_flow": round(sum(f.optical_flow for f in self.frames) / max(1, self.nb_frames), 4),
        }

    def print_summary(self, file=None) -> None:
        # the stream is looked up at call time: test harnesses replace sys.stderr
        print(json.dumps(self.summary()), file=file or sys.stderr)


class Timer:
    """Host wall clock around a block: ``seconds`` after it ends."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False
