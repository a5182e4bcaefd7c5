"""The program's own spans (``visual_odometry_rs_tpu_torch.utils.profiling``),
grouped by the benchmark's traced spans (``vo_bench.frame`` a live frame,
``vo_bench.clip`` a batch clip), for the metrics that read them.

Both sets of spans are on the profiler's clock: a program span belongs to
the traced span that holds its middle.  A program that records no spans
gives no groups, and its metrics read nothing.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional


def recorded() -> list:
    """The spans the program recorded, or none where it has no recorder."""
    try:
        from visual_odometry_rs_tpu_torch.utils import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else []


def groups(record: dict) -> List[list]:
    """The program's spans inside each of the record's traced spans, in order;
    empty without a trace or without program spans in any traced span."""
    within = record.get("trace_spans") or []
    if record.get("trace") is None or not within:
        return []
    starts = [s for s, _ in within]
    out = [[] for _ in within]
    for sp in recorded():
        mid = 0.5e-9 * (sp.start_ns + sp.end_ns)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= within[i][1]:
            out[i].append(sp)
    return out if any(out) else []


def ms(spans, name: Optional[str] = None, prefix: Optional[str] = None) -> float:
    """Summed milliseconds of the spans named ``name``, or whose name starts with ``prefix``."""
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name == name or (prefix is not None and s.name.startswith(prefix)))


def frames(record: dict, switched: int) -> List[list]:
    """The program spans of each traced live frame whose ``vors.track`` span
    has the count ``switched``."""
    out = []
    for group in groups(record):
        track = [s for s in group if s.name == "vors.track"]
        if len(track) == 1 and track[0].counts.get("switched") == switched:
            out.append(group)
    return out


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None
