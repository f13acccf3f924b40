"""The program's own spans, read over a ``--trace 1`` run's device-traced
periods.

The port records its spans (``evennicer_slam_tpu_torch/utils/telemetry.py``:
``slam.step``, ``slam.track``, ``slam.map``, ``slam.sync.<site>``,
``slam.reader.*``, ...) while a ``torch.profiler`` session records in the
process, so after the window its tracer holds the spans of both profiled
stages, stamped on the clock of the device trace (``time.time_ns()``). A
reader keeps those inside the device-traced periods (``reading["window_ns"]``)
and sets them against the card's busy intervals there
(``reading["device_trace"].busy``). A program without the tracer gives
nothing to read: every function here then returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple


def program_spans() -> Optional[list]:
    """Every span the program's tracer holds, or None where the program has
    no tracer."""
    try:
        from evennicer_slam_tpu_torch.utils.telemetry import TRACER
    except ImportError:
        return None
    return TRACER.spans()


def device_period_spans(r) -> Optional[list]:
    """The program's spans that lie inside the device-traced periods."""
    spans = program_spans()
    if spans is None:
        return None
    lo, hi = r["window_ns"]
    return [s for s in spans if s.start >= lo and s.end <= hi]


class Busy:
    """The card's merged busy intervals, for idle time inside any stretch."""

    def __init__(self, intervals: Sequence[Tuple[int, int]]):
        self.iv = list(intervals)
        self.starts = [s for s, _ in self.iv]

    def busy(self, s: int, e: int) -> int:
        i = max(0, bisect.bisect_right(self.starts, s) - 1)
        n = 0
        while i < len(self.iv) and self.iv[i][0] < e:
            a, b = self.iv[i]
            n += max(0, min(b, e) - max(a, s))
            i += 1
        return n

    def idle(self, s: int, e: int) -> int:
        return (e - s) - self.busy(s, e)


def _busy(r) -> Busy:
    lo, hi = r["window_ns"]
    return Busy(r["device_trace"].busy(lo, hi))


def idle_ms_per_span(r, name: str) -> Optional[float]:
    """Device idle milliseconds inside the spans ``name``, a span."""
    spans = device_period_spans(r)
    if spans is None:
        return None
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    busy = _busy(r)
    return 1e-6 * sum(busy.idle(s.start, s.end) for s in mine) / len(mine)


def host_ms_per(r, prefix: str, per: str) -> Optional[float]:
    """Host milliseconds inside the spans whose name starts with ``prefix``
    (a span inside another such span counted once), over the number of
    spans ``per``."""
    spans = device_period_spans(r)
    if spans is None:
        return None
    n = sum(s.name == per for s in spans)
    if n == 0:
        return None
    names = {s.id: s.name for s in spans}
    total = sum(s.end - s.start for s in spans
                if s.name.startswith(prefix) and not names.get(s.parent, "").startswith(prefix))
    return 1e-6 * total / n


def idle_by_span(r) -> Optional[Dict[str, object]]:
    """The device-traced periods' idle time by the innermost program span of
    the thread that steps the frames, in nanoseconds: {"idle_ns", "by_span":
    {name: ns}, "outside": ns in no span, "below_step": the share in a span
    below ``slam.step``}."""
    spans = device_period_spans(r)
    if spans is None:
        return None
    steps = [s for s in spans if s.name == "slam.step"]
    if not steps:
        return None
    main = steps[0].thread
    mine = [s for s in spans if s.thread == main]
    busy = _busy(r)
    lo, hi = r["window_ns"]
    inside = {s.id: busy.idle(s.start, s.end) for s in mine}
    children: Dict[int, int] = defaultdict(int)
    for s in mine:
        children[s.parent] += inside[s.id]
    by_span: Dict[str, int] = defaultdict(int)
    for s in mine:
        by_span[s.name] += inside[s.id] - children[s.id]
    total = busy.idle(lo, hi)
    outside = total - sum(inside[s.id] for s in mine if s.parent == -1)
    below = total - outside - by_span.get("slam.step", 0)
    return {"idle_ns": total, "outside": outside,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "below_step": below / total if total else None}
