"""Reading a ``torch.profiler`` trace of the card: device intervals, the
runtime calls that launched them, and the harness's own annotations.

Every device activity (kernel, copy, set) carries the correlation id of the
runtime call that launched it; a span is the work its thread launched
between the span's start and end. Busy time is the UNION of device
intervals: the reader's uploads run on a stream of their own and overlap
the main stream's kernels.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LAUNCHES = frozenset({"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernelEx", "cudaGraphLaunch"})
PREFIX = "pb."

Interval = Tuple[int, int]


def union_length(intervals: Iterable[Interval]) -> int:
    """Length of the union of half-open intervals."""
    total = 0
    end = None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if end is not None:
        total += end - start
    return total


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """The events of one profiled stretch, indexed for span queries.

    ``device``: [(start, end, corr, name)] of the card's activities;
    ``calls``: per host thread, runtime calls sorted by start as
    (start, corr, is_launch); ``marks``: the harness's annotations as
    (name, start, end, thread); ``cpu``: host events of ``main_thread`` as
    (start, end, name), for the idle-gap breakdown."""

    def __init__(self, device, calls, marks, cpu, main_thread, autograd_threads):
        self.device = device
        self.by_corr: Dict[int, List[Interval]] = defaultdict(list)
        for s, e, c, _ in device:
            self.by_corr[c].append((s, e))
        self.calls = {t: sorted(v) for t, v in calls.items()}
        self._call_starts = {t: [c[0] for c in v] for t, v in self.calls.items()}
        self.marks = sorted(marks, key=lambda m: m[1])
        self.cpu = sorted(cpu)
        self.main_thread = main_thread
        self.autograd_threads = set(autograd_threads)

    @classmethod
    def from_events(cls, events, main_thread: int) -> "Trace":
        """From ``prof.profiler.kineto_results.events()`` (``KinetoEvent``:
        ``device_resource_id`` is the host thread id of a host event and
        the stream of a device one)."""
        from torch.autograd import DeviceType

        device, marks, cpu = [], [], []
        calls: Dict[int, list] = defaultdict(list)
        autograd = set()
        for ev in events:
            name = ev.name()
            start = ev.start_ns()
            end = start + ev.duration_ns()
            ua = ev.is_user_annotation()
            if ev.device_type() == DeviceType.CUDA:
                if not ua:
                    device.append((start, end, ev.correlation_id(), name))
                continue
            tid = ev.device_resource_id()
            if ua:
                if name.startswith(PREFIX):
                    marks.append((name, start, end, tid))
            elif name.startswith("cu"):
                calls[tid].append((start, ev.correlation_id(), name in LAUNCHES))
            elif name.startswith("autograd::engine::evaluate_function"):
                autograd.add(tid)
            cpu.append((start, end, name, tid))
        # the thread that made the harness's forward spans is the main one
        owners = [t for n, _, _, t in marks if n in ("pb.track", "pb.frame_wait")]
        if owners:
            main_thread = owners[0]
        cpu = [(s, e, n) for s, e, n, t in cpu if t == main_thread]
        return cls(device, calls, marks, cpu, main_thread, autograd)

    # -- spans -----------------------------------------------------------

    def spans(self, name: str) -> List[Tuple[int, int, int]]:
        """(start, end, thread) of every annotation ``name``."""
        return [(s, e, t) for n, s, e, t in self.marks if n == name]

    def brackets(self, name: str) -> List[Tuple[int, int, int]]:
        """Backward stretches: from each ``<name>.begin`` mark to the next
        ``<name>.end`` mark on the same thread."""
        out = []
        open_at: Dict[int, int] = {}
        for n, s, e, t in self.marks:
            if n == name + ".begin":
                open_at[t] = s
            elif n == name + ".end" and t in open_at:
                out.append((open_at.pop(t), e, t))
        return out

    def program_threads(self) -> List[int]:
        return [self.main_thread] + sorted(self.autograd_threads - {self.main_thread})

    def launched(self, span: Tuple[int, int], threads: Sequence[int]):
        """(kernel launch calls, device intervals) of the runtime calls the
        ``threads`` made inside ``span``."""
        s, e = span
        n_launch = 0
        intervals: List[Interval] = []
        for t in threads:
            starts = self._call_starts.get(t)
            if not starts:
                continue
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
            for _, corr, is_launch in self.calls[t][lo:hi]:
                n_launch += is_launch
                intervals.extend(self.by_corr.get(corr, ()))
        return n_launch, intervals

    def span_device(self, spans, threads: Optional[Sequence[int]] = None):
        """(launches, device seconds) summed over ``spans``; device time of a
        span is the union of what it launched. ``threads`` default: the
        span's own thread."""
        launches, ns = 0, 0
        for s, e, t in spans:
            n, iv = self.launched((s, e), threads or [t])
            launches += n
            ns += union_length(iv)
        return launches, ns * 1e-9

    # -- the whole stretch -------------------------------------------------

    def busy(self, lo: int, hi: int) -> List[Interval]:
        """The merged device intervals inside [lo, hi]."""
        return merged(clip(((s, e) for s, e, _, _ in self.device), lo, hi))

    def device_ops(self, lo: int, hi: int, top: int = 10):
        """The device operations that took most time, [[name, seconds]]."""
        acc: Dict[str, int] = defaultdict(int)
        for s, e, _, name in self.device:
            if e > lo and s < hi:
                acc[name] += min(e, hi) - max(s, lo)
        rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], v * 1e-9] for n, v in rows]

    def idle_gaps(self, lo: int, hi: int, top: int = 10, scan: int = 4000):
        """The longest idle stretches of the device, summed by the innermost
        host event of the main thread at each gap's midpoint,
        [[name, seconds]]."""
        busy = self.busy(lo, hi)
        gaps = []
        prev = lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        starts = [c[0] for c in self.cpu]
        acc: Dict[str, int] = defaultdict(int)
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(-1, i - 1 - scan), -1):
                cs, ce, name = self.cpu[j]
                if ce >= mid and (best is None or ce - cs < best[0]):
                    best = (ce - cs, name)
            acc[best[1] if best else "host: no event"] += e - s
        rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], v * 1e-9] for n, v in rows]
