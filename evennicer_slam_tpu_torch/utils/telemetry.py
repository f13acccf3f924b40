"""Observability: structured metrics, the program's spans, profiler traces
(counterpart of ``evennicer_slam_tpu/utils/telemetry.py``).

Metrics go to a JSONL stream, one record per frame or event, that any
dashboard can tail.
:func:`torch_trace` wraps a phase in a ``torch.profiler`` trace.

:data:`TRACER` is the process's one :class:`Tracer` (also
``EvenNICERSLAM.tracer``). The program opens a named span at each layer
boundary (``slam.step``, ``slam.track``, ``slam.map``, ``slam.decode.*``,
``slam.eventnet``, ``slam.reader.*``) and around each place where the host
waits for the device (``slam.sync.<site>``). Off, a span is one shared null
context: nothing is recorded, allocated or launched. On (``enable()``, or
while a ``torch.profiler`` session records in this process), each span's
name, start, end, parent, thread and frame index go to a fixed-capacity
buffer in host memory, and a total and a count per name are kept. The
timestamps are ``time.time_ns()``, the clock that ``torch.profiler``'s
events carry, so the spans line up with a device trace of the same run;
while a profiler records, each span is also a ``record_function``
annotation in its trace. :meth:`Tracer.export_chrome` writes the spans as a
Chrome trace (Perfetto, ``chrome://tracing``); :func:`merge_chrome` puts
them into a ``torch.profiler`` trace of the same run::

    python -m evennicer_slam_tpu_torch.utils.telemetry merge spans.json trace.json out.json
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler


class MetricsLogger:
    """Appends one JSON object a record to ``<out_dir>/metrics.jsonl``, with
    the wall time under ``t``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def log(self, record: Dict[str, Any]):
        record = dict(record, t=time.time())
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        self._f.close()


class Span(NamedTuple):
    """One closed span. ``start`` / ``end``: ``time.time_ns()``; ``parent``
    and ``frame``: -1 for none; ``thread``: the native thread id."""

    name: str
    start: int
    end: int
    id: int
    parent: int
    thread: int
    frame: int


# spans the buffer holds; later ones count in ``Tracer.dropped`` (and in the totals)
CAPACITY = 1 << 20
_RECORD = np.dtype([("name", np.int32), ("start", np.int64), ("end", np.int64),
                    ("id", np.int64), ("parent", np.int64), ("thread", np.int64),
                    ("frame", np.int64)])


class _Null:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _Null()


class _Open:
    """A span being recorded."""

    __slots__ = ("tracer", "name", "frame", "id", "parent", "stack", "start", "note")

    def __init__(self, tracer: "Tracer", name: str, frame: Optional[int], detached: bool):
        self.tracer, self.name = tracer, name
        self.frame = tracer.frame if frame is None else frame
        self.stack = stack = tracer._stack()
        main = tracer._main
        if stack:
            self.parent = stack[-1]
        elif detached or main is None:
            self.parent = -1
        else:
            # the first span of a helper thread (autograd's) hangs under the
            # span the frame's thread is in
            try:
                self.parent = main[-1]
            except IndexError:  # that thread is between spans
                self.parent = -1
        self.id = next(tracer._ids)
        self.note = None

    def __enter__(self):
        self.stack.append(self.id)
        if _profiler._is_profiler_enabled:
            self.note = torch.profiler.record_function(self.name)
            self.note.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.note is not None:
            self.note.__exit__(None, None, None)
        stack = self.stack
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:
            stack.remove(self.id)
        self.tracer._record(self.name, self.start, end, self.id, self.parent, stack.tid,
                            self.frame)
        return False


class _Stack(list):
    """A thread's open spans, and its native id (read once: a system call)."""

    def __init__(self):
        super().__init__()
        self.tid = threading.get_native_id()


class _Bracket:
    """The span of a backward: opened by the mark on a call's outputs, whose
    backward runs first, closed by the mark on its inputs, whose backward
    runs last."""

    __slots__ = ("tracer", "name", "frame", "span")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.frame, self.span = tracer, name, tracer.frame, None

    def open(self):
        if self.span is None:
            self.span = _Open(self.tracer, self.name, self.frame, False).__enter__()

    def close(self):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class _Mark(torch.autograd.Function):
    """Identity (views, no launch) whose backward opens or closes a bracket."""

    @staticmethod
    def forward(ctx, bracket, opens, *xs):
        ctx.bracket, ctx.opens = bracket, opens
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        (ctx.bracket.open if ctx.opens else ctx.bracket.close)()
        return (None, None) + grads


def _through_mark(bracket: _Bracket, opens: bool, tensors) -> tuple:
    idx = [i for i, t in enumerate(tensors) if isinstance(t, torch.Tensor) and t.requires_grad]
    out = list(tensors)
    if idx:
        for i, t in zip(idx, _Mark.apply(bracket, opens, *[tensors[i] for i in idx])):
            out[i] = t
    return tuple(out)


def _identity(*xs):
    return xs


class Tracer:
    """Named spans and counters of the program (see the module's
    docstring): on after :meth:`enable`, and while a ``torch.profiler``
    session records."""

    def __init__(self):
        self.enabled = False
        self.frame = -1                  # the index of the frame being stepped
        self.total: Dict[str, float] = defaultdict(float)   # seconds a span name
        self.count: Dict[str, int] = defaultdict(int)       # spans a name; counters
        self.dropped = 0                 # spans past the buffer's capacity
        self._local = threading.local()
        self._main: Optional[_Stack] = None   # the stack of the thread that steps frames
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._n = 0
        self._buf: Optional[np.ndarray] = None
        self._names: List[str] = []
        self._name_ids: Dict[str, int] = {}

    # -- switching ----------------------------------------------------------

    @property
    def on(self) -> bool:
        return self.enabled or _profiler._is_profiler_enabled

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    # -- recording ------------------------------------------------------------

    def span(self, name: str, frame: Optional[int] = None, detached: bool = False):
        """A context that records ``name`` when the tracer is on. ``frame``
        (default: the frame being stepped) and ``detached`` (no parent
        across threads: work beside the frames, such as the reader's
        decode ahead) are for helper threads."""
        # ``on`` written out: the one test on the path of every span when off
        if self.enabled or _profiler._is_profiler_enabled:
            return _Open(self, name, frame, detached)
        return NULL_SPAN

    def step(self, idx: int):
        """The root span ``slam.step`` of frame ``idx``; spans opened until
        the next step carry ``idx``."""
        self.frame = idx
        if self.on:
            self._main = self._stack()
            return _Open(self, "slam.step", idx, True)
        return NULL_SPAN

    def add(self, name: str, n: int = 1):
        """Count ``n`` under ``name`` when the tracer is on."""
        if self.on:
            self.count[name] += n

    def backward_bracket(self, name: str, *inputs):
        """(inputs, finish): a span ``name`` around the backward of the work
        between. The inputs come back through a mark whose backward closes
        the span, and ``finish(*outputs)`` passes the outputs through one
        whose backward opens it. Off, or where no input carries a
        gradient: the inputs themselves and an identity."""
        if not self.on or not any(isinstance(t, torch.Tensor) and t.requires_grad
                                  for t in inputs):
            return inputs, _identity
        bracket = _Bracket(self, name)
        return (_through_mark(bracket, False, inputs),
                lambda *outputs: _through_mark(bracket, True, outputs))

    def _stack(self) -> "_Stack":
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = _Stack()
        return stack

    def _name_id(self, name: str) -> int:
        i = self._name_ids.get(name)
        if i is None:
            with self._lock:
                i = self._name_ids.setdefault(name, len(self._names))
                if i == len(self._names):
                    self._names.append(name)
        return i

    def _record(self, name, start, end, sid, parent, thread, frame):
        self.total[name] += (end - start) * 1e-9
        self.count[name] += 1
        nid = self._name_id(name)
        with self._lock:
            if self._n >= CAPACITY:
                self.dropped += 1
                return
            if self._buf is None:
                self._buf = np.empty(CAPACITY, _RECORD)
            self._buf[self._n] = (nid, start, end, sid, parent, thread, frame)
            self._n += 1

    # -- reading --------------------------------------------------------------

    def spans(self) -> List[Span]:
        """The spans recorded so far, in the order they closed."""
        with self._lock:
            rows = [] if self._buf is None else self._buf[:self._n].tolist()
        names = self._names
        return [Span(names[r[0]], *r[1:]) for r in rows]

    def drain(self) -> List[Span]:
        """The spans recorded so far; the buffer is emptied (the totals and
        counts stay)."""
        out = self.spans()
        with self._lock:
            self._n = 0
        self.dropped = 0
        return out

    def reset(self):
        """Empty the buffer and clear the totals and counts."""
        self.drain()
        self.total.clear()
        self.count.clear()

    def summary(self) -> Dict[str, float]:
        """Seconds and mean milliseconds a span name, ``slam.`` left out of
        the keys: ``track_total_s``, ``track_mean_ms``, ..."""
        out = {}
        for k, v in self.total.items():
            key = k[len("slam."):] if k.startswith("slam.") else k
            out[f"{key}_total_s"] = round(v, 3)
            if self.count[k]:
                out[f"{key}_mean_ms"] = round(1000 * v / self.count[k], 2)
        return out

    def export_chrome(self, path: str) -> str:
        """Write the spans recorded so far as a Chrome trace: one complete
        event a span, in microseconds from ``baseTimeNanoseconds``, as
        ``torch.profiler`` writes its own."""
        spans = self.spans()
        base = min((s.start for s in spans), default=0)
        pid = os.getpid()
        events = [{"ph": "X", "cat": "slam", "name": s.name, "pid": pid, "tid": s.thread,
                   "ts": (s.start - base) / 1e3, "dur": (s.end - s.start) / 1e3,
                   "args": {"id": s.id, "parent": s.parent, "frame": s.frame}}
                  for s in spans]
        counters = {k: v for k, v in self.count.items() if k not in self.total}
        doc = {"schemaVersion": 1, "displayTimeUnit": "ms", "baseTimeNanoseconds": base,
               "traceEvents": events, "counters": counters, "dropped": self.dropped}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def merge_chrome(spans_path: str, profiler_path: str, out_path: str) -> str:
    """A ``torch.profiler`` Chrome trace with the spans of
    :meth:`Tracer.export_chrome` added, shifted onto its time base."""
    with open(spans_path) as f:
        spans = json.load(f)
    with open(profiler_path) as f:
        trace = json.load(f)
    shift = (spans["baseTimeNanoseconds"] - trace.get("baseTimeNanoseconds", 0)) / 1e3
    for ev in spans["traceEvents"]:
        trace["traceEvents"].append(dict(ev, ts=ev["ts"] + shift))
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path


TRACER = Tracer()


@contextlib.contextmanager
def torch_trace(out_dir: Optional[str]):
    """Wrap a phase in a ``torch.profiler`` trace of the host and, when
    there is one, the CUDA device; writes ``<out_dir>/trace.json`` (Chrome
    trace format) at the end. No-op when ``out_dir`` is None."""
    if not out_dir:
        yield None
        return
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


if __name__ == "__main__":
    if len(sys.argv) != 5 or sys.argv[1] != "merge":
        sys.exit("usage: python -m evennicer_slam_tpu_torch.utils.telemetry merge "
                 "SPANS.json PROFILER_TRACE.json OUT.json")
    print(merge_chrome(*sys.argv[2:]))
