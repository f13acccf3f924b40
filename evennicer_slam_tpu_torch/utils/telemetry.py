"""Observability: structured metrics, phase timers, profiler traces
(counterpart of ``evennicer_slam_tpu/utils/telemetry.py``).

Metrics go to a JSONL stream, one record per frame or event, that any
dashboard can tail.
:func:`torch_trace` wraps a phase in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional


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


class PhaseTimers:
    """Cumulative wall-clock time and count per phase."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, float]:
        out = {}
        for k, v in self.total.items():
            out[f"{k}_total_s"] = round(v, 3)
            if self.count[k]:
                out[f"{k}_mean_ms"] = round(1000 * v / self.count[k], 2)
        return out


@contextlib.contextmanager
def torch_trace(out_dir: Optional[str]):
    """Wrap a phase in a ``torch.profiler`` trace of the host and, when
    there is one, the CUDA device; writes ``<out_dir>/trace.json`` (Chrome
    trace format) at the end. No-op when ``out_dir`` is None."""
    if not out_dir:
        yield None
        return
    import torch

    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
