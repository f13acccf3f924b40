"""Reading a trace: unions of device intervals, launches and device time
inside spans and backward brackets, the idle share, the p90."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from portbench import cells
from portbench.harness import p90
from portbench.trace import Trace, clip, merged, union_length


def test_union_is_not_the_sum():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]
    assert union_length(iv) == 15 + 11 + 1
    assert sum(e - s for s, e in iv) == 32
    assert merged(iv) == [(0, 15), (20, 31), (40, 41)]
    assert clip(iv, 8, 25) == [(8, 10), (8, 15), (20, 25)]
    assert union_length([]) == 0


def test_p90_and_its_sample_count():
    vals = list(range(1, 101))
    assert p90(vals) == pytest.approx(np.percentile(vals, 90))
    assert p90([5.0] * 7) == 5.0


def _ev(name, start, dur, dt="cpu", corr=0, res=1, ua=False):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: DeviceType.CUDA if dt == "cuda" else DeviceType.CPU,
        correlation_id=lambda: corr, device_resource_id=lambda: res,
        is_user_annotation=lambda: ua)


def _events():
    main, grad, pre = 11, 12, 13
    return [
        _ev("pb.track", 100, 900, res=main, ua=True),
        _ev("pb.track", 100, 900, dt="cuda", res=7, ua=True),   # the card's copy: not work
        _ev("cudaLaunchKernel", 110, 5, corr=1, res=main),
        _ev("k_fwd", 120, 50, dt="cuda", corr=1, res=7),
        _ev("cudaLaunchKernelExC", 200, 5, corr=2, res=main),
        _ev("k_fwd2", 160, 40, dt="cuda", corr=2, res=7),       # overlaps k_fwd
        _ev("autograd::engine::evaluate_function: X", 300, 100, res=grad),
        _ev("pb.decode_bwd.begin", 310, 1, res=grad, ua=True),
        _ev("cudaLaunchKernel", 320, 5, corr=3, res=grad),
        _ev("k_bwd", 400, 100, dt="cuda", corr=3, res=7),
        _ev("pb.decode_bwd.end", 330, 1, res=grad, ua=True),
        _ev("cudaMemcpyAsync", 340, 5, corr=4, res=pre),         # the reader's thread
        _ev("Memcpy HtoD", 600, 300, dt="cuda", corr=4, res=9),
        _ev("cudaLaunchKernel", 2000, 5, corr=5, res=main),      # outside every span
        _ev("k_late", 2100, 10, dt="cuda", corr=5, res=7),
        _ev("aten::item", 1500, 400, res=main),
    ]


def test_spans_launches_and_device_time():
    t = Trace.from_events(_events(), main_thread=999)
    assert t.main_thread == 11                # found from the harness's spans
    spans = t.spans("pb.track")
    assert len(spans) == 1
    launches, secs = t.span_device(spans, t.program_threads())
    assert launches == 3                       # memcpy is no launch; the reader's thread is out
    assert secs == pytest.approx((80 + 100) * 1e-9)
    br = t.brackets("pb.decode_bwd")
    assert br == [(310, 331, 12)]
    assert t.span_device(br) == (1, pytest.approx(100e-9))


def test_busy_union_and_idle_share_reader():
    t = Trace.from_events(_events(), main_thread=11)
    busy = t.busy(0, 3000)
    assert busy == [(120, 200), (400, 500), (600, 900), (2100, 2110)]
    r = {"device_trace": t, "window_ns": (0, 3000)}
    assert cells.reader("device_idle_share")(r) == pytest.approx(100 * (1 - 490 / 3000))
    gaps = dict(t.idle_gaps(0, 3000))
    assert "aten::item" in gaps
    ops = dict(t.device_ops(0, 3000))
    assert ops["Memcpy HtoD"] == pytest.approx(300e-9)


def test_mark_brackets_the_backward_of_a_function():
    """The identity marks record begin before, and end after, every
    backward node of the wrapped function, on the autograd thread."""
    from portbench.spans import _mark

    x = torch.randn(8, 4, requires_grad=True)
    w = torch.randn(4, 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (xi,) = _mark("pb.f_bwd.end", [x])
        y = torch.relu(xi @ w).sin()
        (y,) = _mark("pb.f_bwd.begin", [y])
        (g,) = torch.autograd.grad((y * 2).sum(), x)
    ev = prof.profiler.kineto_results.events()
    names = [(e.name(), e.start_ns()) for e in ev]
    begin = [s for n, s in names if n == "pb.f_bwd.begin"]
    end = [s for n, s in names if n == "pb.f_bwd.end"]
    inner = [s for n, s in names if "SinBackward" in n or "MmBackward" in n]
    assert len(begin) == len(end) == 1 and inner
    assert begin[0] < min(inner) and max(inner) < end[0]
    assert torch.allclose(g, torch.autograd.grad((torch.relu(x @ w).sin() * 2).sum(), x)[0])


def test_untraced_stretch_readers():
    """fps.nice and track_p90_ms.nice read the window's untraced stretch; a
    stretch with nothing in it gives no reading; the twins read as the metric
    they copy."""
    ms = [float(v) for v in range(100, 200, 5)]
    r = {"untraced": {"frames": 30, "seconds": 24.0, "track_ms": ms}}
    assert cells.reader("fps.nice")(r) == pytest.approx(1.25)
    assert cells.reader("track_p90_ms.nice")(r) == pytest.approx(p90(ms))
    empty = {"untraced": {"frames": 0, "seconds": 0.0, "track_ms": []}}
    assert cells.reader("fps.nice")(empty) is None
    assert cells.reader("track_p90_ms.nice")(empty) is None
    t = Trace.from_events(_events(), main_thread=11)
    r = {"device_trace": t, "window_ns": (0, 3000)}
    assert cells.reader("device_idle_share.nice")(r) == cells.reader("device_idle_share")(r)
