"""The readers of the program's own spans (``portbench/program.py`` and the
metrics that use it) on hand-built device intervals and spans; nothing to
read where the program has no tracer; and, in a CPU run, the program's
tracer records in both profiled stages and nowhere else."""

import sys
import types

import pytest
import torch

from evennicer_slam_tpu_torch.utils.telemetry import TRACER, Span
from portbench import cells, harness, program
from portbench.trace import Trace

MAIN, WORKER = 11, 13
NEW = ("track_idle_ms", "map_idle_ms", "host_sync_ms", "reader_decode_ms")


def _span(name, start, end, sid, parent=-1, thread=MAIN, frame=0):
    return Span(name, start, end, sid, parent, thread, frame)


def _reading():
    # the card busy over [100, 200), [300, 400) and [650, 700) of [0, 1000)
    device = [(100, 150, 1, "k"), (140, 200, 2, "k"), (300, 400, 3, "k"), (650, 700, 4, "k")]
    return {"device_trace": Trace(device, {}, [], [], MAIN, []), "window_ns": (0, 1000)}


SPANS = [
    _span("slam.step", 0, 500, 1),
    _span("slam.track", 50, 450, 2, 1),                # idle inside: 200
    _span("slam.track.iter", 60, 440, 3, 2),            # idle inside: 180
    _span("slam.sync.metrics", 450, 460, 4, 1),
    _span("slam.step", 500, 1000, 5, frame=1),
    _span("slam.track", 600, 900, 6, 5, frame=1),       # idle inside: 250
    _span("slam.map", 900, 990, 7, 5, frame=1),         # idle inside: 90
    _span("slam.sync.map_host", 920, 950, 8, 7, frame=1),
    _span("slam.sync.pose", 930, 940, 9, 8, frame=1),   # inside a sync span: once
    _span("slam.reader.decode", 100, 130, 10, thread=WORKER, frame=1),
    _span("slam.reader.decode", 520, 570, 11, thread=WORKER, frame=2),
    _span("slam.step", 1100, 1200, 12, frame=2),        # after the device-traced periods
    _span("slam.track", 1110, 1190, 13, 12, frame=2),
    _span("slam.reader.decode", 1120, 1200, 14, thread=WORKER, frame=3),
]


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(program, "program_spans", lambda: list(SPANS))


def test_readers_on_hand_built_spans(spans):
    r = _reading()
    got = {name: cells.reader(name)(r) for name in NEW}
    assert got == pytest.approx({"track_idle_ms": 1e-6 * (200 + 250) / 2,
                                 "map_idle_ms": 1e-6 * 90,
                                 "host_sync_ms": 1e-6 * (10 + 30) / 2,
                                 "reader_decode_ms": 1e-6 * (30 + 50) / 2}, rel=1e-12)
    for name in NEW:
        assert cells.reader(name + ".nice")(r) == got[name]


def test_idle_by_the_innermost_span(spans):
    out = program.idle_by_span(_reading())
    # idle: [0, 100), [200, 300), [400, 650), [700, 1000) = 750 in all
    assert out["idle_ns"] == 750
    # exclusive idle: each span's own less its children's
    assert out["by_span"] == {"slam.track.iter": 180, "slam.track": 20 + 250,
                              "slam.step": (300 - 200 - 10) + (450 - 250 - 90),
                              "slam.map": 90 - 30, "slam.sync.map_host": 30 - 10,
                              "slam.sync.pose": 10, "slam.sync.metrics": 10}
    assert out["outside"] == 0
    assert out["below_step"] == pytest.approx((750 - 200) / 750)


def test_nothing_to_read_without_the_programs_tracer(monkeypatch):
    bare = types.ModuleType("evennicer_slam_tpu_torch.utils.telemetry")
    monkeypatch.setitem(sys.modules, "evennicer_slam_tpu_torch.utils.telemetry", bare)
    r = _reading()
    assert program.program_spans() is None and program.idle_by_span(r) is None
    for name in NEW:
        assert cells.reader(name)(r) is None and cells.reader(name + ".nice")(r) is None


def test_no_spans_no_value(monkeypatch):
    monkeypatch.setattr(program, "program_spans", lambda: [])
    for name in NEW:
        assert cells.reader(name)(_reading()) is None


SMALL = {"H": 64, "W": 80, "fx": 50.0, "fy": 50.0, "loop_frames": 8, "frames": 1000}


def _run(trace, tmp_path, monkeypatch):
    """A CPU run of imap.rgbd at a small size; (the run, [(frame, the
    profiler on)] of every frame stepped in the window). A CPU build has
    no CUDA activity to trace: the stages trace the host."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    overrides = {"traffic": {"scene": SMALL, "grow_keyframes": [], "warm_frames": 2,
                             "warm_periods": 0, "checked_periods": 0},
                 "config": {"mapping": {"iters": 3, "iters_first": 3, "pixels": 40},
                            "tracking": {"iters": 2, "pixels": 30, "ignore_edge_W": 4,
                                         "ignore_edge_H": 4}}}
    run = harness.Run(cells.workload(cells.load_benchmark(), "imap.rgbd"), 7, 1, trace, 0.0,
                      device="cpu", overrides=overrides)
    TRACER.reset()
    run.setup()
    stepped = []
    step = run.slam.step

    def logged(idx):
        stepped.append((idx, torch.autograd.profiler._is_profiler_enabled))
        return step(idx)

    run.slam.step = logged
    run.window()
    return run, stepped


@pytest.mark.parametrize("trace", [False, True])
def test_the_tracer_records_in_the_profiled_stages_only(trace, tmp_path, monkeypatch):
    run, stepped = _run(trace, tmp_path, monkeypatch)
    try:
        spans = TRACER.spans()
        assert not TRACER.enabled
        frames = {s.frame for s in spans if s.name == "slam.step"}
        profiled = {i for i, on in stepped if on}
        assert frames == profiled
        if not trace:
            assert spans == [] and not profiled
            return
        every = run.every
        tr = run.traffic
        assert len(profiled) == every * (tr["device_periods"] + tr["span_periods"]), stepped
        # the untraced stretch came first and recorded nothing
        first = min(profiled)
        assert [i for i, _ in stepped if i < first] and all(
            not on for i, on in stepped if i < first)
        assert set(run.traced) == {"device", "span"}
        for name in ("slam.track", "slam.map", "slam.reader.get", "slam.decode.imap"):
            assert any(s.name == name for s in spans), name
    finally:
        run.free_program()
        run.cleanup()
        TRACER.reset()
