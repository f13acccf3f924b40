"""The program's tracer (``evennicer_slam_tpu_torch/utils/telemetry.py``) on
the CPU: off, a span is one shared null context and a pipeline's poses and
losses are bit for bit those of a traced run; the spans are on the clock of
``torch.profiler``'s events; parents, threads and frame indices across the
main, reader-worker and autograd threads; on a ``portbench`` run, each
program span at a layer boundary occurs as often as the benchmark's wrapper
span around the same call, and inside it; the Chrome export of
``run.py --spans``; the lens undistortion's spans inside the reader's decode
and the dense event reader's count of images decoded again."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch import run as port_run
from evennicer_slam_tpu_torch.config import default_config_path, load_config, update_recursive
from evennicer_slam_tpu_torch.data.synthetic import make_synthetic_replica
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils.telemetry import NULL_SPAN, TRACER, merge_chrome

from torch_parity import cap_threads

cap_threads()
N_FRAMES = 4


@pytest.fixture(autouse=True)
def quiet_tracer():
    TRACER.disable()
    TRACER.reset()
    yield
    TRACER.disable()
    TRACER.reset()


@pytest.fixture(scope="module")
def event_scene(tmp_path_factory):
    # the UNet needs 16 px at event scale after its four halvings
    d = tmp_path_factory.mktemp("telemetry")
    return d, make_synthetic_replica(str(d / "scene"), n_frames=N_FRAMES, H=64, W=80,
                                     fx=60.0, fy=60.0, traj_step=0.02)


def _cfg(event_scene, name):
    d, frag = event_scene
    cfg = load_config(default_config_path(nice=True))
    update_recursive(cfg, frag)
    update_recursive(cfg, {
        "verbose": False, "coarse": True, "enable_vis": False,
        "data": {"output": str(d / name)},
        "mapping": {"iters_first": 4, "iters": 2, "every_frame": 2, "pixels": 60,
                    "mapping_window_size": 3, "keyframe_every": 2, "BA": True},
        "tracking": {"iters": 2, "pixels": 40, "ignore_edge_W": 4, "ignore_edge_H": 4},
        "event": {"pretrained_path": "/nonexistent", "rgbd_every_frame": 2,
                  "activate_events": True, "balancer": 0.025, "scale_factor": 0.25,
                  "blur": True, "kernel_sizes": [3], "unblurred_weight": 0,
                  "kernel_weights": [1]},
        "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                     "bound_divisible": 0.2},
    })
    return cfg


def _pipeline(event_scene, name, traced):
    """The tiny event pipeline over every frame, the tracker's decode through
    the packed path (its plain version here), so that the decode and
    EventNet backward brackets run; (poses, the losses of each frame)."""
    slam = EvenNICERSLAM(_cfg(event_scene, name), nice=True, device="cpu")
    slam.tracker.settings = slam.tracker.settings._replace(fused_decode=True)
    if traced:
        TRACER.enable()
    losses = []
    for idx in range(N_FRAMES):
        slam.step(idx)
        losses.append({k: v.clone() for k, v in slam.tracker.last_losses.items()}
                      | {"map": torch.as_tensor(slam.mapper.last_loss).clone()})
    TRACER.disable()
    return slam.estimate_c2w_list.copy(), losses


@pytest.fixture(scope="module")
def traced_run(event_scene):
    TRACER.reset()
    poses, losses = _pipeline(event_scene, "on", traced=True)
    spans = TRACER.spans()
    TRACER.reset()
    return poses, losses, spans


def test_off_a_span_is_the_null_context_and_results_are_bitwise_equal(event_scene, traced_run):
    assert not TRACER.on
    assert TRACER.span("slam.any") is NULL_SPAN and TRACER.step(3) is NULL_SPAN
    x = torch.ones(3, requires_grad=True)
    (same,), finish = TRACER.backward_bracket("slam.any.bwd", x)
    assert same is x and finish(x)[0] is x
    with TRACER.span("slam.any"):
        TRACER.add("slam.counter")
    poses, losses = _pipeline(event_scene, "off", traced=False)
    assert TRACER.spans() == [] and not TRACER.total and not TRACER.count
    on_poses, on_losses, spans = traced_run
    assert np.array_equal(poses, on_poses)
    assert len(losses) == len(on_losses)
    for a, b in zip(losses, on_losses):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    names = {s.name for s in spans}
    assert {"slam.step", "slam.track", "slam.track.iter", "slam.track.iter.loss",
            "slam.track.iter.grad", "slam.track.iter.step", "slam.map", "slam.map.window",
            "slam.map.iter", "slam.map.iter.loss", "slam.map.iter.grad", "slam.map.iter.step",
            "slam.decode.fwd", "slam.decode.bwd", "slam.eventnet", "slam.eventnet.bwd",
            "slam.reader.get", "slam.reader.decode"} <= names


def test_spans_enclose_the_profilers_events_of_their_work():
    """A span follows a running profiler without ``enable()``, lands in its
    trace as an annotation, and its time_ns stamps enclose the kineto
    events of the ops issued inside it."""
    a = torch.randn(64, 64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(20):
            with TRACER.span(f"slam.clock.{i}"):
                (a @ a).relu().sum()
    assert not TRACER.on and TRACER.span("slam.after") is NULL_SPAN
    spans = {s.name: s for s in TRACER.spans()}
    assert len(spans) == 20
    events = prof.profiler.kineto_results.events()
    assert {e.name() for e in events} >= set(spans)
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name().startswith("aten::")]
    assert len(ops) >= 60
    for start, end in ops:
        (owner,) = [s for s in spans.values() if s.start <= start < s.end]
        assert end <= owner.end, (owner, start, end)
    for s in spans.values():
        assert sum(s.start <= o[0] < s.end for o in ops) >= 3


def test_parents_threads_and_frames(traced_run):
    _, _, spans = traced_run
    by_id = {s.id: s for s in spans}
    main = threading.get_native_id()
    steps = [s for s in spans if s.name == "slam.step"]
    assert [s.frame for s in steps] == list(range(N_FRAMES))
    assert all(s.parent == -1 and s.thread == main for s in steps)

    def root(s):
        while s.parent != -1:
            s = by_id[s.parent]
        return s

    for s in spans:
        if s.name == "slam.reader.decode":
            # the worker's decode ahead: a root of its own thread, the frame
            # it decoded
            assert s.parent == -1 and s.thread != main and 1 <= s.frame < N_FRAMES
            continue
        r = root(s)
        assert r.name == "slam.step" and s.frame == r.frame, s
        assert r.start <= s.start <= s.end <= r.end, s
    decoded = sorted(s.frame for s in spans if s.name == "slam.reader.decode")
    assert decoded == list(range(1, N_FRAMES))
    parent = {"slam.track": {"slam.step"}, "slam.track.iter": {"slam.track"},
              "slam.track.iter.loss": {"slam.track.iter"},
              "slam.track.iter.grad": {"slam.track.iter"},
              "slam.track.iter.step": {"slam.track.iter"},
              "slam.track.rgbd": {"slam.track.iter.loss"},
              "slam.track.event": {"slam.track.iter.loss"},
              "slam.track.event.loss": {"slam.track.event"},
              "slam.step.map": {"slam.step"}, "slam.map": {"slam.step.map"},
              "slam.map.window": {"slam.map"}, "slam.map.iter": {"slam.map"},
              "slam.map.iter.loss": {"slam.map.iter"}, "slam.reader.get": {"slam.step"},
              "slam.render": {"slam.track.rgbd", "slam.track.event", "slam.map.iter.loss"},
              "slam.decode.fwd": {"slam.render"},
              "slam.eventnet": {"slam.track.event", "slam.map.iter.loss"},
              # on the CPU autograd runs the backward on the caller's thread
              "slam.decode.bwd": {"slam.track.iter.grad"},
              "slam.eventnet.bwd": {"slam.track.iter.grad", "slam.map.iter.grad"}}
    for s in spans:
        if s.name in parent:
            assert by_id[s.parent].name in parent[s.name], s
    # a mapping call carries its frame's index: frames 0 and 2, and the last
    # frame's colour refinement
    assert {s.frame for s in spans if s.name == "slam.map"} == {0, 2, N_FRAMES - 1}


def test_a_helper_threads_first_span_hangs_under_the_frames_thread():
    """As on the card, where a device's autograd thread runs the backward
    that the frame's thread waits for; a detached span stands alone."""
    TRACER.enable()
    out = {}

    def helper():
        with TRACER.span("slam.helper"):
            with TRACER.span("slam.helper.inner"):
                pass
        with TRACER.span("slam.alone", frame=9, detached=True):
            pass
        out["tid"] = threading.get_native_id()

    with TRACER.step(7):
        with TRACER.span("slam.wait"):
            t = threading.Thread(target=helper)
            t.start()
            t.join()
    s = {x.name: x for x in TRACER.spans()}
    assert s["slam.helper"].parent == s["slam.wait"].id
    assert s["slam.helper.inner"].parent == s["slam.helper"].id
    assert s["slam.helper"].thread == out["tid"] != s["slam.wait"].thread
    assert s["slam.helper"].frame == s["slam.helper.inner"].frame == 7
    assert s["slam.alone"].parent == -1 and s["slam.alone"].frame == 9
    assert s["slam.step"].parent == -1 and s["slam.wait"].parent == s["slam.step"].id


# ---- the benchmark's wrapper spans around the same calls ----------------------

BOUNDARY = {"slam.track": "pb.track", "slam.map": "pb.map", "slam.decode.fwd": "pb.decode_fwd",
            "slam.decode.imap": "pb.imap_fwd", "slam.eventnet": "pb.eventnet",
            "slam.reader.get": "pb.frame_wait"}
BRACKETS = {"slam.decode.bwd": "pb.decode_bwd", "slam.eventnet.bwd": "pb.eventnet_bwd"}


@pytest.mark.parametrize("cell", ["nice.event_k5", "imap.rgbd"])
def test_boundary_spans_match_the_benchmarks_wrappers(cell, tmp_path, monkeypatch):
    from portbench import cells, harness
    from portbench.trace import Trace

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    nice = cell.startswith("nice")
    small = {"H": 64, "W": 80, "fx": 50.0, "fy": 50.0, "loop_frames": 8, "frames": 40}
    overrides = {
        "traffic": {"scene": small, "warm_frames": 2, "grow_keyframes": [],
                    "warm_periods": 0, "checked_periods": 0},
        "config": {"mapping": {"iters": 2, "iters_first": 2, "pixels": 40},
                   "tracking": {"iters": 2, "ignore_edge_W": 4, "ignore_edge_H": 4,
                                "pixels": 30}}}
    if nice:
        overrides["config"]["event"] = {"scale_factor": 0.25}
    run = harness.Run(cells.workload(cells.load_benchmark(), cell), 3, 1, False, 0.0,
                      device="cpu", overrides=overrides, packed=True if nice else None)
    run.setup()
    assert TRACER.spans() == []            # nothing recorded without a profiler
    run.ins.spanning = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run._periods(run.idx, 1)
    run.ins.spanning = False
    trace = Trace.from_events(prof.profiler.kineto_results.events(), threading.get_native_id())
    spans = TRACER.spans()
    run.free_program()
    run.cleanup()
    wrappers = [(n, trace.spans(pb)) for n, pb in BOUNDARY.items()]
    wrappers += [(n, trace.brackets(pb)) for n, pb in BRACKETS.items()]
    seen = 0
    for name, pbs in wrappers:
        mine = sorted((s.start, s.end) for s in spans if s.name == name)
        assert len(mine) == len(pbs), (name, len(mine), len(pbs))
        for (s, e), (ps, pe, _) in zip(mine, sorted(pbs)):
            assert ps <= s <= e <= pe, name
        seen += bool(mine)
    assert seen == (7 if nice else 4)      # iMAP: no packed decode, no EventNet


def test_run_py_spans_writes_a_chrome_trace_of_every_span(event_scene, tmp_path):
    import yaml

    cfg = _cfg(event_scene, "cli")
    cfg["meshing"] = {"eval_rec": False, "resolution": 16}
    path = tmp_path / "scene.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "spans.json"
    port_run.main([str(path), "--output", str(tmp_path / "out"), "--device", "cpu",
                   "--end_frame", "3", "--spans", str(out)])
    assert not TRACER.enabled
    spans = TRACER.spans()
    doc = json.loads(out.read_text())
    events = doc["traceEvents"]
    assert len(events) == len(spans) > 0 and doc["dropped"] == 0
    assert sorted(e["args"]["id"] for e in events) == sorted(s.id for s in spans)
    base = doc["baseTimeNanoseconds"]
    for e, s in zip(events, spans):
        assert e["ph"] == "X" and e["name"] == s.name and e["tid"] == s.thread
        assert e["ts"] == (s.start - base) / 1e3 and e["dur"] == (s.end - s.start) / 1e3
    counters = doc["counters"]
    assert counters.get("slam.reader.ready", 0) + counters.get("slam.reader.waited", 0) >= 2
    assert [e["args"]["frame"] for e in events if e["name"] == "slam.step"] == [0, 1, 2]
    # beside a profiler's trace of its own: the spans shifted onto its base
    prof_trace = {"baseTimeNanoseconds": base - 5000, "traceEvents": [{"ph": "X", "ts": 1.0}]}
    (tmp_path / "trace.json").write_text(json.dumps(prof_trace))
    merged = json.loads(open(merge_chrome(str(out), str(tmp_path / "trace.json"),
                                          str(tmp_path / "merged.json"))).read())
    assert len(merged["traceEvents"]) == len(events) + 1
    assert merged["traceEvents"][1]["ts"] == events[0]["ts"] + 5.0
    assert os.path.exists(tmp_path / "out" / "mesh" / "final_mesh.ply")


# ---- the dense event reader through a lens ------------------------------------

# the DAVIS346's lens of configs/rpg/rpg.yaml, four event frames an image
RPG_LENS = [-0.08409333, 0.05335822, -0.00065521, -0.0001679, 0, 0, 0, 0]
DENSITY = 4


@pytest.fixture(scope="module")
def dense_scene(tmp_path_factory):
    """A small ``rpg_event_dense`` scene written by the benchmark's scene
    writer through the lens: 5 images, 17 dense steps."""
    from portbench import scene

    params = {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "layout": "rpg_event_dense",
              "bound": [[-7.0, 9.4], [-6.5, 3.6], [-9.2, 9.5]], "margin": 0.02,
              "loop_frames": 3, "frames": 5, "amplitude": 0.3, "event_gain": 20.0}
    camera = {"cam": {"png_depth_scale": 1000.0, "distortion": RPG_LENS},
              "data": {"density": DENSITY}}
    root = str(tmp_path_factory.mktemp("dense"))
    return scene.write_scene(root, scene.recorded(params, camera), torch.device("cpu"))


def _dense_reader(frag, lens=True):
    from evennicer_slam_tpu_torch.data.datasets import get_dataset

    cfg = dict(frag, cam=dict(frag["cam"]), data=dict(frag["data"]), scale=1.0)
    if not lens:
        del cfg["cam"]["distortion"]
    return get_dataset(cfg, None, 1.0)


def _prefetched_spans(reader, n):
    """The spans of ``n`` frames read in order through the prefetcher."""
    from evennicer_slam_tpu_torch.data.prefetch import PrefetchingReader

    pre = PrefetchingReader(reader, device="cpu")
    TRACER.enable()
    for idx in range(n):
        with TRACER.step(idx):
            pre.get_with_device(idx)
    pre._join()
    TRACER.disable()
    return TRACER.spans()


def test_undistort_spans_nest_in_the_workers_decode(dense_scene):
    """One ``slam.reader.undistort`` a colour read and one an event read
    (step 0 has no event file), on the worker's thread inside its
    ``slam.reader.decode``, carrying the frame's index; step 0, read on the
    caller's thread, hangs under ``slam.reader.get``."""
    reader = _dense_reader(dense_scene)
    n = 2 * DENSITY + 1
    spans = _prefetched_spans(reader, n)
    by_id = {s.id: s for s in spans}
    decodes = [s for s in spans if s.name == "slam.reader.decode"]
    # the last read decodes the next frame ahead
    assert sorted(d.frame for d in decodes) == list(range(1, n + 1))
    undistort = [s for s in spans if s.name == "slam.reader.undistort"]
    for d in decodes:
        inner = [u for u in undistort if u.parent == d.id]
        assert len(inner) == 2, d
        assert all(u.frame == d.frame and u.thread == d.thread for u in inner)
        assert all(d.start <= u.start <= u.end <= d.end for u in inner)
    (first,) = [u for u in undistort if by_id[u.parent].name != "slam.reader.decode"]
    assert first.frame == 0 and by_id[first.parent].name == "slam.reader.get"
    assert len(undistort) == 2 * len(decodes) + 1


def test_a_reader_without_a_lens_records_no_undistort_span(dense_scene):
    spans = _prefetched_spans(_dense_reader(dense_scene, lens=False), DENSITY + 1)
    assert any(s.name == "slam.reader.decode" for s in spans)
    assert not any(s.name == "slam.reader.undistort" for s in spans)


def test_image_reread_counts_three_steps_of_four(dense_scene):
    """A dense step whose index is not a multiple of the density decodes
    again an image that an earlier step read; off, nothing is counted."""
    reader = _dense_reader(dense_scene)
    assert len(reader) == 4 * DENSITY + 1
    for idx in range(4 * DENSITY):
        reader[idx]
    assert not TRACER.count
    TRACER.enable()
    for idx in range(4 * DENSITY):
        reader[idx]
    TRACER.disable()
    assert TRACER.count["slam.reader.image_reread"] == 3 * 4
