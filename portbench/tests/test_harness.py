"""A whole run of each cell on the CPU at a small size (the look for a card
skipped, the window a second): on the plain path the program and the
reference agree and ``correct`` is true; with each fault that a cell can
have planted under the timed path, ``correct`` comes out false. The
tracker's packed decode, which the program runs on the card alone, runs
here too in its plain version, checked against the reference's plain ops
at its precision, with the decode's backward broken beneath it. A mix in
the RPG dense-event layout, passed as overrides with nothing added to
``BENCHMARK.json``, runs and is checked the same way."""

import contextlib
import copy
import os

import pytest
import torch

from evennicer_slam_tpu_torch.models import decoders as program_decoders
from evennicer_slam_tpu_torch.slam import mapper as program_mapper
from evennicer_slam_tpu_torch.slam import tracker as program_tracker
from evennicer_slam_tpu_torch.utils.telemetry import TRACER
from portbench import cells, check, harness
from portbench.faults import DECODE_FAULTS, FAULTS, planted

SMALL = {"H": 120, "W": 160, "fx": 100.0, "fy": 100.0, "loop_frames": 12, "frames": 60}


# recording4_gap3_density4's layout and lens at the small size: grey
# frames, four event frames an image, mapping every third frame; two checked
# periods, so that an RGB-D frame (every fifth) is among the checked ones
RPG = {"scene": {"layout": "rpg_event_dense", "frames": 20},
       "cfg_overrides": {"mapping": {"every_frame": 3}, "data": {"density": 4},
                         "cam": {"png_depth_scale": 1000.0, "distortion": [
                             -0.08409333, 0.05335822, -0.00065521, -0.0001679, 0, 0, 0, 0]}},
       "checked_periods": 2}


def _overrides(cell, extra=None):
    iters = 3 if cell.startswith("nice") else 6
    out = {"traffic": {"scene": dict(SMALL), "grow_keyframes": [2, 3, 4, 7], "warm_periods": 1},
           "config": {"mapping": {"iters": iters, "iters_first": 3, "pixels": 100},
                      "tracking": {"iters": 2, "ignore_edge_W": 10, "ignore_edge_H": 10,
                                   "pixels": 50}}}
    harness._update(out["traffic"], copy.deepcopy(extra or {}))
    return out


# on the CPU the tracker decodes through the float32 path unless the packed
# decode is asked for, so the decode's own numbers are read only then
CARD_ONLY = ("decode_fwd", "decode_bwd")


def _limits(cell, packed=None):
    return {k: v for k, v in check.limits(cell).items() if packed or k not in CARD_ONLY}


def _run(cell, seed, tmp_path, monkeypatch, packed=None, extra=None, spans=None, min_frames=5):
    """``extra``: traffic keys merged over the cell's mix; ``spans``, a set
    that takes the names of the program's spans of the whole run;
    ``min_frames``, the least the one-second window may step."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    w = cells.workload(cells.load_benchmark(), cell)
    run = harness.Run(w, seed, 1, False, 0.0, device="cpu", overrides=_overrides(cell, extra),
                      packed=packed)
    if spans is not None:
        TRACER.reset()
        TRACER.enable()
    try:
        run.setup()
        run.window()
    finally:
        if spans is not None:
            spans.update(s.name for s in TRACER.spans())
            TRACER.disable()
            TRACER.reset()
    assert run.frames >= min_frames and all(run.poses_finite)
    run.free_program()
    ref = check.Reference(run.cfg, run.nice, run.eventnet_path, run.device, packed=packed)
    nums = check.numbers(run.capture, check.follow(run.capture, ref))
    run.cleanup()
    return check.verdict(nums, _limits(cell, packed))


CELLS = ["nice.event_k5", "imap.rgbd", "nice.rgbd_k5"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path, monkeypatch):
    spans = set()
    ok, rows = _run(cell, 2 ** 31 + 17, tmp_path, monkeypatch, spans=spans)
    assert ok, rows
    assert {name for name, _, _ in rows} == set(_limits(cell))
    assert "slam.track" in spans
    # the replica layout reads no events: no event render, no EventNet
    events = {"slam.eventnet", "slam.track.event"} & spans
    assert bool(events) == (cell == "nice.event_k5"), events


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_caught(cell, fault, tmp_path, monkeypatch):
    with planted(fault, {"tracker": program_tracker, "mapper": program_mapper}):
        ok, rows = _run(cell, 5, tmp_path, monkeypatch)
    assert not ok, rows


@pytest.mark.parametrize("fault", (None,) + DECODE_FAULTS)
def test_packed_decode_is_checked(fault, tmp_path, monkeypatch):
    """The packed decode's plain version against the reference's: sound, it
    passes with the decode's numbers among those compared; with its
    backward returning zero or negated gradients, it fails."""
    cell = "nice.event_k5"
    with contextlib.ExitStack() as stack:
        if fault is not None:
            stack.enter_context(planted(fault, {"tracker": program_tracker,
                                                "mapper": program_mapper,
                                                "decoders": program_decoders}))
        ok, rows = _run(cell, 2 ** 31 + 29, tmp_path, monkeypatch, packed=True)
    if fault is None:
        assert ok, rows
        assert {"decode_fwd", "decode_bwd", "grad_cos"} <= {name for name, _, _ in rows}
    else:
        assert not ok, rows


@pytest.mark.parametrize("fault", (None, "altered"))
def test_dense_event_layout_runs_and_is_checked(fault, tmp_path, monkeypatch):
    """``nice.event_k5``'s configuration over a mix in the RPG dense-event
    layout, given as overrides: the program reads it through
    ``RPGEventDense`` (grey, undistorted, four event frames an image) and
    the check decodes it alike; sound, the run is correct, with a tracked
    pose altered, it is not."""
    with contextlib.ExitStack() as stack:
        if fault is not None:
            stack.enter_context(planted(fault, {"tracker": program_tracker,
                                                "mapper": program_mapper}))
        # a period is three frames here, and the window holds whole ones
        ok, rows = _run("nice.event_k5", 2 ** 31 + 41, tmp_path, monkeypatch, extra=RPG,
                        min_frames=3)
    assert ok == (fault is None), rows
