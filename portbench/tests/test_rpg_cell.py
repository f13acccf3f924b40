"""``nice.rpg_density4``, EvenNICER-SLAM's RPG event camera: a whole run on
the CPU at the small size of ``test_harness.py``, read through
``RPGEventDense`` (grey, undistorted, four event frames an image) and
checked alike, sound and with every planted fault; its merged run
configuration against upstream's published files; and the reader of its
undistortion spans on hand-built spans."""

import os

import pytest

from evennicer_slam_tpu_torch.config import default_config_path, load_config, update_recursive
from evennicer_slam_tpu_torch.slam import mapper as program_mapper
from evennicer_slam_tpu_torch.slam import tracker as program_tracker
from portbench import cells, harness, program, scene
from portbench.faults import FAULTS, planted
from portbench.tests.test_harness import _limits, _run
from portbench.tests.test_program_spans import SPANS, WORKER, _reading, _span

CELL = "nice.rpg_density4"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the small size keeps the mix's two warm periods: mapping every third frame,
# its checked period holds an RGB-D frame (every fifth) only after them; a
# period is three frames, and the window holds whole ones
SMALL_RUN = {"extra": {"warm_periods": 2}, "min_frames": 3}


def test_sound_run_is_correct(tmp_path, monkeypatch):
    spans = set()
    ok, rows = _run(CELL, 2 ** 31 + 17, tmp_path, monkeypatch, spans=spans, **SMALL_RUN)
    assert ok, rows
    assert {name for name, _, _ in rows} == set(_limits(CELL))
    assert {"slam.track", "slam.eventnet", "slam.track.event"} <= spans
    # the DAVIS346's lens is undone on the reader's worker
    assert "slam.reader.undistort" in spans


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_caught(fault, tmp_path, monkeypatch):
    with planted(fault, {"tracker": program_tracker, "mapper": program_mapper}):
        ok, rows = _run(CELL, 5, tmp_path, monkeypatch, **SMALL_RUN)
    assert not ok, rows


def test_run_config_keeps_upstreams_published_keys():
    """The merged run configuration against upstream's
    ``configs/rpg/recording4_gap3_density4.yaml`` over ``rpg.yaml`` over
    ``configs/nice_slam.yaml``: camera, lens, depth scale, density, bound,
    widths and schedule as published; every top-level key that differs from
    upstream but the seed that the harness fills in is named in the
    configuration's ``reduced``."""
    upstream = load_config(default_config_path(nice=True))
    update_recursive(upstream, load_config(
        os.path.join(ROOT, "configs", "rpg", "recording4_gap3_density4.yaml")))
    bench = cells.load_benchmark()
    w = cells.workload(bench, CELL)
    tr = cells.traffic(w["traffic"])
    config = cells.config(bench, w["config"])
    params = scene.recorded(tr["scene"], harness.mix_config(config, tr))
    cfg = harness.run_config(config, tr, scene.scene_fragment("SCENE", params), "OUT", 2 ** 31 + 7)

    published = {
        "cam": ("H", "W", "fx", "fy", "cx", "cy", "crop_edge", "png_depth_scale", "distortion"),
        "data": ("density",),
        "mapping": ("bound", "marching_cubes_bound", "every_frame", "iters", "pixels",
                    "mapping_window_size", "BA", "BA_cam_lr", "frustum_feature_selection",
                    "fine_iter_ratio", "middle_iter_ratio", "stage", "w_color_loss"),
        "tracking": ("iters", "pixels", "lr", "ignore_edge_H", "ignore_edge_W",
                     "handle_dynamic", "use_color_in_tracking", "w_color_loss",
                     "const_speed_assumption", "seperate_LR"),
        "event": ("activate_events", "balancer", "blur", "kernel_sizes", "kernel_weights",
                  "rgbd_every_frame", "scale_factor", "unblurred_weight"),
        "model": ("c_dim", "coarse_bound_enlarge", "pos_embedding_method"),
        "grid_len": ("coarse", "middle", "fine", "color", "bound_divisible"),
        "rendering": ("N_samples", "N_surface", "N_importance", "lindisp", "perturb"),
    }
    for group, keys in published.items():
        for key in keys:
            assert cfg[group][key] == upstream[group][key], (group, key)
    for key in ("coarse", "occupancy", "low_gpu_mem", "sync_method", "scale"):
        assert cfg[key] == upstream[key], key
    assert cfg["cam"]["H"] == params["H"] == 260 and cfg["cam"]["W"] == params["W"] == 346
    assert cfg["dataset"] == "rpg_event_dense" and cfg["data"]["density"] == 4
    # the lens, depth scale and density the scene was written with are the configuration's
    assert (params["distortion"], params["png_depth_scale"], params["density"]) == (
        upstream["cam"]["distortion"], 1000.0, 4)
    run_keys = config["config"]
    changed = {k for k in set(upstream) | set(run_keys)
               if upstream.get(k) != run_keys.get(k)} - {"inherit_from"}
    assert changed <= set(config["reduced"]) | {"seed"}, changed - set(config["reduced"])


# the lens undistortion of each image inside the worker's decode
UNDISTORT = [
    _span("slam.reader.undistort", 105, 115, 15, 10, thread=WORKER, frame=1),
    _span("slam.reader.undistort", 118, 128, 16, 10, thread=WORKER, frame=1),
    _span("slam.reader.undistort", 530, 542, 17, 11, thread=WORKER, frame=2),
    _span("slam.reader.undistort", 1130, 1140, 18, 14, thread=WORKER, frame=3),  # after
]


def test_undistort_reader_on_hand_built_spans(monkeypatch):
    """``reader_undistort_ms.nice``: host time inside the undistortion spans
    over the device-traced periods, a frame decoded there; nothing to read
    where the program records none, as in a camera without a lens."""
    read = cells.reader("reader_undistort_ms.nice")
    monkeypatch.setattr(program, "program_spans", lambda: SPANS + UNDISTORT)
    assert read(_reading()) == pytest.approx(1e-6 * (10 + 10 + 12) / 2, rel=1e-12)
    # the decode reader is unchanged by the spans inside its own
    assert cells.reader("reader_decode_ms.nice")(_reading()) == pytest.approx(
        1e-6 * (30 + 50) / 2, rel=1e-12)
    monkeypatch.setattr(program, "program_spans", lambda: list(SPANS))
    assert read(_reading()) is None
    monkeypatch.setattr(program, "program_spans", lambda: [])
    assert read(_reading()) is None
    monkeypatch.setattr(program, "program_spans", lambda: None)
    assert read(_reading()) is None
