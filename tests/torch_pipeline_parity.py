"""Shared set-up of ``test_torch_pipeline.py`` and
``test_torch_pipeline_events.py``: the JAX package's ``EvenNICERSLAM`` and
the port's on the same scene on disk, from the same initial state and with
the same random draws.

The scene is written by the JAX package's writer and read by each package's
own reader (the readers agree bit for bit, ``test_torch_datasets.py``). The
sizes are those of the JAX package's ``tests/test_slam.py::tiny_cfg``
(36x48 RGB-D or 64x80 with events, first mapping call 12 iterations, steady
calls 6, a mapping call and a keyframe every second frame, window 3, BA),
with the tracker's 200 pixels of the shipped configuration in place of 60:
with 60 the RGB-D loss of a map fitted for 18 iterations is so noisy that
Adam's sign steps split the two closed loops by 2 mm from the fourth frame.
"""

import copy
import json
import os

import numpy as np
import torch

from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.config import update_recursive as j_update
from evennicer_slam_tpu.data.synthetic import make_synthetic_replica
from evennicer_slam_tpu.slam.pipeline import EvenNICERSLAM as JaxSLAM
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.config import load_config, update_recursive
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from torch_parity import JaxDrawsMapper, jax_to_np, jax_track_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(scene_dir, n_frames, events, load=load_config, update=update_recursive,
             **overrides):
    H, W = (64, 80) if events else (36, 48)
    frag = make_synthetic_replica(scene_dir, n_frames=n_frames, H=H, W=W, fx=60.0, fy=60.0,
                                  traj_step=0.02, reuse_if_current=True)
    if not events:
        frag["dataset"] = "replica"
    cfg = load(os.path.join(ROOT, "configs", "nice_slam.yaml"))
    update(cfg, frag)
    update(cfg, {
        "verbose": False, "coarse": True, "enable_vis": False,
        "mapping": {"iters_first": 12, "iters": 6, "every_frame": 2, "pixels": 120,
                    "mapping_window_size": 3, "keyframe_every": 2, "mesh_freq": 10**9,
                    "ckpt_freq": 2, "BA": True},
        "tracking": {"iters": 3, "pixels": 200, "ignore_edge_W": 4, "ignore_edge_H": 4},
        "event": {"pretrained_path": "/nonexistent", "rgbd_every_frame": 2,
                  "activate_events": True, "balancer": 0.025, "scale_factor": 0.25,
                  "blur": True, "kernel_sizes": [3], "unblurred_weight": 0,
                  "kernel_weights": [1]},
        "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                     "bound_divisible": 0.2},
    })
    update(cfg, copy.deepcopy(overrides))
    return cfg


def run_jax(tmp, n_frames, events, **overrides):
    """The JAX pipeline's whole run; returns its initial state (numpy), the
    pipeline and the mapping calls' event integrals."""
    cfg = tiny_cfg(os.path.join(tmp, "scene"), n_frames, events, j_load_config, j_update,
                   **overrides)
    cfg["data"]["output"] = os.path.join(tmp, "jax")
    slam = JaxSLAM(cfg)
    state = tuple(jax_to_np(t) for t in (slam.grids, slam.decoders, slam.eventnet))
    integrals = record_integrals(slam)
    est = slam.run(mesh=False).copy()
    return {"state": state, "slam": slam, "est": est, "integrals": integrals,
            "records": read_records(slam.output), "cfg": cfg}


def record_integrals(slam):
    """Wrap the pipeline's ``_integrated_event``: {frame: integral as numpy}."""
    seen = {}
    orig = slam._integrated_event

    def wrapped(idx):
        out = orig(idx)
        seen[idx] = np.asarray(out.detach().cpu() if isinstance(out, torch.Tensor) else out)
        return out

    slam._integrated_event = wrapped
    return seen


def port_pipeline(tmp, name, n_frames, events, state, **overrides):
    """The port's pipeline on the CPU from the JAX pipeline's initial state,
    with the JAX package's tracker and mapper draws handed in."""
    cfg = tiny_cfg(os.path.join(tmp, "scene"), n_frames, events, **overrides)
    cfg["data"]["output"] = os.path.join(tmp, name)
    slam = EvenNICERSLAM(cfg, device="cpu")
    convert.pipeline_state_from_numpy(slam, *state)
    use_jax_draws(slam)
    return slam


def use_jax_draws(slam):
    slam.mapper.__class__ = JaxDrawsMapper
    track = slam.tracker.track

    def with_draws(idx, *args, **kw):
        c = slam.tracker.cfg
        if (not c.use_events) or idx % c.rgbd_every_frame == 0:
            kw["pixel_draws"] = jax_track_draws(idx, c, slam.cam)
        return track(idx, *args, **kw)

    slam.tracker.track = with_draws


def read_records(output):
    with open(os.path.join(output, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def mm_apart(a, b):
    """Per-frame distance of two trajectories' positions, in millimetres."""
    return 1e3 * np.linalg.norm(np.asarray(a)[:, :3, 3].astype(np.float64)
                                - np.asarray(b)[:, :3, 3], axis=1)


def skip_mapping_at(slam, frame):
    """Planted schedule fault: the boundary mapping call of ``frame`` is skipped."""
    orig = slam._map_frame

    def faulty(idx, f, init, **kw):
        if idx == frame and not init and not kw.get("color_refine"):
            return None
        return orig(idx, f, init, **kw)

    slam._map_frame = faulty


def stale_mapping_pose(slam):
    """Planted schedule fault: every steady mapping call maps from the
    previous frame's pose; the tracked pose stands again after the call
    unless the call wrote one back (BA)."""
    orig = slam._map_frame

    def faulty(idx, f, init, **kw):
        if init or kw.get("color_refine"):
            return orig(idx, f, init, **kw)
        tracked = slam._pose(idx)
        slam._set_pose(idx, slam._pose(idx - 1))
        orig(idx, f, init, **kw)
        if not slam.mapper.BA_active:
            slam._set_pose(idx, tracked)

    slam._map_frame = faulty
