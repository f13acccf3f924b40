#!/usr/bin/env python3
"""The trajectory error of ``chip_smoke.py``'s map-and-track phase over
seeds, on one NVIDIA GPU.

    python3 scripts/ate_spread.py [--seeds 1 2 3 4] [--schedules every bench]
        [--scale 1.0] [--bound config|pipeline] [--pipeline [--faults ...]]
        [--out build/ate_spread.json]

For each seed and schedule, runs ``chip_smoke.map_and_track`` (frames 0-25
of the furnished room, the first mapping call 300 iterations, a steady call
and a keyframe every fifth frame) with the map, the mapper's draws and the
tracker's draws started from that seed, and prints its ATE beside the RMSE
of a camera held at frame 0. Schedules: ``every`` (RGB-D + event on every
frame) and ``bench`` (event only, RGB-D every fifth frame). ``--scale`` cuts
the camera (focal lengths and the tracker's ignored edges with it), as
``tests/test_torch_map_and_track.py`` does for its CPU runs of both frameworks.
``--bound pipeline`` gives the map the bound the pipeline uses
(``slam/pipeline.py::load_scene_bound``: rounded up to ``bound_divisible``,
one grid cell more an axis) instead of the configured one.

``--pipeline`` runs ``chip_smoke.run_pipeline`` instead: ``EvenNICERSLAM.run``
over the same frames read from the scene on disk, the configuration's seed
replaced by each seed, and, with ``--faults``, once more with each fault
planted: ``skip`` (the steady mapping call of frame 10 skipped) and
``stale`` (every steady mapping call given the previous frame's pose).
Prints the card's name and power limit first.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from evennicer_slam_tpu_torch.slam.pipeline import load_scene_bound  # noqa: E402


def skip_call(slam, frame=10):
    """Planted fault: the steady mapping call of ``frame`` is skipped."""
    orig = slam._map_frame

    def faulty(idx, f, init, **kw):
        if idx == frame and not init:
            return None
        return orig(idx, f, init, **kw)

    slam._map_frame = faulty


def stale_pose(slam):
    """Planted fault: every steady mapping call maps from the previous
    frame's pose; the tracked pose stands again after the call unless the
    call wrote one back (BA)."""
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


FAULTS = {"skip": skip_call, "stale": stale_pose}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--schedules", nargs="+", default=["every", "bench"],
                    choices=["every", "bench"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--bound", choices=["config", "pipeline"], default="config")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--out", default="build/ate_spread.json")
    opts = ap.parse_args()
    if opts.pipeline and opts.scale != 1.0:
        ap.error("--pipeline runs at full width (its configuration's ignored edges)")
    dev = torch.device("cuda")
    print(f"device: {cs.nvidia_smi_line()}", flush=True)
    cs.setup_torch(verbose=False)
    cs.cuda_build.build_all(["fused_decode", "fused_decode_bwd"])
    cfg = cs.load_config(cs.default_config_path(nice=True))
    c = cfg["cam"]
    H, W = round(c["H"] * opts.scale), round(c["W"] * opts.scale)
    c.update(H=H, W=W, fx=c["fx"] * opts.scale, fy=c["fy"] * opts.scale,
             cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)
    mp = cs.main_path_inputs(cfg, torch.from_numpy(cs.BOUND).to(dev), dev)
    edge = round(100 * opts.scale)
    mp.tcfg = mp.tcfg._replace(ignore_edge_h=edge, ignore_edge_w=edge)
    frag = cs.write_room_scene(mp.cam)
    bound = (load_scene_bound(cs.pipeline_config(frag)) if opts.bound == "pipeline"
             else cs.BOUND)
    frames = None if opts.pipeline else cs.room_frames(frag, dev, cs.MAP_FRAMES)
    runs = []
    for seed in opts.seeds:
        for sched in opts.schedules:
            for fault in [None] + (opts.faults if opts.pipeline else []):
                if opts.pipeline:
                    ate, held, err, _ = cs.run_pipeline(
                        frag, dev, 1 if sched == "every" else 5, seed=seed,
                        plant=FAULTS[fault] if fault else None, label=f"{sched}_{fault}")
                else:
                    tcfg = mp.tcfg._replace(rgbd_every_frame=1) if sched == "every" else mp.tcfg
                    _, res = cs.map_and_track(cfg, mp, dev, frames, tcfg,
                                              f"{sched}, seed {seed}", lambda held: np.inf,
                                              seed=seed, bound=bound)
                    ate, held, err = (res["ate_rmse_m"], res["held_camera_rmse_m"],
                                      res["err_mm_per_frame"])
                runs.append({"seed": seed, "schedule": sched, "cam": [H, W],
                             "pipeline": opts.pipeline, "fault": fault,
                             "bound": [[float(v) for v in r] for r in bound]
                             if not opts.pipeline else "pipeline",
                             "ate_rmse_m": ate, "held_camera_rmse_m": held,
                             "err_mm_per_frame": err})
                print(json.dumps(runs[-1]), flush=True)
    summary = {f"{s}{'' if f is None else ', ' + f}": [
        r["ate_rmse_m"] for r in runs if r["schedule"] == s and r["fault"] == f]
        for s in opts.schedules for f in [None] + (opts.faults if opts.pipeline else [])}
    print(json.dumps({"cam": [H, W], "pipeline": opts.pipeline, "bound": opts.bound,
                      "ate_rmse_m": summary}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as fh:
        json.dump({"args": vars(opts), "runs": runs, "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
