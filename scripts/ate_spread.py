#!/usr/bin/env python3
"""The trajectory error of ``chip_smoke.py``'s map-and-track phase over
seeds, on one NVIDIA GPU.

    python3 scripts/ate_spread.py [--seeds 1 2 3 4] [--schedules every bench]
        [--scale 1.0] [--out build/ate_spread.json]

For each seed and schedule, runs ``chip_smoke.map_and_track`` (frames 0-25
of the furnished room, the first mapping call 300 iterations, a steady call
and a keyframe every fifth frame) with the map, the mapper's draws and the
tracker's draws started from that seed, and prints its ATE beside the RMSE
of a camera held at frame 0. Schedules: ``every`` (RGB-D + event on every
frame) and ``bench`` (event only, RGB-D every fifth frame). ``--scale`` cuts
the camera (focal lengths and the tracker's ignored edges with it), as
``tests/test_torch_map_and_track.py`` does for its CPU runs of both frameworks.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--schedules", nargs="+", default=["every", "bench"],
                    choices=["every", "bench"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="build/ate_spread.json")
    opts = ap.parse_args()
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
    frames = cs.room_frames(mp.cam, dev, cs.MAP_FRAMES)
    runs = []
    for seed in opts.seeds:
        for sched in opts.schedules:
            tcfg = mp.tcfg._replace(rgbd_every_frame=1) if sched == "every" else mp.tcfg
            _, res = cs.map_and_track(cfg, mp, dev, frames, tcfg, f"{sched}, seed {seed}",
                                      lambda held: np.inf, seed=seed)
            runs.append({"seed": seed, "schedule": sched, "cam": [H, W],
                         "ate_rmse_m": res["ate_rmse_m"],
                         "held_camera_rmse_m": res["held_camera_rmse_m"],
                         "err_mm_per_frame": res["err_mm_per_frame"]})
            print(json.dumps(runs[-1]), flush=True)
    summary = {s: [r["ate_rmse_m"] for r in runs if r["schedule"] == s] for s in opts.schedules}
    print(json.dumps({"cam": [H, W], "ate_rmse_m": summary}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as fh:
        json.dump({"args": vars(opts), "runs": runs, "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
