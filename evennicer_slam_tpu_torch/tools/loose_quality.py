"""Quality cost of the loose schedule's mapping cadence (counterpart of
``evennicer_slam_tpu/tools/loose_quality.py``).

The loose configuration with a track / map split of 6 / 2 maps at the
cadence the map group sustains, not every fifth frame. This tool measures
what that costs in trajectory quality on the synthetic validation scene,
three ways:

- ``strict5``: the reference's default schedule (every_frame = 5),
- ``strict7``: the same with every_frame = 7, the cadence the JAX package's
  loose headline sustained, applied deterministically,
- ``loose``: the concurrent loose schedule, the map group two of eight
  slots (its cadence comes from completion gating, so it depends on timing
  like the reference's own loose mode).

Each row runs ``--seeds`` initialisations of the scene state; ATE RMSE mean
+/- std per row goes to ``--out``. Every row runs on eight slots of
``--device`` (``parallel/sharding.py``): on one card they measure the
schedule, not overlap between cards.

Usage:
    python -m evennicer_slam_tpu_torch.tools.loose_quality [--frames 40]
        [--device cuda|cpu] [--out build/loose_quality.json]
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np

SLOTS = 8


def build_cfg(scene_dir: str, frames: int, seed: int):
    from evennicer_slam_tpu_torch.config import (
        default_config_path,
        load_config,
        update_recursive,
    )
    from evennicer_slam_tpu_torch.data.synthetic import make_synthetic_replica

    frag = make_synthetic_replica(
        scene_dir, n_frames=frames, H=64, W=80, fx=60.0, fy=60.0,
        traj_step=0.02, reuse_if_current=True,
    )
    frag["dataset"] = "replica"  # RGB-D mode: the headline workload
    cfg = load_config(default_config_path(nice=True))
    update_recursive(cfg, frag)
    update_recursive(cfg, {
        "verbose": False,
        "coarse": True,
        "seed": seed,
        "enable_vis": False,
        "mapping": {
            "iters_first": 300, "iters": 60, "every_frame": 5,
            "pixels": 500, "mapping_window_size": 5, "keyframe_every": 5,
            "mesh_freq": 10**9, "ckpt_freq": 10**9, "color_refine": False,
            "keyframe_catchup": True,
        },
        "tracking": {"iters": 10, "pixels": 200,
                     "ignore_edge_W": 4, "ignore_edge_H": 4},
        "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                     "bound_divisible": 0.2},
        "meshing": {"eval_rec": False},
        "data": {"output": os.path.join(scene_dir, "out_lq")},
    })
    return cfg


def run_one(cfg, device: str = "cuda"):
    """One row's run on SLOTS slots of ``device``: (ATE RMSE, the pipeline)."""
    from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
    from evennicer_slam_tpu_torch.tools.eval_ate import evaluate_ate

    slam = EvenNICERSLAM(cfg, nice=True, device=device, devices=[device] * SLOTS)
    est = slam.run(mesh=False, checkpoint=False)
    n = slam.n_img
    res = evaluate_ate(
        np.asarray(est)[:n, :3, 3], np.asarray(slam.gt_c2w_list)[:n, :3, 3]
    )
    return float(res["absolute_translational_error.rmse"]), slam


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scene", default=os.path.join("build", "loose_quality_scene"))
    ap.add_argument("--out", default=os.path.join("build", "loose_quality.json"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every slot (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        from evennicer_slam_tpu_torch.utils.runtime import setup_torch

        setup_torch(verbose=False)

    results = {"frames": args.frames, "device": args.device, "slots": SLOTS, "configs": {}}
    for name in ("strict5", "strict7", "loose"):
        rows = []
        for seed in args.seeds:
            cfg = build_cfg(args.scene, args.frames, seed)
            if name == "strict7":
                cfg["mapping"]["every_frame"] = 7
            elif name == "loose":
                cfg = copy.deepcopy(cfg)
                cfg["sync_method"] = "loose"
                cfg["parallel"] = dict(cfg.get("parallel", {}),
                                       map_devices=2, data_parallel=1)
            rmse, slam = run_one(cfg, args.device)
            row = {"seed": seed, "ate_rmse_m": rmse}
            if name == "loose":
                row["concurrent"] = bool(slam.concurrent)
                row["n_maps"] = int(slam.n_concurrent_maps)
                row["n_frames"] = int(slam.n_img)
            rows.append(row)
            print(f"[{name} seed {seed}] ATE RMSE {rmse:.4f} m", flush=True)
        vals = [r["ate_rmse_m"] for r in rows]
        results["configs"][name] = {
            "runs": rows,
            "ate_rmse_mean_m": float(np.mean(vals)),
            "ate_rmse_std_m": float(np.std(vals)),
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
