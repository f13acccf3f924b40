"""Event-branch ablation: does event tracking beat dead reckoning?
(counterpart of ``evennicer_slam_tpu/tools/event_ablation.py``)

The system's namesake capability is tracking frames that have NO RGB-D
(``rgbd_every_frame=5``) with the EventNet loss. This tool measures it on
the synthetic scene over a grid of variants (ATE RMSE against the ground
truth, optionally over several trajectory seeds with mean +- std):

  A  dead reckoning       - event loss computed but NOT optimized; non-RGB-D
                            frames keep constant-speed extrapolation.
  B  events (GT-trained)  - net trained on GT-GT intensity pairs (needs
                            --with_gt_variant).
  C  events (map-domain)  - reference behaviour: net trained on
                            (map-render, GT-event) triples, best pose by the
                            event loss.
  C' C with best pose by RGB-D on RGB-D frames.
  D  events optimized only on non-RGB-D frames.
  E  D + event-bias self-calibration (event.bias_correction).
  E' E with window-scaled bias (event.bias_scale_mode: window).
  F  C + bias calibration.
  O  the analytic ESIM predictor in place of the UNet (a bound, not a mode);
  R  RGB-D on every frame (the anchor, not a mode); H* the event loss at
     scale 0.25.

Without ``--net`` it first trains the map-domain net (``models/
eventnet_train.py``) and writes it to ``--out``. A regenerated net goes
there (default under ``build/``), never over the shipped
``pretrained/eventnet_mapdomain.npz``. Runs on the CUDA device unless
``--device cpu`` is given.

Usage:
    python -m evennicer_slam_tpu_torch.tools.event_ablation \
        [--frames 26] [--hw 240 320] [--seeds 3] [--train_steps 300] \
        [--out build/eventnet_mapdomain.npz] [--net <trained.npz>] \
        [--variants A_dead_reckoning C_events_reference] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

SCENE_BOUND = np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)


def build_cfg(scene_dir: str, n_frames: int, H: int, W: int,
              traj_jitter: float = 0.004, traj_seed: int = 7,
              keyframe_every: int = None, traj_step: float = 0.015):
    """Write the ablation's scene to ``scene_dir`` and return its
    configuration: ``configs/nice_slam.yaml`` with the scene and the event
    settings of the JAX tool."""
    from evennicer_slam_tpu_torch.config import (
        default_config_path,
        load_config,
        update_recursive,
    )
    from evennicer_slam_tpu_torch.data.synthetic import make_synthetic_replica

    # traj_jitter adds per-frame pose noise: real camera motion has jerk,
    # and without it constant-speed dead reckoning is a near-perfect oracle
    # on the synthetic orbit
    frag = make_synthetic_replica(
        scene_dir, n_frames=n_frames, H=H, W=W, fx=0.5 * W, fy=0.5 * W,
        bound=SCENE_BOUND.copy(),
        traj_step=traj_step, traj_jitter=traj_jitter, traj_seed=traj_seed,
    )
    cfg = load_config(default_config_path(nice=True))
    update_recursive(cfg, frag)
    update_recursive(cfg, {
        "verbose": False,
        "enable_vis": False,
        "event": {
            "pretrained_path": "/nonexistent",
            "rgbd_every_frame": 5, "activate_events": True, "balancer": 0.025,
            "scale_factor": 0.15, "blur": True, "kernel_sizes": [9],
            "unblurred_weight": 0, "kernel_weights": [1],
        },
        "tracking": {"ignore_edge_W": 20, "ignore_edge_H": 20},
        # the first frame keeps the shipped 1500-iteration call: the event
        # branch renders the current view from the map, and a half-built
        # first map poisons every early event loss
        "mapping": {"mesh_freq": 10**9, "ckpt_freq": 10**9},
        "data": {"output": os.path.join(scene_dir, "out")},
    })
    if keyframe_every is not None:
        # sequences much longer than 26 frames sweep more of the orbit than
        # keyframe_every=50 was tuned for: denser keyframes keep the overlap
        # selector anchored
        cfg["mapping"]["keyframe_every"] = keyframe_every
    return cfg


# variant grid: name -> (activate_events, best_pose_criterion, extra event cfg)
VARIANTS = {
    "A_dead_reckoning": (False, "rgbd", {}),
    # RGB-D loss on EVERY frame, no event optimization: what the tracker
    # achieves when it never has to coast between anchors
    "R_full_rgbd_anchor": (False, "rgbd", {"rgbd_every_frame": 1}),
    "C_events_reference": (True, "event", {}),
    # the analytic ESIM predictor: on the synthetic scene the GT events ARE
    # gain * (I2 - I1) split by polarity, the ceiling of any trained net
    "O_esim_oracle": (True, "event", {"predictor": "esim"}),
    # the event loss at 0.25 scale (2.8x the pixels), with the esim predictor
    "H_hires_events": (True, "event",
                       {"scale_factor": 0.25, "predictor": "esim"}),
    # as H, the event weight normalised per pixel: 0.025 * (0.15/0.25)^2
    "H2_hires_balanced": (True, "event",
                          {"scale_factor": 0.25, "predictor": "esim",
                           "balancer": 0.009}),
    # H2 with the UNet: needs a net TRAINED at 0.25 scale (--train_scale 0.25
    # or --net <0.25-trained.npz>)
    "H2u_hires_unet": (True, "event",
                       {"scale_factor": 0.25, "balancer": 0.009}),
    "Cp_rgbd_criterion": (True, "rgbd", {}),
    "D_non_rgbd_only": ("non_rgbd", "rgbd", {}),
    "E_bias_const": ("non_rgbd", "rgbd", {"bias_correction": True}),
    "Ep_bias_window": ("non_rgbd", "rgbd",
                       {"bias_correction": True, "bias_scale_mode": "window"}),
    "F_reference_plus_bias": (True, "event", {"bias_correction": True}),
    # EMA-damped bias: the probe averaged across boundaries, applied at half
    # strength, window-scaled
    "E2_bias_ema_damped": ("non_rgbd", "rgbd",
                           {"bias_correction": True, "bias_ema": 0.7,
                            "bias_alpha": 0.5,
                            "bias_scale_mode": "window"}),
}


def summarize(per_seed, seeds, frames):
    """Per-variant mean/std plus events-vs-dead-reckoning flags. Comparison
    flags are emitted only when both sides were measured (a --variants
    subset must not claim a comparison that never ran)."""
    summary = {
        name: {
            "mean": float(np.mean(v)),
            "std": float(np.std(v)),
            "runs": [round(x, 5) for x in v],
        }
        for name, v in per_seed.items()
    }
    # deployable event modes only: the O_* oracle is a bound and R_* the
    # full-RGB-D anchor; neither may set best_event_mode or the flags
    ev_means = {n: s["mean"] for n, s in summary.items()
                if not n.startswith(("A_", "O_", "R_"))}
    best = min(ev_means, key=ev_means.get) if ev_means else None
    out = {
        "summary": summary,
        "seeds": seeds,
        "frames": frames,
        "best_event_mode": best,
    }
    oracle = [n for n in summary if n.startswith("O_")]
    if oracle:
        out["oracle_bound_mean"] = {n: summary[n]["mean"] for n in oracle}
    if "A_dead_reckoning" in summary:
        dr = summary["A_dead_reckoning"]["mean"]
        if "C_events_reference" in summary:
            out["events_beat_dead_reckoning_reference"] = bool(
                summary["C_events_reference"]["mean"] < dr)
        if best is not None:
            out["events_beat_dead_reckoning_any_mode"] = bool(
                ev_means[best] < dr)
    return out


def run_variant(cfg, eventnet, n_frames: int, activate, criterion: str,
                extra_event_cfg=None, device=None):
    """One pipeline run over ``n_frames`` frames with the variant's event
    settings; returns its ATE RMSE in metres.

    ``eventnet`` replaces the pipeline's net in the pipeline and the tracker
    only, as the JAX tool assigns it: the mapper keeps the net it was built
    with (a random one under ``pretrained_path: /nonexistent``), which only a
    configuration with ``mapping.use_events`` reads (ROADMAP Queue 3)."""
    from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
    from evennicer_slam_tpu_torch.tools.eval_ate import evaluate_ate

    cfg = copy.deepcopy(cfg)
    cfg["event"]["activate_events"] = activate
    cfg["event"]["best_pose_criterion"] = criterion
    for k, v in (extra_event_cfg or {}).items():
        cfg["event"][k] = v
    slam = EvenNICERSLAM(cfg, nice=True, device=device)
    if eventnet is not None:
        slam.eventnet = eventnet
        slam.tracker.eventnet = eventnet
    if not slam.use_events:
        raise RuntimeError("the ablation's scene has no event frames")
    slam.run(end_frame=n_frames, mesh=False, checkpoint=False)
    est = slam.estimate_c2w_list[:n_frames]
    gt = slam.gt_c2w_list[:n_frames]
    res = evaluate_ate(est[:, :3, 3], gt[:, :3, 3])
    return float(res["absolute_translational_error.rmse"])


def gt_render(cam):
    """``c2w -> (color, depth)``: the analytic render of the ablation's room
    with ``cam``'s intrinsics, for perturbed-pose triples."""
    from evennicer_slam_tpu_torch.data.synthetic import render_box_views

    def fn(c2w):
        return render_box_views(c2w, cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                                cam["cy"], SCENE_BOUND)
    return fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=26)
    parser.add_argument("--hw", type=int, nargs=2, default=(240, 320))
    parser.add_argument("--scene", default=os.path.join("build", "event_ablation"))
    # a regenerated net never goes over the shipped pretrained/ blob
    parser.add_argument("--out", default=os.path.join("build", "eventnet_mapdomain.npz"))
    parser.add_argument("--train_steps", type=int, default=300)
    parser.add_argument("--traj_jitter", type=float, default=0.004)
    parser.add_argument("--seeds", type=int, default=1,
                        help="number of trajectory-jitter seeds (mean+-std)")
    parser.add_argument("--with_gt_variant", action="store_true",
                        help="also train+run the GT-GT variant (B)")
    parser.add_argument("--skip_gt_variant", action="store_true",
                        help="(default; kept for CLI compatibility)")
    parser.add_argument("--variants", nargs="*", default=None,
                        help=f"subset of {list(VARIANTS)} (default: all)")
    parser.add_argument("--net", default=None,
                        help="load this .npz and skip all training")
    parser.add_argument("--keyframe_every", type=int, default=None)
    parser.add_argument("--train_scale", type=float, default=None,
                        help="override event.scale_factor for NET TRAINING"
                             " only (e.g. 0.25 to train the H2u net; the variant"
                             " grid still sets its own scale_factor)")
    parser.add_argument("--traj_step", type=float, default=0.015,
                        help="orbit angle per frame; for sequences longer"
                             " than 26 frames scale it down (0.015*26/frames)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    unknown = [n for n in (args.variants or []) if n not in VARIANTS]
    if unknown:
        parser.error(f"unknown --variants {unknown}; choose from {list(VARIANTS)}")

    from evennicer_slam_tpu_torch.models.eventnet_train import (
        load_eventnet_npz,
        save_eventnet_npz,
        train_eventnet,
        train_eventnet_map_domain,
    )
    from evennicer_slam_tpu_torch.utils.runtime import resolve_device, setup_torch

    device = resolve_device(None if args.device == "cuda" else args.device)
    if device.type == "cuda":
        setup_torch(verbose=False)

    H, W = args.hw
    seeds = [7 + 1000 * i for i in range(max(1, args.seeds))]
    cfg0 = build_cfg(args.scene, args.frames, H, W,
                     traj_jitter=args.traj_jitter, traj_seed=seeds[0],
                     keyframe_every=args.keyframe_every,
                     traj_step=args.traj_step)

    names = args.variants or list(VARIANTS)
    # A_* never runs the net and O_* uses the analytic predictor
    needs_net = any(not n.startswith(("A_", "O_")) for n in names)

    # --- net: load or train once (on the first seed's scene) -------------
    net_md = None
    if not needs_net:
        pass
    elif args.net:
        net_md = load_eventnet_npz(args.net, device=device)
    else:
        bound = np.array(cfg0["mapping"]["bound"], np.float32)
        init = None
        if args.with_gt_variant:
            net_gt = train_eventnet(steps=args.train_steps, batch=4,
                                    hw=(int(H * 0.15), int(W * 0.15)),
                                    bound=bound, seed=0, verbose=True, device=device)
            ate_b = run_variant(cfg0, net_gt, args.frames, True, "event", device=device)
            print(json.dumps({"variant": "B events (GT-GT trained)",
                              "ate_rmse_m": ate_b}), flush=True)
            init = net_gt

        t0 = time.perf_counter()
        cfg_train = cfg0
        if args.train_scale is not None:
            # map_domain_pairs reads event.scale_factor for its low-res size
            cfg_train = copy.deepcopy(cfg0)
            cfg_train["event"]["scale_factor"] = args.train_scale
        net_md = train_eventnet_map_domain(
            cfg_train,
            steps=args.train_steps if init is not None else 2 * args.train_steps,
            n_map_frames=args.frames, n_pairs=128,
            init_params=init, seed=0,
            perturb_trans=0.01, perturb_rot=0.005, gt_render_fn=gt_render(cfg0["cam"]),
            verbose=True, device=device,
        )
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            save_eventnet_npz(net_md, args.out)
        print(json.dumps({"net": args.out, "map_triples_train_s":
                          round(time.perf_counter() - t0, 2)}), flush=True)

    # --- variant grid x seeds -------------------------------------------
    per_seed = {name: [] for name in names}
    for seed in seeds:
        cfg = (cfg0 if seed == seeds[0] else build_cfg(
            args.scene + f"_s{seed}", args.frames, H, W,
            traj_jitter=args.traj_jitter, traj_seed=seed,
            keyframe_every=args.keyframe_every, traj_step=args.traj_step,
        ))
        for name in names:
            activate, criterion, extra = VARIANTS[name]
            net = None if name.startswith(("A_", "O_")) else net_md
            t0 = time.perf_counter()
            ate = run_variant(cfg, net, args.frames, activate, criterion, extra,
                              device=device)
            per_seed[name].append(ate)
            print(json.dumps({"variant": name, "seed": seed, "ate_rmse_m": round(ate, 5),
                              "s": round(time.perf_counter() - t0, 2)}), flush=True)

    print(json.dumps(summarize(per_seed, seeds, args.frames)), flush=True)


if __name__ == "__main__":
    main()
