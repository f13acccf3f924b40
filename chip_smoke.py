#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as a check of a checkout
    python3 chip_smoke.py --quick    # build + kernel check only

Builds the port's CUDA kernel from ``evennicer_slam_tpu_torch/csrc`` into
``build/``, holds it against its plain PyTorch version on the card, then
drives the port's main path at the full width of the shipped configuration
(``configs/nice_slam.yaml``, Replica camera 680x1200, the bench scene's
bound): ``tracking_loss`` scored for a few camera poses — the 0.15-scale
render through the fused decode, EventNet from
``pretrained/eventnet_mapdomain.npz``, the RGB-D and event losses — and one
whole-image ``Renderer.render_img``. Scene grids and decoders are random,
from a seed; the frame is made from a seed on the host.

Every phase that fails ends the run with a non-zero exit code. Without a CUDA
device the script exits non-zero and prints no result. Output, last three
lines: one JSON object ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; the port runs on a GPU\n")
    sys.exit(1)

from evennicer_slam_tpu_torch.config import (  # noqa: E402
    default_config_path,
    load_config,
    update_recursive,
)
from evennicer_slam_tpu_torch.core.bounds import (  # noqa: E402
    normalize_3d_coordinate,
    ray_bound_exit,
)
from evennicer_slam_tpu_torch.core.quaternion import pose_matrix_from_tensor  # noqa: E402
from evennicer_slam_tpu_torch.core.rays import get_rays, get_rays_rescale  # noqa: E402
from evennicer_slam_tpu_torch.models.decoders import (  # noqa: E402
    init_nice_decoders,
    pack_grids_for_tracking,
)
from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz  # noqa: E402
from evennicer_slam_tpu_torch.models.grids import init_grids  # noqa: E402
from evennicer_slam_tpu_torch.ops import cuda_build, fused_decode  # noqa: E402
from evennicer_slam_tpu_torch.ops.grid_sample import packed_rows_and_frac  # noqa: E402
from evennicer_slam_tpu_torch.ops.resize import resize_bilinear, resize_nearest  # noqa: E402
from evennicer_slam_tpu_torch.render.renderer import (  # noqa: E402
    Renderer,
    RenderSettings,
    render_rays,
)
from evennicer_slam_tpu_torch.slam.camera import Camera  # noqa: E402
from evennicer_slam_tpu_torch.slam.tracker import TrackerConfig, tracking_loss  # noqa: E402
from evennicer_slam_tpu_torch.utils.runtime import setup_torch  # noqa: E402

SEED = 0
BOUND = np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)
# Kernel against plain version: atol = rtol = 5e-3, the JAX package's own
# tolerance for its kernel against its XLA path. Features and sine arguments
# are bit-identical on both sides; what differs is the order of the f32 sums
# inside the MLP products. Now and then that flips the bf16 rounding of one
# hidden unit (one part in 256 of that unit), and the flip travels to the
# output. So at the main-path size (3.5 million values) up to one value in
# 100,000 may lie outside that tolerance, and every value must lie within
# ten times it; at N = 1,500 every value lies within it.
ATOL = RTOL = 5e-3
OUTLIER_SHARE = 1e-5
OUTLIER_FACTOR = 10.0
# the composited 102x180 image: per-point differences average out along a
# ray, but a flip in an occupancy near a surface moves that ray's weights
IMG_ATOL = 2e-2
N_SMALL = 1500
N_MAIN = 102 * 180 * 48  # 881,280 points: one 0.15-scale tracking render

# published peaks of one H100 SXM (dense): device memory, bf16 tensor cores,
# f32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# per point: multiply-adds of the three MLPs with bf16 operands, and the f32
# work (embedding product 3x279, corner reduction 8x96)
MLP_MACS = (2 * 93 * 32 + 4 * 32 * 32 + 5 * 32 * 32 + 32 * 1) \
    + (2 * 93 * 32 + 4 * 32 * 32 + 5 * 64 * 32 + 32 * 1) \
    + (2 * 93 * 32 + 4 * 32 * 32 + 5 * 32 * 32 + 32 * 4)
F32_MACS = 3 * 279 + 8 * 96
BYTES_PER_POINT = 3 * 12 + 512 + 1024 + 16


def say(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters, warmup=1):
    """Mean device time of ``fn()`` in ms over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_bound(n, param_bytes):
    """Least time in ms the card could take for the decode of ``n`` points:
    each input read once and the output written once at the memory rate,
    against the operations at the peak rate for their type."""
    t_bytes = (n * BYTES_PER_POINT + param_bytes) / PEAK_BYTES_S
    t_ops = n * (2 * MLP_MACS / PEAK_BF16_FLOPS + 2 * F32_MACS / PEAK_F32_FLOPS)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, 1e3 * t_bytes, 1e3 * t_ops


def make_scene(dev):
    """Full-width grids (noise added so the features matter), decoders,
    packed snapshot."""
    cfg = load_config(default_config_path(nice=True))
    gen = torch.Generator().manual_seed(SEED)
    grids = init_grids(gen, BOUND, cfg["grid_len"], cfg["model"]["c_dim"],
                       coarse=False, device=dev)
    grids = {k: v + 0.3 * torch.randn(v.shape, generator=gen).to(dev)
             for k, v in grids.items()}
    decoders = init_nice_decoders(gen, c_dim=cfg["model"]["c_dim"],
                                  coarse=False, device=dev)
    return cfg, grids, decoders, pack_grids_for_tracking(grids)


def decode_inputs(packed, bound_t, n, dev, seed):
    """n query points in and slightly around the bound, with their gathered
    rows and fractions, as nice_forward_packed makes them."""
    rng = np.random.default_rng(seed)
    half = (BOUND[:, 1] - BOUND[:, 0]) / 2
    p = torch.from_numpy(
        (rng.uniform(-1.1, 1.1, (n, 3)) * half).astype(np.float32)).to(dev)
    p_nor = normalize_3d_coordinate(p, bound_t)
    rows_m, frac_m = packed_rows_and_frac(packed["middle_packed"], p_nor)
    rows_f, frac_f = packed_rows_and_frac(packed["fc_packed"], p_nor)
    return p, frac_m, frac_f, rows_m, rows_f


def check_kernel(decoders, packed, bound_t, n, dev, iters, plain_iters):
    args = decode_inputs(packed, bound_t, n, dev, seed=SEED + n)
    with torch.no_grad():
        out = fused_decode.fused_decode_packed(decoders, *args)
        torch.cuda.synchronize()
        ref = fused_decode.fused_decode_packed_plain(decoders, *args)
        torch.cuda.synchronize()
        if out.shape != (n, 4) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"kernel output at N={n}: bad shape or non-finite")
        err = (out - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        n_bad = int((err > ATOL + RTOL * ref.abs()).sum())
        n_far = int((err > OUTLIER_FACTOR * (ATOL + RTOL * ref.abs())).sum())
        allowed = int(OUTLIER_SHARE * out.numel())  # 0 at N = 1,500
        rel_norm = float((out - ref).norm() / ref.norm())
        w16, f32 = fused_decode.pack_trio_weights(decoders)
        ms = cuda_ms(lambda: fused_decode.fused_decode_packed(decoders, *args), iters)
        kernel_only_ms = cuda_ms(
            lambda: fused_decode.launch_fused_decode_fwd(*args, w16, f32), iters)
        plain_ms = cuda_ms(
            lambda: fused_decode.fused_decode_packed_plain(decoders, *args),
            plain_iters)
    param_bytes = w16.numel() * 2 + f32.numel() * 4
    bound_ms, bound_by, t_bytes, t_ops = decode_bound(n, param_bytes)
    res = {
        "n": n, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "rel_norm_err": rel_norm, "outside_tolerance": n_bad,
        "outside_allowed": allowed, "outside_10x_tolerance": n_far,
        "atol": ATOL, "rtol": RTOL, "ms": ms, "kernel_only_ms": kernel_only_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
    }
    say(f"kernel vs plain at N={n}: " + json.dumps(res))
    if n_bad > allowed or n_far:
        raise RuntimeError(
            f"kernel disagrees with its plain version at N={n}: {n_bad} values "
            f"outside atol={ATOL} rtol={RTOL} ({allowed} allowed), {n_far} outside "
            f"{OUTLIER_FACTOR:g} times that (max abs {max_abs:.3e})")
    return res


def make_frame(cam, bound_t, dev):
    """A Replica-shaped frame from a seed: the depth image is what the
    camera sees of a box 0.9 times the scene bound (so every surface lies
    inside the bound); colour, previous colour and events are smooth random
    images made with numpy on the host."""
    rng = np.random.default_rng(SEED + 1)
    H, W = cam.H, cam.W
    # camera near the middle of the room, looking down -z, turned a little
    true_pose = torch.tensor([0.995, 0.02, 0.09, 0.01, 0.1, -0.05, 0.4], device=dev)
    c2w = pose_matrix_from_tensor(true_pose)
    rays_o, rays_d = get_rays(H, W, cam.fx, cam.fy, cam.cx, cam.cy, c2w)
    depth = ray_bound_exit(rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                           bound_t * 0.9).reshape(H, W)

    def smooth(c, lo=(17, 30)):
        small = torch.from_numpy(rng.random((*lo, c), dtype=np.float32)).to(dev)
        return resize_bilinear(small, (H, W))

    color = smooth(3)
    prev_color = (color + 0.05 * (smooth(3) - 0.5)).clamp(0.0, 1.0)
    # event counts by polarity: sparse, non-negative
    ev = torch.from_numpy(
        (rng.random((H, W, 2)) < 0.05).astype(np.float32)
        * rng.integers(1, 4, (H, W, 2)).astype(np.float32)).to(dev)
    return true_pose, color, prev_color, depth, ev


def main_path_inputs(cfg, bound_t, dev):
    """Everything ``tracking_loss`` needs at full width: the bench workload's
    event settings on top of the shipped config, the Replica camera, EventNet
    from the shipped weights, the seeded frame and its per-frame event inputs
    as the tracker prepares them (nearest for the events, the previous colour
    and the mask, bilinear for the depth prior)."""
    update_recursive(cfg, {
        "event": {"rgbd_every_frame": 5, "activate_events": True,
                  "balancer": 0.025, "scale_factor": 0.15, "blur": True,
                  "kernel_sizes": [9], "unblurred_weight": 0,
                  "kernel_weights": [1]},
        "tracking": {"ignore_edge_W": 100, "ignore_edge_H": 100},
    })
    cam = Camera.from_cfg(cfg)
    tcfg = TrackerConfig.from_cfg(cfg, use_events=True)
    settings = RenderSettings.from_cfg(cfg)._replace(fused_decode=True)
    eventnet = load_eventnet_npz(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "pretrained",
                     "eventnet_mapdomain.npz"), device=dev)
    true_pose, color, prev_color, depth, ev = make_frame(cam, bound_t, dev)
    lo_hw = (int(cam.H * tcfg.scale_factor), int(cam.W * tcfg.scale_factor))
    return SimpleNamespace(
        cam=cam, tcfg=tcfg, settings=settings, eventnet=eventnet,
        true_pose=true_pose, color=color, depth=depth, lo_hw=lo_hw,
        gt_event_lo=resize_nearest(ev, lo_hw),
        prev_color_lo=resize_nearest(prev_color, lo_hw),
        gt_depth_lo_flat=resize_bilinear(depth, lo_hw).reshape(-1),
        gt_mask_lo=resize_nearest((ev != 0).any(dim=-1).to(torch.float32), lo_hw),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build the kernel and check it against its plain "
                         "version, then stop (prints no result line)")
    opts = ap.parse_args()
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device ------------------------------------------------------
    smi = nvidia_smi_line()
    say(f"device: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    flags = setup_torch(verbose=False)
    say(f"TF32: matmul allow_tf32={flags['matmul_allow_tf32']}, "
        f"cudnn allow_tf32={flags['cudnn_allow_tf32']}; "
        f"cudnn benchmark={flags['cudnn_benchmark']}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = fused_decode.kernel_library()
    build_s = time.perf_counter() - t0
    log = cuda_build.BUILD_LOG["fused_decode"]
    say(f"built {log['lib']} in {build_s:.1f} s (set-up); tile "
        f"{lib.fused_decode_tile()} points, {lib.fused_decode_smem_bytes()} B "
        f"of shared memory per block")
    for line in str(log["ptxas"]).splitlines():
        if "registers" in line or "spill" in line or "warning" in line.lower():
            say("  ptxas: " + line.strip())

    # ---- 3. the kernel against its plain version ---------------------------
    cfg, grids, decoders, packed = make_scene(dev)
    bound_t = torch.from_numpy(BOUND).to(dev)
    if not fused_decode.supports(decoders):
        raise RuntimeError("the shipped decoder trio must be supported by the kernel")
    small = check_kernel(decoders, packed, bound_t, N_SMALL, dev, iters=20, plain_iters=5)
    main_res = check_kernel(decoders, packed, bound_t, N_MAIN, dev,
                            iters=3 if opts.quick else 10, plain_iters=2)
    if opts.quick:
        say(f"quick check done in {time.perf_counter() - t_start:.1f} s")
        return

    # ---- 4. the main path: tracking_loss at full width ---------------------
    mp = main_path_inputs(cfg, bound_t, dev)
    cam, tcfg, settings, eventnet = mp.cam, mp.tcfg, mp.settings, mp.eventnet
    true_pose, color, depth, lo_hw = mp.true_pose, mp.color, mp.depth, mp.lo_hw
    gt_event_lo, prev_color_lo = mp.gt_event_lo, mp.prev_color_lo
    gt_depth_lo_flat, gt_mask_lo = mp.gt_depth_lo_flat, mp.gt_mask_lo
    if lo_hw[0] * lo_hw[1] * (settings.n_samples + settings.n_surface) != N_MAIN:
        raise RuntimeError(f"low-resolution render {lo_hw} is not the main-path size")

    poses = [true_pose + d for d in (
        torch.zeros(7, device=dev),
        torch.tensor([0, 0.002, -0.001, 0.001, 0.01, -0.005, 0.008], device=dev),
        torch.tensor([0, -0.004, 0.003, 0.002, -0.02, 0.01, -0.015], device=dev),
    )]
    gen = torch.Generator().manual_seed(SEED + 2)

    def score(pose, rgbd):
        with torch.no_grad():
            total, aux = tracking_loss(
                pose, decoders, packed, eventnet, bound_t, color, depth,
                gt_event_lo, prev_color_lo, gt_depth_lo_flat, gt_mask_lo,
                tcfg, cam, settings, rgbd=rgbd, event=True, generator=gen)
        torch.cuda.synchronize()
        return total, aux

    score(poses[0], True)  # warm-up: cuDNN picks its algorithms here
    fused_decode.fused_decode_packed.launches = 0
    results = []
    for rgbd in (False, True):
        for i, pose in enumerate(poses):
            t0 = time.perf_counter()
            total, aux = score(pose, rgbd)
            ms = 1e3 * (time.perf_counter() - t0)
            vals = {"total": float(total), **{k: float(v) for k, v in aux.items()}}
            want = {"event", "event_corr", "event_gt_energy", "mask"} | (
                {"rgbd"} if rgbd else set())
            if set(aux) != want or not all(math.isfinite(v) for v in vals.values()):
                raise RuntimeError(f"tracking_loss pose {i} rgbd={rgbd}: {vals}")
            results.append((rgbd, i, ms, vals))
            say(f"tracking_loss pose {i} {'rgbd+event' if rgbd else 'event only'}: "
                f"{ms:.2f} ms  " + json.dumps(vals))
    launches_main = fused_decode.fused_decode_packed.launches
    expected = len(poses) * 1 + len(poses) * 2
    say(f"fused decode launches on the main path: {launches_main} "
        f"(expected {expected}: 1 per event-only score, 2 per RGB-D + event score)")
    if launches_main != expected:
        raise RuntimeError("the main path did not go through the kernel as expected")
    if not (results[0][3]["total"] < results[1][3]["total"] or
            results[0][3]["total"] < results[2][3]["total"]):
        say("note: the unperturbed pose does not score lowest (random scene: "
            "the map was never fitted to the frame)")

    # the rendered 102x180 image through the kernel against the same path
    # forced through the plain version
    def lo_render():
        c2w = pose_matrix_from_tensor(poses[0])
        ro, rd = get_rays_rescale(cam.H, cam.W, lo_hw[0], lo_hw[1],
                                  cam.fx, cam.fy, cam.cx, cam.cy, c2w)
        with torch.no_grad():
            d, v, c = render_rays(decoders, packed, ro.reshape(-1, 3),
                                  rd.reshape(-1, 3), bound_t, "color", settings,
                                  gt_depth=gt_depth_lo_flat)
        torch.cuda.synchronize()
        return d.reshape(lo_hw), c.reshape(*lo_hw, 3)

    d_k, c_k = lo_render()
    kernel_fn = fused_decode.fused_decode_packed
    fused_decode.fused_decode_packed = fused_decode.fused_decode_packed_plain
    try:
        d_p, c_p = lo_render()
    finally:
        fused_decode.fused_decode_packed = kernel_fn
    img_err = float((c_k - c_p).abs().max())
    depth_err = float((d_k - d_p).abs().max())
    say(f"rendered {lo_hw[0]}x{lo_hw[1]} image, kernel path vs plain path: colour "
        f"max abs err {img_err:.3e} (mean {float((c_k - c_p).abs().mean()):.3e}), "
        f"depth max abs err {depth_err:.3e} (mean "
        f"{float((d_k - d_p).abs().mean()):.3e}); tolerance {IMG_ATOL} on the max")
    if not (img_err <= IMG_ATOL and depth_err <= IMG_ATOL
            and bool(torch.isfinite(c_k).all())):
        raise RuntimeError("the rendered image disagrees with the plain path")

    # ---- 5. one whole image --------------------------------------------------
    renderer = Renderer(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy, BOUND,
                        settings, device=dev)
    c2w = pose_matrix_from_tensor(poses[0])
    img_ms = []
    for _ in range(2):  # the first call also pays for the allocator's growth
        fused_decode.fused_decode_packed.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            d_img, v_img, c_img = renderer.render_img(decoders, packed, c2w, "color",
                                                      gt_depth=depth)
        torch.cuda.synchronize()
        img_ms.append(1e3 * (time.perf_counter() - t0))
    launches_img = fused_decode.fused_decode_packed.launches
    n_chunks = -(-cam.H * cam.W // renderer.ray_chunk)
    ok_img = (c_img.shape == (cam.H, cam.W, 3) and d_img.shape == (cam.H, cam.W)
              and bool(torch.isfinite(c_img).all()) and bool(torch.isfinite(d_img).all())
              and bool(torch.isfinite(v_img).all()))
    say(f"render_img {cam.H}x{cam.W}: first call {img_ms[0]:.1f} ms, second "
        f"{img_ms[1]:.1f} ms, {launches_img} fused decode "
        f"launches ({n_chunks} chunks of {renderer.ray_chunk} rays), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, finite={ok_img}")
    if not ok_img or launches_img != n_chunks:
        raise RuntimeError("whole-image render failed")

    # ---- result ---------------------------------------------------------------
    ev_ms = [r[2] for r in results if not r[0]]
    rgbd_ms = [r[2] for r in results if r[0]]
    say(f"tracking_loss forward: event only {min(ev_ms):.2f} ms (best of "
        f"{len(ev_ms)}), rgbd+event {min(rgbd_ms):.2f} ms; total run "
        f"{time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "fused_decode_fwd",
        "route": "cuda",
        "source": "evennicer_slam_tpu_torch/csrc/fused_decode.cu",
        "replaces": "evennicer_slam_tpu/ops/fused_decode.py:177",
        "launches": launches_main,
        "max_abs_err": max(main_res["max_abs_err"], small["max_abs_err"]),
        "ms": main_res["ms"],
        "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "library_ms": None,
        "n_points": N_MAIN,
        "kernel_only_ms": main_res["kernel_only_ms"],
        "launches_render_img": launches_img,
        "small": small,
    }]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
