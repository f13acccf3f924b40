#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as a check of a checkout
    python3 chip_smoke.py --quick    # build + kernel check only

Builds the port's two CUDA kernels (fused decode forward and backward) from
``evennicer_slam_tpu_torch/csrc`` into ``build/``, side by side, holds each
against its plain PyTorch version on the card, then drives the port's main
paths at the full width of the shipped configuration
(``configs/nice_slam.yaml``, Replica camera 680x1200, the bench scene's
bound):
  - ``tracking_loss`` scored for a few camera poses — the 0.15-scale render
    through the fused decode, EventNet from
    ``pretrained/eventnet_mapdomain.npz``, the RGB-D and event losses — and
    one whole-image ``Renderer.render_img``;
  - the pose gradient of that score through the kernels against the same
    path through the plain versions;
  - six frames of the synthetic scene (``data/synthetic.py``) tracked through
    ``Tracker.track`` / ``end_of_window`` as the pipeline drives them: ten
    Adam steps a frame, forward and backward through the kernels, with the
    launches counted; one frame tracked again through the plain versions; one
    frame tracked against a render of the map itself (the map random);
  - mapping and tracking interleaved (``Mapper.optimize_map``) over frames
    0-25 of the furnished room: frame 0 mapped from its true pose (300
    iterations), frames 1-25 tracked on the fitted map, a steady mapping
    call (60 iterations, device pose, the coarse mapper fused, BA from the
    fifth keyframe) every fifth frame; the trajectory error (ATE) against
    the ground truth, the depth error of a render before and after the first
    call, the host synchronisations inside each steady call. Twice: the
    bench schedule, event only with RGB-D every fifth frame (its ATE held to
    the JAX package's on the same frames), and RGB-D + event on every frame
    (its ATE held below a camera held at frame 0);
  - one steady mapping call (K = 5, BA) through ``Mapper.optimize_map`` on
    the card twice (bitwise equal) and on the CPU from the same state with
    the same draws (within limits), and on the CPU with each of three faults
    planted (each outside the limits);
  - the pipeline from disk: the same furnished room written as a
    Replica-event scene under ``build/`` (``make_synthetic_replica``; phase
    10 reads its frames from it) and run through ``EvenNICERSLAM`` with
    ``bench.py``'s configuration: frames 0-5, ``preload_device`` of 6-31,
    four timed blocks of five frames each ending with its steady mapping
    call (frames per second of each block), one more block with the host
    synchronisations counted, then the sequence's end (the final colour
    refinement); the ATE, the kernels' launches and a checkpoint restored
    bit for bit; then ``EvenNICERSLAM.run`` over frames 0-25 with RGB-D +
    event on every frame, its ATE held below a camera held at frame 0.

Scene grids and decoders start random, from a seed; only the mapping phase
fits them. Every phase that fails ends the run with a non-zero exit code. Without a CUDA
device the script exits non-zero and prints no result. Output, last three
lines: one JSON object ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings
from types import SimpleNamespace

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; the port runs on a GPU\n")
    sys.exit(1)

from evennicer_slam_tpu_torch import convert  # noqa: E402
from evennicer_slam_tpu_torch.config import (  # noqa: E402
    default_config_path,
    load_config,
    update_recursive,
)
from evennicer_slam_tpu_torch.core.bounds import (  # noqa: E402
    normalize_3d_coordinate,
    ray_bound_exit,
)
from evennicer_slam_tpu_torch.core.quaternion import (  # noqa: E402
    pose_matrix_from_tensor,
    tensor_from_pose_matrix,
)
from evennicer_slam_tpu_torch.core.rays import (  # noqa: E402
    get_rays,
    get_rays_rescale,
    sample_pixels,
)
from evennicer_slam_tpu_torch.data.datasets import get_dataset  # noqa: E402
from evennicer_slam_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_replica,
    synthetic_frames,
)
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
from evennicer_slam_tpu_torch.slam import mapper as mapper_module  # noqa: E402
from evennicer_slam_tpu_torch.slam.mapper import Mapper, MapperConfig  # noqa: E402
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM  # noqa: E402
from evennicer_slam_tpu_torch.slam.tracker import (  # noqa: E402
    Tracker,
    TrackerConfig,
    _prep_event_inputs,
    track_frame,
    tracking_loss,
)
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger  # noqa: E402
from evennicer_slam_tpu_torch.utils.optim import tree_map  # noqa: E402
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
#
# Those counts were set for kernels that summed on the CUDA cores in the
# plain version's own order (sequential k, as cuBLAS sums these shapes), so
# most of their products were bit-identical to the plain version's. The
# tensor cores sum in another order, and the plain version is itself an
# approximation: against the same arithmetic with every product summed
# exactly and rounded once (exact_products), it lies outside the tolerance at
# more values than that allowance (69 of 3.5 million on an H100). So each
# check measures that distance, X values outside the tolerance and X10
# outside ten times it, on its own inputs, and holds the kernel to the
# tolerance with the allowance max(fixed allowance, 2 X) (and, beyond ten
# times it, max(fixed, 2 X10)), since two approximations of one function each
# X away may disagree at 2 X; and it requires the kernel to be no further from
# the exact arithmetic than the plain version plus the fixed allowance.
ATOL = RTOL = 5e-3
OUTLIER_SHARE = 1e-5
OUTLIER_FACTOR = 10.0
# the composited 102x180 image: per-point differences average out along a
# ray, but a flip in an occupancy near a surface moves that ray's weights
IMG_ATOL = 2e-2
# pose gradient (a 7-vector) through the kernels against the plain path
GRAD_REL_TOL = 1e-2
GRAD_COS_MIN = 0.999
# one frame tracked through the kernels and through the plain versions: the
# first iteration's event loss sees only the forward difference (relative)
TRACK_FIRST_LOSS_RTOL = 1e-3
N_TRACK_FRAMES = 7   # frame 0 seeds the window, 1..6 are tracked
EVERY_FRAME = 5      # mapping cadence = RGB-D cadence of the bench workload
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
# the backward, per point. Bytes: point, fractions and rows in (rows counted
# once), the cotangent in, three cotangents out. Operations: the recomputed
# forward (without its heads' 6 x 32, which the backward does not need, but
# counted: the difference is 0.4 %), then the reverse pass: per MLP two
# embedding products, four hidden products and five feature products (the
# fine MLP's only for its first 32 channels), all transposed, and the head.
# The head's cotangent is f32; every other cotangent entering a transposed
# product is a bf16 value (autograd rounds it on the way back through the
# operand's cast, the kernel does the same), so those products are reckoned at
# the bf16 tensor-core rate, which gives the lower, harder bound. The f32 work
# is the forward's again (embedding 3x279 with the cosines' chain rule, corner
# weights 8x96).
BWD_HEAD_MACS = 32 * 1 + 32 * 1 + 32 * 4
BWD_MLP_MACS = 3 * (2 * 93 * 32 + 4 * 32 * 32 + 5 * 32 * 32) + BWD_HEAD_MACS  # 45,696
BWD_BYTES_PER_POINT = 3 * 12 + 512 + 1024 + 16 + 3 * 12
# Backward kernel against autograd of the plain version. Both round every
# transposed product's result to bf16, so a last-bit difference of two f32
# sums can flip one rounding (one part in 256 of that cotangent), and a
# pre-activation within an ulp of zero can flip a ReLU sign (that unit's
# gradient all or nothing). Tolerance per output: |err| <= BWD_TOL * (rms of
# the reference + |reference|); at the main-path size up to BWD_OUTLIER_SHARE
# of the values may lie outside it and up to a tenth of that share outside ten
# times it (sign flips); at N = 1,500 none may lie outside ten times it and
# at most 2 values outside it. As for the forward, those counts are the fixed
# allowance; each check also measures the plain version's own distance from
# the exact arithmetic and allows twice that (the plain version alone has 30
# values of dp beyond ten times the tolerance at N = 881,280 on an H100).
BWD_TOL = 5e-3
BWD_OUTLIER_SHARE = 1e-4
BWD_PLAIN_CHUNK = 220320  # autograd of the plain version walks N_MAIN in 4 chunks
FWD_DESIGN = ("mma.sync m16n8k16 bf16 with f32 accumulators, warp tiles of {points} "
              "points, one persistent block per SM, weights resident in shared memory")
BWD_DESIGN = ("forward recompute and reverse products as mma.sync m16n8k16 bf16, warp "
              "tiles of {points} points, one persistent block per SM, weights resident "
              "in shared memory")


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


def decode_bwd_bound(n, param_bytes):
    """Least time in ms the card could take for the backward of ``n`` points,
    as :func:`decode_bound`; also the operation time if the reverse products
    had to run at the f32 rate (cotangents not taken as bf16 values)."""
    t_bytes = (n * BWD_BYTES_PER_POINT + param_bytes) / PEAK_BYTES_S
    bf16_macs = MLP_MACS + BWD_MLP_MACS - BWD_HEAD_MACS
    f32_macs = 2 * F32_MACS + BWD_HEAD_MACS
    t_ops = n * (2 * bf16_macs / PEAK_BF16_FLOPS + 2 * f32_macs / PEAK_F32_FLOPS)
    t_ops_f32 = n * (2 * MLP_MACS / PEAK_BF16_FLOPS
                     + 2 * (BWD_MLP_MACS + 2 * F32_MACS) / PEAK_F32_FLOPS)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, 1e3 * t_bytes, 1e3 * t_ops, 1e3 * t_ops_f32


@contextlib.contextmanager
def exact_products():
    """Inside the block, the plain version sums every MLP product exactly
    (float64) and rounds it once to float32; operands are rounded to bf16 as
    before, everything else is unchanged. Autograd through it rounds each
    cotangent once as well."""
    f32_mm = fused_decode._mm
    fused_decode._mm = lambda a, w: (a.bfloat16().double() @ w.bfloat16().double()).float()
    try:
        yield
    finally:
        fused_decode._mm = f32_mm


def outside(got, want, tol):
    """Values of ``got`` outside ``tol`` of ``want``, and outside ten times it."""
    err = (got - want).abs()
    return int((err > tol).sum()), int((err > OUTLIER_FACTOR * tol).sum())


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
        with exact_products():
            exact = fused_decode.fused_decode_packed_plain(decoders, *args)
        torch.cuda.synchronize()
        if out.shape != (n, 4) or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"kernel output at N={n}: bad shape or non-finite")
        err = (out - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        n_bad, n_far = outside(out, ref, ATOL + RTOL * ref.abs())
        plain_bad, plain_far = outside(ref, exact, ATOL + RTOL * exact.abs())
        exact_bad, exact_far = outside(out, exact, ATOL + RTOL * exact.abs())
        fixed = int(OUTLIER_SHARE * out.numel())  # 0 at N = 1,500
        allowed, allowed_far = max(fixed, 2 * plain_bad), 2 * plain_far
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
        "outside_10x_allowed": allowed_far, "fixed_allowance": fixed,
        "plain_vs_exact": [plain_bad, plain_far], "kernel_vs_exact": [exact_bad, exact_far],
        "atol": ATOL, "rtol": RTOL, "ms": ms, "kernel_only_ms": kernel_only_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
    }
    say(f"kernel vs plain at N={n}: " + json.dumps(res))
    if n_bad > allowed or n_far > allowed_far:
        raise RuntimeError(
            f"kernel disagrees with its plain version at N={n}: {n_bad} values "
            f"outside atol={ATOL} rtol={RTOL} ({allowed} allowed), {n_far} outside "
            f"{OUTLIER_FACTOR:g} times that ({allowed_far} allowed; max abs {max_abs:.3e})")
    if exact_bad > plain_bad + fixed or exact_far > plain_far:
        raise RuntimeError(
            f"kernel at N={n} is further from the exact arithmetic than the plain version: "
            f"{exact_bad} / {exact_far} values outside the tolerance / ten times it, "
            f"plain {plain_bad} / {plain_far}")
    return res


def check_bwd_kernel(decoders, packed, bound_t, n, dev, iters, plain_iters):
    """The backward kernel against autograd of the plain version on the same
    inputs and a seeded cotangent; times by CUDA events."""
    args = decode_inputs(packed, bound_t, n, dev, seed=SEED + n)
    g = torch.from_numpy(np.random.default_rng(SEED + n + 1).standard_normal(
        (n, 4)).astype(np.float32)).to(dev)
    w16, f32 = fused_decode.pack_trio_weights(decoders)
    chunk = BWD_PLAIN_CHUNK if n > BWD_PLAIN_CHUNK else None
    got = fused_decode.launch_fused_decode_bwd(*args, w16, f32, g)
    torch.cuda.synchronize()
    want = fused_decode.fused_decode_bwd_plain(decoders, *args, g, chunk=chunk)
    torch.cuda.synchronize()
    with exact_products():
        exact = fused_decode.fused_decode_bwd_plain(decoders, *args, g, chunk=chunk)
    torch.cuda.synchronize()
    big = n > 10000
    fixed = int(BWD_OUTLIER_SHARE * 3 * n) if big else 2
    fixed_far = fixed // 10 if big else 0
    res = {"n": n, "tol": BWD_TOL, "fixed_allowance": [fixed, fixed_far]}
    failed = []
    for name, o, r, x in zip(("dp", "dfrac_m", "dfrac_f"), got, want, exact):
        if o.shape != (n, 3) or not bool(torch.isfinite(o).all()):
            raise RuntimeError(f"backward kernel {name} at N={n}: bad shape or non-finite")
        err = (o - r).abs()
        n_bad, n_far = outside(o, r, BWD_TOL * (r.pow(2).mean().sqrt() + r.abs()))
        tol_x = BWD_TOL * (x.pow(2).mean().sqrt() + x.abs())
        plain_bad, plain_far = outside(r, x, tol_x)
        exact_bad, exact_far = outside(o, x, tol_x)
        allowed, allowed_far = max(fixed, 2 * plain_bad), max(fixed_far, 2 * plain_far)
        res[name] = {"max_abs_err": float(err.max()), "ref_rms": float(r.pow(2).mean().sqrt()),
                     "rel_norm_err": float((o - r).norm() / r.norm()),
                     "outside_tolerance": n_bad, "outside_10x_tolerance": n_far,
                     "outside_allowed": allowed, "outside_10x_allowed": allowed_far,
                     "plain_vs_exact": [plain_bad, plain_far],
                     "kernel_vs_exact": [exact_bad, exact_far]}
        if (n_bad > allowed or n_far > allowed_far or exact_bad > plain_bad + fixed
                or exact_far > plain_far + fixed_far):
            failed.append(name)
    # the same through autograd.Function, as the render path reaches it
    leaves = [a.detach().clone().requires_grad_() for a in args[:3]]
    out = fused_decode.fused_decode_packed(decoders, *leaves, *args[3:], weights=(w16, f32))
    via = torch.autograd.grad(out, leaves, g, retain_graph=True)
    if not all(torch.equal(a, b) for a, b in zip(via, got)):
        raise RuntimeError(f"_FusedDecode.backward differs from the bare launch at N={n}")
    res["ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), iters)
    res["kernel_only_ms"] = cuda_ms(
        lambda: fused_decode.launch_fused_decode_bwd(*args, w16, f32, g), iters)
    res["plain_ms"] = cuda_ms(
        lambda: fused_decode.fused_decode_bwd_plain(decoders, *args, g, chunk=chunk),
        plain_iters)
    res["plain_chunks"] = 1 if chunk is None else -(-n // chunk)
    param_bytes = w16.numel() * 2 + f32.numel() * 4
    (res["bound_ms"], res["bound_by"], res["bound_bytes_ms"], res["bound_operations_ms"],
     res["bound_operations_ms_if_f32_cotangents"]) = decode_bwd_bound(n, param_bytes)
    res["max_abs_err"] = max(res[k]["max_abs_err"] for k in ("dp", "dfrac_m", "dfrac_f"))
    say(f"backward kernel vs autograd of the plain version at N={n}: " + json.dumps(res))
    if failed:
        raise RuntimeError(
            f"backward kernel disagrees with its plain version at N={n}: {failed}")
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


@contextlib.contextmanager
def plain_decode():
    """Send the decode of every render inside the block through the plain
    PyTorch version instead of the kernels (autograd differentiates it)."""
    def plain(decoders, p, frac_m, frac_f, rows_m, rows_f, c_dim=32, weights=None):
        return fused_decode.fused_decode_packed_plain(
            decoders, p, frac_m, frac_f, rows_m, rows_f, c_dim)

    kernel_fn = fused_decode.fused_decode_packed
    fused_decode.fused_decode_packed = plain
    try:
        yield
    finally:
        fused_decode.fused_decode_packed = kernel_fn


def reset_launches():
    fused_decode.fused_decode_packed.launches = 0
    fused_decode.fused_decode_packed.bwd_launches = 0


def launches():
    return (fused_decode.fused_decode_packed.launches,
            fused_decode.fused_decode_packed.bwd_launches)


def check_pose_gradient(mp, decoders, packed, bound_t, dev):
    """d total / d pose through the whole score, once through the kernels and
    once through the plain versions, with the same pixel draws."""
    tcfg, cam = mp.tcfg, mp.cam
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ij = sample_pixels(gen, tcfg.pixels, tcfg.ignore_edge_h, cam.H - tcfg.ignore_edge_h,
                       tcfg.ignore_edge_w, cam.W - tcfg.ignore_edge_w, device=dev)
    pose = mp.true_pose + torch.tensor(
        [0, 0.002, -0.001, 0.001, 0.01, -0.005, 0.008], device=dev)

    def grad(rgbd):
        x = pose.clone().requires_grad_()
        total, _ = tracking_loss(
            x, decoders, packed, mp.eventnet, bound_t, mp.color, mp.depth,
            mp.gt_event_lo, mp.prev_color_lo, mp.gt_depth_lo_flat, mp.gt_mask_lo,
            tcfg, cam, mp.settings, rgbd=rgbd, event=True, pixel_ij=ij)
        (g,) = torch.autograd.grad(total, x)
        torch.cuda.synchronize()
        return g

    out = {}
    for rgbd in (False, True):
        reset_launches()
        g_k = grad(rgbd)
        n_f, n_b = launches()
        with plain_decode():
            g_p = grad(rgbd)
        rel = float((g_k - g_p).norm() / g_p.norm())
        cos = float(torch.dot(g_k, g_p) / (g_k.norm() * g_p.norm()))
        name = "rgbd+event" if rgbd else "event only"
        say(f"pose gradient {name}: kernels {[f'{v:.4g}' for v in g_k.tolist()]} "
            f"plain {[f'{v:.4g}' for v in g_p.tolist()]} relative difference {rel:.3e}, "
            f"cosine {cos:.8f}; launches forward {n_f}, backward {n_b} "
            f"(tolerance: relative {GRAD_REL_TOL}, cosine > {GRAD_COS_MIN})")
        want = 2 if rgbd else 1
        if not (bool(torch.isfinite(g_k).all()) and rel <= GRAD_REL_TOL
                and cos > GRAD_COS_MIN and (n_f, n_b) == (want, want)):
            raise RuntimeError(f"pose gradient through the kernels, {name}: disagrees")
        out[name] = {"rel": rel, "cos": cos}
    return out


def upload_frames(cam, dev, n=N_TRACK_FRAMES):
    """The first ``n`` frames of the synthetic Replica-event scene at full
    size (host ray tracing), on the device."""
    t0 = time.perf_counter()
    frames = []
    for f in synthetic_frames(n, cam.H, cam.W, fx=cam.fx, fy=cam.fy,
                              bound=BOUND, traj_step=0.01):
        frames.append(SimpleNamespace(
            index=f.index, c2w=torch.from_numpy(f.c2w).to(dev),
            color=torch.from_numpy(f.color).to(dev),
            depth=torch.from_numpy(f.depth).to(dev),
            event=torch.from_numpy(f.event).to(dev)))
    say(f"synthetic scene: {len(frames)} frames {cam.H}x{cam.W} made on the host and "
        f"uploaded in {time.perf_counter() - t0:.1f} s (set-up); events per frame "
        f"{[int(f.event.sum()) for f in frames]}")
    return frames


def track_sequence(mp, frames, decoders, packed, dev, label):
    """Frames 1..6 through ``Tracker.track`` / ``end_of_window`` as the
    pipeline drives them: poses fed back from the tracker's own estimates,
    the window boundary every ``EVERY_FRAME`` frames. One synchronise at the
    end of each frame. Checks losses, poses and launch counts per frame."""
    tcfg = mp.tcfg
    tracker = Tracker(tcfg, mp.cam, mp.settings, BOUND, mp.eventnet, device=dev)
    est = {0: frames[0].c2w}
    tracker.reset_event_integration(frames[0].event.shape)
    tracker.pre_gt_color = frames[0].color
    tracker.end_of_window(0, frames[0].color, EVERY_FRAME)
    records = []
    for f in frames[1:]:
        idx = f.index
        rgbd = idx % tcfg.rgbd_every_frame == 0
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        c2w = tracker.track(idx, f.color, f.depth, f.event, est[idx - 1],
                            est[idx - 2] if idx >= 2 else None, decoders, packed, seed=idx)
        t_enq = time.perf_counter()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        est[idx] = c2w
        tracker.end_of_window(idx, f.color, EVERY_FRAME)
        n_f, n_b = (a - b for a, b in zip(launches(), before))
        losses = tracker.last_losses
        want_keys = {"event", "event_corr", "event_gt_energy", "mask"} | (
            {"rgbd"} if rgbd else set())
        rot = c2w[:3, :3]
        ortho = float((rot.T @ rot - torch.eye(3, device=dev)).abs().max())
        ok = (set(losses) == want_keys
              and all(v.shape == (tcfg.iters,) and bool(torch.isfinite(v).all())
                      for v in losses.values())
              and c2w.shape == (4, 4) and bool(torch.isfinite(c2w).all())
              and ortho <= 1e-4
              and bool((c2w[3] == torch.tensor([0.0, 0, 0, 1], device=dev)).all()))
        want_launches = tcfg.iters * (2 if rgbd else 1)
        rec = {"frame": idx, "rgbd": rgbd, "wall_ms": 1e3 * (t_end - t0),
               "enqueue_ms": 1e3 * (t_enq - t0), "fwd_launches": n_f, "bwd_launches": n_b,
               "event_loss_first": float(losses["event"][0]),
               "event_loss_min": float(losses["event"].min()),
               "moved_mm": 1e3 * float((c2w[:3, 3] - est[idx - 1][:3, 3]).norm()),
               "gt_moved_mm": 1e3 * float((f.c2w[:3, 3] - frames[idx - 1].c2w[:3, 3]).norm()),
               "orthonormality": ortho}
        say(f"track [{label}] " + json.dumps(rec))
        if not ok:
            raise RuntimeError(f"tracking frame {idx}: bad losses or pose: "
                               f"{ {k: v.tolist() for k, v in losses.items()} } {c2w.tolist()}")
        if (n_f, n_b) != (want_launches, want_launches):
            raise RuntimeError(
                f"tracking frame {idx}: {n_f} forward and {n_b} backward launches, "
                f"expected {want_launches} each")
        records.append(rec)
    # the window state after six frames: handed off at frame 5, reset, frame 6 in
    if tracker.consume_event_handoff(EVERY_FRAME) is None or \
            tracker.consume_event_handoff(EVERY_FRAME) is not None:
        raise RuntimeError("the event integral was not handed off once at the boundary")
    if not torch.equal(tracker.gt_event_integrate, frames[6].event):
        raise RuntimeError("the event integral was not reset at the boundary")
    return records


def track_kernel_vs_plain(mp, frames, decoders, packed, bound_t, dev):
    """Frame 1 (event only) tracked twice from the same start, through the
    kernels and through the plain versions."""
    tcfg, f = mp.tcfg, frames[1]
    _, ev_lo, prev_lo, depth_lo, mask_lo = _prep_event_inputs(
        torch.zeros_like(f.event), f.event, frames[0].color, f.depth, mp.lo_hw,
        tcfg.prev_resize)

    def run():
        out = track_frame(
            frames[0].c2w, torch.eye(4, device=dev), decoders, packed, mp.eventnet,
            bound_t, torch.Generator(device=dev).manual_seed(1), f.color, f.depth,
            ev_lo, prev_lo, depth_lo, mask_lo, torch.zeros(7, device=dev), 1.0,
            tcfg, mp.cam, mp.settings, rgbd=False, event=True, const_speed=False)
        torch.cuda.synchronize()
        return out

    cam_k, _, loss_k, _ = run()
    t0 = time.perf_counter()
    with plain_decode():
        cam_p, _, loss_p, _ = run()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    d_pose = float((cam_k - cam_p).abs().max())
    first = float((loss_k["event"][0] - loss_p["event"][0]).abs() / loss_p["event"][0].abs())
    hist = float(((loss_k["event"] - loss_p["event"]).abs() / loss_p["event"].abs()).max())
    limit = 2 * tcfg.iters * tcfg.lr
    say(f"one frame, kernels vs plain versions: best poses differ by {d_pose:.3e} "
        f"(limit {limit:g} = 2 * iters * lr), event loss of the first iteration by "
        f"{first:.3e} relative (tolerance {TRACK_FIRST_LOSS_RTOL}), of any iteration by "
        f"{hist:.3e}; the plain path took {plain_ms:.0f} ms for the frame")
    if not (d_pose <= limit and first <= TRACK_FIRST_LOSS_RTOL):
        raise RuntimeError("tracking through the kernels disagrees with the plain path")
    return {"pose_diff": d_pose, "first_loss_rel": first, "any_loss_rel": hist,
            "plain_frame_ms": plain_ms}


def self_consistent_frame(mp, renderer, decoders, packed, bound_t, dev):
    """Reported, not asserted: render colour and depth of the (random) map at
    a known pose, then track RGB-D only from that pose moved by a few
    millimetres. The map is noise, so nothing is promised."""
    pose = mp.true_pose / torch.cat([mp.true_pose[:4].norm().expand(4),
                                     torch.ones(3, device=dev)])
    c2w = torch.cat([pose_matrix_from_tensor(pose), torch.eye(4, device=dev)[3:4]])
    with torch.no_grad():
        depth, _, color = renderer.render_img(decoders, packed, c2w[:3], "color")
    start = pose + torch.tensor([0, 0.001, -0.001, 0.0005, 0.004, -0.003, 0.005], device=dev)
    start_c2w = torch.cat([pose_matrix_from_tensor(start), torch.eye(4, device=dev)[3:4]])
    cfg_rgbd = mp.tcfg._replace(use_events=False)
    lo = mp.lo_hw
    best, _, losses, _ = track_frame(
        start_c2w, torch.eye(4, device=dev), decoders, packed, {}, bound_t,
        torch.Generator(device=dev).manual_seed(2), color, depth,
        torch.zeros(*lo, 2, device=dev), torch.zeros(*lo, 3, device=dev),
        torch.zeros(lo[0] * lo[1], device=dev), torch.zeros(*lo, device=dev),
        torch.zeros(7, device=dev), 1.0, cfg_rgbd, mp.cam, mp.settings,
        rgbd=True, event=False, const_speed=False)
    torch.cuda.synchronize()
    start7 = tensor_from_pose_matrix(start_c2w[:3])
    res = {"t_err_before_mm": 1e3 * float((start7[4:] - pose[4:]).norm()),
           "t_err_after_mm": 1e3 * float((best[4:] - pose[4:]).norm()),
           "q_err_before": float((start7[:4] - pose[:4]).norm()),
           "q_err_after": float((best[:4] / best[:4].norm() - pose[:4]).norm()),
           "rgbd_loss_first": float(losses["rgbd"][0]),
           "rgbd_loss_min": float(losses["rgbd"].min())}
    say("self-consistent frame (map rendered at a known pose, tracked RGB-D only from "
        "a start a few mm off; reported, not asserted): " + json.dumps(res))
    return res


# ---- mapping: map and track interleaved, and one mapping call card vs CPU ----------

MAP_FRAMES = 26        # frames 0-25: a first mapping call, five steady ones
MAP_ITERS_FIRST = 300  # bench.py:82; the shipped configuration's 1500, cut
MAP_KEYFRAME_EVERY = 5  # so the window grows to K = 5 and BA turns on at frame 25
# the room's walls 2 cm inside the map's bound, as the pipeline's scene
# configuration places them (a wall on the bound would make a ray's inside
# test turn on the last bit of its exit distance)
ROOM = BOUND + np.array([[0.02, -0.02]], np.float32)
# One steady mapping call through Mapper.optimize_map (steady_mapping_state),
# card against CPU, same state and draws. Each limit lies between the sound
# reading and the nearest reading of a call with a fault planted on the CPU
# side (MAP_FAULTS), on an H100 (PERF.md, the mapping findings):
#   last loss, relative:        sound 5.7e-7; frustum masks off 4.9e-3,
#                               colour stage skipped 0.73 (BA off 1.6e-7);
#   worst leaf update, rel. L2: sound 0.021; frustum masks off 0.97, colour
#                               stage skipped inf (BA off 2.1e-4);
#   written-back poses, abs.:   sound 1.3e-5; BA off 1.5e-3, the others 1.2e-3.
# The leaves and poses are far apart where any differ: a call builds its Adam
# state anew, and Adam's first step, lr * sign(g), is a whole step at every
# element whose gradient sign the two devices' rounding decides. Two card
# calls are bitwise equal: the grid gradient (the backward of the corner
# gathers) sorts its indices and adds in a fixed order.
MAP_CHECK_ITERS = 5
STEADY_FIRST_ITERS = 60
MAP_LOSS_RTOL = 1e-4
MAP_UPDATE_REL = 0.15
MAP_POSE_ATOL = 1.5e-4
MAP_FAULTS = ("BA off", "colour stage skipped", "frustum masks off")
# Trajectory error bars (metres). The bench schedule is held to the JAX
# package's own error on the same frames and schedule: over seeds 0-2 it read
# 0.168, 0.276 and 0.287 m (tests/test_torch_map_and_track.py, the camera cut to
# 170x300 for the CPU), and the two frameworks' closed loops part by up to
# 2.2x at one seed and the same draws (0.376 against 0.168 m), so the bar is
# 1.5 times the JAX package's largest. In this configuration the reference's
# event-only frames drift past a camera held at frame 0 (0.046 m), so that
# bar does not tell a tracker from a held camera; the schedule with RGB-D on
# every frame does, and is held below the held camera's error.
ATE_BENCH_BAR = 0.43


def mapping_config(cfg):
    c = copy.deepcopy(cfg)
    c["mapping"]["iters_first"] = MAP_ITERS_FIRST
    c["mapping"]["keyframe_every"] = MAP_KEYFRAME_EVERY
    return MapperConfig.from_cfg(c)


def make_map(cfg, dev, seed=SEED, bound=BOUND):
    """The full-width map of the shipped configuration, coarse level
    included, random from a seed."""
    gen = torch.Generator().manual_seed(seed + 5)
    grids = init_grids(gen, bound, cfg["grid_len"], cfg["model"]["c_dim"], coarse=True,
                       coarse_bound_enlarge=cfg["model"]["coarse_bound_enlarge"], device=dev)
    decoders = init_nice_decoders(gen, c_dim=cfg["model"]["c_dim"], coarse=True, device=dev)
    return grids, decoders


def room_frames(frag, dev, n):
    """Frames 0..n-1 of the furnished room 2 cm inside the map's bound (its
    relief constrains translation where a bare wall would not), read from
    the scene on disk through the port's reader — equal, bit for bit, to
    ``data/synthetic.py::synthetic_frames`` with the same arguments — on the
    host (numpy, as the reader yields them) and on the device."""
    t0 = time.perf_counter()
    reader = get_dataset({"dataset": frag["dataset"], "data": frag["data"], "cam": frag["cam"]})
    out = []
    for i in range(n):
        f = reader[i]
        out.append(SimpleNamespace(
            index=f.index, np=f, c2w=torch.from_numpy(f.c2w).to(dev),
            color=torch.from_numpy(f.color).to(dev), depth=torch.from_numpy(f.depth).to(dev),
            event=torch.from_numpy(f.event).to(dev)))
    torch.cuda.synchronize()
    say(f"mapping scene: {n} frames {reader.H}x{reader.W} read from disk and uploaded in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    return out


def depth_l1(renderer, decoders, grids, f):
    """Mean |depth| error of a 0.15-scale render at the frame's true pose,
    over pixels with a depth reading."""
    with torch.no_grad():
        d, _, _ = renderer.render_img_rescale(decoders, grids, f.c2w[:3], "color",
                                              gt_depth=f.depth, scale_factor=0.15)
    ref = resize_bilinear(f.depth, tuple(d.shape))
    ok = ref > 0
    return float(((d - ref).abs() * ok).sum() / ok.sum())


@contextlib.contextmanager
def count_syncs(out):
    """Record the host synchronisations inside the block (PyTorch's sync
    debug mode in warn mode): one entry per synchronising call, the port's
    own innermost frames that made it."""
    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message).lower():
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "evennicer_slam_tpu_torch" in f.filename]
            out.append(" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                   for f in frames[::-1][:3]) or "outside the port")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def map_and_track(cfg, mp, dev, frames, tcfg, label, ate_bar, seed=SEED, bound=BOUND):
    """Frame 0 mapped from its true pose (the first call), frames 1..n-1
    tracked through ``Tracker.track`` on the fitted map with ``tcfg``, a
    steady mapping call every fifth frame from the tracker's device pose,
    keyframes every fifth frame, the packed snapshot rebuilt after each
    mapping call; the map, the mapper's draws and the tracker's draws start
    from ``seed``. Checks
    the depth of the first call's map, the window, the losses, the launches
    and the host synchronisations inside steady calls, and that the ATE lies
    below ``ate_bar(held)``, ``held`` the RMSE of a camera held at frame 0
    (both in metres). ``bound`` is the map's bound. Returns the failures
    with the results."""
    cam = mp.cam
    n_frames = len(frames)
    mcfg = mapping_config(cfg)
    map_settings = RenderSettings.from_cfg(cfg)
    grids, decoders = make_map(cfg, dev, seed, bound)
    mapper = Mapper(mcfg, cam, map_settings, bound, seed=seed, device=dev)
    mapper.fuse_coarse = True
    tracker = Tracker(tcfg, cam, mp.settings, bound, mp.eventnet, device=dev)
    renderer = Renderer(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy, bound, map_settings,
                        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f0 = frames[0]
    l1_before = depth_l1(renderer, decoders, grids, f0)

    def map_call(f, pose, first):
        n_it = mcfg.iters_first if first else mcfg.iters
        lr = mcfg.lr_first_factor if first else mcfg.lr_factor
        mapper.update_ba_state()
        ba = mapper.BA_active
        syncs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_syncs(syncs):
            g, d, new = mapper.optimize_map(
                n_it, lr, f.index, f.np.color, f.np.depth, f.np.event, pose,
                seed=f.index * 97 + 7919 * seed, grids=grids, decoders=decoders,
                cur_images_dev=(f.color, f.depth))
        t_enq = time.perf_counter()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        rec = {"frame": f.index, "iters": n_it, "K": mapper.last_window_size, "BA": ba,
               "device_pose": isinstance(pose, torch.Tensor), "ms": 1e3 * (t_end - t0),
               "enqueue_ms": 1e3 * (t_enq - t0), "ms_per_iter": 1e3 * (t_end - t0) / n_it,
               "syncs": len(syncs), "sync_sites": sorted(set(syncs))[:4],
               "loss": mapper.last_loss}
        return g, d, new, rec

    tracker.reset_event_integration(f0.event.shape)
    tracker.pre_gt_color = f0.color
    tracker.end_of_window(0, f0.color, EVERY_FRAME)
    grids, decoders, _, first = map_call(f0, f0.np.c2w.copy(), True)
    mapper.maybe_add_keyframe(0, n_frames, f0.np.color, f0.np.depth, f0.np.event,
                              f0.np.c2w, f0.np.c2w, device_images=(f0.color, f0.depth))
    l1_after = depth_l1(renderer, decoders, grids, f0)
    say(f"[{label}] first mapping call (frame 0, {mcfg.iters_first} iterations at lr x "
        f"{mcfg.lr_first_factor:g}): {first['ms']:.0f} ms, {first['ms_per_iter']:.2f} ms an "
        f"iteration; depth L1 of a 0.15-scale render at frame 0 {l1_before:.4f} m before, "
        f"{l1_after:.4f} m after")
    packed = pack_grids_for_tracking(grids)
    est = {0: f0.c2w}
    calls, losses = [first], []
    before = launches()
    want_launches = 0
    t_track = 0.0
    for f in frames[1:]:
        idx = f.index
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est[idx] = tracker.track(idx, f.color, f.depth, f.event, est[idx - 1],
                                 est[idx - 2] if idx >= 2 else None, decoders, packed,
                                 seed=idx + 100003 * seed)
        torch.cuda.synchronize()
        t_track += time.perf_counter() - t0
        want_launches += tcfg.iters * (2 if idx % tcfg.rgbd_every_frame == 0 else 1)
        losses.append(tracker.last_losses)
        tracker.end_of_window(idx, f.color, EVERY_FRAME)
        if idx % EVERY_FRAME == 0:
            grids, decoders, new, rec = map_call(f, est[idx], False)
            if new is not None:
                est[idx] = new
            mapper.maybe_add_keyframe(idx, n_frames, f.np.color, f.np.depth, f.np.event,
                                      est[idx], f.np.c2w, device_images=(f.color, f.depth))
            packed = pack_grids_for_tracking(grids)
            calls.append(rec)
            say(f"[{label}] mapping call " + json.dumps(
                {k: v for k, v in rec.items() if k not in ("loss", "sync_sites")}))
    torch.cuda.synchronize()
    n_fwd, n_bwd = (a - b for a, b in zip(launches(), before))
    peak = torch.cuda.max_memory_allocated() / 2**30
    gt_t = np.stack([f.np.c2w[:3, 3] for f in frames]).astype(np.float64)
    est_t = torch.stack([est[i][:3, 3] for i in range(n_frames)]).double().cpu().numpy()
    err = np.linalg.norm(est_t - gt_t, axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    held = float(np.sqrt(np.mean(np.sum((gt_t - gt_t[0]) ** 2, axis=1))))
    bar = float(ate_bar(held))
    finite = all(bool(torch.isfinite(v).all()) for d in losses for v in d.values()) and all(
        math.isfinite(float(c["loss"])) for c in calls)
    steady = calls[1:]
    corr = [float(d["event_corr"].mean()) for d in losses if "event_corr" in d]
    res = {
        "tracking": {"rgbd_every_frame": tcfg.rgbd_every_frame, "iters": tcfg.iters},
        "frames": n_frames, "ate_rmse_m": ate, "ate_bar_m": bar, "held_camera_rmse_m": held,
        "err_mm_per_frame": [round(1e3 * e, 2) for e in err],
        "event_corr_mean": float(np.mean(corr)) if corr else None,
        "depth_l1_before_m": l1_before, "depth_l1_after_m": l1_after,
        "first_call_ms": first["ms"], "first_call_enqueue_ms": first["enqueue_ms"],
        "first_ms_per_iter": first["ms_per_iter"],
        "steady_call_ms": [c["ms"] for c in steady],
        "steady_enqueue_ms": [c["enqueue_ms"] for c in steady],
        "steady_ms_per_iter": [c["ms_per_iter"] for c in steady],
        "windows": [(c["frame"], c["K"], c["BA"]) for c in calls],
        "syncs_in_steady_calls": [c["syncs"] for c in steady],
        "mapping_losses": [float(c["loss"]) for c in calls],
        "tracking_ms_per_frame": 1e3 * t_track / (n_frames - 1),
        "peak_memory_gib": peak, "fwd_launches": n_fwd, "bwd_launches": n_bwd,
    }
    say(f"[{label}] map and track: " + json.dumps(res))
    failed = []
    if not l1_after <= 0.5 * l1_before:
        failed.append(f"depth L1 at frame 0 fell from {l1_before:.4f} only to {l1_after:.4f} m")
    if not ate < bar:
        failed.append(f"ATE {ate:.4f} m is not below {bar:.4f} m")
    if not any(c["K"] == 5 and c["BA"] for c in calls):
        failed.append("no mapping call had K = 5 with BA active")
    if not finite:
        failed.append("a tracking or mapping loss is not finite")
    if any(c["syncs"] for c in steady):
        failed.append("a steady mapping call synchronised with the host "
                      f"{[c['syncs'] for c in steady]} times, at "
                      f"{sorted({s for c in steady for s in c['sync_sites']})}")
    if (n_fwd, n_bwd) != (want_launches, want_launches):
        failed.append(f"tracking launched the decode kernels {n_fwd} / {n_bwd} times, "
                      f"expected {want_launches} each")
    return [f"map and track [{label}]: {f}" for f in failed], res


def steady_mapping_state(cfg, cam, dev, frames):
    """The state of a steady mapping call at frame 25 that tracking does not
    touch: the map fitted to frame 0 from its true pose (STEADY_FIRST_ITERS
    iterations at lr x 5), keyframes 0, 5, ..., 20 at their true poses as
    device tensors, BA on (five keyframes), frame 25 at its true pose.
    Returns (mapper, grids, decoders, frame, pose)."""
    mcfg = mapping_config(cfg)
    grids, decoders = make_map(cfg, dev)
    mapper = Mapper(mcfg, cam, RenderSettings.from_cfg(cfg), BOUND, seed=SEED, device=dev)
    mapper.fuse_coarse = True
    f0 = frames[0]
    grids, decoders, _ = mapper.optimize_map(
        STEADY_FIRST_ITERS, mcfg.lr_first_factor, 0, f0.np.color, f0.np.depth, f0.np.event,
        f0.np.c2w.copy(), seed=1, grids=grids, decoders=decoders,
        cur_images_dev=(f0.color, f0.depth))
    for mf in frames[:-1:EVERY_FRAME]:
        mapper.maybe_add_keyframe(mf.index, len(frames), mf.np.color, mf.np.depth, mf.np.event,
                                  mf.c2w, mf.np.c2w, device_images=(mf.color, mf.depth))
    mapper.update_ba_state()
    return mapper, grids, decoders, frames[-1], frames[-1].c2w


def clone_mapper(mapper, grids, decoders, dev):
    """A new ``Mapper`` on ``dev`` in ``mapper``'s state: its keyframes
    (images, poses as the device stack holds them), its selection streams,
    its BA flag, and its own random draws (those of ``mapper``'s device,
    copied over), with copies of the map."""
    mapper.keyframes.sync_host_poses()
    m = Mapper(mapper.cfg, mapper.cam, mapper.settings, mapper.bound_np, device=dev)
    m.fuse_coarse, m.BA_active = mapper.fuse_coarse, mapper.BA_active
    m.rng, m.rng_coarse = copy.deepcopy(mapper.rng), copy.deepcopy(mapper.rng_coarse)
    m.keyframes = convert.keyframe_store_from_numpy(mapper.keyframes.frames, device=dev)
    m._draw_pixels = lambda *a: mapper._draw_pixels(*a).to(dev)
    m._selection_draws = lambda *a: tuple(x.to(dev) for x in mapper._selection_draws(*a))
    return m, tree_map(lambda x: x.detach().to(dev, copy=True), (grids, decoders))


@contextlib.contextmanager
def colour_stage_skipped():
    """A planted fault: every mapping call runs its colour stage's
    iterations as fine-stage iterations."""
    schedule = mapper_module.stage_schedule

    def no_colour(n, cfg, coarse_mapper, color_refine):
        stages, seg = schedule(n, cfg, coarse_mapper, color_refine)
        if "color" not in stages:
            return stages, seg
        seg = dict(seg, fine=seg["fine"] + seg.pop("color"))
        return tuple(x for x in stages if x != "color"), seg

    mapper_module.stage_schedule = no_colour
    try:
        yield
    finally:
        mapper_module.stage_schedule = schedule


def steady_call(mapper, grids, decoders, f, pose, dev, fault=None):
    """One ``Mapper.optimize_map`` call of MAP_CHECK_ITERS iterations on
    ``dev`` from a copy of ``mapper``'s state (``fault`` plants one):
    the map after it, the keyframe pose stack after the BA write-back, the
    current frame's new pose and the last loss."""
    m, (g, d) = clone_mapper(mapper, grids, decoders, dev)
    if fault == "BA off":
        m.BA_active = False
    if fault == "frustum masks off":
        m.cfg = m.cfg._replace(frustum_feature_selection=False)
    with colour_stage_skipped() if fault == "colour stage skipped" else contextlib.nullcontext():
        g, d, new = m.optimize_map(
            MAP_CHECK_ITERS, m.cfg.lr_factor, f.index, f.np.color, f.np.depth, f.np.event,
            pose.to(dev), seed=f.index * 97, grids=g, decoders=d,
            cur_images_dev=(f.color.to(dev), f.depth.to(dev)))
    _, _, poses = m.keyframes.device_stack()
    new = pose.to(dev) if new is None else new
    return {"map": (g, d), "poses": torch.cat([poses, new[None]]), "loss": m.last_loss,
            "K": m.last_window_size}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def mapping_distance(got, want, before):
    """How far the call ``got`` lies from ``want``: the last loss's relative
    difference, each leaf's update (after minus ``before``) at a relative L2
    distance (a leaf that moved on one side only reads inf), and the largest
    difference of the written-back poses."""
    rel = {}
    for (path, a), (_, b), (_, x0) in zip(_leaves(got["map"]), _leaves(want["map"]),
                                          _leaves(before)):
        x0 = x0.detach().double().cpu()
        da, db = a.detach().double().cpu() - x0, b.detach().double().cpu() - x0
        if float(db.norm()) > 0:
            rel[str(path)] = float((da - db).norm() / db.norm())
        elif float(da.norm()) > 0:
            rel[str(path)] = math.inf
    worst = max(rel, key=rel.get)
    loss_w = float(want["loss"])
    return {"loss_rel": abs(float(got["loss"]) - loss_w) / abs(loss_w),
            "worst_leaf": worst, "leaf_update_rel": rel[worst],
            "pose_abs": float((got["poses"].cpu() - want["poses"].cpu()).abs().max())}


def within(dist):
    return (dist["loss_rel"] <= MAP_LOSS_RTOL and dist["leaf_update_rel"] <= MAP_UPDATE_REL
            and dist["pose_abs"] <= MAP_POSE_ATOL)


def mapping_card_vs_cpu(mapper, grids, decoders, f, pose, dev):
    """One steady mapping call (K = 5, BA, fused coarse, frustum masks) of
    MAP_CHECK_ITERS iterations through ``Mapper.optimize_map`` at full
    width, from the state ``steady_mapping_state`` builds: on the card twice
    from one copied state (bitwise equal), and on the CPU from the same state
    with the same draws (within the limits). Then the CPU call again with
    each of MAP_FAULTS planted: each must lie outside the limits."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = steady_call(mapper, grids, decoders, f, pose, dev)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    again = steady_call(mapper, grids, decoders, f, pose, dev)
    t0 = time.perf_counter()
    cpu = steady_call(mapper, grids, decoders, f, pose, torch.device("cpu"))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    pairs = list(zip(_leaves(card), _leaves(again)))
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in pairs if isinstance(a, torch.Tensor))
    run_to_run = max(float((a.double() - b.double()).abs().max())
                     for (_, a), (_, b) in pairs if isinstance(a, torch.Tensor))
    sound = mapping_distance(card, cpu, (grids, decoders))
    faults = {}
    for fault in MAP_FAULTS:
        bad = steady_call(mapper, grids, decoders, f, pose, torch.device("cpu"), fault)
        faults[fault] = mapping_distance(card, bad, (grids, decoders))
    res = {"iters": MAP_CHECK_ITERS, "K": card["K"], "BA": mapper.BA_active,
           "card_vs_cpu": sound, "card_ms": card_ms, "cpu_ms": cpu_ms,
           "card_vs_card_bitwise_equal": bitwise, "card_vs_card_max_abs_diff": run_to_run,
           "card_vs_faulty_cpu": faults,
           "limits": {"loss_rtol": MAP_LOSS_RTOL, "leaf_update_rel": MAP_UPDATE_REL,
                      "pose_atol": MAP_POSE_ATOL}}
    say("one steady mapping call through Mapper.optimize_map, card vs card, card vs CPU, "
        "card vs CPU with a fault planted: " + json.dumps(res))
    failed = []
    if not bitwise:
        failed.append(f"two identical card calls differ (max abs {run_to_run:.3e})")
    if not (math.isfinite(float(card["loss"])) and within(sound)):
        failed.append(f"the card disagrees with the CPU: {sound}")
    caught = [k for k, v in faults.items() if not within(v)]
    if caught != list(faults):
        failed.append(f"the limits do not catch {sorted(set(faults) - set(caught))}")
    if failed:
        raise RuntimeError("steady mapping call: " + "; ".join(failed))
    return res


# ---- the pipeline from disk ------------------------------------------------------

# The furnished room of phase 10 written to disk in the Replica-event layout and
# read back through the port's reader (data/datasets.py, data/png.py): the same
# frames, bit for bit. Past the four timed blocks (frames 6-25) one more block,
# untimed, in which the host synchronisations are counted (PyTorch's sync debug
# mode slows the host), then two frames more, as bench.py writes two past its
# window (bench.py:39): the final colour refinement comes last (frame 32).
SCENE_DIR = os.path.join(cuda_build.BUILD_DIR, "room_scene")
PIPE_WARM = 6    # frames 0-5: the first mapping call, the first steady call
PIPE_BLOCK = 5   # then blocks of five frames, each ending with its mapping call
SCENE_FRAMES = MAP_FRAMES + PIPE_BLOCK + 2
EVENTNET_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pretrained",
                            "eventnet_mapdomain.npz")


def write_room_scene(cam):
    """Write (or keep, when current) the furnished room at the camera's width."""
    t0 = time.perf_counter()
    frag = make_synthetic_replica(SCENE_DIR, n_frames=SCENE_FRAMES, H=cam.H, W=cam.W,
                                  fx=cam.fx, fy=cam.fy, bound=ROOM, traj_step=0.01,
                                  furnished=True, reuse_if_current=True)
    say(f"scene: {SCENE_FRAMES} frames {cam.H}x{cam.W} of the furnished room written to "
        f"{SCENE_DIR} in {time.perf_counter() - t0:.1f} s (set-up)")
    return frag


def pipeline_config(frag):
    """configs/nice_slam.yaml with bench.py's overrides (bench.py:53-84), but
    keyframe_every 5 as phase 10 has it: K reaches 5 and BA turns on."""
    cfg = load_config(default_config_path(nice=True))
    update_recursive(cfg, frag)
    update_recursive(cfg, {
        "verbose": False, "enable_vis": False, "metrics_flush_batch": 10**9,
        "event": {"pretrained_path": EVENTNET_NPZ, "rgbd_every_frame": 5,
                  "activate_events": True, "balancer": 0.025, "scale_factor": 0.15,
                  "blur": True, "kernel_sizes": [9], "unblurred_weight": 0,
                  "kernel_weights": [1]},
        "tracking": {"ignore_edge_W": 100, "ignore_edge_H": 100},
        "mapping": {"mesh_freq": 10**9, "ckpt_freq": 10**9, "iters_first": MAP_ITERS_FIRST,
                    "keyframe_every": MAP_KEYFRAME_EVERY},
        "data": {"output": os.path.join(SCENE_DIR, "output")},
    })
    return cfg


def pipeline_from_disk(frag, dev, ate_in_memory):
    """``EvenNICERSLAM`` over the scene on disk: ``step`` 0-5,
    ``preload_device`` 6-31, ``step`` in four timed blocks of five frames,
    each ending with its mapping call and a synchronise, one more block with
    the host synchronisations counted, then the sequence's last two frames
    (the final colour refinement). Checks the ATE of frames 0-25 against
    ATE_BENCH_BAR, that every steady call took the device pose, that the
    tracked frames went through both kernels, that no steady block
    synchronised with the host, and that a checkpoint of the last frame
    restores into a fresh pipeline bit for bit. ``ate_in_memory`` is phase
    10's reading on frames 0-25, printed beside. Returns (failures, results,
    launches)."""
    cfg = pipeline_config(frag)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slam = EvenNICERSLAM(cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    for idx in range(PIPE_WARM):
        slam.step(idx)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    end = PIPE_WARM + 4 * PIPE_BLOCK
    t0 = time.perf_counter()
    slam.frame_reader.preload_device(range(PIPE_WARM, end + PIPE_BLOCK + 1))
    slam._flush_metrics(force=True)
    torch.cuda.synchronize()
    preload_s = time.perf_counter() - t0
    blocks, syncs = [], []
    for b in range(4):
        t0 = time.perf_counter()
        for idx in range(PIPE_WARM + b * PIPE_BLOCK, PIPE_WARM + (b + 1) * PIPE_BLOCK):
            slam.step(idx)
        torch.cuda.synchronize()
        blocks.append(PIPE_BLOCK / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    window, ba = slam.mapper.last_window_size, slam.mapper.BA_active
    # before any pose is read back: a pose read to the host goes up again
    # from pageable memory when the next frame is tracked from it
    with count_syncs(syncs):
        for idx in range(end, end + PIPE_BLOCK):
            slam.step(idx)
    torch.cuda.synchronize()
    slam._flush_metrics(force=True)
    est = slam.estimate_c2w_list[:end].astype(np.float64)
    gt = slam.gt_c2w_list[:end].astype(np.float64)
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    steady_calls = (end + PIPE_BLOCK - 1) // slam.m_cfg.every_frame

    # the sequence's end: the last frame, whose pose is staged into pinned
    # memory as it is tracked and read by the final colour refinement (five
    # calls, the window doubled)
    n_img = len(slam.frame_reader)
    t0 = time.perf_counter()
    for idx in range(end + PIPE_BLOCK, n_img):
        slam.step(idx)
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    n_fwd, n_bwd = launches()
    tcfg = slam.t_cfg
    want_launches = sum(tcfg.iters * (2 if i % tcfg.rgbd_every_frame == 0 else 1)
                        for i in range(1, n_img))

    # a checkpoint of the last frame restored into a fresh pipeline
    slam._flush_metrics(force=True)
    slam.mapper.keyframes.sync_host_poses()
    t0 = time.perf_counter()
    path = slam.logger.log(slam, n_img - 1)
    fresh = EvenNICERSLAM(cfg, device=dev)
    start = CheckpointLogger.restore(fresh, path)
    ckpt_s = time.perf_counter() - t0
    same = (all(torch.equal(a, b) for (_, a), (_, b) in
                zip(_leaves((slam.grids, slam.decoders)), _leaves((fresh.grids, fresh.decoders))))
            and np.array_equal(fresh.estimate_c2w_list, slam.estimate_c2w_list)
            and fresh.mapper.keyframes.indices == slam.mapper.keyframes.indices
            and start == n_img)
    res = {"frames": end, "scene_frames": len(slam.frame_reader),
           "fps_blocks": blocks, "fps_median": float(np.median(blocks)),
           "warm_s": warm_s, "preload_s": preload_s, "pipeline_build_s": build_s,
           "ate_rmse_m": ate, "ate_bar_m": ATE_BENCH_BAR,
           "ate_in_memory_phase10_m": ate_in_memory,
           "err_mm_per_frame": [round(1e3 * e, 2) for e in err],
           "n_fast_maps": slam.n_fast_maps, "steady_calls": steady_calls,
           "keyframes": slam.mapper.keyframes.indices,
           "window_frame_25": window, "BA_frame_25": ba, "end_of_sequence_s": tail_s,
           "mapping_calls": slam.mapping_cnt,
           "fwd_launches": n_fwd, "bwd_launches": n_bwd, "expected_launches": want_launches,
           "syncs_in_steady_block": len(syncs), "sync_sites": sorted(set(syncs))[:6],
           "peak_memory_gib": peak, "checkpoint_bitwise": same, "checkpoint_s": ckpt_s,
           "host_dispatch": slam.timers.summary()}
    say("pipeline from disk: " + json.dumps(res))
    failed = []
    if not ate <= ATE_BENCH_BAR:
        failed.append(f"ATE {ate:.4f} m above {ATE_BENCH_BAR} m")
    if slam.n_fast_maps != steady_calls:
        failed.append(f"{slam.n_fast_maps} of {steady_calls} steady mapping calls took the "
                      "device pose")
    if not (n_fwd > 0 and n_bwd > 0 and n_fwd == n_bwd == want_launches):
        failed.append(f"the pipeline launched the decode kernels {n_fwd} / {n_bwd} times, "
                      f"expected {want_launches} each")
    if not (window == 5 and ba):
        failed.append("the mapping call of frame 25 did not run at K = 5 with BA")
    if syncs:
        failed.append(f"a steady block synchronised with the host {len(syncs)} times, at "
                      f"{sorted(set(syncs))[:6]}")
    if slam.mapping_cnt != steady_calls + 2 or slam.n_fast_maps != steady_calls:
        failed.append(f"the sequence's end did not refine the colour at frame {n_img - 1} "
                      "from the pose read back")
    if not same:
        failed.append("the checkpoint did not restore bit for bit")
    return [f"pipeline from disk: {f}" for f in failed], res, (n_fwd, n_bwd)


def run_pipeline(frag, dev, rgbd_every_frame, seed=None, plant=None, label="every"):
    """``EvenNICERSLAM.run`` over frames 0-25 of the scene on disk (no
    checkpoint, no final colour refinement: the scene runs on) with RGB-D
    on every ``rgbd_every_frame``-th frame; ``seed`` replaces the
    configuration's, ``plant(slam)`` plants a fault before the first frame.
    Returns (ATE, RMSE of a camera held at frame 0, per-frame error in mm,
    the pipeline), lengths in metres."""
    cfg = pipeline_config(frag)
    cfg["event"]["rgbd_every_frame"] = rgbd_every_frame
    cfg["data"]["output"] = os.path.join(SCENE_DIR, f"output_{label}")
    if seed is not None:
        cfg["seed"] = seed
    slam = EvenNICERSLAM(cfg, device=dev)
    if plant is not None:
        plant(slam)
    est = slam.run(end_frame=MAP_FRAMES, mesh=False, checkpoint=False)[:MAP_FRAMES]
    gt = slam.gt_c2w_list[:MAP_FRAMES].astype(np.float64)
    err = np.linalg.norm(est[:, :3, 3].astype(np.float64) - gt[:, :3, 3], axis=1)
    held = float(np.sqrt(np.mean(np.sum((gt[:, :3, 3] - gt[0, :3, 3]) ** 2, axis=1))))
    return float(np.sqrt(np.mean(err ** 2))), held, [round(1e3 * e, 2) for e in err], slam


def pipeline_every_frame(frag, dev):
    """The pipeline from disk with RGB-D + event on every frame, through
    ``EvenNICERSLAM.run``: its ATE of frames 0-25 must lie below the RMSE of
    a camera held at frame 0, as phase 10's does on the same schedule (the
    bench schedule's bar does not tell a tracker from a held camera).
    Returns (failures, results, launches)."""
    reset_launches()
    t0 = time.perf_counter()
    ate, held, err, slam = run_pipeline(frag, dev, 1)
    torch.cuda.synchronize()
    n_fwd, n_bwd = launches()
    want = 2 * slam.t_cfg.iters * (MAP_FRAMES - 1)
    res = {"frames": MAP_FRAMES, "ate_rmse_m": ate, "held_camera_rmse_m": held,
           "err_mm_per_frame": err, "keyframes": slam.mapper.keyframes.indices,
           "n_fast_maps": slam.n_fast_maps, "fwd_launches": n_fwd, "bwd_launches": n_bwd,
           "run_s": time.perf_counter() - t0}
    say("pipeline from disk, RGB-D + event on every frame (EvenNICERSLAM.run): "
        + json.dumps(res))
    failed = []
    if not ate < held:
        failed.append(f"ATE {ate:.4f} m is not below the held camera's {held:.4f} m")
    if (n_fwd, n_bwd) != (want, want):
        failed.append(f"the decode kernels launched {n_fwd} / {n_bwd} times, expected {want}")
    return [f"pipeline from disk, RGB-D every frame: {f}" for f in failed], res, (n_fwd, n_bwd)


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
    cuda_build.build_all(["fused_decode", "fused_decode_bwd"])  # side by side
    lib = fused_decode.kernel_library()
    lib_b = fused_decode.bwd_kernel_library()
    build_s = time.perf_counter() - t0
    say(f"built both kernels in {build_s:.1f} s (set-up)")
    ptxas = {}
    for name, warps, points, smem in (
            ("fused_decode", lib.fused_decode_warps(), lib.fused_decode_warp_points(),
             lib.fused_decode_smem_bytes()),
            ("fused_decode_bwd", lib_b.fused_decode_bwd_warps(),
             lib_b.fused_decode_bwd_warp_points(), lib_b.fused_decode_bwd_smem_bytes())):
        log = cuda_build.BUILD_LOG[name]
        ptxas[name] = {"warps": warps, "points_per_warp": points, "smem_bytes": smem,
                       **cuda_build.ptxas_usage(str(log["ptxas"]))}
        say(f"  {log['lib']}: {float(log['seconds']):.1f} s; {warps} warps a block, "
            f"{points} points a warp tile, {smem} B of shared memory per block")
        for line in str(log["ptxas"]).splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                say("    ptxas: " + line.strip())

    # ---- 3. the kernel against its plain version ---------------------------
    cfg, grids, decoders, packed = make_scene(dev)
    bound_t = torch.from_numpy(BOUND).to(dev)
    if not fused_decode.supports(decoders):
        raise RuntimeError("the shipped decoder trio must be supported by the kernel")
    small = check_kernel(decoders, packed, bound_t, N_SMALL, dev, iters=20, plain_iters=5)
    main_res = check_kernel(decoders, packed, bound_t, N_MAIN, dev,
                            iters=3 if opts.quick else 5, plain_iters=2)
    bwd_small = check_bwd_kernel(decoders, packed, bound_t, N_SMALL, dev,
                                 iters=20, plain_iters=5)
    bwd_main = check_bwd_kernel(decoders, packed, bound_t, N_MAIN, dev,
                                iters=3 if opts.quick else 5, plain_iters=2)
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
    reset_launches()
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
    launches_main = launches()[0]
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
    with plain_decode():
        d_p, c_p = lo_render()
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

    # ---- 6. the pose gradient through the whole score -----------------------------
    grad_res = check_pose_gradient(mp, decoders, packed, bound_t, dev)

    # ---- 7. tracking at full width through Tracker.track --------------------------
    frames = upload_frames(cam, dev)
    track_sequence(mp, frames, decoders, packed, dev, "first pass, warm-up")
    reset_launches()
    track_recs = track_sequence(mp, frames, decoders, packed, dev, "second pass")
    launches_track_fwd, launches_track_bwd = launches()
    ev_frames = [r for r in track_recs if not r["rgbd"]]
    rgbd_frames = [r for r in track_recs if r["rgbd"]]
    iters = tcfg.iters
    say(f"tracking, {iters} iterations a frame (forward + backward + Adam), one "
        f"synchronise at the end of each frame: event only "
        f"{min(r['wall_ms'] for r in ev_frames):.1f}-{max(r['wall_ms'] for r in ev_frames):.1f} "
        f"ms a frame = {min(r['wall_ms'] for r in ev_frames) / iters:.2f} ms an iteration "
        f"at best; RGB-D + event {rgbd_frames[0]['wall_ms']:.1f} ms a frame = "
        f"{rgbd_frames[0]['wall_ms'] / iters:.2f} ms an iteration. The host had the frame "
        f"enqueued after {min(r['enqueue_ms'] for r in ev_frames):.1f}-"
        f"{max(r['enqueue_ms'] for r in ev_frames):.1f} ms (event only) and "
        f"{rgbd_frames[0]['enqueue_ms']:.1f} ms (RGB-D + event): a float() or .item() "
        f"inside the loop would make the host wait for the device in every iteration "
        f"and give up that lead. Launches on the tracking path: forward "
        f"{launches_track_fwd}, backward {launches_track_bwd}")
    if launches_track_fwd != 7 * iters or launches_track_bwd != 7 * iters:
        raise RuntimeError("the tracking path did not go through both kernels as expected")

    # ---- 8. one frame through the kernels and through the plain versions ----------
    kp_res = track_kernel_vs_plain(mp, frames, decoders, packed, bound_t, dev)

    # ---- 9. one self-consistent frame (reported only) ----------------------------
    self_res = self_consistent_frame(mp, renderer, decoders, packed, bound_t, dev)

    # ---- 10. map and track, interleaved, at full width ----------------------------
    # The bench schedule (event only, RGB-D every fifth frame) held to the JAX
    # package's trajectory error on the same frames; RGB-D + event on every
    # frame held below the error of a camera held at frame 0.
    frag = write_room_scene(cam)
    m_frames = room_frames(frag, dev, MAP_FRAMES)
    reset_launches()
    failed, map_res = map_and_track(
        cfg, mp, dev, m_frames, tcfg._replace(rgbd_every_frame=1), "RGB-D + event every frame",
        lambda held: held)
    failed_bench, bench_res = map_and_track(
        cfg, mp, dev, m_frames, tcfg, "bench schedule, RGB-D every 5th",
        lambda held: ATE_BENCH_BAR)
    launches_map_fwd, launches_map_bwd = launches()
    failed += failed_bench
    if failed:
        say("map and track FAILED: " + "; ".join(failed))

    # ---- 11. one steady mapping call on the card and on the CPU -------------------
    cpu_res = mapping_card_vs_cpu(*steady_mapping_state(cfg, cam, dev, m_frames), dev)

    # ---- 12. the pipeline from disk -----------------------------------------------
    failed_pipe, pipe_res, (launches_pipe_fwd, launches_pipe_bwd) = pipeline_from_disk(
        frag, dev, bench_res["ate_rmse_m"])
    failed += failed_pipe
    failed_every, every_res, (launches_every_fwd, launches_every_bwd) = pipeline_every_frame(
        frag, dev)
    failed += failed_every
    launches_pipe_fwd += launches_every_fwd
    launches_pipe_bwd += launches_every_bwd
    if failed:
        raise RuntimeError("; ".join(failed))

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
        "launches": launches_main + launches_track_fwd + launches_map_fwd + launches_pipe_fwd,
        "launches_scores": launches_main,
        "launches_tracking": launches_track_fwd,
        "launches_map_and_track": launches_map_fwd,
        "launches_pipeline": launches_pipe_fwd,
        "max_abs_err": max(main_res["max_abs_err"], small["max_abs_err"]),
        "ms": main_res["ms"],
        "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"],
        "bound_by": main_res["bound_by"],
        "library_ms": None,
        "n_points": N_MAIN,
        "kernel_only_ms": main_res["kernel_only_ms"],
        "bound_share": main_res["bound_ms"] / main_res["kernel_only_ms"],
        "design": FWD_DESIGN.format(points=ptxas["fused_decode"]["points_per_warp"]),
        **ptxas["fused_decode"],
        "launches_render_img": launches_img,
        "small": small,
    }, {
        "name": "fused_decode_bwd",
        "route": "cuda",
        "source": "evennicer_slam_tpu_torch/csrc/fused_decode_bwd.cu",
        "replaces": "evennicer_slam_tpu/ops/fused_decode.py:188",
        "launches": launches_track_bwd + launches_map_bwd + launches_pipe_bwd,
        "launches_tracking": launches_track_bwd,
        "launches_map_and_track": launches_map_bwd,
        "launches_pipeline": launches_pipe_bwd,
        "max_abs_err": max(bwd_main["max_abs_err"], bwd_small["max_abs_err"]),
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "n_points": N_MAIN,
        "kernel_only_ms": bwd_main["kernel_only_ms"],
        "bound_share": bwd_main["bound_ms"] / bwd_main["kernel_only_ms"],
        "design": BWD_DESIGN.format(
            points=ptxas["fused_decode_bwd"]["points_per_warp"]),
        **ptxas["fused_decode_bwd"],
        "main": {k: bwd_main[k] for k in ("dp", "dfrac_m", "dfrac_f")},
        "small": bwd_small,
        "pose_gradient_vs_plain": grad_res,
        "tracked_frame_vs_plain": kp_res,
        "self_consistent_frame": self_res,
    }]
    say("mapping: " + json.dumps({
        "map_and_track": {k: v for k, v in map_res.items() if k != "err_mm_per_frame"},
        "bench_schedule": {k: bench_res[k] for k in (
            "ate_rmse_m", "ate_bar_m", "held_camera_rmse_m", "event_corr_mean",
            "steady_call_ms")},
        "card_vs_cpu": cpu_res}))
    say("pipeline: " + json.dumps({k: pipe_res[k] for k in (
        "fps_blocks", "fps_median", "ate_rmse_m", "ate_in_memory_phase10_m", "n_fast_maps",
        "syncs_in_steady_block", "peak_memory_gib", "checkpoint_bitwise")}
        | {"every_frame": {k: every_res[k] for k in ("ate_rmse_m", "held_camera_rmse_m")}}))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
