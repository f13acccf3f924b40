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
    call, the host synchronisations inside each steady call; on the bench
    schedule, event only with RGB-D every fifth frame (its ATE held to the
    JAX package's on the same frames; RGB-D + event on every frame, held
    below a camera held at frame 0, runs in the pipeline's ``run`` below);
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
    event on every frame, its ATE held below a camera held at frame 0, and
    its two final meshes (``final_mesh.ply``, ``final_mesh_eval_rec.ply``) at
    the shipped resolution 256, each timed by part (sweep, marching, clean,
    colours, export) with its faces and peak device memory;
  - reconstruction (phase 13): ``Mesher.masked_occ_sweep`` at resolution 64
    on that fitted map on the card and on the CPU (logits and hull masks
    within limits); both final meshes scored against the analytic room
    (``scene_gt_mesh``) with ``tools/eval_recon.py`` — the accuracy of
    ``final_mesh.ply`` and the eval-rec mesh's completion ratio over the
    observed surface held to bars, which the meshes of an untransposed
    volume and of the map before its first mapping call must fail — and the
    eval-rec mesh's depth L1 of a few interior views;
    then the command line, ``evennicer_slam_tpu_torch.run.main``, in process
    over frames 0-5 into ``build/cli_out``: a checkpoint, ``final_mesh.ply``
    and a finite ATE of that checkpoint;
  - iMAP (phase 14): ``configs/imap.yaml`` at its full width (one MLP
    93 -> 256 x 4 -> 4, 32 + 12 samples with density compositing, tracking
    5,000 pixels x 50 iterations, mapping 1,500 iterations first and
    3 x 100 every fifth frame, meshing at 256^3 at density level 10 with
    colours rendered along the vertex normals) through
    ``EvenNICERSLAM(cfg, nice=False).run`` over frames 0-25 of the same
    scene: ms per tracked frame and per mapping call, the share of a steady
    call's device time in matrix products, peak memory, the mesh by part,
    the ATE held below a camera held at frame 0, the mesh scored against the
    analytic room, the along-normal colours of 2,000 vertices card vs CPU,
    and no fused decode launched; then ``run.main([... "--imap",
    "--end_frame", "6"])`` and ``tools/eval_ate.py --imap`` on its
    checkpoint;
  - shipped formats (phase 15): the scene again with JPEG colour frames,
    decode and undistort times, blocks not preloaded, ``run()`` over it, the
    visualiser's panels;
  - the event network (phase 16): EventNet trained from scratch at 102x180,
    batch 4 (``models/eventnet_train.py::train_step``; ms a step, peak
    memory, the loss; one step card against CPU; two 10-step runs compared
    bit for bit; a profile of a step by kind of kernel), then the shipped
    net's recipe through the port's ``tools/event_ablation.py`` at 240x320
    over 26 frames (the map-domain net trained from scratch on 128 triples,
    its loss on 32 held-out triples below the untrained net's and beside the
    shipped net's, ``A_dead_reckoning`` and ``C_events_reference`` tracked,
    C's ATE held to ``ATE_BENCH_BAR``). One cut: the first mapping call of
    each of its three pipeline runs has 300 iterations, not 1,500.

Scene grids and decoders start random, from a seed; only the mapping phase
fits them. Every phase that fails ends the run with a non-zero exit code. Without a CUDA
device the script exits non-zero and prints no result. Output, last three
lines: one JSON object ``{"kernels": [...]}``, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import copy
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
import warnings
from types import SimpleNamespace

import numpy as np
import torch
import yaml

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; the port runs on a GPU\n")
    sys.exit(1)

from evennicer_slam_tpu_torch import convert  # noqa: E402
from evennicer_slam_tpu_torch import run as port_run  # noqa: E402
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
from evennicer_slam_tpu_torch.data.jpeg import decode_jpeg, write_jpeg  # noqa: E402
from evennicer_slam_tpu_torch.data.png import read_png  # noqa: E402
from evennicer_slam_tpu_torch.data.undistort import Undistorter  # noqa: E402
from evennicer_slam_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_replica,
    scene_gt_mesh,
    synthetic_frames,
)
from evennicer_slam_tpu_torch.mesh import mesher as mesher_module  # noqa: E402
from evennicer_slam_tpu_torch.mesh.mesher import Mesher  # noqa: E402
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh  # noqa: E402
from evennicer_slam_tpu_torch.models.decoders import (  # noqa: E402
    init_nice_decoders,
    pack_grids_for_tracking,
)
from evennicer_slam_tpu_torch.models import eventnet_train  # noqa: E402
from evennicer_slam_tpu_torch.models.eventnet import init_eventnet, load_eventnet_npz  # noqa: E402
from evennicer_slam_tpu_torch.models.eventnet_train import make_pair_batch  # noqa: E402
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
from evennicer_slam_tpu_torch.slam.mapper import Mapper, MapperConfig, stage_schedule  # noqa: E402
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM  # noqa: E402
from evennicer_slam_tpu_torch.slam.tracker import (  # noqa: E402
    Tracker,
    TrackerConfig,
    _prep_event_inputs,
    track_frame,
    tracking_loss,
)
from evennicer_slam_tpu_torch.tools.eval_ate import evaluate_checkpoint  # noqa: E402
from evennicer_slam_tpu_torch.tools.eval_recon import (  # noqa: E402
    calc_2d_metric,
    calc_3d_metric,
    completion_seen,
    seen_surface,
)
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger  # noqa: E402
from evennicer_slam_tpu_torch.utils.optim import adam_init, adam_update, tree_map  # noqa: E402
from evennicer_slam_tpu_torch.utils.runtime import setup_torch  # noqa: E402
from evennicer_slam_tpu_torch.utils.visualizer import MARGIN as VIS_MARGIN  # noqa: E402

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
# phase 10 maps and tracks frames 0-5 by hand (a first call, one steady call);
# the pipeline (phase 12) runs the whole 26 frames, K = 5 and BA at frame 25
MAP_TRACK_FRAMES = 6
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
    if not all(c["K"] >= 2 and c["device_pose"] for c in calls[1:]):
        failed.append("a steady mapping call did not take the device pose with a window "
                      "of two frames or more")
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

    def no_colour(n, cfg, coarse_mapper, color_refine, nice=True):
        stages, seg = schedule(n, cfg, coarse_mapper, color_refine, nice)
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
    10's reading on frames 0-5, printed beside. Returns (failures, results,
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


def run_pipeline(frag, dev, rgbd_every_frame, seed=None, plant=None, label="every",
                 mesh=False):
    """``EvenNICERSLAM.run`` over frames 0-25 of the scene on disk (no
    checkpoint, no final colour refinement: the scene runs on) with RGB-D
    on every ``rgbd_every_frame``-th frame; ``seed`` replaces the
    configuration's, ``plant(slam)`` plants a fault before the first frame;
    ``mesh`` writes both final meshes (``meshing.eval_rec`` on) at the
    configuration's resolution. Returns (ATE, RMSE of a camera held at frame
    0, per-frame error in mm, the pipeline), lengths in metres."""
    cfg = pipeline_config(frag)
    cfg["event"]["rgbd_every_frame"] = rgbd_every_frame
    cfg["data"]["output"] = os.path.join(SCENE_DIR, f"output_{label}")
    cfg["meshing"]["eval_rec"] = mesh
    if seed is not None:
        cfg["seed"] = seed
    slam = EvenNICERSLAM(cfg, device=dev)
    if plant is not None:
        plant(slam)
    est = slam.run(end_frame=MAP_FRAMES, mesh=mesh, checkpoint=False)[:MAP_FRAMES]
    gt = slam.gt_c2w_list[:MAP_FRAMES].astype(np.float64)
    err = np.linalg.norm(est[:, :3, 3].astype(np.float64) - gt[:, :3, 3], axis=1)
    held = float(np.sqrt(np.mean(np.sum((gt[:, :3, 3] - gt[0, :3, 3]) ** 2, axis=1))))
    return float(np.sqrt(np.mean(err ** 2))), held, [round(1e3 * e, 2) for e in err], slam


def instrument_mesher(slam, records):
    """Wrap ``slam.mesher.get_mesh``: each call appends its seconds by part,
    its vertex and face counts (``Mesher.last_stats``) and the device
    memory it peaked at to ``records``."""
    get_mesh = slam.mesher.get_mesh

    def measured(path, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = get_mesh(path, *args, **kw)
        records.append({"mesh": os.path.basename(path), **slam.mesher.last_stats,
                        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "above_start_gib": (torch.cuda.max_memory_allocated() - base) / 2**30})
        return out

    slam.mesher.get_mesh = measured


def pipeline_every_frame(frag, dev):
    """The pipeline from disk with RGB-D + event on every frame, through
    ``EvenNICERSLAM.run`` with its meshes (``final_mesh.ply`` and
    ``final_mesh_eval_rec.ply`` at resolution 256): its ATE of frames 0-25
    must lie below the RMSE of a camera held at frame 0, as phase 10's does
    on the same schedule (the bench schedule's bar does not tell a tracker
    from a held camera). Returns (failures, results, launches, the pipeline,
    its map before the first mapping call, the meshes' records)."""
    mesh_recs, start = [], {}

    def plant(slam):
        start["state"] = copy.deepcopy((slam.grids, slam.decoders))
        instrument_mesher(slam, mesh_recs)

    reset_launches()
    t0 = time.perf_counter()
    ate, held, err, slam = run_pipeline(frag, dev, 1, plant=plant, mesh=True)
    torch.cuda.synchronize()
    n_fwd, n_bwd = launches()
    want = 2 * slam.t_cfg.iters * (MAP_FRAMES - 1)
    res = {"frames": MAP_FRAMES, "ate_rmse_m": ate, "held_camera_rmse_m": held,
           "err_mm_per_frame": err, "keyframes": slam.mapper.keyframes.indices,
           "n_fast_maps": slam.n_fast_maps, "fwd_launches": n_fwd, "bwd_launches": n_bwd,
           "run_s": time.perf_counter() - t0,
           "meshing_s": sum(r["total_s"] for r in mesh_recs)}
    say("pipeline from disk, RGB-D + event on every frame (EvenNICERSLAM.run, with its "
        "meshes): " + json.dumps(res))
    failed = []
    if not ate < held:
        failed.append(f"ATE {ate:.4f} m is not below the held camera's {held:.4f} m")
    if (n_fwd, n_bwd) != (want, want):
        failed.append(f"the decode kernels launched {n_fwd} / {n_bwd} times, expected {want}")
    if [r["mesh"] for r in mesh_recs] != ["final_mesh.ply", "final_mesh_eval_rec.ply"]:
        failed.append(f"run() wrote the meshes {[r['mesh'] for r in mesh_recs]}")
    return ([f"pipeline from disk, RGB-D every frame: {f}" for f in failed], res,
            (n_fwd, n_bwd), slam, start["state"], mesh_recs)


# ---- 13. reconstruction ---------------------------------------------------------------
# The meshes of phase 12's every-frame run, scored against the analytic room
# (data/synthetic.py::scene_gt_mesh): accuracy and completion over the whole
# ground truth (tools/eval_recon.py::calc_3d_metric, ICP-aligned), completion
# over the ground truth that frames 0-25 observed
# (tools/eval_recon.py::seen_surface and completion_seen), and the depth L1 of a few interior
# views (calc_2d_metric, all views: 26 frames observe too little of the room
# for the unseen-view rejection to leave any). Bars: RECON_BARS; two planted
# faults must fail them.
SWEEP_CHECK_RES = 64  # 262,144 lattice points, card against CPU
# card against CPU from the same grids and decoders: the decode's float32
# products sum in another order (logits 1e-5 apart expected, a fault in the
# lattice or the decode moves them by whole units); the hull test is
# elementwise float32 on both sides, so its masks should agree exactly, and
# a point within rounding of a plane may flip (the CPU tests allow this share)
SWEEP_LOGIT_ATOL = 1e-2
SWEEP_MASK_SHARE = 1e-4
# Bars on the two final meshes (measured on an NVIDIA H100 80GB HBM3 at
# 700 W, scripts/ate_spread.py --pipeline --mesh over seeds 42, 42, 0-5;
# PERF.md section 6). final_mesh.ply keeps what the keyframes saw; its
# accuracy reads 1.54-2.52 cm sound, 9.36-10.62 cm with x and y swapped and
# 16.86-26.51 cm from the map before mapping, so it holds the accuracy bar.
# The eval-rec mesh keeps whatever any frame's frustum saw, floaters behind
# the walls included: its accuracy (1.67-8.37 cm sound) overlaps the swap's
# (9.31-12.76 cm), so it holds the completion ratio over the observed
# surface (96.86-99.57 % sound, 85.91-89.21 % swapped). A faulty build makes
# both meshes faulty, so a planted fault is caught when either mesh fails.
RECON_BARS = {
    "final_mesh": {"accuracy (cm)": ("<=", 5.0)},
    "final_mesh_eval_rec": {"completion_ratio_seen (<5cm %)": (">=", 94.0)},
}
RECON_2D_VIEWS = 10
RECON_FAULTS = ("volume without its transpose", "map before its first mapping call")
CLI_FRAMES = 6
CLI_OUT = os.path.join(cuda_build.BUILD_DIR, "cli_out")


def sweep_card_vs_cpu(slam):
    """``masked_occ_sweep`` at resolution SWEEP_CHECK_RES on the card and on
    the CPU from the same grids, decoders and hull."""
    grid = slam.mesher.get_grid_uniform(SWEEP_CHECK_RES)
    hull = slam.mesher.get_bound_from_frames(slam.mapper.keyframes.frames)
    t0 = time.perf_counter()
    z_card = slam.mesher.masked_occ_sweep(grid["xyz"], hull, slam.grids,
                                          slam.decoders).cpu().numpy()
    card_s = time.perf_counter() - t0

    def to_cpu(t):
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    cpu_mesher = Mesher(slam.cfg, slam.cam, slam.settings, slam.bound, device="cpu")
    t0 = time.perf_counter()
    z_cpu = cpu_mesher.masked_occ_sweep(grid["xyz"], hull, tree_map(to_cpu, slam.grids),
                                        tree_map(to_cpu, slam.decoders)).numpy()
    cpu_s = time.perf_counter() - t0
    in_card, in_cpu = z_card != 100, z_cpu != 100
    both = in_card & in_cpu
    res = {"points": int(z_card.size), "hull_facets": int(len(hull.equations)),
           "inside_share": float(in_card.mean()),
           "mask_disagreements": int((in_card != in_cpu).sum()),
           "mask_limit": int(SWEEP_MASK_SHARE * z_card.size),
           "max_logit_diff": float(np.abs(z_card - z_cpu)[both].max()),
           "logit_atol": SWEEP_LOGIT_ATOL,
           "logit_range": [float(z_card[both].min()), float(z_card[both].max())],
           "card_s": card_s, "cpu_s": cpu_s}
    failed = []
    if not res["mask_disagreements"] <= res["mask_limit"]:
        failed.append(f"{res['mask_disagreements']} hull-mask disagreements")
    if not res["max_logit_diff"] <= SWEEP_LOGIT_ATOL:
        failed.append(f"logits {res['max_logit_diff']:.3e} apart")
    return failed, res


def seen_gt_points(slam, gt_mesh):
    """Ground-truth surface samples that frames 0-25 observed
    (``tools/eval_recon.py::seen_surface``), and their share."""
    gt_pts, seen = seen_surface(gt_mesh, ((slam.gt_c2w_list[i], slam.frame_reader[i].depth)
                                          for i in range(MAP_FRAMES)), slam.cam)
    return gt_pts[seen], float(seen.mean())


def score_mesh(rec_path, gt_path, seen_pts, bars):
    """3-D metrics against the whole ground truth, completion over its seen
    part (``tools/eval_recon.py``), and whether every one of ``bars``
    ({metric: (op, value)}) holds. A missing mesh passes none."""
    if not os.path.exists(rec_path):
        return {"mesh": None, "passes_bars": False}
    t0 = time.perf_counter()
    res = {**calc_3d_metric(rec_path, gt_path), **completion_seen(rec_path, seen_pts),
           "score_s": time.perf_counter() - t0}
    res["passes_bars"] = all(res[k] <= v if op == "<=" else res[k] >= v
                             for k, (op, v) in bars.items())
    return res


def mesh_faults(slam, start_state, gt_path, seen_pts):
    """Both final meshes made again with each of RECON_FAULTS planted, and
    scored against their bars: {fault: {mesh: scores}}."""
    last = MAP_FRAMES - 1
    faults = {}
    for fault in RECON_FAULTS:
        swapped = fault == RECON_FAULTS[0]
        grids, decoders = (slam.grids, slam.decoders) if swapped else start_state
        faults[fault] = {}
        for name in RECON_BARS:
            path = os.path.join(slam.output, "mesh", f"fault_{fault.split()[0]}_{name}.ply")
            if os.path.exists(path):
                os.remove(path)
            with untransposed_volume() if swapped else contextlib.nullcontext():
                mesh = slam.mesher.get_mesh(
                    path, grids, decoders, slam.mapper.keyframes.frames,
                    slam.estimate_c2w_list, last,
                    get_mask_use_all_frames=name == "final_mesh_eval_rec")
            faults[fault][name] = {"faces": 0 if mesh is None else len(mesh.faces),
                                   "mesh_s": slam.mesher.last_stats.get("total_s"),
                                   **score_mesh(path, gt_path, seen_pts, RECON_BARS[name])}
    return faults


@contextlib.contextmanager
def untransposed_volume():
    """Planted fault: the sweep's flat 'xy'-order values taken as the volume
    without the [1, 0, 2] transpose (x and y swapped)."""
    real = mesher_module.marching_cubes
    mesher_module.marching_cubes = lambda vol, **kw: real(vol.permute(1, 0, 2), **kw)
    try:
        yield
    finally:
        mesher_module.marching_cubes = real


def command_line(frag):
    """``evennicer_slam_tpu_torch.run.main`` in process on the scene on disk:
    frames 0-5 into ``CLI_OUT``; a checkpoint, ``mesh/final_mesh.ply`` and a
    finite ATE of the checkpoint (``tools/eval_ate.evaluate_checkpoint``,
    no plot)."""
    shutil.rmtree(CLI_OUT, ignore_errors=True)
    os.makedirs(CLI_OUT)
    cfg = pipeline_config(frag)
    cfg["data"]["output"] = CLI_OUT
    path = os.path.join(CLI_OUT, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    reset_launches()
    t0 = time.perf_counter()
    port_run.main([path, "--end_frame", str(CLI_FRAMES), "--output", CLI_OUT])
    run_s = time.perf_counter() - t0
    n_fwd, n_bwd = launches()
    want = sum(cfg["tracking"]["iters"] * (2 if i % cfg["event"]["rgbd_every_frame"] == 0
                                           else 1) for i in range(1, CLI_FRAMES))
    ckpt = CheckpointLogger.latest(os.path.join(CLI_OUT, "ckpts"))
    ate = evaluate_checkpoint(ckpt, scale=cfg["scale"], plot=None) if ckpt else {}
    rmse = ate.get("absolute_translational_error.rmse", float("nan"))
    mesh_path = os.path.join(CLI_OUT, "mesh", "final_mesh.ply")
    res = {"frames": CLI_FRAMES, "run_s": run_s, "checkpoint": ckpt and os.path.basename(ckpt),
           "ate_rmse_m": rmse, "final_mesh": os.path.exists(mesh_path),
           "final_mesh_faces": len(Mesh.load(mesh_path).faces) if os.path.exists(mesh_path)
           else 0, "fwd_launches": n_fwd, "bwd_launches": n_bwd, "expected_launches": want}
    failed = []
    if not (ckpt and ckpt.endswith(f"{CLI_FRAMES - 1:05d}.npz") and math.isfinite(rmse)):
        failed.append(f"checkpoint {ckpt}, ATE {rmse}")
    if not res["final_mesh_faces"] > 0:
        failed.append("no mesh/final_mesh.ply")
    if (n_fwd, n_bwd) != (want, want):
        failed.append(f"the decode kernels launched {n_fwd} / {n_bwd} times, expected {want}")
    return failed, res, (n_fwd, n_bwd)


def reconstruction(frag, slam, start_state, mesh_recs):
    """Phase 13: (a) the sweep on the card against the CPU, (b) the meshes
    of phase 12's every-frame run by part, (c) both meshes scored against
    the analytic room, each held to its RECON_BARS, and made again with each
    of RECON_FAULTS planted (each must fail the bars of one at least), (d)
    the command line in process.
    Returns (failures, results, launches of the command line)."""
    t_phase = time.perf_counter()
    failed, res = [], {}
    reset_launches()
    f, res["sweep_card_vs_cpu"] = sweep_card_vs_cpu(slam)
    failed += [f"sweep card vs CPU: {x}" for x in f]
    res["meshes"] = list(mesh_recs)

    out = slam.output
    gt_path = os.path.join(out, "gt_mesh.ply")
    gt_mesh = scene_gt_mesh(ROOM, furnished=True)
    gt_mesh.export(gt_path)
    seen_pts, seen_frac = seen_gt_points(slam, gt_mesh)
    res["gt_surface_seen_frac"] = seen_frac
    res["bars"] = RECON_BARS
    res["scores"] = {name: score_mesh(os.path.join(out, "mesh", name + ".ply"), gt_path,
                                      seen_pts, bars) for name, bars in RECON_BARS.items()}
    for name, score in res["scores"].items():
        if not score["passes_bars"]:
            failed.append(f"{name}.ply fails its bars")
    rec_path = os.path.join(out, "mesh", "final_mesh_eval_rec.ply")
    t0 = time.perf_counter()
    res["scores"]["final_mesh_eval_rec"]["2d"] = calc_2d_metric(rec_path, gt_path,
                                                                n_imgs=RECON_2D_VIEWS)
    res["scores"]["final_mesh_eval_rec"]["2d_s"] = time.perf_counter() - t0

    res["faults"] = mesh_faults(slam, start_state, gt_path, seen_pts)
    for fault, scores in res["faults"].items():
        if all(score["passes_bars"] for score in scores.values()):
            failed.append(f"planted fault '{fault}' passes the bars of both meshes")
    res["mesher_launches"] = list(launches())
    if res["mesher_launches"] != [0, 0]:
        failed.append(f"the mesher launched the decode kernels {res['mesher_launches']} times")

    f, res["command_line"], cli_launches = command_line(frag)
    failed += [f"command line: {x}" for x in f]
    res["phase_s"] = time.perf_counter() - t_phase
    say("reconstruction: " + json.dumps(res))
    return [f"reconstruction: {x}" for x in failed], res, cli_launches


# ---- 14. iMAP ------------------------------------------------------------------------
# The second model family, as ``run.py --imap`` runs it: configs/imap.yaml at
# its full width (680x1200; one MLP 93 -> 256 x 4 -> 4; 32 + 12 samples with
# density compositing, occupancy false, scale 0.1; tracking 5,000 pixels x 50
# iterations; mapping 5,000 pixels, 1,500 iterations first, then 300 every
# fifth frame as three calls of 100 at imap_decoders_lr; meshing at 256^3, level
# set 10 on density, colours rendered along the vertex normals) over frames
# 0-25 of phase 12's scene on disk. Changed from imap.yaml, and nothing else:
# the data paths (the scene's folders and camera, the output folder),
# enable_vis false, the scene's bound (mapping.bound, marching_cubes_bound) and
# the frame range (run(end_frame=26); the command line --end_frame 6).
# imap.yaml has no event section, so the pipeline tracks RGB-D on every frame
# and leaves the scene's events unread. No fused decode kernel lies on this
# path: the kernels cover the NICE trio, and iMAP's MLP runs as plain PyTorch
# matrix products in float32 (TF32 off).
IMAP_FRAMES = MAP_FRAMES
IMAP_CLI_FRAMES = 6
IMAP_OUT = os.path.join(SCENE_DIR, "output_imap")
IMAP_CLI_OUT = os.path.join(cuda_build.BUILD_DIR, "imap_cli_out")
IMAP_COLOUR_VERTICES = 2000
IMAP_PROFILE_ITERS = 20  # a steady call's iterations, traced from the fitted map
# card against CPU, the same map and vertices: float32 on both sides in other
# summation orders (measured 8.3e-7 at most on an NVIDIA H100 80GB HBM3 at
# 700 W, colours in [-0.21, 1.59]); an importance sample that crosses a CDF
# bin edge on one side only moves its vertex by more than rounding, so such
# vertices are counted and held to a share
IMAP_COLOUR_ATOL = 1e-4
IMAP_COLOUR_SHARE = 5e-3


def imap_config(frag, output):
    """Write the scene's fragment (its data paths, camera and bound) with
    ``enable_vis: false`` and ``output`` to ``output/config.yaml`` and load
    it over configs/imap.yaml, as ``run.py --imap`` loads a config. Returns
    (config, path)."""
    shutil.rmtree(output, ignore_errors=True)
    os.makedirs(output)
    scene = copy.deepcopy(frag)
    scene["data"]["output"] = output
    scene["enable_vis"] = False
    path = os.path.join(output, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(scene, f)
    return load_config(path, default_config_path(nice=False)), path


def host_timed(fn, records):
    """``fn`` with a synchronise before and after; each call appends its
    milliseconds on the host clock to ``records``."""
    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        records.append(1e3 * (time.perf_counter() - t0))
        return out
    return timed


def device_kernels(fn):
    """Run ``fn`` under ``torch.profiler`` with the CUDA device traced:
    (device ms in all, device ms of the kernels named *gemm*, wall ms)."""
    kernels, wall = _device_ms(fn, 1)
    return (sum(ms for ms, _ in kernels.values()),
            sum(ms for k, (ms, _) in kernels.items() if "gemm" in k.lower()), wall)


def _device_ms(fn, n):
    """``fn`` run ``n`` times under torch.profiler with the card traced:
    ({kernel name: (device ms a run, launches a run)}, wall ms a run)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels[e.key] = (us / 1e3 / n, e.count // n)
    return kernels, wall


def imap_colours_card_vs_cpu(slam, mesh):
    """The along-normal colours of IMAP_COLOUR_VERTICES vertices of the
    final mesh, rendered on the card and on the CPU from the same map."""
    scale = slam.cfg["scale"]
    inner = Mesh(mesh.vertices * scale, mesh.faces)
    normals = mesher_module._vertex_normals(inner)
    rng = np.random.default_rng(SEED)
    sel = rng.choice(len(inner.vertices), min(IMAP_COLOUR_VERTICES, len(inner.vertices)),
                     replace=False)
    v, n = inner.vertices[sel], normals[sel]
    card = slam.mesher.render_along_normals(v, n, slam.grids, slam.decoders)

    def to_cpu(t):
        return t.detach().cpu() if isinstance(t, torch.Tensor) else t

    cpu_mesher = Mesher(slam.cfg, slam.cam, slam.settings, slam.bound, device="cpu")
    cpu = cpu_mesher.render_along_normals(v, n, {}, tree_map(to_cpu, slam.decoders))
    diff = np.abs(card - cpu)
    return {"vertices": int(len(sel)), "max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
            "share_above_atol": float((diff.max(axis=1) > IMAP_COLOUR_ATOL).mean()),
            "atol": IMAP_COLOUR_ATOL, "share_limit": IMAP_COLOUR_SHARE,
            "colour_range": [float(card.min()), float(card.max())]}


def imap_command_line(frag):
    """``evennicer_slam_tpu_torch.run.main([... "--imap", "--end_frame", "6"])``
    in process into IMAP_CLI_OUT, then ``tools/eval_ate.py --imap`` on its
    checkpoint: a checkpoint of frame 5, a non-empty final_mesh.ply and a
    finite ATE."""
    import io

    from evennicer_slam_tpu_torch.tools import eval_ate

    _, path = imap_config(frag, IMAP_CLI_OUT)
    t0 = time.perf_counter()
    port_run.main([path, "--imap", "--end_frame", str(IMAP_CLI_FRAMES),
                   "--output", IMAP_CLI_OUT])
    run_s = time.perf_counter() - t0
    ckpt = CheckpointLogger.latest(os.path.join(IMAP_CLI_OUT, "ckpts"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        eval_ate.main([path, "--output", IMAP_CLI_OUT, "--imap", "--no_plot"])
    rmse = float("nan")
    for line in printed.getvalue().splitlines():
        if line.startswith("absolute_translational_error.rmse:"):
            rmse = float(line.split(":")[1])
    mesh_path = os.path.join(IMAP_CLI_OUT, "mesh", "final_mesh.ply")
    faces = len(Mesh.load(mesh_path).faces) if os.path.exists(mesh_path) else 0
    res = {"frames": IMAP_CLI_FRAMES, "run_s": run_s,
           "checkpoint": ckpt and os.path.basename(ckpt), "eval_ate_rmse_m": rmse,
           "final_mesh_faces": faces}
    failed = []
    if not (ckpt and ckpt.endswith(f"{IMAP_CLI_FRAMES - 1:05d}.npz") and math.isfinite(rmse)):
        failed.append(f"checkpoint {ckpt}, eval_ate RMSE {rmse}")
    if not faces > 0:
        failed.append("no mesh/final_mesh.ply with faces")
    return failed, res


def imap_phase(frag, dev):
    """Phase 14: ``EvenNICERSLAM(cfg, nice=False).run`` over frames 0-25 at
    imap.yaml's full width with its final mesh; ms per tracked frame and per
    mapping call (the first and the steady ones), the MLP's share of a
    steady call's device time (IMAP_PROFILE_ITERS of its iterations,
    traced), peak
    device memory, the mesh's seconds by part and faces, the ATE held below
    a camera held at frame 0, the mesh scored against the analytic room,
    the along-normal colours card vs CPU, no fused decode launched; then the
    command line. Returns (failures, results)."""
    t_phase = time.perf_counter()
    cfg, _ = imap_config(frag, IMAP_OUT)
    scale = cfg["scale"]
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = EvenNICERSLAM(cfg, nice=False, device=dev)
    track_ms, map_ms, mesh_recs = [], [], []
    slam.tracker.track = host_timed(slam.tracker.track, track_ms)
    slam._map_frame = host_timed(slam._map_frame, map_ms)
    instrument_mesher(slam, mesh_recs)
    t0 = time.perf_counter()
    est = slam.run(end_frame=IMAP_FRAMES, mesh=True, checkpoint=False)[:IMAP_FRAMES]
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    gt = slam.gt_c2w_list[:IMAP_FRAMES].astype(np.float64) / scale
    err = np.linalg.norm(est[:, :3, 3].astype(np.float64) / scale - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    held = float(np.sqrt(np.mean(np.sum((gt[:, :3, 3] - gt[0, :3, 3]) ** 2, axis=1))))

    # a call of a steady call's kind, from the fitted map, traced
    f = slam.frame_reader[IMAP_FRAMES - 1]
    images = (torch.from_numpy(np.array(f.color)).to(dev),
              torch.from_numpy(np.array(f.depth)).to(dev))
    pose = slam.estimate_c2w_list[IMAP_FRAMES - 1].copy()

    def steady_call():
        slam.mapper.optimize_map(IMAP_PROFILE_ITERS, slam.m_cfg.lr_factor, IMAP_FRAMES - 1,
                                 f.color, f.depth, f.event, pose.copy(),
                                 seed=(IMAP_FRAMES - 1) * 97, grids=slam.grids,
                                 decoders=slam.decoders, cur_images_dev=images)

    dev_ms, gemm_ms, prof_wall_ms = device_kernels(steady_call)

    mesh_path = os.path.join(IMAP_OUT, "mesh", "final_mesh.ply")
    mesh = Mesh.load(mesh_path) if os.path.exists(mesh_path) else None
    gt_path = os.path.join(IMAP_OUT, "gt_mesh.ply")
    scene_gt_mesh(ROOM, furnished=True).export(gt_path)
    score = calc_3d_metric(mesh_path, gt_path) if mesh is not None and len(mesh.faces) else {}
    colours = imap_colours_card_vs_cpu(slam, mesh) if score else {}
    n_fwd, n_bwd = launches()
    res = {"frames": IMAP_FRAMES, "config": {
               "hw": [slam.cam.H, slam.cam.W], "hidden": int(slam.decoders["imap"]["lin_w"][0]
                                                         .shape[1]),
               "blocks": len(slam.decoders["imap"]["lin_w"]),
               "samples": [slam.settings.n_samples, slam.settings.n_importance],
               "occupancy": slam.settings.occupancy, "scale": scale,
               "tracking": [slam.t_cfg.pixels, slam.t_cfg.iters],
               "mapping": [slam.m_cfg.pixels, slam.m_cfg.iters_first, slam.m_cfg.iters],
               "meshing": [slam.mesher.resolution, slam.mesher.level_set,
                           slam.mesher.color_mesh_extraction_method],
               "use_events": slam.use_events},
           "run_s": run_s, "ate_rmse_m": ate, "held_camera_rmse_m": held,
           "err_mm_per_frame": [round(1e3 * e, 2) for e in err],
           "track_ms_per_frame": {"n": len(track_ms), "median": float(np.median(track_ms)),
                                  "min": float(min(track_ms)), "max": float(max(track_ms))},
           "map_ms_first": map_ms[0], "map_ms_steady": map_ms[1:],
           "steady_traced": {"iterations": IMAP_PROFILE_ITERS, "wall_ms": prof_wall_ms,
                            "device_ms": dev_ms, "gemm_device_ms": gemm_ms,
                            "gemm_share": gemm_ms / dev_ms if dev_ms else None},
           "peak_memory_gib": peak, "meshes": mesh_recs,
           "mesh_score": {k: score[k] for k in ("accuracy (cm)", "completion (cm)",
                                                 "completion ratio (<5cm %)") if k in score},
           "colours_card_vs_cpu": colours, "fused_decode_launches": [n_fwd, n_bwd],
           "mapping_calls": slam.mapping_cnt, "keyframes": slam.mapper.keyframes.indices}
    failed = []
    if not ate < held:
        failed.append(f"ATE {ate:.4f} m is not below the held camera's {held:.4f} m")
    if mesh is None or not len(mesh.faces):
        failed.append("no final_mesh.ply with faces")
    if not score:
        failed.append("final_mesh.ply was not scored")
    elif not (colours["share_above_atol"] <= IMAP_COLOUR_SHARE
              and math.isfinite(colours["max_abs_diff"])):
        failed.append(f"along-normal colours card vs CPU: {colours['share_above_atol']:.4f} of "
                      f"the vertices beyond {IMAP_COLOUR_ATOL:.4f}")
    if (n_fwd, n_bwd) != (0, 0):
        failed.append(f"the iMAP path launched the fused decode {n_fwd} / {n_bwd} times")
    if not dev_ms > 0:
        failed.append("the profiler saw no device time in the steady call")
    f_cli, res["command_line"] = imap_command_line(frag)
    failed += [f"command line: {x}" for x in f_cli]
    res["command_line_launches"] = list(launches())
    if res["command_line_launches"] != [0, 0]:
        failed.append(f"the iMAP command line launched the fused decode "
                      f"{res['command_line_launches']} times")
    res["phase_s"] = time.perf_counter() - t_phase
    say("imap: " + json.dumps(res))
    return [f"imap: {x}" for x in failed], res


# ---- 15. shipped formats ----------------------------------------------------------
# Phase 12's scene with its colour frames re-encoded as JPEG (write_jpeg,
# quality 95), as Replica ships them; depth and events stay PNG, as Replica
# ships them (the event folder is phase 12's). All 33 frames are written, so
# that frames 0-25 run on the schedule of phase 12 (no final colour refinement
# at frame 25). TUM freiburg1's camera (configs/TUM_RGBD/freiburg1_desk.yaml)
# times the undistortion.
JPEG_SCENE_DIR = os.path.join(cuda_build.BUILD_DIR, "room_scene_jpeg")
JPEG_QUALITY = 95
JPEG_PSNR_MIN = 40.0
DECODE_TIMED = 5       # the median of the first five frames' decodes
SPEED_BLOCKS = 2       # timed 5-frame blocks after frames 0-5, frames not preloaded
TUM_FR1 = {"H": 480, "W": 640, "fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
           "distortion": [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]}
UNDISTORT_CALLS = 5
VIS_FRAMES = 11        # frames 0-10 with the visualiser on
VIS_FREQ = 5
VIS_INSIDE = 25        # mapping.vis_inside_freq as shipped: a mapping panel every 49 iterations
VIS_ITERS_FIRST = 60   # cut: the panels check the schedule, not the fitted map


def write_jpeg_scene(frag):
    """Phase 12's scene on disk with JPEG colour frames under
    ``JPEG_SCENE_DIR`` (depth linked, events read from phase 12's folder).
    Returns (the scene's config fragment, seconds)."""
    t0 = time.perf_counter()
    src = frag["data"]["input_folder"]
    res = os.path.join(JPEG_SCENE_DIR, "results")
    shutil.rmtree(JPEG_SCENE_DIR, ignore_errors=True)
    os.makedirs(res)
    for path in sorted(glob.glob(os.path.join(src, "results", "frame*.png"))):
        name = os.path.basename(path)[:-len(".png")] + ".jpg"
        write_jpeg(os.path.join(res, name), read_png(path), JPEG_QUALITY)
    for path in sorted(glob.glob(os.path.join(src, "results", "depth*.png"))) + [
            os.path.join(src, "traj.txt")]:
        dst = os.path.join(res if "depth" in os.path.basename(path) else JPEG_SCENE_DIR,
                           os.path.basename(path))
        try:
            os.link(path, dst)
        except OSError:
            shutil.copyfile(path, dst)
    jfrag = copy.deepcopy(frag)
    jfrag["data"]["input_folder"] = JPEG_SCENE_DIR
    return jfrag, time.perf_counter() - t0


def decode_checks(frag, jfrag):
    """ms per JPEG and per PNG decode of the same 680x1200 colour frames,
    the decoded JPEG frames' PSNR against the PNG source, and ms per
    ``undistort`` of a 480x640 colour frame with TUM freiburg1's
    coefficients (the first call computes the map, later calls reuse it)."""
    jpg = sorted(glob.glob(os.path.join(jfrag["data"]["input_folder"], "results",
                                        "frame*.jpg")))[:MAP_FRAMES]
    jpeg_ms, png_ms, psnr = [], [], []
    for path in jpg:
        png = os.path.join(frag["data"]["input_folder"], "results",
                           os.path.basename(path)[:-len(".jpg")] + ".png")
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        img = decode_jpeg(data, path=path)
        jpeg_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        ref = read_png(png)
        png_ms.append(1e3 * (time.perf_counter() - t0))
        mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
        psnr.append(10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
    cam = TUM_FR1
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    rgb = np.random.default_rng(SEED).integers(0, 256, (cam["H"], cam["W"], 3), np.uint8)
    und = Undistorter(K, cam["distortion"])
    t0 = time.perf_counter()
    out = und(rgb)
    first_ms = 1e3 * (time.perf_counter() - t0)
    und_ms = []
    for _ in range(UNDISTORT_CALLS):
        t0 = time.perf_counter()
        out = und(rgb)
        und_ms.append(1e3 * (time.perf_counter() - t0))
    res = {"frames": len(jpg), "hw": list(img.shape),
           "jpeg_decode_ms_median5": float(np.median(jpeg_ms[:DECODE_TIMED])),
           "jpeg_decode_ms_all": [round(x, 1) for x in jpeg_ms],
           "png_decode_ms_median5": float(np.median(png_ms[:DECODE_TIMED])),
           "png_decode_ms_all": [round(x, 1) for x in png_ms],
           "jpeg_bytes_median": float(np.median([os.path.getsize(p) for p in jpg])),
           "psnr_db_min": min(psnr), "psnr_db_median": float(np.median(psnr)),
           "psnr_bar_db": JPEG_PSNR_MIN,
           "undistort_480x640_first_ms": first_ms,
           "undistort_480x640_ms_median": float(np.median(und_ms))}
    failed = []
    if len(jpg) != MAP_FRAMES or img.shape != (frag["cam"]["H"], frag["cam"]["W"], 3):
        failed.append(f"{len(jpg)} JPEG frames of shape {img.shape}")
    if not min(psnr) >= JPEG_PSNR_MIN:
        failed.append(f"a decoded JPEG frame at {min(psnr):.2f} dB, below {JPEG_PSNR_MIN} dB")
    if out.shape != rgb.shape or out.dtype != np.uint8 or not out.any():
        failed.append("undistort gave no image")
    return failed, res


def block_speed(frag, dev, label):
    """Phase 12's configuration over a scene, frames not preloaded: frames
    0-5, then SPEED_BLOCKS timed blocks of five frames, each ending with its
    steady mapping call and a synchronise. Returns frames per second a block."""
    cfg = pipeline_config(frag)
    cfg["data"]["output"] = os.path.join(JPEG_SCENE_DIR, f"output_speed_{label}")
    slam = EvenNICERSLAM(cfg, device=dev)
    for idx in range(PIPE_WARM):
        slam.step(idx)
    torch.cuda.synchronize()
    fps = []
    for b in range(SPEED_BLOCKS):
        t0 = time.perf_counter()
        for idx in range(PIPE_WARM + b * PIPE_BLOCK, PIPE_WARM + (b + 1) * PIPE_BLOCK):
            slam.step(idx)
        torch.cuda.synchronize()
        fps.append(PIPE_BLOCK / (time.perf_counter() - t0))
    return fps, slam.timers.summary()


def vis_run(jfrag, dev):
    """``EvenNICERSLAM.run`` over frames 0-10 of the JPEG scene with the
    visualiser on (``vis_freq`` 5; the first mapping call cut to
    VIS_ITERS_FIRST iterations): the panels written against the names the
    schedule implies, each decoded by the port's decoder to the mosaic's
    shape. Returns (failures, results)."""
    cfg = pipeline_config(jfrag)
    out = os.path.join(JPEG_SCENE_DIR, "output_vis")
    update_recursive(cfg, {"enable_vis": True, "data": {"output": out},
                           "tracking": {"vis_freq": VIS_FREQ},
                           "mapping": {"vis_freq": VIS_FREQ, "vis_inside_freq": VIS_INSIDE,
                                       "iters_first": VIS_ITERS_FIRST}})
    slam = EvenNICERSLAM(cfg, device=dev)
    t0 = time.perf_counter()
    slam.run(end_frame=VIS_FRAMES, mesh=False, checkpoint=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    m = slam.m_cfg
    inside = 2 * VIS_INSIDE - 1
    want = {"tracking_vis": [f"{i:05d}_0000.jpg" for i in range(1, VIS_FRAMES)
                             if i % VIS_FREQ == 0], "mapping_vis": []}
    for idx in range(VIS_FRAMES):
        if idx % m.every_frame == 0 and idx % VIS_FREQ == 0:
            stages, seg = stage_schedule(m.iters_first if idx == 0 else m.iters,
                                         slam.mapper.cfg, False, False, True)
            total = sum(seg[st] for st in stages)
            want["mapping_vis"] += [f"{idx:05d}_{it:04d}.jpg" for it in range(0, total, inside)]
    got = {sub: sorted(os.listdir(os.path.join(out, sub))) for sub in want
           if os.path.isdir(os.path.join(out, sub))}
    H, W = slam.cam.H, slam.cam.W
    failed, shapes, decode_ms = [], {}, []
    if got != want:
        failed.append(f"panels {got}, expected {want}")
    for sub, names in got.items():
        rows = 3 if sub == "tracking_vis" and slam.use_events else 2
        want_shape = (rows * (H + VIS_MARGIN) + VIS_MARGIN, 3 * (W + VIS_MARGIN) + VIS_MARGIN, 3)
        for name in names:
            with open(os.path.join(out, sub, name), "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            img = decode_jpeg(data)
            decode_ms.append(1e3 * (time.perf_counter() - t0))
            shapes[f"{sub}/{name}"] = list(img.shape)
            if img.shape != want_shape:
                failed.append(f"{sub}/{name} decodes to {img.shape}, expected {want_shape}")
    res = {"frames": VIS_FRAMES, "panels": got, "panel_shapes": sorted(
        {tuple(v) for v in shapes.values()}), "run_s": run_s,
           "panel_decode_ms_median": float(np.median(decode_ms)) if decode_ms else None}
    return [f"visualiser: {f}" for f in failed], res


def shipped_formats(frag, dev, ate_png_every):
    """Phase 15: the JPEG scene written, the decode checks, the blocks'
    speed over JPEG and over PNG frames (not preloaded), ``EvenNICERSLAM.run``
    over frames 0-25 of the JPEG scene with RGB-D + event on every frame (its
    ATE below a camera held at frame 0; ``ate_png_every`` is phase 12's
    reading on the PNG scene, printed beside), the visualiser. Returns
    (failures, results, the decode kernels' launches of the phase)."""
    t_phase = time.perf_counter()
    reset_launches()
    jfrag, write_s = write_jpeg_scene(frag)
    failed, dec = decode_checks(frag, jfrag)
    speed = {}
    for label, f in (("jpeg", jfrag), ("png", frag)):
        fps, dispatch = block_speed(f, dev, label)
        speed[label] = {"fps_blocks": fps, "fps_median": float(np.median(fps)),
                        "host_dispatch": dispatch}
    fwd0, bwd0 = launches()
    ate, held, err, slam = run_pipeline(jfrag, dev, 1, label="jpeg_every")
    torch.cuda.synchronize()
    fwd1, bwd1 = launches()
    want = 2 * slam.t_cfg.iters * (MAP_FRAMES - 1)
    if not ate < held:
        failed.append(f"JPEG scene: ATE {ate:.4f} m is not below the held camera's {held:.4f} m")
    if (fwd1 - fwd0, bwd1 - bwd0) != (want, want):
        failed.append(f"JPEG scene: the decode kernels launched {fwd1 - fwd0} / {bwd1 - bwd0} "
                      f"times, expected {want}")
    del slam
    failed_vis, vis = vis_run(jfrag, dev)
    failed += failed_vis
    n_fwd, n_bwd = launches()
    if not (n_fwd > 0 and n_bwd > 0):
        failed.append("no decode kernel launched in the phase")
    res = {"jpeg_scene_write_s": write_s, "decode": dec, "speed_not_preloaded": speed,
           "jpeg_every_frame": {"ate_rmse_m": ate, "held_camera_rmse_m": held,
                                "ate_png_every_frame_phase12_m": ate_png_every,
                                "err_mm_per_frame": err},
           "visualiser": vis, "fwd_launches": n_fwd, "bwd_launches": n_bwd,
           "phase_s": time.perf_counter() - t_phase}
    say("shipped formats: " + json.dumps(res))
    return [f"shipped formats: {f}" for f in failed], res, (n_fwd, n_bwd)


# ---- phase 16: the event network ---------------------------------------------------
# (a) Training from scratch at the deployment's low-res size: train_step at
# 102x180 (0.15 of 680x1200, the event image the tracker feeds the net),
# batch 4. make_pair_batch renders three views a sample on the host (two at
# 408x720: about 1.3 s a batch on the card's host), so the 40 steps cycle a
# pool of 5 batches it made. The card's step against the CPU's from the same
# weights and batch: the loss to a relative 1e-4, each leaf's gradient to
# 1e-3 of the leaf's norm (Adam's first step, lr * sign(g), would turn a
# near-zero gradient's rounding into a whole step, so the updated weights
# are not compared; measured 1.6e-7 and 1.8e-4-2.1e-4). Two card runs of 10
# steps from the same state, compared bit for bit (reported).
EVNET_HW = (102, 180)
EVNET_BATCH = 4
EVNET_STEPS = 40
EVNET_POOL = 5
EVNET_TIMED = 30
EVNET_REPEAT_STEPS = 10
EVNET_PROFILE_STEPS = 3
EVNET_LR = 3e-4
EVNET_LOSS_RTOL = 1e-4
EVNET_GRAD_REL = 1e-3
# (b) The shipped artifact's recipe on the port (pretrained/README.md):
# event_ablation --frames 26 --hw 240 320 --train_steps 300: the map-domain
# net from scratch, 2 x 300 steps on 128 triples with perturbed poses (0.01 m,
# 0.005 rad, gt_render_fn), then A_dead_reckoning and C_events_reference at
# seed 7. One cut: each pipeline run's first mapping call runs 300 iterations,
# not the configuration's 1,500 (bench.py:82's cut): 1,500 would cost about
# 90 s in each of the three runs. The net goes to build/, never to pretrained/.
# 32 held-out triples that training never saw (drawn with another seed, any
# triple equal to a training one dropped) hold the trained net's loss below
# that of the untrained net it started from (the planted fault: it must fail).
ABLATION_DIR = os.path.join(cuda_build.BUILD_DIR, "event_ablation")
ABLATION_NET = os.path.join(cuda_build.BUILD_DIR, "eventnet_mapdomain_smoke.npz")
ABLATION_FRAMES = 26
ABLATION_HW = (240, 320)
ABLATION_TRAIN_STEPS = 2 * 300
ABLATION_PAIRS = 128
ABLATION_HELD_OUT = 32
ABLATION_ITERS_FIRST = MAP_ITERS_FIRST
ABLATION_SEED = 7
ABLATION_VARIANTS = ("A_dead_reckoning", "C_events_reference")
# the JAX package's record, mean and std over 3 seeds (benchmarks/
# event_ablation_r5.json: 100 frames at 680x1200, first call 1,500 iterations)
JAX_ABLATION_RECORD = {"A_dead_reckoning": (0.284, 0.090), "C_events_reference": (0.108, 0.018)}


def pair_batches(n, dev):
    """``n`` batches of make_pair_batch at EVNET_HW on ``dev``, from SEED."""
    rng = np.random.default_rng(SEED)
    return [tuple(torch.from_numpy(a).to(dev) for a in make_pair_batch(
        rng, EVNET_BATCH, EVNET_HW, eventnet_train.DEFAULT_BOUND)) for _ in range(n)]


def evnet_steps(params, batches, n):
    state = adam_init(params)
    losses = []
    for step in range(n):
        params, state, loss = eventnet_train.train_step(
            params, state, *batches[step % len(batches)], EVNET_LR)
        losses.append(loss)
    return params, losses


def evnet_card_vs_cpu(params, batch):
    """The loss and every leaf's gradient of one step, card against CPU."""
    def cpu(t):
        return t.detach().cpu()

    loss_c, g_c = eventnet_train.loss_and_grads(params, *batch)
    loss_h, g_h = eventnet_train.loss_and_grads(tree_map(cpu, params), *map(cpu, batch))
    worst, worst_leaf = 0.0, None
    for (path, a), (_, b) in zip(_leaves(g_c), _leaves(g_h)):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        if rel >= worst:
            worst, worst_leaf = rel, ".".join(path)
    loss_rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    return {"loss_card": float(loss_c), "loss_cpu": float(loss_h), "loss_rel": loss_rel,
            "worst_grad_rel": worst, "worst_grad_leaf": worst_leaf,
            "loss_rtol": EVNET_LOSS_RTOL, "grad_rel_limit": EVNET_GRAD_REL}


def evnet_card_vs_card(init, batches):
    """Two runs of EVNET_REPEAT_STEPS steps from the same state: bitwise equal?
    Else the first leaf that differs, by how much, and how many differ."""
    a, _ = evnet_steps(init, batches, EVNET_REPEAT_STEPS)
    b, _ = evnet_steps(init, batches, EVNET_REPEAT_STEPS)
    torch.cuda.synchronize()
    differ = [(".".join(path), float((x - y).abs().max())) for (path, x), (_, y) in
              zip(_leaves(a), _leaves(b)) if not torch.equal(x, y)]
    return {"steps": EVNET_REPEAT_STEPS, "bitwise_equal": not differ,
            "leaves_differing": len(differ), "leaves": len(_leaves(a)),
            "first_differing_leaf": differ[0][0] if differ else None,
            "first_max_abs_diff": differ[0][1] if differ else 0.0,
            "max_abs_diff": max((d for _, d in differ), default=0.0)}


def _kernel_kind(name):
    n = name.lower()
    if "wgrad" in n or "bwd_filter" in n:
        return "convolution, weight gradient"
    if "dgrad" in n or "bwd_data" in n:
        return "convolution, data gradient"
    if "fprop" in n or "implicit_convolve" in n or "convolve" in n:
        return "convolution, forward"
    if "fft" in n or "winograd" in n or "xmma" in n or "cudnn" in n or "conv" in n:
        return "convolution, other (FFT, Winograd, filter flips)"
    if "nchwtonhwc" in n or "nhwctonchw" in n or "transpose" in n or "copy" in n:
        return "layout copies"
    if "upsample" in n:
        return "bilinear upsample"
    if "max_pool" in n:
        return "max pooling"
    if "gemm" in n:
        return "matrix products"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


def evnet_profile(params, batch):
    """Where a training step's time goes: EVNET_PROFILE_STEPS forward +
    backward passes (``loss_and_grads``) and as many Adam updates, each under
    torch.profiler: device ms a step by kind of kernel, the largest kernels,
    launches, and the wall ms a step of each part (the profiler slows the
    host)."""
    _, grads = eventnet_train.loss_and_grads(params, *batch)
    state = adam_init(params)
    detached = tree_map(torch.Tensor.detach, params)
    fwd_bwd, wall_fb = _device_ms(lambda: eventnet_train.loss_and_grads(params, *batch),
                                  EVNET_PROFILE_STEPS)
    adam, wall_adam = _device_ms(lambda: adam_update(grads, state, detached, EVNET_LR),
                                 EVNET_PROFILE_STEPS)
    kinds = {}
    for name, (ms, _) in fwd_bwd.items():
        kinds[_kernel_kind(name)] = kinds.get(_kernel_kind(name), 0.0) + ms
    kinds["Adam (its own window)"] = sum(ms for ms, _ in adam.values())
    busy = sum(kinds.values())
    wall = wall_fb + wall_adam
    top = sorted(fwd_bwd.items(), key=lambda kv: -kv[1][0])[:10]
    return {"steps": EVNET_PROFILE_STEPS, "wall_ms_per_step": wall,
            "wall_ms_forward_backward": wall_fb, "wall_ms_adam": wall_adam,
            "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1 - busy / wall),
            "launches_forward_backward": sum(c for _, c in fwd_bwd.values()),
            "launches_adam": sum(c for _, c in adam.values()),
            "by_kind_ms_per_step": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"kernel": k[:90], "ms_per_step": v[0], "launches_per_step": v[1]}
                            for k, v in top]}


def evnet_training(dev):
    """Phase 16 (a). Returns (failures, results)."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    batches = pair_batches(EVNET_POOL, dev)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    init = init_eventnet(torch.Generator().manual_seed(SEED), device=dev)
    cpu_res = evnet_card_vs_cpu(init, batches[0])
    with FlopCounterMode(display=False) as flops:
        eventnet_train.train_step(init, adam_init(init), *batches[0], EVNET_LR)
    gflop = flops.get_total_flops() / 1e9
    evnet_steps(init, batches, 2)  # warm-up: cuDNN times its algorithms here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, state = init, adam_init(init)
    marks, enqueue_ms, losses = [], [], []
    t_all = time.perf_counter()
    for step in range(EVNET_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, state, loss = eventnet_train.train_step(
            params, state, *batches[step % EVNET_POOL], EVNET_LR)
        end.record()
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
        marks.append((start, end))
        losses.append(loss)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_all) / EVNET_STEPS
    step_ms = [s.elapsed_time(e) for s, e in marks]
    loss_v = [float(x) for x in losses]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ms = float(np.median(step_ms[-EVNET_TIMED:]))
    res = {"hw": list(EVNET_HW), "batch": EVNET_BATCH, "steps": EVNET_STEPS,
           "pool_batches": EVNET_POOL, "pool_make_s": batch_s,
           "ms_per_step_cuda_events_median_last30": ms,
           "ms_per_step_range_last30": [min(step_ms[-EVNET_TIMED:]),
                                        max(step_ms[-EVNET_TIMED:])],
           "host_enqueue_ms_per_step_median": float(np.median(enqueue_ms[-EVNET_TIMED:])),
           "wall_ms_per_step": wall_ms,
           "gflop_per_step": gflop,
           "f32_bound_ms": 1e3 * gflop * 1e9 / PEAK_F32_FLOPS,
           "peak_memory_gib_above_start": peak,
           "loss_step0": loss_v[0], "loss_mean_last10": float(np.mean(loss_v[-10:])),
           "card_vs_cpu": cpu_res,
           "card_vs_card": evnet_card_vs_card(init, batches),
           "profile": evnet_profile(init, batches[0])}
    say("event network (a), training from scratch: " + json.dumps(res))
    failed = []
    if not all(math.isfinite(v) for v in loss_v):
        failed.append("a training loss is not finite")
    if not cpu_res["loss_rel"] <= EVNET_LOSS_RTOL:
        failed.append(f"card vs CPU: loss {cpu_res['loss_card']} against {cpu_res['loss_cpu']}")
    if not cpu_res["worst_grad_rel"] <= EVNET_GRAD_REL:
        failed.append(f"card vs CPU: gradient of {cpu_res['worst_grad_leaf']} "
                      f"{cpu_res['worst_grad_rel']:.2e} of its norm apart")
    return failed, res


def held_out_triples(slam, n, train, gt_fn):
    """ABLATION_HELD_OUT triples drawn with another seed, none equal to a
    training triple (their previous image and events identify the window)."""
    seen = {a.tobytes() + b.tobytes() for a, b in zip(train[0], train[2])}
    cand = eventnet_train.pairs_from_map(slam, n, 2 * ABLATION_HELD_OUT, seed=1,
                                         perturb_trans=0.01, perturb_rot=0.005,
                                         gt_render_fn=gt_fn)
    keep = [i for i in range(len(cand[0]))
            if cand[0][i].tobytes() + cand[2][i].tobytes() not in seen][:ABLATION_HELD_OUT]
    if len(keep) < ABLATION_HELD_OUT:
        raise RuntimeError(f"only {len(keep)} held-out triples unseen by training")
    return tuple(a[keep] for a in cand)


def held_out_loss(net, triples, dev):
    with torch.no_grad():
        loss, _ = eventnet_train.loss_fn(net, *(torch.from_numpy(a).to(dev) for a in triples))
    return float(loss)


def ablation_recipe(dev):
    """Phase 16 (b). Returns (failures, results, the decode launches)."""
    from evennicer_slam_tpu_torch.tools import event_ablation

    t0 = time.perf_counter()
    cfg = event_ablation.build_cfg(ABLATION_DIR, ABLATION_FRAMES, *ABLATION_HW,
                                   traj_seed=ABLATION_SEED)
    cfg["mapping"]["iters_first"] = ABLATION_ITERS_FIRST
    scene_s = time.perf_counter() - t0
    gt_fn = event_ablation.gt_render(cfg["cam"])
    t0 = time.perf_counter()
    slam, n = eventnet_train.map_frames(cfg, ABLATION_FRAMES, gt_fn, device=dev)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = eventnet_train.pairs_from_map(slam, n, ABLATION_PAIRS, seed=0, perturb_trans=0.01,
                                          perturb_rot=0.005, gt_render_fn=gt_fn)
    triples_s = time.perf_counter() - t0
    held = held_out_triples(slam, n, train, gt_fn)
    del slam
    untrained = init_eventnet(torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = eventnet_train.train_on_triples(*train, steps=ABLATION_TRAIN_STEPS, seed=0,
                                          device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    eventnet_train.save_eventnet_npz(net, ABLATION_NET)
    reread = load_eventnet_npz(ABLATION_NET, device=dev)
    losses = {"trained": held_out_loss(net, held, dev),
              "trained_reread_f16": held_out_loss(reread, held, dev),
              "untrained": held_out_loss(untrained, held, dev),
              "shipped_eventnet_mapdomain": held_out_loss(
                  load_eventnet_npz(EVENTNET_NPZ, device=dev), held, dev)}

    def learned(loss):
        return loss < losses["untrained"]

    variants = {}
    fwd = bwd = 0
    for name in ABLATION_VARIANTS:
        activate, criterion, extra = event_ablation.VARIANTS[name]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ate = event_ablation.run_variant(cfg, None if name.startswith("A_") else net,
                                         ABLATION_FRAMES, activate, criterion, extra, device=dev)
        torch.cuda.synchronize()
        f, b = launches()
        fwd, bwd = fwd + f, bwd + b
        variants[name] = {"ate_rmse_m": ate, "s": time.perf_counter() - t0,
                          "fwd_launches": f, "bwd_launches": b,
                          "jax_record_mean_std_m": JAX_ABLATION_RECORD[name]}
    res = {"frames": ABLATION_FRAMES, "hw": list(ABLATION_HW),
           "first_call_iters": ABLATION_ITERS_FIRST, "scene_s": scene_s, "map_s": map_s,
           "triples": ABLATION_PAIRS, "triples_s": triples_s, "train_steps": ABLATION_TRAIN_STEPS,
           "train_s": train_s, "train_ms_per_step": 1e3 * train_s / ABLATION_TRAIN_STEPS,
           "held_out_triples": ABLATION_HELD_OUT, "held_out_loss": losses,
           "planted_fault_untrained_passes": learned(losses["untrained"]),
           "variants": variants, "ate_bar_c_m": ATE_BENCH_BAR, "net": ABLATION_NET}
    say("event network (b), the shipped net's recipe: " + json.dumps(res))
    failed = []
    if not learned(losses["trained"]):
        failed.append(f"held-out loss of the trained net {losses['trained']:.4f} is not below "
                      f"the untrained net's {losses['untrained']:.4f}")
    if res["planted_fault_untrained_passes"]:
        failed.append("the untrained net passed the held-out check")
    ate_c = variants["C_events_reference"]["ate_rmse_m"]
    if not ate_c <= ATE_BENCH_BAR:
        failed.append(f"C_events_reference ATE {ate_c:.4f} m above {ATE_BENCH_BAR} m")
    if not all(math.isfinite(v["ate_rmse_m"]) for v in variants.values()):
        failed.append("a variant's ATE is not finite")
    if not (fwd > 0 and bwd > 0):
        failed.append(f"the variants launched the decode kernels {fwd} / {bwd} times")
    return failed, res, (fwd, bwd)


def event_network(dev):
    """Phase 16: (a) EventNet trained from scratch at 102x180, (b) the shipped
    net's recipe through the port's event_ablation. Returns (failures,
    results, the decode kernels' launches of the phase)."""
    t_phase = time.perf_counter()
    failed_a, res_a = evnet_training(dev)
    failed_b, res_b, n_launch = ablation_recipe(dev)
    res = {"training": res_a, "ablation": res_b, "phase_s": time.perf_counter() - t_phase}
    return [f"event network: {f}" for f in failed_a + failed_b], res, n_launch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build the kernel and check it against its plain "
                         "version, then stop (prints no result line)")
    opts = ap.parse_args()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    laps, t_lap = {}, [t_start]

    def lap(name):
        """Seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    lap("1-2 device, build")
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
    lap("3 kernels vs plain")

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

    lap("4 scores")

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

    lap("5 whole image")

    # ---- 6. the pose gradient through the whole score -----------------------------
    grad_res = check_pose_gradient(mp, decoders, packed, bound_t, dev)
    lap("6 pose gradient")

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

    lap("7 tracking")

    # ---- 8. one frame through the kernels and through the plain versions ----------
    kp_res = track_kernel_vs_plain(mp, frames, decoders, packed, bound_t, dev)
    lap("8 frame kernels vs plain")

    # ---- 9. one self-consistent frame (reported only) ----------------------------
    self_res = self_consistent_frame(mp, renderer, decoders, packed, bound_t, dev)
    lap("9 self-consistent frame")

    # ---- 10. map and track, interleaved, at full width ----------------------------
    # Frames 0-5 on the bench schedule (event only, RGB-D every fifth frame),
    # driven by hand through Mapper.optimize_map and Tracker.track.
    # The schedule with RGB-D + event on every frame, held below a camera held
    # at frame 0, runs in phase 12 (EvenNICERSLAM.run over the same frames).
    frag = write_room_scene(cam)
    m_frames = room_frames(frag, dev, MAP_FRAMES)
    reset_launches()
    failed, bench_res = map_and_track(
        cfg, mp, dev, m_frames[:MAP_TRACK_FRAMES], tcfg, "bench schedule, RGB-D every 5th",
        lambda held: ATE_BENCH_BAR)
    launches_map_fwd, launches_map_bwd = launches()
    if failed:
        say("map and track FAILED: " + "; ".join(failed))
    lap("10 map and track")

    # ---- 11. one steady mapping call on the card and on the CPU -------------------
    cpu_res = mapping_card_vs_cpu(*steady_mapping_state(cfg, cam, dev, m_frames), dev)
    lap("11 steady call card vs CPU")

    # ---- 12. the pipeline from disk -----------------------------------------------
    failed_pipe, pipe_res, (launches_pipe_fwd, launches_pipe_bwd) = pipeline_from_disk(
        frag, dev, bench_res["ate_rmse_m"])
    failed += failed_pipe
    (failed_every, every_res, (launches_every_fwd, launches_every_bwd), every_slam,
     start_state, mesh_recs) = pipeline_every_frame(frag, dev)
    failed += failed_every
    launches_pipe_fwd += launches_every_fwd
    launches_pipe_bwd += launches_every_bwd
    lap("12 pipeline")

    # ---- 13. reconstruction -------------------------------------------------------
    failed_rec, rec_res, (launches_cli_fwd, launches_cli_bwd) = reconstruction(
        frag, every_slam, start_state, mesh_recs)
    failed += failed_rec
    del every_slam, start_state
    lap("13 reconstruction")

    # ---- 14. iMAP -----------------------------------------------------------------
    failed_imap, imap_res = imap_phase(frag, dev)
    failed += failed_imap
    lap("14 imap")

    # ---- 15. shipped formats ----------------------------------------------------
    failed_fmt, fmt_res, (launches_fmt_fwd, launches_fmt_bwd) = shipped_formats(
        frag, dev, every_res["ate_rmse_m"])
    failed += failed_fmt
    lap("15 shipped formats")

    # ---- 16. the event network ----------------------------------------------------
    failed_ev, ev_res, (launches_ev_fwd, launches_ev_bwd) = event_network(dev)
    failed += failed_ev
    lap("16 event network")
    say("seconds by phase: " + json.dumps(laps))
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
        "launches": (launches_main + launches_track_fwd + launches_map_fwd + launches_pipe_fwd
                     + launches_cli_fwd + launches_fmt_fwd + launches_ev_fwd),
        "launches_scores": launches_main,
        "launches_tracking": launches_track_fwd,
        "launches_map_and_track": launches_map_fwd,
        "launches_pipeline": launches_pipe_fwd,
        "launches_command_line": launches_cli_fwd,
        "launches_imap": imap_res["fused_decode_launches"][0],
        "launches_shipped_formats": launches_fmt_fwd,
        "launches_event_network": launches_ev_fwd,
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
        "launches": (launches_track_bwd + launches_map_bwd + launches_pipe_bwd + launches_cli_bwd
                     + launches_fmt_bwd + launches_ev_bwd),
        "launches_tracking": launches_track_bwd,
        "launches_map_and_track": launches_map_bwd,
        "launches_pipeline": launches_pipe_bwd,
        "launches_command_line": launches_cli_bwd,
        "launches_imap": imap_res["fused_decode_launches"][1],
        "launches_shipped_formats": launches_fmt_bwd,
        "launches_event_network": launches_ev_bwd,
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
        "bench_schedule": {k: v for k, v in bench_res.items() if k != "err_mm_per_frame"},
        "card_vs_cpu": cpu_res}))
    say("pipeline: " + json.dumps({k: pipe_res[k] for k in (
        "fps_blocks", "fps_median", "ate_rmse_m", "ate_in_memory_phase10_m", "n_fast_maps",
        "syncs_in_steady_block", "peak_memory_gib", "checkpoint_bitwise")}
        | {"every_frame": {k: every_res[k] for k in ("ate_rmse_m", "held_camera_rmse_m")}}))
    say("reconstruction: " + json.dumps({
        "sweep_card_vs_cpu": {k: rec_res["sweep_card_vs_cpu"][k] for k in (
            "mask_disagreements", "max_logit_diff")},
        "meshes": [{k: r[k] for k in ("mesh", "total_s", "sweep_s", "march_s", "clean_s",
                                      "color_s", "export_s", "faces", "peak_memory_gib")}
                   for r in rec_res["meshes"]],
        "scores": {name: {k: score[k] for k in (
            "accuracy (cm)", "completion (cm)", "completion ratio (<5cm %)",
            "completion_ratio_seen (<5cm %)", "passes_bars")}
            for name, score in rec_res["scores"].items()},
        "faults_pass_bars": {fault: {name: score["passes_bars"] for name, score in by.items()}
                             for fault, by in rec_res["faults"].items()},
        "command_line": {k: rec_res["command_line"][k] for k in ("checkpoint", "ate_rmse_m",
                                                                 "final_mesh")}}))
    say("imap: " + json.dumps({k: imap_res[k] for k in (
        "ate_rmse_m", "held_camera_rmse_m", "track_ms_per_frame", "map_ms_first",
        "map_ms_steady", "steady_traced", "peak_memory_gib", "mesh_score",
        "colours_card_vs_cpu", "fused_decode_launches", "phase_s")}
        | {"meshes": [{k: r[k] for k in ("total_s", "sweep_s", "march_s", "clean_s", "color_s",
                                          "export_s", "faces")} for r in imap_res["meshes"]],
           "command_line": imap_res["command_line"]}))
    say("shipped formats: " + json.dumps({
        "decode": {k: fmt_res["decode"][k] for k in (
            "jpeg_decode_ms_median5", "png_decode_ms_median5", "psnr_db_min",
            "undistort_480x640_first_ms", "undistort_480x640_ms_median")},
        "fps_not_preloaded": {k: v["fps_blocks"] for k, v in
                              fmt_res["speed_not_preloaded"].items()},
        "jpeg_every_frame": {k: v for k, v in fmt_res["jpeg_every_frame"].items()
                             if k != "err_mm_per_frame"},
        "visualiser_panels": {k: len(v) for k, v in fmt_res["visualiser"]["panels"].items()},
        "phase_s": fmt_res["phase_s"]}))
    tr, ab = ev_res["training"], ev_res["ablation"]
    say("event network: " + json.dumps({
        "training": {k: tr[k] for k in (
            "ms_per_step_cuda_events_median_last30", "host_enqueue_ms_per_step_median",
            "wall_ms_per_step", "f32_bound_ms", "peak_memory_gib_above_start", "loss_step0",
            "loss_mean_last10")}
        | {"card_vs_cpu": {k: tr["card_vs_cpu"][k] for k in ("loss_rel", "worst_grad_rel")},
           "card_vs_card": tr["card_vs_card"],
           "profile_ms_per_step": tr["profile"]["by_kind_ms_per_step"]},
        "ablation": {k: ab[k] for k in ("map_s", "triples_s", "train_s", "train_ms_per_step",
                                        "held_out_loss")}
        | {"variants": {k: {"ate_rmse_m": v["ate_rmse_m"], "s": v["s"]}
                        for k, v in ab["variants"].items()}},
        "phase_s": ev_res["phase_s"]}))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
