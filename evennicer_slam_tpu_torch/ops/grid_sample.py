"""Trilinear feature-grid sampling (counterpart of
``evennicer_slam_tpu/ops/grid_sample.py``).

Numerically equivalent to ``F.grid_sample(grid, vgrid,
padding_mode='border', align_corners=True, mode='bilinear')`` on a
``[1, C, Z, Y, X]`` grid, but with the channels-last layout ``[Z, Y, X, C]``
the JAX package uses, so each corner lookup is a contiguous [C]-vector row.

On CUDA tensors the trilinear sample is one autograd function with a CUDA
kernel each way (``csrc/grid_sample.cu``): the forward reads the corner rows
from the grid and keeps only the points for the backward; the grid gradient
sums the stably sorted (point, corner) pairs a vertex, with no atomics; the
coordinate gradient re-reads the corners. Output and both gradients are
:func:`sample_grid_trilinear_plain`'s on the card bit for bit: the kernels
repeat its autograd chain's operations in its order. On CPU tensors it is
that plain version, which autograd differentiates.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from evennicer_slam_tpu_torch.utils.telemetry import TRACER


def _unnormalize(p_nor: torch.Tensor, Z: int, Y: int, X: int):
    """align_corners=True (-1 -> 0, +1 -> size-1) with border padding: the
    continuous coordinate is clamped into the valid range."""
    ux = torch.clamp((p_nor[..., 0] + 1.0) * 0.5 * (X - 1), 0.0, X - 1)
    uy = torch.clamp((p_nor[..., 1] + 1.0) * 0.5 * (Y - 1), 0.0, Y - 1)
    uz = torch.clamp((p_nor[..., 2] + 1.0) * 0.5 * (Z - 1), 0.0, Z - 1)
    return ux, uy, uz


def sample_grid_trilinear_plain(
    grid: torch.Tensor,
    p_nor: torch.Tensor,
    mode: str = "bilinear",
) -> torch.Tensor:
    """:func:`sample_grid_trilinear` in plain PyTorch ops, on any device:
    eight row gathers and seven lerps, differentiated by autograd."""
    Z, Y, X, C = grid.shape
    ux, uy, uz = _unnormalize(p_nor, Z, Y, X)
    flat = grid.reshape(-1, C)

    if mode == "nearest":
        ix = torch.round(ux).to(torch.long)
        iy = torch.round(uy).to(torch.long)
        iz = torch.round(uz).to(torch.long)
        return flat[(iz * Y + iy) * X + ix]

    x0 = torch.floor(ux).detach().to(torch.long)
    y0 = torch.floor(uy).detach().to(torch.long)
    z0 = torch.floor(uz).detach().to(torch.long)
    x1 = torch.clamp(x0 + 1, max=X - 1)
    y1 = torch.clamp(y0 + 1, max=Y - 1)
    z1 = torch.clamp(z0 + 1, max=Z - 1)
    fx = (ux - x0)[..., None]
    fy = (uy - y0)[..., None]
    fz = (uz - z0)[..., None]

    def corner(zi, yi, xi):
        return flat[(zi * Y + yi) * X + xi]

    c000 = corner(z0, y0, x0)
    c001 = corner(z0, y0, x1)
    c010 = corner(z0, y1, x0)
    c011 = corner(z0, y1, x1)
    c100 = corner(z1, y0, x0)
    c101 = corner(z1, y0, x1)
    c110 = corner(z1, y1, x0)
    c111 = corner(z1, y1, x1)

    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


# ---------------------------------------------------------------------------
# the CUDA kernels and their wrappers
# ---------------------------------------------------------------------------

def declare_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/grid_sample.cu`` (pointers and the stream as ``c_void_p``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.grid_sample_fwd.argtypes = [vp, vp] + [i32] * 4 + [i64, vp, vp]
    lib.grid_sample_keys.argtypes = [vp] + [i32] * 3 + [i64, vp, vp]
    lib.grid_sample_grid_bwd.argtypes = [vp] * 4 + [i64] + [i32] * 4 + [i64] + [vp] * 2
    lib.grid_sample_coord_bwd.argtypes = [vp] * 3 + [i64] + [i32] * 4 + [i64, vp, vp]
    for fn in (lib.grid_sample_fwd, lib.grid_sample_keys, lib.grid_sample_grid_bwd,
               lib.grid_sample_coord_bwd):
        fn.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernels (built from ``csrc/grid_sample.cu`` on first use,
    loaded once per process) with their C signatures declared."""
    from evennicer_slam_tpu_torch.ops.cuda_build import load_kernel_library

    return declare_signatures(load_kernel_library("grid_sample"))


def _launch(name: str, fn, *args) -> None:
    """Call a launcher of the library on the current stream of the points'
    device; raise if the launch failed."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _cotangent(grad_out: torch.Tensor) -> torch.Tensor:
    """The output's cotangent as rows of unit stride (it may arrive as a
    strided slice of a concatenation's cotangent, or expanded)."""
    if grad_out.stride(-1) != 1 or grad_out.stride(0) < grad_out.shape[-1]:
        grad_out = grad_out.contiguous()
    return grad_out


def launch_grid_sample_fwd(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """The forward kernel: ``grid`` [Z, Y, X, C] and ``p_nor`` [N, 3] float32,
    contiguous, on one CUDA device -> [N, C]. No synchronisation."""
    Z, Y, X, C = grid.shape
    n = p_nor.shape[0]
    out = torch.empty((n, C), dtype=torch.float32, device=p_nor.device)
    _launch("grid_sample_fwd", kernel_library().grid_sample_fwd,
            grid.data_ptr(), p_nor.data_ptr(), Z, Y, X, C, n, out.data_ptr())
    if n > 0:
        sample_grid_trilinear.launches += 1
    return out


def launch_grid_sample_grid_bwd(shape, p_nor: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The grid gradient ``[Z, Y, X, C]`` of the sample at ``p_nor`` for the
    cotangent ``g`` [N, C] (rows of unit stride): the 8N (point, corner) keys,
    a stable sort, the sums a vertex in the plain version's order. The plain
    version's bits, on every run."""
    Z, Y, X, C = shape
    n = p_nor.shape[0]
    dev = p_nor.device
    lib = kernel_library()
    keys = torch.empty(8 * n, dtype=torch.int32, device=dev)
    _launch("grid_sample_keys", lib.grid_sample_keys,
            p_nor.data_ptr(), Z, Y, X, n, keys.data_ptr())
    skeys, perm = torch.sort(keys, stable=True)
    dgrid = torch.empty((Z, Y, X, C), dtype=torch.float32, device=dev)
    _launch("grid_sample_grid_bwd", lib.grid_sample_grid_bwd,
            skeys.data_ptr(), perm.data_ptr(), p_nor.data_ptr(), g.data_ptr(), g.stride(0),
            Z, Y, X, C, n, dgrid.data_ptr())
    sample_grid_trilinear.grid_bwd_launches += 1
    sample_grid_trilinear.scattered += 8 * n
    TRACER.add("slam.grid.scattered", 8 * n)
    return dgrid


def launch_grid_sample_coord_bwd(grid: torch.Tensor, p_nor: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """The gradient [N, 3] to ``p_nor`` for the cotangent ``g`` [N, C]."""
    Z, Y, X, C = grid.shape
    n = p_nor.shape[0]
    dp = torch.empty((n, 3), dtype=torch.float32, device=p_nor.device)
    _launch("grid_sample_coord_bwd", kernel_library().grid_sample_coord_bwd,
            grid.data_ptr(), p_nor.data_ptr(), g.data_ptr(), g.stride(0), Z, Y, X, C, n,
            dp.data_ptr())
    if n > 0:
        sample_grid_trilinear.coord_bwd_launches += 1
    return dp


class _TrilinearSample(torch.autograd.Function):
    """One kernel forward; the backward launches the grid gradient's and the
    coordinate gradient's kernels, each only where its input needs it. The
    backward keeps the points (12 B a point) and recomputes each point's cell
    and fractions with the forward's own arithmetic (fractions alone would
    lose which coordinates were clamped at the border); the grid is kept only
    for the coordinate gradient. A call where neither input needs a gradient
    keeps nothing."""

    @staticmethod
    def forward(ctx, grid, p_nor):
        need_grid, need_p = ctx.needs_input_grad
        if need_grid or need_p:
            ctx.save_for_backward(p_nor, grid if need_p else None)
            ctx.shape = tuple(grid.shape)
        return launch_grid_sample_fwd(grid, p_nor)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        p_nor, grid = ctx.saved_tensors
        g = _cotangent(grad_out)
        with torch.cuda.device(p_nor.device):
            dgrid = (launch_grid_sample_grid_bwd(ctx.shape, p_nor, g)
                     if ctx.needs_input_grad[0] else None)
            dp = (launch_grid_sample_coord_bwd(grid, p_nor, g)
                  if ctx.needs_input_grad[1] else None)
        return dgrid, dp


def _check_kernel_args(grid: torch.Tensor, p_nor: torch.Tensor) -> None:
    dev = p_nor.device
    if dev.type != "cuda":
        raise ValueError(f"the grid-sample kernels need CUDA tensors, got {dev}")
    if grid.device != dev:
        raise ValueError(f"grid on {grid.device}, points on {dev}")
    for name, t in (("grid", grid), ("p_nor", p_nor)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")
    if grid.dim() != 4 or p_nor.shape[-1] != 3:
        raise ValueError(f"grid {tuple(grid.shape)} / points {tuple(p_nor.shape)}: "
                         "expected [Z, Y, X, C] and [..., 3]")
    Z, Y, X, C = grid.shape
    if not 0 < 8 * Z * Y * X < 2**31 or not 0 < C <= 128:
        raise ValueError(f"a grid of {Z}x{Y}x{X} cells of {C} channels: the kernels take "
                         "fewer than 2**28 cells and 1 to 128 channels")
    if 8 * p_nor[..., 0].numel() >= 2**31:
        raise ValueError(f"{p_nor[..., 0].numel()} points: 8 keys a point need int32")


def sample_grid_trilinear(
    grid: torch.Tensor,
    p_nor: torch.Tensor,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Sample a feature grid at normalized coordinates.

    Args:
        grid:  [Z, Y, X, C] feature grid.
        p_nor: [N, 3] coordinates in [-1, 1], ordered (x, y, z) — x indexes
               the X axis, etc. Out-of-range coords clamp to the border.
        mode:  'bilinear' (trilinear) or 'nearest'.

    Returns:
        [N, C] sampled features.

    CPU tensors, and ``mode='nearest'``, go through
    :func:`sample_grid_trilinear_plain`. A trilinear sample on CUDA tensors
    (float32) goes through the kernels, forward and backward, or the call
    raises. ``sample_grid_trilinear.launches`` counts forward kernel launches,
    ``.grid_bwd_launches`` grid gradients (keys, sort and segmented sum),
    ``.coord_bwd_launches`` coordinate gradients (neither launches for no
    points; a grid gradient then still writes its zeros), and ``.scattered`` the
    (point, corner) contributions the grid gradients summed (also the
    tracer's counter ``slam.grid.scattered``)."""
    if mode != "bilinear" or p_nor.device.type == "cpu":
        return sample_grid_trilinear_plain(grid, p_nor, mode)
    _check_kernel_args(grid, p_nor)
    lead = p_nor.shape[:-1]
    pts = p_nor.reshape(-1, 3).contiguous()
    with torch.cuda.device(pts.device):
        out = _TrilinearSample.apply(grid.contiguous(), pts)
    return out.reshape(*lead, grid.shape[-1])


sample_grid_trilinear.launches = 0
sample_grid_trilinear.grid_bwd_launches = 0
sample_grid_trilinear.coord_bwd_launches = 0
sample_grid_trilinear.scattered = 0


# ---------------------------------------------------------------------------
# packed-corner layout: one row gather per point instead of eight
# ---------------------------------------------------------------------------
#
# The packed layout stores, at every cell, the features of all 8 cell corners
# contiguously ([Z, Y, X, 8*C], edge-padded), so a trilinear sample is ONE
# row gather plus a weighted reduction over the row. 8x the memory, for the
# read-only snapshot the tracker uses; the compact layout stays the one that
# is optimized.

def pack_corner_grid(grid: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[Z, Y, X, C] -> [Z, Y, X, 8*C] with corner order (dz, dy, dx)
    lexicographic; borders edge-replicated (= 'border' padding)."""
    Z, Y, X, C = grid.shape
    gp = torch.cat([grid, grid[-1:]], dim=0)
    gp = torch.cat([gp, gp[:, -1:]], dim=1)
    gp = torch.cat([gp, gp[:, :, -1:]], dim=2)
    parts = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                parts.append(gp[dz : dz + Z, dy : dy + Y, dx : dx + X])
    return torch.cat(parts, dim=-1).to(dtype)


def packed_rows_and_frac(packed: torch.Tensor, p_nor: torch.Tensor):
    """Gather packed-corner rows + trilinear fractions for N points.

    Returns (rows [N, 8C] in the packed dtype, frac [N, 3] f32, (x, y, z)
    order). ``frac`` carries the coordinate gradient (zero where the
    continuous coordinate is clamped at the border, matching
    ``F.grid_sample(padding_mode='border')``); indices and rows are detached
    data. Feeds the fused decode's plain version (ops/fused_decode.py); the
    tracking decode passes :func:`packed_index_and_frac`'s cell indices to
    the kernels instead."""
    Z, Y, X, C8 = packed.shape
    ux, uy, uz = _unnormalize(p_nor, Z, Y, X)
    x0 = torch.floor(ux.detach())
    y0 = torch.floor(uy.detach())
    z0 = torch.floor(uz.detach())
    frac = torch.stack([ux - x0, uy - y0, uz - z0], dim=-1)
    idx = (z0.to(torch.long) * Y + y0.to(torch.long)) * X + x0.to(torch.long)
    rows = packed.detach().reshape(-1, C8)[idx]
    return rows, frac


def packed_index_and_frac(packed: torch.Tensor, p_nor: torch.Tensor):
    """The cell index of each of N points in a packed-corner grid, and its
    trilinear fractions: :func:`packed_rows_and_frac` without the gather.

    Returns (idx [N] int32, the flat cell index into ``packed.reshape(-1,
    8C)``; frac [N, 3] f32, (x, y, z) order, with the same floor, border clamp
    and coordinate gradient). ``packed.reshape(-1, 8C)[idx]`` is
    :func:`packed_rows_and_frac`'s rows. The fused decode kernels read each
    point's row from the grid through ``idx`` (ops/fused_decode.py)."""
    Z, Y, X, _ = packed.shape
    if Z * Y * X >= 2**31:
        raise ValueError(f"a grid of {Z}x{Y}x{X} cells has no int32 cell index")
    ux, uy, uz = _unnormalize(p_nor, Z, Y, X)
    x0 = torch.floor(ux.detach())
    y0 = torch.floor(uy.detach())
    z0 = torch.floor(uz.detach())
    frac = torch.stack([ux - x0, uy - y0, uz - z0], dim=-1)
    i32 = torch.int32
    idx = (z0.to(i32) * Y + y0.to(i32)) * X + x0.to(i32)
    return idx, frac


def sample_packed_trilinear(packed: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """Trilinear sample from a packed-corner grid. Returns [N, C] float32.

    Numerically identical to :func:`sample_grid_trilinear` on the unpacked
    grid (up to the packed dtype)."""
    Z, Y, X, C8 = packed.shape
    C = C8 // 8
    ux, uy, uz = _unnormalize(p_nor, Z, Y, X)
    x0 = torch.floor(ux.detach())
    y0 = torch.floor(uy.detach())
    z0 = torch.floor(uz.detach())
    fx, fy, fz = ux - x0, uy - y0, uz - z0
    idx = (z0.to(torch.long) * Y + y0.to(torch.long)) * X + x0.to(torch.long)
    rows = packed.reshape(-1, C8)[idx]  # [N, 8C], kept in the packed dtype
    out = None
    k = 0
    for dz in (0, 1):
        wz = fz if dz else (1 - fz)
        for dy in (0, 1):
            wzy = wz * (fy if dy else (1 - fy))
            for dx in (0, 1):
                w = wzy * (fx if dx else (1 - fx))
                term = rows[:, k * C : (k + 1) * C].to(torch.float32) * w[:, None]
                out = term if out is None else out + term
                k += 1
    return out
