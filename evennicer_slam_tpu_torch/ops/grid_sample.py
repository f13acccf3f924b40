"""Trilinear feature-grid sampling (counterpart of
``evennicer_slam_tpu/ops/grid_sample.py``).

Numerically equivalent to ``F.grid_sample(grid, vgrid,
padding_mode='border', align_corners=True, mode='bilinear')`` on a
``[1, C, Z, Y, X]`` grid, but with the channels-last layout ``[Z, Y, X, C]``
the JAX package uses, so each corner lookup is a contiguous [C]-vector row.
"""

from __future__ import annotations

import torch


def _unnormalize(p_nor: torch.Tensor, Z: int, Y: int, X: int):
    """align_corners=True (-1 -> 0, +1 -> size-1) with border padding: the
    continuous coordinate is clamped into the valid range."""
    ux = torch.clamp((p_nor[..., 0] + 1.0) * 0.5 * (X - 1), 0.0, X - 1)
    uy = torch.clamp((p_nor[..., 1] + 1.0) * 0.5 * (Y - 1), 0.0, Y - 1)
    uz = torch.clamp((p_nor[..., 2] + 1.0) * 0.5 * (Z - 1), 0.0, Z - 1)
    return ux, uy, uz


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
    """
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
