"""Volume-rendering compositor: raw decoder outputs -> depth / variance / rgb
(counterpart of ``evennicer_slam_tpu/core/composite.py``).

Two modes: occupancy (``alpha = sigmoid(10 * raw)``, NICE-SLAM) and volume
density (``alpha = 1 - exp(-relu(raw) * dist)``, iMAP*). Nothing is mutated.
"""

from __future__ import annotations

from typing import Tuple

import torch


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` for inputs known to be nonzero. Autograd's own
    backward of ``cumprod`` first asks whether any input is zero, which
    reads a value back from the card and so waits for every queued launch;
    here the answer is known, and the backward is the formula autograd uses
    for nonzero inputs (the same values, bit for bit)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        out = torch.cumprod(x, dim=dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, out = ctx.saved_tensors
        w = out * grad
        return w.flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim).div(x), None


def composite_rays(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    occupancy: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite raw predictions along rays.

    Args:
        raw:    [N, S, 4] — rgb in [..., :3], occupancy/density in [..., 3].
        z_vals: [N, S] sample depths along each ray.
        rays_d: [N, 3] ray directions (non-unit; scales density intervals).
        occupancy: True -> occupancy mode; False -> density mode.

    Returns:
        (depth [N], depth_var [N], rgb [N, 3], weights [N, S])
    """
    rgb = raw[..., :-1]
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., -1])
    else:
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat(
            [dists, torch.full_like(dists[..., :1], 1e10)], dim=-1
        )
        dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
        alpha = 1.0 - torch.exp(-torch.clamp(raw[..., -1], min=0.0) * dists)

    # transmittance: cumprod of (1 - alpha + 1e-10), exclusive; every factor
    # is at least 1e-10
    trans = _PositiveCumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1), -1,
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth_map, depth_var, rgb_map, weights


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(
        torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1), dim=-1
    )


def composite_two_bands_occupancy(
    raw_a: torch.Tensor,
    z_a: torch.Tensor,
    raw_b: torch.Tensor,
    z_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Occupancy-mode compositing of TWO per-row-sorted sample bands WITHOUT
    merging/sorting them.

    In occupancy mode the interval lengths are unused (alpha depends only on
    the raw value), so the merged-order transmittance
    ``T_i = prod_{z_j < z_i} (1 - alpha_j + 1e-10)`` factorizes into an
    in-band exclusive prefix product and a cross-band prefix product looked
    up at the sample's cross rank. Equal to sorting + composite_rays up to
    floating-point association.

    Returns (depth, depth_var, rgb, weights_cat[A+B in concat order]).
    """
    alpha_a = torch.sigmoid(10.0 * raw_a[..., -1])
    alpha_b = torch.sigmoid(10.0 * raw_b[..., -1])
    # clamp: 1 - alpha + 1e-10 is exactly 0 in float32 for alpha == 1, and
    # log(0) = -inf would poison the prefix sums
    la = torch.log(torch.clamp(1.0 - alpha_a + 1e-10, min=1e-10))
    lb = torch.log(torch.clamp(1.0 - alpha_b + 1e-10, min=1e-10))

    ca_excl = _exclusive_cumsum(la)
    cb_excl = _exclusive_cumsum(lb)

    # cross-band sums: masked reductions over the comparison tensors
    cmp_ba = (z_b[..., None, :] < z_a[..., :, None]).to(la.dtype)  # [N,A,B]
    cmp_ab = (z_a[..., None, :] <= z_b[..., :, None]).to(la.dtype)  # [N,B,A]
    cross_a = torch.sum(cmp_ba * lb[..., None, :], dim=-1)
    cross_b = torch.sum(cmp_ab * la[..., None, :], dim=-1)

    T_a = torch.exp(ca_excl + cross_a)
    T_b = torch.exp(cb_excl + cross_b)
    w_a = alpha_a * T_a
    w_b = alpha_b * T_b

    rgb_map = torch.sum(w_a[..., None] * raw_a[..., :-1], dim=-2) + torch.sum(
        w_b[..., None] * raw_b[..., :-1], dim=-2
    )
    depth_map = torch.sum(w_a * z_a, dim=-1) + torch.sum(w_b * z_b, dim=-1)
    ta = z_a - depth_map[..., None]
    tb = z_b - depth_map[..., None]
    depth_var = torch.sum(w_a * ta * ta, dim=-1) + torch.sum(w_b * tb * tb, dim=-1)
    weights = torch.cat([w_a, w_b], dim=-1)
    return depth_map, depth_var, rgb_map, weights
