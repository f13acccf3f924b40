"""Scene-bound geometry: coordinate normalization and ray/box interaction
(counterpart of ``evennicer_slam_tpu/core/bounds.py``)."""

from __future__ import annotations

import torch


def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Map world coordinates ``[..., 3]`` into [-1, 1]^3 for the given bound
    ``[3, 2]``. Pure (no in-place mutation)."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def ray_bound_exit(
    rays_o: torch.Tensor, rays_d: torch.Tensor, bound: torch.Tensor
) -> torch.Tensor:
    """Distance along each ray to its exit from the axis-aligned scene bound:
    per axis the ray crosses both planes at ``t = (bound - o) / d``; the exit
    is ``min_axis(max(t_lo, t_hi))``. Returns [N]."""
    t = (bound[None, :, :] - rays_o[..., :, None]) / rays_d[..., :, None]  # [N,3,2]
    return t.amax(dim=-1).amin(dim=-1)


def inside_bound_mask(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    bound: torch.Tensor,
) -> torch.Tensor:
    """Mask of rays whose surface (gt_depth) lies inside the scene bound:
    bound-exit distance >= gt depth. Callers keep the fixed shape and zero
    the masked rays' loss contributions."""
    return ray_bound_exit(rays_o, rays_d, bound) >= gt_depth


def points_inside_bound(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Strict inside-test per point ``[..., 3]``."""
    return ((p < bound[:, 1]) & (p > bound[:, 0])).all(dim=-1)
