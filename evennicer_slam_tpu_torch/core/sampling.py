"""Depth sampling along rays: stratified bins and hierarchical inverse-CDF
(counterpart of ``evennicer_slam_tpu/core/sampling.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, generator, like: torch.Tensor) -> torch.Tensor:
    """U[0,1) draws of ``shape`` on ``like``'s device, made on the generator's
    own device."""
    gdev = generator.device if generator is not None else like.device
    return torch.rand(
        shape, generator=generator, device=gdev, dtype=like.dtype
    ).to(like.device)


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    perturb: float = 0.0,
    lindisp: bool = False,
    t_rand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z values between near and far, ``[..., n_samples]``.

    ``near``/``far`` broadcast against each other; with ``perturb > 0`` and a
    generator (or the draws ``t_rand`` themselves) each sample is jittered
    inside its bin."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=far.device, dtype=far.dtype)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    if perturb > 0.0 and (generator is not None or t_rand is not None):
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = _uniform(z_vals.shape, generator, z_vals)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def surface_z_vals(
    gt_depth: torch.Tensor,
    n_surface: int,
    span: float = 0.05,
    zero_depth_far: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Near-surface z values: for rays with depth>0, ``n_surface`` uniform
    samples in [0.95 d, 1.05 d]; for zero-depth rays, uniform in
    [0.001, max depth] so interpolated geometry still gets color supervision.
    ``gt_depth``: [N]. Returns [N, n_surface]."""
    t = torch.linspace(0.0, 1.0, n_surface, device=gt_depth.device,
                       dtype=gt_depth.dtype)
    d = gt_depth[..., None]
    z_nonzero = (1.0 - span) * d * (1.0 - t) + (1.0 + span) * d * t
    far = gt_depth.max() if zero_depth_far is None else zero_depth_far
    z_zero = 0.001 * (1.0 - t) + far * t
    return torch.where(d > 0, z_nonzero, z_zero.expand(z_nonzero.shape))


def merge_sorted_zvals(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact merge of two per-row SORTED sequences ([N, A], [N, B]) into a
    sorted [N, A+B] without a sort.

    Rank of a[i] in the merged row = i + #{j : b[j] < a[i]};
    rank of b[j] = j + #{i : a[i] <= b[j]}. Ties split consistently, so the
    ranks form a permutation and placement is one scatter."""
    A = a.shape[-1]
    B = b.shape[-1]
    ra = torch.arange(A, device=a.device) + torch.sum(
        b[..., None, :] < a[..., :, None], dim=-1)
    rb = torch.arange(B, device=a.device) + torch.sum(
        a[..., None, :] <= b[..., :, None], dim=-1)
    vals = torch.cat([a, b], dim=-1)
    ranks = torch.cat([ra, rb], dim=-1)
    return torch.zeros_like(vals).scatter(-1, ranks, vals)


def sample_pdf(
    generator: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hierarchical (importance) sampling by inverting the per-ray CDF.

    ``bins``: [N, B], ``weights``: [N, B-1] -> samples [N, n_samples].
    Weights get +1e-5, the CDF is prepended with 0, right-searchsorted,
    degenerate bins get t=u. ``u`` supplies the uniform draws instead of the
    generator (ignored when ``det``)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    if det:
        u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(cdf.shape[:-1] + (n_samples,))
    elif u is None:
        u = _uniform(cdf.shape[:-1] + (n_samples,), generator, cdf)

    inds = torch.searchsorted(cdf.detach(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=bins.shape[-1] - 1))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=bins.shape[-1] - 1))

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
