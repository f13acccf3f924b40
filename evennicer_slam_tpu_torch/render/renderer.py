"""Volume renderer: depth-led sampling + staged decoding + compositing
(counterpart of ``evennicer_slam_tpu/render/renderer.py``).

- the sort/merge of stratified + near-surface samples happens per ray at the
  fixed width ``N_samples + N_surface`` (no dynamic boolean filtering),
- out-of-bound points get occupancy +100 ("solid walls") via ``where``,
- whole-image rendering walks the rays in chunks so a full-resolution image
  fits on the card; the port runs eagerly, so the last chunk is simply
  shorter (no padding to a fixed chunk),
- everything is differentiable wrt pose / grids / decoder params; through
  the fused decode (tracking) wrt the pose only, its rows and weights being
  frozen.

``regulation_sigma`` is iMAP's free-space term: densities sampled in front
of the surface.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.core.bounds import points_inside_bound, ray_bound_exit
from evennicer_slam_tpu_torch.core.composite import (
    composite_rays,
    composite_two_bands_occupancy,
)
from evennicer_slam_tpu_torch.core.rays import get_rays, get_rays_rescale
from evennicer_slam_tpu_torch.core.sampling import (
    merge_sorted_zvals,
    sample_pdf,
    stratified_z_vals,
    surface_z_vals,
)
from evennicer_slam_tpu_torch.models.decoders import decoder_forward
from evennicer_slam_tpu_torch.ops.resize import resize_bilinear
from evennicer_slam_tpu_torch.parallel.sharding import gather_rows, replicate, shard_rows
from evennicer_slam_tpu_torch.utils.runtime import require_on, resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER


class RenderSettings(NamedTuple):
    """Static rendering configuration. ``fused_decode=True`` sends the color
    stage through ``nice_forward_packed`` and so, for the standard decoder
    trio, through the fused decode."""

    n_samples: int = 32
    n_surface: int = 16
    n_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = True
    nice: bool = True
    coarse_bound_enlarge: float = 2.0
    fused_decode: bool = False

    @staticmethod
    def from_cfg(cfg: Dict[str, Any], nice: bool = True) -> "RenderSettings":
        r = cfg["rendering"]
        return RenderSettings(
            n_samples=r["N_samples"],
            n_surface=r["N_surface"],
            n_importance=r["N_importance"],
            lindisp=r["lindisp"],
            perturb=float(r["perturb"]),
            occupancy=cfg["occupancy"],
            nice=nice,
            coarse_bound_enlarge=float(cfg["model"]["coarse_bound_enlarge"]),
        )


def eval_points(
    decoders: Dict[str, Any],
    grids: Optional[Dict[str, torch.Tensor]],
    p: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    settings: RenderSettings,
    raw_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Decode raw (rgb, occ) for points [N, 3]; out-of-bound occ := 100.
    ``raw_fn(p, stage)`` replaces the decoders' forward when given."""
    if raw_fn is not None:
        raw = raw_fn(p, stage)
    else:
        raw = decoder_forward(
            decoders, grids, p, bound, stage,
            nice=settings.nice,
            coarse_bound_enlarge=settings.coarse_bound_enlarge,
            fused=settings.fused_decode,
        )
    inside = points_inside_bound(p, bound)
    occ = torch.where(inside, raw[..., -1], 100.0)
    return torch.cat([raw[..., :-1], occ[..., None]], dim=-1)


def render_rays(
    decoders: Dict[str, Any],
    grids: Optional[Dict[str, torch.Tensor]],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    settings: RenderSettings,
    gt_depth: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    far_max: Optional[torch.Tensor] = None,
    raw_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render a batch of rays -> (depth [N], depth_var [N], color [N, 3]).

    Depth-led stratified band [0.01 d, min(bound exit, 1.2 max d)] plus a
    near-surface band [0.95 d, 1.05 d] (uniform fallback for d == 0), z-sorted
    merge, staged decode, composite; optional importance resampling. The
    coarse stage ignores gt_depth. ``generator`` feeds the stratified jitter
    (``perturb > 0``) and the importance draws, in that order. ``far_max``
    is the batch's ``max(1.2 d)``: a caller that renders a batch in parts
    (``render_rays_dp``) hands in the whole batch's. ``raw_fn(points,
    stage)`` replaces the decoders' forward (``parallel/tp_example.py``
    decodes across its tensor-parallel slots)."""
    n_samples = settings.n_samples
    n_surface = settings.n_surface

    if stage == "coarse":
        gt_depth = None
    if gt_depth is None:
        n_surface = 0
        near = 0.01
    else:
        near = gt_depth[..., None] * 0.01  # [N, 1] broadcast over samples

    far_bb = ray_bound_exit(rays_o.detach(), rays_d.detach(), bound)[..., None] + 0.01
    if gt_depth is not None:
        if far_max is None:
            far_max = torch.max(gt_depth * 1.2)
        far = torch.minimum(torch.clamp(far_bb, min=0.0), far_max)
        # keep the stratified sequence monotone for the sort-free merge
        # (rays whose bound exit precedes the near plane are degenerate and
        # loss-masked anyway)
        far = torch.maximum(far, near + 1e-6)
    else:
        far = far_bb

    z_vals = stratified_z_vals(
        near, far, n_samples, generator=generator,
        perturb=settings.perturb, lindisp=settings.lindisp,
    )
    z_vals = z_vals.expand(rays_o.shape[:-1] + (n_samples,))

    def decode(z):
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
        flat = pts.reshape(-1, 3)
        raw = eval_points(decoders, grids, flat, bound, stage, settings, raw_fn)
        return raw.reshape(z.shape + (4,))

    if n_surface > 0 and settings.occupancy and settings.n_importance == 0:
        # occupancy compositing is interval-free, so the stratified and
        # surface bands need no merged sort (core/composite.py)
        z_surf = surface_z_vals(gt_depth, n_surface)
        z_cat = torch.cat([z_vals, z_surf], dim=-1)
        raw = decode(z_cat)
        depth, depth_var, color, _ = composite_two_bands_occupancy(
            raw[..., :n_samples, :], z_vals, raw[..., n_samples:, :], z_surf
        )
        return depth, depth_var, color

    if n_surface > 0:
        z_surf = surface_z_vals(gt_depth, n_surface)
        # both sequences are sorted -> exact merge, no sort
        z_vals = merge_sorted_zvals(z_vals, z_surf)

    raw = decode(z_vals)
    depth, depth_var, color, weights = composite_rays(
        raw, z_vals, rays_d, occupancy=settings.occupancy
    )

    if settings.n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            generator, z_mid, weights[..., 1:-1], settings.n_importance,
            det=(settings.perturb == 0.0),
        ).detach()
        z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
        raw = decode(z_vals)
        depth, depth_var, color, weights = composite_rays(
            raw, z_vals, rays_d, occupancy=settings.occupancy
        )

    return depth, depth_var, color


def render_rays_dp(
    decoders: Dict[str, Any],
    grids: Optional[Dict[str, torch.Tensor]],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    settings: RenderSettings,
    gt_depth: Optional[torch.Tensor] = None,
    dp: Optional[Sequence[torch.device]] = None,
    replicas: Optional[Sequence[Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``render_rays`` with the rays split over the ``dp`` slots (the JAX
    package's ray batches constrained to its dp mesh axis): each slot
    renders its rows through ``render_rays``, so the fused decode launches
    once a slot, and the outputs come back in order to the rays' device.
    The far plane is the whole batch's. ``replicas[i]`` = (decoders, grids,
    bound) on slot i, when the caller has them already (a frame's frozen
    map); otherwise they are made by a differentiable ``.to``, so the
    gradients of every slot's copy sum back into the parameters. ``dp``
    None is ``render_rays`` itself. The call is the span ``slam.render``
    (``utils/telemetry.py``)."""
    with TRACER.span("slam.render"):
        if dp is None:
            return render_rays(decoders, grids, rays_o, rays_d, bound, stage, settings,
                               gt_depth=gt_depth)
        lead = rays_o.device
        if stage == "coarse":
            gt_depth = None
        far_max = None if gt_depth is None else torch.max(gt_depth * 1.2)
        if replicas is None:
            replicas = [replicate((decoders, grids, bound), d) for d in dp]
        ro, rd = shard_rows(rays_o, dp), shard_rows(rays_d, dp)
        gd = shard_rows(gt_depth, dp) if gt_depth is not None else [None] * len(dp)
        outs = []
        for d, (dec, g, b), o, r, z in zip(dp, replicas, ro, rd, gd):
            if o.shape[0] == 0:  # fewer rays than slots
                continue
            outs.append(render_rays(dec, g, o, r, b, stage, settings, gt_depth=z,
                                    far_max=None if far_max is None else far_max.to(d)))
        return tuple(gather_rows([out[k] for out in outs], lead) for k in range(3))


def regulation_sigma(
    decoders: Dict[str, Any],
    grids: Optional[Dict[str, torch.Tensor]],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gt_depth: torch.Tensor,
    bound: torch.Tensor,
    settings: RenderSettings,
    generator: Optional[torch.Generator] = None,
    stage: str = "color",
    t_rand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """iMAP's free-space regulation: the raw density [N * n_samples] at
    ``settings.n_samples`` stratified depths in [0, 0.85 d] of each ray,
    always jittered inside their bins. The jitter [N, n_samples] is drawn
    from ``generator`` unless ``t_rand`` hands it in."""
    near = torch.zeros_like(gt_depth)[..., None]
    far = (gt_depth * 0.85)[..., None]
    if t_rand is None:
        gdev = generator.device if generator is not None else gt_depth.device
        t_rand = torch.rand((gt_depth.shape[0], settings.n_samples), generator=generator,
                            device=gdev).to(gt_depth.device)
    z_vals = stratified_z_vals(near, far, settings.n_samples, perturb=1.0, t_rand=t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = eval_points(decoders, grids, pts.reshape(-1, 3), bound, stage, settings)
    return raw[:, -1]


class Renderer:
    """Camera intrinsics + settings + scene bound on one device, with chunked
    whole-image rendering."""

    def __init__(
        self,
        H: int,
        W: int,
        fx: float,
        fy: float,
        cx: float,
        cy: float,
        bound: np.ndarray,
        settings: RenderSettings,
        ray_chunk: int = 65536,
        device=None,
    ):
        self.device = resolve_device(device)
        self.H, self.W = H, W
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.bound = torch.as_tensor(
            np.asarray(bound), dtype=torch.float32).to(self.device)
        self.settings = settings
        self.ray_chunk = ray_chunk

    def render_batch(self, decoders, grids, rays_o, rays_d, stage, gt_depth=None):
        require_on(self.device, rays_o, rays_d)
        return render_rays(
            decoders, grids, rays_o, rays_d, self.bound, stage, self.settings,
            gt_depth=gt_depth,
        )

    def _render_flat_chunked(self, decoders, grids, rays_o, rays_d, stage, gt_depth):
        """Render flattened rays ``ray_chunk`` at a time. The stratified far
        plane uses each chunk's own maximum depth, as in the JAX package."""
        n = rays_o.shape[0]
        chunk = min(self.ray_chunk, max(1, n))
        outs = []
        for i in range(0, n, chunk):
            d = None if gt_depth is None else gt_depth[i : i + chunk]
            outs.append(
                self.render_batch(
                    decoders, grids, rays_o[i : i + chunk], rays_d[i : i + chunk],
                    stage, d,
                )
            )
        depth = torch.cat([o[0] for o in outs])
        var = torch.cat([o[1] for o in outs])
        color = torch.cat([o[2] for o in outs])
        return depth, var, color

    def render_img(self, decoders, grids, c2w, stage, gt_depth=None):
        """Full-resolution image render -> (depth [H, W], var [H, W],
        color [H, W, 3])."""
        rays_o, rays_d = get_rays(
            self.H, self.W, self.fx, self.fy, self.cx, self.cy, c2w
        )
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        d = None if gt_depth is None else gt_depth.reshape(-1)
        depth, var, color = self._render_flat_chunked(
            decoders, grids, rays_o, rays_d, stage, d
        )
        return (
            depth.reshape(self.H, self.W),
            var.reshape(self.H, self.W),
            color.reshape(self.H, self.W, 3),
        )

    def render_img_rescale(
        self, decoders, grids, c2w, stage, gt_depth=None, scale_factor=0.15
    ):
        """Downscaled image render used by the event loss; the depth prior is
        resized bilinearly."""
        new_H, new_W = int(self.H * scale_factor), int(self.W * scale_factor)
        rays_o, rays_d = get_rays_rescale(
            self.H, self.W, new_H, new_W, self.fx, self.fy, self.cx, self.cy, c2w
        )
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        d = None
        if gt_depth is not None:
            d = resize_bilinear(gt_depth, (new_H, new_W)).reshape(-1)
        depth, var, color = self._render_flat_chunked(
            decoders, grids, rays_o, rays_d, stage, d
        )
        return (
            depth.reshape(new_H, new_W),
            var.reshape(new_H, new_W),
            color.reshape(new_H, new_W, 3),
        )
