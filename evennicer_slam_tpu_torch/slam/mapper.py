"""Mapper: joint optimisation of the scene (feature grids, decoders) and,
under BA, of the window's camera poses (counterpart of
``evennicer_slam_tpu/slam/mapper.py``).

``map_frame`` is the JAX package's ``map_frame_jit`` as an eager loop: the
staged middle -> fine -> colour schedule runs stage after stage with the
iteration counts and learning rates of the call, autograd through the
render, and the functional Adam of ``utils/optim.py``. ``Mapper`` is the
host-side front end: window selection, frustum masks, the keyframe registry,
the BA write-back.

Semantics:
- keyframe window = (window_size - 2 selected) + last keyframe + current
  frame; ``pixels // K`` rays per window frame,
- staged learning rates from ``mapping.stage``, scaled by ``lr_factor``;
  Adam moments persist across the stages of a call and are built anew for
  every call; a leaf that the stage does not optimise keeps its parameter,
  moments and step count (``adam_update(active=...)``),
- frustum feature selection as a gradient mask: masked cells still take an
  Adam step with a zero gradient, so their moments decay,
- BA: window poses optimised (the oldest keyframe anchored) with
  ``BA_cam_lr`` in the colour stage only,
- loss = depth L1 over rays with a depth reading whose surface lies inside
  the bound, plus ``w_color_loss`` x colour L1 in the colour stage,
- the fused coarse term: the coarse mapper's loss (its own globally random
  window, depth-unguided render, no BA) is added to every staged iteration;
  its parameters are disjoint from the staged ones, so one Adam step equals
  two optimisers,
- ``use_events``: a second Adam step after each main step on the event loss
  of the current frame's 0.15-scale render; its optimiser leaves out the
  colour and coarse grids,
- iMAP (``settings.nice`` False): no grids; one colour stage of every
  iteration, the whole MLP at ``imap_decoders_lr`` scaled by
  ``0.8 ** (it // 200)`` (a StepLR over the call's global iteration), the
  colour loss on every ray and no inside mask, no frustum masks and no
  coarse term,
- a non-occupancy render (``occupancy: false``, iMAP's) adds the free-space
  regulation ``0.0005 * sum |sigma|`` of ``render/renderer.py``'s
  ``regulation_sigma`` on the same rays.

Randomness: the pixel draws of a call are made once per stage, one
``randint`` of shape [iterations, K, pixels] from a generator seeded by the
call's seed and the stage, and so are the regulation's depth jitters, one
``rand`` of shape [iterations, rays, n_samples] from a stream of their own;
a call split into chunks slices them, so it is bitwise equal to the
unchunked call. Keyframe selection draws from numpy generators exactly as
the JAX package does.

``dp`` (a list of device slots, or None) is the JAX package's device-mesh
argument: every ray batch of the losses renders split over the slots
(``render/renderer.py::render_rays_dp``), the parameters reaching each slot
by a differentiable ``.to``, so the gradients of the copies sum back; the
losses are computed on the mapper's device as at dp = 1. iMAP's free-space
regulation stays on the mapper's device.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.core.bounds import inside_bound_mask
from evennicer_slam_tpu_torch.core.quaternion import (
    pose_matrix_from_tensor,
    pose_matrix_from_tensor_np,
    tensor_from_pose_matrix,
    tensor_from_pose_matrix_np,
)
from evennicer_slam_tpu_torch.core.rays import get_rays_rescale
from evennicer_slam_tpu_torch.models.eventnet import inference_event
from evennicer_slam_tpu_torch.ops.gaussian_blur import gaussian_blur
from evennicer_slam_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from evennicer_slam_tpu_torch.render.renderer import (
    RenderSettings,
    regulation_sigma,
    render_rays_dp,
)
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.keyframes import (
    KeyframeStore,
    frustum_feature_mask,
    frustum_feature_masks,
    host_array,
    keyframe_selection_overlap,
    random_select,
    scatter_window_poses,
    select_assemble_window,
    to_device,
)
from evennicer_slam_tpu_torch.slam.tracker import _check_prev_resize, esim_predict
from evennicer_slam_tpu_torch.utils.optim import (
    AdamState,
    adam_init,
    adam_update,
    tree_map,
)
from evennicer_slam_tpu_torch.utils.runtime import require_on, resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER

STAGE_IDS = {"coarse": 0, "middle": 1, "fine": 2, "color": 3}
# the span of a device read on the mapper's host path
MAP_HOST = "slam.sync.map_host"


class MapperConfig(NamedTuple):
    """Same fields as the JAX package's ``MapperConfig``."""

    pixels: int = 1000
    iters: int = 60
    iters_first: int = 1500
    lr_first_factor: float = 5.0
    lr_factor: float = 1.0
    middle_iter_ratio: float = 0.4
    fine_iter_ratio: float = 0.6
    every_frame: int = 5
    window_size: int = 5
    keyframe_every: int = 50
    keyframe_selection: str = "overlap"
    frustum_feature_selection: bool = True
    BA: bool = False
    BA_cam_lr: float = 0.001
    fix_fine: bool = True
    fix_color: bool = False
    w_color_loss: float = 0.2
    color_refine: bool = True
    save_selected_keyframes_info: bool = False
    use_events: bool = False
    event_scale_factor: float = 0.15
    event_predictor: str = "unet"
    esim_gain: float = 20.0
    keyframe_catchup: bool = False
    imap_decoders_lr: float = 0.0002
    prev_resize: str = "nearest"  # see TrackerConfig.prev_resize
    stage_lrs: Tuple[Tuple[str, Tuple[float, float, float, float, float]], ...] = ()

    @staticmethod
    def from_cfg(cfg: Dict[str, Any], use_events: bool = False) -> "MapperConfig":
        m = cfg["mapping"]
        stage_lrs = tuple(
            (
                s,
                (
                    m["stage"][s]["decoders_lr"],
                    m["stage"][s]["coarse_lr"],
                    m["stage"][s]["middle_lr"],
                    m["stage"][s]["fine_lr"],
                    m["stage"][s]["color_lr"],
                ),
            )
            for s in ("coarse", "middle", "fine", "color")
        ) if "stage" in m else ()
        concurrent = (
            cfg.get("sync_method", "strict") in ("loose", "free")
            and int(cfg.get("parallel", {}).get("map_devices", 0) or 0) > 0
        )
        if concurrent and not m.get("keyframe_catchup", False):
            warnings.warn(
                "concurrent loose/free mapping maps whatever frame tracking"
                " is on when the previous call completes, so mapped indices"
                " are timing-dependent and `idx % keyframe_every == 0` may"
                " NEVER fire — the keyframe registry starves and meshing"
                " discards unanchored regions. Set mapping.keyframe_catchup:"
                " true to add a keyframe whenever a full keyframe_every"
                " window passes without one.",
                stacklevel=2,
            )
        if m["keyframe_every"] % m["every_frame"] != 0:
            eff = math.lcm(m["keyframe_every"], m["every_frame"])
            warnings.warn(
                f"mapping.keyframe_every={m['keyframe_every']} is not a"
                f" multiple of mapping.every_frame={m['every_frame']}:"
                " keyframes are only added at mapped frames, so the EFFECTIVE"
                f" cadence is lcm={eff} frames. Mesh extraction bounds and"
                " keyframe windows are built from keyframes only — a sparse"
                " registry silently discards mapped regions at meshing time.",
                stacklevel=2,
            )
        ev = cfg.get("event", {})
        return MapperConfig(
            pixels=m["pixels"],
            iters=m["iters"],
            iters_first=m["iters_first"],
            lr_first_factor=m["lr_first_factor"],
            lr_factor=m["lr_factor"],
            middle_iter_ratio=m["middle_iter_ratio"],
            fine_iter_ratio=m["fine_iter_ratio"],
            every_frame=m["every_frame"],
            window_size=m["mapping_window_size"],
            keyframe_every=m["keyframe_every"],
            keyframe_selection=m["keyframe_selection_method"],
            frustum_feature_selection=m["frustum_feature_selection"],
            BA=m["BA"],
            BA_cam_lr=m["BA_cam_lr"],
            fix_fine=m["fix_fine"],
            fix_color=m["fix_color"],
            w_color_loss=m["w_color_loss"],
            color_refine=m["color_refine"],
            save_selected_keyframes_info=m.get("save_selected_keyframes_info", False),
            use_events=use_events,
            event_scale_factor=ev.get("scale_factor", 0.15),
            event_predictor=ev.get("predictor", "unet"),
            esim_gain=float(ev.get("esim_gain", 20.0)),
            keyframe_catchup=m.get("keyframe_catchup", False),
            imap_decoders_lr=m.get("imap_decoders_lr", 0.0002),
            prev_resize=_check_prev_resize(ev.get("prev_resize", "nearest")),
            stage_lrs=stage_lrs,
        )

    def stage_lr_dict(self, stage: str) -> Dict[str, float]:
        for s, (dec, co, mid, fi, col) in self.stage_lrs:
            if s == stage:
                return {"decoders": dec, "coarse": co, "middle": mid,
                        "fine": fi, "color": col}
        raise KeyError(stage)


# ---------------------------------------------------------------------------
# one mapping call
# ---------------------------------------------------------------------------

def _window_c2w(cam_tensors: torch.Tensor, fixed_c2w: torch.Tensor, ba: bool) -> torch.Tensor:
    """Per-slot camera matrices [K, 3, 4]: from the optimised tensors under
    BA, else the fixed estimates."""
    if ba:
        return pose_matrix_from_tensor(cam_tensors)
    return fixed_c2w[:, :3, :]


def _sample_window_rays(pixel_idx: torch.Tensor, c2ws: torch.Tensor, colors: torch.Tensor,
                        depths: torch.Tensor, cam: Camera):
    """Rays of the drawn pixels of every window frame, flattened.
    ``pixel_idx`` [K, P] holds flat pixel indices (row * W + column)."""
    K, P = pixel_idx.shape
    jj = torch.div(pixel_idx, cam.W, rounding_mode="floor")
    ii = pixel_idx % cam.W
    jf, if_ = jj.to(torch.float32), ii.to(torch.float32)
    dirs = torch.stack(
        [(if_ - cam.cx) / cam.fx, -(jf - cam.cy) / cam.fy, -torch.ones_like(if_)], dim=-1)
    # explicit multiply-add, as rays_from_uv, batched over the window
    rays_d = torch.sum(dirs[..., None, :] * c2ws[:, None, :3, :3], dim=-1)
    rays_o = c2ws[:, None, :3, -1].expand(rays_d.shape)
    k = torch.arange(K, device=pixel_idx.device)[:, None]
    b_depth = depths[k, jj, ii]
    b_color = colors[k, jj, ii]
    return (rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), b_depth.reshape(-1),
            b_color.reshape(-1, 3))


def _map_loss(params, fixed_c2w, colors, depths, bound, pixel_idx, cfg: MapperConfig,
              cam: Camera, settings: RenderSettings, stage: str, ba: bool,
              coarse_mapper: bool, reg_draws: Optional[torch.Tensor] = None,
              dp=None) -> torch.Tensor:
    """The mapping loss of one window for the drawn pixels ``pixel_idx``
    [K, P]; ``params`` = (grids, decoders, cam_tensors). A non-occupancy
    render adds the free-space regulation, its depth jitter ``reg_draws``
    [K * P, n_samples]. ``dp``: the render's rays split over these slots."""
    grids, decoders, cam_tensors = params
    c2ws = _window_c2w(cam_tensors, fixed_c2w, ba)
    rays_o, rays_d, b_depth, b_color = _sample_window_rays(pixel_idx, c2ws, colors, depths, cam)
    if settings.nice:
        inside = inside_bound_mask(rays_o.detach(), rays_d.detach(), b_depth, bound)
    else:
        inside = torch.ones_like(b_depth, dtype=torch.bool)
    depth, _, color = render_rays_dp(
        decoders, grids, rays_o, rays_d, bound, stage, settings,
        gt_depth=None if coarse_mapper else b_depth, dp=dp,
    )
    depth_mask = (b_depth > 0) & inside
    loss = torch.sum(torch.abs(b_depth - depth) * depth_mask)
    if (not settings.nice) or stage == "color":
        loss = loss + cfg.w_color_loss * torch.sum(torch.abs(b_color - color) * inside[:, None])
    if not settings.occupancy:
        sigma = regulation_sigma(decoders, grids, rays_o, rays_d, b_depth, bound, settings,
                                 stage=stage, t_rand=reg_draws)
        loss = loss + 0.0005 * torch.sum(torch.abs(sigma))
    return loss


def _f32_product(a: float, b: float) -> float:
    """``a * b`` rounded as float32 arithmetic rounds it (the JAX package
    scales its learning rates in float32)."""
    return float(np.float32(a) * np.float32(b))


def imap_lr_factor(it: int) -> float:
    """iMAP's StepLR (step 200, gamma 0.8) at the call's global iteration
    ``it``, in float32 as the JAX package computes it."""
    return float(np.float32(0.8) ** np.float32(it // 200))


def _decoder_lr_tree(decoders, lrs: Dict[str, Any], cfg: MapperConfig, nice: bool = True):
    """Per-leaf rates of the decoders. NICE: the fine decoder unless
    ``fix_fine``, the colour decoder unless ``fix_color``; the middle and
    coarse decoders are never optimised. iMAP: the whole MLP."""
    out = {}
    for name in decoders:
        if not nice:
            lr = lrs["decoders"]
        elif name == "fine":
            lr = 0.0 if cfg.fix_fine else lrs["decoders"]
        elif name == "color":
            lr = 0.0 if cfg.fix_color else lrs["decoders"]
        else:
            lr = 0.0
        out[name] = tree_map(lambda _, lr=lr: lr, decoders[name])
    return out


def _mask_grid_grads(grid_grads, grid_masks, coarse_mapper: bool, fused: bool = False):
    """Frustum selection as a gradient mask: the coarse mapper touches only
    the coarse grid, the fine mapper everything but coarse. With the fused
    coarse term the coarse gradient (produced only by that term) passes.
    ``None`` (a leaf the step does not optimise) stays ``None``."""
    out = {}
    for lvl, g in grid_grads.items():
        if g is None:
            out[lvl] = None
            continue
        keep = (lvl == "coarse") if coarse_mapper else (fused or lvl != "coarse")
        out[lvl] = g * grid_masks[lvl] if keep else torch.zeros_like(g)
    return out


def _value_and_grad(loss_fn, params, active):
    """(loss, grads) with gradients for the active leaves only (``None``
    elsewhere): the JAX package differentiates every leaf and the optimiser
    ignores the inactive ones, so asking autograd for the active leaves is
    the same step without the backward of the frozen ones."""
    leaves: List[torch.Tensor] = []

    def mark(act, x):
        if not act:
            return x
        x = x.detach().requires_grad_()
        leaves.append(x)
        return x

    def take(act, x):
        if not act:
            return None
        g = next(grads)
        return torch.zeros_like(x) if g is None else g

    with TRACER.span("slam.map.iter.loss"):
        p = tree_map(mark, active, params)
        loss = loss_fn(p)
    with TRACER.span("slam.map.iter.grad"):
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        return loss.detach(), tree_map(take, active, p)


def _mapper_event_loss(params, fixed_c2w, bound, prev_color_lo, gt_event_lo,
                       gt_depth_lo_flat, eventnet, cfg: MapperConfig, cam: Camera,
                       settings: RenderSettings, ba: bool, balancer: float,
                       dp=None) -> torch.Tensor:
    """Event loss of the current frame (the window's last slot): L2 of the
    GT events against the prediction from the 0.15-scale render, plus the
    same after a 3x3 Gaussian blur, times ``balancer``."""
    grids, decoders, cam_tensors = params
    cur_c2w = _window_c2w(cam_tensors, fixed_c2w, ba)[-1]
    lo_h, lo_w = prev_color_lo.shape[:2]
    rays_o, rays_d = get_rays_rescale(cam.H, cam.W, lo_h, lo_w, cam.fx, cam.fy, cam.cx,
                                      cam.cy, cur_c2w)
    _, _, cur_lo = render_rays_dp(
        decoders, grids, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), bound, "color",
        settings, gt_depth=gt_depth_lo_flat, dp=dp,
    )
    cur_lo = cur_lo.reshape(lo_h, lo_w, 3)
    if cfg.event_predictor == "esim":
        pred, _ = esim_predict(prev_color_lo, cur_lo, cfg.esim_gain)
    else:
        pred, _ = inference_event(eventnet, prev_color_lo, cur_lo)
    loss = torch.sum((gt_event_lo - pred) ** 2)
    loss = loss + torch.sum((gaussian_blur(gt_event_lo, 3) - gaussian_blur(pred, 3)) ** 2)
    return loss * balancer


def map_frame(
    grids,
    decoders,
    cam_tensors: torch.Tensor,
    adam: Optional[AdamState],
    adam_ev: Optional[AdamState],
    fixed_c2w: torch.Tensor,
    opt_cam_mask: torch.Tensor,
    colors: torch.Tensor,
    depths: torch.Tensor,
    grid_masks: Dict[str, torch.Tensor],
    bound: torch.Tensor,
    pixel_draws: Dict[str, torch.Tensor],
    seg_lens: Dict[str, int],
    lr_factor: float,
    prev_color_lo: Optional[torch.Tensor],
    gt_event_lo: Optional[torch.Tensor],
    gt_depth_lo_flat: Optional[torch.Tensor],
    eventnet,
    event_balancer: float,
    colors_c: Optional[torch.Tensor],
    depths_c: Optional[torch.Tensor],
    fixed_c2w_c: Optional[torch.Tensor],
    pixel_draws_c: Optional[Dict[str, torch.Tensor]],
    cfg: MapperConfig,
    cam: Camera,
    settings: RenderSettings,
    ba: bool,
    coarse_mapper: bool,
    use_frustum: bool,
    stages: Tuple[str, ...],
    use_events: bool,
    fix_color_now: bool,
    fuse_coarse: bool = False,
    init_adam: bool = False,
    device=None,
    seg_starts: Optional[Dict[str, int]] = None,
    reg_draws: Optional[Dict[str, torch.Tensor]] = None,
    dp=None,
):
    """One mapping call (or one chunk of it): the stages in sequence, each
    for ``seg_lens[stage]`` iterations, nothing read back to the host.

    ``pixel_draws[stage]`` [seg_lens[stage], K, P] holds the flat pixel
    indices of each of the stage's iterations in this chunk, one row of P per
    window frame (``pixel_draws_c`` the same for the fused coarse term's
    window). ``reg_draws[stage]`` [seg_lens[stage], K * P, n_samples] holds
    the regulation's depth jitter, needed by a non-occupancy render (iMAP's;
    a fused coarse term, NICE's only, draws its own from the global
    generator). ``seg_starts[stage]`` is the stage's first iteration in this
    chunk (0 when not given), which iMAP's StepLR counts from. Adam state is threaded through: ``init_adam`` builds
    it anew (the first chunk of a call) and ignores ``adam`` / ``adam_ev``.
    ``dp`` (device slots, or None) splits the rays of every render.

    Returns (grids, decoders, cam_tensors, adam, adam_ev, last_loss,
    last_event_loss); the losses are tensors of the last iteration."""
    device = resolve_device(device)
    require_on(device, cam_tensors, fixed_c2w, colors, bound)
    nice = settings.nice
    params = (grids, decoders, cam_tensors)
    if init_adam:
        with TRACER.span("slam.map.init"):
            adam = adam_init(params, per_leaf_t=True)
            adam_ev = adam_init(params, per_leaf_t=True) if use_events else None
    cfg_now = cfg._replace(fix_color=cfg.fix_color or fix_color_now)

    def active_trees(stage: str, event_update: bool):
        """Which leaves the step optimises: a leaf is active iff its
        parameter group is in the optimiser and the stage's loss reaches
        it. Inactive leaves keep parameter, moments and step count."""
        if event_update:
            # the event optimiser: decoders and the middle / fine grids (the
            # colour grid is left out; its colour-stage render never reaches
            # the coarse grid)
            grid_on = {"coarse": False, "middle": True, "fine": True, "color": False}
        else:
            grid_on = {
                "coarse": stage == "coarse" or fuse_coarse,
                "middle": stage in ("middle", "fine", "color"),
                "fine": stage in ("fine", "color"),
                "color": stage == "color",
            }
        g_act = {lvl: grid_on.get(lvl, False) for lvl in grids}

        def dec_on(name: str) -> bool:
            if not nice:
                return True  # iMAP: the whole MLP is the parameter list
            if name == "fine":
                return (not cfg.fix_fine) and (event_update or stage in ("fine", "color"))
            if name == "color":
                return (not cfg_now.fix_color) and (event_update or stage == "color")
            return False

        d_act = {name: tree_map(lambda _, on=dec_on(name): on, decoders[name])
                 for name in decoders}
        return (g_act, d_act, ba)

    def lr_trees(stage: str, event_update: bool, it: Optional[int] = None):
        """Per-leaf rates; iMAP's StepLR applies to the main step at
        iteration ``it`` (the event step keeps the unscaled rate, as in the
        JAX package)."""
        if nice:
            lrs_host = dict(cfg.stage_lr_dict(stage))
        else:
            lrs_host = {"decoders": cfg.imap_decoders_lr, "coarse": 0.0, "middle": 0.0,
                        "fine": 0.0, "color": 0.0}
        if fuse_coarse:
            # the coarse grid trains at the coarse stage's rate throughout
            lrs_host["coarse"] = cfg.stage_lr_dict("coarse")["coarse"]
        g_lrs = {lvl: _f32_product(lrs_host.get(lvl, 0.0), lr_factor)
                 for lvl in ("coarse", "middle", "fine", "color")}
        if event_update:
            g_lrs["color"] = 0.0
            g_lrs["coarse"] = 0.0
        dec_lr = _f32_product(lrs_host["decoders"], lr_factor)
        if not nice and it is not None:
            dec_lr = _f32_product(dec_lr, imap_lr_factor(it))
        cam_lr = cfg.BA_cam_lr if (ba and stage == "color") else 0.0
        return ({lvl: g_lrs[lvl] for lvl in grids},
                _decoder_lr_tree(decoders, {"decoders": dec_lr}, cfg_now, nice),
                opt_cam_mask[:, None] * cam_lr)

    last_loss = torch.zeros((), device=device)
    last_ev = torch.zeros((), device=device)
    for stage in stages:
        n = int(seg_lens[stage])
        if n == 0:
            continue
        with TRACER.span("slam.map.stage"):
            act_main = active_trees(stage, event_update=False)
            lrs_main = lr_trees(stage, event_update=False)
            if use_events:
                act_ev = active_trees(stage, event_update=True)
                lrs_ev = lr_trees(stage, event_update=True)
        draws = pixel_draws[stage]
        draws_c = pixel_draws_c[stage] if fuse_coarse else None
        reg = reg_draws[stage] if reg_draws is not None else None
        start = seg_starts[stage] if seg_starts is not None else 0
        for i in range(n):
            def loss_fn(p, i=i):
                loss = _map_loss(p, fixed_c2w, colors, depths, bound, draws[i], cfg_now, cam,
                                 settings, stage, ba, coarse_mapper,
                                 None if reg is None else reg[i], dp=dp)
                if fuse_coarse:
                    loss = loss + _map_loss(p, fixed_c2w_c, colors_c, depths_c, bound,
                                            draws_c[i], cfg_now, cam, settings, "coarse",
                                            False, True, dp=dp)
                return loss

            def ev_fn(p):
                return _mapper_event_loss(p, fixed_c2w, bound, prev_color_lo, gt_event_lo,
                                          gt_depth_lo_flat, eventnet, cfg, cam, settings,
                                          ba, event_balancer, dp=dp)

            with TRACER.span("slam.map.iter"):
                if not nice:
                    lrs_main = lr_trees(stage, event_update=False, it=start + i)
                last_loss, grads = _value_and_grad(loss_fn, params, act_main)
                with TRACER.span("slam.map.iter.step"), torch.no_grad():
                    if use_frustum:
                        grads = (_mask_grid_grads(grads[0], grid_masks, coarse_mapper,
                                                  fused=fuse_coarse), grads[1], grads[2])
                    params, adam = adam_update(grads, adam, params, lrs_main, active=act_main)
                if use_events:
                    last_ev, ev_grads = _value_and_grad(ev_fn, params, act_ev)
                    with TRACER.span("slam.map.iter.step"), torch.no_grad():
                        if use_frustum:
                            ev_grads = (_mask_grid_grads(ev_grads[0], grid_masks,
                                                         coarse_mapper),
                                        ev_grads[1], ev_grads[2])
                        params, adam_ev = adam_update(ev_grads, adam_ev, params, lrs_ev,
                                                      active=act_ev)
    return params[0], params[1], params[2], adam, adam_ev, last_loss, last_ev


# ---------------------------------------------------------------------------
# host-side front end
# ---------------------------------------------------------------------------

def stage_schedule(num_joint_iters: int, cfg: MapperConfig, coarse_mapper: bool,
                   color_refine: bool, nice: bool = True
                   ) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """The stages of a call and their iteration counts."""
    if coarse_mapper:
        return ("coarse",), {"coarse": num_joint_iters}
    if color_refine or not nice:
        return ("color",), {"color": num_joint_iters}
    m_end = int(num_joint_iters * cfg.middle_iter_ratio)
    f_end = int(num_joint_iters * cfg.fine_iter_ratio)
    return ("middle", "fine", "color"), {
        "middle": m_end + 1,
        "fine": f_end - m_end,
        "color": num_joint_iters - 1 - f_end,
    }


class Mapper:
    """Host-side front end of mapping: window selection, frustum masks, keyframe
    registry, and the call into :func:`map_frame`. ``device=None`` means
    the CUDA device; ``dp`` (device slots, or None) splits the rays of
    every render over the slots."""

    def __init__(
        self,
        cfg: MapperConfig,
        cam: Camera,
        settings: RenderSettings,
        bound: np.ndarray,
        coarse_mapper: bool = False,
        eventnet: Optional[Dict] = None,
        seed: int = 1234,
        device=None,
        dp=None,
    ):
        self.device = resolve_device(device)
        self.dp = dp
        self.cfg = cfg
        self.cam = cam
        self.settings = settings
        self.bound_np = np.asarray(bound, np.float32)
        self.bound = to_device(self.bound_np, self.device)
        self.coarse_mapper = coarse_mapper
        self.keyframes = KeyframeStore(device=self.device)
        self.eventnet = eventnet if eventnet is not None else {}
        self.rng = np.random.default_rng(seed)
        # the coarse mapper's optimisation folded into this mapper's calls
        # (see map_frame's fused coarse term); its window selection draws
        # from a stream of its own so that fusing leaves the fine mapper's
        # selection unchanged
        self.fuse_coarse = False
        self.rng_coarse = np.random.default_rng(seed + 1)
        self.BA_active = False
        self.last_loss: Any = 0.0
        self.last_window_size = 0  # K of the last call
        self.selected_keyframes: Dict[int, list] = {}
        self.selection = "global" if coarse_mapper else cfg.keyframe_selection
        self.lo_hw = (int(cam.H * cfg.event_scale_factor), int(cam.W * cfg.event_scale_factor))
        # device constants reused by every call (filled on the device)
        self._ones_masks: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._zeros_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def _ones_mask(self, shape_zyx) -> torch.Tensor:
        key = tuple(int(s) for s in shape_zyx)
        if key not in self._ones_masks:
            self._ones_masks[key] = torch.ones(key + (1,), device=self.device)
        return self._ones_masks[key]

    def _zeros(self, *shape) -> torch.Tensor:
        if shape not in self._zeros_cache:
            self._zeros_cache[shape] = torch.zeros(shape, device=self.device)
        return self._zeros_cache[shape]

    # -- randomness (tests hand in the JAX package's draws here) -------------

    def _draw_pixels(self, seed: int, stage: str, term: int, n: int, K: int,
                     pix: int) -> torch.Tensor:
        """Flat pixel indices [n, K, pix] of every iteration of ``stage`` in a
        call; ``term`` 1 is the fused coarse term's window."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((seed * 4 + STAGE_IDS[stage]) * 2 + term) % (2 ** 63))
        return torch.randint(0, self.cam.H * self.cam.W, (n, K, pix), generator=gen,
                             device=self.device)

    def _draw_regulation(self, seed: int, stage: str, n: int, rays: int) -> torch.Tensor:
        """The free-space regulation's depth jitter [n, rays, n_samples] of
        every iteration of ``stage`` in a call (a non-occupancy render)."""
        gen = torch.Generator(device=self.device)
        # 2**62 apart from the pixel streams' seeds of any call
        gen.manual_seed((seed * 4 + STAGE_IDS[stage] + 2 ** 62) % (2 ** 63))
        return torch.rand((n, rays, self.settings.n_samples), generator=gen,
                          device=self.device)

    def _selection_draws(self, seed: int, n_kf: int):
        """(pixel indices [100], priorities [n_kf - 1]) of the device-side
        window selection."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed * 2 + 1)
        idx = torch.randint(0, self.cam.H * self.cam.W, (100,), generator=gen,
                            device=self.device)
        return idx, torch.rand((n_kf - 1,), generator=gen, device=self.device)

    # -- window selection ---------------------------------------------------

    def select_window(self, gt_color, gt_depth, cur_c2w, selection: Optional[str] = None,
                      rng=None) -> List[int]:
        """Indices into the keyframe store; -1 denotes the current frame.
        ``selection`` / ``rng`` default to this mapper's policy and stream;
        the fused coarse term passes ('global', rng_coarse)."""
        kf = self.keyframes
        selection = self.selection if selection is None else selection
        rng = self.rng if rng is None else rng
        if len(kf) <= 1:
            # no candidates besides the always-included last keyframe; the
            # overlap scorer is skipped, so the pose is not read
            frames: List[int] = []
        else:
            num = self.cfg.window_size - 2
            if selection == "global":
                frames = random_select(len(kf) - 1, num, rng)
            else:
                kf.sync_host_poses()  # device BA may have updated poses
                frames = keyframe_selection_overlap(
                    host_array(gt_color, MAP_HOST), host_array(gt_depth, MAP_HOST),
                    host_array(cur_c2w, MAP_HOST),
                    kf.frames[:-1], num, self.cam, rng=rng,
                )
        if len(kf) > 0:
            frames = frames + [len(kf) - 1]
        return [int(f) for f in frames] + [-1]

    def _assemble_window(self, frames: List[int], cur_color_dev, cur_depth_dev, cur_c2w,
                         need_cams: bool = True):
        """Window images from the keyframe device cache (the current frame
        from the caller's upload), estimated c2w matrices and, when
        ``need_cams``, their quaternion + translation tensors. A device
        ``cur_c2w`` is spliced into the current-frame slots on the device,
        so the pose is not read back."""
        col_list, dep_list = [], []
        for f in frames:
            if f == -1:
                col_list.append(cur_color_dev)
                dep_list.append(cur_depth_dev)
            else:
                c, d = self.keyframes.device_images(f)
                col_list.append(c)
                dep_list.append(d)
        colors = torch.stack(col_list)
        depths = torch.stack(dep_list)
        cur_is_dev = isinstance(cur_c2w, torch.Tensor)
        cams = None
        if self.keyframes.host_poses_stale and cur_is_dev and not need_cams:
            # device BA updated the pose stack: take the window's rows there
            _, _, poses_dev = self.keyframes.device_stack()
            fixed = torch.stack([poses_dev[0 if f == -1 else f] for f in frames])
        else:
            self.keyframes.sync_host_poses()
            kf_rows = np.stack([
                np.eye(4, dtype=np.float32) if (f == -1 and cur_is_dev)
                else (host_array(cur_c2w, MAP_HOST) if f == -1
                      else self.keyframes.frames[f]["est_c2w"])
                for f in frames
            ]).astype(np.float32)
            fixed = to_device(kf_rows, self.device)
            if need_cams:
                cams = to_device(np.stack([tensor_from_pose_matrix_np(m[:3]) for m in kf_rows])
                                 .astype(np.float32), self.device)
        if cams is None:
            cams = self._zeros(len(frames), 7)
        if cur_is_dev:
            # the device pose (and its 7-vector) into the current-frame slots
            cur4 = cur_c2w.to(self.device, torch.float32)
            fixed = fixed.clone()
            if need_cams:
                cams = cams.clone()
                cur_cam = tensor_from_pose_matrix(cur4[:3])
            for slot, f in enumerate(frames):
                if f == -1:
                    fixed[slot] = cur4
                    if need_cams:
                        cams[slot] = cur_cam
        return colors, depths, fixed, cams

    # -- main entry ---------------------------------------------------------

    def optimize_map(
        self,
        num_joint_iters: int,
        lr_factor: float,
        idx: int,
        cur_gt_color,
        cur_gt_depth,
        cur_gt_event,
        cur_c2w,
        pre_gt_color=None,
        color_refine: bool = False,
        seed: int = 0,
        grids=None,
        decoders=None,
        cur_images_dev=None,
        vis_callback=None,
        vis_inside_freq: int = 0,
    ):
        """One mapping call. Returns (grids, decoders, new_cur_c2w or None).

        ``cur_c2w`` as a numpy array takes the host path: host selection
        (which may shrink the window), the numpy frustum mask, the host BA
        write-back. As a device tensor with overlap selection and more than
        one keyframe it takes the device path: selection, assembly, frustum
        masks and BA write-back on the device, nothing read back to the
        host, ``last_loss`` a device tensor.

        ``vis_callback(global_iter, grids, decoders, cam_tensors)`` with
        ``vis_inside_freq`` > 0 splits the call into chunks of that many
        iterations and fires before each; the chunked call is bitwise equal
        to the unchunked one."""
        with TRACER.span("slam.map"):
            return self._optimize_map(
                num_joint_iters, lr_factor, idx, cur_gt_color, cur_gt_depth, cur_gt_event,
                cur_c2w, pre_gt_color, color_refine, seed, grids, decoders, cur_images_dev,
                vis_callback, vis_inside_freq)

    def _optimize_map(self, num_joint_iters, lr_factor, idx, cur_gt_color, cur_gt_depth,
                      cur_gt_event, cur_c2w, pre_gt_color, color_refine, seed, grids, decoders,
                      cur_images_dev, vis_callback, vis_inside_freq):
        with TRACER.span("slam.map.window"):
            cfg = self.cfg
            dev = self.device
            pose_is_dev = isinstance(cur_c2w, torch.Tensor)
            if cur_images_dev is not None:
                cur_color_dev, cur_depth_dev = cur_images_dev
            else:
                cur_color_dev = to_device(host_array(cur_gt_color, MAP_HOST), dev)
                cur_depth_dev = to_device(host_array(cur_gt_depth, MAP_HOST), dev)

            dev_select = (
                pose_is_dev
                and self.selection == "overlap"
                and len(self.keyframes) > 1
                and not cfg.save_selected_keyframes_info
            )
            ba = self.BA_active and not self.coarse_mapper
            window = window_idx_dev = None
            if dev_select:
                K = min(cfg.window_size, len(self.keyframes) + 1)
                kf_cols, kf_deps, kf_poses = self.keyframes.device_stack()
                sel_idx, sel_pri = self._selection_draws(seed, len(self.keyframes))
                (colors, depths, fixed_c2w, cam_tensors, window_idx_dev,
                 opt_mask) = select_assemble_window(
                    kf_cols, kf_deps, kf_poses, cur_color_dev, cur_depth_dev,
                    cur_c2w.to(dev, torch.float32), K - 2, self.cam,
                    pixel_idx=sel_idx, priorities=sel_pri,
                )
            else:
                window = self.select_window(cur_gt_color, cur_gt_depth, cur_c2w)
                K = len(window)
                # cam tensors are only read under BA
                colors, depths, fixed_c2w, cam_tensors = self._assemble_window(
                    window, cur_color_dev, cur_depth_dev, cur_c2w, need_cams=ba)
            pix_per_img = cfg.pixels // K
            self.last_window_size = K

            if cfg.save_selected_keyframes_info:
                info = []
                for f in window:
                    if f == -1:
                        info.append({"idx": idx, "est_c2w": host_array(cur_c2w, MAP_HOST).copy()})
                    else:
                        kf = self.keyframes.frames[f]
                        info.append({"idx": kf["idx"], "est_c2w": kf["est_c2w"].copy(),
                                     "gt_c2w": kf["gt_c2w"].copy()})
                self.selected_keyframes[idx] = info

            # the fused coarse term: its own globally random window
            nice = self.settings.nice
            fuse_coarse = bool(self.fuse_coarse and nice and not self.coarse_mapper
                               and not color_refine)
            colors_c = depths_c = fixed_c2w_c = None
            pix_per_img_c = 0
            if fuse_coarse:
                c_frames = self.select_window(None, None, None, selection="global",
                                              rng=self.rng_coarse)
                pix_per_img_c = cfg.pixels // len(c_frames)
                if c_frames == window:
                    colors_c, depths_c, fixed_c2w_c = colors, depths, fixed_c2w
                else:
                    colors_c, depths_c, fixed_c2w_c, _ = self._assemble_window(
                        c_frames, cur_color_dev, cur_depth_dev, cur_c2w, need_cams=False)

            assert not (ba and pose_is_dev and not dev_select), (
                "BA with a device pose needs the device selection / write-back path "
                "(overlap selection); host-path BA must receive a numpy pose"
            )
            # the oldest KEYFRAME anchors the gauge; the current frame's pose is
            # optimised (dev_select computed opt_mask on the device)
            if not dev_select:
                kf_only = [f for f in window if f != -1]
                oldest = min(kf_only) if kf_only else -1
                opt_mask = to_device(
                    np.array([0.0 if f == oldest else 1.0 for f in window], np.float32), dev)

            stages, seg = stage_schedule(num_joint_iters, cfg, self.coarse_mapper, color_refine,
                                         nice)
            spans = {}
            acc = 0
            for s in stages:
                spans[s] = (acc, acc + seg[s])
                acc += seg[s]
            total_iters = acc

            # frustum masks
            use_frustum = cfg.frustum_feature_selection and nice and not color_refine
            grid_masks: Dict[str, torch.Tensor] = {}
            if grids is not None:
                masked = [lvl for lvl in grids if use_frustum and lvl != "coarse"]
                if masked and pose_is_dev:
                    ms = frustum_feature_masks(
                        cur_c2w, [tuple(grids[lvl].shape[:3]) for lvl in masked],
                        cur_depth_dev, self.bound, self.cam)
                    grid_masks.update(zip(masked, ms))
                else:
                    for lvl in masked:
                        m = frustum_feature_mask(host_array(cur_c2w, MAP_HOST),
                                                 tuple(grids[lvl].shape[:3]),
                                                 host_array(cur_gt_depth, MAP_HOST),
                                                 self.bound_np, self.cam)
                        grid_masks[lvl] = to_device(m[..., None].astype(np.float32), dev)
                for lvl, g in grids.items():
                    if lvl not in grid_masks:
                        grid_masks[lvl] = self._ones_mask(g.shape[:3])

            # event inputs
            use_events = cfg.use_events and not self.coarse_mapper and idx != 0
            lo_h, lo_w = self.lo_hw
            if use_events and pre_gt_color is not None:
                prev_fn = resize_nearest if cfg.prev_resize == "nearest" else resize_bilinear
                prev_color_lo = prev_fn(_as_tensor(pre_gt_color, dev), self.lo_hw)
                gt_event_lo = resize_nearest(_as_tensor(cur_gt_event, dev), self.lo_hw)
                gt_depth_lo_flat = resize_bilinear(cur_depth_dev, self.lo_hw).reshape(-1)
                balancer = float(np.float32((pix_per_img * K) / (lo_w * lo_h) / 100.0))
            else:
                use_events = False
                prev_color_lo = gt_event_lo = gt_depth_lo_flat = None
                balancer = 0.0

            # the pixel draws of the whole call, one randint per stage and term
            draws = {s: self._draw_pixels(seed, s, 0, seg[s], K, pix_per_img) for s in stages}
            draws_c = ({s: self._draw_pixels(seed, s, 1, seg[s], len(c_frames), pix_per_img_c)
                        for s in stages} if fuse_coarse else None)
            reg = None
            if not self.settings.occupancy:
                reg = {s: self._draw_regulation(seed, s, seg[s], K * pix_per_img) for s in stages}

        new_grids, new_decoders, new_cams = grids, decoders, cam_tensors
        adam = adam_ev = None
        loss = None
        if vis_callback is not None and vis_inside_freq > 0:
            chunks = [(a, min(a + vis_inside_freq, total_iters))
                      for a in range(0, total_iters, vis_inside_freq)]
        else:
            chunks = [(0, total_iters)]
        for ci, (a, b) in enumerate(chunks):
            if vis_callback is not None and vis_inside_freq > 0:
                vis_callback(a, new_grids, new_decoders, new_cams)
            seg_lens = {s: max(0, min(b, spans[s][1]) - max(a, spans[s][0])) for s in stages}
            seg_starts = {s: max(0, min(a, spans[s][1]) - spans[s][0]) for s in stages}

            def chunk(d):
                return None if d is None else {
                    s: d[s][seg_starts[s]: seg_starts[s] + seg_lens[s]] for s in stages}

            (new_grids, new_decoders, new_cams, adam, adam_ev, loss, _) = map_frame(
                new_grids, new_decoders, new_cams, adam, adam_ev, fixed_c2w, opt_mask,
                colors, depths, grid_masks, self.bound, chunk(draws), seg_lens, lr_factor,
                prev_color_lo, gt_event_lo, gt_depth_lo_flat, self.eventnet, balancer,
                colors_c, depths_c, fixed_c2w_c, chunk(draws_c), cfg, self.cam,
                self.settings, ba, self.coarse_mapper, use_frustum, stages, use_events,
                color_refine, fuse_coarse, init_adam=(ci == 0), device=dev,
                seg_starts=seg_starts, reg_draws=chunk(reg), dp=self.dp,
            )
        # a device scalar: reading it here would wait for the whole call
        self.last_loss = loss

        new_cur_c2w = None
        if ba and dev_select:
            with TRACER.span("slam.map.writeback"):
                _, _, kf_poses = self.keyframes.device_stack()
                new_poses, new_cur_c2w = scatter_window_poses(
                    kf_poses, window_idx_dev, new_cams, fixed_c2w, opt_mask)
                self.keyframes.set_poses_device(new_poses)
        elif ba:
            with TRACER.span("slam.sync.ba_writeback"):
                cams_np = new_cams.cpu().numpy()
            for slot, f in enumerate(window):
                if f == oldest:
                    continue
                m = np.eye(4, dtype=np.float32)
                m[:3] = pose_matrix_from_tensor_np(cams_np[slot])
                if f == -1:
                    new_cur_c2w = m
                else:
                    self.keyframes.set_pose(f, m)
        return new_grids, new_decoders, new_cur_c2w

    def maybe_add_keyframe(self, idx, n_img, gt_color, gt_depth, gt_event, cur_c2w, gt_c2w,
                           device_images=None):
        """Append every keyframe_every frames or at the second-to-last frame;
        with ``mapping.keyframe_catchup`` also whenever a full keyframe_every
        window has passed without one."""
        due = idx % self.cfg.keyframe_every == 0 or idx == n_img - 2
        if not due and self.cfg.keyframe_catchup and self.keyframes.indices:
            due = idx - max(self.keyframes.indices) >= self.cfg.keyframe_every
        if due and idx not in self.keyframes.indices:
            self.keyframes.append(idx, gt_color, gt_depth, gt_event, cur_c2w, gt_c2w,
                                  device_images=device_images)

    def update_ba_state(self):
        self.BA_active = len(self.keyframes) > 4 and self.cfg.BA and not self.coarse_mapper


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return to_device(np.asarray(x, np.float32), device)
