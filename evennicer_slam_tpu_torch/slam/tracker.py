"""Tracker, forward half: everything one tracking iteration computes for a
given camera pose (counterpart of ``evennicer_slam_tpu/slam/tracker.py``).

Ported: ``TrackerConfig``, ``esim_predict``, ``masked_median``,
``event_pyramid_loss`` and ``tracking_loss`` (the JAX package's
``_tracking_loss`` without its device-mesh argument). Not ported yet: the
pose optimisation around it (``track_frame_jit``: autograd through this
path, Adam, best-pose selection), ``initial_pose_tensor``, the per-frame
event preprocessing and the ``Tracker`` class.

Semantics:
- pose as a 7-vector [quat, t],
- RGB-D loss = sum |d_gt - d| / sqrt(var + 1e-10) over rays passing the
  dynamic-handling mask (err < 10 * median, d_gt > 0) plus w_color * L1
  color; rays whose depth exits the scene bound are *masked* rather than
  dropped (fixed shapes),
- event loss = L2 of (accumulated GT events - predicted events) at 0.15
  scale with a Gaussian-blur pyramid, scaled by ``balancer``,
- the event loss enters the total only when ``activate_events`` says so; it
  is always computed and reported.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from evennicer_slam_tpu_torch.core.bounds import inside_bound_mask
from evennicer_slam_tpu_torch.core.quaternion import pose_matrix_from_tensor
from evennicer_slam_tpu_torch.core.rays import get_rays_rescale, get_samples
from evennicer_slam_tpu_torch.models.eventnet import inference_event
from evennicer_slam_tpu_torch.ops.gaussian_blur import gaussian_blur
from evennicer_slam_tpu_torch.render.renderer import RenderSettings, render_rays
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.runtime import require_on, resolve_device


def _check_activate_events(value):
    """true | false | 'non_rgbd'; anything else (e.g. a typo'd string,
    which would silently fall into the truthy always-on branch) raises."""
    if value in (True, False, 0, 1, "non_rgbd"):
        return bool(value) if value in (0, 1) else value
    raise ValueError(
        f"event.activate_events must be true, false, or 'non_rgbd'; "
        f"got {value!r}"
    )


def _check_predictor(value: str) -> str:
    if value not in ("unet", "esim"):
        raise ValueError(
            f"event.predictor must be 'unet' or 'esim'; got {value!r}"
        )
    return value


def _check_prev_resize(value: str) -> str:
    if value not in ("nearest", "bilinear"):
        raise ValueError(
            f"event.prev_resize must be 'nearest' or 'bilinear'; got {value!r}"
        )
    return value


class TrackerConfig(NamedTuple):
    """Same fields as the JAX package's ``TrackerConfig``; the ones that
    steer the pose optimisation are carried for the next slice."""

    pixels: int = 200
    iters: int = 10
    lr: float = 1e-3
    separate_lr: bool = False
    w_color_loss: float = 0.5
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    handle_dynamic: bool = True
    use_color: bool = True
    const_speed: bool = True
    gt_camera: bool = False
    rgbd_every_frame: int = 1
    use_events: bool = False
    # True: event loss optimized on every frame; False: never optimized (still
    # computed for logging/selection); "non_rgbd": optimized only on frames
    # WITHOUT an RGB-D loss
    activate_events: object = True
    balancer: float = 0.025
    scale_factor: float = 0.15
    blur: bool = True
    kernel_sizes: Tuple[int, ...] = (9,)
    unblurred_weight: float = 0.0
    kernel_weights: Tuple[float, ...] = (1.0,)
    best_pose_criterion: str = "event"
    bias_correction: bool = False
    bias_scale_mode: str = "constant"
    bias_ema: float = 0.0
    bias_alpha: float = 1.0
    # event predictor: "unet" = the 2-head EventNet; "esim" = the analytic
    # model gain*(I2_render - I1_gt) split by polarity
    predictor: str = "unet"
    esim_gain: float = 20.0
    prev_resize: str = "nearest"

    @staticmethod
    def from_cfg(cfg: Dict[str, Any], use_events: bool) -> "TrackerConfig":
        t = cfg["tracking"]
        e = cfg.get("event", {})
        return TrackerConfig(
            pixels=t["pixels"],
            iters=t["iters"],
            lr=t["lr"],
            separate_lr=t["seperate_LR"],
            w_color_loss=t["w_color_loss"],
            ignore_edge_w=t["ignore_edge_W"],
            ignore_edge_h=t["ignore_edge_H"],
            handle_dynamic=t["handle_dynamic"],
            use_color=t["use_color_in_tracking"],
            const_speed=t["const_speed_assumption"],
            gt_camera=t["gt_camera"],
            rgbd_every_frame=e.get("rgbd_every_frame", 1),
            use_events=use_events,
            activate_events=_check_activate_events(
                e.get("activate_events", False)
            ),
            balancer=e.get("balancer", 0.025),
            scale_factor=e.get("scale_factor", 0.15),
            blur=e.get("blur", True),
            kernel_sizes=tuple(e.get("kernel_sizes", [9])),
            unblurred_weight=e.get("unblurred_weight", 0.0),
            kernel_weights=tuple(e.get("kernel_weights", [1.0])),
            best_pose_criterion=e.get("best_pose_criterion", "event"),
            bias_correction=bool(e.get("bias_correction", False)),
            bias_scale_mode=e.get("bias_scale_mode", "constant"),
            bias_ema=float(e.get("bias_ema", 0.0)),
            bias_alpha=float(e.get("bias_alpha", 1.0)),
            predictor=_check_predictor(e.get("predictor", "unet")),
            esim_gain=float(e.get("esim_gain", 20.0)),
            prev_resize=_check_prev_resize(e.get("prev_resize", "nearest")),
        )


def esim_predict(
    prev_lo: torch.Tensor, cur_lo: torch.Tensor, gain: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic ESIM-style event prediction from an intensity pair:
    counts = gain * (mean(cur) - mean(prev)) split by polarity [-,+].
    Returns (events [h,w,2], existence mask probs [h,w,2]) matching
    inference_event's contract."""
    diff = (cur_lo.mean(dim=-1) - prev_lo.mean(dim=-1)) * gain
    events = torch.stack(
        [torch.clamp(-diff, 0.0, 255.0), torch.clamp(diff, 0.0, 255.0)], dim=-1
    )
    p = (diff.abs() > 0.5).to(torch.float32)
    mask = torch.stack([1.0 - p, p], dim=-1)
    return events, mask


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch-style median (lower middle, index (n-1)//2) over masked entries,
    at a fixed shape and without a host round trip."""
    big = torch.where(mask, x, float("inf"))
    s, _ = torch.sort(big)
    n = mask.sum()
    idx = torch.clamp(n - 1, min=0) // 2
    return s.gather(0, idx.reshape(1))[0]


def event_pyramid_loss(
    gt_lo: torch.Tensor,
    pred: torch.Tensor,
    kernel_sizes: Tuple[int, ...],
    kernel_weights: Tuple[float, ...],
) -> torch.Tensor:
    """raw L2 + sum_k w_k * L2(blur_k(gt), blur_k(pred)). ``unblurred_weight``
    scales only the logged unblurred entry, not this loss."""
    loss = torch.sum((gt_lo - pred) ** 2)
    for k, w in zip(kernel_sizes, kernel_weights):
        loss = loss + w * torch.sum(
            (gaussian_blur(gt_lo, k) - gaussian_blur(pred, k)) ** 2
        )
    return loss


def tracking_loss(
    cam_tensor: torch.Tensor,
    decoders,
    grids,
    eventnet,
    bound: torch.Tensor,
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_event_lo: torch.Tensor,
    prev_color_lo: torch.Tensor,
    gt_depth_lo_flat: torch.Tensor,
    gt_mask_lo: torch.Tensor,
    cfg: TrackerConfig,
    cam: Camera,
    settings: RenderSettings,
    rgbd: bool,
    event: bool,
    generator: Optional[torch.Generator] = None,
    pixel_ij: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    device=None,
):
    """One iteration's losses as a function of the camera tensor
    ``[quat, t]``: returns (total, aux) with ``aux`` holding ``rgbd`` (on
    RGB-D frames) and ``event``, ``event_corr``, ``event_gt_energy``,
    ``mask`` (when the event branch runs).

    The RGB-D pixels are drawn from ``generator`` unless ``pixel_ij`` hands
    the (i, j) draws in. ``device=None`` means the CUDA device; the tensors
    must lie on the device the call runs on."""
    device = resolve_device(device)
    require_on(device, cam_tensor, bound)
    c2w = pose_matrix_from_tensor(cam_tensor)
    aux: Dict[str, torch.Tensor] = {}
    total = cam_tensor.new_zeros(())

    if rgbd:
        He, We = cfg.ignore_edge_h, cfg.ignore_edge_w
        rays_o, rays_d, b_depth, b_color = get_samples(
            generator, He, cam.H - He, We, cam.W - We, cfg.pixels,
            cam.fx, cam.fy, cam.cx, cam.cy, c2w, gt_depth, gt_color,
            pixel_ij=pixel_ij,
        )
        if settings.nice:
            inside = inside_bound_mask(
                rays_o.detach(), rays_d.detach(), b_depth, bound)
        else:
            inside = torch.ones_like(b_depth, dtype=torch.bool)

        depth, var, color = render_rays(
            decoders, grids, rays_o, rays_d, bound, "color", settings,
            gt_depth=b_depth,
        )
        var = var.detach()
        tmp = torch.abs(b_depth - depth) / torch.sqrt(var + 1e-10)
        if cfg.handle_dynamic:
            med = masked_median(tmp.detach(), inside)
            mask = (tmp.detach() < 10 * med) & (b_depth > 0) & inside
        else:
            mask = (b_depth > 0) & inside

        loss_rgbd = torch.sum(tmp * mask)
        if cfg.use_color:
            loss_rgbd = loss_rgbd + cfg.w_color_loss * torch.sum(
                torch.abs(b_color - color) * mask[:, None]
            )
        aux["rgbd"] = loss_rgbd
        total = total + loss_rgbd

    if event:
        lo_h, lo_w = prev_color_lo.shape[:2]
        rays_o, rays_d = get_rays_rescale(
            cam.H, cam.W, lo_h, lo_w, cam.fx, cam.fy, cam.cx, cam.cy, c2w
        )
        _, _, cur_color_lo = render_rays(
            decoders, grids, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
            bound, "color", settings, gt_depth=gt_depth_lo_flat,
        )
        cur_color_lo = cur_color_lo.reshape(lo_h, lo_w, 3)
        if cfg.predictor == "esim":
            ev, mp = esim_predict(prev_color_lo, cur_color_lo, cfg.esim_gain)
            pred_event, mask_pred = ev, mp[None]
        else:
            pred_event, mask_pred = inference_event(
                eventnet, prev_color_lo, cur_color_lo
            )
        # prediction-quality telemetry: Pearson correlation of the detached
        # prediction against the GT events, plus the GT event energy (the
        # correlation is undefined on event-free frames)
        p = pred_event.detach().reshape(-1)
        g = gt_event_lo.reshape(-1)
        pc = p - p.mean()
        gc = g - g.mean()
        aux["event_corr"] = torch.sum(pc * gc) / torch.sqrt(
            torch.sum(pc * pc) * torch.sum(gc * gc) + 1e-12
        )
        aux["event_gt_energy"] = torch.sum(g * g)
        # event-existence mask cross-entropy — computed and LOGGED but never
        # backpropagated (the CE runs on the already-sigmoided mask head, as
        # the original did)
        logsm = torch.log_softmax(mask_pred[0].detach(), dim=-1)
        aux["mask"] = -torch.mean(
            gt_mask_lo * logsm[..., 1] + (1.0 - gt_mask_lo) * logsm[..., 0]
        )
        if cfg.blur:
            loss_event = event_pyramid_loss(
                gt_event_lo, pred_event, cfg.kernel_sizes, cfg.kernel_weights
            )
        else:
            loss_event = torch.sum((gt_event_lo - pred_event) ** 2)
        loss_event = loss_event * cfg.balancer
        aux["event"] = loss_event
        if cfg.activate_events == "non_rgbd":
            if not rgbd:
                total = total + loss_event
        elif cfg.activate_events:
            total = total + loss_event

    return total, aux
