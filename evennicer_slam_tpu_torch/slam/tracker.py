"""Tracker: per-frame camera-pose optimisation (counterpart of
``evennicer_slam_tpu/slam/tracker.py``).

``tracking_loss`` is everything one iteration computes for a given camera
pose (the JAX package's ``_tracking_loss``; its ``dp`` splits every ray
batch over device slots, ``render/renderer.py::render_rays_dp``);
``track_frame`` is the optimisation around it (the JAX package's
``track_frame_jit``): pose initialisation by constant-speed extrapolation,
``cfg.iters`` Adam steps on the pose with autograd through the whole score,
best-pose selection, and the event-bias probe. It runs as an eager loop that
never reads a value back to the host: selection and the loss history stay on
the device. ``Tracker`` is the host-side front end: motion model, event
integration across the RGB-D window, the handoff of the event integral to
the mapper, the bias calibration state.

Semantics:
- constant-speed motion extrapolation for the pose initialisation,
- pose as a 7-vector [quat, t],
- RGB-D loss = sum |d_gt - d| / sqrt(var + 1e-10) over rays passing the
  dynamic-handling mask (err < 10 * median, d_gt > 0) plus w_color * L1
  color; rays whose depth exits the scene bound are *masked* rather than
  dropped (fixed shapes),
- event loss = L2 of (accumulated GT events - predicted events) at 0.15
  scale with a Gaussian-blur pyramid, scaled by ``balancer``,
- the event loss enters the total only when ``activate_events`` says so; it
  is always computed and reported,
- both losses feed ONE Adam step; optional ``seperate_LR`` gives the
  quaternion 0.2x the translation rate,
- best pose = argmin of the per-iteration criterion loss, where the stored
  tensor is the post-step value paired with the pre-step loss; the criterion
  is the event loss when the event branch runs (unless
  ``best_pose_criterion == "rgbd"`` on an RGB-D frame), else the RGB-D loss.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.core.bounds import inside_bound_mask
from evennicer_slam_tpu_torch.core.quaternion import (
    pose_matrix_from_tensor,
    tensor_from_pose_matrix,
)
from evennicer_slam_tpu_torch.core.rays import get_rays_rescale, get_samples
from evennicer_slam_tpu_torch.models.decoders import (
    pack_decoders_for_tracking,
    pack_grids_for_tracking,
)
from evennicer_slam_tpu_torch.models.eventnet import inference_event
from evennicer_slam_tpu_torch.ops.gaussian_blur import gaussian_blur
from evennicer_slam_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from evennicer_slam_tpu_torch.parallel.sharding import replicate
from evennicer_slam_tpu_torch.render.renderer import RenderSettings, render_rays_dp
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.optim import adam_init, adam_update
from evennicer_slam_tpu_torch.utils.runtime import require_on, resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER


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
    """Same fields as the JAX package's ``TrackerConfig``."""

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
    dp=None,
    replicas=None,
):
    """One iteration's losses as a function of the camera tensor
    ``[quat, t]``: returns (total, aux) with ``aux`` holding ``rgbd`` (on
    RGB-D frames) and ``event``, ``event_corr``, ``event_gt_energy``,
    ``mask`` (when the event branch runs).

    The RGB-D pixels are drawn from ``generator`` unless ``pixel_ij`` hands
    the (i, j) draws in. ``device=None`` means the CUDA device; the tensors
    must lie on the device the call runs on. ``dp`` (a list of device slots,
    or None) renders every ray batch split over the slots, from
    ``replicas`` (the map on each slot) when given; the losses are computed
    on ``device`` from the gathered outputs, as at dp = 1."""
    device = resolve_device(device)
    require_on(device, cam_tensor, bound)
    c2w = pose_matrix_from_tensor(cam_tensor)
    aux: Dict[str, torch.Tensor] = {}
    total = cam_tensor.new_zeros(())

    if rgbd:
        with TRACER.span("slam.track.rgbd"):
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

            depth, var, color = render_rays_dp(
                decoders, grids, rays_o, rays_d, bound, "color", settings,
                gt_depth=b_depth, dp=dp, replicas=replicas,
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
        with TRACER.span("slam.track.event"):
            lo_h, lo_w = prev_color_lo.shape[:2]
            rays_o, rays_d = get_rays_rescale(
                cam.H, cam.W, lo_h, lo_w, cam.fx, cam.fy, cam.cx, cam.cy, c2w
            )
            _, _, cur_color_lo = render_rays_dp(
                decoders, grids, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
                bound, "color", settings, gt_depth=gt_depth_lo_flat, dp=dp, replicas=replicas,
            )
            cur_color_lo = cur_color_lo.reshape(lo_h, lo_w, 3)
            if cfg.predictor == "esim":
                ev, mp = esim_predict(prev_color_lo, cur_color_lo, cfg.esim_gain)
                pred_event, mask_pred = ev, mp[None]
            else:
                pred_event, mask_pred = inference_event(
                    eventnet, prev_color_lo, cur_color_lo
                )
            with TRACER.span("slam.track.event.loss"):
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


PixelDraws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def initial_pose_tensor(
    pre_c2w: torch.Tensor,
    pre_pre_c2w: torch.Tensor,
    const_speed: bool,
) -> torch.Tensor:
    """Constant-speed pose extrapolation, on the device: the last motion
    ``pre @ inv(pre_pre)`` applied once more. Returns the 7-vector."""
    if const_speed:
        # inv_ex: no error check, so no read-back to the host
        delta = pre_c2w @ torch.linalg.inv_ex(pre_pre_c2w).inverse
        est_c2w = delta @ pre_c2w
    else:
        est_c2w = pre_c2w
    return tensor_from_pose_matrix(est_c2w[:3])


def _optimise_pose(loss_fn, start, lr_vec, iters, criterion, draws, keep_history):
    """``iters`` Adam steps on the 7-vector from ``start``. Returns the best
    tensor — the POST-step tensor of the iteration whose PRE-step criterion
    loss was lowest, the start if none was finite — and the per-iteration
    ``aux`` entries, stacked. Nothing is read back to the host."""
    cam_t = start
    adam_state = adam_init(cam_t)
    best_loss = torch.full((), float("inf"), device=start.device)
    best_cam = start
    history: Dict[str, list] = {}
    for it in range(iters):
        with TRACER.span("slam.track.iter"):
            with TRACER.span("slam.track.iter.loss"):
                x = cam_t.detach().requires_grad_()
                total, aux = loss_fn(x, None if draws is None else draws[it])
            with TRACER.span("slam.track.iter.grad"):
                if total.requires_grad:
                    (g,) = torch.autograd.grad(total, x)
                else:  # neither loss enters the total: nothing to follow
                    g = torch.zeros_like(cam_t)
            with TRACER.span("slam.track.iter.step"):
                new_cam, adam_state = adam_update(g, adam_state, cam_t, lr_vec)
                crit = aux[criterion].detach()
                better = crit < best_loss
                best_loss = torch.where(better, crit, best_loss)
                best_cam = torch.where(better, new_cam, best_cam)
                if keep_history:
                    for k, v in aux.items():
                        history.setdefault(k, []).append(v.detach())
            cam_t = new_cam
    return best_cam, {k: torch.stack(v) for k, v in history.items()}


def track_frame(
    pre_c2w: torch.Tensor,
    pre_pre_c2w: torch.Tensor,
    decoders,
    grids,
    eventnet,
    bound: torch.Tensor,
    generator: Optional[torch.Generator],
    gt_color: torch.Tensor,
    gt_depth: torch.Tensor,
    gt_event_lo: torch.Tensor,
    prev_color_lo: torch.Tensor,
    gt_depth_lo_flat: torch.Tensor,
    gt_mask_lo: torch.Tensor,
    bias_in: torch.Tensor,
    bias_scale,
    cfg: TrackerConfig,
    cam: Camera,
    settings: RenderSettings,
    rgbd: bool,
    event: bool,
    const_speed: bool,
    calibrate: bool = False,
    pixel_draws: Optional[PixelDraws] = None,
    device=None,
    dp=None,
):
    """Full per-frame tracking: pose init by constant-speed extrapolation
    followed by ``cfg.iters`` Adam steps, all on the device; the host reads
    nothing back, so the call returns while the device still works.

    The RGB-D pixels of every iteration are drawn from ``generator``, unless
    ``pixel_draws`` hands them in (one ``(i, j)`` pair per iteration). The
    probe below is event-only and draws none.

    ``calibrate`` (RGB-D-anchored frames, event.bias_correction): after the
    anchored pose is selected, an event-only probe optimisation from it, with
    a fresh Adam state, measures the event basin's offset; on event-only
    frames the caller passes the measured bias (zeros until one exists) and
    ``bias_in * bias_scale`` is subtracted from the winning pose tensor.

    ``dp`` (device slots, or None) splits every render's rays over the
    slots; the frozen map reaches each slot once a frame.

    ``device=None`` means the CUDA device. Returns (best_cam_tensor,
    best_c2w [4, 4], per-iteration loss dict, bias_out [7])."""
    device = resolve_device(device)
    require_on(device, pre_c2w, pre_pre_c2w, bound)
    with TRACER.span("slam.track.pack"):
        with torch.no_grad():
            init_cam_tensor = initial_pose_tensor(pre_c2w, pre_pre_c2w, const_speed)
        dev = init_cam_tensor.device
        if cfg.separate_lr:
            lr_vec = torch.cat([torch.full((4,), cfg.lr * 0.2, device=dev),
                                torch.full((3,), cfg.lr, device=dev)])
        else:
            lr_vec = torch.full((7,), cfg.lr, device=dev)

        if settings.fused_decode and settings.nice:
            # pack the frozen map snapshot once: every iteration's decode then
            # needs a single gather per grid family, and the decode kernels find
            # the trio's weights packed
            if "fc_packed" not in grids:
                grids = pack_grids_for_tracking(grids)
            grids = pack_decoders_for_tracking(decoders, grids)
        replicas = None if dp is None else [replicate((decoders, grids, bound), d) for d in dp]

    def loss_fn(cfg_, rgbd_):
        def fn(x, pixel_ij):
            return tracking_loss(
                x, decoders, grids, eventnet, bound, gt_color, gt_depth,
                gt_event_lo, prev_color_lo, gt_depth_lo_flat, gt_mask_lo,
                cfg_, cam, settings, rgbd_, event,
                generator=generator, pixel_ij=pixel_ij, device=device,
                dp=dp, replicas=replicas)
        return fn

    # criterion: event loss when the event branch runs (it is always
    # available), else the RGB-D loss. best_pose_criterion="rgbd" overrides
    # on RGB-D frames.
    by_event = event and (cfg.best_pose_criterion == "event" or not rgbd)
    best_cam, losses = _optimise_pose(
        loss_fn(cfg, rgbd), init_cam_tensor, lr_vec, cfg.iters,
        "event" if by_event else "rgbd", pixel_draws, keep_history=True)

    bias_out = torch.zeros((7,), dtype=torch.float32, device=dev)
    if calibrate and event:
        # event-only probe from the anchored pose: where does the event
        # basin pull a pose that RGB-D says is right? That offset is the
        # systematic bias to subtract on event-only frames.
        ev_best, _ = _optimise_pose(
            loss_fn(cfg._replace(activate_events=True), False), best_cam, lr_vec,
            cfg.iters, "event", None, keep_history=False)
        bias_out = ev_best - best_cam

    with TRACER.span("slam.track.pose"):
        if event:
            best_cam = best_cam - bias_in * bias_scale
        best_c2w = torch.cat(
            [pose_matrix_from_tensor(best_cam), torch.eye(4, device=dev)[3:4]], dim=0)
    return best_cam, best_c2w, losses, bias_out


def _prep_event_inputs(gt_event_integrate, gt_event, pre_gt_color, gt_depth,
                       lo_hw, prev_resize="nearest"):
    """Per-frame event preprocessing (integration + resizes). The existence
    mask is the CURRENT frame's (any polarity nonzero), nearest-resized. The
    previous colour goes through the same NEAREST transform by default;
    ``event.prev_resize: bilinear`` opts into the antialiased variant. The
    depth rescale is always bilinear, matching ``render_img_rescale``."""
    acc = gt_event_integrate + gt_event
    gt_event_lo = resize_nearest(acc, lo_hw)
    prev_fn = resize_nearest if prev_resize == "nearest" else resize_bilinear
    prev_color_lo = prev_fn(pre_gt_color, lo_hw)
    gt_depth_lo_flat = resize_bilinear(gt_depth, lo_hw).reshape(-1)
    mask = (gt_event != 0).any(dim=-1).to(torch.float32)
    gt_mask_lo = resize_nearest(mask, lo_hw)
    return acc, gt_event_lo, prev_color_lo, gt_depth_lo_flat, gt_mask_lo


class Tracker:
    """Host-side front end of tracking: motion model, event integration, frame
    loop bookkeeping. All math happens in :func:`track_frame`.
    ``device=None`` means the CUDA device; ``dp`` (device slots, or None)
    splits the rays of every render over the slots."""

    def __init__(
        self,
        cfg: TrackerConfig,
        cam: Camera,
        settings: RenderSettings,
        bound: np.ndarray,
        eventnet: Optional[Dict] = None,
        device=None,
        dp=None,
    ):
        self.device = resolve_device(device)
        self.dp = dp
        self.cfg = cfg
        self.cam = cam
        self.settings = settings
        self.bound = torch.as_tensor(
            np.asarray(bound), dtype=torch.float32).to(self.device)
        self.eventnet = eventnet if eventnet is not None else {}
        lo_h = int(cam.H * cfg.scale_factor)
        lo_w = int(cam.W * cfg.scale_factor)
        self.lo_hw = (lo_h, lo_w)
        self.pre_gt_color: Optional[torch.Tensor] = None
        self.gt_event_integrate: Optional[torch.Tensor] = None
        self.handoff_event_integrate: Optional[torch.Tensor] = None
        self.handoff_idx: int = -1
        self.last_losses: Dict[str, torch.Tensor] = {}
        # event-bias self-calibration state (device 7-vector, see
        # TrackerConfig.bias_correction)
        self.event_bias: Optional[torch.Tensor] = None

    def consume_event_handoff(self, idx: int) -> Optional[torch.Tensor]:
        """The event integral handed off at window boundary ``idx``, or None
        if none/stale (an out-of-cadence mapping call must re-integrate its
        own window rather than reuse an older boundary's integral). Consuming
        clears the handoff so it can never be read twice."""
        if self.handoff_event_integrate is None or self.handoff_idx != idx:
            return None
        out = self.handoff_event_integrate
        self.handoff_event_integrate = None
        return out

    def reset_event_integration(self, shape):
        self.gt_event_integrate = torch.zeros(
            tuple(shape), dtype=torch.float32, device=self.device)

    def _on_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return a.to(self.device, torch.float32)

    def track(
        self,
        idx: int,
        gt_color: torch.Tensor,
        gt_depth: torch.Tensor,
        gt_event: torch.Tensor,
        pre_c2w,
        pre_pre_c2w,
        decoders,
        grids,
        seed: int = 0,
        pixel_draws: Optional[PixelDraws] = None,
    ) -> torch.Tensor:
        """Track one frame; returns the refined 4x4 c2w as a tensor on the
        device. The call does not synchronise: pose init, optimisation and
        best-pose selection are queued on the device and nothing here waits
        for their results. ``seed`` seeds the frame's pixel draws, unless
        ``pixel_draws`` hands them in."""
        with TRACER.span("slam.track"):
            return self._track(idx, gt_color, gt_depth, gt_event, pre_c2w, pre_pre_c2w,
                               decoders, grids, seed, pixel_draws)

    def _track(self, idx, gt_color, gt_depth, gt_event, pre_c2w, pre_pre_c2w, decoders,
               grids, seed, pixel_draws):
        cfg = self.cfg
        event = cfg.use_events
        rgbd = (not event) or (idx % cfg.rgbd_every_frame == 0)
        dev = self.device

        with TRACER.span("slam.track.inputs"):
            if event:
                if self.gt_event_integrate is None:
                    self.gt_event_integrate = torch.zeros_like(gt_event)
                (self.gt_event_integrate, gt_event_lo, prev_color_lo,
                 gt_depth_lo_flat, gt_mask_lo) = _prep_event_inputs(
                    self.gt_event_integrate, gt_event, self.pre_gt_color, gt_depth,
                    self.lo_hw, self.cfg.prev_resize,
                )
            else:
                lo_h, lo_w = self.lo_hw
                gt_event_lo = torch.zeros((lo_h, lo_w, 2), device=dev)
                prev_color_lo = torch.zeros((lo_h, lo_w, 3), device=dev)
                gt_depth_lo_flat = torch.zeros((lo_h * lo_w,), device=dev)
                gt_mask_lo = torch.zeros((lo_h, lo_w), device=dev)

            const_speed = bool(self.cfg.const_speed and pre_pre_c2w is not None)
            pre_c2w = self._on_device(pre_c2w)
            pre_pre_c2w = (
                self._on_device(pre_pre_c2w) if pre_pre_c2w is not None
                else torch.eye(4, dtype=torch.float32, device=dev)
            )
            calibrate = bool(cfg.bias_correction and event and rgbd and idx > 0)
            apply_bias = bool(
                cfg.bias_correction and event and not rgbd
                and self.event_bias is not None
            )
            if apply_bias and cfg.bias_scale_mode == "window":
                scale = (idx % cfg.rgbd_every_frame) / cfg.rgbd_every_frame
            else:
                scale = 1.0
            scale *= cfg.bias_alpha
            bias_in = (
                self.event_bias if apply_bias
                else torch.zeros((7,), dtype=torch.float32, device=dev)
            )
            # draws are made on the device the frame lives on: no copy per step
            generator = torch.Generator(device=dev).manual_seed(seed)
        best_cam, c2w, losses, bias_out = track_frame(
            pre_c2w,
            pre_pre_c2w,
            decoders,
            grids,
            self.eventnet,
            self.bound,
            generator,
            gt_color,
            gt_depth,
            gt_event_lo,
            prev_color_lo,
            gt_depth_lo_flat,
            gt_mask_lo,
            bias_in,
            scale,
            cfg,
            self.cam,
            self.settings,
            rgbd,
            event,
            const_speed,
            calibrate,
            pixel_draws=pixel_draws,
            device=dev,
            dp=self.dp,
        )
        self.last_losses = losses
        if calibrate:
            if cfg.bias_ema > 0 and self.event_bias is not None:
                self.event_bias = (
                    cfg.bias_ema * self.event_bias
                    + (1.0 - cfg.bias_ema) * bias_out
                )
            else:
                self.event_bias = bias_out
        return c2w

    def end_of_window(self, idx: int, gt_color: torch.Tensor, every_frame: int):
        """At RGB-D boundaries, snapshot prev color + hand the event integral
        to the mapper, then reset it. The handoff stays on the device — it
        is only ever consumed there."""
        if idx % every_frame == 0:
            self.pre_gt_color = gt_color
            if self.gt_event_integrate is not None:
                self.handoff_event_integrate = self.gt_event_integrate
                self.handoff_idx = idx
                self.gt_event_integrate = torch.zeros_like(self.gt_event_integrate)
