"""EventNet training: fit the 2-head UNet to ESIM-style events (counterpart
of ``evennicer_slam_tpu/models/eventnet_train.py``).

Two recipes, as in the JAX package:

- from scratch on procedurally rendered intensity pairs of the synthetic
  room (:func:`train_eventnet`): head 1 (event counts, 2 polarity channels)
  by an L2 loss against ``gain * (I2 - I1)`` split by sign, head 2 (event
  existence) by binary cross-entropy;
- map domain (:func:`train_eventnet_map_domain`): the same loss on
  (previous low-res image, render of a learned map, integrated GT events)
  triples, the tracker's own input distribution at SLAM time.

A training step differentiates **every leaf** of the parameter tree,
BatchNorm's running statistics ``m`` and ``v`` included, and Adam moves them
all: the JAX package differentiates its whole pytree, and ``_bn`` takes the
statistics as plain inputs (ROADMAP Queue 3, mirrored).

Weights are written as the JAX package's ``.npz`` (:func:`save_eventnet_npz`)
and read back by the one loader, ``models/eventnet.py::load_eventnet_npz``.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.data.synthetic import circular_trajectory, render_box_views
from evennicer_slam_tpu_torch.models.eventnet import (  # noqa: F401  (the one loader)
    eventnet_forward,
    init_eventnet,
    load_eventnet_npz,
)
from evennicer_slam_tpu_torch.ops.resize import resize_nearest
from evennicer_slam_tpu_torch.utils.logger import _flatten_tree
from evennicer_slam_tpu_torch.utils.optim import adam_init, adam_update, tree_leaves, tree_map
from evennicer_slam_tpu_torch.utils.runtime import resolve_device

DEFAULT_BOUND = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)


def _nearest_np(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    return resize_nearest(torch.from_numpy(np.ascontiguousarray(img)), hw).numpy()


def make_pair_batch(
    rng: np.random.Generator,
    batch: int,
    hw: Tuple[int, int],
    bound: np.ndarray,
    gain: float = 20.0,
    step_scale: float = 0.03,
    full_hw: Tuple[int, int] = None,
):
    """Random intensity pairs and their GT events from the synthetic room, at
    the tracker's input distribution: the previous image a NEAREST
    down-scale of the full-resolution frame, the current image point-sampled
    on the renderer's low-res ray grid, the target the nearest-downsampled
    full-resolution event image. Makes the JAX function's ``rng`` calls in
    its order, so one numpy seed gives both packages the same batch.
    Returns (img1, img2, events) float32 ``[batch, h, w, 3 | 3 | 2]``."""
    h, w = hw
    H, W = full_hw if full_hw else (4 * h, 4 * w)
    fx = fy = 0.8 * max(H, W)
    cx, cy = (W - 1) / 2, (H - 1) / 2
    # the renderer's low-res grid places rays on linspace(0, W-1, w): the
    # equivalent direct render uses scaled intrinsics
    sx = (W - 1) / (w - 1)
    sy = (H - 1) / (h - 1)
    imgs1, imgs2, events = [], [], []
    center = bound.mean(axis=1)
    traj = circular_trajectory(128, center, radius=0.25, step=step_scale,
                               jitter=0.01, jitter_seed=int(rng.integers(1 << 30)))
    for _ in range(batch):
        k = int(rng.integers(0, len(traj) - 1))
        c1_full, _ = render_box_views(traj[k], H, W, fx, fy, cx, cy, bound)
        c2_full, _ = render_box_views(traj[k + 1], H, W, fx, fy, cx, cy, bound)
        c2_lo, _ = render_box_views(
            traj[k + 1], h, w, fx / sx, fy / sy, cx / sx, cy / sy, bound
        )
        c1_lo = _nearest_np(c1_full, (h, w))
        diff_full = (c2_full.mean(-1) - c1_full.mean(-1)) * gain
        ev_full = np.stack(
            [np.clip(-diff_full, 0, 255), np.clip(diff_full, 0, 255)], -1
        )
        imgs1.append(c1_lo)
        imgs2.append(c2_lo)
        events.append(_nearest_np(ev_full, (h, w)))
    return (
        np.stack(imgs1).astype(np.float32),
        np.stack(imgs2).astype(np.float32),
        np.stack(events).astype(np.float32),
    )


def loss_fn(params: Dict[str, Any], img1: torch.Tensor, img2: torch.Tensor,
            gt_event: torch.Tensor):
    """L2 on the event head plus 0.1 x the BCE of ``mask[..., 1:2]`` (clipped
    to [1e-6, 1 - 1e-6]) against "any event here". Returns (loss, (l_ev,
    l_mask)): the JAX package's ``_loss_fn``."""
    x = torch.cat([img1, img2], dim=-1)
    events, mask = eventnet_forward(params, x)
    l_ev = torch.mean((events - gt_event) ** 2)
    exist = (torch.sum(gt_event, dim=-1, keepdim=True) > 0).to(torch.float32)
    p1 = torch.clamp(mask[..., 1:2], 1e-6, 1 - 1e-6)
    l_mask = -torch.mean(exist * torch.log(p1) + (1 - exist) * torch.log(1 - p1))
    return l_ev + 0.1 * l_mask, (l_ev, l_mask)


def loss_and_grads(params, img1, img2, gt_event):
    """(loss, gradient tree): ``torch.autograd.grad`` over every leaf of the
    tree, BatchNorm statistics included."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(live, img1, img2, gt_event)
    flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(flat), live)


def train_step(params, opt_state, img1, img2, gt_event, lr):
    """One Adam step on every leaf (the JAX package's jitted ``_train_step``).
    Returns (params, opt_state, loss); nothing is read back to the host."""
    loss, grads = loss_and_grads(params, img1, img2, gt_event)
    params = tree_map(torch.Tensor.detach, params)
    params, opt_state = adam_update(grads, opt_state, params, lr)
    return params, opt_state, loss


def _initial(init_params, generator, seed, device):
    if init_params is not None:
        return tree_map(lambda p: p.detach().to(device), init_params)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return init_eventnet(generator, device=device)


def train_eventnet(
    steps: int = 400,
    batch: int = 4,
    hw: Tuple[int, int] = (64, 96),
    lr: float = 3e-4,
    seed: int = 0,
    bound: np.ndarray = None,
    verbose: bool = False,
    device=None,
    generator: Optional[torch.Generator] = None,
    init_params: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Train from scratch on synthetic pairs; returns the parameter tree on
    ``device`` (None: the CUDA device). The initial weights come from
    ``init_params``, else from ``generator`` (default: one seeded with
    ``seed``); the batches from ``np.random.default_rng(seed)``, as in the
    JAX package."""
    device = resolve_device(device)
    if bound is None:
        bound = DEFAULT_BOUND
    rng = np.random.default_rng(seed)
    params = _initial(init_params, generator, seed, device)
    opt_state = adam_init(params)
    for step in range(steps):
        img1, img2, ev = (torch.from_numpy(a).to(device)
                          for a in make_pair_batch(rng, batch, hw, bound))
        params, opt_state, loss = train_step(params, opt_state, img1, img2, ev, lr)
        if verbose and step % 50 == 0:
            print(f"eventnet step {step}: loss {float(loss):.4f}", flush=True)
    return params


# ---------------------------------------------------------------------------
# map-domain training: the tracker's own input distribution
# ---------------------------------------------------------------------------
#
# At SLAM time the tracker feeds EventNet (previous GT colour downscaled,
# the CURRENT IMAGE RENDERED FROM THE LEARNED MAP) and compares against the
# integrated GT events since the last RGB-D frame. A net trained only on
# GT-GT pairs reads map-render artifacts (early-map blur, colour bias) as
# events; these triples are made from a real map's renders.

def _perturb_pose(c2w: np.ndarray, rng, trans: float, rot: float):
    q = c2w.copy()
    q[:3, 3] += rng.normal(scale=trans, size=3)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax) + 1e-12
    ang = rng.normal(scale=rot)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
    q[:3, :3] = q[:3, :3] @ R
    return q


def map_frames(cfg: Dict, n_map_frames: int = 20, gt_render_fn=None, device=None,
               verbose: bool = False):
    """Run ``EvenNICERSLAM`` with ``tracking.gt_camera`` (mapping only) over
    the first ``n_map_frames`` frames of the configured dataset; returns
    (pipeline, frames mapped). With ``gt_render_fn`` the frames must be
    uncropped and unscaled: it renders raw ``[H, W]`` views."""
    from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM

    cfg = copy.deepcopy(cfg)
    if gt_render_fn is not None and (
        cfg["cam"].get("crop_edge", 0) or cfg.get("scale", 1.0) != 1.0
        or cfg["cam"].get("crop_size")
    ):
        raise ValueError(
            "perturbed-pose triples assume uncropped/unscaled frames at the "
            "cam resolution (gt_render_fn renders raw [H, W])"
        )
    cfg.setdefault("tracking", {})["gt_camera"] = True
    cfg["enable_vis"] = False
    t0 = time.perf_counter()
    slam = EvenNICERSLAM(cfg, nice=True, device=device)
    n = min(n_map_frames, slam.n_img)
    slam.run(end_frame=n, mesh=False, checkpoint=False)
    if verbose:
        print(f"[map_domain_pairs] mapped {n} frames in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return slam, n


def pairs_from_map(
    slam,
    n: int,
    n_pairs: int = 64,
    max_offset: int = 5,
    seed: int = 0,
    perturb_trans: float = 0.0,
    perturb_rot: float = 0.0,
    gt_render_fn=None,
    event_gain: float = 20.0,
):
    """(prev_lo, map_render_lo, gt_event_lo) triples from the map of
    ``slam`` over its frames ``0..n-1``: for random windows (k, k + j),
    j <= ``max_offset`` (the ``rgbd_every_frame`` horizon), the current
    image rendered from the map at the GT pose, the nearest-downscaled
    previous GT image and the nearest-downscaled integral of the GT events
    over the window.

    With ``gt_render_fn(c2w) -> (color, depth)`` and ``perturb_trans/rot`` >
    0, about half the triples render at a PERTURBED pose, with the ESIM
    target between the previous frame and the GT view at that pose. Makes
    the JAX function's ``rng`` calls (seeded with ``seed``) in its order.
    Returns three float32 arrays ``[n_pairs, h, w, 3 | 3 | 2]``."""
    lo_hw = slam.tracker.lo_hw
    sf = slam.t_cfg.scale_factor
    dev = slam.device
    rng = np.random.default_rng(seed)
    frames = [slam.frame_reader[i] for i in range(n)]

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    prevs, curs, evs = [], [], []
    for _ in range(n_pairs):
        j = int(rng.integers(1, max_offset + 1))
        k = int(rng.integers(0, n - j))
        prev = frames[k]
        cur = frames[k + j]
        prev_lo = _nearest_np(prev.color, lo_hw)
        perturbed = (
            gt_render_fn is not None
            and (perturb_trans > 0 or perturb_rot > 0)
            and rng.random() < 0.5
        )
        if perturbed:
            q = _perturb_pose(cur.c2w, rng, perturb_trans, perturb_rot)
            gt_color_q, gt_depth_q = gt_render_fn(q)
            pose, gt_depth = q, gt_depth_q
            diff = (gt_color_q.mean(-1) - prev.color.mean(-1)) * event_gain
            ev = np.stack(
                [np.clip(-diff, 0, 255), np.clip(diff, 0, 255)], -1
            ).astype(np.float32)
        else:
            pose, gt_depth = cur.c2w, cur.depth
            ev = np.zeros_like(frames[0].event)
            for i in range(k + 1, k + j + 1):
                ev = ev + frames[i].event
        with torch.no_grad():
            _, _, cur_lo = slam.renderer.render_img_rescale(
                slam.decoders, slam.grids, on_dev(pose[:3]), "color",
                gt_depth=on_dev(gt_depth), scale_factor=sf,
            )
        prevs.append(prev_lo)
        curs.append(cur_lo.cpu().numpy())
        evs.append(_nearest_np(ev, lo_hw))
    return (
        np.stack(prevs).astype(np.float32),
        np.stack(curs).astype(np.float32),
        np.stack(evs).astype(np.float32),
    )


def map_domain_pairs(
    cfg: Dict,
    n_map_frames: int = 20,
    n_pairs: int = 64,
    max_offset: int = 5,
    seed: int = 0,
    perturb_trans: float = 0.0,
    perturb_rot: float = 0.0,
    gt_render_fn=None,
    event_gain: float = 20.0,
    verbose: bool = False,
    device=None,
):
    """:func:`map_frames` then :func:`pairs_from_map` on its map."""
    slam, n = map_frames(cfg, n_map_frames, gt_render_fn, device, verbose)
    return pairs_from_map(slam, n, n_pairs, max_offset, seed, perturb_trans, perturb_rot,
                          gt_render_fn, event_gain)


def train_on_triples(
    prevs: np.ndarray,
    curs: np.ndarray,
    evs: np.ndarray,
    steps: int = 300,
    batch: int = 4,
    lr: float = 3e-4,
    seed: int = 0,
    init_params: Optional[Dict[str, Any]] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    verbose: bool = False,
) -> Dict[str, Any]:
    """Adam on random batches of the triples (indices from
    ``np.random.default_rng(seed + 1)``, as in the JAX package), from
    ``init_params`` or from weights drawn with ``generator`` (default: one
    seeded with ``seed``)."""
    device = resolve_device(device)
    data = [torch.from_numpy(a).to(device) for a in (prevs, curs, evs)]
    rng = np.random.default_rng(seed + 1)
    params = _initial(init_params, generator, seed, device)
    opt_state = adam_init(params)
    t0 = time.perf_counter()
    for step in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(prevs), size=batch)).to(device)
        params, opt_state, loss = train_step(params, opt_state, *(a[idx] for a in data), lr)
        if verbose and step % 50 == 0:
            print(f"eventnet map-domain step {step}: loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return params


def train_eventnet_map_domain(
    cfg: Dict,
    steps: int = 300,
    batch: int = 4,
    lr: float = 3e-4,
    n_map_frames: int = 20,
    n_pairs: int = 96,
    seed: int = 0,
    init_params: Dict = None,
    perturb_trans: float = 0.0,
    perturb_rot: float = 0.0,
    gt_render_fn=None,
    verbose: bool = False,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """Fine-tune (or train from scratch) on map-domain triples."""
    triples = map_domain_pairs(
        cfg, n_map_frames=n_map_frames, n_pairs=n_pairs, seed=seed,
        perturb_trans=perturb_trans, perturb_rot=perturb_rot,
        gt_render_fn=gt_render_fn, verbose=verbose, device=device,
    )
    return train_on_triples(*triples, steps=steps, batch=batch, lr=lr, seed=seed,
                            init_params=init_params, generator=generator, device=device,
                            verbose=verbose)


def _is_bn_stat(key: str) -> bool:
    """BatchNorm running statistics flatten to ``....bnN.m`` / ``....bnN.v``."""
    parts = key.rsplit(".", 2)
    return len(parts) == 3 and parts[1].startswith("bn") and parts[2] in ("m", "v")


def save_eventnet_npz(params: Dict[str, Any], path: str, half: bool = True) -> None:
    """The JAX package's ``.npz`` layout (``eventnet.<block>.<leaf>``,
    ``np.savez_compressed``). ``half`` stores weights as float16 and keeps
    BatchNorm running statistics in float32 (variances can underflow f16's
    6e-5 normal floor)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten_tree(params, "eventnet", flat)
    if half:
        flat = {k: (v if (_is_bn_stat(k) or v.dtype != np.float32) else v.astype(np.float16))
                for k, v in flat.items()}
    np.savez_compressed(path, **flat)
