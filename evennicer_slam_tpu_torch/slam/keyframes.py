"""Keyframe registry, overlap-based window selection, frustum feature masks
(counterpart of ``evennicer_slam_tpu/slam/keyframes.py``).

Two halves, as in the JAX package:
- the host half (numpy): the registry's host rows, the overlap scorer and
  ``random_select``, which make the same ``np.random.Generator`` calls as the
  JAX package so that the same seed selects the same keyframes, and the host
  frustum mask;
- the device half (torch ops, no read-back to the host): the frustum masks of
  every grid level in one call, overlap selection plus window assembly, and
  the BA pose write-back of the grown-registry path.

The host frustum mask samples the depth image with the same bilinear,
zero-border rule as ``cv2.remap(INTER_LINEAR, BORDER_CONSTANT)``, in numpy:
the port does not use OpenCV. cv2 interpolates with 5-bit fixed-point
weights, so at a few voxels on the frustum's boundary the two may differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.core.quaternion import (
    pose_matrix_from_tensor,
    tensor_from_pose_matrix,
)
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.runtime import resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER


def host_array(x, site: str) -> np.ndarray:
    """A host numpy copy of an array or a tensor (a tensor on the card is
    read back, inside the span ``site``: callers use this on host paths
    only)."""
    if isinstance(x, torch.Tensor):
        with TRACER.span(site):
            return x.detach().cpu().numpy()
    return np.asarray(x)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device``. To a card the copy goes through
    pinned memory without blocking, so the host does not wait for the work
    queued before it (a plain host-to-device copy synchronises the stream)."""
    t = torch.from_numpy(np.array(a, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class KeyframeStore:
    """Append-only keyframe list.

    Images are kept on the host (selection, meshing) plus on the device: a
    per-frame upload cache that ``device_stack`` folds into one growing
    stack, so the mapping window never re-uploads its images. The device
    pose stack is the truth while device-side BA writes to it; the host
    ``est_c2w`` rows are then stale until :meth:`sync_host_poses`.
    ``device=None`` means the CUDA device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.frames: List[Dict] = []
        self._device_cache: Dict[int, tuple] = {}
        self._img_stack = None
        self._img_stack_len = 0
        self._poses_dev: Optional[torch.Tensor] = None
        self.host_poses_stale = False

    def __len__(self):
        return len(self.frames)

    @property
    def indices(self) -> List[int]:
        return [f["idx"] for f in self.frames]

    def _put(self, x) -> torch.Tensor:
        return to_device(np.asarray(x), self.device)

    def _ensure_poses_dev(self, n: int):
        """Make the device pose stack cover the first ``n`` frames, uploading
        host rows for any it does not hold yet (existing device rows are the
        truth: host copies may be stale under device-side BA)."""
        if n <= 0:
            return
        old = 0 if self._poses_dev is None else int(self._poses_dev.shape[0])
        if old >= n:
            return
        host = np.stack([f["est_c2w"] for f in self.frames[old:n]]).astype(np.float32)
        rows = self._put(host)
        self._poses_dev = rows if self._poses_dev is None else torch.cat(
            [self._poses_dev, rows], dim=0)

    def append(self, idx: int, color, depth, event, est_c2w, gt_c2w,
               device_images=None):
        est_is_dev = isinstance(est_c2w, torch.Tensor)
        rec = {
            "idx": idx,
            "color": host_array(color, "slam.sync.keyframe"),
            "depth": host_array(depth, "slam.sync.keyframe"),
            "event": host_array(event, "slam.sync.keyframe"),
            # a device pose gets its host copy lazily (sync_host_poses):
            # reading it here would wait for the program that produced it
            "est_c2w": (np.eye(4, dtype=np.float32) if est_is_dev
                        else np.asarray(est_c2w).copy()),
            "gt_c2w": host_array(gt_c2w, "slam.sync.keyframe").copy(),
        }
        if est_is_dev:
            self._ensure_poses_dev(len(self.frames))
            row = est_c2w.detach().to(self.device, torch.float32).reshape(1, 4, 4)
            self._poses_dev = row if self._poses_dev is None else torch.cat(
                [self._poses_dev, row], dim=0)
            self.host_poses_stale = True
        self.frames.append(rec)
        if device_images is not None:
            # the frame is already on the device: seed the cache with it
            self._device_cache[len(self.frames) - 1] = tuple(device_images)

    def set_pose(self, kf_index: int, est_c2w: np.ndarray):
        """Host-side BA write-back. Mixing it with pending device-side
        updates would resurrect stale host rows, hence the assertion."""
        assert not self.host_poses_stale, (
            "sync_host_poses() before host-side pose writes"
        )
        self.frames[kf_index]["est_c2w"] = np.asarray(est_c2w).copy()
        self._poses_dev = None  # rebuilt from the (fresh) host rows on next use

    def device_images(self, kf_index: int):
        """(color, depth) on the device. Frames already folded into the stack
        come back as views of it; newer frames from the upload cache."""
        if self._img_stack is not None and kf_index < self._img_stack_len:
            return self._img_stack[0][kf_index], self._img_stack[1][kf_index]
        if kf_index not in self._device_cache:
            f = self.frames[kf_index]
            self._device_cache[kf_index] = (self._put(f["color"]), self._put(f["depth"]))
        return self._device_cache[kf_index]

    def device_stack(self):
        """(colors [N,H,W,3], depths [N,H,W], poses [N,4,4]) on the device.
        The image stacks grow by the frames appended since the last call;
        folded frames leave the per-frame cache, so the stack is their one
        device copy."""
        n = len(self.frames)
        if self._img_stack_len != n:
            new = [self.device_images(i) for i in range(self._img_stack_len, n)]
            cols = [c[None] for c, _ in new]
            deps = [d[None] for _, d in new]
            if self._img_stack is not None:
                cols.insert(0, self._img_stack[0])
                deps.insert(0, self._img_stack[1])
            self._img_stack = (torch.cat(cols, dim=0), torch.cat(deps, dim=0))
            self._img_stack_len = n
            for i in list(self._device_cache):
                if i < n:
                    del self._device_cache[i]
        self._ensure_poses_dev(n)
        return self._img_stack[0], self._img_stack[1], self._poses_dev

    def set_poses_device(self, poses_dev: torch.Tensor):
        """Replace the device pose stack (device-side BA write-back); the
        host ``est_c2w`` rows are stale until :meth:`sync_host_poses`."""
        self._poses_dev = poses_dev
        self.host_poses_stale = True

    def sync_host_poses(self):
        """Refresh the host ``est_c2w`` rows from the device pose stack (one
        read-back). Call before any host consumer of keyframe poses."""
        if not self.host_poses_stale:
            return
        with TRACER.span("slam.sync.pose"):
            mats = self._poses_dev.cpu().numpy()
        # frames appended after the last device write-back are not in the
        # stack yet: their host rows are already the truth
        for i in range(min(len(self.frames), mats.shape[0])):
            self.frames[i]["est_c2w"] = mats[i].copy()
        self.host_poses_stale = False


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def _intrinsics_np(cam: Camera) -> np.ndarray:
    return np.array([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])


def _project(points: np.ndarray, w2c: np.ndarray, cam: Camera):
    """World points -> (uv [N,2], z [N], camera coordinates) with the x
    negation of the camera convention."""
    ones = np.ones((points.shape[0], 1), points.dtype)
    cam_cord = (w2c @ np.concatenate([points, ones], axis=1).T).T[:, :3]
    cam_cord = cam_cord.copy()
    cam_cord[:, 0] *= -1
    uv = (_intrinsics_np(cam) @ cam_cord.T).T
    z = uv[:, -1:] + 1e-5
    uv = uv[:, :2] / z
    return uv, z[:, 0], cam_cord


def keyframe_selection_overlap(
    gt_color: np.ndarray,
    gt_depth: np.ndarray,
    c2w: np.ndarray,
    keyframes: List[Dict],
    k: int,
    cam: Camera,
    n_samples: int = 16,
    pixels: int = 100,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    """Rank keyframes by the share of the current frame's depth-guided
    sample points inside their frusta; pick k of the nonzero-overlap ones at
    random."""
    rng = rng or np.random.default_rng()
    H, W = cam.H, cam.W
    idx = rng.integers(0, H * W, size=(pixels,))
    jj, ii = idx // W, idx % W
    depths = gt_depth[jj, ii]
    dirs = np.stack(
        [(ii - cam.cx) / cam.fx, -(jj - cam.cy) / cam.fy, -np.ones_like(ii, np.float64)],
        -1,
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3]

    t = np.linspace(0.0, 1.0, n_samples)
    near = (depths * 0.8)[:, None]
    far = (depths + 0.5)[:, None]
    z_vals = near * (1 - t) + far * t
    pts = rays_o[None, None] + rays_d[:, None, :] * z_vals[..., None]
    vertices = pts.reshape(-1, 3)

    scored = []
    for kf_id, kf in enumerate(keyframes):
        w2c = np.linalg.inv(kf["est_c2w"])
        uv, z, _ = _project(vertices, w2c, cam)
        edge = 20
        mask = (
            (uv[:, 0] < W - edge) & (uv[:, 0] > edge)
            & (uv[:, 1] < H - edge) & (uv[:, 1] > edge)
            & (z < 0)
        )
        scored.append((kf_id, mask.sum() / uv.shape[0]))

    scored.sort(key=lambda x: x[1], reverse=True)
    nonzero = [kf_id for kf_id, pct in scored if pct > 0.0]
    return list(rng.permutation(np.array(nonzero, dtype=np.int64))[:k])


def random_select(n: int, k: int, rng: Optional[np.random.Generator] = None) -> List[int]:
    """k distinct indices from range(n)."""
    rng = rng or np.random.default_rng()
    return list(rng.permutation(np.arange(n))[: min(n, k)])


def remap_bilinear_zero_border(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``img`` [H, W] sampled at (u = column, v = row) bilinearly; corners
    outside the image contribute 0 (cv2's BORDER_CONSTANT with value 0).
    Float32 arithmetic, exact weights."""
    H, W = img.shape
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    x0 = np.floor(u)
    y0 = np.floor(v)
    fx = u - x0
    fy = v - y0

    def corner(xi, yi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        # non-finite coordinates are never ``ok``; keep their index in range
        xc = np.clip(np.nan_to_num(xi), 0, W - 1).astype(np.int64)
        yc = np.clip(np.nan_to_num(yi), 0, H - 1).astype(np.int64)
        return np.where(ok, img[yc, xc], np.float32(0.0))

    one = np.float32(1.0)
    return (corner(x0, y0) * (one - fx) * (one - fy) + corner(x0 + 1, y0) * fx * (one - fy)
            + corner(x0, y0 + 1) * (one - fx) * fy + corner(x0 + 1, y0 + 1) * fx * fy)


def frustum_feature_mask(
    c2w: np.ndarray,
    grid_shape_zyx,
    depth_np: np.ndarray,
    bound: np.ndarray,
    cam: Camera,
) -> np.ndarray:
    """Boolean [Z, Y, X] mask of the grid nodes visible in the current
    frustum (plus a 0.5 m ball around the camera): the grid entries the
    mapper may update. Host version, float64 projection."""
    Z, Y, X = grid_shape_zyx
    xs = np.linspace(bound[0][0], bound[0][1], X)
    ys = np.linspace(bound[1][0], bound[1][1], Y)
    zs = np.linspace(bound[2][0], bound[2][1], Z)
    # meshgrid in (x, y, z) order, then flatten; mask reshaped to [Z, Y, X]
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([gx, gy, gz], -1).reshape(-1, 3)

    w2c = np.linalg.inv(c2w)
    uv, z, _ = _project(points, w2c, cam)
    uv32 = uv.astype(np.float32)
    H, W = cam.H, cam.W
    depths = remap_bilinear_zero_border(
        np.asarray(depth_np, np.float32), uv32[:, 0], uv32[:, 1])

    mask = (uv[:, 0] < W) & (uv[:, 0] > 0) & (uv[:, 1] < H) & (uv[:, 1] > 0)
    zero = depths == 0
    if np.any(~zero):
        depths[zero] = np.max(depths)
    mask &= (0 <= -z) & (-z <= depths + 0.5)

    # keep grid features near the camera centre regardless of visibility
    dist2 = np.sum((points - c2w[:3, 3]) ** 2, axis=1)
    mask |= dist2 < 0.25
    return mask.reshape(X, Y, Z).transpose(2, 1, 0)


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``start * (1 - s) + stop * s`` with s = i / (num - 1) and the last
    value ``stop`` exactly: the JAX package's linspace, float32."""
    s = torch.arange(num - 1, dtype=torch.float32, device=start.device) / float(num - 1)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def _intrinsics(cam: Camera, device) -> torch.Tensor:
    """The 3x3 intrinsics, filled on the device: a tensor built from a host
    list, or a Python number assigned into an element, is a copy from the
    host that waits for the device."""
    K = torch.zeros((3, 3), dtype=torch.float32, device=device)
    for (r, c), v in (((0, 0), cam.fx), ((0, 2), cam.cx), ((1, 1), cam.fy),
                      ((1, 2), cam.cy), ((2, 2), 1.0)):
        K[r, c].fill_(v)
    return K


def _frustum_mask(c2w: torch.Tensor, depth: torch.Tensor, bound: torch.Tensor,
                  K: torch.Tensor, Zs: int, Ys: int, Xs: int) -> torch.Tensor:
    """Boolean [Z, Y, X] frustum mask on the device, float32 (the JAX
    package's ``_frustum_mask_trace``)."""
    xs = _linspace(bound[0, 0], bound[0, 1], Xs)
    ys = _linspace(bound[1, 0], bound[1, 1], Ys)
    zs = _linspace(bound[2, 0], bound[2, 1], Zs)
    gx, gy, gz = torch.meshgrid(xs, ys, zs, indexing="ij")
    points = torch.stack([gx, gy, gz], -1).reshape(-1, 3)

    # inv_ex: no error check, so no read-back to the host
    w2c = torch.linalg.inv_ex(c2w).inverse
    cam_cord = points @ w2c[:3, :3].T + w2c[:3, 3]
    cam_cord = torch.cat([-cam_cord[:, :1], cam_cord[:, 1:]], dim=1)
    uvz = cam_cord @ K.T
    z = uvz[:, 2] + 1e-5
    u = uvz[:, 0] / z
    v = uvz[:, 1] / z

    # bilinear sample of the depth image at (u, v); corners outside it are 0
    H, W = depth.shape
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx_ = u - x0
    fy_ = v - y0

    def corner(xi, yi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(torch.nan_to_num(xi), 0, W - 1).to(torch.long)
        yc = torch.clamp(torch.nan_to_num(yi), 0, H - 1).to(torch.long)
        return torch.where(ok, depth[yc, xc], 0.0)

    depths = (
        corner(x0, y0) * (1 - fx_) * (1 - fy_) + corner(x0 + 1, y0) * fx_ * (1 - fy_)
        + corner(x0, y0 + 1) * (1 - fx_) * fy_ + corner(x0 + 1, y0 + 1) * fx_ * fy_
    )

    mask = (u < W) & (u > 0) & (v < H) & (v > 0)
    dmax = torch.max(depths)
    depths = torch.where(depths == 0, dmax, depths)
    mask &= (0 <= -z) & (-z <= depths + 0.5)

    dist2 = torch.sum((points - c2w[:3, 3]) ** 2, dim=1)
    mask |= dist2 < 0.25
    return mask.reshape(Xs, Ys, Zs).permute(2, 1, 0)


def frustum_feature_masks(c2w: torch.Tensor, grid_shapes: Sequence[Tuple[int, int, int]],
                          depth: torch.Tensor, bound, cam: Camera) -> Tuple[torch.Tensor, ...]:
    """The frustum masks of every grid level in one call: a tuple of
    [Z, Y, X, 1] float32 tensors on the depth's device, for ``grid_shapes``
    a list of (Z, Y, X). The pose, depth and (a tensor) bound stay on the
    device."""
    dev = depth.device
    c2w = c2w.to(dev, torch.float32)
    bound_t = (bound.to(dev, torch.float32) if isinstance(bound, torch.Tensor)
               else to_device(np.asarray(bound, np.float32), dev))
    K = _intrinsics(cam, dev)
    return tuple(
        _frustum_mask(c2w, depth, bound_t, K, int(Z), int(Y), int(X))[..., None]
        .to(torch.float32)
        for (Z, Y, X) in grid_shapes
    )


def select_assemble_window(
    kf_colors: torch.Tensor,
    kf_depths: torch.Tensor,
    kf_poses: torch.Tensor,
    cur_color: torch.Tensor,
    cur_depth: torch.Tensor,
    cur_c2w: torch.Tensor,
    k_sel: int,
    cam: Camera,
    pixel_idx: torch.Tensor,
    priorities: torch.Tensor,
):
    """Overlap scoring, selection and window assembly on the device, with
    no read-back to the host.

    The current frame's depth guides 100 pixels x 16 samples; each candidate
    keyframe (all but the last, always in the window) scores the share of
    those points inside its frustum. A uniform random priority, plus 10 on
    nonzero overlap, ranks the candidates and the top ``k_sel`` are taken:
    a random choice among the nonzero-overlap candidates. The window stays
    K = k_sel + 2 wide (fixed-K deviation: where fewer than ``k_sel``
    candidates overlap, zero-overlap ones fill it at random).

    The draws are arguments: ``pixel_idx`` [100] flat indices of the
    current frame's pixels, ``priorities`` [N - 1] uniform in [0, 1).

    Returns (colors [K,...], depths [K,...], fixed_c2w [K,4,4], cams [K,7],
    window_idx [K-1] store indices, opt_mask [K]: 0 at the oldest keyframe,
    the BA gauge anchor)."""
    N = kf_poses.shape[0]
    H, W = cam.H, cam.W
    dev = kf_poses.device

    jj = pixel_idx // W
    ii = pixel_idx % W
    d = cur_depth[jj, ii]
    jf = jj.to(torch.float32)
    if_ = ii.to(torch.float32)
    dirs = torch.stack(
        [(if_ - cam.cx) / cam.fx, -(jf - cam.cy) / cam.fy, -torch.ones_like(if_)], dim=-1)
    rays_d = dirs @ cur_c2w[:3, :3].T
    rays_o = cur_c2w[:3, 3]
    t = _linspace(torch.zeros((), device=dev), torch.ones((), device=dev), 16)
    z = (d * 0.8)[:, None] * (1.0 - t) + (d + 0.5)[:, None] * t
    verts = (rays_o + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)

    w2c = torch.linalg.inv_ex(kf_poses.to(torch.float32)).inverse
    camc = torch.einsum("nij,pj->npi", w2c[:, :3, :3], verts) + w2c[:, :3, 3][:, None, :]
    zs = camc[..., 2] + 1e-5
    u = (cam.fx * (-camc[..., 0]) + cam.cx * zs) / zs
    v = (cam.fy * camc[..., 1] + cam.cy * zs) / zs
    edge = 20
    inside = (u < W - edge) & (u > edge) & (v < H - edge) & (v > edge) & (zs < 0)
    score = inside.to(torch.float32).mean(dim=-1)  # [N]

    pri = priorities + torch.where(score[: N - 1] > 0.0, 10.0, 0.0)
    sel = torch.topk(pri, k_sel).indices
    window_idx = torch.cat([sel, torch.full((1,), N - 1, dtype=sel.dtype, device=dev)])
    colors = torch.cat([kf_colors[window_idx], cur_color[None]], dim=0)
    depths = torch.cat([kf_depths[window_idx], cur_depth[None]], dim=0)
    fixed = torch.cat([kf_poses[window_idx], cur_c2w[None]], dim=0).to(torch.float32)
    cams = tensor_from_pose_matrix(fixed[:, :3])
    oldest_pos = torch.argmin(window_idx)
    opt_mask = torch.ones((k_sel + 2,), dtype=torch.float32, device=dev)
    opt_mask = opt_mask.scatter(0, oldest_pos.reshape(1), 0.0)
    return colors, depths, fixed, cams, window_idx, opt_mask


def scatter_window_poses(kf_poses: torch.Tensor, window_idx: torch.Tensor,
                         new_cams: torch.Tensor, fixed_c2w: torch.Tensor,
                         opt_mask: torch.Tensor):
    """Device-side BA write-back: the optimised window poses go into the
    registry's pose stack; the anchored slot (opt_mask 0) keeps its pose.
    Returns (new pose stack, the current frame's new pose [4, 4])."""
    m34 = pose_matrix_from_tensor(new_cams)  # [K, 3, 4]
    bottom = torch.eye(4, device=m34.device)[3:].expand(m34.shape[0], 1, 4)
    m44 = torch.cat([m34, bottom], dim=1)
    upd = torch.where(opt_mask[:, None, None] > 0.0, m44, fixed_c2w)
    out = kf_poses.clone()
    out[window_idx] = upd[:-1]
    return out, upd[-1]
