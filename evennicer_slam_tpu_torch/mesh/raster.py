"""Offline triangle-mesh depth rasterizer (numpy, z-buffer; counterpart of
``evennicer_slam_tpu/mesh/raster.py``).

Replaces the reference 2D-recon metric's open3d offscreen renderer
(reference src/tools/eval_recon.py:152-205, capture_depth_float_buffer):
a perspective z-buffer rasterizer with near-plane clipping and
perspective-correct depth. CV camera convention (+x right, +y down,
+z forward), matching the o3d pinhole model the reference renders with.

Vectorization strategy: most marching-cubes triangles cover only a few
pixels at 500x500, so faces are expanded into (face, pixel) candidate pairs
over their screen bounding boxes in one shot; the few large near-camera
faces fall back to a per-face path.
"""

from __future__ import annotations

import numpy as np

_Z_NEAR = 1e-3


def _clip_near(tris: np.ndarray) -> np.ndarray:
    """Clip camera-space triangles [F, 3, 3] against z = _Z_NEAR
    (Sutherland-Hodgman for the single plane; fan re-triangulation)."""
    z = tris[:, :, 2]
    inside = z > _Z_NEAR
    n_in = inside.sum(1)
    keep = tris[n_in == 3]
    cross = np.nonzero((n_in == 1) | (n_in == 2))[0]
    if cross.size == 0:
        return keep
    extra = []
    for fi in cross:
        poly = []
        t = tris[fi]
        for i in range(3):
            a, b = t[i], t[(i + 1) % 3]
            ain, bin_ = a[2] > _Z_NEAR, b[2] > _Z_NEAR
            if ain:
                poly.append(a)
            if ain != bin_:
                s = (_Z_NEAR - a[2]) / (b[2] - a[2])
                poly.append(a + s * (b - a))
        for i in range(1, len(poly) - 1):
            extra.append([poly[0], poly[i], poly[i + 1]])
    if extra:
        keep = np.concatenate([keep, np.asarray(extra)], axis=0)
    return keep


def rasterize_depth(
    vertices: np.ndarray,
    faces: np.ndarray,
    w2c: np.ndarray,
    H: int,
    W: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bbox_cap: int = 24,
) -> np.ndarray:
    """Depth map [H, W] in meters; 0 where no geometry projects."""
    cam = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    tris = _clip_near(cam[faces])
    if tris.shape[0] == 0:
        return np.zeros((H, W), np.float32)

    z = tris[:, :, 2]
    u = fx * tris[:, :, 0] / z + cx
    v = fy * tris[:, :, 1] / z + cy
    iw = 1.0 / z  # interpolated linearly in screen space (perspective-correct)

    u0 = np.clip(np.floor(u.min(1)).astype(np.int64), 0, W - 1)
    u1 = np.clip(np.ceil(u.max(1)).astype(np.int64), 0, W - 1)
    v0 = np.clip(np.floor(v.min(1)).astype(np.int64), 0, H - 1)
    v1 = np.clip(np.ceil(v.max(1)).astype(np.int64), 0, H - 1)
    bw = u1 - u0 + 1
    bh = v1 - v0 + 1
    onscreen = (u.max(1) >= 0) & (u.min(1) <= W - 1) & (v.max(1) >= 0) & (v.min(1) <= H - 1)

    zbuf = np.full(H * W, np.inf, np.float64)

    def _splat(face_ids, px, py):
        """Barycentric-test candidate (face, pixel) pairs and z-buffer them."""
        ua, va = u[face_ids], v[face_ids]
        d00x = ua[:, 1] - ua[:, 0]
        d00y = va[:, 1] - va[:, 0]
        d10x = ua[:, 2] - ua[:, 0]
        d10y = va[:, 2] - va[:, 0]
        denom = d00x * d10y - d00y * d10x
        ok = np.abs(denom) > 1e-12
        face_ids, px, py = face_ids[ok], px[ok], py[ok]
        if face_ids.size == 0:
            return
        ua, va = u[face_ids], v[face_ids]
        denom = denom[ok]
        ex = px - ua[:, 0]
        ey = py - va[:, 0]
        b1 = (ex * (va[:, 2] - va[:, 0]) - ey * (ua[:, 2] - ua[:, 0])) / denom
        b2 = (ey * (ua[:, 1] - ua[:, 0]) - ex * (va[:, 1] - va[:, 0])) / denom
        b0 = 1.0 - b1 - b2
        hit = (b0 >= -1e-9) & (b1 >= -1e-9) & (b2 >= -1e-9)
        face_ids, px, py = face_ids[hit], px[hit], py[hit]
        if face_ids.size == 0:
            return
        b0, b1, b2 = b0[hit], b1[hit], b2[hit]
        wi = iw[face_ids]
        w_interp = b0 * wi[:, 0] + b1 * wi[:, 1] + b2 * wi[:, 2]
        depth = 1.0 / np.maximum(w_interp, 1e-12)
        np.minimum.at(zbuf, py * W + px, depth)

    small = np.nonzero(onscreen & (bw <= bbox_cap) & (bh <= bbox_cap))[0]
    if small.size:
        bws, bhs = bw[small], bh[small]
        counts = bws * bhs
        total = counts.sum()
        face_rep = np.repeat(small, counts)
        # per-pair offset within its face's bbox
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        local = np.arange(total) - np.repeat(starts, counts)
        bw_rep = np.repeat(bws, counts)
        px = np.repeat(u0[small], counts) + local % bw_rep
        py = np.repeat(v0[small], counts) + local // bw_rep
        _splat(face_rep, px, py)

    large = np.nonzero(onscreen & ((bw > bbox_cap) | (bh > bbox_cap)))[0]
    for fi in large:
        gx, gy = np.meshgrid(
            np.arange(u0[fi], u1[fi] + 1), np.arange(v0[fi], v1[fi] + 1)
        )
        px = gx.ravel()
        py = gy.ravel()
        _splat(np.full(px.shape, fi, np.int64), px, py)

    zbuf = zbuf.reshape(H, W)
    out = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return out
