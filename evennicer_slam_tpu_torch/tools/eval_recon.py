"""Mesh reconstruction evaluation: 3D accuracy/completion metrics + 2D
depth-L1 (counterpart of ``evennicer_slam_tpu/tools/eval_recon.py``; numpy +
scipy, on the host).

As the reference's src/tools/eval_recon.py:24-231, without open3d/trimesh:

- 3D: ICP-align the reconstructed mesh to ground truth, sample 200k surface
  points on each, then KD-tree nearest distances give accuracy (cm),
  completion (cm), and completion ratio (% < 5 cm).
- 2D: depth-L1 (cm) over random interior views; mesh depth maps are rendered
  with a real triangle z-buffer rasterizer (mesh/raster.py, replacing the
  reference's open3d offscreen renderer).

Usage:
    python -m evennicer_slam_tpu_torch.tools.eval_recon --rec_mesh a.ply --gt_mesh b.ply [-3d] [-2d]
"""

from __future__ import annotations

import argparse
from typing import Dict, Iterable

import numpy as np
from scipy.spatial import cKDTree

from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, workers=-1)
    return d


def icp_align(
    src_pts: np.ndarray, dst_pts: np.ndarray, iters: int = 30, threshold: float = 0.1
) -> np.ndarray:
    """Point-to-point ICP; returns a 4x4 transform mapping src -> dst
    (replaces the reference's o3d.registration_icp, eval_recon.py:54-75)."""
    T = np.eye(4)
    cur = src_pts.copy()
    tree = cKDTree(dst_pts)
    for _ in range(iters):
        d, idx = tree.query(cur, k=1, workers=-1)
        keep = d < threshold
        if keep.sum() < 10:
            break
        a = cur[keep]
        b = dst_pts[idx[keep]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vh = np.linalg.svd(H)
        S = np.eye(3)
        if np.linalg.det(U @ Vh) < 0:
            S[2, 2] = -1
        R = Vh.T @ S @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        cur = cur @ R.T + t
        T = step @ T
    return T


def accuracy(rec_pts, gt_pts):
    return float(nn_distances(rec_pts, gt_pts).mean())


def completion(rec_pts, gt_pts):
    return float(nn_distances(gt_pts, rec_pts).mean())


def completion_ratio(rec_pts, gt_pts, dist_th: float = 0.05):
    return float((nn_distances(gt_pts, rec_pts) < dist_th).mean())


def calc_3d_metric(
    rec_path: str, gt_path: str, n_samples: int = 200000, align: bool = True
) -> Dict[str, float]:
    """3D metrics in the reference's units: accuracy/completion in cm,
    completion ratio in % (reference eval_recon.py:91-117)."""
    rng = np.random.default_rng(0)
    rec = Mesh.load(rec_path)
    gt = Mesh.load(gt_path)
    rec_pts = rec.sample_surface(n_samples, rng)
    gt_pts = gt.sample_surface(n_samples, rng)
    if align:
        T = icp_align(rec_pts[::20], gt_pts[::20])
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    acc = accuracy(rec_pts, gt_pts)
    comp = completion(rec_pts, gt_pts)
    ratio = completion_ratio(rec_pts, gt_pts)
    return {
        "accuracy (cm)": acc * 100,
        "completion (cm)": comp * 100,
        "completion ratio (<5cm %)": ratio * 100,
    }


def seen_surface(gt_mesh: Mesh, views: Iterable, cam, n_samples: int = 100000,
                 depth_margin: float = 0.05):
    """Ground-truth surface samples, and which of them some view observed:
    inside its image, in front of its camera, and at most ``depth_margin``
    behind its ground-truth depth (furniture hides the wall behind it).
    ``views`` yields (c2w [4, 4], depth [H, W]). Returns (points [N, 3],
    mask [N])."""
    from evennicer_slam_tpu_torch.slam.keyframes import _project

    gt_pts = gt_mesh.sample_surface(n_samples, np.random.default_rng(3))
    seen = np.zeros(len(gt_pts), bool)
    for c2w, depth in views:
        uv, z, _ = _project(gt_pts, np.linalg.inv(np.asarray(c2w, np.float64)), cam)
        inside = ((uv[:, 0] > 0) & (uv[:, 0] < cam.W - 1) & (uv[:, 1] > 0)
                  & (uv[:, 1] < cam.H - 1) & (z < 0))
        depth = np.asarray(depth)
        ui = np.clip(uv[:, 0].astype(int), 0, cam.W - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, cam.H - 1)
        seen |= inside & (-z <= depth[vi, ui] + depth_margin)
    return gt_pts, seen


def completion_seen(rec_path: str, seen_pts: np.ndarray) -> Dict[str, float]:
    """Completion over the observed ground-truth surface only (cm, and %
    within 5 cm): completion against the whole ground truth conflates
    reconstruction quality with the trajectory's coverage."""
    rec_pts = Mesh.load(rec_path).sample_surface(200000, np.random.default_rng(4))
    d = nn_distances(seen_pts, rec_pts)
    return {"completion_seen (cm)": float(d.mean() * 100),
            "completion_ratio_seen (<5cm %)": float((d < 0.05).mean() * 100)}


def _viewmatrix(z, up, pos):
    """Reference viewmatrix (eval_recon.py:15-21): columns [x, y, z, pos];
    camera looks along +z (CV convention when up = [0, 0, -1])."""
    vec2 = z / np.linalg.norm(z)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    vec1 = vec1 / np.linalg.norm(vec1)
    return np.stack([vec0, vec1, vec2, pos], 1)


def _pca_obb(vertices: np.ndarray):
    """Oriented bounding box via PCA (approximates trimesh's minimum-volume
    oriented_bounds used by reference get_cam_position, eval_recon.py:118-127;
    for room-shaped Replica meshes the principal axes match)."""
    c = vertices.mean(0)
    x = vertices - c
    cov = x.T @ x / len(x)
    _, vecs = np.linalg.eigh(cov)
    R = vecs[:, ::-1]  # principal axis first
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    local = x @ R
    lo, hi = local.min(0), local.max(0)
    extents = hi - lo
    transform = np.eye(4)
    transform[:3, :3] = R
    transform[:3, 3] = c + R @ ((lo + hi) / 2)
    return extents, transform


def _check_proj(points, W, H, fx, fy, cx, cy, c2w) -> bool:
    """True if ANY point projects into the view (reference check_proj,
    eval_recon.py:62-88; c2w here is already CV-convention)."""
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2] + 1e-5
    uv = cam[:, :2] * np.array([fx, fy]) / z[:, None] + np.array([cx, cy])
    mask = (z > 0) & (uv[:, 0] > 0) & (uv[:, 0] < W) & (uv[:, 1] > 0) & (uv[:, 1] < H)
    return bool(mask.sum() > 0)


def calc_2d_metric(
    rec_path: str,
    gt_path: str,
    n_imgs: int = 1000,
    align: bool = True,
    unseen_pc: np.ndarray = None,
    seed: int = 0,
) -> Dict[str, float]:
    """Depth-L1 (cm) over random interior views — the reference protocol
    (eval_recon.py:129-210): camera positions sampled uniformly in the GT
    mesh's oriented bounding box scaled by (0.3, 0.7, 0.7) and raised 0.4 m;
    random look-at targets with up = [0, 0, -1]; a view is REJECTED if any
    point of ``{gt}_pc_unseen.npy`` projects into it; both meshes rendered
    as triangle meshes (mesh/raster.py replaces o3d offscreen); error is the
    mean |gt - rec| over ALL pixels of each accepted view."""
    import os

    from evennicer_slam_tpu_torch.mesh.raster import rasterize_depth

    H = W = 500
    focal = 300.0
    fx = fy = focal
    # the reference writes cx = H/2, cy = W/2 (eval_recon.py:139-140) — a
    # latent swap that is value-identical at its square 500x500 resolution;
    # written correctly here
    cx = W / 2.0 - 0.5
    cy = H / 2.0 - 0.5
    rng = np.random.default_rng(seed)

    rec = Mesh.load(rec_path)
    gt = Mesh.load(gt_path)
    if unseen_pc is None:
        unseen_file = gt_path.replace(".ply", "_pc_unseen.npy")
        if os.path.exists(unseen_file):
            unseen_pc = np.load(unseen_file)
    rec_v = rec.vertices
    if align:
        rec_pts = rec.sample_surface(200000, np.random.default_rng(1))
        gt_pts = gt.sample_surface(200000, np.random.default_rng(2))
        T = icp_align(rec_pts[::10], gt_pts[::10])
        rec_v = rec_v @ T[:3, :3].T + T[:3, 3]

    extents, transform = _pca_obb(gt.vertices)
    extents = extents * np.array([0.3, 0.7, 0.7])
    transform = transform.copy()
    transform[2, 3] += 0.4

    errs = []
    tries = 0
    while len(errs) < n_imgs and tries < n_imgs * 50:
        tries += 1
        up = np.array([0.0, 0.0, -1.0])
        local = (rng.random(3) - 0.5) * extents
        origin = transform[:3, :3] @ local + transform[:3, 3]
        target = rng.uniform(-10000, 10000, 3) - origin
        if np.linalg.norm(np.cross(up, target)) < 1e-8:
            continue
        c2w = np.eye(4)
        c2w[:3, :] = _viewmatrix(target, up, origin)
        if unseen_pc is not None and _check_proj(
            unseen_pc, W, H, fx, fy, cx, cy, c2w
        ):
            continue  # unseen region visible -> resample view
        w2c = np.linalg.inv(c2w)
        gt_depth = rasterize_depth(gt.vertices, gt.faces, w2c, H, W, fx, fy, cx, cy)
        rec_depth = rasterize_depth(rec_v, rec.faces, w2c, H, W, fx, fy, cx, cy)
        errs.append(np.abs(gt_depth - rec_depth).mean())
    return {"depth L1 (cm)": float(np.mean(errs) * 100) if errs else float("nan")}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Mesh reconstruction evaluation")
    parser.add_argument("--rec_mesh", required=True)
    parser.add_argument("--gt_mesh", required=True)
    parser.add_argument("-3d", "--metric_3d", action="store_true")
    parser.add_argument("-2d", "--metric_2d", action="store_true")
    parser.add_argument("--n_imgs", type=int, default=1000)
    args = parser.parse_args(argv)
    if args.metric_3d or not args.metric_2d:
        for k, v in calc_3d_metric(args.rec_mesh, args.gt_mesh).items():
            print(f"{k}: {v:.4f}")
    if args.metric_2d:
        for k, v in calc_2d_metric(
            args.rec_mesh, args.gt_mesh, n_imgs=args.n_imgs
        ).items():
            print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
