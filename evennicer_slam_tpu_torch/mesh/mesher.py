"""Mesher: occupancy sweep on the device, marching tetrahedra, cleaning,
colours and PLY export (counterpart of ``evennicer_slam_tpu/mesh/mesher.py``).

The decoder sweep over the query lattice (256^3 points at the shipped
resolution) runs chunk by chunk on the device through the renderer's
``eval_points`` at stage ``"fine"``; each chunk makes its slice of the lattice
on the device and applies the convex-hull test there, so no point crosses to
the device and only the volume's mesh comes back. Marching runs where the
volume is (``mesh/marching.py``). The visibility masks, the hull, the clean,
the component filter and the export are host numpy over mesh-sized data and
the keyframes' host depth and poses.

Vertex colours: ``direct_point_query`` decodes each vertex's colour;
any other ``meshing.color_mesh_extraction_method`` (iMAP's
``render_ray_along_normal``) renders a short ray into the surface along each
vertex's inward normal through ``Renderer.render_batch``, on the device,
100,000 rays at a time. With ``occupancy: false`` (iMAP) the sweep reads raw
density and ``meshing.level_set`` is a density level.

Meshing reads data-dependent shapes back to the host, so it synchronises
with the device; the pipeline calls it between frames, never inside
``step``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from evennicer_slam_tpu_torch.mesh.marching import marching_cubes
from evennicer_slam_tpu_torch.mesh.trimesh_lite import ConvexHullRegion, Mesh
from evennicer_slam_tpu_torch.render.renderer import Renderer, RenderSettings, eval_points
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.keyframes import _project
from evennicer_slam_tpu_torch.utils.runtime import resolve_device

HULL_PLANE_BLOCK = 128  # planes a block: bounds the [points, planes] distances
NORMAL_RAY_LENGTH = 0.1  # rays start this far behind each vertex
NORMAL_RAY_CHUNK = 100000


def hull_inside(p: torch.Tensor, eq: torch.Tensor, tol: float) -> torch.Tensor:
    """Half-space test of points [N, 3] against hull planes [F, 4]
    (normal, offset): inside where every ``n . p + offset <= tol``.

    Three float32 multiply-adds per plane, not a matrix product, so that the
    test never runs in TF32 (a 10-bit mantissa moves a distance at metre
    scale by about 1e-3, past the hull's 1e-5 tolerance) whatever the
    process's matmul setting; planes go in blocks of
    ``HULL_PLANE_BLOCK``."""
    inside = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    for j in range(0, eq.shape[0], HULL_PLANE_BLOCK):
        e = eq[j:j + HULL_PLANE_BLOCK]
        d = p[:, 0:1] * e[:, 0] + p[:, 1:2] * e[:, 1] + p[:, 2:3] * e[:, 2] + e[:, 3]
        inside &= (d <= tol).all(dim=1)
    return inside


class Mesher:
    """Scene mesh extraction from the map. ``device=None`` means the CUDA
    device. After each :meth:`get_mesh`, ``last_stats`` holds its seconds by
    part (``sweep_s``, ``march_s``, ``clean_s`` with its ``seen_mask_s``,
    ``color_s``, ``export_s``, ``total_s``; ``sweep_device_ms`` by CUDA
    events on the card) and the mesh's vertex and face counts."""

    def __init__(
        self,
        cfg: Dict,
        cam: Camera,
        settings: RenderSettings,
        bound: np.ndarray,
        points_batch_size: int = 500000,
        device=None,
    ):
        mcfg = cfg["meshing"]
        self.device = resolve_device(device)
        self.cam = cam
        self.settings = settings
        self.bound = torch.from_numpy(np.array(bound, np.float32)).to(self.device)
        self.scale = cfg["scale"]
        self.resolution = mcfg["resolution"]
        self.level_set = mcfg["level_set"]
        self.clean_mesh_bound_scale = mcfg["clean_mesh_bound_scale"]
        self.remove_small_geometry_threshold = mcfg["remove_small_geometry_threshold"]
        self.color_mesh_extraction_method = mcfg["color_mesh_extraction_method"]
        self.get_largest_components = mcfg["get_largest_components"]
        self.depth_test = mcfg["depth_test"]
        self.clean = mcfg.get("clean_mesh", True)
        self.points_batch_size = points_batch_size
        self.marching_cubes_bound = (
            np.array(cfg["mapping"]["marching_cubes_bound"], np.float64) * self.scale
        )
        self.verbose = cfg.get("verbose", False)
        self.last_stats: Dict[str, float] = {}
        self._bound_np = np.array(bound, np.float32)
        self._renderer: Optional[Renderer] = None  # built on first use

    # ------------------------------------------------------------------

    def get_grid_uniform(self, resolution: int):
        """Query grid over the marching-cubes bound with 0.05 padding (the
        reference's 'xy' meshgrid order and [1, 0, 2] transpose are applied
        by the sweep and by :meth:`get_mesh`)."""
        bound = self.marching_cubes_bound
        padding = 0.05
        x = np.linspace(bound[0][0] - padding, bound[0][1] + padding, resolution)
        y = np.linspace(bound[1][0] - padding, bound[1][1] + padding, resolution)
        z = np.linspace(bound[2][0] - padding, bound[2][1] + padding, resolution)
        return {"xyz": [x, y, z]}

    def eval_rgb(self, points: np.ndarray, grids, decoders) -> np.ndarray:
        """Colours of host points, decoded ``points_batch_size`` at a time
        on the device; every chunk is enqueued before the one read-back."""
        outs = []
        with torch.no_grad():
            for i in range(0, points.shape[0], self.points_batch_size):
                p = torch.from_numpy(np.ascontiguousarray(
                    points[i:i + self.points_batch_size], np.float32)).to(self.device)
                outs.append(eval_points(decoders, grids, p, self.bound, "color",
                                        self.settings)[:, :3])
        return torch.cat(outs).cpu().numpy()

    def render_along_normals(self, vertices: np.ndarray, normals: np.ndarray, grids,
                             decoders) -> np.ndarray:
        """Colours of host vertices [N, 3] by a render along their unit
        normals [N, 3] (``_vertex_normals``): rays from ``NORMAL_RAY_LENGTH``
        behind each vertex, the depth prior at the vertex, at stage colour,
        ``NORMAL_RAY_CHUNK`` rays a call; every chunk is enqueued before the
        one read-back. The render is deterministic: no jitter and no random
        importance draws at ``rendering.perturb`` 0."""
        if self._renderer is None:
            cam = self.cam
            self._renderer = Renderer(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy,
                                      self._bound_np, self.settings, device=self.device)
        dev = self.device
        rays_d = torch.from_numpy(normals.astype(np.float32)).to(dev)
        rays_o = torch.from_numpy(
            (vertices - NORMAL_RAY_LENGTH * normals).astype(np.float32)).to(dev)
        gt_depth = torch.full((len(vertices),), NORMAL_RAY_LENGTH, dtype=torch.float32,
                              device=dev)
        outs = []
        with torch.no_grad():
            for i in range(0, rays_d.shape[0], NORMAL_RAY_CHUNK):
                sl = slice(i, i + NORMAL_RAY_CHUNK)
                outs.append(self._renderer.render_batch(decoders, grids, rays_o[sl], rays_d[sl],
                                                        "color", gt_depth[sl])[2])
        return torch.cat(outs).cpu().numpy()

    def masked_occ_sweep(self, xyz, hull: ConvexHullRegion, grids, decoders,
                         stage: str = "fine") -> torch.Tensor:
        """Occupancy over the whole lattice, +100 outside the hull (the
        reference's mesh_bound mask), as a flat float32 tensor on the device
        in the 'xy' order (NY, NX, NZ). Each chunk makes its points from its
        start; the last chunk stops at the lattice's end."""
        dev = self.device
        x, y, z = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in xyz)
        nx, ny, nz = len(x), len(y), len(z)
        n = nx * ny * nz
        eq = torch.from_numpy(hull.equations.astype(np.float32)).to(dev)
        tol = float(np.float32(hull.tol))
        out = torch.empty(n, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for start in range(0, n, self.points_batch_size):
                flat = torch.arange(start, min(start + self.points_batch_size, n), device=dev)
                iy = flat // (nx * nz)
                ix = (flat // nz) % nx
                iz = flat % nz
                p = torch.stack([x[ix], y[iy], z[iz]], dim=-1)
                raw = eval_points(decoders, grids, p, self.bound, stage, self.settings)
                out[start:start + flat.shape[0]] = torch.where(
                    hull_inside(p, eq, tol), raw[:, -1], 100.0)
        return out

    # ------------------------------------------------------------------

    def seen_mask(
        self,
        points: np.ndarray,
        keyframe_dict: List[Dict],
        estimate_c2w_list: np.ndarray,
        idx: int,
        get_mask_use_all_frames: bool = False,
    ) -> np.ndarray:
        """Points seen by some keyframe (inside its image, in front of it and
        near or before its depth), or, with ``get_mask_use_all_frames``,
        inside the frustum of some frame up to ``idx``; on the host."""
        cam = self.cam
        H, W = cam.H, cam.W
        seen = np.zeros(points.shape[0], bool)

        if get_mask_use_all_frames:
            poses = [estimate_c2w_list[i] for i in range(0, idx + 1)]
            depth_imgs = [None] * len(poses)
        else:
            poses = [kf["est_c2w"] for kf in keyframe_dict]
            depth_imgs = [kf["depth"] for kf in keyframe_dict]

        for c2w, depth_img in zip(poses, depth_imgs):
            w2c = np.linalg.inv(np.asarray(c2w, np.float64))
            uv, z, cam_cord = _project(points.astype(np.float64), w2c, cam)
            cur_seen = ((uv[:, 0] < W) & (uv[:, 0] > 0) & (uv[:, 1] < H) & (uv[:, 1] > 0)
                        & (z < 0))
            proj_depth = -cam_cord[:, 2]
            if depth_img is None:
                pass  # all-frames mode: the frustum test alone
            elif self.depth_test:
                ds = _bilinear_sample(depth_img, uv)
                cur_seen &= (proj_depth < ds + 2.4) & (ds - 2.4 < proj_depth)
            else:
                cur_seen &= proj_depth < float(np.max(depth_img)) * 1.1
            seen |= cur_seen
        return seen

    def get_bound_from_frames(self, keyframe_dict: List[Dict], scale=1.0):
        """Scene hull from the keyframes' RGB-D: each keyframe's depth map
        back-projected (every 8th pixel) plus the camera centres, convex
        hull scaled by ``clean_mesh_bound_scale``."""
        cam = self.cam
        pts = []
        stride = 8  # the hull is insensitive to density
        jj, ii = np.meshgrid(
            np.arange(0, cam.H, stride), np.arange(0, cam.W, stride), indexing="ij"
        )
        dirs = np.stack(
            [
                (ii - cam.cx) / cam.fx,
                -(jj - cam.cy) / cam.fy,
                -np.ones_like(ii, np.float64),
            ],
            -1,
        )
        for kf in keyframe_dict:
            c2w = np.asarray(kf["est_c2w"], np.float64)
            d = np.asarray(kf["depth"])[::stride, ::stride]
            valid = d > 0
            rays_d = dirs @ c2w[:3, :3].T
            p = c2w[:3, 3] + rays_d[valid] * d[valid][:, None]
            pts.append(p)
            pts.append(c2w[:3, 3][None])
        allp = np.concatenate(pts, axis=0)
        return ConvexHullRegion(allp, scale=self.clean_mesh_bound_scale)

    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_mesh(
        self,
        mesh_out_file: str,
        grids,
        decoders,
        keyframe_dict: List[Dict],
        estimate_c2w_list: np.ndarray,
        idx: int,
        color: bool = True,
        clean_mesh: Optional[bool] = None,
        get_mask_use_all_frames: bool = False,
    ) -> Optional[Mesh]:
        """Extract, clean, colour and export the scene mesh; returns it, or
        None when the level set is empty."""
        stats: Dict[str, float] = {}
        t_start = time.perf_counter()
        clean_mesh = self.clean if clean_mesh is None else clean_mesh
        grid = self.get_grid_uniform(self.resolution)
        x, y, zax = grid["xyz"]

        t0 = time.perf_counter()
        mesh_bound = self.get_bound_from_frames(keyframe_dict, self.scale)
        if self.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        z = self.masked_occ_sweep(grid["xyz"], mesh_bound, grids, decoders)
        if self.device.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
            stats["sweep_device_ms"] = ev[0].elapsed_time(ev[1])
        self._sync()
        stats["sweep_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        volume = z.reshape(len(y), len(x), len(zax)).permute(1, 0, 2)
        spacing = (x[2] - x[1], y[2] - y[1], zax[2] - zax[1])
        verts, faces = marching_cubes(volume, level=float(self.level_set), spacing=spacing)
        del z, volume
        verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
        stats["march_s"] = time.perf_counter() - t0
        if len(verts) == 0:
            print("marching cubes: no surface extracted from the level set.")
            self.last_stats = stats
            return None
        vertices = verts + np.array([x[0], y[0], zax[0]])

        t0 = time.perf_counter()
        mesh = Mesh(vertices, faces)
        stats["seen_mask_s"] = 0.0
        if clean_mesh:
            t1 = time.perf_counter()
            seen_m = self.seen_mask(mesh.vertices, keyframe_dict, estimate_c2w_list, idx,
                                    get_mask_use_all_frames=get_mask_use_all_frames)
            stats["seen_mask_s"] = time.perf_counter() - t1
            face_unseen = (~seen_m)[mesh.faces].all(axis=1)
            mesh.update_faces(~face_unseen)

            labels, ncomp = mesh.face_components()
            if ncomp:
                comp_area = np.bincount(
                    labels, weights=mesh.face_areas, minlength=ncomp
                )
                if self.get_largest_components:
                    keep_faces = labels == int(comp_area.argmax())
                else:
                    good = comp_area > (
                        self.remove_small_geometry_threshold
                        * self.scale * self.scale
                    )
                    keep_faces = good[labels]
                if keep_faces.any():
                    mesh.update_faces(keep_faces)
        stats["clean_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        vertex_colors = None
        if color and len(mesh.vertices):
            if self.color_mesh_extraction_method == "direct_point_query":
                rgb = self.eval_rgb(mesh.vertices.astype(np.float32), grids, decoders)
            else:
                rgb = self.render_along_normals(mesh.vertices, _vertex_normals(mesh), grids,
                                                decoders)
            vertex_colors = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        stats["color_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = Mesh(mesh.vertices / self.scale, mesh.faces, vertex_colors)
        out.export(mesh_out_file)
        stats["export_s"] = time.perf_counter() - t0
        stats["total_s"] = time.perf_counter() - t_start
        stats["vertices"] = len(out.vertices)
        stats["faces"] = len(out.faces)
        self.last_stats = stats
        if self.verbose:
            print("Saved mesh at", mesh_out_file)
        return out


def _vertex_normals(mesh: Mesh) -> np.ndarray:
    """Unit vertex normals: the sum of the adjacent faces' cross products
    (area-weighted), normalised; float64 on the host."""
    v = mesh.vertices
    f = mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def _bilinear_sample(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear sample with zero padding (torch grid_sample 'zeros',
    align_corners=True equivalent for pixel coordinates)."""
    H, W = img.shape
    x = uv[:, 0]
    y = uv[:, 1]
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    out = np.zeros(len(uv))
    for dx in (0, 1):
        for dy in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            w = (1 - np.abs(x - xi)) * (1 - np.abs(y - yi))
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            out[valid] += w[valid] * img[yi[valid], xi[valid]]
    return out
