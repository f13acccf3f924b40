"""Cull mesh faces outside every camera frustum of a trajectory
(counterpart of ``evennicer_slam_tpu/tools/cull_mesh.py``; numpy).

As the reference's src/tools/cull_mesh.py:32-76, which hardcodes Replica
intrinsics; here they are flags with the same defaults.

Usage:
    python -m evennicer_slam_tpu_torch.tools.cull_mesh --input_mesh m.ply \
        --traj traj.txt --output m_culled.ply [--H 680 --W 1200 --fx 600 ...]
"""

from __future__ import annotations

import argparse

import numpy as np

from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.keyframes import _project


def cull_mesh(
    mesh: Mesh, poses: np.ndarray, cam: Camera
) -> Mesh:
    """Keep faces with at least one vertex inside some frustum."""
    verts = mesh.vertices
    inside = np.zeros(len(verts), bool)
    for c2w in poses:
        w2c = np.linalg.inv(c2w)
        uv, z, _ = _project(verts, w2c, cam)
        inside |= (
            (uv[:, 0] < cam.W) & (uv[:, 0] > 0)
            & (uv[:, 1] < cam.H) & (uv[:, 1] > 0)
            & (z < 0)
        )
    face_out = (~inside)[mesh.faces].all(axis=1)
    out = Mesh(verts.copy(), mesh.faces.copy(),
               None if mesh.vertex_colors is None else mesh.vertex_colors.copy())
    out.update_faces(~face_out)
    return out


def load_traj(path: str) -> np.ndarray:
    lines = open(path).read().strip().splitlines()
    poses = []
    for ln in lines:
        c2w = np.array(list(map(float, ln.split()))).reshape(4, 4)
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1
        poses.append(c2w)
    return np.stack(poses)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cull mesh by trajectory frusta")
    parser.add_argument("--input_mesh", required=True)
    parser.add_argument("--traj", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--H", type=int, default=680)
    parser.add_argument("--W", type=int, default=1200)
    parser.add_argument("--fx", type=float, default=600.0)
    parser.add_argument("--fy", type=float, default=600.0)
    parser.add_argument("--cx", type=float, default=599.5)
    parser.add_argument("--cy", type=float, default=339.5)
    args = parser.parse_args(argv)
    cam = Camera(args.H, args.W, args.fx, args.fy, args.cx, args.cy)
    mesh = Mesh.load(args.input_mesh)
    poses = load_traj(args.traj)
    out = cull_mesh(mesh, poses, cam)
    out_path = args.output or args.input_mesh.replace(".ply", "_culled.ply")
    out.export(out_path)
    print("Saved culled mesh at", out_path)


if __name__ == "__main__":
    main()
