"""Generate a config for a user-provided (Azure-style) RGB-D capture
(counterpart of ``evennicer_slam_tpu/tools/prep_own_data.py``).

Reads the camera intrinsics from ``intrinsic.json`` (open3d's convention:
the matrix column-major) and takes the scene bound from a reconstructed
mesh's bounding box +- 1 m (+-5 m without a mesh).

Usage:
    python -m evennicer_slam_tpu_torch.tools.prep_own_data --input_folder DIR \
        [--mesh recon.ply] [--out configs/Own/generated.yaml]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import yaml


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--mesh", default=None,
                        help="reconstructed mesh for bound estimation")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    with open(os.path.join(args.input_folder, "intrinsic.json")) as f:
        intr = json.load(f)
    W, H = intr["width"], intr["height"]
    m = intr["intrinsic_matrix"]  # column-major (open3d convention)
    fx, fy, cx, cy = m[0], m[4], m[6], m[7]

    mesh_path = args.mesh or os.path.join(args.input_folder, "scene", "integrated.ply")
    if os.path.exists(mesh_path):
        from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh

        mesh = Mesh.load(mesh_path)
        lo = mesh.vertices.min(0) - 1.0
        hi = mesh.vertices.max(0) + 1.0
    else:
        lo, hi = np.full(3, -5.0), np.full(3, 5.0)
    bound = [[round(float(a), 2), round(float(b), 2)] for a, b in zip(lo, hi)]

    cfg = {
        "inherit_from": "configs/Own/own.yaml",
        "mapping": {"bound": bound, "marching_cubes_bound": bound},
        "cam": {"H": H, "W": W, "fx": fx, "fy": fy, "cx": cx, "cy": cy,
                "png_depth_scale": 1000.0, "crop_edge": 0},
        "data": {
            "input_folder": args.input_folder,
            "output": os.path.join("output", os.path.basename(args.input_folder.rstrip("/"))),
        },
    }
    out = args.out or os.path.join("configs", "Own", "generated.yaml")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    print("wrote", out)


if __name__ == "__main__":
    main()
