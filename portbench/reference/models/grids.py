"""Hierarchical dense feature grids (coarse / middle / fine / color), a plain
dict of ``[Z, Y, X, C]`` tensors (counterpart of
``evennicer_slam_tpu/models/grids.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference.utils.runtime import resolve_device

GRID_LEVELS = ("coarse", "middle", "fine", "color")
GRID_INIT_STD = {"coarse": 0.01, "middle": 0.01, "fine": 0.0001, "color": 0.01}


def grid_shapes(
    bound: np.ndarray,
    grid_len: Dict[str, float],
    coarse: bool,
    coarse_bound_enlarge: float = 2.0,
) -> Dict[str, Tuple[int, int, int]]:
    """Spatial (Z, Y, X) shape per level: ``int(extent / len)`` per world
    axis (x, y, z), stored [Z, Y, X]."""
    bound = np.asarray(bound)
    xyz_len = bound[:, 1] - bound[:, 0]
    shapes = {}
    for level in GRID_LEVELS:
        if level == "coarse":
            if not coarse:
                continue
            nxyz = [int(v) for v in (xyz_len * coarse_bound_enlarge / grid_len[level])]
        else:
            nxyz = [int(v) for v in (xyz_len / grid_len[level])]
        shapes[level] = (nxyz[2], nxyz[1], nxyz[0])  # (Z, Y, X)
    return shapes


def init_grids(
    generator: torch.Generator,
    bound: np.ndarray,
    grid_len: Dict[str, float],
    c_dim: int,
    coarse: bool,
    coarse_bound_enlarge: float = 2.0,
    dtype=torch.float32,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Allocate and normally-initialize the grid dict on ``device``. The
    draws are made on the generator's own device."""
    device = resolve_device(device)
    shapes = grid_shapes(bound, grid_len, coarse, coarse_bound_enlarge)
    grids = {}
    for level, shape in shapes.items():
        g = torch.randn((*shape, c_dim), generator=generator, dtype=dtype,
                        device=generator.device)
        grids[level] = (g * GRID_INIT_STD[level]).to(device)
    return grids
