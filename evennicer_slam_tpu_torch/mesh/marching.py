"""Iso-surface extraction: vectorised marching tetrahedra as torch ops
(counterpart of ``evennicer_slam_tpu/mesh/marching.py``).

Every grid cell is split into 6 tetrahedra and each tet contributes 0-2
triangles with vertices linearly interpolated onto the iso-level. The
function runs on the volume's device: on the card, where the mesher's sweep
left the volume, only the mesh comes back to the host.

Given the same volume it returns the JAX function's faces, in the same order,
and its vertices to float32 rounding:
- the reflected Kuhn triangulation (corner id XOR the cell's coordinate
  parity), which makes neighbouring cells conform;
- vertices welded by the edge key ``lo * (NX*NY*NZ) + hi`` (int64), the
  vertex kept for a key being its first occurrence, as
  ``np.unique(return_index=True)`` keeps it;
- each face wound outward, from the tet's inside corners towards its
  outside ones, in float64 as numpy computes it; degenerate faces dropped.

Only the cells that cross the level set are gathered: the all-cells pass
keeps two boolean masks, not the ``[cells, 8]`` corner values.

Inside = value > level, the reference mesher's occupancy-logit convention.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (corner indices).
# Cube corners: bit 0 -> +x, bit 1 -> +y, bit 2 -> +z offset.
_TETS = np.array(
    [
        [0, 5, 1, 3],
        [0, 5, 3, 7],
        [0, 5, 7, 4],
        [0, 7, 3, 2],
        [0, 7, 2, 6],
        [0, 7, 6, 4],
    ],
    np.int64,
)
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)
# Tet edges: (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def _tet_case_table() -> np.ndarray:
    """[16, 2, 3] tet-edge ids per sign case (-1 = unused): up to two
    triangles from the inside/outside split of the 4 tet vertices."""
    table = -np.ones((16, 2, 3), np.int64)
    edge_lookup = {tuple(sorted(e)): i for i, e in enumerate(_TET_EDGES.tolist())}

    def edges_from(inside, outside):
        return [edge_lookup[tuple(sorted((a, b)))] for a in inside for b in outside]

    for case in range(16):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if not case & (1 << v)]
        if len(inside) in (0, 4):
            continue
        if len(inside) == 1:
            table[case, 0] = edges_from(inside, outside)
        elif len(inside) == 3:
            e = edges_from(inside, outside)
            table[case, 0] = [e[0], e[2], e[1]]  # the 1-inside case, flipped
        else:  # 2 inside, 2 outside -> a quad -> 2 triangles
            i0, i1 = inside
            o0, o1 = outside
            e00 = edge_lookup[tuple(sorted((i0, o0)))]
            e01 = edge_lookup[tuple(sorted((i0, o1)))]
            e10 = edge_lookup[tuple(sorted((i1, o0)))]
            e11 = edge_lookup[tuple(sorted((i1, o1)))]
            table[case, 0] = [e00, e10, e11]
            table[case, 1] = [e00, e11, e01]
    return table


_CASE_TABLE = _tet_case_table()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of [..., 3] arrays, summed left to right as
    numpy's ``(a * b).sum(-1)`` sums three terms."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.cross`` of [..., 3] arrays, term for term."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def marching_cubes(
    volume: Union[torch.Tensor, np.ndarray],
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract the ``level`` iso-surface of ``volume`` [NX, NY, NZ].

    Returns (vertices [V, 3] float32 in spacing units, faces [F, 3] int64),
    on the volume's device (a numpy volume is taken as a CPU tensor).
    Vertices are shared per interpolated grid edge. Inside = value > level.
    """
    vol = torch.as_tensor(volume).to(torch.float32).contiguous()
    dev = vol.device
    NX, NY, NZ = vol.shape
    empty = (torch.zeros((0, 3), dtype=torch.float32, device=dev),
             torch.zeros((0, 3), dtype=torch.int64, device=dev))
    if min(NX, NY, NZ) < 2:
        return empty
    nx, ny, nz = NX - 1, NY - 1, NZ - 1
    offsets = torch.from_numpy(_CORNER_OFFSETS).to(dev)

    # cells with corners on both sides of the level, in np.argwhere's order
    any_in = torch.zeros((nx, ny, nz), dtype=torch.bool, device=dev)
    any_out = torch.zeros_like(any_in)
    for ox, oy, oz in _CORNER_OFFSETS.tolist():
        c_in = vol[ox:ox + nx, oy:oy + ny, oz:oz + nz] > level
        any_in |= c_in
        any_out |= ~c_in
    active = torch.nonzero(any_in & any_out)  # [A, 3]
    del any_in, any_out
    if active.shape[0] == 0:
        return empty

    flat = vol.reshape(-1)

    def node_id(cells, corners):
        """Grid-node ids and positions of cube corners ``corners`` of ``cells``."""
        pos = cells + offsets[corners]
        return (pos[..., 0] * NY + pos[..., 1]) * NZ + pos[..., 2], pos

    A = active.shape[0]
    corner_ids = torch.arange(8, device=dev).expand(A, 8)
    av = flat[node_id(active[:, None, :], corner_ids)[0]]  # [A, 8]
    # Reflected Kuhn triangulation: mirror the 6-tet decomposition by the
    # cell's per-axis parity, so that the two sides of a shared cell face are
    # cut along the same diagonal and their iso-vertices weld by edge key
    # (see the JAX package's marching.py for why a translation-invariant
    # decomposition cracks the surface).
    parity = (active[:, 0] & 1) | ((active[:, 1] & 1) << 1) | ((active[:, 2] & 1) << 2)
    cell_tets = torch.from_numpy(_TETS).to(dev)[None] ^ parity[:, None, None]  # [A, 6, 4]
    tet_vals = torch.gather(av, 1, cell_tets.reshape(A, 24)).reshape(A, 6, 4)
    tet_in = tet_vals > level
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    cases = (tet_in.long() * bits).sum(-1)  # [A, 6]

    tris = torch.from_numpy(_CASE_TABLE).to(dev)[cases]  # [A, 6, 2, 3], -1 = none
    a_idx, t_idx, k_idx = torch.nonzero(tris[..., 0] >= 0, as_tuple=True)
    tri_edges = tris[a_idx, t_idx, k_idx]  # [T, 3] tet-edge ids
    cell = active[a_idx]  # [T, 3]
    tet_corner = cell_tets[a_idx, t_idx]  # [T, 4] cube-corner ids (mirrored)
    T = tri_edges.shape[0]
    edges = torch.from_numpy(_TET_EDGES).to(dev)

    pts, keys = [], []
    for slot in range(3):
        e = edges[tri_edges[:, slot]]  # [T, 2] tet-local vertex pairs
        va = torch.gather(tet_corner, 1, e[:, :1])[:, 0]
        vb = torch.gather(tet_corner, 1, e[:, 1:])[:, 0]
        ida, pa = node_id(cell, va)
        idb, pb = node_id(cell, vb)
        keys.append(torch.minimum(ida, idb) * (NX * NY * NZ) + torch.maximum(ida, idb))
        fa, fb = flat[ida], flat[idb]
        denom = fb - fa
        denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        t = torch.clamp((level - fa) / denom, 0.0, 1.0)
        # numpy promotes the float32 fraction and the integer positions to float64
        pts.append(pa.double() + t.double()[:, None] * (pb - pa).double())

    key = torch.cat(keys)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    first = torch.full((uniq.shape[0],), key.shape[0], dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(key.shape[0], device=dev), "amin")
    vertices = torch.cat(pts)[first].to(torch.float32)
    faces = torch.stack([inv[:T], inv[T:2 * T], inv[2 * T:]], dim=1)

    # Outward winding: orient each triangle so its normal points from the
    # tet's inside corners towards its outside corners, out of the solid.
    p0, p1, p2 = pts
    tri_n = _cross(p1 - p0, p2 - p0)
    tin = tet_in[a_idx, t_idx].double()  # [T, 4]
    cpos = (cell[:, None, :] + offsets[tet_corner]).double()  # [T, 4, 3]
    w_in = tin / torch.clamp(tin.sum(-1, keepdim=True), min=1.0)
    w_out = (1.0 - tin) / torch.clamp((1.0 - tin).sum(-1, keepdim=True), min=1.0)
    w = (w_out - w_in)[..., None] * cpos
    outward = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
    flip = _dot3(tri_n, outward) < 0
    faces = torch.where(flip[:, None], faces[:, [0, 2, 1]], faces)

    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]
    vertices = vertices * torch.tensor(np.asarray(spacing, np.float32), device=dev)[None]
    return vertices, faces
