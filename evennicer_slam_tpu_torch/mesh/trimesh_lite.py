"""Minimal triangle-mesh toolkit: PLY export/import, areas, connected
components, convex hulls, surface sampling (counterpart of
``evennicer_slam_tpu/mesh/trimesh_lite.py``; numpy + scipy, host code on
mesh-sized data).

:meth:`Mesh.export` writes the same bytes as the JAX package's for the same
arrays, and :meth:`Mesh.load` reads either package's files. The mesher's
device sweep makes its own half-space test (``mesh/mesher.py``); the host
:meth:`ConvexHullRegion.contains` is the reference that test is held to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components as _cc
from scipy.spatial import ConvexHull as _ConvexHull


class Mesh:
    """Triangle mesh with optional per-vertex uint8 colors."""

    def __init__(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        vertex_colors: Optional[np.ndarray] = None,
    ):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int64).reshape(-1, 3)
        self.vertex_colors = (
            None if vertex_colors is None else np.asarray(vertex_colors)
        )

    # -- geometry ----------------------------------------------------------

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        a = v[self.faces[:, 1]] - v[self.faces[:, 0]]
        b = v[self.faces[:, 2]] - v[self.faces[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)

    @property
    def area(self) -> float:
        return float(self.face_areas.sum())

    def update_faces(self, keep_mask: np.ndarray) -> None:
        """Keep only faces where mask is True; drop unreferenced vertices."""
        self.faces = self.faces[np.asarray(keep_mask, bool)]
        self._drop_unreferenced()

    def _drop_unreferenced(self) -> None:
        used = np.unique(self.faces)
        remap = -np.ones(len(self.vertices), np.int64)
        remap[used] = np.arange(len(used))
        self.vertices = self.vertices[used]
        if self.vertex_colors is not None and len(self.vertex_colors):
            self.vertex_colors = self.vertex_colors[used]
        self.faces = remap[self.faces]

    def face_components(self):
        """(labels [F], ncomp): connected components over shared edges.
        Label-based so area filtering never materializes per-component
        meshes — a 256^3 early-map surface can have thousands of noise
        components, and building each as a full Mesh is minutes of work."""
        if len(self.faces) == 0:
            return np.zeros((0,), np.int64), 0
        edges = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]]
        )
        edges = np.sort(edges, axis=1)
        # faces sharing an edge are connected: build face-face adjacency via
        # sorted unique edges
        key = edges[:, 0] * (len(self.vertices) + 1) + edges[:, 1]
        order = np.argsort(key, kind="stable")
        sk = key[order]
        face_of_edge = (order % len(self.faces))
        same = sk[1:] == sk[:-1]
        fa = face_of_edge[:-1][same]
        fb = face_of_edge[1:][same]
        n = len(self.faces)
        graph = coo_matrix(
            (np.ones(len(fa)), (fa, fb)), shape=(n, n)
        )
        ncomp, labels = _cc(graph, directed=False)
        return labels, ncomp

    def split(self) -> List["Mesh"]:
        """Connected components by shared edges (trimesh.split
        only_watertight=False semantics)."""
        labels, ncomp = self.face_components()
        if ncomp == 0:
            return []
        order = np.argsort(labels, kind="stable")
        sorted_faces = self.faces[order]
        counts = np.bincount(labels, minlength=ncomp)
        out = []
        start = 0
        for c in range(ncomp):
            f = sorted_faces[start : start + counts[c]]
            start += counts[c]
            used = np.unique(f)
            out.append(
                Mesh(
                    self.vertices[used],
                    np.searchsorted(used, f),
                    None if self.vertex_colors is None
                    else self.vertex_colors[used],
                )
            )
        return out

    def sample_surface(self, n: int, rng=None) -> np.ndarray:
        """Area-weighted uniform surface samples [n, 3]."""
        rng = rng or np.random.default_rng()
        areas = self.face_areas
        if areas.sum() == 0 or len(self.faces) == 0:
            return np.zeros((0, 3))
        fidx = rng.choice(len(self.faces), size=n, p=areas / areas.sum())
        r1 = np.sqrt(rng.random(n))
        r2 = rng.random(n)
        f = self.faces[fidx]
        v0, v1, v2 = (self.vertices[f[:, k]] for k in range(3))
        return (1 - r1)[:, None] * v0 + (r1 * (1 - r2))[:, None] * v1 + (
            r1 * r2
        )[:, None] * v2

    # -- IO ----------------------------------------------------------------

    def export(self, path: str) -> None:
        """Binary-little-endian PLY with optional vertex colors."""
        has_color = self.vertex_colors is not None and len(self.vertex_colors)
        with open(path, "wb") as f:
            header = ["ply", "format binary_little_endian 1.0"]
            header.append(f"element vertex {len(self.vertices)}")
            header += ["property float x", "property float y", "property float z"]
            if has_color:
                header += [
                    "property uchar red",
                    "property uchar green",
                    "property uchar blue",
                ]
            header.append(f"element face {len(self.faces)}")
            header.append("property list uchar int vertex_indices")
            header.append("end_header")
            f.write(("\n".join(header) + "\n").encode())
            v = self.vertices.astype("<f4")
            if has_color:
                c = self.vertex_colors.astype(np.uint8)
                rec = np.zeros(
                    len(v),
                    dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")],
                )
                rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
                rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
                f.write(rec.tobytes())
            else:
                f.write(np.ascontiguousarray(v).tobytes())
            frec = np.zeros(
                len(self.faces),
                dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")],
            )
            frec["n"] = 3
            frec["a"], frec["b"], frec["c"] = (
                self.faces[:, 0], self.faces[:, 1], self.faces[:, 2],
            )
            f.write(frec.tobytes())

    @staticmethod
    def load(path: str) -> "Mesh":
        """Load the PLY files written by :meth:`export` (binary LE) and simple
        ascii PLYs."""
        with open(path, "rb") as f:
            data = f.read()
        header_end = data.index(b"end_header\n") + len(b"end_header\n")
        header = data[:header_end].decode().splitlines()
        n_vert = n_face = 0
        props: List[str] = []
        binary = True
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                binary = "binary" in parts[1]
            elif parts[0] == "element":
                cur = parts[1]
                if cur == "vertex":
                    n_vert = int(parts[2])
                else:
                    n_face = int(parts[2])
            elif parts[0] == "property" and cur == "vertex":
                props.append(parts[-1])
        has_color = "red" in props
        body = data[header_end:]
        if binary:
            vdt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if has_color:
                vdt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            vrec = np.frombuffer(body, dtype=vdt, count=n_vert)
            off = vrec.itemsize * n_vert
            fdt = [("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")]
            frec = np.frombuffer(body[off:], dtype=fdt, count=n_face)
            verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], -1).astype(np.float64)
            faces = np.stack([frec["a"], frec["b"], frec["c"]], -1).astype(np.int64)
            colors = (
                np.stack([vrec["r"], vrec["g"], vrec["b"]], -1) if has_color else None
            )
        else:
            lines = body.decode().splitlines()
            vl = lines[:n_vert]
            fl = lines[n_vert : n_vert + n_face]
            va = np.array([list(map(float, ln.split())) for ln in vl])
            verts = va[:, :3]
            colors = va[:, 3:6].astype(np.uint8) if va.shape[1] >= 6 else None
            faces = np.array(
                [list(map(int, ln.split()))[1:4] for ln in fl], np.int64
            )
        return Mesh(verts, faces, colors)


def concatenate(meshes: Sequence[Mesh]) -> Mesh:
    if not meshes:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    vs, fs, cs = [], [], []
    off = 0
    any_color = any(m.vertex_colors is not None for m in meshes)
    for m in meshes:
        vs.append(m.vertices)
        fs.append(m.faces + off)
        if any_color:
            cs.append(
                m.vertex_colors
                if m.vertex_colors is not None
                else np.zeros((len(m.vertices), 3), np.uint8)
            )
        off += len(m.vertices)
    return Mesh(
        np.concatenate(vs), np.concatenate(fs),
        np.concatenate(cs) if any_color else None,
    )


class ConvexHullRegion:
    """Convex hull with fast inside tests (replaces trimesh
    ``mesh_bound.contains`` on the reference's hull, src/utils/Mesher.py:426)."""

    def __init__(self, points: np.ndarray, scale: float = 1.0):
        hull = _ConvexHull(np.asarray(points, np.float64))
        self.center = points[hull.vertices].mean(axis=0)
        verts = points[hull.vertices]
        if scale != 1.0:
            verts = self.center + (verts - self.center) * scale
            hull = _ConvexHull(verts)
            self.hull = hull
        else:
            self.hull = hull
        self.equations = self.hull.equations  # [F, 4] (normal, offset)
        # half-space tests run in float32; a fixed 1e-9 tolerance is below
        # f32 resolution at meter scale, so boundary points could flip
        # inside/outside — scale the tolerance with the hull extent instead
        extent = float(np.ptp(self.hull.points, axis=0).max())
        self.tol = 1e-5 * max(extent, 1.0)

    def contains(self, pts: np.ndarray, tol: Optional[float] = None) -> np.ndarray:
        """Chunked half-space test. A hull of back-projected depth maps can
        have thousands of facets; an unchunked [N, F] distance matrix at the
        mesher's 256^3 query size would be hundreds of GB."""
        if tol is None:
            tol = self.tol
        pts = np.asarray(pts, np.float32)
        eq = self.equations.astype(np.float32)
        n = len(pts)
        out = np.empty(n, bool)
        chunk = max(1, (1 << 26) // max(1, len(eq)))  # ~256 MB working set
        for i in range(0, n, chunk):
            d = pts[i : i + chunk] @ eq[:, :3].T + eq[:, 3]
            out[i : i + chunk] = np.all(d <= tol, axis=1)
        return out

    def as_mesh(self) -> Mesh:
        return Mesh(self.hull.points, self.hull.simplices)
