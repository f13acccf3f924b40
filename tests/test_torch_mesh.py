"""The port's mesh layer against the JAX package's, on the CPU: marching
tetrahedra (``mesh/marching.py``, torch ops), the mesh toolkit and its PLY
bytes (``mesh/trimesh_lite.py``), the depth rasterizer (``mesh/raster.py``)
and the analytic room mesh (``data/synthetic.py::scene_gt_mesh``).

Tolerances: marching gives the JAX function's faces exactly and its vertices
to float32 rounding (the same float32 fractions and float64 positions, so in
practice bitwise); the numpy copies are held bitwise."""

import numpy as np
import pytest
import torch

from evennicer_slam_tpu.data.synthetic import scene_gt_mesh as j_scene_gt_mesh
from evennicer_slam_tpu.mesh.marching import marching_cubes as j_marching_cubes
from evennicer_slam_tpu.mesh.raster import rasterize_depth as j_rasterize_depth
from evennicer_slam_tpu.mesh.trimesh_lite import ConvexHullRegion as JHull
from evennicer_slam_tpu.mesh.trimesh_lite import Mesh as JMesh
from evennicer_slam_tpu_torch.data.synthetic import scene_gt_mesh
from evennicer_slam_tpu_torch.mesh.marching import marching_cubes
from evennicer_slam_tpu_torch.mesh.raster import rasterize_depth
from evennicer_slam_tpu_torch.mesh.trimesh_lite import ConvexHullRegion, Mesh, concatenate

from torch_parity import cap_threads

cap_threads()
BOUND = np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)


def sphere_volume(n=32, r=0.6):
    lin = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    return r - np.sqrt(X**2 + Y**2 + Z**2), lin


def march(vol, level=0.0, spacing=(1.0, 1.0, 1.0)):
    v, f = marching_cubes(torch.as_tensor(vol), level=level, spacing=spacing)
    assert v.dtype == torch.float32 and f.dtype == torch.int64
    return v.numpy(), f.numpy()


# ---- marching against the JAX function --------------------------------------------

VOLUMES = {
    "sphere": lambda: (sphere_volume(32)[0], 0.0, (0.0645, 0.0645, 0.0645)),
    "sphere_level": lambda: (sphere_volume(48)[0], 0.1, (0.1, 0.2, 0.05)),
    "random_12x14x10": lambda: (np.random.default_rng(0).normal(size=(12, 14, 10)), 0.0,
                                (0.1, 0.2, 0.05)),
    "random_f32_20x9x17": lambda: (
        np.random.default_rng(1).normal(size=(20, 9, 17)).astype(np.float32), 0.3,
        (1.0, 1.0, 1.0)),
    "random_smooth_24": lambda: (
        np.cumsum(np.random.default_rng(2).normal(size=(24, 24, 24)), axis=0) * 0.1, 0.0,
        (0.016, 0.016, 0.016)),
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_gives_the_jax_faces_and_vertices(name):
    vol, level, spacing = VOLUMES[name]()
    vj, fj = j_marching_cubes(vol, level=level, spacing=spacing)
    vt, ft = march(vol, level, spacing)
    assert len(fj) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=2 ** -23, atol=0)


def test_marching_empty_and_degenerate_volumes():
    for vol in (np.full((8, 8, 8), -1.0), np.full((8, 8, 8), 1.0), np.zeros((1, 5, 5))):
        v, f = march(vol)
        assert v.shape == (0, 3) and f.shape == (0, 3)


# ---- the properties of tests/test_mesh.py::TestMarching, on the port ---------------

def _sphere_surface():
    vol, lin = sphere_volume()
    sp = lin[1] - lin[0]
    verts, faces = march(vol, spacing=(sp, sp, sp))
    verts = verts + lin[0]
    assert len(verts) > 200 and len(faces) > 200
    radii = np.linalg.norm(verts, axis=1)
    assert np.abs(radii - 0.6).max() < sp * 1.5
    assert np.abs(radii - 0.6).mean() < sp * 0.3


def _empty_and_full():
    assert len(march(np.full((8, 8, 8), -1.0))[0]) == 0
    assert len(march(np.full((8, 8, 8), 1.0))[0]) == 0


def _face_indices_valid():
    verts, faces = march(sphere_volume(16)[0])
    assert faces.max() < len(verts) and faces.min() >= 0


def _consistent_outward_winding():
    vol, lin = sphere_volume(32)
    sp = lin[1] - lin[0]
    verts, faces = march(vol, spacing=(sp, sp, sp))
    t = (verts + lin[0]).astype(np.float64)[faces]
    fn = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    assert (np.einsum("ij,ij->i", fn, t.mean(1)) > 0).all()
    signed_vol = np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6.0
    true = 4.0 / 3.0 * np.pi * 0.6**3
    assert abs(signed_vol - true) / true < 0.05


def _closed_surface_area():
    vol, lin = sphere_volume(48)
    sp = lin[1] - lin[0]
    m = Mesh(*march(vol, spacing=(sp, sp, sp)))
    assert abs(m.area - 4 * np.pi * 0.36) / (4 * np.pi * 0.36) < 0.05


def _conforming_across_cells():
    vol, lin = sphere_volume(48)
    sp = lin[1] - lin[0]
    verts, faces = march(vol, spacing=(sp, sp, sp))
    assert Mesh(verts, faces).face_components()[1] == 1
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                    axis=1)
    _, counts = np.unique(edges[:, 0] * (len(verts) + 1) + edges[:, 1], return_counts=True)
    assert (counts == 2).all(), "surface must be watertight (2 faces an edge)"


def _two_blobs_two_components():
    lin = np.linspace(-1, 1, 48)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = np.maximum(0.25 - np.sqrt((X - 0.5) ** 2 + Y**2 + Z**2),
                     0.25 - np.sqrt((X + 0.5) ** 2 + Y**2 + Z**2))
    assert Mesh(*march(vol)).face_components()[1] == 2


MARCHING_PROPERTIES = {
    "sphere_surface": _sphere_surface,
    "empty_and_full": _empty_and_full,
    "face_indices_valid": _face_indices_valid,
    "consistent_outward_winding": _consistent_outward_winding,
    "closed_surface_area": _closed_surface_area,
    "conforming_across_cells": _conforming_across_cells,
    "two_blobs_two_components": _two_blobs_two_components,
}


@pytest.mark.parametrize("prop", sorted(MARCHING_PROPERTIES))
def test_marching_properties(prop):
    MARCHING_PROPERTIES[prop]()


# ---- the mesh toolkit ---------------------------------------------------------------

def _two_triangles(cls):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5], [6, 5, 5], [5, 6, 5], [6, 6, 5]],
                 float)
    return cls(v, np.array([[0, 1, 2], [3, 4, 5], [4, 6, 5]]))


def test_mesh_operations_match_the_jax_toolkit():
    m, jm = _two_triangles(Mesh), _two_triangles(JMesh)
    np.testing.assert_array_equal(m.face_areas, jm.face_areas)
    labels, n = m.face_components()
    jlabels, jn = jm.face_components()
    assert n == jn == 2 and np.array_equal(labels, jlabels)
    comps, jcomps = m.split(), jm.split()
    assert [c.area for c in comps] == [c.area for c in jcomps]
    for c, jc in zip(comps, jcomps):
        np.testing.assert_array_equal(c.vertices, jc.vertices)
        np.testing.assert_array_equal(c.faces, jc.faces)
    assert len(concatenate(comps).faces) == 3
    pts = m.sample_surface(500, np.random.default_rng(0))
    np.testing.assert_array_equal(pts, jm.sample_surface(500, np.random.default_rng(0)))
    keep = np.array([True, False, True])
    m.update_faces(keep)
    jm.update_faces(keep)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.faces, jm.faces)


@pytest.mark.parametrize("colored", [False, True])
def test_ply_bytes_equal_the_jax_export(tmp_path, colored):
    vol, lin = sphere_volume(20)
    v, f = march(vol, spacing=(0.1, 0.1, 0.1))
    rng = np.random.default_rng(3)
    c = rng.integers(0, 256, (len(v), 3)).astype(np.uint8) if colored else None
    Mesh(v + 0.25, f, c).export(str(tmp_path / "port.ply"))
    JMesh(v + 0.25, f, c).export(str(tmp_path / "jax.ply"))
    a, b = (tmp_path / "port.ply").read_bytes(), (tmp_path / "jax.ply").read_bytes()
    assert a == b
    back = Mesh.load(str(tmp_path / "jax.ply"))
    jback = JMesh.load(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(back.vertices, jback.vertices)
    np.testing.assert_array_equal(back.faces, f)
    if colored:
        np.testing.assert_array_equal(back.vertex_colors, c)


def test_ascii_ply_loads(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                 "property float y\nproperty float z\nelement face 1\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    m = Mesh.load(str(p))
    assert m.faces.tolist() == [[0, 1, 2]] and abs(m.area - 0.5) < 1e-12


@pytest.mark.parametrize("scale", [1.0, 1.02])
def test_hull_contains_equals_the_jax_hull(scale):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(400, 3)) * np.array([2.0, 1.5, 1.0])
    q = rng.normal(size=(20000, 3)) * 1.5
    hull, jhull = ConvexHullRegion(pts, scale=scale), JHull(pts, scale=scale)
    np.testing.assert_array_equal(hull.equations, jhull.equations)
    assert hull.tol == jhull.tol
    got = hull.contains(q)
    np.testing.assert_array_equal(got, jhull.contains(q))
    assert 0.05 < got.mean() < 0.95
    np.testing.assert_array_equal(hull.as_mesh().faces, jhull.as_mesh().faces)


# ---- the rasterizer and the analytic room --------------------------------------------

def test_rasterize_depth_equals_the_jax_rasterizer():
    m = scene_gt_mesh(BOUND, furnished=True)
    rng = np.random.default_rng(5)
    for _ in range(3):
        w2c = np.eye(4)
        th = rng.uniform(-np.pi, np.pi)
        w2c[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                [-np.sin(th), 0, np.cos(th)]])
        w2c[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        args = (w2c, 60, 80, 50.0, 50.0, 39.5, 29.5)
        d = rasterize_depth(m.vertices, m.faces, *args)
        np.testing.assert_array_equal(d, j_rasterize_depth(m.vertices, m.faces, *args))
        assert (d > 0).mean() > 0.9  # inside the room every ray meets a surface


@pytest.mark.parametrize("furnished", [False, True])
def test_scene_gt_mesh_is_the_jax_mesh(furnished):
    m = scene_gt_mesh(BOUND, furnished=furnished)
    jm = j_scene_gt_mesh(BOUND, furnished=furnished)
    assert isinstance(m, Mesh)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.faces, jm.faces)
    assert m.vertex_colors is None and jm.vertex_colors is None
    assert len(m.faces) == (12 if not furnished else len(jm.faces)) and len(m.faces) >= 12
