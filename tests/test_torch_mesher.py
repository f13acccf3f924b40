"""The port's ``Mesher`` (``mesh/mesher.py``) on the CPU: the analytic-sphere
tests of ``tests/test_mesher_unit.py`` through the port, and the port against
the JAX package's ``Mesher`` on the same random map (carried across by
``convert``), the same keyframes and the same lattice.

Tolerances, set from the float32 arithmetic the two frameworks share (both
decode in float32 with their own summation orders; measured on this map:
logits 2.3e-6 apart at most, no hull-mask disagreement, vertices 1.1e-5 m):
- swept logits: 1e-4 absolute inside the hull; hull masks: at most
  ``MASK_SHARE`` of the lattice points disagree (a point within float32
  rounding of a hull plane);
- meshes: the same face count, every vertex of each within 1e-4 m of the
  other's nearest vertex, vertex colours within one 8-bit level.
The lattice has 64,000 points and the chunks 16,384, so the last chunk is
a short one (trimmed in the port, padded in the JAX package).

iMAP's meshing (``configs/imap.yaml``: level 10 on raw density, colours
rendered along the vertex normals) on a random iMAP map against the JAX
``Mesher``: the same faces, the colours within one 8-bit level."""

import os

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import evennicer_slam_tpu_torch.mesh.mesher as mesher_mod
from evennicer_slam_tpu.mesh.mesher import Mesher as JMesher
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.render.renderer import RenderSettings as JRenderSettings
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.config import load_config
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames
from evennicer_slam_tpu_torch.mesh.mesher import Mesher
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam.camera import Camera

from torch_parity import cap_threads, jax_to_np

cap_threads()

ROOT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "nice_slam.yaml")
R_SPHERE = 0.5
BOUND = np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)
GRID_LEN = {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2}
RESOLUTION = 40
BATCH = 16384
LOGIT_ATOL = 1e-4
MASK_SHARE = 1e-4
VERTEX_ATOL = 1e-4  # metres
CAM = Camera(36, 48, 30.0, 30.0, 23.5, 17.5)


# ---- the analytic sphere (tests/test_mesher_unit.py through the port) --------------

def _sphere_eval_points(decoders, grids, p, bound, stage, settings):
    """occ logit = (R - |p|) * 10; rgb = constant. Shape [N, 4]."""
    occ = (R_SPHERE - torch.linalg.norm(p, dim=-1)) * 10.0
    return torch.cat([torch.full((p.shape[0], 3), 0.5), occ[:, None]], dim=-1)


def _look_at_keyframe(origin, cam):
    """c2w looking from ``origin`` at the world origin (-z forward) and the
    analytic depth map of the sphere from that pose."""
    origin = np.asarray(origin, np.float64)
    fwd = -origin / np.linalg.norm(origin)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, origin
    jj, ii = np.meshgrid(np.arange(cam.H), np.arange(cam.W), indexing="ij")
    dirs = np.stack([(ii - cam.cx) / cam.fx, -(jj - cam.cy) / cam.fy,
                     -np.ones_like(ii, np.float64)], -1)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    b = (rd * origin[None, None]).sum(-1)
    disc = b * b - ((origin * origin).sum() - R_SPHERE**2)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return c2w, np.where((disc > 0) & (t > 0), t, 0.0).astype(np.float32)


@pytest.fixture()
def sphere_mesher(monkeypatch):
    monkeypatch.setattr(mesher_mod, "eval_points", _sphere_eval_points)
    cfg = {
        "scale": 1.0, "verbose": False,
        "meshing": {"resolution": 64, "level_set": 0, "clean_mesh_bound_scale": 1.02,
                    "remove_small_geometry_threshold": 0.2,
                    "color_mesh_extraction_method": "direct_point_query",
                    "get_largest_components": False, "depth_test": False,
                    "clean_mesh": True},
        "mapping": {"marching_cubes_bound": [[-1, 1], [-1, 1], [-1, 1]]},
    }
    cam = Camera(H=60, W=80, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    bound = np.array([[-1, 1], [-1, 1], [-1, 1]], np.float32)
    return Mesher(cfg, cam, settings=None, bound=bound, points_batch_size=65536, device="cpu")


# ---- iMAP: density at level 10, colours rendered along the vertex normals --------------

IMAP_RESOLUTION = 24
IMAP_LEVEL_OFFSET = 9.4  # the density's bias: the random field crosses 10 in places


@pytest.fixture(scope="module")
def imap_both():
    """Both packages' Mesher at configs/imap.yaml's meshing (level_set 10 on
    raw density, render_ray_along_normal colours) over a random iMAP map
    whose density bias is IMAP_LEVEL_OFFSET (2 % of the lattice above 10)."""
    from evennicer_slam_tpu.render.renderer import Renderer as JRenderer

    from evennicer_slam_tpu_torch.config import default_config_path

    cfg = load_config(default_config_path(False))
    cfg["mapping"]["marching_cubes_bound"] = BOUND.tolist()
    cfg["meshing"]["resolution"] = IMAP_RESOLUTION
    cfg["scale"] = 1.0
    assert cfg["meshing"]["level_set"] == 10 and not cfg["occupancy"]
    assert cfg["meshing"]["color_mesh_extraction_method"] == "render_ray_along_normal"
    frames = list(synthetic_frames(n_frames=12, H=CAM.H, W=CAM.W, fx=CAM.fx, fy=CAM.fy,
                                   bound=BOUND, traj_step=0.1, furnished=True))
    kfs = [{"est_c2w": f.c2w.copy(), "depth": f.depth.copy()} for f in frames[::3]]
    dj = jd.init_imap_decoder(jax.random.PRNGKey(1))
    dj["imap"]["out_b"] = dj["imap"]["out_b"].at[3].set(IMAP_LEVEL_OFFSET)
    js = JRenderSettings.from_cfg(cfg, nice=False)
    jm = JMesher(cfg, JCamera(*CAM), js, BOUND, points_batch_size=BATCH,
                 renderer=JRenderer(CAM.H, CAM.W, CAM.fx, CAM.fy, CAM.cx, CAM.cy, BOUND, js))
    tm = Mesher(cfg, CAM, RenderSettings.from_cfg(cfg, nice=False), BOUND,
                points_batch_size=BATCH, device="cpu")
    dt = convert.decoders_from_numpy(jax_to_np(dj), device="cpu")
    return {"jax": (jm, dj), "port": (tm, dt), "kfs": kfs,
            "est": np.stack([f.c2w for f in frames])}


def _imap_meshes(imap_both, tmp_path):
    (tm, dt), (jm, dj) = imap_both["port"], imap_both["jax"]
    args = (imap_both["kfs"], imap_both["est"], len(imap_both["est"]) - 1)
    return (tm.get_mesh(str(tmp_path / "port.ply"), {}, dt, *args),
            jm.get_mesh(str(tmp_path / "jax.ply"), {}, dj, *args))


def test_normal_ray_colours_equal_the_jax_mesher(imap_both, tmp_path):
    """The same faces at level 10 on density, vertices within VERTEX_ATOL
    (measured 7.2e-7 m), and the vertex colours rendered along the inward
    normals within one 8-bit level (measured: equal)."""
    port, ref = _imap_meshes(imap_both, tmp_path)
    assert port is not None and ref is not None
    assert len(port.faces) == len(ref.faces) > 1000
    np.testing.assert_array_equal(port.faces, ref.faces)
    assert meshes_apart(port, ref) <= VERTEX_ATOL
    diff = np.abs(port.vertex_colors.astype(int) - ref.vertex_colors.astype(int))
    assert diff.max() <= 1
    assert imap_both["port"][0].last_stats["color_s"] > 0


def test_outward_normal_rays_fail_the_colour_comparison(imap_both, tmp_path, monkeypatch):
    """Planted fault: the rays cast along the outward normal, from outside
    the surface: 42 % of the vertices then differ by more than one level
    (none when sound)."""
    real = mesher_mod._vertex_normals
    monkeypatch.setattr(mesher_mod, "_vertex_normals", lambda mesh: -real(mesh))
    port, ref = _imap_meshes(imap_both, tmp_path)
    diff = np.abs(port.vertex_colors.astype(int) - ref.vertex_colors.astype(int))
    assert (diff > 1).mean() > 0.2


def test_vertex_normals_equal_the_jax_function():
    from evennicer_slam_tpu.mesh.mesher import _vertex_normals as j_vertex_normals

    rng = np.random.default_rng(6)
    v = rng.normal(size=(50, 3))
    faces = rng.integers(0, 50, size=(120, 3))
    mesh = Mesh(v, faces)
    got = mesher_mod._vertex_normals(mesh)
    np.testing.assert_array_equal(got, j_vertex_normals(mesh))
    used = np.unique(faces)
    np.testing.assert_allclose(np.linalg.norm(got[used], axis=1), 1.0, rtol=1e-12)


def test_get_mesh_full_pipeline(sphere_mesher, tmp_path):
    """Keyframes orbiting the sphere see all of it: the sphere must survive
    the component filter as one component of the right area."""
    kfs = []
    for ang in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        c2w, depth = _look_at_keyframe([1.6 * np.cos(ang), 1.6 * np.sin(ang), 0.35],
                                       sphere_mesher.cam)
        kfs.append({"est_c2w": c2w, "depth": depth})
    est = np.stack([k["est_c2w"] for k in kfs])
    out = str(tmp_path / "m.ply")
    mesh = sphere_mesher.get_mesh(out, {}, {}, kfs, est, len(kfs) - 1)
    assert mesh is not None and len(mesh.faces) > 100
    labels, ncomp = mesh.face_components()
    areas = np.bincount(labels, weights=mesh.face_areas, minlength=ncomp)
    cent = mesh.vertices[mesh.faces].mean(axis=1)
    on_sphere = np.abs(np.linalg.norm(cent, axis=1) - R_SPHERE) < 0.08
    true_area = 4 * np.pi * R_SPHERE**2
    assert areas[np.unique(labels[on_sphere])].max() > 0.88 * true_area
    assert abs(mesh.face_areas[on_sphere].sum() - true_area) / true_area < 0.12
    assert np.all(np.abs(mesh.vertex_colors.astype(int) - 127) <= 1)
    assert len(Mesh.load(out).faces) == len(mesh.faces)
    stats = sphere_mesher.last_stats
    assert stats["faces"] == len(mesh.faces) and stats["vertices"] == len(mesh.vertices)
    assert {"sweep_s", "march_s", "clean_s", "color_s", "export_s", "total_s"} <= set(stats)


def test_get_mesh_seen_clean_removes_unobserved(sphere_mesher, tmp_path):
    """Keyframes on one side only: the far hemisphere is cleaned away."""
    kfs = []
    for ang in (-0.3, 0.0, 0.3):
        c2w, depth = _look_at_keyframe([1.6 * np.cos(ang), 1.6 * np.sin(ang), 0.0],
                                       sphere_mesher.cam)
        kfs.append({"est_c2w": c2w, "depth": depth})
    est = np.stack([k["est_c2w"] for k in kfs])
    mesh = sphere_mesher.get_mesh(str(tmp_path / "m.ply"), {}, {}, kfs, est, 2)
    assert mesh is not None and len(mesh.vertices) > 0
    assert mesh.vertices[:, 0].max() > 0.4
    assert (mesh.vertices[:, 0] < -0.45).sum() == 0


# ---- the device hull test -------------------------------------------------------------

def test_hull_inside_is_the_elementwise_float32_test_in_plane_blocks():
    """``hull_inside`` is three float32 multiply-adds a plane (no matrix
    product, so no TF32 on the card), over blocks of ``HULL_PLANE_BLOCK``
    planes: it equals the same arithmetic in numpy bit for bit, and the
    host ``ConvexHullRegion.contains`` (a float32 matrix product) except
    within float32 rounding of a plane. The hull has more facets than one
    block."""
    rng = np.random.default_rng(5)
    d = rng.normal(size=(600, 3))
    hull = mesher_mod.ConvexHullRegion(d / np.linalg.norm(d, axis=1, keepdims=True))
    eq = hull.equations.astype(np.float32)
    assert len(eq) > 2 * mesher_mod.HULL_PLANE_BLOCK
    p = (rng.uniform(-1.05, 1.05, size=(20000, 3))).astype(np.float32)
    tol = np.float32(hull.tol)
    got = mesher_mod.hull_inside(torch.from_numpy(p), torch.from_numpy(eq), float(tol)).numpy()
    dist = (((p[:, 0:1] * eq[:, 0] + p[:, 1:2] * eq[:, 1]) + p[:, 2:3] * eq[:, 2]) + eq[:, 3])
    np.testing.assert_array_equal(got, (dist <= tol).all(axis=1))
    host = hull.contains(p)
    assert 0.2 < got.mean() < 0.8
    margin = np.abs(dist).min(axis=1)
    assert (got == host)[margin > 1e-5].all()


# ---- the port's Mesher against the JAX package's, on one random map -----------------

@pytest.fixture(scope="module")
def both():
    cfg = load_config(ROOT_CONFIG)
    cfg["mapping"]["marching_cubes_bound"] = BOUND.tolist()
    cfg["meshing"]["resolution"] = RESOLUTION
    frames = list(synthetic_frames(n_frames=12, H=CAM.H, W=CAM.W, fx=CAM.fx, fy=CAM.fy,
                                   bound=BOUND, traj_step=0.1, furnished=True))
    kfs = [{"est_c2w": f.c2w.copy(), "depth": f.depth.copy()} for f in frames[::3]]
    est = np.stack([f.c2w for f in frames])
    gj = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, 32, True)
    dj = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    gt = convert.grids_from_numpy(jax_to_np(gj), device="cpu")
    dt = convert.decoders_from_numpy(jax_to_np(dj), device="cpu")
    jm = JMesher(cfg, JCamera(*CAM), JRenderSettings.from_cfg(cfg), BOUND,
                 points_batch_size=BATCH)
    tm = Mesher(cfg, CAM, RenderSettings.from_cfg(cfg), BOUND, points_batch_size=BATCH,
                device="cpu")
    return {"jax": (jm, gj, dj), "port": (tm, gt, dt), "kfs": kfs, "est": est}


def sweep_apart(z_port, z_jax):
    """(hull-mask disagreements, largest logit difference inside both)."""
    zt = np.asarray(z_port)
    inside_t, inside_j = zt != 100, z_jax != 100
    both_in = inside_t & inside_j
    return int((inside_t != inside_j).sum()), float(np.abs(zt - z_jax)[both_in].max())


def test_the_sweep_equals_the_jax_sweep(both):
    tm, gt, dt = both["port"]
    jm, gj, dj = both["jax"]
    grid = tm.get_grid_uniform(RESOLUTION)
    hull = tm.get_bound_from_frames(both["kfs"])
    z = tm.masked_occ_sweep(grid["xyz"], hull, gt, dt)
    zj = np.asarray(jm.masked_occ_sweep(grid["xyz"], hull, gj, dj))
    assert z.shape == (RESOLUTION**3,) and z.dtype == torch.float32
    n_masks, logit = sweep_apart(z.numpy(), zj)
    inside = (zj != 100).mean()
    assert 0.05 < inside < 0.95  # the hull cuts the lattice
    assert n_masks <= MASK_SHARE * zj.size and logit <= LOGIT_ATOL
    # the random map crosses its level set inside the hull
    zin = zj[zj != 100]
    assert zin.min() < 0 < zin.max()


def meshes_apart(a: Mesh, b: Mesh) -> float:
    """Symmetric nearest-vertex distance of two meshes, in metres."""
    return max(float(cKDTree(b.vertices).query(a.vertices)[0].max()),
               float(cKDTree(a.vertices).query(b.vertices)[0].max()))


def mesh_both(both, tmp_path, **kw):
    tm, gt, dt = both["port"]
    jm, gj, dj = both["jax"]
    args = (both["kfs"], both["est"], len(both["est"]) - 1)
    port = tm.get_mesh(str(tmp_path / "port.ply"), gt, dt, *args, **kw)
    ref = jm.get_mesh(str(tmp_path / "jax.ply"), gj, dj, *args, **kw)
    return port, ref


def assert_meshes_agree(port, ref):
    assert port is not None and ref is not None
    assert len(port.faces) == len(ref.faces) > 1000
    assert meshes_apart(port, ref) <= VERTEX_ATOL
    np.testing.assert_array_equal(port.faces, ref.faces)
    assert np.abs(port.vertex_colors.astype(int) - ref.vertex_colors.astype(int)).max() <= 1


@pytest.mark.parametrize("branch", [
    {},
    {"get_mask_use_all_frames": True},
    {"clean_mesh": False, "color": False},
], ids=["default", "all_frames", "unclean_uncoloured"])
def test_the_mesh_equals_the_jax_mesh(both, tmp_path, branch):
    port, ref = mesh_both(both, tmp_path, **branch)
    if branch.get("color") is False:
        assert port.vertex_colors is None and ref.vertex_colors is None
        assert len(port.faces) == len(ref.faces) and meshes_apart(port, ref) <= VERTEX_ATOL
    else:
        assert_meshes_agree(port, ref)
    assert (tmp_path / "port.ply").stat().st_size == (tmp_path / "jax.ply").stat().st_size


def test_an_untransposed_volume_fails_the_comparison(both, tmp_path, monkeypatch):
    """Planted fault: the sweep's flat 'xy'-order values reshaped to
    [NX, NY, NZ] without the [1, 0, 2] transpose (x and y swapped)."""
    real = mesher_mod.marching_cubes
    monkeypatch.setattr(mesher_mod, "marching_cubes",
                        lambda vol, **kw: real(vol.permute(1, 0, 2), **kw))
    port, ref = mesh_both(both, tmp_path)
    assert port is not None and ref is not None
    assert len(port.faces) != len(ref.faces) or meshes_apart(port, ref) > 100 * VERTEX_ATOL


def test_the_pipeline_mesher_decodes_through_the_plain_settings(tmp_path):
    """The pipeline's mesher uses the pipeline's own (non-fused) render
    settings and device, as the JAX pipeline's does."""
    from torch_pipeline_parity import tiny_cfg

    from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM

    cfg = tiny_cfg(str(tmp_path / "scene"), 2, events=False)
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, device="cpu")
    m = slam.mesher
    assert m is slam.mesher and m.device == torch.device("cpu")
    assert m.settings == slam.settings and not m.settings.fused_decode
    assert m.points_batch_size == 500000 and m.resolution == cfg["meshing"]["resolution"]
