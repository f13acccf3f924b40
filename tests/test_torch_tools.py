"""The port's offline tools (``evennicer_slam_tpu_torch/tools``) against the
JAX package's on the same inputs, on the CPU: ``eval_ate``, ``eval_recon``
(3-D and 2-D) and ``cull_mesh``, numpy and scipy code in both, so the
results are held equal; and ``validate_synthetic`` run end to end at a tiny
size, printing its JSON records."""

import json
import os

import numpy as np
import pytest

from evennicer_slam_tpu.mesh.trimesh_lite import Mesh as JMesh
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu.tools import cull_mesh as j_cull
from evennicer_slam_tpu.tools import eval_ate as j_ate
from evennicer_slam_tpu.tools import eval_recon as j_recon
from evennicer_slam_tpu_torch import config as tconfig
from evennicer_slam_tpu_torch.mesh.marching import marching_cubes
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.tools import cull_mesh, eval_ate, eval_recon, validate_synthetic

from torch_parity import cap_threads

cap_threads()


def sphere_mesh(r=0.5, n=32, center=(0.0, 0.0, 0.0)):
    lin = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    sp = lin[1] - lin[0]
    v, f = marching_cubes(r - np.sqrt(X**2 + Y**2 + Z**2), spacing=(sp, sp, sp))
    return Mesh(v.numpy() + lin[0] + np.asarray(center), f.numpy())


def random_poses(rng, n):
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        th = rng.uniform(-0.5, 0.5)
        poses[i, :3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        poses[i, :3, 3] = rng.normal(size=3)
    return poses


# ---- eval_ate ----------------------------------------------------------------------

def test_eval_ate_equals_the_jax_tool():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(30, 3))
    rot = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    est = gt @ rot.T + 0.3 + rng.normal(size=(30, 3)) * 0.01
    for a, b in zip(eval_ate.align(est.T, gt.T), j_ate.align(est.T, gt.T)):
        np.testing.assert_array_equal(a, b)
    res = eval_ate.evaluate_ate(est, gt)
    assert res == j_ate.evaluate_ate(est, gt)
    assert 0 < res["absolute_translational_error.rmse"] < 0.05
    poses = random_poses(rng, 6)
    poses[2, 0, 0] = np.inf  # an invalid pose is masked, as for ScanNet
    for a, b in zip(eval_ate.convert_poses(poses, 2.0), j_ate.convert_poses(poses, 2.0)):
        np.testing.assert_array_equal(a, b)


def test_evaluate_checkpoint_equals_the_jax_tool(tmp_path):
    rng = np.random.default_rng(1)
    gt = random_poses(rng, 8).astype(np.float32)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(8, 3)) * 0.02
    path = str(tmp_path / "00005.npz")
    np.savez(path, estimate_c2w_list=est, gt_c2w_list=gt, idx=np.asarray(5))
    res = eval_ate.evaluate_checkpoint(path, scale=1.0, plot=None)
    assert res == j_ate.evaluate_checkpoint(path, scale=1.0, plot=None)
    assert res["compared_pose_pairs"] == 6


def test_eval_ate_main_reads_the_latest_checkpoint(tmp_path, capsys):
    out = tmp_path / "out"
    os.makedirs(out / "ckpts")
    gt = random_poses(np.random.default_rng(2), 4)
    np.savez(str(out / "ckpts" / "00003.npz"), estimate_c2w_list=gt, gt_c2w_list=gt,
             idx=np.asarray(3))
    eval_ate.main([tconfig.default_config_path(True), "--output", str(out), "--no_plot"])
    printed = capsys.readouterr().out
    assert "compared_pose_pairs: 4" in printed and "rmse: " in printed


# ---- eval_recon --------------------------------------------------------------------

@pytest.fixture()
def two_meshes(tmp_path):
    a = sphere_mesh(r=0.5)
    b = sphere_mesh(r=0.5, center=(0.02, -0.01, 0.0))
    pa, pb = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    a.export(pa)
    b.export(pb)
    return pa, pb


@pytest.mark.parametrize("align", [True, False])
def test_calc_3d_metric_equals_the_jax_tool(two_meshes, align):
    pa, pb = two_meshes
    res = eval_recon.calc_3d_metric(pa, pb, n_samples=5000, align=align)
    assert res == j_recon.calc_3d_metric(pa, pb, n_samples=5000, align=align)
    assert res["completion ratio (<5cm %)"] > 90.0


def test_recon_primitives_equal_the_jax_tool():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(500, 3)), rng.normal(size=(700, 3))
    np.testing.assert_array_equal(eval_recon.nn_distances(a, b), j_recon.nn_distances(a, b))
    assert eval_recon.accuracy(a, b) == j_recon.accuracy(a, b)
    assert eval_recon.completion(a, b) == j_recon.completion(a, b)
    assert eval_recon.completion_ratio(a, b, 0.2) == j_recon.completion_ratio(a, b, 0.2)
    np.testing.assert_array_equal(eval_recon.icp_align(a + 0.01, a), j_recon.icp_align(a + 0.01, a))


def test_calc_2d_metric_equals_the_jax_tool(tmp_path):
    a, b = sphere_mesh(r=0.5, n=24), sphere_mesh(r=0.6, n=24)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    a.export(pa)
    b.export(pb)
    res = eval_recon.calc_2d_metric(pa, pb, n_imgs=3, align=False)
    assert res == j_recon.calc_2d_metric(pa, pb, n_imgs=3, align=False)
    assert res["depth L1 (cm)"] > eval_recon.calc_2d_metric(pa, pa, n_imgs=3,
                                                            align=False)["depth L1 (cm)"]
    # {gt}_pc_unseen.npy beside the ground truth rejects every view that sees it
    np.save(pb.replace(".ply", "_pc_unseen.npy"), b.sample_surface(20000,
                                                                   np.random.default_rng(0)))
    res_u = eval_recon.calc_2d_metric(pa, pb, n_imgs=2, align=False)
    assert np.isnan(res_u["depth L1 (cm)"]) == np.isnan(
        j_recon.calc_2d_metric(pa, pb, n_imgs=2, align=False)["depth L1 (cm)"])


def test_eval_recon_main_prints_both_metrics(two_meshes, capsys):
    pa, pb = two_meshes
    eval_recon.main(["--rec_mesh", pa, "--gt_mesh", pb, "-3d", "-2d", "--n_imgs", "1"])
    printed = capsys.readouterr().out
    assert "accuracy (cm)" in printed and "depth L1 (cm)" in printed


# ---- cull_mesh -----------------------------------------------------------------------

def test_cull_mesh_equals_the_jax_tool(tmp_path):
    m = sphere_mesh(r=0.3, center=(0, 0, -1.0))
    m.vertex_colors = np.full((len(m.vertices), 3), 7, np.uint8)
    cam = Camera(60, 80, 60.0, 60.0, 39.5, 29.5)
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[:, 0, 3] = (0.9, 1.0)  # the sphere partly outside both frusta
    out = cull_mesh.cull_mesh(m, poses, cam)
    jm = JMesh(m.vertices, m.faces, m.vertex_colors)
    ref = j_cull.cull_mesh(jm, poses, JCamera(*cam))
    np.testing.assert_array_equal(out.vertices, ref.vertices)
    np.testing.assert_array_equal(out.faces, ref.faces)
    np.testing.assert_array_equal(out.vertex_colors, ref.vertex_colors)
    assert 0 < len(out.faces) < len(m.faces)  # faces outside both frusta are culled

    traj = tmp_path / "traj.txt"
    traj.write_text("\n".join(" ".join(map(str, p.reshape(-1))) for p in poses) + "\n")
    np.testing.assert_array_equal(cull_mesh.load_traj(str(traj)), j_cull.load_traj(str(traj)))
    src = str(tmp_path / "m.ply")
    m.export(src)
    cull_mesh.main(["--input_mesh", src, "--traj", str(traj), "--H", "60", "--W", "80",
                    "--fx", "60", "--fy", "60", "--cx", "39.5", "--cy", "29.5"])
    assert os.path.exists(src.replace(".ply", "_culled.ply"))


# ---- validate_synthetic, end to end ----------------------------------------------------

def test_validate_synthetic_prints_its_records(tmp_path, monkeypatch, capsys):
    """The whole tool on the CPU at a tiny size: six 36x48 frames of the
    furnished room, the shipped configuration with short mapping and
    tracking loops and a 32^3 meshing lattice (set here, through the loader
    the tool calls)."""
    real_load = tconfig.load_config

    def small_config(path, default_path=None):
        cfg = real_load(path, default_path)
        tconfig.update_recursive(cfg, {
            "mapping": {"iters_first": 10, "iters": 4, "pixels": 120},
            "tracking": {"iters": 3, "pixels": 100, "ignore_edge_W": 4, "ignore_edge_H": 4},
            "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                         "bound_divisible": 0.2},
            "meshing": {"resolution": 32},
        })
        return cfg

    monkeypatch.setattr(tconfig, "load_config", small_config)
    scene = str(tmp_path / "scene")
    validate_synthetic.main(["--frames", "6", "--hw", "36", "48", "--device", "cpu",
                             "--scene", scene, "--n_imgs_2d", "2",
                             "--no_plot"])
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    keys = [k for r in records for k in r]
    assert keys == ["ate_rmse_m", "ate_mean_m", "gt_surface_seen_frac", "recon_3d",
                    "recon_3d_seen_only", "recon_2d"]
    assert np.isfinite(records[0]["ate_rmse_m"])
    assert 0 < records[1]["gt_surface_seen_frac"] < 1
    assert np.isfinite(records[2]["recon_3d"]["accuracy (cm)"])
    assert os.path.exists(os.path.join(scene, "out", "mesh", "final_mesh_eval_rec.ply"))
    assert os.path.exists(os.path.join(scene, "gt_mesh_pc_unseen.npy"))
