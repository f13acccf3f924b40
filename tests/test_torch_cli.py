"""The port's command line (``evennicer_slam_tpu_torch/run.py``) on the CPU:
a tiny scene (36x48, a handful of frames) from a config file to checkpoints,
the final meshes and the trajectory error of the checkpoint; ``--resume``;
``--imap`` and the along-normal mesh colours; ``enable_vis``; ``--viz_port``,
the browser viewer serving the run."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import yaml

from evennicer_slam_tpu_torch import run as port_run
from evennicer_slam_tpu_torch.data.synthetic import make_synthetic_replica
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.tools import viz_server
from evennicer_slam_tpu_torch.tools.eval_ate import evaluate_checkpoint
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger

from torch_parity import cap_threads

cap_threads()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_config(tmp_path, n_frames, **changes):
    frag = make_synthetic_replica(str(tmp_path / "scene"), n_frames=n_frames, H=36, W=48,
                                  fx=60.0, fy=60.0, traj_step=0.02, reuse_if_current=True)
    frag["dataset"] = "replica"
    cfg = dict(frag)
    cfg["inherit_from"] = os.path.join(ROOT, "configs", "nice_slam.yaml")
    cfg.update({
        "coarse": True, "enable_vis": False, "verbose": False,
        "mapping": {**frag["mapping"], "iters_first": 8, "iters": 4, "every_frame": 2,
                    "pixels": 80, "mapping_window_size": 3, "keyframe_every": 2,
                    "mesh_freq": 2, "ckpt_freq": 2},
        "tracking": {"iters": 2, "pixels": 40, "ignore_edge_W": 4, "ignore_edge_H": 4},
        "meshing": {"eval_rec": True, "resolution": 24},
        "grid_len": {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2,
                     "bound_divisible": 0.2},
    })
    cfg.update(changes)
    path = str(tmp_path / "scene.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_cli_writes_checkpoints_meshes_and_a_finite_ate(tmp_path):
    cfg = write_config(tmp_path, 5)
    out = str(tmp_path / "out")
    est = port_run.main([cfg, "--output", out, "--device", "cpu"])
    assert est.shape == (5, 4, 4) and np.isfinite(est).all()
    ckpts = sorted(f for f in os.listdir(os.path.join(out, "ckpts")) if f.endswith(".npz"))
    assert ckpts == ["00002.npz", "00004.npz"]  # every ckpt_freq mapped frames, and the last
    meshes = sorted(os.listdir(os.path.join(out, "mesh")))
    # a mesh every mesh_freq mapped frames but the last, then the two final ones
    assert meshes == ["00002_mesh.ply", "final_mesh.ply", "final_mesh_eval_rec.ply"]
    for name in meshes:
        m = Mesh.load(os.path.join(out, "mesh", name))
        assert len(m.faces) > 0 and m.vertex_colors is not None
    ckpt = CheckpointLogger.latest(os.path.join(out, "ckpts"))
    res = evaluate_checkpoint(ckpt, scale=1.0, plot=None)
    assert res["compared_pose_pairs"] == 5
    assert np.isfinite(res["absolute_translational_error.rmse"])
    plot = str(tmp_path / "ate.png")
    evaluate_checkpoint(ckpt, scale=1.0, plot=plot)
    assert os.path.getsize(plot) > 0


def test_cli_resume_continues_from_the_latest_checkpoint(tmp_path, capsys):
    cfg = write_config(tmp_path, 5)
    out = str(tmp_path / "out")
    first = port_run.main([cfg, "--output", out, "--device", "cpu", "--end_frame", "3"]).copy()
    assert CheckpointLogger.latest(os.path.join(out, "ckpts")).endswith("00002.npz")
    est = port_run.main([cfg, "--output", out, "--device", "cpu", "--resume"])
    assert "Resumed from" in capsys.readouterr().out
    assert CheckpointLogger.latest(os.path.join(out, "ckpts")).endswith("00004.npz")
    np.testing.assert_array_equal(est[:3], first[:3])  # restored, not re-tracked
    assert np.isfinite(est).all() and not np.array_equal(est[3], np.zeros((4, 4)))
    assert os.path.exists(os.path.join(out, "mesh", "final_mesh.ply"))


@pytest.mark.parametrize("flags,changes,match", [
    (["--viz_port", "0"], {}, "ROADMAP Queue 1 item 4"),
    ([], {"enable_vis": True}, "enable_vis: false"),
], ids=["viz_port", "enable_vis"])
def test_unported_options_raise_before_any_frame(tmp_path, monkeypatch, flags, changes, match):
    """Both options this test once saw refused run to their end now.
    ``--viz_port`` (the viewer, ROADMAP Queue 1 item 4) serves the output
    directory while the run goes on: after a 3-frame run ``/state.json``
    reports the last frame and ``/mesh.bin`` the final mesh.
    ``enable_vis: true`` writes the tracking panels of frame 2
    (``tracking.vis_freq`` 2 here) and the mapping panels of frame 0."""
    if changes.get("enable_vis"):
        changes = dict(changes, tracking={"vis_freq": 2, "iters": 2, "pixels": 40,
                                          "ignore_edge_W": 4, "ignore_edge_H": 4})
    cfg = write_config(tmp_path, 3, **changes)
    out = str(tmp_path / "out")
    if not changes.get("enable_vis"):
        servers = []
        serve = viz_server.serve

        def kept(*a, **kw):
            servers.append(serve(*a, **kw))
            return servers[-1]

        monkeypatch.setattr(viz_server, "serve", kept)
        est = port_run.main([cfg, "--output", out, "--device", "cpu"] + flags)
        assert np.isfinite(est).all() and len(servers) == 1
        httpd, watcher = servers[0]
        try:
            watcher.refresh()  # the poll thread's next look, now
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            with urllib.request.urlopen(url + "/state.json", timeout=30) as r:
                state = json.loads(r.read())
            assert state["idx"] == 2 and len(state["est"]) == 3
            # the newest of the sorted mesh files
            assert state["mesh_path"] == "final_mesh_eval_rec.ply" and state["n_faces"] > 0
            with urllib.request.urlopen(url + "/mesh.bin", timeout=30) as r:
                assert len(r.read()) > 16 + 40 * state["n_verts"]
        finally:
            httpd.shutdown()
            watcher.stop()
        return
    est = port_run.main([cfg, "--output", out, "--device", "cpu"] + flags)
    assert np.isfinite(est).all()
    assert os.listdir(os.path.join(out, "tracking_vis")) == ["00002_0000.jpg"]
    assert "00000_0000.jpg" in os.listdir(os.path.join(out, "mapping_vis"))


@pytest.mark.parametrize("flags,changes", [
    (["--imap"], {"scale": 1.0}),
    ([], {"meshing": {"resolution": 24,
                      "color_mesh_extraction_method": "render_ray_along_normal"}}),
], ids=["imap", "render_ray_along_normal"])
def test_options_once_refused_run_to_their_end(tmp_path, capsys, flags, changes):
    """``--imap`` and the along-normal mesh colours: a checkpoint of the last
    frame, a coloured ``final_mesh.ply``, and ``eval_ate`` reads the
    checkpoint in the same mode. The iMAP config names no parent, so
    ``configs/imap.yaml`` is its base (``--imap``'s default), at scale 1 as
    ``tests/test_slam.py::test_imap_mode`` has it."""
    from evennicer_slam_tpu_torch.tools import eval_ate

    cfg = write_config(tmp_path, 3, **changes)
    if "--imap" in flags:
        with open(cfg) as f:
            raw = yaml.safe_load(f)
        del raw["inherit_from"]
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
    out = str(tmp_path / "out")
    est = port_run.main([cfg, "--output", out, "--device", "cpu"] + flags)
    assert est.shape == (3, 4, 4) and np.isfinite(est).all()
    assert sorted(f for f in os.listdir(os.path.join(out, "ckpts")) if f.endswith(".npz")) == [
        "00002.npz"]
    mesh = Mesh.load(os.path.join(out, "mesh", "final_mesh.ply"))
    assert len(mesh.faces) > 0 and mesh.vertex_colors is not None
    with np.load(os.path.join(out, "ckpts", "00002.npz")) as ck:
        assert any(k.startswith("decoders.imap") for k in ck.files) == ("--imap" in flags)
    capsys.readouterr()
    eval_ate.main([cfg, "--output", out, "--no_plot"] + flags)
    printed = capsys.readouterr().out
    rmse = float(printed.split("absolute_translational_error.rmse:")[1].split()[0])
    assert np.isfinite(rmse)


def test_python_dash_m_runs_on_the_cpu(tmp_path):
    """``python -m evennicer_slam_tpu_torch.run <config> --device cpu``."""
    cfg = write_config(tmp_path, 3, meshing={"eval_rec": False, "resolution": 20})
    out = str(tmp_path / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "evennicer_slam_tpu_torch.run", cfg, "--output", out,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.listdir(os.path.join(out, "mesh")) == ["final_mesh.ply"]
    assert os.path.exists(os.path.join(out, "ckpts", "00002.npz"))
