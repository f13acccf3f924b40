"""The port's replay tool (``tools/viz.py``) against the JAX package's on a
run directory written here (a checkpoint of eight poses on a circle, a
height-field mesh): the chase-cam depth, the frustum and the chase pose
equal the JAX functions'; the figure drawn in numpy puts each trajectory
where its panel's projection says; the GIF writer's output reads back in
Pillow; ``replay`` in each of its modes."""

import os

import numpy as np
import pytest
from PIL import Image

from evennicer_slam_tpu.mesh.trimesh_lite import Mesh as JMesh
from evennicer_slam_tpu.tools import viz as jviz
from evennicer_slam_tpu_torch.data.png import read_png
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.tools import viz
from torch_parity import cap_threads

cap_threads()


def poses(n, radius, z=0.0):
    """n camera poses on a circle in the x-y plane, each looking at the
    origin (the SLAM convention: -z forward, y up)."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        a = 0.4 * k
        c = np.array([radius * np.cos(a), radius * np.sin(a), z])
        fwd = -c / np.linalg.norm(c)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        out[k, :3, :3] = np.stack([right, up, -fwd], axis=1)
        out[k, :3, 3] = c
    return out


def height_field(n=40):
    """A wavy square surface of (n - 1)^2 quads around the origin."""
    x, y = np.meshgrid(np.linspace(-0.6, 0.6, n), np.linspace(-0.6, 0.6, n))
    z = 0.15 * np.sin(4 * x) * np.cos(3 * y)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, :-1], i[1:, 1:]
    f = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                        np.stack([a, d, c], -1).reshape(-1, 3)])
    colours = np.full((len(v), 3), 200, np.uint8)
    return Mesh(v, f, colours)


@pytest.fixture
def run_dir(tmp_path):
    out = tmp_path / "out"
    (out / "ckpts").mkdir(parents=True)
    (out / "mesh").mkdir()
    est, gt = poses(8, 1.5), poses(8, 1.8, z=0.2)
    np.savez(out / "ckpts" / "00007.npz", idx=np.asarray(7), estimate_c2w_list=est,
             gt_c2w_list=gt)
    height_field().export(str(out / "mesh" / "final_mesh.ply"))
    return str(out), est, gt


def test_mesh_view_frustum_and_chase_pose_equal_the_jax_functions(run_dir):
    out, est, _ = run_dir
    path = os.path.join(out, "mesh", "final_mesh.ply")
    tm, jm = Mesh.load(path), JMesh.load(path)
    for c2w in est[::3]:
        chase = viz._chase_pose(c2w)
        np.testing.assert_array_equal(chase, jviz._chase_pose(c2w))
        got, want = viz.render_mesh_view(tm, chase), jviz.render_mesh_view(jm, chase)
        assert got.shape == want.shape == (240, 320)
        np.testing.assert_array_equal(got > 0, want > 0)
        assert (got > 0).mean() > 0.01
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        for (a, b), (c, d) in zip(viz._frustum_lines(c2w), jviz._frustum_lines(c2w)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_the_figure_puts_each_trajectory_where_its_panel_projects_it(run_dir, tmp_path):
    out, est, gt = run_dir
    mesh_path = os.path.join(out, "mesh", "final_mesh.ply")
    with_mesh = viz.draw_trajectory(est, gt, mesh_path, str(tmp_path / "a.png"))
    bare = viz.draw_trajectory(est, gt, None, str(tmp_path / "b.png"))
    img, img2 = read_png(with_mesh), read_png(bare)
    assert img.shape == (viz.PANEL_PX, 3 * viz.PANEL_PX, 3)
    assert img2.shape == (viz.PANEL_PX, 2 * viz.PANEL_PX, 3)
    assert not (img2 == viz.MESH_RGB).all(axis=-1).any()  # no mesh, no mesh dots
    third = img[:, 2 * viz.PANEL_PX:]
    assert (third != 255).any(axis=-1).mean() > 0.05  # the chase-cam depth
    assert set(map(tuple, third.reshape(-1, 3))) <= set(map(tuple, viz.VIRIDIS)) | {(255,) * 3}

    verts = Mesh.load(mesh_path).vertices
    for panel, view in enumerate(viz._panel_views(est, gt, verts)):
        canvas = img[:, panel * viz.PANEL_PX:(panel + 1) * viz.PANEL_PX]
        for k in range(5):  # away from the current pose's frustum and marker
            for traj, rgb in ((est, viz.EST_RGB), (gt, viz.GT_RGB)):
                x, y = np.rint(view(traj[k:k + 1, :3, 3])[0]).astype(int)
                assert tuple(canvas[y, x]) == rgb, (panel, k, rgb)
    # the current-pose marker on the top-down panel
    x, y = np.rint(viz._panel_views(est, gt, verts)[1](est[-1:, :3, 3])[0]).astype(int)
    assert tuple(img[y, viz.PANEL_PX + x]) == viz.CUR_RGB


@pytest.mark.parametrize("fps", [10, 7])
def test_the_gif_reads_back_in_pillow(run_dir, tmp_path, fps):
    out, est, gt = run_dir
    mesh_path = os.path.join(out, "mesh", "final_mesh.ply")
    frames = []
    for k in (2, 5, 8):
        path = viz.draw_trajectory(est[:k], gt[:k], mesh_path if k > 2 else None,
                                   str(tmp_path / f"{k}.png"))
        img = read_png(path)
        pad = np.full((viz.PANEL_PX, 3 * viz.PANEL_PX, 3), 255, np.uint8)
        pad[:, : img.shape[1]] = img
        frames.append(pad)
    gif = str(tmp_path / "r.gif")
    viz.write_gif(gif, frames, fps=fps)
    im = Image.open(gif)
    assert im.n_frames == 3 and im.info["loop"] == 0
    assert im.info["duration"] == 10 * int(int(1000 / fps) / 10)
    n_colours = len({tuple(c) for f in frames for c in f.reshape(-1, 3)})
    for i, want in enumerate(frames):
        im.seek(i)
        got = np.asarray(im.convert("RGB")).astype(int)
        err = np.abs(got - want).max()
        # at most 256 colours: exact; beyond, the nearest of the 256 most
        # frequent (viridis' neighbours lie a few levels apart)
        assert err == 0 if n_colours <= 256 else err <= 8, (i, n_colours, err)


def test_replay_plain_frames_gif_and_one_follow_poll(run_dir, monkeypatch):
    out, _, _ = run_dir
    viz.replay(out)
    assert read_png(os.path.join(out, "replay.png")).shape == (540, 1620, 3)
    viz.replay(out, save_rendering=True, frame_step=3)
    frames = sorted(os.listdir(os.path.join(out, "vis", "replay")))
    assert frames == ["00001.png", "00004.png", "00007.png"]
    assert not os.path.exists(os.path.join(out, "replay.gif"))
    viz.replay(out, save_rendering=True, gif=True, frame_step=3)
    assert Image.open(os.path.join(out, "replay.gif")).n_frames == 3

    os.remove(os.path.join(out, "replay.png"))

    class Stop(Exception):
        pass

    def stop(_):
        raise Stop

    monkeypatch.setattr(viz.time, "sleep", stop)
    with pytest.raises(Stop):
        viz.replay(out, follow=True, poll_s=0.01)
    assert os.path.exists(os.path.join(out, "replay.png"))
    os.makedirs(os.path.join(out, "empty", "ckpts"))
    with pytest.raises(SystemExit):
        viz.replay(os.path.join(out, "empty"))
