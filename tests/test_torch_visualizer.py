"""The port's visualiser (``utils/visualizer.py``) and its place in the
pipeline's schedule, against the JAX package's (which draws with
matplotlib).

The panels' inputs, the rendered depth and colour of a pose and their
residuals against the GT, through both packages' ``Renderer`` on a tiny
random map with the fused decode off: within PANEL_ATOL (measured 5.0e-7
depth, 3.3e-6 colour). ``_event_rgb`` equal. A tiny pipeline with
``enable_vis: true`` in both packages (RGB-D + events, 64x80, four frames,
panels every second frame): the same panel file names in ``tracking_vis/``
and ``mapping_vis/``; each port panel decodes through cv2 to the mosaic's
shape, 3x3 cells with events; an output directory named ``Demo`` writes the
tracking panels to ``vis/`` and no mapping panels.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from evennicer_slam_tpu.models import decoders as jdec
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.render import renderer as jr
from evennicer_slam_tpu.utils import visualizer as jvis
from evennicer_slam_tpu_torch.render import renderer as tr
from evennicer_slam_tpu_torch.utils import visualizer as tvis
from torch_parity import cap_threads, to_torch
from torch_pipeline_parity import port_pipeline, run_jax

cap_threads()
PANEL_ATOL = 1e-4
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
CAM = dict(H=20, W=30, fx=18.0, fy=18.0, cx=14.5, cy=9.5)
N_FRAMES = 4
VIS = {"tracking": {"vis_freq": 2}, "mapping": {"vis_freq": 2, "vis_inside_freq": 3}}


def test_panel_inputs_match_the_jax_renderer(tmp_path):
    grids = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    grids = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
             for k, v in grids.items()}
    decoders = jdec.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    rng = np.random.default_rng(5)
    gt_depth = rng.uniform(0.2, 0.7, (CAM["H"], CAM["W"])).astype(np.float32)
    gt_depth[::4, ::5] = 0.0  # pixels without a depth reading
    gt_color = rng.random((CAM["H"], CAM["W"], 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05, -0.02, 0.3]
    j_settings = jr.RenderSettings(n_samples=16, n_surface=8)
    t_settings = tr.RenderSettings(n_samples=16, n_surface=8)
    assert not j_settings.fused_decode and not t_settings.fused_decode
    j_ren = jr.Renderer(*CAM.values(), BOUND, j_settings)
    t_ren = tr.Renderer(*CAM.values(), BOUND, t_settings, device="cpu")
    depth, _, color = j_ren.render_img(decoders, grids, c2w[:3], "color", gt_depth=gt_depth)
    depth, color = np.asarray(depth), np.clip(np.asarray(color), 0, 1)
    got = tvis.Visualizer(1, 1, str(tmp_path), t_ren).panel_inputs(
        gt_depth, gt_color, c2w, to_torch(grids), to_torch(decoders))
    depth_res = np.abs(gt_depth - depth)
    depth_res[gt_depth == 0] = 0
    want = {"depth": depth, "color": color, "depth_res": depth_res,
            "color_res": np.abs(gt_color - color).mean(-1)}
    for k, v in want.items():
        d = float(np.abs(got[k] - v).max())
        print(f"{k}: max abs diff {d:.2e}")
        assert got[k].shape == v.shape and d <= PANEL_ATOL, k
    assert (got["depth_res"][gt_depth == 0] == 0).all()


def test_event_rgb_equals_the_jax_one():
    ev = np.random.default_rng(2).uniform(-1, 8, (12, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(tvis._event_rgb(ev), jvis._event_rgb(ev))


def _panels(out):
    return {sub: sorted(os.listdir(os.path.join(out, sub)))
            for sub in ("tracking_vis", "mapping_vis", "vis")
            if os.path.isdir(os.path.join(out, sub))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("vis"))
    jax_run = run_jax(tmp, N_FRAMES, events=True, enable_vis=True, **VIS)
    port = port_pipeline(tmp, "port", N_FRAMES, True, jax_run["state"], enable_vis=True,
                         **VIS)
    port.run(mesh=False)
    return jax_run, port


def test_the_pipeline_writes_the_jax_packages_panels(runs):
    jax_run, port = runs
    want, got = _panels(jax_run["slam"].output), _panels(port.output)
    print(got)
    assert got == want
    assert got["tracking_vis"] == ["00002_0000.jpg"]
    # mapping: frames 0 and 2, every 2 * 3 - 1 = 5 iterations inside each call
    assert {"00000_0000.jpg", "00000_0005.jpg", "00002_0000.jpg"} <= set(got["mapping_vis"])


def test_each_panel_decodes_to_the_mosaics_shape(runs):
    _, port = runs
    H, W, m = port.cam.H, port.cam.W, tvis.MARGIN
    for sub, names in _panels(port.output).items():
        rows = 3 if sub == "tracking_vis" else 2  # the tracking panels carry events
        for name in names:
            img = cv2.imread(os.path.join(port.output, sub, name))
            assert img.shape == (rows * (H + m) + m, 3 * (W + m) + m, 3), (sub, name)


def test_a_demo_output_directory(runs, tmp_path):
    """Under an output directory named ``Demo`` the tracking panels go to
    ``vis/`` and the mapping call writes none, as in the JAX package."""
    jax_run, _ = runs
    port = port_pipeline(str(tmp_path), "Demo", 3, True, jax_run["state"], enable_vis=True,
                         **VIS)
    for idx in range(3):
        port.step(idx)
    assert _panels(port.output) == {"vis": ["00002_0000.jpg"]}
    assert torch.isfinite(torch.as_tensor(port.estimate_c2w_list)).all()
