"""The slice as a whole on the CPU: the port's ``tracking_loss`` against the
JAX package's ``_tracking_loss`` — render, EventNet, RGB-D and event losses —
on a tiny camera and tiny grids, with the shipped EventNet weights. The pixel
draws come from the JAX package's ``sample_pixels(key, ...)`` and are handed
to the port. Total and every ``aux`` entry are compared at rtol 2e-3 +
atol 1e-3 (f32 on both sides; the RGB-D term divides by sqrt(depth variance)
and the event term passes through eighteen convolutions, so last-digit
differences in the render are amplified a few hundred times)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.core.rays import sample_pixels as j_sample_pixels
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.eventnet_train import load_eventnet_npz as j_load
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.render.renderer import RenderSettings as JSettings
from evennicer_slam_tpu.slam import tracker as jt
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam import tracker as tt
from evennicer_slam_tpu_torch.slam.camera import Camera

from torch_parity import assert_close, cap_threads, t, to_torch

cap_threads()
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "pretrained", "eventnet_mapdomain.npz")
CAM = (40, 60, 36.0, 36.0, 29.5, 19.5)
LO = (20, 30)
CFG = dict(pixels=64, ignore_edge_w=5, ignore_edge_h=4, use_events=True,
           scale_factor=0.5, kernel_sizes=(5,), kernel_weights=(1.0,))
SET = dict(n_samples=8, n_surface=4)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(21)
    grids = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=False)
    grids = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
             for k, v in grids.items()}
    decoders = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=False)
    H, W = CAM[:2]
    frame = dict(
        gt_color=rng.random((H, W, 3)).astype(np.float32),
        gt_depth=rng.uniform(0.3, 0.7, (H, W)).astype(np.float32),
        gt_event_lo=(rng.random((*LO, 2)) < 0.2).astype(np.float32)
        * rng.integers(1, 4, (*LO, 2)).astype(np.float32),
        prev_color_lo=rng.random((*LO, 3)).astype(np.float32),
        gt_depth_lo_flat=rng.uniform(0.3, 0.7, LO[0] * LO[1]).astype(np.float32),
        gt_mask_lo=(rng.random(LO) < 0.3).astype(np.float32),
    )
    frame["gt_depth"][::7, ::5] = 0.0  # pixels without a depth reading
    cam_tensor = np.array([0.99, 0.03, -0.05, 0.02, 0.05, -0.03, 0.35], np.float32)
    return dict(dj=decoders, gj=grids, dt=to_torch(decoders), gt=to_torch(grids),
                ej=j_load(NPZ), et=load_eventnet_npz(NPZ, device="cpu"),
                frame=frame, cam_tensor=cam_tensor)


def _both(world, rgbd, event, cfg_kw=None, key=jax.random.PRNGKey(3)):
    cfg_kw = {**CFG, **(cfg_kw or {})}
    f = world["frame"]
    jcfg, tcfg = jt.TrackerConfig(**cfg_kw), tt.TrackerConfig(**cfg_kw)
    want = jt._tracking_loss(
        jnp.asarray(world["cam_tensor"]), world["dj"], world["gj"], world["ej"],
        jnp.asarray(BOUND), key, *(jnp.asarray(f[k]) for k in f),
        jcfg, JCamera(*CAM), JSettings(**SET), rgbd, event)
    i, j = j_sample_pixels(key, jcfg.pixels, jcfg.ignore_edge_h, CAM[0] - jcfg.ignore_edge_h,
                           jcfg.ignore_edge_w, CAM[1] - jcfg.ignore_edge_w)
    got = tt.tracking_loss(
        t(world["cam_tensor"]), world["dt"], world["gt"], world["et"], t(BOUND),
        *(t(f[k]) for k in f), tcfg, Camera(*CAM), RenderSettings(**SET), rgbd, event,
        pixel_ij=(t(i), t(j)), device="cpu")
    return got, want


def _compare(got, want):
    assert set(got[1]) == set(want[1])
    assert_close(got[0], want[0], atol=1e-3, rtol=2e-3, msg="total")
    for k in want[1]:
        assert got[1][k].shape == () and torch.isfinite(got[1][k])
        assert_close(got[1][k], want[1][k], atol=1e-3, rtol=2e-3, msg=k)


@pytest.mark.parametrize("rgbd,event,keys", [
    (True, False, {"rgbd"}),
    (False, True, {"event", "event_corr", "event_gt_energy", "mask"}),
    (True, True, {"rgbd", "event", "event_corr", "event_gt_energy", "mask"}),
])
def test_tracking_loss_modes(world, rgbd, event, keys):
    got, want = _both(world, rgbd, event)
    assert set(got[1]) == keys
    _compare(got, want)
    expect = sum(got[1][k] for k in ("rgbd", "event") if k in keys)
    assert_close(got[0], float(expect), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("activate,rgbd,in_total", [
    (False, True, False), ("non_rgbd", True, False), ("non_rgbd", False, True),
])
def test_activate_events_modes(world, activate, rgbd, in_total):
    got, want = _both(world, rgbd, True, {"activate_events": activate})
    _compare(got, want)
    base = got[1]["rgbd"] if rgbd else torch.zeros(())
    expect = base + (got[1]["event"] if in_total else 0.0)
    assert_close(got[0], float(expect), atol=1e-4, rtol=1e-6)


def test_esim_predictor_no_blur_no_dynamic_mask(world):
    got, want = _both(world, True, True, {"predictor": "esim", "blur": False,
                                          "handle_dynamic": False, "use_color": False})
    _compare(got, want)


def test_pose_gradient_of_the_total(world):
    """Autograd through the port's whole path (f32 decode) against jax.grad:
    what the next slice's pose optimisation will follow."""
    f = world["frame"]
    key = jax.random.PRNGKey(3)
    jcfg, tcfg = jt.TrackerConfig(**CFG), tt.TrackerConfig(**CFG)

    def jloss(x):
        return jt._tracking_loss(
            x, world["dj"], world["gj"], world["ej"], jnp.asarray(BOUND), key,
            *(jnp.asarray(f[k]) for k in f), jcfg, JCamera(*CAM), JSettings(**SET),
            True, True)[0]

    g_want = np.asarray(jax.grad(jloss)(jnp.asarray(world["cam_tensor"])))
    i, j = j_sample_pixels(key, 64, 4, 36, 5, 55)
    x = t(world["cam_tensor"]).requires_grad_()
    total, _ = tt.tracking_loss(
        x, world["dt"], world["gt"], world["et"], t(BOUND), *(t(f[k]) for k in f),
        tcfg, Camera(*CAM), RenderSettings(**SET), True, True,
        pixel_ij=(t(i), t(j)), device="cpu")
    total.backward()
    rel = np.linalg.norm(x.grad.numpy() - g_want) / np.linalg.norm(g_want)
    assert rel < 2e-2, (rel, x.grad.numpy(), g_want)


def test_fused_settings_route_through_the_packed_decode(world):
    """fused_decode=True (the tracker's setting): same losses up to the bf16
    rows and products of the packed decode."""
    f = world["frame"]
    tcfg = tt.TrackerConfig(**CFG)
    args = (t(world["cam_tensor"]), world["dt"], world["gt"], world["et"], t(BOUND),
            *(t(f[k]) for k in f), tcfg, Camera(*CAM))
    plain = tt.tracking_loss(*args, RenderSettings(**SET), False, True, device="cpu")
    fused = tt.tracking_loss(*args, RenderSettings(fused_decode=True, **SET), False, True,
                             device="cpu")
    assert not torch.equal(plain[0], fused[0])
    assert_close(fused[0], float(plain[0]), atol=0.0, rtol=5e-2)


def test_own_pixel_draws_and_helpers(world):
    f = world["frame"]
    tcfg = tt.TrackerConfig(**CFG)
    args = (t(world["cam_tensor"]), world["dt"], world["gt"], world["et"], t(BOUND),
            *(t(f[k]) for k in f), tcfg, Camera(*CAM), RenderSettings(**SET), True, False)
    a = tt.tracking_loss(*args, generator=torch.Generator().manual_seed(1), device="cpu")[0]
    b = tt.tracking_loss(*args, generator=torch.Generator().manual_seed(1), device="cpu")[0]
    c = tt.tracking_loss(*args, generator=torch.Generator().manual_seed(2), device="cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("n_masked", [0, 1, 4, 7])
def test_masked_median_is_the_lower_median(n_masked):
    rng = np.random.default_rng(n_masked)
    x = rng.normal(size=12).astype(np.float32)
    mask = np.ones(12, bool)
    mask[rng.permutation(12)[:n_masked]] = False
    got = tt.masked_median(t(x), torch.tensor(mask))
    assert_close(got, jt.masked_median(jnp.asarray(x), jnp.asarray(mask)), 0.0)
    assert float(got) == float(torch.median(t(x)[torch.tensor(mask)]))  # torch's lower median


def test_esim_predict_and_pyramid_loss():
    rng = np.random.default_rng(5)
    a, b = rng.random((10, 14, 3)).astype(np.float32), rng.random((10, 14, 3)).astype(np.float32)
    for g, w in zip(tt.esim_predict(t(a), t(b), 20.0),
                    jt.esim_predict(jnp.asarray(a), jnp.asarray(b), 20.0)):
        assert_close(g, w, 1e-5)
    ev, pr = rng.random((10, 14, 2)).astype(np.float32), rng.random((10, 14, 2)).astype(np.float32)
    assert_close(tt.event_pyramid_loss(t(ev), t(pr), (3, 5), (1.0, 0.5)),
                 jt.event_pyramid_loss(jnp.asarray(ev), jnp.asarray(pr), (3, 5), (1.0, 0.5)),
                 atol=1e-4, rtol=1e-5)


def test_tracker_config_from_cfg_matches():
    cfg = {"tracking": {"pixels": 200, "iters": 10, "lr": 1e-3, "seperate_LR": False,
                        "w_color_loss": 0.5, "ignore_edge_W": 100, "ignore_edge_H": 100,
                        "handle_dynamic": True, "use_color_in_tracking": True,
                        "const_speed_assumption": True, "gt_camera": False},
           "event": {"rgbd_every_frame": 5, "activate_events": "non_rgbd", "balancer": 0.025,
                     "kernel_sizes": [9], "kernel_weights": [1], "predictor": "esim"}}
    got, want = tt.TrackerConfig.from_cfg(cfg, True), jt.TrackerConfig.from_cfg(cfg, True)
    assert got._fields == want._fields and tuple(got) == tuple(want)
    for bad in ({"activate_events": "sometimes"}, {"predictor": "cnn"}, {"prev_resize": "cubic"}):
        with pytest.raises(ValueError):
            tt.TrackerConfig.from_cfg({**cfg, "event": bad}, True)
