"""The tracker slice as a whole on the CPU: the port's ``track_frame`` and
``Tracker`` against the JAX package's ``track_frame_jit`` and ``Tracker`` on
a tiny camera and tiny grids, with the shipped EventNet weights.

Both sides get the same pixel draws: the JAX package draws iteration ``it``'s
pixels from ``fold_in(base_key, it)``; the test takes those draws from its
``sample_pixels`` and hands them to the port.

Tolerances. The loss history of every ``aux`` key is held at rtol 2e-3 +
atol 1e-3, the tolerance ``tracking_loss`` meets (test_torch_tracking_loss).
The best pose and ``best_c2w`` are held at atol 2e-4 after 3 steps at lr
1e-3: Adam's first step is ``lr * sign(g)`` and does not see a gradient
difference of 2 %; later steps see it as about 2 % of ``lr``. With the packed
bf16 decode (``fused_decode=True``; the JAX side through its Pallas kernels in
interpret mode, the port through the plain versions) the two frameworks round
at other places, so the history is held at rtol 5e-2 and the pose at
2 * iters * lr, the most Adam can separate two runs.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("ENSLAM_PALLAS", "0")

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
from evennicer_slam_tpu_torch.core.quaternion import pose_matrix_from_tensor
from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam import tracker as tt
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.optim import adam_init, adam_update

from torch_parity import assert_close, cap_threads, t, to_torch

cap_threads()
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "pretrained", "eventnet_mapdomain.npz")
CAM = (40, 60, 36.0, 36.0, 29.5, 19.5)
LO = (20, 30)
CFG = dict(pixels=64, iters=3, ignore_edge_w=5, ignore_edge_h=4, use_events=True,
           scale_factor=0.5, kernel_sizes=(5,), kernel_weights=(1.0,))
SET = dict(n_samples=8, n_surface=4)
FRAME_KEYS = ("gt_color", "gt_depth", "gt_event_lo", "prev_color_lo",
              "gt_depth_lo_flat", "gt_mask_lo")


def _c2w(cam7):
    m = np.eye(4, dtype=np.float32)
    m[:3] = pose_matrix_from_tensor(t(cam7)).numpy()
    return m


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
    pre = _c2w(np.array([0.99, 0.03, -0.05, 0.02, 0.05, -0.03, 0.35], np.float32))
    pre_pre = _c2w(np.array([0.99, 0.028, -0.052, 0.021, 0.047, -0.028, 0.347], np.float32))
    return dict(dj=decoders, gj=grids, dt=to_torch(decoders), gt=to_torch(grids),
                ej=j_load(NPZ), et=load_eventnet_npz(NPZ, device="cpu"),
                frame=frame, pre=pre, pre_pre=pre_pre)


def _draws(key, cfg, n_iters):
    """The JAX package's pixel draws for every iteration, as tensors."""
    out = []
    for it in range(n_iters):
        i, j = j_sample_pixels(jax.random.fold_in(key, it), cfg.pixels,
                               cfg.ignore_edge_h, CAM[0] - cfg.ignore_edge_h,
                               cfg.ignore_edge_w, CAM[1] - cfg.ignore_edge_w)
        out.append((t(i), t(j)))
    return out


def _both(world, rgbd, event, cfg_kw=None, set_kw=None, calibrate=False,
          bias_in=None, bias_scale=1.0, const_speed=True, seed=3):
    cfg_kw = {**CFG, **(cfg_kw or {})}
    set_kw = {**SET, **(set_kw or {})}
    f = world["frame"]
    jcfg, tcfg = jt.TrackerConfig(**cfg_kw), tt.TrackerConfig(**cfg_kw)
    key = jax.random.PRNGKey(seed)
    bias = np.zeros(7, np.float32) if bias_in is None else np.asarray(bias_in, np.float32)
    want = jt.track_frame_jit(
        jnp.asarray(world["pre"]), jnp.asarray(world["pre_pre"]), world["dj"], world["gj"],
        world["ej"], jnp.asarray(BOUND), key, *(jnp.asarray(f[k]) for k in FRAME_KEYS),
        jnp.asarray(bias), jnp.asarray(bias_scale, jnp.float32), jcfg, JCamera(*CAM),
        JSettings(**set_kw), rgbd, event, const_speed, calibrate)
    got = tt.track_frame(
        t(world["pre"]), t(world["pre_pre"]), world["dt"], world["gt"], world["et"],
        t(BOUND), None, *(t(f[k]) for k in FRAME_KEYS), t(bias), bias_scale, tcfg,
        Camera(*CAM), RenderSettings(**set_kw), rgbd, event, const_speed, calibrate,
        pixel_draws=_draws(key, jcfg, jcfg.iters), device="cpu")
    return got, want


def _compare(got, want, iters=3, loss_rtol=2e-3, loss_atol=1e-3, pose_atol=2e-4):
    best_cam, best_c2w, losses, bias_out = got
    assert set(losses) == set(want[2])
    for k in want[2]:
        assert tuple(losses[k].shape) == (iters,) and not losses[k].requires_grad
        assert_close(losses[k], want[2][k], atol=loss_atol, rtol=loss_rtol, msg=k)
    assert tuple(best_cam.shape) == (7,) and tuple(best_c2w.shape) == (4, 4)
    assert_close(best_cam, want[0], atol=pose_atol, msg="best_cam")
    assert_close(best_c2w, want[1], atol=pose_atol, msg="best_c2w")
    assert_close(best_c2w[3], [0.0, 0.0, 0.0, 1.0], atol=0.0)
    assert tuple(bias_out.shape) == (7,)


# ---- pose init and event preprocessing -----------------------------------------

@pytest.mark.parametrize("const_speed", [True, False])
def test_initial_pose_tensor(world, const_speed):
    got = tt.initial_pose_tensor(t(world["pre"]), t(world["pre_pre"]), const_speed)
    want = jt.initial_pose_tensor(jnp.asarray(world["pre"]), jnp.asarray(world["pre_pre"]),
                                  const_speed)
    assert_close(got, want, atol=1e-5)
    if not const_speed:
        assert_close(got[4:], world["pre"][:3, 3], atol=1e-7)


@pytest.mark.parametrize("prev_resize", ["nearest", "bilinear"])
def test_prep_event_inputs(prev_resize):
    rng = np.random.default_rng(4)
    H, W = CAM[:2]
    acc = rng.integers(0, 3, (H, W, 2)).astype(np.float32)
    ev = ((rng.random((H, W, 2)) < 0.3) * rng.integers(1, 4, (H, W, 2))).astype(np.float32)
    color = rng.random((H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 0.7, (H, W)).astype(np.float32)
    got = tt._prep_event_inputs(t(acc), t(ev), t(color), t(depth), LO, prev_resize)
    want = jt._prep_event_inputs(jnp.asarray(acc), jnp.asarray(ev), jnp.asarray(color),
                                 jnp.asarray(depth), LO, prev_resize)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close(g, w, atol=1e-5)
    assert_close(got[0], acc + ev, atol=0.0)


# ---- the slice as a whole --------------------------------------------------------

@pytest.mark.parametrize("rgbd,event,keys", [
    (True, False, {"rgbd"}),
    (False, True, {"event", "event_corr", "event_gt_energy", "mask"}),
    (True, True, {"rgbd", "event", "event_corr", "event_gt_energy", "mask"}),
])
def test_track_frame_matches_jax(world, rgbd, event, keys):
    got, want = _both(world, rgbd, event)
    assert set(got[2]) == keys
    _compare(got, want)
    assert_close(got[3], np.zeros(7), atol=0.0)  # no calibration: no bias measured
    # the pose moved, by no more than Adam can move it (a step may exceed lr
    # a little once the two bias corrections differ)
    start = tt.initial_pose_tensor(t(world["pre"]), t(world["pre_pre"]), True)
    step = (got[0] - start).abs().max()
    assert 0 < float(step) <= 2 * 3 * 1e-3


def test_track_frame_fused_decode_matches_jax(world):
    """The tracker's own setting: the packed bf16 decode on both sides (the
    JAX kernels, forward and backward, in interpret mode)."""
    os.environ["ENSLAM_PALLAS"] = "1"
    try:
        got, want = _both(world, True, True, set_kw={"fused_decode": True})
    finally:
        os.environ["ENSLAM_PALLAS"] = "0"
    _compare(got, want, loss_rtol=5e-2, pose_atol=2 * 3 * 1e-3)


def test_track_frame_separate_lr(world):
    got, want = _both(world, True, False, cfg_kw={"separate_lr": True})
    _compare(got, want)
    start = tt.initial_pose_tensor(t(world["pre"]), t(world["pre_pre"]), True)
    moved = (got[0] - start).abs()
    # the quaternion steps at a fifth of the translation's rate
    assert float(moved[:4].max()) <= 2 * 3 * 0.2e-3
    assert float(moved[:4].max()) < float(moved[4:].max())


def test_track_frame_calibrate_and_bias(world):
    """calibrate: the event-only probe's offset comes back as bias_out;
    bias_in * bias_scale is subtracted from the selected pose on event frames."""
    bias = np.array([0.0, 1e-3, -2e-3, 5e-4, 4e-3, -3e-3, 2e-3], np.float32)
    got, want = _both(world, True, True, calibrate=True, bias_in=bias, bias_scale=0.5)
    _compare(got, want)
    assert float(got[3].abs().max()) > 0
    assert_close(got[3], want[3], atol=4e-4, msg="bias_out")  # two optimisations deep
    # the same frame without calibration and bias (the port alone)
    f = world["frame"]
    tcfg = tt.TrackerConfig(**CFG)
    plain = tt.track_frame(
        t(world["pre"]), t(world["pre_pre"]), world["dt"], world["gt"], world["et"],
        t(BOUND), None, *(t(f[k]) for k in FRAME_KEYS), torch.zeros(7), 1.0, tcfg,
        Camera(*CAM), RenderSettings(**SET), True, True, True,
        pixel_draws=_draws(jax.random.PRNGKey(3), tcfg, tcfg.iters), device="cpu")
    assert_close(got[0], (plain[0] - 0.5 * t(bias)).numpy(), atol=1e-7)
    assert_close(plain[3], np.zeros(7), atol=0.0)


def test_bias_in_is_ignored_without_the_event_branch(world):
    f = world["frame"]
    tcfg = tt.TrackerConfig(**CFG)
    key = jax.random.PRNGKey(3)

    def run(bias):
        return tt.track_frame(
            t(world["pre"]), t(world["pre_pre"]), world["dt"], world["gt"], world["et"],
            t(BOUND), None, *(t(f[k]) for k in FRAME_KEYS), bias, 1.0, tcfg, Camera(*CAM),
            RenderSettings(**SET), True, False, True,
            pixel_draws=_draws(key, tcfg, tcfg.iters), device="cpu")[0]

    assert torch.equal(run(torch.zeros(7)), run(torch.full((7,), 0.01)))


# ---- best-pose pairing -----------------------------------------------------------

def _manual_run(world, tcfg, rgbd, event, draws):
    """An independent loop: poses before each step, post-step poses and the
    pre-step aux of every iteration."""
    f = world["frame"]
    cam_t = tt.initial_pose_tensor(t(world["pre"]), t(world["pre_pre"]), True)
    state = adam_init(cam_t)
    pre_step, post_step, auxes = [], [], []
    for it in range(tcfg.iters):
        x = cam_t.clone().requires_grad_()
        total, aux = tt.tracking_loss(
            x, world["dt"], world["gt"], world["et"], t(BOUND),
            *(t(f[k]) for k in FRAME_KEYS), tcfg, Camera(*CAM), RenderSettings(**SET),
            rgbd, event, pixel_ij=draws[it], device="cpu")
        (g,) = torch.autograd.grad(total, x)
        new_cam, state = adam_update(g, state, cam_t, tcfg.lr)
        pre_step.append(cam_t)
        post_step.append(new_cam)
        auxes.append({k: float(v.detach()) for k, v in aux.items()})
        cam_t = new_cam
    return pre_step, post_step, auxes


def test_best_pose_is_the_post_step_tensor_of_the_lowest_pre_step_event_loss(world):
    """On an RGB-D + event frame the criterion is the event loss, and the
    stored tensor is the one AFTER the step whose pre-step loss was lowest.
    Fails if the pre-step tensor is stored, or if the RGB-D loss selects."""
    cfg_kw = {**CFG, "iters": 4, "lr": 5e-3}
    tcfg = tt.TrackerConfig(**cfg_kw)
    key = jax.random.PRNGKey(3)
    draws = _draws(key, tcfg, tcfg.iters)
    pre_step, post_step, auxes = _manual_run(world, tcfg, True, True, draws)
    k_event = int(np.argmin([a["event"] for a in auxes]))
    k_rgbd = int(np.argmin([a["rgbd"] for a in auxes]))
    assert k_event != k_rgbd, "the scene must tell the two criteria apart"
    f = world["frame"]

    def run(cfg):
        return tt.track_frame(
            t(world["pre"]), t(world["pre_pre"]), world["dt"], world["gt"], world["et"],
            t(BOUND), None, *(t(f[k]) for k in FRAME_KEYS), torch.zeros(7), 1.0, cfg,
            Camera(*CAM), RenderSettings(**SET), True, True, True,
            pixel_draws=draws, device="cpu")

    best_cam, _, losses, _ = run(tcfg)
    assert_close(losses["event"], [a["event"] for a in auxes], atol=0.0, rtol=1e-6)
    assert torch.equal(best_cam, post_step[k_event])
    assert not torch.equal(best_cam, pre_step[k_event])
    assert not torch.equal(best_cam, post_step[k_rgbd])
    # the quirk knob: the RGB-D loss selects on an RGB-D frame
    by_rgbd, _, _, _ = run(tcfg._replace(best_pose_criterion="rgbd"))
    assert torch.equal(by_rgbd, post_step[k_rgbd])


def test_no_loss_in_the_total_leaves_the_pose_where_it_started(world):
    """activate_events=False on an event-only frame: the event loss is
    logged and selects, but nothing is optimised."""
    tcfg = tt.TrackerConfig(**{**CFG, "activate_events": False})
    f = world["frame"]
    best_cam, _, losses, _ = tt.track_frame(
        t(world["pre"]), t(world["pre_pre"]), world["dt"], world["gt"], world["et"],
        t(BOUND), None, *(t(f[k]) for k in FRAME_KEYS), torch.zeros(7), 1.0, tcfg,
        Camera(*CAM), RenderSettings(**SET), False, True, True, device="cpu")
    start = tt.initial_pose_tensor(t(world["pre"]), t(world["pre_pre"]), True)
    assert torch.equal(best_cam, start)
    assert float(losses["event"].max()) == float(losses["event"].min())


# ---- the Tracker class -------------------------------------------------------------

def _sequence(n):
    rng = np.random.default_rng(8)
    H, W = CAM[:2]
    frames = []
    for k in range(n):
        ev = ((rng.random((H, W, 2)) < 0.2) * rng.integers(1, 4, (H, W, 2))).astype(np.float32)
        frames.append(dict(
            color=rng.random((H, W, 3)).astype(np.float32),
            depth=rng.uniform(0.3, 0.7, (H, W)).astype(np.float32),
            event=ev if k > 0 else np.zeros_like(ev)))
    return frames


def test_tracker_over_six_frames_matches_jax(world):
    """Frames 0..6 with rgbd_every_frame=5, driven as the pipeline drives the
    tracker: which frames are RGB-D, the event integral and its handoff, the
    previous colour, and the bias calibration under bias_ema. The analytic
    event predictor keeps the JAX side's three compiled variants small."""
    cfg_kw = {**CFG, "rgbd_every_frame": 5, "predictor": "esim", "bias_correction": True,
              "bias_ema": 0.6, "bias_scale_mode": "window", "bias_alpha": 0.5}
    jcfg, tcfg = jt.TrackerConfig(**cfg_kw), tt.TrackerConfig(**cfg_kw)
    jtr = jt.Tracker(jcfg, JCamera(*CAM), JSettings(**SET), BOUND)
    ttr = tt.Tracker(tcfg, Camera(*CAM), RenderSettings(**SET), BOUND, device="cpu")
    assert ttr.lo_hw == jtr.lo_hw == LO
    frames = _sequence(7)
    seed_bias = np.array([0.0, 2e-3, -1e-3, 1e-3, 3e-3, -2e-3, 1e-3], np.float32)

    est_j, est_t = {0: world["pre_pre"]}, {0: t(world["pre_pre"])}
    jtr.reset_event_integration(frames[0]["event"].shape)
    ttr.reset_event_integration(frames[0]["event"].shape)
    jtr.pre_gt_color, ttr.pre_gt_color = jnp.asarray(frames[0]["color"]), t(frames[0]["color"])
    jtr.end_of_window(0, jnp.asarray(frames[0]["color"]), 5)
    ttr.end_of_window(0, t(frames[0]["color"]), 5)
    # frame 0 hands off the (empty) integral; a stale index reads nothing
    assert ttr.consume_event_handoff(3) is None and jtr.consume_event_handoff(3) is None
    assert_close(ttr.consume_event_handoff(0), np.asarray(jtr.consume_event_handoff(0)), 0.0)
    assert ttr.consume_event_handoff(0) is None and jtr.consume_event_handoff(0) is None

    for idx in range(1, 7):
        fr = frames[idx]
        if idx == 5:  # an earlier boundary's measurement, so the EMA has something to blend
            jtr.event_bias, ttr.event_bias = jnp.asarray(seed_bias), t(seed_bias)
        draws = _draws(jax.random.PRNGKey(idx), jcfg, jcfg.iters)
        cj = jtr.track(idx, jnp.asarray(fr["color"]), jnp.asarray(fr["depth"]),
                       jnp.asarray(fr["event"]), est_j[idx - 1],
                       est_j[idx - 2] if idx >= 2 else None, world["dj"], world["gj"], seed=idx)
        ct = ttr.track(idx, t(fr["color"]), t(fr["depth"]), t(fr["event"]), est_t[idx - 1],
                       est_t[idx - 2] if idx >= 2 else None, world["dt"], world["gt"],
                       seed=idx, pixel_draws=draws)
        # feed both sides the same pose back, so differences do not add up
        est_j[idx], est_t[idx] = np.asarray(cj), t(np.asarray(cj))
        rgbd = idx == 5
        assert ("rgbd" in ttr.last_losses) == ("rgbd" in jtr.last_losses) == rgbd
        assert set(ttr.last_losses) == set(jtr.last_losses)
        assert_close(ct, cj, atol=2e-4, msg=f"c2w of frame {idx}")
        for k in jtr.last_losses:
            assert_close(ttr.last_losses[k], jtr.last_losses[k], atol=1e-3, rtol=2e-3,
                         msg=f"frame {idx} {k}")
        jtr.end_of_window(idx, jnp.asarray(fr["color"]), 5)
        ttr.end_of_window(idx, t(fr["color"]), 5)
        if idx < 5:
            want = sum(f["event"] for f in frames[1:idx + 1])
            assert_close(ttr.gt_event_integrate, want, atol=0.0)
            assert_close(ttr.gt_event_integrate, np.asarray(jtr.gt_event_integrate), 0.0)
            assert_close(ttr.pre_gt_color, frames[0]["color"], atol=0.0)
            assert ttr.event_bias is None and ttr.consume_event_handoff(idx) is None
        if idx == 5:
            assert_close(ttr.pre_gt_color, frames[5]["color"], atol=0.0)
            assert_close(ttr.pre_gt_color, np.asarray(jtr.pre_gt_color), atol=0.0)
            assert float(ttr.gt_event_integrate.abs().sum()) == 0.0
            assert ttr.handoff_idx == jtr.handoff_idx == 5
            # bias_ema blends the seeded bias with this boundary's measurement
            assert_close(ttr.event_bias, np.asarray(jtr.event_bias), atol=4e-4)
            assert float((ttr.event_bias - 0.6 * t(seed_bias)).abs().max()) > 0
        if idx == 6:
            assert_close(ttr.gt_event_integrate, frames[6]["event"], atol=0.0)
    hand_t, hand_j = ttr.consume_event_handoff(5), jtr.consume_event_handoff(5)
    assert_close(hand_t, sum(f["event"] for f in frames[1:6]), atol=0.0)
    assert_close(hand_t, np.asarray(hand_j), atol=0.0)
    assert ttr.consume_event_handoff(5) is None


def test_tracker_without_events_tracks_rgbd_every_frame(world):
    tcfg = tt.TrackerConfig(**{**CFG, "use_events": False, "rgbd_every_frame": 5})
    ttr = tt.Tracker(tcfg, Camera(*CAM), RenderSettings(**SET), BOUND, device="cpu")
    fr = _sequence(2)[1]
    c2w = ttr.track(3, t(fr["color"]), t(fr["depth"]), t(fr["event"]), world["pre"], None,
                    world["dt"], world["gt"], seed=1)
    assert set(ttr.last_losses) == {"rgbd"} and ttr.gt_event_integrate is None
    rot = c2w[:3, :3]
    assert_close(rot.T @ rot, np.eye(3), atol=1e-5)
    again = ttr.track(3, t(fr["color"]), t(fr["depth"]), t(fr["event"]), world["pre"], None,
                      world["dt"], world["gt"], seed=1)
    other = ttr.track(3, t(fr["color"]), t(fr["depth"]), t(fr["event"]), world["pre"], None,
                      world["dt"], world["gt"], seed=2)
    assert torch.equal(c2w, again) and not torch.equal(c2w, other)  # the seed draws the pixels
