"""iMAP mapping in the port against the JAX package's on the CPU, at the
sizes of ``test_torch_mapper.py`` (36x48 frames of the synthetic scene, 120
pixels, window 3) with the rendering of ``configs/imap.yaml`` (32 stratified
+ 12 importance samples, no surface band, density compositing,
``occupancy: false``): the free-space regulation ``regulation_sigma``, the
iMAP ``_map_loss``, the StepLR on the decoder rate, and ``Mapper`` calls as
the pipeline makes them. The JAX package's pixel draws and regulation
jitters are handed to the port.

Tolerances (measured on these inputs, then set with room):
- ``regulation_sigma``: relative L2 distance and rtol 1e-5, atol 1e-5 x the
  largest density (measured 2.2e-6 relative L2, 6.2e-6 at most of values up
  to 1.5);
- ``_map_loss``: the value at rtol 1e-5 (measured 7.6e-7), each decoder
  leaf's gradient at a relative L2 distance of 1e-2 (measured at most
  1.4e-3; 3.0e-3 at other draws). The first layers carry the spread: a
  sample point's f32 rounding moves its Fourier argument (up to ~100) by
  ~1e-5, which now and then flips a ReLU of the first blocks; each
  framework's f32 gradient of these layers lies 2e-4 to 3e-3 from the
  float64 gradient of the same loss, the last two layers within 6e-5;
- the mapper's calls: the last loss of each at rtol 3e-2 (measured at most
  1.7e-2), the decoder's update over the calls at a relative L2 distance of
  0.2 (measured at most 0.10). The iMAP MLP is more sensitive to f32
  rounding than the NICE trio (``test_torch_mapping_slice.py`` holds its
  losses at 1e-3): the ReLU flips above turn, through Adam's first steps
  (lr * g / |g|), into whole steps of the first layers. The first call's 12
  iterations read 28.711 in float64 (the port's tensors in double), 28.689
  in the port's f32 and 28.375 in the JAX package's f32: the JAX package's
  own rounding moves it 1.2 % off the float64 loss. Three planted faults move
  the first call's loss by 8 to 17 % (``FAULTS``), outside the band.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.render import renderer as jr
from evennicer_slam_tpu.render.renderer import RenderSettings as JSettings
from evennicer_slam_tpu.slam import mapper as jm
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu_torch.config import load_config
from evennicer_slam_tpu_torch.core.rays import get_rays
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames
from evennicer_slam_tpu_torch.render import renderer as tr
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam import mapper as tm
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.optim import tree_map

from test_torch_mapper import BOUND, CAM, H, ROOM, W, _flat, _np, _rel, _window, tiny_cfg
from torch_parity import JaxDrawsMapper, assert_close, cap_threads, jax_to_np, t, to_torch

cap_threads()
SEED = 1234
SIGMA_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL = 1e-2
CALL_LOSS_RTOL = 3e-2
SEQ_UPDATE_REL = 0.2
# what configs/imap.yaml changes in the rendering and the mapping
IMAP = {"rendering": {"N_importance": 12, "N_samples": 32, "N_surface": 0,
                      "lindisp": False, "perturb": 0.0},
        "occupancy": False}


def imap_cfg(load):
    cfg = tiny_cfg(load, imap_decoders_lr=0.0002, keyframe_selection_method="global")
    cfg.update(IMAP)
    return cfg


@pytest.fixture(scope="module")
def scene():
    frames = list(synthetic_frames(5, H, W, fx=60.0, fy=60.0, bound=ROOM, traj_step=0.02))
    dj = jd.init_imap_decoder(jax.random.PRNGKey(1))
    return dict(frames=frames, dj=dj, jset=JSettings.from_cfg(imap_cfg(j_load_config),
                                                              nice=False),
                tset=RenderSettings.from_cfg(imap_cfg(load_config), nice=False))


def test_the_settings_are_imaps(scene):
    s = scene["tset"]
    assert (s.nice, s.occupancy, s.n_samples, s.n_importance, s.n_surface) == (
        False, False, 32, 12, 0)
    assert {f: getattr(s, f) for f in s._fields} == {
        f: getattr(scene["jset"], f) for f in s._fields}


def test_regulation_sigma_matches_the_jax_package(scene):
    f = scene["frames"][1]
    ro, rd = get_rays(H, W, CAM[2], CAM[3], CAM[4], CAM[5], t(f.c2w))
    rng = np.random.default_rng(2)
    sel = rng.choice(np.flatnonzero(f.depth.reshape(-1) > 0), 200, replace=False)
    ro, rd = ro.reshape(-1, 3)[sel], rd.reshape(-1, 3)[sel]
    depth = f.depth.reshape(-1)[sel]
    key = jax.random.PRNGKey(11)
    want = np.asarray(jr.regulation_sigma(scene["dj"], {}, jnp.asarray(_np(ro)),
                                          jnp.asarray(_np(rd)), jnp.asarray(depth),
                                          jnp.asarray(BOUND), scene["jset"], key))
    t_rand = t(np.asarray(jax.random.uniform(key, (200, 32))))
    got = tr.regulation_sigma(to_torch(scene["dj"]), {}, ro, rd, t(depth), t(BOUND),
                              scene["tset"], t_rand=t_rand)
    assert tuple(got.shape) == (200 * 32,)
    assert _rel(got, want) <= SIGMA_RTOL
    assert_close(got, want, atol=SIGMA_RTOL * float(np.abs(want).max()), rtol=SIGMA_RTOL)
    # the jitter stays inside the bins of [0, 0.85 d], and a generator draws one
    gen = torch.Generator().manual_seed(0)
    a = tr.regulation_sigma(to_torch(scene["dj"]), {}, ro, rd, t(depth), t(BOUND),
                            scene["tset"], generator=gen)
    assert torch.isfinite(a).all() and not torch.equal(a, got)


def test_imap_map_loss_value_and_gradients(scene):
    colors, depths, fixed, cams = _window(scene, (0, 2, 4))
    cfg_t = tm.MapperConfig.from_cfg(imap_cfg(load_config))
    cfg_j = jm.MapperConfig.from_cfg(imap_cfg(j_load_config))
    K, pix = 3, 40
    key = jax.random.PRNGKey(17)
    params_j = ({}, scene["dj"], jnp.asarray(cams))
    loss_j, grads_j = jax.jit(jax.value_and_grad(jm._map_loss), static_argnums=range(6, 13))(
        params_j, jnp.asarray(fixed), jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(BOUND), key, cfg_j, JCamera(*CAM), scene["jset"], "color", False, False,
        pix)
    draws = torch.from_numpy(np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (pix,), 0, H * W))(jax.random.split(key, K))
    ).astype(np.int64))
    reg = t(np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (K * pix, 32))))
    dec = tree_map(lambda x: x.requires_grad_(), to_torch(scene["dj"]))
    loss_t = tm._map_loss(({}, dec, t(cams)), t(fixed), t(colors), t(depths), t(BOUND), draws,
                          cfg_t, Camera(*CAM), scene["tset"], "color", False, False, reg)
    assert_close(loss_t, loss_j, atol=0.0, rtol=LOSS_RTOL)
    paths, leaves = zip(*_flat(dec))
    grads = torch.autograd.grad(loss_t, leaves)
    flat_j = _flat(grads_j[1])
    assert [p for p, _ in flat_j] == list(paths)
    for g, (path, gj) in zip(grads, flat_j):
        assert np.any(np.asarray(gj)), path  # every leaf of the MLP is trained
        assert _rel(g, gj) <= GRAD_REL, (path, _rel(g, gj))
    # the regulation term is in the loss: without it the loss falls
    no_reg = tm._map_loss(({}, to_torch(scene["dj"]), t(cams)), t(fixed), t(colors),
                          t(depths), t(BOUND), draws, cfg_t, Camera(*CAM),
                          scene["tset"]._replace(occupancy=True), "color", False, False)
    assert float(no_reg) != float(loss_t.detach())


@pytest.mark.parametrize("it,factor", [(199, 1.0), (200, 0.8)])
def test_imap_step_lr_holds_at_199_and_drops_at_200(scene, it, factor):
    """One Adam step of the iMAP decoder from a fresh state at global
    iteration ``it``: the first step is lr * g / (|g| + eps), so the largest
    change of a bias is the rate itself, imap_decoders_lr x 0.8 ** (it // 200)."""
    want = float(jnp.float32(0.8) ** (jnp.int32(it) // 200).astype(jnp.float32))
    assert tm.imap_lr_factor(it) == want == pytest.approx(factor)
    colors, depths, fixed, cams = _window(scene, (0, 2, 4))
    cfg = tm.MapperConfig.from_cfg(imap_cfg(load_config))
    dec0 = to_torch(scene["dj"])
    draws = {"color": torch.randint(0, H * W, (1, 3, 40), generator=torch.Generator()
                                    .manual_seed(0))}
    reg = {"color": torch.rand((1, 120, 32), generator=torch.Generator().manual_seed(1))}
    _, dec, _, _, _, _, _ = tm.map_frame(
        {}, dec0, t(cams), None, None, t(fixed), torch.ones(3), t(colors), t(depths), {},
        t(BOUND), draws, {"color": 1}, 1.0, None, None, None, {}, 0.0, None, None, None, None,
        cfg, Camera(*CAM), scene["tset"], False, False, False, ("color",), False, False,
        init_adam=True, device="cpu", seg_starts={"color": it}, reg_draws=reg)
    # the biases start at zero, where the step is not rounded away
    step = max(float((a - b).abs().max()) for a, b in zip(dec["imap"]["lin_b"],
                                                          dec0["imap"]["lin_b"]))
    lr = float(np.float32(0.0002) * np.float32(want))
    assert step == pytest.approx(lr, rel=1e-3)


@pytest.mark.parametrize("branch", ["host", "device"])
def test_imap_mapper_matches_jax_over_three_calls(scene, branch):
    """The first call (``iters_first`` at ``lr_first_factor``) and two steady
    calls, each three calls of ``iters // 3`` iterations with the pipeline's
    seeds; global keyframe selection; a keyframe every second frame. The
    device branch hands the steady calls the pose as a tensor."""
    frames = scene["frames"]
    jcfg = jm.MapperConfig.from_cfg(imap_cfg(j_load_config))
    tcfg = tm.MapperConfig.from_cfg(imap_cfg(load_config))
    jmap = jm.Mapper(jcfg, JCamera(*CAM), scene["jset"], BOUND, seed=SEED)
    tmap = JaxDrawsMapper(tcfg, Camera(*CAM), scene["tset"], BOUND, seed=SEED, device="cpu")
    assert tmap.selection == "global"
    dj, dt = scene["dj"], to_torch(scene["dj"])
    gj, gt = {}, {}
    for idx in (0, 2, 4):
        f = frames[idx]
        init = idx == 0
        outer, num, lr = ((1, tcfg.iters_first, tcfg.lr_first_factor) if init
                          else (3, tcfg.iters // 3, tcfg.lr_factor))
        pose = f.c2w.copy()
        pose_t = t(pose) if (branch == "device" and not init) else pose.copy()
        for o in range(outer):
            gj, dj, new_j = jmap.optimize_map(num, lr, idx, f.color, f.depth, f.event, pose,
                                              seed=idx * 97 + o, grids=gj, decoders=dj)
            gt, dt, new_t = tmap.optimize_map(num, lr, idx, f.color, f.depth, f.event, pose_t,
                                              seed=idx * 97 + o, grids=gt, decoders=dt)
            assert new_j is None and new_t is None  # no BA in iMAP's configuration
            assert gt == {} and gj == {}
            assert_close(tmap.last_loss, float(jmap.last_loss), atol=0.0, rtol=CALL_LOSS_RTOL,
                         msg=f"frame {idx}, call {o}")
        jmap.maybe_add_keyframe(idx, 5, f.color, f.depth, f.event, pose, f.c2w)
        tmap.maybe_add_keyframe(idx, 5, f.color, f.depth, f.event, pose_t, f.c2w)
        assert tmap.keyframes.indices == jmap.keyframes.indices
    assert tmap.keyframes.indices == [0, 2, 4]
    assert tmap.rng.integers(1 << 30) == jmap.rng.integers(1 << 30)
    d0 = jax_to_np(scene["dj"])
    for (path, g), (_, w), (_, x0) in zip(_flat(dt), _flat(dj), _flat(d0)):
        g, w, x0 = _np(g), np.asarray(w), np.asarray(x0)
        assert not np.array_equal(w, x0), path  # the whole MLP moved
        assert _rel(g - x0, w - x0) <= SEQ_UPDATE_REL, (path, _rel(g - x0, w - x0))


# planted faults of the first call: (lr factor, MapperConfig changes)
FAULTS = {"lr_first_factor ignored": (1.0, {}),
          "colour loss dropped": (None, {"w_color_loss": 0.0}),
          "StepLR from the first iteration": (None, {"imap_decoders_lr": 0.0002 * 0.8})}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_leaves_the_first_calls_band(scene, fault):
    f = scene["frames"][0]
    jcfg = jm.MapperConfig.from_cfg(imap_cfg(j_load_config))
    tcfg = tm.MapperConfig.from_cfg(imap_cfg(load_config))
    jmap = jm.Mapper(jcfg, JCamera(*CAM), scene["jset"], BOUND, seed=SEED)
    jmap.optimize_map(tcfg.iters_first, tcfg.lr_first_factor, 0, f.color, f.depth, f.event,
                      f.c2w.copy(), seed=0, grids={}, decoders=scene["dj"])
    lr, change = FAULTS[fault]
    tmap = JaxDrawsMapper(tcfg._replace(**change), Camera(*CAM), scene["tset"], BOUND,
                          seed=SEED, device="cpu")
    tmap.optimize_map(tcfg.iters_first, lr or tcfg.lr_first_factor, 0, f.color, f.depth,
                      f.event, f.c2w.copy(), seed=0, grids={}, decoders=to_torch(scene["dj"]))
    got, want = float(tmap.last_loss), float(jmap.last_loss)
    assert abs(got - want) > CALL_LOSS_RTOL * want, (got, want)
