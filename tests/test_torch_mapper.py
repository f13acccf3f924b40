"""The mapper of the port (``slam/mapper.py``) against the JAX package's on
the CPU, at the small sizes of ``tests/test_slam.py`` (36x48 frames of the
synthetic scene, 120 pixels, window 3, grid_len coarse 0.8 / middle 0.4 /
fine 0.2): the same grids, decoders, frames and poses, and the JAX package's
pixel draws handed to the port (the JAX package draws iteration ``it`` of a
stage from ``fold_in(fold_in(PRNGKey(seed), stage), it)``; the port takes
one tensor of draws per stage).

Tolerances (measured on these inputs, then set with room; CHANGES.md):
- ``_map_loss``: the value at rtol 1e-5, each leaf's gradient at a relative
  L2 distance of 1e-4 (f32 rounding of two frameworks' sums);
- ``map_frame``, after 6 to 12 Adam steps: the loss of every iteration at
  rtol 1e-3, each leaf's update (parameter after minus before) at a relative
  L2 distance of 1e-2, the camera tensors at atol 1e-6 (BA lr 1e-3); a leaf
  the call does not optimise is left exactly as it was, on both sides;
- chunked against unchunked in the port: bitwise.
"""

import functools
import os
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.render.renderer import RenderSettings as JSettings
from evennicer_slam_tpu.slam import mapper as jm
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu.slam.keyframes import frustum_feature_mask as j_frustum_mask
from evennicer_slam_tpu.utils.optim import adam_init as j_adam_init
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.config import load_config
from evennicer_slam_tpu_torch.core.quaternion import tensor_from_pose_matrix_np
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam import mapper as tm
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.utils.optim import tree_leaves, tree_map

from torch_parity import assert_close, cap_threads, jax_to_np, t, to_torch

cap_threads()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 36, 48
CAM = (H, W, 60.0, 60.0, (W - 1) / 2.0, (H - 1) / 2.0)
ROOM = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)
# the map's bound as the pipeline derives it from the room's (2 cm out, the
# upper end rounded up to bound_divisible): no wall lies on the bound, where
# the inside test of a ray would turn on the last bit of its exit distance
BOUND = np.array([[-1.22, 1.38], [-1.02, 1.18], [-0.82, 0.98]], np.float32)
GRID_LEN = {"coarse": 0.8, "middle": 0.4, "fine": 0.2, "color": 0.2, "bound_divisible": 0.2}
MAPPING = {"iters_first": 12, "iters": 6, "every_frame": 2, "pixels": 120,
           "mapping_window_size": 3, "keyframe_every": 2, "BA": True}
LO = (int(H * 0.15), int(W * 0.15))

LOSS_RTOL = 1e-3
UPDATE_REL = 1e-2
CAMS_ATOL = 1e-6
GRAD_REL = 1e-4


def tiny_cfg(load=load_config, event=None, **mapping):
    cfg = load(os.path.join(ROOT, "configs", "nice_slam.yaml"))
    cfg["mapping"].update({**MAPPING, **mapping})
    cfg["grid_len"] = dict(GRID_LEN)
    if event is not None:
        cfg["event"] = dict(event)
    return cfg


# the net-free event predictor keeps the JAX compiles small
ESIM = {"predictor": "esim"}


@functools.partial(jax.jit, static_argnames=("K", "pix", "coarse"))
def _jax_iter_draws(seed, sid, it, K, pix, coarse):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), sid), it)
    if coarse:
        key = jax.random.fold_in(key, 2)
    return jax.vmap(lambda k: jax.random.randint(k, (pix,), 0, H * W))(
        jax.random.split(key, K))


def jax_draws(seed, stage, start, n, K, pix, coarse=False):
    """The JAX package's pixel draws of iterations [start, start + n) of a
    stage, as the port takes them: [n, K, pix]."""
    out = [np.asarray(_jax_iter_draws(np.uint32(seed), np.int32(tm.STAGE_IDS[stage]),
                                      np.int32(it), K=K, pix=pix, coarse=coarse))
           for it in range(start, start + n)]
    return torch.from_numpy(np.stack(out).astype(np.int64))


@pytest.fixture(scope="module")
def scene():
    frames = list(synthetic_frames(5, H, W, fx=60.0, fy=60.0, bound=ROOM, traj_step=0.02))
    gj = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    dj = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    # a map that is not all zeros at the start (the fine grid's init is 1e-4)
    gj = {k: v + 0.05 * jax.random.normal(jax.random.PRNGKey(9), v.shape) for k, v in gj.items()}
    return dict(frames=frames, gj=gj, dj=dj)


def _window(scene, ids, perturb=0.0):
    fr = [scene["frames"][i] for i in ids]
    fixed = np.stack([f.c2w for f in fr]).astype(np.float32)
    fixed[:, :3, 3] += perturb * np.arange(len(ids))[:, None]  # BA has work to do
    cams = np.stack([tensor_from_pose_matrix_np(m[:3]) for m in fixed])
    return (np.stack([f.color for f in fr]), np.stack([f.depth for f in fr]), fixed, cams)


def _flat(tree, path=()):
    """(path, leaf) pairs of nested dicts / lists / tuples, dict keys in
    sorted order: a JAX pytree and the port's tree line up leaf by leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---- configuration ------------------------------------------------------------------

def test_mapper_config_from_cfg_equals_the_jax_packages():
    cfg = tiny_cfg()
    got = tm.MapperConfig.from_cfg(cfg, use_events=True)
    want = jm.MapperConfig.from_cfg(tiny_cfg(j_load_config), use_events=True)
    assert got._fields == want._fields
    assert tuple(got) == tuple(want)
    assert got.stage_lr_dict("middle") == want.stage_lr_dict("middle")
    assert got.stage_lr_dict("color")["decoders"] == 0.005
    with pytest.raises(KeyError):
        got.stage_lr_dict("nope")


@pytest.mark.parametrize("case", ["keyframe_every", "concurrent"])
def test_mapper_config_warnings(case):
    over = ({"keyframe_every": 3} if case == "keyframe_every" else {})
    cfg, jcfg = tiny_cfg(**over), tiny_cfg(j_load_config, **over)
    if case == "concurrent":
        for c in (cfg, jcfg):
            c["sync_method"] = "loose"
            c["parallel"] = {"map_devices": 1}
    for fn, c in ((tm.MapperConfig.from_cfg, cfg), (jm.MapperConfig.from_cfg, jcfg)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn(c)
        msgs = [str(w.message) for w in rec]
        assert len(msgs) == 1, msgs
        assert ("lcm=6" if case == "keyframe_every" else "keyframe_catchup") in msgs[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm.MapperConfig.from_cfg(tiny_cfg())


def test_mapper_config_checks_prev_resize():
    """A deliberate divergence: the JAX package takes any value here."""
    cfg, jcfg = tiny_cfg(), tiny_cfg(j_load_config)
    for c in (cfg, jcfg):
        c["event"] = {"prev_resize": "bicubic"}
    assert jm.MapperConfig.from_cfg(jcfg).prev_resize == "bicubic"
    with pytest.raises(ValueError, match="prev_resize"):
        tm.MapperConfig.from_cfg(cfg)
    cfg["event"] = {"prev_resize": "bilinear"}
    assert tm.MapperConfig.from_cfg(cfg).prev_resize == "bilinear"


# ---- the loss -------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "cam", "settings", "stage", "ba",
                                             "coarse_mapper", "pix"))
def _jax_map_loss(params, fixed, colors, depths, bound, key, cfg, cam, settings, stage, ba,
                  coarse_mapper, pix):
    return jax.value_and_grad(jm._map_loss)(params, fixed, colors, depths, bound, key, cfg,
                                            cam, settings, stage, ba, coarse_mapper, pix)


@pytest.mark.parametrize("stage,ba,coarse_mapper", [
    ("middle", False, False), ("fine", False, False), ("color", False, False),
    ("color", True, False), ("coarse", False, True),
])
def test_map_loss_value_and_gradients(scene, stage, ba, coarse_mapper):
    colors, depths, fixed, cams = _window(scene, (0, 2, 4), perturb=0.01)
    cfg_t, cfg_j = tm.MapperConfig.from_cfg(tiny_cfg()), jm.MapperConfig.from_cfg(
        tiny_cfg(j_load_config))
    K, pix = 3, 40
    key = jax.random.PRNGKey(17)
    params_j = (scene["gj"], scene["dj"], jnp.asarray(cams))
    loss_j, grads_j = _jax_map_loss(params_j, jnp.asarray(fixed), jnp.asarray(colors),
                                    jnp.asarray(depths), jnp.asarray(BOUND), key, cfg_j,
                                    JCamera(*CAM), JSettings(), stage, ba, coarse_mapper, pix)
    draws = torch.from_numpy(np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (pix,), 0, H * W))(jax.random.split(key, K))
    ).astype(np.int64))
    params_t = tree_map(lambda x: x.requires_grad_(), to_torch(params_j))
    params_t = (params_t[0], params_t[1], params_t[2])
    loss_t = tm._map_loss(params_t, t(fixed), t(colors), t(depths), t(BOUND), draws, cfg_t,
                          Camera(*CAM), RenderSettings(), stage, ba, coarse_mapper)
    paths, leaves = zip(*_flat(params_t))
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    assert_close(loss_t, loss_j, atol=0.0, rtol=1e-5)
    n_nonzero = 0
    flat_j = _flat(grads_j)
    assert [p for p, _ in flat_j] == list(paths)
    for g, (path, gj) in zip(grads_t, flat_j):
        gj = np.asarray(gj)
        g = np.zeros(gj.shape, np.float32) if g is None else g.numpy()
        assert g.shape == gj.shape
        if not np.any(gj):
            assert not np.any(g), path
            continue
        n_nonzero += 1
        assert _rel(g, gj) <= GRAD_REL, (path, _rel(g, gj))
    assert n_nonzero >= 3
    if not ba:
        assert not np.any(np.asarray(grads_j[2]))


# ---- one mapping call --------------------------------------------------------------------

def _jax_call(scene, v):
    """The JAX package's ``map_frame_jit``, one iteration a call (it is
    chunked bitwise), Adam state made on the host: per-iteration losses."""
    cfg = jm.MapperConfig.from_cfg(tiny_cfg(j_load_config, event=ESIM),
                                   use_events=v["use_events"])
    params = (scene["gj"], scene["dj"], jnp.asarray(v["cams"]))
    adam = j_adam_init(params, per_leaf_t=True)
    adam_ev = j_adam_init(params, per_leaf_t=True) if v["use_events"] else None
    spans, acc = {}, 0
    for s in v["stages"]:
        spans[s] = (acc, acc + v["seg"][s])
        acc += v["seg"][s]
    losses, ev_losses = [], []
    grids, decoders, cams = params
    for it in range(acc):
        seg_lens = {s: np.int32(int(spans[s][0] <= it < spans[s][1])) for s in v["stages"]}
        seg_starts = {s: np.int32(min(max(it - spans[s][0], 0), v["seg"][s]))
                      for s in v["stages"]}
        out = jm.map_frame_jit(
            grids, decoders, cams, adam, adam_ev, jnp.asarray(v["fixed"]), jnp.asarray(v["opt"]),
            jnp.asarray(v["colors"]), jnp.asarray(v["depths"]),
            {k: jnp.asarray(m) for k, m in v["masks"].items()}, jnp.asarray(BOUND),
            np.uint32(v["seed"]), seg_lens, seg_starts, np.float32(v["lr_factor"]),
            jnp.asarray(v["prev_lo"]), jnp.asarray(v["ev_lo"]), jnp.asarray(v["depth_lo"]), {},
            np.float32(v["balancer"]), jnp.asarray(v["colors_c"]), jnp.asarray(v["depths_c"]),
            jnp.asarray(v["fixed_c"]), cfg, JCamera(*CAM), JSettings(), v["ba"], False,
            v["pix"], v["use_frustum"], v["stages"], v["use_events"], v["fix_color_now"],
            v["fuse"], v["pix_c"], None, init_adam=False)
        grids, decoders, cams, adam, adam_ev = out[:5]
        losses.append(float(out[5]))
        ev_losses.append(float(out[6]))
    return (grids, decoders, cams), np.array(losses), np.array(ev_losses)


def _port_call(scene, v, chunk=1):
    """The port's ``map_frame`` over the same iterations, ``chunk`` at a
    time (1: a loss per iteration)."""
    cfg = tm.MapperConfig.from_cfg(tiny_cfg(event=ESIM), use_events=v["use_events"])
    spans, acc = {}, 0
    for s in v["stages"]:
        spans[s] = (acc, acc + v["seg"][s])
        acc += v["seg"][s]
    draws = {s: jax_draws(v["seed"], s, 0, v["seg"][s], v["K"], v["pix"]) for s in v["stages"]}
    draws_c = ({s: jax_draws(v["seed"], s, 0, v["seg"][s], v["Kc"], v["pix_c"], coarse=True)
                for s in v["stages"]} if v["fuse"] else None)
    params = (to_torch(scene["gj"]), to_torch(scene["dj"]), t(v["cams"]))
    adam = adam_ev = None
    losses, ev_losses = [], []
    for a in range(0, acc, chunk):
        b = min(a + chunk, acc)
        seg_lens = {s: max(0, min(b, spans[s][1]) - max(a, spans[s][0])) for s in v["stages"]}
        starts = {s: max(0, min(a, spans[s][1]) - spans[s][0]) for s in v["stages"]}

        def sl(d):
            return None if d is None else {s: d[s][starts[s]: starts[s] + seg_lens[s]]
                                           for s in v["stages"]}

        out = tm.map_frame(
            *params, adam, adam_ev, t(v["fixed"]), t(v["opt"]), t(v["colors"]), t(v["depths"]),
            {k: t(m) for k, m in v["masks"].items()}, t(BOUND), sl(draws), seg_lens,
            v["lr_factor"], t(v["prev_lo"]), t(v["ev_lo"]), t(v["depth_lo"]), {}, v["balancer"],
            t(v["colors_c"]), t(v["depths_c"]), t(v["fixed_c"]), sl(draws_c), cfg, Camera(*CAM),
            RenderSettings(), v["ba"], False, v["use_frustum"], v["stages"], v["use_events"],
            v["fix_color_now"], v["fuse"], init_adam=(a == 0), device="cpu")
        params, (adam, adam_ev) = out[:3], out[3:5]
        losses.append(float(out[5]))
        ev_losses.append(float(out[6]))
    return params, np.array(losses), np.array(ev_losses), (adam, adam_ev)


def _variant(scene, name):
    fr = scene["frames"]
    cam_j = JCamera(*CAM)
    if name == "first":
        # the first call: the current frame alone, lr x 5, all three stages
        colors, depths, fixed, cams = _window(scene, (0,))
        ids_c, stages, seg, lr_factor = (0,), ("middle", "fine", "color"), 12, 5.0
        ba, fuse, use_frustum, use_events, fix_now = False, True, True, False, False
    elif name == "steady":
        colors, depths, fixed, cams = _window(scene, (0, 2, 4), perturb=0.01)
        ids_c, stages, seg, lr_factor = (2, 0, 4), ("middle", "fine", "color"), 6, 1.0
        ba, fuse, use_frustum, use_events, fix_now = True, True, True, True, False
    else:  # colour refinement
        colors, depths, fixed, cams = _window(scene, (0, 2, 4))
        ids_c, stages, seg, lr_factor = (0,), ("color",), 6, 1.0
        ba, fuse, use_frustum, use_events, fix_now = False, False, False, False, True
    K = len(colors)
    cfg = tm.MapperConfig.from_cfg(tiny_cfg())
    _, seg = tm.stage_schedule(seg, cfg, False, name == "refine")
    colors_c, depths_c, fixed_c, _ = _window(scene, ids_c)
    masks = {}
    for lvl, g in scene["gj"].items():
        if use_frustum and lvl != "coarse":
            masks[lvl] = j_frustum_mask(fixed[-1], g.shape[:3], depths[-1], BOUND,
                                        cam_j)[..., None].astype(np.float32)
        else:
            masks[lvl] = np.ones(g.shape[:3] + (1,), np.float32)
    rng = np.random.default_rng(2)
    pix = 120 // K
    return dict(
        stages=stages, seg=seg, lr_factor=lr_factor, ba=ba, fuse=fuse, use_frustum=use_frustum,
        use_events=use_events, fix_color_now=fix_now, seed=11, K=K, pix=pix,
        Kc=len(ids_c), pix_c=120 // len(ids_c), colors=colors, depths=depths, fixed=fixed,
        cams=cams, opt=np.array([0.0] + [1.0] * (K - 1), np.float32),
        colors_c=colors_c, depths_c=depths_c, fixed_c=fixed_c, masks=masks,
        prev_lo=rng.random(LO + (3,)).astype(np.float32),
        ev_lo=(fr[4].event[::7, ::7][: LO[0], : LO[1]]).astype(np.float32),
        depth_lo=rng.uniform(0.5, 2.0, LO[0] * LO[1]).astype(np.float32),
        balancer=(pix * K) / (LO[0] * LO[1]) / 100.0 if use_events else 0.0,
    )


@pytest.mark.parametrize("name", ["first", "steady", "refine"])
def test_map_frame_matches_jax(scene, name):
    v = _variant(scene, name)
    want, losses_j, ev_j = _jax_call(scene, v)
    got, losses_t, ev_t, _ = _port_call(scene, v)
    n_iters = sum(v["seg"].values())
    assert losses_t.shape == (n_iters,) and np.all(np.isfinite(losses_t))
    np.testing.assert_allclose(losses_t, losses_j, rtol=LOSS_RTOL)
    if v["use_events"]:
        assert np.all(ev_t > 0)
        np.testing.assert_allclose(ev_t, ev_j, rtol=LOSS_RTOL)
    else:
        assert not np.any(ev_t)
    p0 = (jax_to_np(scene["gj"]), jax_to_np(scene["dj"]), v["cams"])
    n_moved = 0
    for (path, g), (_, w), (_, x0) in zip(_flat(got[:2]), _flat(want[:2]), _flat(p0[:2])):
        g, w, x0 = _np(g), _np(w), _np(x0)
        if np.array_equal(w, x0):  # not optimised by this call: untouched on both sides
            np.testing.assert_array_equal(g, x0, err_msg=str(path))
            continue
        n_moved += 1
        assert _rel(g - x0, w - x0) <= UPDATE_REL, (path, _rel(g - x0, w - x0))
    assert n_moved >= (4 if name != "refine" else 3)
    assert_close(got[2], want[2], atol=CAMS_ATOL)
    if v["ba"]:
        assert np.abs(got[2].numpy() - v["cams"]).max() > 1e-4  # BA moved the poses
        np.testing.assert_array_equal(got[2][0].numpy(), v["cams"][0])  # the anchor
    else:
        np.testing.assert_array_equal(got[2].numpy(), v["cams"])
    # the fused coarse term moves the coarse grid; without it the grid stays
    moved_coarse = not np.array_equal(got[0]["coarse"].numpy(), p0[0]["coarse"])
    assert moved_coarse == v["fuse"]


def test_map_frame_chunked_equals_unchunked_bitwise(scene):
    v = _variant(scene, "steady")
    v["use_events"] = False
    whole, losses_w, _, adam_w = _port_call(scene, v, chunk=10**6)
    for chunk in (1, 4):
        parts, losses_c, _, adam_c = _port_call(scene, v, chunk=chunk)
        for a, b in zip(tree_leaves(whole), tree_leaves(parts)):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(tuple(adam_w[0])), tree_leaves(tuple(adam_c[0]))):
            assert torch.equal(a, b)
        assert losses_c[-1] == losses_w[-1]


def test_map_frame_and_mapper_refuse_what_is_not_ported():
    """Without a device the mapper means the CUDA device, and refuses where
    there is none (iMAP and the regulation are ported:
    ``test_torch_imap_mapping.py``)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.Mapper(tm.MapperConfig(), Camera(*CAM), RenderSettings(), BOUND)


def test_mapper_adam_state_carries_across(scene):
    params = (scene["gj"], scene["dj"], jnp.ones((3, 7)))
    st = j_adam_init(params, per_leaf_t=True)
    st = st._replace(m=jax.tree.map(lambda x: x + 0.5, st.m))
    got = convert.mapper_adam_state_from_numpy(jax_to_np(st.m), jax_to_np(st.v),
                                               jax_to_np(st.t), device="cpu")
    assert isinstance(got.m, tuple) and len(got.m) == 3
    for a, b in zip(tree_leaves(got.m), jax.tree.leaves(st.m)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert all(x.dtype == torch.int32 for x in tree_leaves(got.t))
