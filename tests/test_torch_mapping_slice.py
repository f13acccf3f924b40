"""The mapping slice as a whole on the CPU: the port's ``Mapper`` against the
JAX package's over a 5-frame sequence of the synthetic scene (36x48),
mapped every 2nd frame with ``keyframe_every`` 2 and the coarse mapper
fused, as the pipeline drives it: the first call from frame 0 (lr x 5,
``iters_first``), then steady calls; BA forced on for the last call so that
both write-backs run. Both branches of ``optimize_map``: numpy poses (host
selection and write-back) and device poses (device selection, assembly,
frustum masks and write-back from the second keyframe on).

The same seeds on both sides; the JAX package's pixel and selection draws
are handed to the port by overriding its two draw methods.

Tolerances: the last loss of each call at rtol 1e-3; each grid's and
decoder leaf's change over the sequence at a relative L2 distance of 0.1
(measured up to 0.05, in the colour decoder); the two final maps rendered at
the last frame: depth L1 against the frame within 1e-3 relative of each
other, mean absolute differences of depth 1e-3 m and colour 3e-2 (measured
1.3e-4 and 1.0e-2). Over several calls the leaves drift apart by more than
one call's 1e-2 (``test_torch_mapper.py``): the colour MLP's sine reads
arguments up to 165 (25-scale Fourier features), so the f32 rounding of a
sample point moves it by up to 3e-5, now and then flipping a ReLU whose
input sits that close to zero; where one such point carries much of a
gradient (a few per cent of the colour decoder's first layers, measured
against float64), Adam's first step, lr * sign(g), turns it into steps of
2 lr apart at the elements whose gradient is small. The JAX package shows the
same against float64, at other draws.
poses written back by BA at atol 3e-4, under a third of one BA step
(``BA_cam_lr`` 1e-3): by the last call the map that the pose gradients see
differs by about 1e-4 relative between the two sides, and Adam's step
lr * m / sqrt(v) turns a small difference in a gradient component near zero
into a visible part of a step (1.5e-4 measured, device branch).
"""

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
from evennicer_slam_tpu_torch.core.rays import get_rays
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames
from evennicer_slam_tpu_torch.render.renderer import RenderSettings, render_rays
from evennicer_slam_tpu_torch.slam import mapper as tm
from evennicer_slam_tpu_torch.slam.camera import Camera

from test_torch_mapper import (
    BOUND, CAM, GRID_LEN, H, ROOM, W, _flat, _np, _rel, jax_draws, tiny_cfg,
)
from torch_parity import assert_close, cap_threads, jax_to_np, t, to_torch

cap_threads()
N_FRAMES = 5
SEED = 1234
POSE_ATOL = 3e-4
SEQ_UPDATE_REL = 0.1
RENDER_DEPTH_ATOL = 1e-3
RENDER_COLOR_ATOL = 3e-2


class JaxDrawsMapper(tm.Mapper):
    """The port's mapper with the JAX package's random draws."""

    def _draw_pixels(self, seed, stage, term, n, K, pix):
        return jax_draws(seed, stage, 0, n, K, pix, coarse=bool(term))

    def _selection_draws(self, seed, n_kf):
        k_pix, k_pri = jax.random.split(jax.random.PRNGKey(np.uint32(seed * 2 + 1)))
        idx = np.asarray(jax.random.randint(k_pix, (100,), 0, H * W)).astype(np.int64)
        return torch.from_numpy(idx), t(np.asarray(jax.random.uniform(k_pri, (n_kf - 1,))))


@pytest.fixture(scope="module")
def sequence():
    frames = list(synthetic_frames(N_FRAMES, H, W, fx=60.0, fy=60.0, bound=ROOM,
                                   traj_step=0.02))
    rng = np.random.default_rng(4)
    est = []
    for f in frames:  # tracked estimates: a few millimetres off
        m = f.c2w.copy()
        m[:3, 3] += rng.normal(0.0, 0.003, 3).astype(np.float32)
        est.append(m)
    est[0] = frames[0].c2w.copy()
    gj = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    dj = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    return dict(frames=frames, est=est, gj=gj, dj=dj)


@pytest.mark.parametrize("branch", ["host", "device"])
def test_mapper_matches_jax_over_a_sequence(sequence, branch):
    frames, est = sequence["frames"], sequence["est"]
    jcfg = jm.MapperConfig.from_cfg(tiny_cfg(j_load_config))
    tcfg = tm.MapperConfig.from_cfg(tiny_cfg())
    jmap = jm.Mapper(jcfg, JCamera(*CAM), JSettings(), BOUND, seed=SEED)
    tmap = JaxDrawsMapper(tcfg, Camera(*CAM), RenderSettings(), BOUND, seed=SEED, device="cpu")
    jmap.fuse_coarse = tmap.fuse_coarse = True
    gj, dj = sequence["gj"], sequence["dj"]
    gt, dt = to_torch(gj), to_torch(dj)
    n_ba = 0
    for idx in range(0, N_FRAMES, 2):
        f = frames[idx]
        init = idx == 0
        num, lr = (tcfg.iters_first, tcfg.lr_first_factor) if init else (tcfg.iters, tcfg.lr_factor)
        dev = branch == "device" and not init  # the first call takes the host pose
        pose_j = jnp.asarray(est[idx]) if dev else est[idx].copy()
        pose_t = t(est[idx]) if dev else est[idx].copy()
        for m in (jmap, tmap):
            m.update_ba_state()
            m.BA_active = idx == N_FRAMES - 1  # both BA write-backs get to run
        gj, dj, new_j = jmap.optimize_map(num, lr, idx, f.color, f.depth, f.event, pose_j,
                                          seed=idx * 97, grids=gj, decoders=dj)
        gt, dt, new_t = tmap.optimize_map(num, lr, idx, f.color, f.depth, f.event, pose_t,
                                          seed=idx * 97, grids=gt, decoders=dt)
        assert isinstance(tmap.last_loss, torch.Tensor)
        assert_close(tmap.last_loss, float(jmap.last_loss), atol=0.0, rtol=1e-3,
                     msg=f"last loss, frame {idx}")
        assert (new_t is None) == (new_j is None)
        if new_t is not None:
            n_ba += 1
            assert isinstance(new_t, torch.Tensor) == dev
            assert_close(new_t, np.asarray(new_j), atol=POSE_ATOL)
            assert np.abs(_np(new_t) - est[idx]).max() > 1e-5  # BA moved it
            pose_j, pose_t = new_j, new_t
        jmap.maybe_add_keyframe(idx, N_FRAMES, f.color, f.depth, f.event, pose_j, f.c2w)
        tmap.maybe_add_keyframe(idx, N_FRAMES, f.color, f.depth, f.event, pose_t, f.c2w)
        assert tmap.keyframes.indices == jmap.keyframes.indices
        assert tmap.keyframes.host_poses_stale == jmap.keyframes.host_poses_stale
    assert n_ba == 1 and tmap.keyframes.indices == [0, 2, 4]
    # the numpy selection streams made the same calls
    assert tmap.rng.integers(1 << 30) == jmap.rng.integers(1 << 30)
    assert tmap.rng_coarse.integers(1 << 30) == jmap.rng_coarse.integers(1 << 30)
    # keyframe poses after BA (device truth synced to the host rows)
    jmap.keyframes.sync_host_poses()
    tmap.keyframes.sync_host_poses()
    for a, b in zip(tmap.keyframes.frames, jmap.keyframes.frames):
        np.testing.assert_allclose(a["est_c2w"], b["est_c2w"], atol=POSE_ATOL)
    # the map over the whole sequence
    p0 = (jax_to_np(sequence["gj"]), jax_to_np(sequence["dj"]))
    rels = {}
    for (path, g), (_, w), (_, x0) in zip(_flat((gt, dt)), _flat((gj, dj)), _flat(p0)):
        g, w, x0 = _np(g), _np(w), _np(x0)
        if np.array_equal(w, x0):
            np.testing.assert_array_equal(g, x0, err_msg=str(path))
            continue
        rels[path] = _rel(g - x0, w - x0)
    assert len(rels) >= 4
    worst = max(rels, key=rels.get)
    assert rels[worst] <= SEQ_UPDATE_REL, (worst, rels[worst])
    # the two maps rendered at the last frame's true pose
    f = frames[-1]
    ro, rd = get_rays(H, W, CAM[2], CAM[3], CAM[4], CAM[5], t(f.c2w))
    gt_depth = t(f.depth).reshape(-1)
    outs = []
    for g, d in ((gt, dt), (to_torch(gj), to_torch(dj))):
        with torch.no_grad():
            outs.append(render_rays(d, g, ro.reshape(-1, 3), rd.reshape(-1, 3), t(BOUND), "color",
                                    RenderSettings(), gt_depth=gt_depth))
    l1 = [float((o[0] - gt_depth).abs().mean()) for o in outs]
    assert abs(l1[0] - l1[1]) <= 1e-3 * l1[1], l1
    assert float((outs[0][0] - outs[1][0]).abs().mean()) <= RENDER_DEPTH_ATOL
    assert float((outs[0][2] - outs[1][2]).abs().mean()) <= RENDER_COLOR_ATOL


def test_chunked_optimize_map_equals_unchunked_bitwise(sequence):
    """``vis_callback`` splits a call into chunks; the result is the same to
    the last bit (the draws of the call are made once and sliced)."""
    f = sequence["frames"][0]
    outs, seen = [], []
    for freq in (0, 5):
        m = tm.Mapper(tm.MapperConfig.from_cfg(tiny_cfg()), Camera(*CAM), RenderSettings(),
                      BOUND, seed=SEED, device="cpu")
        m.fuse_coarse = True
        cb = (lambda it, g, d, c: seen.append(it)) if freq else None
        outs.append(m.optimize_map(12, 5.0, 0, f.color, f.depth, f.event, f.c2w.copy(), seed=3,
                                   grids=to_torch(sequence["gj"]),
                                   decoders=to_torch(sequence["dj"]), vis_callback=cb,
                                   vis_inside_freq=freq))
    assert seen == [0, 5, 10]
    for (_, a), (_, b) in zip(_flat(outs[0][:2]), _flat(outs[1][:2])):
        assert torch.equal(a, b)
