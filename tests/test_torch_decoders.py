"""The port's NICE decoders against the JAX package's on the CPU: all four
``nice_forward`` stages with weights made by the JAX package and carried
across (f32 on both sides, atol 2e-5: sums of a few hundred products in
another order), gradients, the detach on the middle features, and the
port's own initialisation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import grid_shapes as j_grid_shapes
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu_torch.models import decoders as td
from evennicer_slam_tpu_torch.models import grids as tgr

from torch_parity import assert_close, cap_threads, t, to_torch

cap_threads()
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
ATOL = 2e-5


@pytest.fixture(scope="module")
def scene():
    grids = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    grids = {k: v + 0.3 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
             for k, v in grids.items()}
    decoders = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    rng = np.random.default_rng(3)
    p = (rng.uniform(-1.1, 1.1, (600, 3)) * [1.0, 0.8, 0.6]).astype(np.float32)
    return decoders, grids, to_torch(decoders), to_torch(grids), p


@pytest.mark.parametrize("stage", ["coarse", "middle", "fine", "color"])
def test_nice_forward_stage(scene, stage):
    dj, gj, dt, gt, p = scene
    want = jd.nice_forward(dj, gj, jnp.asarray(p), jnp.asarray(BOUND), stage)
    got = td.nice_forward(dt, gt, t(p), t(BOUND), stage)
    assert tuple(got.shape) == (600, 4)
    assert_close(got, want, ATOL)
    assert_close(td.decoder_forward(dt, gt, t(p), t(BOUND), stage), want, ATOL)


def test_unknown_stage_raises(scene):
    _, _, dt, gt, p = scene
    with pytest.raises(ValueError):
        td.nice_forward(dt, gt, t(p), t(BOUND), "finest")


def test_color_stage_point_gradient(scene):
    dj, gj, dt, gt, p = scene
    w = jnp.array([1.0, -0.5, 0.25, 2.0])
    g_want = np.asarray(jax.grad(lambda q: jnp.sum(
        jd.nice_forward(dj, gj, q, jnp.asarray(BOUND), "color") * w))(jnp.asarray(p)))
    q = t(p).requires_grad_()
    (td.nice_forward(dt, gt, q, t(BOUND), "color") * t(w)).sum().backward()
    rel = np.linalg.norm(q.grad.numpy() - g_want) / np.linalg.norm(g_want)
    assert rel < 1e-4, rel


def test_fine_stage_detaches_middle_features(scene):
    """The middle grid gets its fine-stage gradient through the middle
    decoder only: the copy concatenated into the fine feature is detached."""
    dj, gj, dt, gt, p = scene
    g_want = jax.grad(lambda g: jnp.sum(jd.nice_forward(
        dj, {**gj, "middle": g}, jnp.asarray(p), jnp.asarray(BOUND), "fine")))(gj["middle"])
    m = gt["middle"].clone().requires_grad_()
    td.nice_forward(dt, {**gt, "middle": m}, t(p), t(BOUND), "fine").sum().backward()
    assert_close(m.grad, g_want, 1e-4)


def test_grid_shapes_and_init():
    want = j_grid_shapes(BOUND, GRID_LEN, coarse=True)
    assert tgr.grid_shapes(BOUND, GRID_LEN, coarse=True) == want
    gen = torch.Generator().manual_seed(0)
    g = tgr.init_grids(gen, BOUND, GRID_LEN, c_dim=32, coarse=True, device="cpu")
    assert set(g) == {"coarse", "middle", "fine", "color"}
    for level, shape in want.items():
        assert tuple(g[level].shape) == (*shape, 32)
        std = float(g[level].std())
        assert 0.5 * tgr.GRID_INIT_STD[level] < std < 1.5 * tgr.GRID_INIT_STD[level]
    assert "coarse" not in tgr.init_grids(gen, BOUND, GRID_LEN, 32, coarse=False, device="cpu")


def test_init_nice_decoders_has_the_jax_layout(scene):
    dj = scene[0]
    dt = td.init_nice_decoders(torch.Generator().manual_seed(0), coarse=True, device="cpu")
    assert set(dt) == set(dj)
    for name, m in dj.items():
        assert set(dt[name]) == set(m), name
        for key, val in m.items():
            if isinstance(val, (list, tuple)):
                assert [tuple(x.shape) for x in dt[name][key]] == [x.shape for x in val]
            else:
                assert tuple(dt[name][key].shape) == val.shape
    B = dt["middle"]["B"]
    assert 15 < float(B.std()) < 35  # N(0, 25^2)
    assert all(float(b.abs().max()) == 0 for b in dt["fine"]["lin_b"])
    # and the drawn weights run
    gen = torch.Generator().manual_seed(1)
    grids = tgr.init_grids(gen, BOUND, GRID_LEN, 32, coarse=True, device="cpu")
    raw = td.nice_forward(dt, grids, t(scene[4]), t(BOUND), "color")
    assert torch.isfinite(raw).all()


@pytest.mark.parametrize("method", ["same", "nerf", "fc_relu"])
def test_other_embeddings_wait_for_their_slice(method):
    with pytest.raises(NotImplementedError, match="slice"):
        td.init_nice_decoders(torch.Generator().manual_seed(0),
                              pos_embedding_method=method, device="cpu")


def test_imap_waits_for_its_slice():
    with pytest.raises(NotImplementedError, match="slice"):
        td.init_imap_decoder(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        td.decoder_forward({}, None, torch.zeros(2, 3), t(BOUND), "color", nice=False)
    with pytest.raises(ValueError):
        td.init_nice_decoders(torch.Generator().manual_seed(0),
                              pos_embedding_method="wavelet", device="cpu")
