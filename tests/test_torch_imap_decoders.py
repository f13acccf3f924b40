"""The port's positional embeddings and iMAP decoder against the JAX
package's on the CPU: ``_init_mlp`` parameters made by the JAX package for
each of ``fourier`` / ``same`` / ``nerf`` / ``fc_relu``, both for a NICE MLP
(width 32, five blocks, skip at block 2, grid features injected) and for the
iMAP MLP (width 256, four blocks, no skip, no features), carried across by
``convert`` and run through the port's ``_mlp_forward``.

Tolerances (f32 on both sides; the two frameworks sum their products in
other orders):
- values at rtol 1e-5 with atol 1e-5 x the largest output (measured at most
  4.7e-7 x; the Fourier sines read arguments up to ~100, where one ulp of the
  argument is 7.6e-6);
- the gradient with respect to the points and to every leaf at a relative L2
  distance of 1e-5 (measured at most 3.6e-7);
- a NICE trio with a non-Fourier embedding through ``nice_forward_packed``
  (the bf16 plain ops: the fused kernels cover the Fourier trio only) against
  the JAX package's f32 ``nice_forward``: in aggregate, relative L2 distance
  under 1e-2 (JAX on the CPU folds bf16 round trips away, so an elementwise
  comparison of two bf16 paths is not possible here)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.config import get_model as j_get_model
from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu_torch import config as tconfig
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.models import decoders as td
from evennicer_slam_tpu_torch.ops import fused_decode

from torch_parity import cap_threads, jax_to_np, t, to_torch

cap_threads()
N = 300
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
VALUE_RTOL = 1e-5
GRAD_REL = 1e-5
PACKED_REL = 1e-2
# (c_dim, hidden, n_blocks, skips, color, concat_feature, name)
MLPS = {"nice": (32, 32, 5, (2,), True, False, "color"),
        "imap": (0, 256, 4, (), True, False, "imap")}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(c_dim, seed=3):
    rng = np.random.default_rng(seed)
    p = (rng.uniform(-1.0, 1.0, (N, 3)) * [1.0, 0.8, 0.6]).astype(np.float32)
    feat = rng.normal(0.0, 0.3, (N, c_dim)).astype(np.float32) if c_dim else None
    w = np.array([1.0, -0.5, 0.25, 2.0], np.float32)
    return p, feat, w


def _assert_values(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL,
                               atol=VALUE_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("mlp", sorted(MLPS))
@pytest.mark.parametrize("method", td.POS_EMBEDDING_METHODS)
def test_mlp_values_and_gradients_match_the_jax_package(method, mlp):
    c_dim, hidden, n_blocks, skips, color, concat, name = MLPS[mlp]
    params_j = jd._init_mlp(jax.random.PRNGKey(5), c_dim, hidden, n_blocks, skips, color,
                            concat, pos_embedding_method=method, name=name)
    p, feat, w = _inputs(c_dim)
    feat_j = None if feat is None else jnp.asarray(feat)

    def loss_j(params, q):
        return jnp.sum(jd._mlp_forward(params, q, feat_j) * w)

    want = jd._mlp_forward(params_j, jnp.asarray(p), feat_j)
    g_params_j, g_p_j = jax.grad(loss_j, argnums=(0, 1))(params_j, jnp.asarray(p))

    params_t = {k: v for k, v in to_torch(params_j).items()}
    leaves = [x.requires_grad_() for _, x in _flat(params_t)]
    q = t(p).requires_grad_()
    got = td._mlp_forward(params_t, q, None if feat is None else t(feat))
    assert tuple(got.shape) == (N, 4)
    _assert_values(got, want)
    grads = torch.autograd.grad((got * t(w)).sum(), [q] + leaves)
    assert _rel(grads[0], g_p_j) <= GRAD_REL
    flat_j = _flat(g_params_j)
    assert [path for path, _ in flat_j] == [path for path, _ in _flat(params_t)]
    for g, (path, gj) in zip(grads[1:], flat_j):
        assert _rel(g, gj) <= GRAD_REL, (path, _rel(g, gj))


def test_nerf_bands_of_a_colour_mlp_and_of_the_others():
    colour = td._nerf_freq_bands("color")
    other = td._nerf_freq_bands("middle")
    np.testing.assert_array_equal(colour.numpy(), np.asarray(jd._nerf_freq_bands("color")))
    np.testing.assert_array_equal(other.numpy(), np.asarray(jd._nerf_freq_bands("fine")))
    assert colour.tolist() == [2.0 ** k for k in range(10)]  # log-spaced, 1 to 512
    np.testing.assert_allclose(other.numpy(), [1.0, 4.75, 8.5, 12.25, 16.0])  # linear
    dec = td.init_nice_decoders(torch.Generator().manual_seed(0),
                                pos_embedding_method="nerf", device="cpu")
    assert dec["color"]["nerf_freqs"].shape == (10,)
    assert dec["middle"]["lin_w"][0].shape == (3 + 6 * 5, 32)
    assert dec["color"]["lin_w"][0].shape == (3 + 6 * 10, 32)


@pytest.mark.parametrize("method", td.POS_EMBEDDING_METHODS)
def test_init_imap_decoder_has_the_jax_layout(method):
    dj = jd.init_imap_decoder(jax.random.PRNGKey(0), pos_embedding_method=method)
    dt = td.init_imap_decoder(torch.Generator().manual_seed(0), pos_embedding_method=method,
                              device="cpu")
    assert [(path, tuple(x.shape)) for path, x in _flat(dt)] == [
        (path, tuple(x.shape)) for path, x in _flat(dj)]
    assert all(float(b.abs().max()) == 0 for b in dt["imap"]["lin_b"])
    p, _, _ = _inputs(0)
    raw = td.decoder_forward(dt, None, t(p), t(BOUND), "color", nice=False)
    assert tuple(raw.shape) == (N, 4) and torch.isfinite(raw).all()


def test_imap_forward_and_decoder_forward_match_the_jax_package():
    """The iMAP decoder of the shipped imap.yaml (through both packages'
    ``get_model``, carried across): ``imap_forward`` and
    ``decoder_forward(nice=False)`` ignore grids and stage."""
    cfg_j = j_load_config(tconfig.default_config_path(False))
    dj = j_get_model(cfg_j, nice=False)
    dt = convert.decoders_from_numpy(jax_to_np(dj), device="cpu")
    p, _, _ = _inputs(0, seed=8)
    want = jd.imap_forward(dj, jnp.asarray(p))
    _assert_values(td.imap_forward(dt, t(p)), want)
    for stage in ("middle", "color"):
        got = td.decoder_forward(dt, {}, t(p), t(BOUND), stage, nice=False)
        _assert_values(got, jd.decoder_forward(dj, {}, jnp.asarray(p), jnp.asarray(BOUND),
                                               stage, nice=False))
    # the port's own iMAP decoder, seeded by the configuration
    cfg = tconfig.load_config(tconfig.default_config_path(False))
    a = tconfig.get_model(cfg, nice=False, device="cpu")
    b = tconfig.get_model(cfg, nice=False, device="cpu")
    assert set(a) == {"imap"} and a["imap"]["lin_w"][0].shape == (93, 256)
    assert torch.equal(a["imap"]["out_w"], b["imap"]["out_w"])


@pytest.mark.parametrize("method", ["same", "nerf", "fc_relu"])
def test_a_non_fourier_trio_decodes_through_the_plain_packed_ops(method):
    gj = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=False)
    gj = {k: v + 0.3 * jax.random.normal(jax.random.PRNGKey(7), v.shape) for k, v in gj.items()}
    dj = jd.init_nice_decoders(jax.random.PRNGKey(1), pos_embedding_method=method)
    dt, gt = to_torch(dj), to_torch(gj)
    assert not fused_decode.supports(dt)  # decided by the configuration
    p, _, _ = _inputs(0, seed=4)
    want = np.asarray(jd.nice_forward(dj, gj, jnp.asarray(p), jnp.asarray(BOUND), "color"))
    got = td.nice_forward_packed(dt, gt, t(p), t(BOUND))
    assert tuple(got.shape) == (N, 4) and torch.isfinite(got).all()
    assert _rel(got, want) < PACKED_REL
    assert _rel(td.nice_forward(dt, gt, t(p), t(BOUND), "color", fused=True), want) < PACKED_REL
