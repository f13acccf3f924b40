"""The port's grid sampling against the JAX package's, on the CPU: trilinear
sampling incl. out-of-range points (f32, atol 1e-5), packed-corner rows
bit-equal as bf16, rows and fractions of the packed gather."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.ops import grid_sample as jg
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.ops import grid_sample as tg

from torch_parity import assert_close, cap_threads, t

cap_threads()
ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(5, 6, 7, 8)).astype(np.float32)
    p = rng.uniform(-1.3, 1.3, (400, 3)).astype(np.float32)  # a third out of range
    p[:4] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1, -1, 0.5]]  # corners, centre
    return grid, p


def _bits(x):
    """bf16 array (either framework) -> its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_grid_trilinear(data, mode):
    grid, p = data
    got = tg.sample_grid_trilinear(t(grid), t(p), mode=mode)
    want = jg.sample_grid_trilinear(jnp.asarray(grid), jnp.asarray(p), mode=mode)
    assert_close(got, want, ATOL)


def test_sample_grid_trilinear_matches_grid_sample(data):
    """And both are torch's own grid_sample with border padding."""
    grid, p = data
    vol = t(grid).permute(3, 0, 1, 2)[None]  # [1, C, Z, Y, X]
    ref = torch.nn.functional.grid_sample(
        vol, t(p)[None, :, None, None, :], padding_mode="border",
        align_corners=True, mode="bilinear")[0, :, :, 0, 0].T
    assert_close(tg.sample_grid_trilinear(t(grid), t(p)), ref.numpy(), ATOL)


def test_sample_grid_gradients(data):
    # points exactly on the border are left out: there jnp.clip passes half
    # the gradient and torch.clamp all of it (a set of measure zero)
    grid, p = data[0], data[1][4:]
    w = np.random.default_rng(1).normal(size=(396, 8)).astype(np.float32)

    def jloss(g, q):
        return jnp.sum(jg.sample_grid_trilinear(g, q) * w)

    gg, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(p))
    g_t, p_t = t(grid).requires_grad_(), t(p).requires_grad_()
    (tg.sample_grid_trilinear(g_t, p_t) * t(w)).sum().backward()
    assert_close(g_t.grad, gg, 1e-4)
    assert_close(p_t.grad, gp, 1e-4)
    # clamped coordinates carry no gradient (border padding)
    assert (p_t.grad[np.abs(p) > 1.0] == 0).all()


def test_pack_corner_grid_rows_bit_equal(data):
    grid, _ = data
    got = tg.pack_corner_grid(t(grid))
    want = jg.pack_corner_grid(jnp.asarray(grid))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 6, 7, 64)
    assert (_bits(got) == _bits(want)).all()
    # corner order (dz, dy, dx), edge replicated
    g = t(grid).bfloat16()
    assert (got[1, 2, 3, 8:16] == g[1, 2, 4]).all()       # dx
    assert (got[1, 2, 3, 16:24] == g[1, 3, 3]).all()      # dy
    assert (got[1, 2, 3, 32:40] == g[2, 2, 3]).all()      # dz
    assert (got[4, 5, 6, 56:64] == g[4, 5, 6]).all()      # far edge replicates


def test_convert_carries_packed_rows_bit_for_bit(data):
    grid, _ = data
    want = jg.pack_corner_grid(jnp.asarray(grid))
    got = convert.tensor_from_numpy(np.asarray(want), "cpu")
    assert got.dtype == torch.bfloat16 and (_bits(got) == _bits(want)).all()


def test_packed_rows_and_frac(data):
    grid, p = data
    packed_j = jg.pack_corner_grid(jnp.asarray(grid))
    packed_t = tg.pack_corner_grid(t(grid))
    rows_t, frac_t = tg.packed_rows_and_frac(packed_t, t(p))
    rows_j, frac_j = jg.packed_rows_and_frac(packed_j, jnp.asarray(p))
    assert rows_t.dtype == torch.bfloat16 and (_bits(rows_t) == _bits(rows_j)).all()
    assert_close(frac_t, frac_j, ATOL)
    assert frac_t.min() >= 0 and frac_t.max() <= 1


def test_packed_frac_carries_the_coordinate_gradient(data):
    grid, p = data[0], data[1][4:]  # see test_sample_grid_gradients
    packed_j = jg.pack_corner_grid(jnp.asarray(grid))
    w = np.random.default_rng(2).normal(size=(396, 3)).astype(np.float32)
    g_want = jax.grad(
        lambda q: jnp.sum(jg.packed_rows_and_frac(packed_j, q)[1] * w))(jnp.asarray(p))
    p_t = t(p).requires_grad_()
    rows, frac = tg.packed_rows_and_frac(tg.pack_corner_grid(t(grid)), p_t)
    assert not rows.requires_grad
    (frac * t(w)).sum().backward()
    assert_close(p_t.grad, g_want, ATOL)


def test_sample_packed_trilinear(data):
    grid, p = data
    got = tg.sample_packed_trilinear(tg.pack_corner_grid(t(grid)), t(p))
    want = jg.sample_packed_trilinear(jg.pack_corner_grid(jnp.asarray(grid)), jnp.asarray(p))
    assert got.dtype == torch.float32
    assert_close(got, want, ATOL)
    # equals the unpacked sample up to the bf16 rounding of the rows
    ref = tg.sample_grid_trilinear(t(grid), t(p))
    assert (got - ref).abs().max() < 2e-2
