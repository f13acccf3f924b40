"""The port's image ops and EventNet against the JAX package's on the CPU:
nearest / bilinear resize, Gaussian blur (f32, atol 1e-5), and the EventNet
forward with the weights shipped in ``pretrained/eventnet_mapdomain.npz`` at
26x44, a size whose odd intermediate shapes exercise pad-to-skip
(atol 2e-4 + rtol 2e-4: eighteen float32 convolutions summed in another order)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.models import eventnet as je
from evennicer_slam_tpu.models.eventnet_train import load_eventnet_npz as j_load
from evennicer_slam_tpu.ops.gaussian_blur import gaussian_blur as j_blur
from evennicer_slam_tpu.ops import resize as jrz
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.models import eventnet as te
from evennicer_slam_tpu_torch.ops import gaussian_blur as tb
from evennicer_slam_tpu_torch.ops import resize as trz

from torch_parity import assert_close, cap_threads, jax_to_np, t

cap_threads()
ATOL = 1e-5
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "pretrained", "eventnet_mapdomain.npz")


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(0).random((23, 37, 3)).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(7, 11), (10, 18), (23, 37), (40, 50)])
def test_resize_nearest(img, out_hw):
    assert_close(trz.resize_nearest(t(img), out_hw),
                 jrz.resize_nearest(jnp.asarray(img), out_hw), 0.0)
    # the full-size frame to its 0.15 scale picks floor(dst * src / dst_size)
    big = np.arange(680 * 3, dtype=np.float32).reshape(680, 3)
    assert_close(trz.resize_nearest(t(big), (102, 3)),
                 jrz.resize_nearest(jnp.asarray(big), (102, 3)), 0.0)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(7, 11), (46, 74), (1, 5)])
def test_resize_bilinear(img, out_hw, align_corners):
    got = trz.resize_bilinear(t(img), out_hw, align_corners=align_corners)
    want = jrz.resize_bilinear(jnp.asarray(img), out_hw, align_corners=align_corners)
    assert tuple(got.shape) == (*out_hw, 3)
    assert_close(got, want, ATOL)


def test_resize_bilinear_2d_and_torch_semantics(img):
    d = img[..., 0]
    got = trz.resize_bilinear(t(d), (9, 13))
    assert_close(got, jrz.resize_bilinear(jnp.asarray(d), (9, 13)), ATOL)
    ref = torch.nn.functional.interpolate(t(d)[None, None], size=(9, 13), mode="bilinear",
                                          align_corners=False)[0, 0]
    assert_close(got, ref.numpy(), ATOL)


@pytest.mark.parametrize("ksize", [3, 9, 15])
def test_gaussian_blur(img, ksize):
    assert_close(tb.gaussian_blur(t(img), ksize), j_blur(jnp.asarray(img), ksize), ATOL)
    assert_close(tb.gaussian_blur(t(img[..., 0]), ksize),
                 j_blur(jnp.asarray(img[..., 0]), ksize), ATOL)


def test_gaussian_blur_reflects_and_preserves_mass():
    x = np.zeros((12, 14), np.float32)
    x[0, 0] = 1.0
    got = tb.gaussian_blur(t(x), 5, sigma=1.2)
    assert_close(got, j_blur(jnp.asarray(x), 5, sigma=1.2), 1e-7)
    assert_close(tb.gaussian_blur(torch.ones(12, 14), 9), np.ones((12, 14)), 1e-6)


@pytest.fixture(scope="module")
def nets():
    return j_load(NPZ), te.load_eventnet_npz(NPZ, device="cpu")


def test_load_eventnet_npz_matches_jax_loader(nets):
    pj, pt = nets
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == 134
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32
        assert_close(node, leaf, 0.0, msg=str(path))
    # the converter gives the same tree from the JAX pytree as numpy arrays
    conv = convert.eventnet_from_numpy(jax_to_np(pj), device="cpu")
    assert torch.equal(conv["up3_2"]["bn1"]["v"], pt["up3_2"]["bn1"]["v"])
    assert torch.equal(conv["inc"]["w1"], pt["inc"]["w1"])
    assert tuple(pt["inc"]["w1"].shape) == (3, 3, 6, 64)  # HWIO


def test_eventnet_forward_pad_to_skip(nets):
    pj, pt = nets
    x = np.random.default_rng(1).random((1, 26, 44, 6)).astype(np.float32)
    ev_j, mask_j = je.eventnet_forward(pj, jnp.asarray(x))
    ev_t, mask_t = te.eventnet_forward(pt, t(x))
    assert tuple(ev_t.shape) == (1, 26, 44, 2) and tuple(mask_t.shape) == (1, 26, 44, 2)
    assert_close(ev_t, ev_j, atol=2e-4, rtol=2e-4)
    assert_close(mask_t, mask_j, atol=2e-4, rtol=2e-4)
    assert float(mask_t.min()) >= 0 and float(mask_t.max()) <= 1


def test_inference_event_and_input_gradient(nets):
    pj, pt = nets
    rng = np.random.default_rng(2)
    a = rng.random((26, 44, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ev_j, mask_j = je.inference_event(pj, jnp.asarray(a), jnp.asarray(b))
    cur = t(b).requires_grad_()
    ev_t, mask_t = te.inference_event(pt, t(a), cur)
    assert tuple(ev_t.shape) == (26, 44, 2) and tuple(mask_t.shape) == (1, 26, 44, 2)
    assert_close(ev_t, ev_j, atol=2e-4, rtol=2e-4)
    assert_close(mask_t, mask_j, atol=2e-4, rtol=2e-4)
    # gradients flow through the frozen net into the current image
    g_want = np.asarray(jax.grad(
        lambda c: jnp.sum(je.inference_event(pj, jnp.asarray(a), c)[0] ** 2))(jnp.asarray(b)))
    (ev_t ** 2).sum().backward()
    rel = np.linalg.norm(cur.grad.numpy() - g_want) / np.linalg.norm(g_want)
    assert rel < 1e-3, rel


@pytest.mark.parametrize("shape", [(2, 3, 6, 11), (1, 4, 13, 1), (1, 2, 1, 5), (4, 8, 25, 45)])
def test_upsample2x_is_f_interpolate(shape):
    """EventNet's x2 upsample: ``F.interpolate(bilinear, align_corners=True)``
    forward (the same bits), its backward written as two matrix products (the
    same bits in every run on the card) against ``F.interpolate``'s own
    backward: float32 sums in another order (atol 2e-6)."""
    rng = np.random.default_rng(3)
    x = t(rng.normal(size=shape))
    gy = t(rng.normal(size=(*shape[:2], 2 * shape[2], 2 * shape[3])))
    outs = []
    for up in (te.upsample2x, lambda v: torch.nn.functional.interpolate(
            v, scale_factor=2, mode="bilinear", align_corners=True)):
        xi = x.clone().requires_grad_(True)
        y = up(xi)
        (g,) = torch.autograd.grad(y, xi, gy)
        outs.append((y.detach(), g))
    (y, g), (y_ref, g_ref) = outs
    assert torch.equal(y, y_ref)
    assert_close(g, g_ref.numpy(), 2e-6)
    # the weights' table: each row sums to one, two taps at most
    a = te._upsample_matrix(shape[2], torch.device("cpu"))
    assert_close(a.sum(1), np.ones(2 * shape[2]), 1e-6)
    assert int((a != 0).sum(1).max()) <= 2
