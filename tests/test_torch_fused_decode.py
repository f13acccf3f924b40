"""The fused decode's plain PyTorch version — the arithmetic the CUDA kernel
implements — against the JAX package on the CPU.

Elementwise it is held against the JAX Pallas kernel run in interpret mode,
exactly as ``tests/test_fused_decode.py`` runs it (``ENSLAM_PALLAS=1`` around
the call): atol = rtol = 5e-3, that file's own tolerance. On the CPU XLA
folds the bf16 round trips away on the JAX package's non-Pallas path, so that
path is no elementwise reference; in aggregate the comparison is against the
f32 ``nice_forward`` (relative norm < 0.01 forward; gradient wrt the points
relative < 0.15 and cosine > 0.99, the bounds of ``TestPackedVsReference``).
"""

import os

import numpy as np
import pytest

os.environ.setdefault("ENSLAM_PALLAS", "0")

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu_torch.models import decoders as td
from evennicer_slam_tpu_torch.ops import fused_decode as tf
from evennicer_slam_tpu_torch.ops.grid_sample import packed_rows_and_frac
from evennicer_slam_tpu_torch.core.bounds import normalize_3d_coordinate

from torch_parity import assert_close, cap_threads, t, to_torch

cap_threads()
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
N = 1500  # not a multiple of any tile size


@pytest.fixture(scope="module")
def scene():
    grids = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=False)
    grids = {k: v + 0.3 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
             for k, v in grids.items()}
    decoders = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=False)
    packed = jd.pack_grids_for_tracking(grids)
    rng = np.random.default_rng(2)
    p = (rng.uniform(-1.1, 1.1, (N, 3)) * [1.0, 0.8, 0.6]).astype(np.float32)
    return dict(dj=decoders, gj=grids, pj=packed, dt=to_torch(decoders),
                gt=to_torch(grids), pt=to_torch(packed), p=p)


def _pallas_forward(s):
    """The JAX Pallas kernel in interpret mode on the CPU."""
    os.environ["ENSLAM_PALLAS"] = "1"
    try:
        return np.asarray(jd.nice_forward_packed(
            s["dj"], s["pj"], jnp.asarray(s["p"]), jnp.asarray(BOUND)))
    finally:
        os.environ["ENSLAM_PALLAS"] = "0"


def _decode_args(s, p):
    p_nor = normalize_3d_coordinate(p, t(BOUND))
    rows_m, frac_m = packed_rows_and_frac(s["pt"]["middle_packed"], p_nor)
    rows_f, frac_f = packed_rows_and_frac(s["pt"]["fc_packed"], p_nor)
    return p, frac_m, frac_f, rows_m, rows_f


def test_plain_matches_pallas_kernel_in_interpret_mode(scene):
    want = _pallas_forward(scene)
    got = tf.fused_decode_packed_plain(scene["dt"], *_decode_args(scene, t(scene["p"])))
    assert tuple(got.shape) == (N, 4)
    assert_close(got, want, atol=5e-3, rtol=5e-3)


def test_packed_forward_goes_through_the_fused_decode(scene):
    """nice_forward_packed, nice_forward(fused=True) and the wrapper on CPU
    tensors all give the plain version's numbers, and no launch is counted."""
    before = tf.fused_decode_packed.launches
    args = _decode_args(scene, t(scene["p"]))
    plain = tf.fused_decode_packed_plain(scene["dt"], *args)
    assert torch.equal(tf.fused_decode_packed(scene["dt"], *args), plain)
    assert torch.equal(td.nice_forward_packed(scene["dt"], scene["pt"], t(scene["p"]), t(BOUND)),
                       plain)
    # unpacked grids are packed on the way in
    assert torch.equal(td.nice_forward(scene["dt"], scene["gt"], t(scene["p"]), t(BOUND),
                                       "color", fused=True), plain)
    assert tf.fused_decode_packed.launches == before
    assert_close(plain, _pallas_forward(scene), atol=5e-3, rtol=5e-3)


def test_forward_close_to_f32(scene):
    ref = np.asarray(jd.nice_forward(scene["dj"], scene["gj"], jnp.asarray(scene["p"]),
                                     jnp.asarray(BOUND), "color"))
    out = td.nice_forward_packed(scene["dt"], scene["pt"], t(scene["p"]), t(BOUND)).numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 0.01, f"plain-vs-f32 forward rel error {rel:.4f}"


def test_point_gradient_close_to_f32(scene):
    w = jnp.array([1.0, -0.5, 0.25, 2.0])
    g_ref = np.asarray(jax.grad(lambda q: jnp.sum(jd.nice_forward(
        scene["dj"], scene["gj"], q, jnp.asarray(BOUND), "color") * w))(jnp.asarray(scene["p"])))
    q = t(scene["p"]).requires_grad_()
    (td.nice_forward_packed(scene["dt"], scene["pt"], q, t(BOUND)) * t(w)).sum().backward()
    g_out = q.grad.numpy()
    assert np.abs(g_ref).max() > 1e-3
    rel = np.linalg.norm(g_out - g_ref) / np.linalg.norm(g_ref)
    assert rel < 0.15, f"plain-vs-f32 gradient rel error {rel:.4f}"
    cos = np.sum(g_out * g_ref) / (np.linalg.norm(g_out) * np.linalg.norm(g_ref))
    assert cos > 0.99, f"gradient direction cosine {cos:.6f}"


def test_point_gradient_matches_pallas_backward(scene):
    """Against the JAX backward kernel in interpret mode (which also rounds
    its cotangents to bf16): relative < 0.02, cosine > 0.999."""
    w = jnp.array([1.0, -0.5, 0.25, 2.0])

    def loss(q):
        os.environ["ENSLAM_PALLAS"] = "1"
        try:
            return jnp.sum(jd.nice_forward_packed(
                scene["dj"], scene["pj"], q, jnp.asarray(BOUND)) * w)
        finally:
            os.environ["ENSLAM_PALLAS"] = "0"

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(scene["p"])))
    q = t(scene["p"]).requires_grad_()
    (td.nice_forward_packed(scene["dt"], scene["pt"], q, t(BOUND)) * t(w)).sum().backward()
    g_out = q.grad.numpy()
    rel = np.linalg.norm(g_out - g_ref) / np.linalg.norm(g_ref)
    cos = np.sum(g_out * g_ref) / (np.linalg.norm(g_out) * np.linalg.norm(g_ref))
    assert rel < 0.02 and cos > 0.999, (rel, cos)


def test_rows_weights_and_middle_copy_carry_no_gradient(scene):
    """Frozen by construction: only points and fractions receive gradient,
    and the fine MLP's copy of the middle feature is detached — the middle
    fraction's gradient is what the middle MLP alone sends back."""
    dt = {k: {kk: ([x.clone().requires_grad_() for x in vv] if isinstance(vv, list)
                   else vv.clone().requires_grad_()) for kk, vv in m.items()}
          for k, m in scene["dt"].items()}
    p, frac_m, frac_f, rows_m, rows_f = _decode_args(scene, t(scene["p"]))
    frac_m = frac_m.clone().requires_grad_()
    frac_f = frac_f.clone().requires_grad_()
    raw = tf.fused_decode_packed_plain(dt, p, frac_m, frac_f, rows_m, rows_f)
    raw[:, 3].sum().backward()
    assert all(x.grad is None for m in dt.values() for v in m.values()
               for x in (v if isinstance(v, list) else [v]))
    assert frac_f.grad.abs().max() > 0
    # middle MLP alone
    fm = frac_m.detach().clone().requires_grad_()
    feat = tf._corner_reduce(rows_m, tf._corner_weights(fm), 32)
    tf._mlp_plain(scene["dt"]["middle"], p, feat)[:, 0].sum().backward()
    assert_close(frac_m.grad, fm.grad.numpy(), atol=1e-5)


def test_supports_and_fallback_for_other_trios(scene):
    assert tf.supports(scene["dt"])
    narrow = {k: v for k, v in scene["dt"].items() if k != "fine"}
    assert not tf.supports(narrow)
    # a trio the kernel does not cover runs the same arithmetic as separate ops
    odd = {k: dict(v) for k, v in scene["dt"].items()}
    odd["color"] = {k: v for k, v in odd["color"].items() if k != "B"}
    assert not tf.supports(odd)
    wide = td.init_nice_decoders(torch.Generator().manual_seed(0), hidden_size=16, device="cpu")
    assert not tf.supports(wide)


def test_unsupported_trio_runs_as_separate_ops(scene):
    """hidden 16 is outside the kernel's cover: nice_forward_packed then runs
    the bf16 MLPs as separate ops, close to the f32 forward."""
    dec = td.init_nice_decoders(torch.Generator().manual_seed(0), hidden_size=16, device="cpu")
    out = td.nice_forward_packed(dec, scene["pt"], t(scene["p"]), t(BOUND))
    ref = td.nice_forward(dec, scene["gt"], t(scene["p"]), t(BOUND), "color")
    rel = float((out - ref).norm() / ref.norm())
    assert tuple(out.shape) == (N, 4) and rel < 0.01, rel


def test_pack_trio_weights_layout(scene):
    w16, f32 = tf.pack_trio_weights(scene["dt"])
    assert w16.dtype == torch.bfloat16 and w16.shape == (51008,)
    assert f32.dtype == torch.float32 and f32.shape == (1812,)
    m = scene["dt"]["middle"]
    assert torch.equal(w16[: 93 * 32], m["lin_w"][0].bfloat16().reshape(-1))
    assert torch.equal(w16[93 * 32 : 2 * 93 * 32], m["lin_w"][3][:93].bfloat16().reshape(-1))
    fine0 = 2 * 93 * 32 + 4 * 1024 + 5 * 32 * 32 + 128
    assert torch.equal(w16[fine0 : fine0 + 93 * 32],
                       scene["dt"]["fine"]["lin_w"][0].bfloat16().reshape(-1))
    assert torch.equal(f32[:279], m["B"].reshape(-1))
    assert torch.equal(f32[280:312], m["lin_b"][0])
    c = scene["dt"]["color"]
    assert torch.equal(f32[2 * 604 + 600 : 2 * 604 + 604], c["out_b"])
    assert torch.equal(w16[-128:].reshape(32, 4), c["out_w"].bfloat16())


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(scene):
    """The CUDA kernel against the plain version on a GPU. Skipped without
    one; the comparison that counts is ``chip_smoke.py``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    dev = torch.device("cuda")
    dt = to_torch(scene["dj"])
    dt = {k: {kk: ([x.to(dev) for x in vv] if isinstance(vv, list) else vv.to(dev))
              for kk, vv in m.items()} for k, m in dt.items()}
    args = [a.to(dev) for a in _decode_args(scene, t(scene["p"]))]
    before = tf.fused_decode_packed.launches
    out = tf.fused_decode_packed(dt, *args)
    torch.cuda.synchronize()
    assert tf.fused_decode_packed.launches == before + 1
    ref = tf.fused_decode_packed_plain(dt, *args)
    assert_close(out, ref.cpu().numpy(), atol=5e-3, rtol=5e-3)
    with pytest.raises(NotImplementedError, match="next slice"):
        q = args[0].clone().requires_grad_()
        tf.fused_decode_packed(dt, q, *args[1:]).sum().backward()
