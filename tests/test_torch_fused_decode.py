"""The fused decode's plain PyTorch version — the arithmetic the CUDA kernel
implements — against the JAX package on the CPU.

Elementwise it is held against the JAX Pallas kernel run in interpret mode,
exactly as ``tests/test_fused_decode.py`` runs it (``ENSLAM_PALLAS=1`` around
the call): atol = rtol = 5e-3, that file's own tolerance. On the CPU XLA
folds the bf16 round trips away on the JAX package's non-Pallas path, so that
path is no elementwise reference; in aggregate the comparison is against the
f32 ``nice_forward`` (relative norm < 0.01 forward; gradient wrt the points
relative < 0.15 and cosine > 0.99, the bounds of ``TestPackedVsReference``).

The backward's plain version (``fused_decode_bwd_plain``: autograd of the
forward's plain version) is held against the JAX backward kernel in interpret
mode for each of its three outputs: relative < 0.02 and cosine > 0.999 (the
two frameworks round the cotangents to bf16 at other places).
"""

import os

import numpy as np
import pytest

os.environ.setdefault("ENSLAM_PALLAS", "0")

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.core.bounds import normalize_3d_coordinate as j_normalize
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.ops import fused_decode as jf
from evennicer_slam_tpu.ops.grid_sample import packed_rows_and_frac as j_rows_and_frac
from evennicer_slam_tpu_torch.models import decoders as td
from evennicer_slam_tpu_torch.ops import fused_decode as tf
from evennicer_slam_tpu_torch.ops.grid_sample import packed_index_and_frac, packed_rows_and_frac
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


def _index_args(s, p):
    """The wrapper's arguments: cell indices and the packed grids."""
    p_nor = normalize_3d_coordinate(p, t(BOUND))
    packed_m, packed_f = s["pt"]["middle_packed"], s["pt"]["fc_packed"]
    idx_m, frac_m = packed_index_and_frac(packed_m, p_nor)
    idx_f, frac_f = packed_index_and_frac(packed_f, p_nor)
    return p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f


def test_plain_matches_pallas_kernel_in_interpret_mode(scene):
    want = _pallas_forward(scene)
    got = tf.fused_decode_packed_plain(scene["dt"], *_decode_args(scene, t(scene["p"])))
    assert tuple(got.shape) == (N, 4)
    assert_close(got, want, atol=5e-3, rtol=5e-3)


def test_packed_forward_goes_through_the_fused_decode(scene):
    """nice_forward_packed, nice_forward(fused=True) and the wrapper on CPU
    tensors all give the plain version's numbers, and no launch is counted."""
    before = tf.fused_decode_packed.launches
    gathered = tf.fused_decode_packed.gathered_points
    plain = tf.fused_decode_packed_plain(scene["dt"], *_decode_args(scene, t(scene["p"])))
    assert torch.equal(tf.fused_decode_packed(scene["dt"], *_index_args(scene, t(scene["p"]))),
                       plain)
    assert torch.equal(td.nice_forward_packed(scene["dt"], scene["pt"], t(scene["p"]), t(BOUND)),
                       plain)
    # unpacked grids are packed on the way in
    assert torch.equal(td.nice_forward(scene["dt"], scene["gt"], t(scene["p"]), t(BOUND),
                                       "color", fused=True), plain)
    assert tf.fused_decode_packed.launches == before
    assert tf.fused_decode_packed.gathered_points == gathered
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


def _cotangent():
    return np.random.default_rng(5).standard_normal((N, 4)).astype(np.float32)


def test_bwd_plain_is_autograd_of_the_plain_forward(scene):
    args = _decode_args(scene, t(scene["p"]))
    g = t(_cotangent())
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    raw = tf.fused_decode_packed_plain(scene["dt"], *leaves, *args[3:])
    want = torch.autograd.grad(raw, leaves, g)
    got = tf.fused_decode_bwd_plain(scene["dt"], *args, g)
    chunked = tf.fused_decode_bwd_plain(scene["dt"], *args, g, chunk=400)
    for a, b, c in zip(got, want, chunked):
        assert tuple(a.shape) == (N, 3) and not a.requires_grad
        assert torch.equal(a, b) and torch.equal(a, c)
    # the wrapper on CPU tensors is the plain version, and autograd goes through it
    raw = tf.fused_decode_packed(scene["dt"], *leaves, *_index_args(scene, t(scene["p"]))[3:])
    for a, b in zip(torch.autograd.grad(raw, leaves, g), want):
        assert torch.equal(a, b)


def test_bwd_plain_matches_pallas_backward_kernel(scene):
    """dp, dfrac_m and dfrac_f against ``_fused_call_bwd`` (the JAX backward
    kernel in interpret mode) through ``jax.vjp`` of the JAX package's
    ``fused_decode_packed``, for a seeded cotangent."""
    pj = jnp.asarray(scene["p"])
    p_nor = j_normalize(pj, jnp.asarray(BOUND))
    rows_m, frac_m = j_rows_and_frac(scene["pj"]["middle_packed"], p_nor)
    rows_f, frac_f = j_rows_and_frac(scene["pj"]["fc_packed"], p_nor)
    _, vjp = jax.vjp(
        lambda a, b, c: jf.fused_decode_packed(scene["dj"], a, b, c, rows_m, rows_f),
        pj, frac_m, frac_f)
    want = [np.asarray(x) for x in vjp(jnp.asarray(_cotangent()))]
    args = _decode_args(scene, t(scene["p"]))
    assert_close(args[1], np.asarray(frac_m), atol=1e-6)
    got = tf.fused_decode_bwd_plain(scene["dt"], *args, t(_cotangent()))
    for name, a, b in zip(("dp", "dfrac_m", "dfrac_f"), got, want):
        a = a.numpy()
        assert np.abs(b).max() > 1e-3, name
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        cos = np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert rel < 0.02 and cos > 0.999, (name, rel, cos)


def test_the_backward_rounds_each_cotangent_through_bf16(scene):
    """What the backward kernel has to reproduce: autograd casts the cotangent
    of a rounded activation operand back through bf16."""
    a = t(np.random.default_rng(6).standard_normal((5, 8)).astype(np.float32)).requires_grad_()
    w = t(np.random.default_rng(7).standard_normal((8, 4)).astype(np.float32))
    g = t(np.random.default_rng(8).standard_normal((5, 4)).astype(np.float32))
    (ga,) = torch.autograd.grad(tf._mm(a, w), a, g)
    raw = g @ w.bfloat16().float().T
    assert torch.equal(ga, raw.bfloat16().float()) and not torch.equal(ga, raw)


def test_backward_launch_refuses_cpu_tensors():
    z = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tf.launch_fused_decode_bwd(z, z, z, z, z, z, z, z, z, torch.zeros(5, 4))
    assert tf.fused_decode_packed.bwd_launches == 0
    assert tf.fused_decode_packed.gathered_points == 0


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
    assert w16.dtype == torch.bfloat16 and w16.shape == (51200,)
    assert f32.dtype == torch.float32 and f32.shape == (2220,)
    rows = w16.reshape(1600, 32)
    m = scene["dt"]["middle"]
    assert torch.equal(rows[:93], m["lin_w"][0].bfloat16())
    assert torch.equal(rows[96:189], m["lin_w"][3][:93].bfloat16())
    assert torch.equal(rows[192 + 64 : 192 + 96], m["lin_w"][3][93:].bfloat16())
    assert torch.equal(rows[320:352], m["fc_w"][0].bfloat16())
    fine0 = 2 * 96 + 4 * 32 + 5 * 32
    assert fine0 == tf.W_ROW0["fine"]
    assert torch.equal(rows[fine0 : fine0 + 93], scene["dt"]["fine"]["lin_w"][0].bfloat16())
    assert torch.equal(rows[fine0 + 320 + 4 * 64 : fine0 + 320 + 5 * 64],
                       scene["dt"]["fine"]["fc_w"][4].bfloat16())
    assert tf.W_ROW0["color"] + 2 * 96 + 4 * 32 + 5 * 32 == 1600
    assert torch.equal(f32[:93], m["B"][0]) and torch.equal(f32[96:189], m["B"][1])
    assert torch.equal(f32[288:320], m["lin_b"][0])
    assert torch.equal(f32[448 + 4 * 32 : 608], m["fc_b"][4])
    c = scene["dt"]["color"]
    assert torch.equal(f32[2 * 740 + 736 : 2 * 740 + 740], c["out_b"])
    assert torch.equal(f32[2 * 740 + 608 : 2 * 740 + 736].reshape(32, 4),
                       c["out_w"].bfloat16().float())


def _unpack_trio(w16, f32):
    """The trio read back out of the two packed buffers by the layout's
    offsets, in the decoders' own layout (f32 tensors of the bf16 values)."""
    rows = w16.float().reshape(tf.W_ROWS, tf.HIDDEN)
    f = f32.reshape(3, tf.F_MLP)
    out = {}
    for i, (name, feat, n_out) in enumerate((("middle", 32, 1), ("fine", 64, 1),
                                             ("color", 32, 4))):
        r = tf.W_ROW0[name]
        hid = [rows[r + tf.R_HID + 32 * j : r + tf.R_HID + 32 * (j + 1)] for j in range(4)]
        lin3 = torch.cat([rows[r + tf.R_EMB3 : r + tf.R_EMB3 + tf.EMB], hid[2]])
        out[name] = {
            "B": f[i, tf.F_B : tf.F_B + 3 * tf.EMB_PAD].reshape(3, tf.EMB_PAD)[:, : tf.EMB],
            "lin_w": [rows[r + tf.R_EMB0 : r + tf.R_EMB0 + tf.EMB], hid[0], hid[1], lin3, hid[3]],
            "lin_b": list(f[i, tf.F_LINB : tf.F_LINB + 160].reshape(5, 32)),
            "fc_w": [rows[r + tf.R_FC + feat * j : r + tf.R_FC + feat * (j + 1)]
                     for j in range(5)],
            "fc_b": list(f[i, tf.F_FCB : tf.F_FCB + 160].reshape(5, 32)),
            "out_w": f[i, tf.F_OUTW : tf.F_OUTW + 128].reshape(32, 4)[:, :n_out],
            "out_b": f[i, tf.F_OUTB : tf.F_OUTB + n_out],
        }
    return out


def test_packed_buffers_hold_the_trio(scene):
    """What the kernels read: the trio taken back out of ``w16`` / ``f32`` by
    the layout's offsets gives the plain version's numbers exactly, and every
    padding value is zero."""
    w16, f32 = tf.pack_trio_weights(scene["dt"])
    back = _unpack_trio(w16, f32)
    args = _decode_args(scene, t(scene["p"]))
    assert torch.equal(tf.fused_decode_packed_plain(back, *args),
                       tf.fused_decode_packed_plain(scene["dt"], *args))
    rows = w16.float().reshape(tf.W_ROWS, tf.HIDDEN)
    f = f32.reshape(3, tf.F_MLP)
    for i, (name, n_out) in enumerate((("middle", 1), ("fine", 1), ("color", 4))):
        r = tf.W_ROW0[name]
        assert not rows[r + tf.EMB : r + tf.EMB_PAD].any()
        assert not rows[r + tf.R_EMB3 + tf.EMB : r + tf.R_EMB3 + tf.EMB_PAD].any()
        assert not f[i, : 3 * tf.EMB_PAD].reshape(3, tf.EMB_PAD)[:, tf.EMB :].any()
        assert not f[i, tf.F_OUTW : tf.F_OUTW + 128].reshape(32, 4)[:, n_out:].any()
        assert not f[i, tf.F_OUTB + n_out : tf.F_MLP].any()


def test_summation_order_alone_flips_bf16_roundings():
    """Why the kernel checks on the card measure their outlier allowance: the
    plain version sums each product in one order, the tensor cores in
    another. Two f32 sums of the same exact bf16 products, in two orders,
    round to different bf16 values for some share of the outputs, although
    both lie within a few ulp of the exact sum; each such flip changes a
    hidden unit by one part in 256."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((4096, 96)).astype(np.float32)).bfloat16().float()
    w = torch.from_numpy(0.2 * rng.standard_normal((96, 32)).astype(np.float32)).bfloat16().float()
    exact = (a.double() @ w.double()).float()
    fwd = torch.zeros(4096, 32)
    for k in range(96):  # the products are exact in f32: a sum in k order
        fwd = fwd + a[:, k : k + 1] * w[k]
    rev = torch.zeros(4096, 32)
    for k in reversed(range(96)):
        rev = rev + a[:, k : k + 1] * w[k]
    bound = 96 * 2.0**-24 * (a.abs() @ w.abs())  # the textbook bound of an f32 sum
    for s in (fwd, rev):
        assert bool(((s - exact).abs() <= bound).all())
    flips = int((fwd.bfloat16() != rev.bfloat16()).sum())
    flips_exact = int((fwd.bfloat16() != exact.bfloat16()).sum())
    assert 0 < flips < 0.01 * fwd.numel() and flips_exact > 0, (flips, flips_exact)


def _points(where):
    """N points of one kind: inside the bound, exactly on its faces (some
    coordinate at -1 or +1 after normalisation), or outside it (clamped)."""
    rng = np.random.default_rng(11)
    lo, hi = BOUND[:, 0], BOUND[:, 1]
    if where == "interior":
        u = rng.uniform(0.05, 0.95, (N, 3))
    elif where == "border":
        u = rng.uniform(0.0, 1.0, (N, 3))
        axis = rng.integers(0, 3, N)
        u[np.arange(N), axis] = rng.integers(0, 2, N)
    else:
        u = rng.uniform(-0.3, 1.3, (N, 3))
        axis = rng.integers(0, 3, N)
        u[np.arange(N), axis] = np.where(rng.random(N) < 0.5, -0.2, 1.2)
    return (lo + u * (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("where", ["interior", "border", "clamped"])
@pytest.mark.parametrize("grid", ["middle_packed", "fc_packed"])
def test_index_and_frac_match_rows_and_frac(scene, grid, where):
    """packed_index_and_frac is packed_rows_and_frac without the gather: the
    same fractions and coordinate gradient, and its cells hold the rows."""
    packed = scene["pt"][grid]
    w = t(np.random.default_rng(12).standard_normal((N, 3)).astype(np.float32))
    outs = []
    for fn in (packed_index_and_frac, packed_rows_and_frac):
        q = t(_points(where)).requires_grad_()
        first, frac = fn(packed, normalize_3d_coordinate(q, t(BOUND)))
        (frac * w).sum().backward()
        outs.append((first, frac.detach(), q.grad))
    (idx, frac_i, grad_i), (rows, frac_r, grad_r) = outs
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (N,) and idx.is_contiguous()
    assert torch.equal(frac_i, frac_r) and torch.equal(grad_i, grad_r)
    assert torch.equal(packed.reshape(-1, packed.shape[-1])[idx.long()], rows)
    assert torch.equal(tf.gather_rows(packed, idx), rows)
    cells = packed.shape[0] * packed.shape[1] * packed.shape[2]
    assert int(idx.min()) >= 0 and int(idx.max()) < cells
    if where != "interior":  # the border cells are reached, and clamped to
        assert bool((frac_i == 0).any() | (frac_i == 1).any())
    if where == "clamped":
        assert not bool(grad_i.abs().sum(dim=1).eq(0).all())
        assert bool(grad_i.eq(0).any())  # a clamped coordinate passes no gradient


@pytest.mark.parametrize("where", ["interior", "border", "clamped"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_index_decode_matches_rows_decode(scene, direction, where):
    """The wrapper on CPU tensors, from cell indices, against the plain
    version from gathered rows: the same output, and through autograd the
    same gradient at the points, bit for bit."""
    g = t(_cotangent())
    res = []
    for make, decode in ((_index_args, tf.fused_decode_packed),
                         (_decode_args, tf.fused_decode_packed_plain)):
        q = t(_points(where)).requires_grad_()
        raw = decode(scene["dt"], *make(scene, q))
        if direction == "forward":
            res.append(raw.detach())
        else:
            (grad,) = torch.autograd.grad(raw, q, g)
            res.append(grad)
    assert torch.equal(res[0], res[1])
    assert bool(res[0].abs().max() > 1e-3)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(scene):
    """The CUDA kernels, forward and backward, against their plain versions on
    a GPU. Skipped without one; the comparison that counts is
    ``chip_smoke.py``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    dev = torch.device("cuda")
    dt = to_torch(scene["dj"])
    dt = {k: {kk: ([x.to(dev) for x in vv] if isinstance(vv, list) else vv.to(dev))
              for kk, vv in m.items()} for k, m in dt.items()}
    args = [a.to(dev) for a in _index_args(scene, t(scene["p"]))]
    rows = [tf.gather_rows(g, i) for g, i in zip(args[5:], args[3:5])]
    before = tf.fused_decode_packed.launches
    gathered = tf.fused_decode_packed.gathered_points
    out = tf.fused_decode_packed(dt, *args)
    torch.cuda.synchronize()
    assert tf.fused_decode_packed.launches == before + 1
    assert tf.fused_decode_packed.gathered_points == gathered + N
    ref = tf.fused_decode_packed_plain(dt, *args[:3], *rows)
    assert_close(out, ref.cpu().numpy(), atol=5e-3, rtol=5e-3)
    # the backward kernel through autograd against autograd of the plain
    # version: |err| <= 5e-3 * (rms of the reference + |reference|)
    g = t(_cotangent()).to(dev)
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    before = tf.fused_decode_packed.bwd_launches
    got = torch.autograd.grad(tf.fused_decode_packed(dt, *leaves, *args[3:]), leaves, g)
    torch.cuda.synchronize()
    assert tf.fused_decode_packed.bwd_launches == before + 1
    assert tf.fused_decode_packed.gathered_points == gathered + 3 * N
    want = tf.fused_decode_bwd_plain(dt, *args[:3], *rows, g)
    for a, b in zip(got, want):
        assert bool(((a - b).abs() <= 5e-3 * (b.pow(2).mean().sqrt() + b.abs())).all())
