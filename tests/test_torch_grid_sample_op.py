"""The trilinear grid sample as one op: on CPU tensors the plain ops as they
were before the CUDA kernels came, bit for bit (values, grid gradient and
coordinate gradient, border points included); on CUDA tensors the kernels or
an error, never a fallback. The kernels themselves are held to the plain
version on a card (``-m cuda``; skipped here) and in ``chip_smoke.py``."""

import os
import re

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch.ops import cuda_build
from evennicer_slam_tpu_torch.ops import grid_sample as tg
from evennicer_slam_tpu_torch.utils.telemetry import TRACER

from torch_parity import cap_threads

cap_threads()


def _sample_before(grid, p_nor, mode="bilinear"):
    """``sample_grid_trilinear`` as the port had it before the kernels,
    verbatim: the yardstick of the CPU path."""
    Z, Y, X, C = grid.shape
    ux = torch.clamp((p_nor[..., 0] + 1.0) * 0.5 * (X - 1), 0.0, X - 1)
    uy = torch.clamp((p_nor[..., 1] + 1.0) * 0.5 * (Y - 1), 0.0, Y - 1)
    uz = torch.clamp((p_nor[..., 2] + 1.0) * 0.5 * (Z - 1), 0.0, Z - 1)
    flat = grid.reshape(-1, C)
    if mode == "nearest":
        ix = torch.round(ux).to(torch.long)
        iy = torch.round(uy).to(torch.long)
        iz = torch.round(uz).to(torch.long)
        return flat[(iz * Y + iy) * X + ix]
    x0 = torch.floor(ux).detach().to(torch.long)
    y0 = torch.floor(uy).detach().to(torch.long)
    z0 = torch.floor(uz).detach().to(torch.long)
    x1 = torch.clamp(x0 + 1, max=X - 1)
    y1 = torch.clamp(y0 + 1, max=Y - 1)
    z1 = torch.clamp(z0 + 1, max=Z - 1)
    fx = (ux - x0)[..., None]
    fy = (uy - y0)[..., None]
    fz = (uz - z0)[..., None]

    def corner(zi, yi, xi):
        return flat[(zi * Y + yi) * X + xi]

    c000 = corner(z0, y0, x0)
    c001 = corner(z0, y0, x1)
    c010 = corner(z0, y1, x0)
    c011 = corner(z0, y1, x1)
    c100 = corner(z1, y0, x0)
    c101 = corner(z1, y0, x1)
    c110 = corner(z1, y1, x0)
    c111 = corner(z1, y1, x1)
    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _border_points(rng, n):
    """Points in and around [-1, 1]^3 with every border case on each axis:
    exactly -1 and +1 (coordinate 0 and size - 1), below -1, above +1."""
    p = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    cases = np.array([-1.0, 1.0, -1.2, 1.25, 0.0], np.float32)
    for axis in range(3):
        p[axis * 5:(axis + 1) * 5, axis] = cases
    p[15] = [1.0, 1.0, 1.0]
    p[16] = [-1.0, -1.0, -1.0]
    p[17] = [1.5, -1.5, 1.0]
    return p


def _run(fn, grid, p, w):
    g = torch.from_numpy(grid).requires_grad_()
    q = torch.from_numpy(p).requires_grad_()
    out = fn(g, q)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), g.grad, q.grad


@pytest.mark.parametrize("shape", [(5, 6, 7, 8), (2, 3, 2, 32), (4, 1, 3, 5)])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_cpu_path_is_the_plain_ops_bit_for_bit(shape, mode):
    rng = np.random.default_rng(sum(shape))
    grid = rng.normal(size=shape).astype(np.float32)
    p = _border_points(rng, 300)
    w = rng.normal(size=(300, shape[-1])).astype(np.float32)
    got = _run(lambda g, q: tg.sample_grid_trilinear(g, q, mode=mode), grid, p, w)
    want = _run(lambda g, q: _sample_before(g, q, mode=mode), grid, p, w)
    for a, b in zip(got, want):
        if b is None:  # nearest: the coordinates get no gradient
            assert a is None
            continue
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert bool(got[0].abs().max() > 0)


def test_cpu_path_counts_no_launch():
    before = (tg.sample_grid_trilinear.launches, tg.sample_grid_trilinear.grid_bwd_launches,
              tg.sample_grid_trilinear.coord_bwd_launches, tg.sample_grid_trilinear.scattered)
    _run(tg.sample_grid_trilinear, np.ones((3, 3, 3, 4), np.float32),
         np.zeros((10, 3), np.float32), np.ones((10, 4), np.float32))
    assert before == (tg.sample_grid_trilinear.launches,
                      tg.sample_grid_trilinear.grid_bwd_launches,
                      tg.sample_grid_trilinear.coord_bwd_launches,
                      tg.sample_grid_trilinear.scattered)


def test_batched_points_keep_their_leading_shape():
    rng = np.random.default_rng(3)
    grid = torch.from_numpy(rng.normal(size=(4, 5, 6, 8)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-1, 1, (7, 9, 3)).astype(np.float32))
    out = tg.sample_grid_trilinear(grid, p)
    assert out.shape == (7, 9, 8)
    assert torch.equal(out.reshape(-1, 8), tg.sample_grid_trilinear(grid, p.reshape(-1, 3)))


def test_a_device_without_kernels_raises():
    """Off the CPU the trilinear sample takes the kernels or raises: a tensor
    on a device that is neither (here ``meta``) is refused, not sampled by
    the plain ops."""
    grid = torch.empty((4, 5, 6, 8), device="meta")
    p = torch.empty((10, 3), device="meta")
    with pytest.raises(ValueError, match="need CUDA tensors"):
        tg.sample_grid_trilinear(grid, p)
    assert tg.sample_grid_trilinear(grid, p, mode="nearest").shape == (10, 8)


def test_cotangent_rows_keep_their_stride_or_are_copied():
    full = torch.arange(60.0).reshape(5, 12)
    sliced = full[:, :6]  # a concatenation's cotangent, cut
    assert tg._cotangent(sliced).data_ptr() == sliced.data_ptr()
    expanded = torch.ones(6).expand(5, 6)
    got = tg._cotangent(expanded)
    assert got.is_contiguous() and torch.equal(got, expanded)
    transposed = full[:, :5].t()
    got = tg._cotangent(transposed)
    assert got.stride(-1) == 1 and torch.equal(got, transposed)


def test_kernel_source_has_no_atomics_and_is_in_the_digest():
    """The grid gradient is a segmented sum in a fixed order: the source
    calls no atomic function nor PTX atomic, and the library's digest
    covers it."""
    files = cuda_build.source_files("grid_sample")
    assert files[0] == os.path.join(cuda_build.CSRC_DIR, "grid_sample.cu")
    with open(files[0]) as f:
        src = f.read()
    assert not re.findall(r"atomic\w*\s*\(|\batom\.|\bred\.", src)
    for fn in ("grid_sample_fwd", "grid_sample_keys", "grid_sample_grid_bwd",
               "grid_sample_coord_bwd"):
        assert f'extern "C" int {fn}(' in src


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _chain_in_kernel_order(grid, p, g):
    """The plain version's two gradients computed in the order the kernels
    compute them (csrc/grid_sample.cu): each corner's contributions
    ((g * wz) * wy) * wx summed point by point into a zero gradient, the
    eight corners added c111 first; the coordinate gradient from each lerp's
    cotangent-times-corner products, each reduced over the channels by
    ``sum`` (the kernels repeat the card's reduction), added in the order the
    kernels add them. Returns (grid gradient, coordinate gradient)."""
    Z, Y, X, C = grid.shape
    u = tg._unnormalize(p, Z, Y, X)
    lo = [torch.floor(a) for a in u]
    fx, fy, fz = [(a - b)[:, None] for a, b in zip(u, lo)]
    i0 = [b.long() for b in lo]
    i1 = [torch.clamp(b + 1, max=m - 1) for b, m in zip(i0, (X, Y, Z))]
    flat = grid.reshape(-1, C)

    def idx(dz, dy, dx):
        return (((i1 if dz else i0)[2] * Y + (i1 if dy else i0)[1]) * X
                + (i1 if dx else i0)[0])

    corners = [(dz, dy, dx) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    c = {k: flat[idx(*k)] for k in corners}
    omfx, omfy, omfz = 1 - fx, 1 - fy, 1 - fz
    c00 = c[0, 0, 0] * omfx + c[0, 0, 1] * fx
    c01 = c[0, 1, 0] * omfx + c[0, 1, 1] * fx
    c10 = c[1, 0, 0] * omfx + c[1, 0, 1] * fx
    c11 = c[1, 1, 0] * omfx + c[1, 1, 1] * fx
    c0, c1 = c00 * omfy + c01 * fy, c10 * omfy + c11 * fy
    g0, g1 = g * omfz, g * fz
    g00, g01, g10, g11 = g0 * omfy, g0 * fy, g1 * omfy, g1 * fy

    def S(t):
        return t.sum(-1, keepdim=True)

    dfz = S(g * c1) + -S(g * c0)
    dfy = ((S(g1 * c11) + -S(g1 * c10)) + S(g0 * c01)) + -S(g0 * c00)
    dfx = S(g11 * c[1, 1, 1])
    for t in (-S(g11 * c[1, 1, 0]), S(g10 * c[1, 0, 1]), -S(g10 * c[1, 0, 0]),
              S(g01 * c[0, 1, 1]), -S(g01 * c[0, 1, 0]), S(g00 * c[0, 0, 1]),
              -S(g00 * c[0, 0, 0])):
        dfx = dfx + t
    dp = []
    for axis, (df, size) in enumerate(((dfx, X), (dfy, Y), (dfz, Z))):
        raw = ((p[:, axis] + 1.0) * 0.5) * (size - 1)
        du = torch.where((raw >= 0) & (raw <= size - 1), df[:, 0], torch.zeros(()))
        dp.append((du * (size - 1)) * 0.5 + 0.0)
    total = torch.zeros_like(flat)
    for k in reversed(corners):
        w = ((g * (fz if k[0] else omfz)) * (fy if k[1] else omfy)) * (fx if k[2] else omfx)
        total = total + torch.zeros_like(flat).index_put_((idx(*k),), w, accumulate=True)
    return total.reshape(grid.shape), torch.stack(dp, -1)


@pytest.mark.parametrize("shape", [(5, 6, 7, 32), (3, 4, 2, 8), (7, 8, 11, 32)])
@pytest.mark.parametrize("needs", ["both", "grid"])
def test_the_kernels_order_is_the_plain_chains(shape, needs):
    """The order of additions the kernels follow is the one autograd takes
    through the plain version (one thread: the CPU's index backward then adds
    point by point, as the card's sorted one does), bit for bit. The channel
    sums here are the CPU's ``sum``, so this pins the grid gradient's order
    and the coordinate gradient's order of terms, not the card's channel
    reduction: only the card test below, which holds the kernels to the
    plain version itself, checks that."""
    gen = torch.Generator().manual_seed(sum(shape))
    grid = torch.randn(shape, generator=gen)
    p = torch.rand((3000, 3), generator=gen) * 2.6 - 1.3
    p[:8] = torch.tensor([1.0, -1.0, 0.3])
    if shape == (7, 8, 11, 32):
        p = p * 0.2  # a few cells: long runs a vertex
    g = torch.randn((3000, shape[-1]), generator=gen)
    want_dg, want_dp = _chain_in_kernel_order(grid, p, g)
    gl = grid.clone().requires_grad_()
    pl = p.clone().requires_grad_(needs == "both")
    got = torch.autograd.grad(tg.sample_grid_trilinear(gl, pl),
                              (gl, pl) if needs == "both" else (gl,), g)
    assert torch.equal(got[0], want_dg)
    if needs == "both":
        assert torch.equal(got[1], want_dp)
    assert bool((want_dg != 0).any())


N_MAP = 48_000  # 1,000 rays x 48 samples: one mapping iteration's points
# nice_replica's grids over room0's bound rounded to 0.32 m ([Z, Y, X])
MAP_SHAPES = {"coarse": (7, 8, 11), "middle": (22, 28, 37), "fine": (44, 56, 74)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _map_points(gen, n, level, dev):
    """A mapping batch: points in part of the bound, 5 % outside it; the
    coarse grid sees them at half scale (its bound is enlarged twice)."""
    p = torch.rand((n, 3), generator=gen) * 1.0 - 0.6
    out = torch.rand(n, generator=gen) < 0.05
    p[out] = torch.rand((int(out.sum()), 3), generator=gen) * 2.6 - 1.3
    return (p * 0.5 if level == "coarse" else p).to(dev)


def _one_cell_points(gen, n, shape, dev):
    """Every point inside one cell: eight runs of n pairs each."""
    Z, Y, X = shape
    size = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32)
    u = torch.tensor([2.0, 1.0, 3.0]) + 0.05 + 0.9 * torch.rand((n, 3), generator=gen)
    return (u / size * 2.0 - 1.0).to(dev)


def _grads(fn, grid, p, g):
    gl, pl = grid.clone().requires_grad_(), p.clone().requires_grad_()
    out = fn(gl, pl)
    dg, dp = torch.autograd.grad(out, (gl, pl), g)
    return out.detach(), dg, dp


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["coarse", "middle", "fine", "one_cell"])
def test_kernels_give_the_plain_bits_on_the_card(case):
    """Output, grid gradient and coordinate gradient equal the plain
    version's on the card bit for bit, at the mapping shapes and with every
    point in one cell; the same bits again, and from a strided cotangent;
    the counters."""
    dev = _card()
    gen = torch.Generator().manual_seed(18)
    shape = MAP_SHAPES["middle" if case == "one_cell" else case]
    grid = torch.randn((*shape, 32), generator=gen).to(dev)
    p = (_one_cell_points(gen, N_MAP, shape, dev) if case == "one_cell"
         else _map_points(gen, N_MAP, case, dev))
    p[:4] = torch.tensor([[1.0, -1.0, 0.5], [-1.0, 1.0, -1.0], [1.5, 0.0, -1.5],
                          [0.0, 1.0, 1.0]], device=dev)
    g = torch.randn((N_MAP, 32), generator=gen).to(dev)
    op = tg.sample_grid_trilinear
    counts = (op.launches, op.grid_bwd_launches, op.coord_bwd_launches, op.scattered)
    TRACER.enable()
    scattered = TRACER.count["slam.grid.scattered"]
    try:
        got = _grads(op, grid, p, g)
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    assert (op.launches, op.grid_bwd_launches, op.coord_bwd_launches, op.scattered) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + 8 * N_MAP)
    assert TRACER.count["slam.grid.scattered"] == scattered + 8 * N_MAP
    want = _grads(tg.sample_grid_trilinear_plain, grid, p, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    again = _grads(op, grid, p, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    gl, pl = grid.clone().requires_grad_(), p.clone().requires_grad_()
    both = torch.cat([op(gl, pl), torch.zeros_like(g)], dim=-1)
    strided = torch.autograd.grad(both, (gl, pl), torch.cat([g, g], dim=-1))
    assert torch.equal(strided[0], got[1]) and torch.equal(strided[1], got[2])
    gl = grid.clone().requires_grad_()
    (grid_only,) = torch.autograd.grad(op(gl, p), gl, g)
    assert torch.equal(grid_only, got[1])
    with torch.no_grad():
        assert torch.equal(op(grid, p), got[0])


@pytest.mark.cuda
def test_no_points_launch_no_sample_and_a_zero_grid_gradient():
    """With no points the forward and the coordinate gradient launch nothing
    and count nothing; the grid gradient is one launch that writes zeros."""
    dev = _card()
    op = tg.sample_grid_trilinear
    grid = torch.randn((*MAP_SHAPES["coarse"], 32), device=dev, requires_grad=True)
    p = torch.zeros((0, 3), device=dev, requires_grad=True)
    counts = (op.launches, op.grid_bwd_launches, op.coord_bwd_launches, op.scattered)
    out = op(grid, p)
    dg, dp = torch.autograd.grad(out, (grid, p), torch.zeros((0, 32), device=dev))
    torch.cuda.synchronize()
    assert out.shape == (0, 32) and dp.shape == (0, 3)
    assert torch.equal(dg, torch.zeros_like(grid))
    assert (op.launches, op.grid_bwd_launches, op.coord_bwd_launches, op.scattered) == (
        counts[0], counts[1] + 1, counts[2], counts[3])
