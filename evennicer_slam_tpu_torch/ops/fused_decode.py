"""Fused colour-stage NICE decode for tracking: two CUDA kernels on the card
(forward and backward), their plain PyTorch versions beside them (counterpart
of ``evennicer_slam_tpu/ops/fused_decode.py``).

The forward kernel (``csrc/fused_decode.cu``) replaces the TPU Pallas kernel
``_fwd_kernel`` of the JAX package. For N query points it takes the points,
the two trilinear fraction triples, each point's two cell indices and the two
read-only packed-corner grids (ops/grid_sample.py::packed_index_and_frac) and
returns raw ``[N, 4]`` = (colour rgb, middle + fine occupancy): row gather
from the grids, corner reduction, three Fourier embeddings and three
five-block MLPs with no row and no activation written to device memory. The
JAX package gathers the rows into ``[N, 8C]`` arrays first; here no such
array is made, forward or backward (1,536 B a point, 1.35 GB for the 881,280
points of one event-loss decode).

The backward kernel (``csrc/fused_decode_bwd.cu``) replaces ``_bwd_kernel``:
it recomputes the forward per point, reading the rows again from the grids,
and pulls a cotangent ``g [N, 4]`` back to the points and the two fraction
triples. Grids and decoder weights are frozen. Its plain version is autograd
of the forward's plain version (:func:`fused_decode_bwd_plain`); its source
says what bounds it.

What bounds it on an H100, per point: 44 B of point, fractions and indices
in, 16 B out, and the rows of the cells the points fall in (1,536 B a cell,
read from the grids; neighbouring samples of a ray share cells, so most come
from L2), against 101,632 FLOP of non-zero MLP work (50,816 multiply-adds
with bf16 operands) plus 279 sines. Both kernels run every MLP product on the
tensor cores (``mma.sync`` m16n8k16, bf16 operands, f32 accumulators) against
the trio's bf16 weights resident in shared memory, one persistent block per
SM whose warps each walk their own 16-point tiles; what is left on the CUDA
cores is the sines (and the backward's cosines), the corner reductions and
the fragment epilogues. ``csrc/fused_decode_common.cuh`` sets out the design.
The TPU kernel's block-diagonal stacking of the three MLPs
(``build_batched_params``) is not ported: it exists to fill a 128x128 matrix
unit and triples the weights with zeros.

Numerics, identical in the kernels and the plain versions: operands of every
MLP product rounded to bf16, f32 accumulation; embedding product, sine and
corner reduction in f32. In the backward the rounding of an operand is the
identity, but autograd casts the cotangent of each rounded activation back
through bf16 (the backward of a dtype cast is the cast back), so every
transposed product's result is rounded to bf16; the backward kernel does the
same.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from evennicer_slam_tpu_torch.utils.telemetry import TRACER

C_DIM = 32
HIDDEN = 32
EMB = 93
_TRIO = ("middle", "fine", "color")


def supports(decoders: Dict[str, Any]) -> bool:
    """The fused decode covers the standard NICE decoder trio: Fourier
    embedding, five width-32 blocks, skip at block 2 (the shape every shipped
    config uses)."""

    def ok(m):
        return (
            "B" in m
            and "fc_w" in m
            and len(m["lin_w"]) == 5
            and m["lin_w"][0].shape[1] == HIDDEN
            and m["lin_w"][3].shape[0] == EMB + HIDDEN
        )

    return all(k in decoders and ok(decoders[k]) for k in _TRIO)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Operands rounded to bf16, product accumulated and returned in f32."""
    return a.bfloat16().float() @ w.bfloat16().float()


def _corner_weights(frac: torch.Tensor) -> list:
    """[N, 3] fractions -> 8 [N, 1] trilinear corner weights, corner order
    (dz, dy, dx) lexicographic — matching pack_corner_grid."""
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    ws = []
    for dz in (0, 1):
        wz = fz if dz else (1.0 - fz)
        for dy in (0, 1):
            wzy = wz * (fy if dy else (1.0 - fy))
            for dx in (0, 1):
                ws.append(wzy * (fx if dx else (1.0 - fx)))
    return ws


def _corner_reduce(rows: torch.Tensor, w8: list, c: int) -> torch.Tensor:
    """rows [N, 8c] (corner-major, bf16) x 8 weights [N, 1] -> [N, c] f32."""
    rows = rows.float()
    out = None
    for k in range(8):
        term = rows[:, k * c : (k + 1) * c] * w8[k]
        out = term if out is None else out + term
    return out


def _mlp_plain(m: Dict[str, Any], p: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """One MLP of the trio -> [N, out]. The skip product [emb | h] @ W3 is
    split as emb @ W3[:93] + h @ W3[93:], as in the kernel."""
    B = m["B"].detach()
    # the embedding argument as an explicit three-term sum in f32 (the same
    # order of roundings as the kernel; a K=3 matmul may fuse differently)
    arg = p[:, 0:1] * B[0] + p[:, 1:2] * B[1] + p[:, 2:3] * B[2]
    emb = torch.sin(arg)
    lin_w = [w.detach() for w in m["lin_w"]]
    lin_b = [b.detach() for b in m["lin_b"]]
    fc_w = [w.detach() for w in m["fc_w"]]
    fc_b = [b.detach() for b in m["fc_b"]]
    h = None
    for i in range(5):
        if i == 0:
            pre = _mm(emb, lin_w[0])
        elif i == 3:
            pre = _mm(emb, lin_w[3][:EMB]) + _mm(h, lin_w[3][EMB:])
        else:
            pre = _mm(h, lin_w[i])
        h = torch.relu(pre + lin_b[i])
        h = h + _mm(feat, fc_w[i]) + fc_b[i]
    return _mm(h, m["out_w"].detach()) + m["out_b"].detach()


def fused_decode_packed_plain(
    decoders: Dict[str, Any],
    p: torch.Tensor,
    frac_m: torch.Tensor,
    frac_f: torch.Tensor,
    rows_m: torch.Tensor,
    rows_f: torch.Tensor,
    c_dim: int = C_DIM,
) -> torch.Tensor:
    """The fused decode in plain PyTorch ops, on any device. p/frac [N, 3]
    f32; rows [N, 8c] / [N, 16c] bf16. Returns raw [N, 4]. Differentiable
    wrt p and the fractions; rows and decoder weights are frozen, and the
    middle copy inside the fine feature carries no gradient."""
    rows_m = rows_m.detach()
    rows_f = rows_f.detach()
    middle_feat = _corner_reduce(rows_m, _corner_weights(frac_m), c_dim)
    fc_feat = _corner_reduce(rows_f, _corner_weights(frac_f), 2 * c_dim)
    fine_feat = torch.cat([fc_feat[:, :c_dim], middle_feat.detach()], dim=-1)
    color_feat = fc_feat[:, c_dim:]
    middle_occ = _mlp_plain(decoders["middle"], p, middle_feat)[:, 0]
    fine_occ = _mlp_plain(decoders["fine"], p, fine_feat)[:, 0]
    raw = _mlp_plain(decoders["color"], p, color_feat)
    occ = fine_occ + middle_occ
    return torch.cat([raw[:, :3], occ[:, None]], dim=-1)


def fused_decode_bwd_plain(
    decoders: Dict[str, Any],
    p: torch.Tensor,
    frac_m: torch.Tensor,
    frac_f: torch.Tensor,
    rows_m: torch.Tensor,
    rows_f: torch.Tensor,
    g: torch.Tensor,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch ops, on any device: autograd of
    :func:`fused_decode_packed_plain` for the cotangent ``g [N, 4]``. Returns
    ``(dp, dfrac_m, dfrac_f)``, each ``[N, 3]``. ``chunk`` walks the points
    that many at a time (the result is the same: points are independent)."""
    n = p.shape[0]
    step = n if not chunk else chunk
    outs = []
    for i in range(0, max(n, 1), max(step, 1)):
        sl = slice(i, i + step)
        leaves = [x[sl].detach().requires_grad_() for x in (p, frac_m, frac_f)]
        with torch.enable_grad():
            raw = fused_decode_packed_plain(decoders, *leaves, rows_m[sl], rows_f[sl])
        outs.append(torch.autograd.grad(raw, leaves, g[sl]))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


# ---------------------------------------------------------------------------
# the CUDA kernels and their wrappers
# ---------------------------------------------------------------------------

# Layout of the two packed buffers the kernels read (the same constants are
# in csrc/fused_decode_common.cuh). w16: bf16 rows of 32 values; per MLP the
# embedding weights lin_w[0] and lin_w[3][:93], each padded to 96 rows with
# zeros, the hidden weights lin_w[1], lin_w[2], lin_w[3][93:], lin_w[4], then
# fc_w[0..4] ([F, 32] each). f32: per MLP B [3, 96] (columns 93.. zero),
# lin_b [5, 32], fc_b [5, 32], out_w [32, 4] as bf16 values and out_b [4]
# (columns past the MLP's own outputs zero).
EMB_PAD = 96
W_ROW0 = {"middle": 0, "fine": 480, "color": 1120}  # first w16 row of each MLP
W_ROWS = 1600
R_EMB0, R_EMB3, R_HID, R_FC = 0, EMB_PAD, 2 * EMB_PAD, 2 * EMB_PAD + 4 * HIDDEN
F_MLP = 740
F_B, F_LINB, F_FCB, F_OUTW, F_OUTB = 0, 288, 448, 608, 736


def pack_trio_weights(decoders: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trio's parameters in the kernels' two flat buffers (layout above):
    ``w16`` bf16 ``[1600 * 32]``, ``f32`` float32 ``[3 * 740]``. Every padding
    value is zero."""
    dev = decoders["middle"]["B"].device
    w16 = torch.zeros((W_ROWS, HIDDEN), dtype=torch.bfloat16, device=dev)
    f32 = torch.zeros((len(_TRIO), F_MLP), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i, name in enumerate(_TRIO):
            m = decoders[name]
            r = W_ROW0[name]
            lin_w = m["lin_w"]
            w16[r + R_EMB0 : r + R_EMB0 + EMB] = lin_w[0]
            w16[r + R_EMB3 : r + R_EMB3 + EMB] = lin_w[3][:EMB]
            for j, w in enumerate((lin_w[1], lin_w[2], lin_w[3][EMB:], lin_w[4])):
                w16[r + R_HID + HIDDEN * j : r + R_HID + HIDDEN * (j + 1)] = w
            feat = m["fc_w"][0].shape[0]
            for j, w in enumerate(m["fc_w"]):
                w16[r + R_FC + feat * j : r + R_FC + feat * (j + 1)] = w
            f = f32[i]
            f[F_B : F_B + 3 * EMB_PAD].view(3, EMB_PAD)[:, :EMB] = m["B"]
            f[F_LINB : F_LINB + 5 * HIDDEN] = torch.cat(list(m["lin_b"]))
            f[F_FCB : F_FCB + 5 * HIDDEN] = torch.cat(list(m["fc_b"]))
            out_w = m["out_w"]
            n_out = out_w.shape[1]
            f[F_OUTW : F_OUTW + 4 * HIDDEN].view(HIDDEN, 4)[:, :n_out] = \
                out_w.bfloat16().float()
            f[F_OUTB : F_OUTB + n_out] = m["out_b"]
    return w16.reshape(-1), f32.reshape(-1)


def declare_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/fused_decode.cu`` (pointers and the stream as ``c_void_p``)."""
    vp = ctypes.c_void_p
    i64 = ctypes.c_longlong
    lib.fused_decode_fwd.argtypes = [vp] * 7 + [i64, i64] + [vp] * 3 + [i64, vp]
    lib.fused_decode_fwd.restype = ctypes.c_int
    for fn in (lib.fused_decode_w_bf16_elems, lib.fused_decode_w_f32_elems,
               lib.fused_decode_warps, lib.fused_decode_warp_points,
               lib.fused_decode_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled forward kernel (built from ``csrc/fused_decode.cu`` on
    first use, loaded once per process) with its C signatures declared."""
    from evennicer_slam_tpu_torch.ops.cuda_build import load_kernel_library

    return declare_signatures(load_kernel_library("fused_decode"))


def declare_bwd_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/fused_decode_bwd.cu``."""
    vp = ctypes.c_void_p
    i64 = ctypes.c_longlong
    lib.fused_decode_bwd.argtypes = [vp] * 7 + [i64, i64] + [vp] * 6 + [i64, vp]
    lib.fused_decode_bwd.restype = ctypes.c_int
    for fn in (lib.fused_decode_bwd_w_bf16_elems, lib.fused_decode_bwd_w_f32_elems,
               lib.fused_decode_bwd_warps, lib.fused_decode_bwd_warp_points,
               lib.fused_decode_bwd_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def bwd_kernel_library() -> ctypes.CDLL:
    """The compiled backward kernel (``csrc/fused_decode_bwd.cu``), built on
    first use and loaded once per process."""
    from evennicer_slam_tpu_torch.ops.cuda_build import load_kernel_library

    return declare_bwd_signatures(load_kernel_library("fused_decode_bwd"))


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _check_grid(name: str, grid: torch.Tensor, row: int, device) -> int:
    """A packed-corner grid ``[Z, Y, X, row]`` bf16; returns its cells."""
    if grid.dim() != 4:
        raise ValueError(f"{name}: shape {tuple(grid.shape)}, expected [Z, Y, X, {row}]")
    _check(name, grid, torch.bfloat16, (*grid.shape[:3], row), device)
    cells = grid.shape[0] * grid.shape[1] * grid.shape[2]
    if not 0 < cells < 2**31:
        raise ValueError(f"{name}: {cells} cells, expected 1 .. 2**31 - 1")
    return cells


def _check_points(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f):
    """The arguments the two kernels share; returns (N, cells_m, cells_f)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"the fused decode kernel needs CUDA tensors, got {dev}")
    n = p.shape[0]
    _check("p", p, torch.float32, (n, 3), dev)
    _check("frac_m", frac_m, torch.float32, (n, 3), dev)
    _check("frac_f", frac_f, torch.float32, (n, 3), dev)
    _check("idx_m", idx_m, torch.int32, (n,), dev)
    _check("idx_f", idx_f, torch.int32, (n,), dev)
    cells_m = _check_grid("packed_m", packed_m, 8 * C_DIM, dev)
    cells_f = _check_grid("packed_f", packed_f, 16 * C_DIM, dev)
    return n, cells_m, cells_f


def _count_gathered(n: int) -> None:
    """A kernel read the rows of ``n`` points from the packed grids."""
    fused_decode_packed.gathered_points += n
    TRACER.add("slam.decode.gathered", n)


def launch_fused_decode_fwd(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f, w16, f32,
                            lib: ctypes.CDLL = None) -> torch.Tensor:
    """Check the arguments, launch the kernel on the current stream, count
    the launch and the points gathered. ``idx_*`` [N] int32 are the points'
    cells in the packed grids ``packed_m`` [Z, Y, X, 256] and ``packed_f``
    [Z', Y', X', 512] bf16 (:func:`~evennicer_slam_tpu_torch.ops.grid_sample.
    packed_index_and_frac`). Returns raw [N, 4] f32. No synchronisation.
    ``lib`` is the library to launch from (default: :func:`kernel_library`; a
    tuning script passes a variant built with other flags)."""
    n, cells_m, cells_f = _check_points(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f)
    dev = p.device
    if lib is None:
        lib = kernel_library()
    _check("w16", w16, torch.bfloat16, (lib.fused_decode_w_bf16_elems(),), dev)
    _check("f32", f32, torch.float32, (lib.fused_decode_w_f32_elems(),), dev)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_decode_fwd(
            p.data_ptr(), frac_m.data_ptr(), frac_f.data_ptr(), idx_m.data_ptr(),
            idx_f.data_ptr(), packed_m.data_ptr(), packed_f.data_ptr(), cells_m, cells_f,
            w16.data_ptr(), f32.data_ptr(), out.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_decode_fwd: CUDA error {err} at launch")
    fused_decode_packed.launches += 1
    _count_gathered(n)
    return out


def launch_fused_decode_bwd(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f, w16, f32, g,
                            lib: ctypes.CDLL = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the arguments, launch the backward kernel on the current stream,
    count the launch and the points gathered. The arguments are the
    forward's; ``g`` is the cotangent of raw, [N, 4] f32. Returns ``(dp,
    dfrac_m, dfrac_f)``, each [N, 3] f32. No synchronisation."""
    n, cells_m, cells_f = _check_points(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f)
    dev = p.device
    if lib is None:
        lib = bwd_kernel_library()
    _check("w16", w16, torch.bfloat16, (lib.fused_decode_bwd_w_bf16_elems(),), dev)
    _check("f32", f32, torch.float32, (lib.fused_decode_bwd_w_f32_elems(),), dev)
    _check("g", g, torch.float32, (n, 4), dev)
    dp, dfrac_m, dfrac_f = (
        torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(3))
    if n == 0:
        return dp, dfrac_m, dfrac_f
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_decode_bwd(
            p.data_ptr(), frac_m.data_ptr(), frac_f.data_ptr(), idx_m.data_ptr(),
            idx_f.data_ptr(), packed_m.data_ptr(), packed_f.data_ptr(), cells_m, cells_f,
            w16.data_ptr(), f32.data_ptr(), g.data_ptr(), dp.data_ptr(), dfrac_m.data_ptr(),
            dfrac_f.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_decode_bwd: CUDA error {err} at launch")
    fused_decode_packed.bwd_launches += 1
    _count_gathered(n)
    return dp, dfrac_m, dfrac_f


class _FusedDecode(torch.autograd.Function):
    """Forward and backward are one kernel launch each. The backward keeps
    the points, fractions and cell indices (40 B a point) and references to
    the packed grids; the grids and the packed weights are data (no
    gradient)."""

    @staticmethod
    def forward(ctx, p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f, w16, f32):
        ctx.save_for_backward(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f, w16, f32)
        return launch_fused_decode_fwd(p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f,
                                       w16, f32)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return (None,) * 9
        # the cotangent may arrive expanded or strided
        g = grad_out.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        grads = launch_fused_decode_bwd(*ctx.saved_tensors, g)
        return (*(d if w else None for d, w in zip(grads, need)),) + (None,) * 6


def gather_rows(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The packed-corner rows of the cells ``idx`` [N], [N, 8C] in the
    grid's dtype, detached: what the kernels read in place."""
    return packed.detach().reshape(-1, packed.shape[-1])[idx.long()]


def fused_decode_packed(
    decoders: Dict[str, Any],
    p: torch.Tensor,
    frac_m: torch.Tensor,
    frac_f: torch.Tensor,
    idx_m: torch.Tensor,
    idx_f: torch.Tensor,
    packed_m: torch.Tensor,
    packed_f: torch.Tensor,
    c_dim: int = C_DIM,
    weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Fused decode of N points. p/frac [N, 3] f32; idx [N] int32, each
    point's cell in the packed grids ``packed_m`` [Z, Y, X, 8c] and
    ``packed_f`` [Z', Y', X', 16c] bf16 (``packed_index_and_frac``). Returns
    raw [N, 4], differentiable wrt p and the fractions; grids and decoder
    weights are frozen by construction.

    Tensors on the CPU gather the rows (:func:`gather_rows`) and go through
    :func:`fused_decode_packed_plain` (and autograd). Tensors on a CUDA device
    go through the kernels, forward and backward, which read each point's
    rows from the grids themselves, or the call raises. ``weights`` are the
    trio's two packed buffers (:func:`pack_trio_weights`) where the caller has
    packed them already, as the tracker does once per frame; without them they
    are packed here. ``fused_decode_packed.launches`` counts launches of the
    forward kernel, ``fused_decode_packed.bwd_launches`` of the backward
    kernel, ``fused_decode_packed.gathered_points`` the points whose rows
    either kernel read (also the tracer's counter ``slam.decode.gathered``)."""
    if p.device.type == "cpu":
        return fused_decode_packed_plain(
            decoders, p, frac_m, frac_f, gather_rows(packed_m, idx_m),
            gather_rows(packed_f, idx_f), c_dim)
    if c_dim != C_DIM or not supports(decoders):
        raise ValueError(
            "the fused decode kernel takes the standard NICE trio only "
            f"(c_dim {C_DIM}, Fourier embedding, five width-{HIDDEN} blocks)"
        )
    w16, f32 = weights if weights is not None else pack_trio_weights(decoders)
    return _FusedDecode.apply(
        p, frac_m, frac_f, idx_m, idx_f, packed_m.detach(), packed_f.detach(), w16, f32,
    )


fused_decode_packed.launches = 0
fused_decode_packed.bwd_launches = 0
fused_decode_packed.gathered_points = 0
