"""Fused colour-stage NICE decode for tracking: one CUDA kernel on the card,
its plain PyTorch version beside it (counterpart of
``evennicer_slam_tpu/ops/fused_decode.py``).

The kernel (``csrc/fused_decode.cu``) replaces the TPU Pallas kernel
``_fwd_kernel`` of the JAX package. For N query points it takes the points,
the two trilinear fraction triples and the two gathered packed-corner rows
(ops/grid_sample.py) and returns raw ``[N, 4]`` = (colour rgb, middle + fine
occupancy): corner reduction, three Fourier embeddings and three five-block
MLPs with no activation written to device memory.

What bounds it on an H100, per point: 1,536 B of rows + 36 B of point and
fractions in, 16 B out, against 101,632 FLOP of non-zero MLP work (50,816
multiply-adds with bf16 operands) plus 279 sines. At N = 881,280 that is
1.40 GB, 0.42 ms at 3.35 TB/s, against 0.09 ms at the bf16 tensor-core peak:
the floor is the row traffic. The kernel as it stands is a first, simple
version (one thread per point, FMA loops on the CUDA cores, the trio's bf16
weights resident in shared memory) and is bound by f32 FMA throughput instead;
its source lists what comes next. The TPU kernel's block-diagonal stacking
of the three MLPs (``build_batched_params``) is not ported: it exists to fill
a 128x128 matrix unit and triples the weights with zeros.

Numerics, identical in the kernel and the plain version: operands of every
MLP product rounded to bf16, f32 accumulation; embedding product, sine and
corner reduction in f32.

The backward kernel (``_bwd_kernel`` in the JAX package) is not ported yet:
on CUDA tensors the result cannot be differentiated; the plain version can.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

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


# ---------------------------------------------------------------------------
# the CUDA kernel and its wrapper
# ---------------------------------------------------------------------------

def pack_trio_weights(decoders: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trio's parameters in the kernel's two flat buffers: every product
    weight as bf16 (per MLP: lin_w[0], lin_w[3][:93], lin_w[1], lin_w[2],
    lin_w[3][93:], lin_w[4], fc_w[0..4], out_w padded to [32, 4]) and the f32
    rest (per MLP: B padded to 280, lin_b, fc_b, out_b padded to 4)."""
    w16, f32 = [], []
    for name in _TRIO:
        m = decoders[name]
        w3 = m["lin_w"][3]
        out_w = m["out_w"]
        out_w4 = out_w.new_zeros((HIDDEN, 4))
        out_w4[:, : out_w.shape[1]] = out_w
        out_b4 = out_w.new_zeros((4,))
        out_b4[: out_w.shape[1]] = m["out_b"]
        w16 += [m["lin_w"][0], w3[:EMB], m["lin_w"][1], m["lin_w"][2], w3[EMB:],
                m["lin_w"][4], *m["fc_w"], out_w4]
        f32 += [m["B"], out_w.new_zeros((1,)), *m["lin_b"], *m["fc_b"], out_b4]
    w16 = torch.cat([w.detach().reshape(-1).to(torch.bfloat16) for w in w16])
    f32 = torch.cat([w.detach().reshape(-1).to(torch.float32) for w in f32])
    return w16, f32


def declare_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from
    ``csrc/fused_decode.cu`` (pointers and the stream as ``c_void_p``)."""
    vp = ctypes.c_void_p
    lib.fused_decode_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                     ctypes.c_longlong, vp]
    lib.fused_decode_fwd.restype = ctypes.c_int
    for fn in (lib.fused_decode_w_bf16_elems, lib.fused_decode_w_f32_elems,
               lib.fused_decode_tile, lib.fused_decode_smem_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The compiled kernel (built from ``csrc/fused_decode.cu`` on first use,
    loaded once per process) with its C signatures declared."""
    from evennicer_slam_tpu_torch.ops.cuda_build import load_kernel_library

    return declare_signatures(load_kernel_library("fused_decode"))


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


def launch_fused_decode_fwd(p, frac_m, frac_f, rows_m, rows_f, w16, f32,
                            lib: ctypes.CDLL = None) -> torch.Tensor:
    """Check the arguments, launch the kernel on the current stream, count
    the launch. Returns raw [N, 4] f32. No synchronisation. ``lib`` is the
    library to launch from (default: :func:`kernel_library`; a tuning script
    passes a variant built with other flags)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"the fused decode kernel needs CUDA tensors, got {dev}")
    n = p.shape[0]
    if lib is None:
        lib = kernel_library()
    _check("p", p, torch.float32, (n, 3), dev)
    _check("frac_m", frac_m, torch.float32, (n, 3), dev)
    _check("frac_f", frac_f, torch.float32, (n, 3), dev)
    _check("rows_m", rows_m, torch.bfloat16, (n, 8 * C_DIM), dev)
    _check("rows_f", rows_f, torch.bfloat16, (n, 16 * C_DIM), dev)
    _check("w16", w16, torch.bfloat16, (lib.fused_decode_w_bf16_elems(),), dev)
    _check("f32", f32, torch.float32, (lib.fused_decode_w_f32_elems(),), dev)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_decode_fwd(
            p.data_ptr(), frac_m.data_ptr(), frac_f.data_ptr(),
            rows_m.data_ptr(), rows_f.data_ptr(), w16.data_ptr(),
            f32.data_ptr(), out.data_ptr(), n, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_decode_fwd: CUDA error {err} at launch")
    fused_decode_packed.launches += 1
    return out


class _FusedDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, frac_m, frac_f, rows_m, rows_f, w16, f32):
        return launch_fused_decode_fwd(p, frac_m, frac_f, rows_m, rows_f, w16, f32)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("fused decode backward kernel: next slice")


def fused_decode_packed(
    decoders: Dict[str, Any],
    p: torch.Tensor,
    frac_m: torch.Tensor,
    frac_f: torch.Tensor,
    rows_m: torch.Tensor,
    rows_f: torch.Tensor,
    c_dim: int = C_DIM,
) -> torch.Tensor:
    """Fused decode of N points. p/frac [N, 3] f32; rows [N, 8c] bf16.
    Returns raw [N, 4]; rows and decoder weights are frozen by construction.

    Tensors on the CPU go through :func:`fused_decode_packed_plain`. Tensors
    on a CUDA device go through the kernel, or the call raises; the kernel's
    result cannot be differentiated yet. ``fused_decode_packed.launches``
    counts kernel launches."""
    if p.device.type == "cpu":
        return fused_decode_packed_plain(
            decoders, p, frac_m, frac_f, rows_m, rows_f, c_dim)
    if c_dim != C_DIM or not supports(decoders):
        raise ValueError(
            "the fused decode kernel takes the standard NICE trio only "
            f"(c_dim {C_DIM}, Fourier embedding, five width-{HIDDEN} blocks)"
        )
    w16, f32 = pack_trio_weights(decoders)
    return _FusedDecode.apply(
        p, frac_m, frac_f, rows_m.detach(), rows_f.detach(), w16, f32,
    )


fused_decode_packed.launches = 0
