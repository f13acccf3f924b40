"""NICE (4-MLP hierarchical) and iMAP (single-MLP) decoders as plain nested
dicts of tensors (counterpart of ``evennicer_slam_tpu/models/decoders.py``).

- parameters keep the JAX package's keys and layouts: per MLP ``B`` [3, 93],
  ``lin_w``/``lin_b`` lists, ``fc_w``/``fc_b`` lists, ``out_w``/``out_b``;
  weights are stored [in, out] (row-vector convention: y = x @ W + b),
- Gaussian-Fourier positional embedding (93-dim, scale 25, learnable B),
  5-block width-32 MLPs with a skip at block 2 and per-block feature
  injection ``h += fc_c[i](c)``,
- staged forward ('coarse' | 'middle' | 'fine' | 'color'): fine occupancy =
  fine + middle, the color stage returns the color decoder's rgb with the
  fine+middle occupancy,
- the fine decoder's middle-feature concat is detached,
- ``pos_embedding_method`` picks the positional embedding of every MLP:
  ``fourier`` (above), ``nerf`` (``[p, sin/cos(p f)]`` over fixed frequency
  bands, a parameter leaf ``nerf_freqs``), ``fc_relu`` (a Linear
  ``emb_w``/``emb_b`` with no activation) or ``same`` (``p`` itself); the
  forward tells them apart by the leaves an MLP holds,
- iMAP: one MLP (no grid features, width 256, 4 blocks, no skip, colour
  head) under the key ``imap``; its forward ignores grids and stage.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from evennicer_slam_tpu_torch.core.bounds import normalize_3d_coordinate
from evennicer_slam_tpu_torch.ops.grid_sample import (
    pack_corner_grid,
    packed_index_and_frac,
    sample_grid_trilinear,
    sample_packed_trilinear,
)
from evennicer_slam_tpu_torch.utils.runtime import resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER

EMBEDDING_SIZE = 93
FOURIER_SCALE = 25.0

POS_EMBEDDING_METHODS = ("fourier", "same", "nerf", "fc_relu")

def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of operands rounded to bf16, accumulated and returned in f32.
    (A bf16-typed matmul would also round its output to bf16.)"""
    return a.bfloat16().float() @ b.bfloat16().float()


# ---------------------------------------------------------------------------
# initialization (torch defaults of the original decoder)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * 2.0 - 1.0) * bound


def _xavier_uniform(gen, shape, gain: float) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    return _uniform(gen, shape, gain * np.sqrt(6.0 / (fan_in + fan_out)))


def _torch_linear_default(gen, shape) -> torch.Tensor:
    # nn.Linear default: kaiming_uniform(a=sqrt(5)) == U(+-1/sqrt(fan_in))
    return _uniform(gen, shape, 1.0 / np.sqrt(shape[0]))


def _nerf_freq_bands(name: str) -> torch.Tensor:
    """Frequency bands of the ``nerf`` embedding: 10 log-spaced bands
    (1 to 512) for a colour decoder, 5 linear bands (1 to 16) for the
    others."""
    if "color" in name:
        multires = 10
        bands = 2.0 ** np.linspace(0.0, multires - 1, multires)
    else:
        multires = 5
        bands = np.linspace(2.0 ** 0.0, 2.0 ** (multires - 1), multires)
    return torch.from_numpy(bands.astype(np.float32))


def _init_mlp(
    gen: torch.Generator,
    c_dim: int,
    hidden: int,
    n_blocks: int,
    skips,
    color: bool,
    concat_feature: bool,
    pos_embedding_method: str = "fourier",
    name: str = "",
) -> Dict[str, Any]:
    """Parameters for one MLP. The dict holds ONLY tensors; architecture
    facts (skip positions, color head, embedding) are inferred from its
    leaves in forward. ``name`` picks the ``nerf`` frequency bands."""
    relu_gain = np.sqrt(2.0)
    params: Dict[str, Any] = {}
    if pos_embedding_method == "fourier":
        params["B"] = torch.randn(
            (3, EMBEDDING_SIZE), generator=gen, device=gen.device
        ) * FOURIER_SCALE
        emb = EMBEDDING_SIZE
    elif pos_embedding_method == "same":
        emb = 3
    elif pos_embedding_method == "nerf":
        params["nerf_freqs"] = _nerf_freq_bands(name)
        emb = 3 + 6 * params["nerf_freqs"].shape[0]
    elif pos_embedding_method == "fc_relu":
        # a plain Linear embedder: relu-gain init, no activation in forward
        params["emb_w"] = _xavier_uniform(gen, (3, EMBEDDING_SIZE), relu_gain)
        params["emb_b"] = torch.zeros((EMBEDDING_SIZE,))
        emb = EMBEDDING_SIZE
    else:
        raise ValueError(
            f"unknown pos_embedding_method {pos_embedding_method!r}; "
            f"expected one of {POS_EMBEDDING_METHODS}"
        )

    feat_dim = c_dim * (2 if concat_feature else 1)
    lin_w, lin_b = [], []
    in_dim = emb
    for i in range(n_blocks):
        lin_w.append(_xavier_uniform(gen, (in_dim, hidden), relu_gain))
        lin_b.append(torch.zeros((hidden,)))
        in_dim = hidden + emb if i in skips else hidden
    params["lin_w"] = lin_w
    params["lin_b"] = lin_b

    if c_dim != 0:
        fc_w, fc_b = [], []
        for _ in range(n_blocks):
            fc_w.append(_torch_linear_default(gen, (feat_dim, hidden)))
            fc_b.append(_uniform(gen, (hidden,), 1.0 / np.sqrt(feat_dim)))
        params["fc_w"] = fc_w
        params["fc_b"] = fc_b

    out_dim = 4 if color else 1
    params["out_w"] = _xavier_uniform(gen, (in_dim, out_dim), 1.0)
    params["out_b"] = torch.zeros((out_dim,))
    return params


def _init_mlp_no_xyz(gen, c_dim, hidden, n_blocks, skips, color) -> Dict[str, Any]:
    """Parameters for the coarse decoder: the grid feature itself is the
    input; no positional embedding."""
    relu_gain = np.sqrt(2.0)
    params: Dict[str, Any] = {}
    lin_w, lin_b = [], []
    in_dim = hidden  # layer 0 is hidden x hidden; c_dim == hidden
    for i in range(n_blocks):
        lin_w.append(_xavier_uniform(gen, (in_dim, hidden), relu_gain))
        lin_b.append(torch.zeros((hidden,)))
        in_dim = hidden + c_dim if i in skips else hidden
    params["lin_w"] = lin_w
    params["lin_b"] = lin_b
    out_dim = 4 if color else 1
    params["out_w"] = _xavier_uniform(gen, (in_dim, out_dim), 1.0)
    params["out_b"] = torch.zeros((out_dim,))
    return params


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def init_nice_decoders(
    generator: torch.Generator,
    c_dim: int = 32,
    hidden_size: int = 32,
    coarse: bool = False,
    pos_embedding_method: str = "fourier",
    device=None,
) -> Dict[str, Any]:
    """The NICE decoder family (middle, fine, color and optionally coarse),
    drawn from ``generator`` and placed on ``device``."""
    device = resolve_device(device)
    pe = pos_embedding_method
    dec = {
        "middle": _init_mlp(generator, c_dim, hidden_size, 5, (2,), False, False,
                            pos_embedding_method=pe, name="middle"),
        "fine": _init_mlp(generator, c_dim, hidden_size, 5, (2,), False, True,
                          pos_embedding_method=pe, name="fine"),
        "color": _init_mlp(generator, c_dim, hidden_size, 5, (2,), True, False,
                           pos_embedding_method=pe, name="color"),
    }
    if coarse:
        dec["coarse"] = _init_mlp_no_xyz(generator, c_dim, hidden_size, 5, (2,), False)
    return _tree_to(dec, device)


def init_imap_decoder(
    generator: torch.Generator,
    pos_embedding_method: str = "fourier",
    device=None,
) -> Dict[str, Any]:
    """iMAP: one MLP with no grid features, width 256, 4 blocks, no skip,
    colour head, drawn from ``generator`` and placed on ``device``."""
    device = resolve_device(device)
    mlp = _init_mlp(generator, 0, 256, 4, (), True, False,
                    pos_embedding_method=pos_embedding_method, name="imap")
    return _tree_to({"imap": mlp}, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mlp_forward(
    params: Dict[str, Any],
    p: torch.Tensor,
    feat: Optional[torch.Tensor],
    mm_dtype=None,
    inj: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """One MLP: p [N,3], feat [N,c] -> [N] (occupancy) or [N,4] (color).
    ``inj[i]``, when given, is block i's feature-injection product
    ``feat @ fc_w[i]`` computed elsewhere (``feat`` is then not read).

    Skip positions and the color head are inferred from weight shapes (a
    layer expecting ``hidden + emb`` inputs marks a preceding skip).
    ``mm_dtype=torch.bfloat16`` rounds the operands of every MLP product to
    bf16 and accumulates in f32; the embedding (its product and its sines)
    stays in f32, because the Fourier sine is evaluated at arguments of
    O(+-100), where bf16 would randomize the phase."""
    if mm_dtype is None:
        mm = torch.matmul
    elif mm_dtype == torch.bfloat16:
        mm = _bf16_matmul
    else:
        raise ValueError(f"mm_dtype must be None or torch.bfloat16, got {mm_dtype}")
    if "B" in params:  # fourier
        emb = torch.sin(p @ params["B"])
    elif "nerf_freqs" in params:
        # [p, sin(p f1), cos(p f1), sin(p f2), ...], each band's sines and
        # cosines over x, y, z in turn
        xf = p[..., None, :] * params["nerf_freqs"][:, None]  # [N, F, 3]
        sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [N, F, 2, 3]
        emb = torch.cat([p, sc.reshape(p.shape[0], -1)], dim=-1)
    elif "emb_w" in params:  # fc_relu: a Linear, no activation
        emb = p @ params["emb_w"] + params["emb_b"]
    else:  # same
        emb = p
    emb_dim = emb.shape[-1]
    h = emb
    n_blocks = len(params["lin_w"])
    for i, (w, b) in enumerate(zip(params["lin_w"], params["lin_b"])):
        h = torch.relu(mm(h, w) + b)
        if inj is not None:
            h = h + inj[i] + params["fc_b"][i]
        elif feat is not None:
            h = h + mm(feat, params["fc_w"][i]) + params["fc_b"][i]
        hidden = w.shape[1]
        next_in = (
            params["lin_w"][i + 1].shape[0]
            if i + 1 < n_blocks
            else params["out_w"].shape[0]
        )
        if next_in == hidden + emb_dim:
            h = torch.cat([emb, h], dim=-1)
    out = mm(h, params["out_w"]) + params["out_b"]
    if params["out_w"].shape[1] == 1:
        out = out[..., 0]
    return out


def _mlp_no_xyz_forward(params: Dict[str, Any], feat: torch.Tensor) -> torch.Tensor:
    """The coarse decoder's forward."""
    h = feat
    feat_dim = feat.shape[-1]
    n_blocks = len(params["lin_w"])
    for i, (w, b) in enumerate(zip(params["lin_w"], params["lin_b"])):
        h = torch.relu(h @ w + b)
        hidden = w.shape[1]
        next_in = (
            params["lin_w"][i + 1].shape[0]
            if i + 1 < n_blocks
            else params["out_w"].shape[0]
        )
        if next_in == hidden + feat_dim:
            h = torch.cat([feat, h], dim=-1)
    out = h @ params["out_w"] + params["out_b"]
    if params["out_w"].shape[1] == 1:
        out = out[..., 0]
    return out


def _grid_feat(grids, level: str, p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    p_nor = normalize_3d_coordinate(p, bound)
    return sample_grid_trilinear(grids[level], p_nor)


def _occ_only(p: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    return torch.cat([p.new_zeros(p.shape[:-1] + (3,)), occ[..., None]], dim=-1)


def nice_forward(
    decoders: Dict[str, Any],
    grids: Dict[str, torch.Tensor],
    p: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    coarse_bound_enlarge: float = 2.0,
    fused: bool = False,
) -> torch.Tensor:
    """Staged NICE forward. p: [N, 3] world points -> raw [N, 4] (rgb, occ).
    ``fused`` sends the color stage through :func:`nice_forward_packed`."""
    if stage == "coarse":
        cb = bound * coarse_bound_enlarge
        feat = _grid_feat(grids, "coarse", p, cb)
        return _occ_only(p, _mlp_no_xyz_forward(decoders["coarse"], feat))

    if stage == "middle":
        feat = _grid_feat(grids, "middle", p, bound)
        return _occ_only(p, _mlp_forward(decoders["middle"], p, feat))

    if stage == "color" and fused:
        return nice_forward_packed(decoders, grids, p, bound)

    middle_feat = _grid_feat(grids, "middle", p, bound)
    fine_feat = torch.cat(
        [_grid_feat(grids, "fine", p, bound), middle_feat.detach()], dim=-1
    )

    fine_occ = _mlp_forward(decoders["fine"], p, fine_feat)
    middle_occ = _mlp_forward(decoders["middle"], p, middle_feat)
    occ = fine_occ + middle_occ

    if stage == "fine":
        return _occ_only(p, occ)
    if stage == "color":
        color_feat = _grid_feat(grids, "color", p, bound)
        raw = _mlp_forward(decoders["color"], p, color_feat)
        return torch.cat([raw[..., :3], occ[..., None]], dim=-1)
    raise ValueError(f"unknown stage {stage!r}")


def pack_grids_for_tracking(grids: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Read-only packed-corner snapshot of the scene grids for the tracker's
    decode: middle packed alone, fine+color packed together (bf16 rows).
    Rebuilt once per mapping update; reused by every tracking iteration."""
    out = dict(grids)
    out["middle_packed"] = pack_corner_grid(grids["middle"])
    out["fc_packed"] = pack_corner_grid(
        torch.cat([grids["fine"], grids["color"]], dim=-1)
    )
    return out


TRIO_WEIGHTS = "trio_weights"


def pack_decoders_for_tracking(
    decoders: Dict[str, Any], grids: Dict[str, Any]
) -> Dict[str, Any]:
    """The snapshot ``grids`` with the decoder trio's weights in the fused
    decode kernels' two buffers beside the packed grids (key
    ``TRIO_WEIGHTS``), so a frame's decodes, forward and backward, pack them
    once instead of once per call. The decoders are frozen while a frame is
    tracked; a caller that changes them packs again. Left out where the
    kernels are not used: tensors on the CPU, or a trio they do not cover."""
    from evennicer_slam_tpu_torch.ops import fused_decode

    out = dict(grids)
    out.pop(TRIO_WEIGHTS, None)
    if fused_decode.supports(decoders) and decoders["middle"]["B"].device.type == "cuda":
        out[TRIO_WEIGHTS] = fused_decode.pack_trio_weights(decoders)
    return out


def nice_forward_packed(
    decoders: Dict[str, Any],
    grids: Dict[str, torch.Tensor],
    p: torch.Tensor,
    bound: torch.Tensor,
) -> torch.Tensor:
    """Color-stage decode against packed-corner grids: 2 row gathers in total
    (middle; fine+color) instead of 24 corner gathers. Gradients flow to the
    query points (pose tracking); the packed grids are data, not parameters.

    For the standard decoder trio (``fused_decode.supports``) the row gather,
    the corner reduction and all three MLPs run as the fused decode
    (ops/fused_decode.py) from each point's cell index: one CUDA kernel
    forward and one backward for tensors on the card, which read the rows
    from the grids themselves, the plain PyTorch version for tensors on the
    CPU.
    Any other trio runs the same arithmetic as separate PyTorch ops. Where
    ``grids`` carries the trio's packed weights
    (:func:`pack_decoders_for_tracking`) the kernels take them from there.

    The call is the span ``slam.decode.fwd``, its backward the span
    ``slam.decode.bwd`` (``utils/telemetry.py``)."""
    (p,), finish = TRACER.backward_bracket("slam.decode.bwd", p)
    with TRACER.span("slam.decode.fwd"):
        (out,) = finish(_nice_forward_packed(decoders, grids, p, bound))
    return out


def _nice_forward_packed(decoders, grids, p, bound):
    from evennicer_slam_tpu_torch.ops import fused_decode

    if "fc_packed" not in grids:
        grids = pack_grids_for_tracking(grids)
    p_nor = normalize_3d_coordinate(p, bound)

    # decided by the configuration, never by a failure: a trio the kernels
    # do not cover (a non-Fourier embedding, another width) takes the plain
    # ops below on every device, as the JAX package's does
    if fused_decode.supports(decoders):
        packed_m, packed_f = grids["middle_packed"], grids["fc_packed"]
        idx_m, frac_m = packed_index_and_frac(packed_m, p_nor)
        idx_f, frac_f = packed_index_and_frac(packed_f, p_nor)
        return fused_decode.fused_decode_packed(
            decoders, p, frac_m, frac_f, idx_m, idx_f, packed_m, packed_f,
            c_dim=packed_m.shape[-1] // 8, weights=grids.get(TRIO_WEIGHTS),
        )
    middle_feat = sample_packed_trilinear(grids["middle_packed"], p_nor)
    fc_feat = sample_packed_trilinear(grids["fc_packed"], p_nor)
    c = middle_feat.shape[-1]
    fine_feat = torch.cat([fc_feat[:, :c], middle_feat.detach()], dim=-1)
    color_feat = fc_feat[:, c:]
    bf16 = torch.bfloat16
    fine_occ = _mlp_forward(decoders["fine"], p, fine_feat, mm_dtype=bf16)
    middle_occ = _mlp_forward(decoders["middle"], p, middle_feat, mm_dtype=bf16)
    raw = _mlp_forward(decoders["color"], p, color_feat, mm_dtype=bf16)
    occ = fine_occ + middle_occ
    return torch.cat([raw[..., :3], occ[..., None]], dim=-1)


def imap_forward(decoders: Dict[str, Any], p: torch.Tensor) -> torch.Tensor:
    """iMAP single-MLP forward -> raw [N, 4] (rgb, density); the span
    ``slam.decode.imap``."""
    with TRACER.span("slam.decode.imap"):
        return _mlp_forward(decoders["imap"], p, None)


def decoder_forward(
    decoders: Dict[str, Any],
    grids: Optional[Dict[str, torch.Tensor]],
    p: torch.Tensor,
    bound: torch.Tensor,
    stage: str,
    nice: bool = True,
    coarse_bound_enlarge: float = 2.0,
    fused: bool = False,
) -> torch.Tensor:
    """Unified entry: NICE (with grids) or iMAP (grid-free)."""
    if nice:
        return nice_forward(decoders, grids, p, bound, stage,
                            coarse_bound_enlarge, fused=fused)
    return imap_forward(decoders, p)
