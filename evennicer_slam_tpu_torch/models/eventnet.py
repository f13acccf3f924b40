"""EventNet: 2-head UNet predicting an event image from an intensity pair
(counterpart of ``evennicer_slam_tpu/models/eventnet.py``).

Shared encoder (6 -> 64 -> 128 -> 256 -> 512 -> 512 channels, maxpool downs),
two bilinear-upsampling decoder heads — head 1 regresses per-pixel signed
event counts (2 polarity channels), head 2 a sigmoid event-existence mask —
and ``inference = events * mask_prob``.

Public functions keep the JAX package's layout: activations NHWC, convolution
weights HWIO. Inside, the convolutions go to ``torch.nn.functional.conv2d``
in NCHW (a library convolution on both sides: the JAX package leaves them to
XLA). BatchNorm runs in inference mode (affine with running stats). The
network is frozen at SLAM time — gradients flow *through* it into the
rendered input image.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from evennicer_slam_tpu_torch.utils.runtime import resolve_device

BN_EPS = 1e-5

# (name, in, mid, out) per DoubleConv; bilinear upsampling halves up-path channels
_ENCODER = [
    ("inc", 6, 64, 64),
    ("down1", 64, 128, 128),
    ("down2", 128, 256, 256),
    ("down3", 256, 512, 512),
    ("down4", 512, 512, 512),
]
_DECODER = [
    ("up1", 1024, 512, 256),
    ("up2", 512, 256, 128),
    ("up3", 256, 128, 64),
    ("up4", 128, 64, 64),
]


def _conv(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """'SAME' convolution of NCHW ``x`` with an HWIO weight (odd kernels)."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=w_hwio.shape[0] // 2)


def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    c = lambda v: v[None, :, None, None]
    inv = torch.rsqrt(p["v"] + BN_EPS)
    return (x - c(p["m"])) * c(inv) * c(p["g"]) + c(p["b"])


def _double_conv(x, p):
    x = torch.relu(_bn(_conv(x, p["w1"]), p["bn1"]))
    return torch.relu(_bn(_conv(x, p["w2"]), p["bn2"]))


@functools.lru_cache(maxsize=64)
def _upsample_matrix(n_in: int, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``[2 n_in, n_in]``: the weights of a x2 linear upsample with
    align_corners=True, the source coordinate ``i (n_in - 1) / (2 n_in - 1)``
    computed in float32 as ``F.interpolate`` computes it. A constant table,
    made once per size, device and dtype."""
    n_out = 2 * n_in
    src = torch.arange(n_out, dtype=torch.float32) * ((n_in - 1) / (n_out - 1))
    i0 = src.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    frac = (src - i0)[:, None]
    return ((1 - frac) * F.one_hot(i0, n_in) + frac * F.one_hot(i1, n_in)).to(device, dtype)


class _Upsample2x(torch.autograd.Function):
    """Bilinear x2 upsample of NCHW ``x``, align_corners=True: the forward is
    ``F.interpolate``'s; the backward is its transpose written as two matrix
    products, ``A_h^T @ g @ A_w``. ``F.interpolate``'s own CUDA backward adds
    with atomics, so two runs of a gradient through it differ in the last
    bits; a product gives the same bits in every run (PERF.md, PR 10)."""

    @staticmethod
    def forward(ctx, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)

    @staticmethod
    def backward(ctx, g):
        n, c, h2, w2 = g.shape
        h, w = h2 // 2, w2 // 2
        gx = g.reshape(n * c * h2, w2) @ _upsample_matrix(w, g.device, g.dtype)
        gx = _upsample_matrix(h, g.device, g.dtype).T @ gx.reshape(n * c, h2, w)
        return gx.reshape(n, c, h, w)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """EventNet's x2 bilinear upsample (align_corners=True) with a backward
    that is the same in every run (:class:`_Upsample2x`)."""
    return _Upsample2x.apply(x)


def _up(x1, x2, p):
    """Bilinear x2 upsample (align_corners=True), zero-pad to the skip's
    size, concat [skip, upsampled], DoubleConv."""
    up = upsample2x(x1)
    dy, dx = x2.shape[2] - up.shape[2], x2.shape[3] - up.shape[3]
    up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return _double_conv(torch.cat([x2, up], dim=1), p)


def eventnet_forward(
    params: Dict[str, Any], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N, H, W, 6] image pair -> (events [N, H, W, 2], mask [N, H, W, 2]);
    the mask head output is sigmoided."""
    x = x.permute(0, 3, 1, 2)
    x1 = _double_conv(x, params["inc"])
    x2 = _double_conv(F.max_pool2d(x1, 2), params["down1"])
    x3 = _double_conv(F.max_pool2d(x2, 2), params["down2"])
    x4 = _double_conv(F.max_pool2d(x3, 2), params["down3"])
    x5 = _double_conv(F.max_pool2d(x4, 2), params["down4"])

    def head(h):
        y = _up(x5, x4, params[f"up1_{h}"])
        y = _up(y, x3, params[f"up2_{h}"])
        y = _up(y, x2, params[f"up3_{h}"])
        y = _up(y, x1, params[f"up4_{h}"])
        oc = params[f"outc_{h}"]
        return (_conv(y, oc["w"]) + oc["b"][None, :, None, None]).permute(0, 2, 3, 1)

    events = head("1")
    mask = torch.sigmoid(head("2"))
    return events, mask


def inference_event(
    params: Dict[str, Any], img1: torch.Tensor, img2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predicted event image for a (previous, current) intensity pair.

    img1/img2: [H, W, 3] in [0, 1]. Returns (event [H, W, 2], mask
    [1, H, W, 2]) — prediction = raw events x existence probability."""
    pair = torch.cat([img1, img2], dim=-1)[None]
    events, mask = eventnet_forward(params, pair)
    mask_prob = mask[..., 1:2]
    return (events * mask_prob)[0], mask


def _param_names():
    """Flattened parameter names of the checkpoint layout, e.g.
    ``eventnet.inc.bn1.g``, ``eventnet.outc_1.w``."""
    blocks = [n for n, *_ in _ENCODER]
    for head in ("1", "2"):
        blocks += [f"{n}_{head}" for n, *_ in _DECODER]
    for blk in blocks:
        for w, bn in (("w1", "bn1"), ("w2", "bn2")):
            yield (blk, w)
            for s in ("g", "b", "m", "v"):
                yield (blk, bn, s)
    for head in ("1", "2"):
        yield (f"outc_{head}", "w")
        yield (f"outc_{head}", "b")


def load_eventnet_npz(path: str, device=None) -> Dict[str, Any]:
    """Load an EventNet checkpoint written by the JAX package's
    ``save_eventnet_npz`` (f32, or f16-quantized weights with f32 BatchNorm
    statistics); parameters come back as f32 tensors on ``device``."""
    device = resolve_device(device)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    params: Dict[str, Any] = {}
    for name in _param_names():
        key = "eventnet." + ".".join(name)
        arr = flat[key]
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        node = params
        for part in name[:-1]:
            node = node.setdefault(part, {})
        node[name[-1]] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return params


def _he(generator: torch.Generator, shape) -> torch.Tensor:
    """He-normal HWIO weight: N(0, 2 / fan_in), fan_in = kh * kw * in."""
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=generator, device=generator.device) * np.sqrt(2.0 / fan_in)


def _bn_identity(c: int, device) -> Dict[str, torch.Tensor]:
    return {"g": torch.ones(c, device=device), "b": torch.zeros(c, device=device),
            "m": torch.zeros(c, device=device), "v": torch.ones(c, device=device)}


def init_eventnet(generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random EventNet parameters (He-normal convolutions, identity
    BatchNorm statistics), drawn from ``generator`` in the order of the
    parameter tree and placed on ``device``."""
    device = resolve_device(device)
    params: Dict[str, Any] = {}

    def double_conv(cin, mid, cout):
        return {"w1": _he(generator, (3, 3, cin, mid)).to(device), "bn1": _bn_identity(mid, device),
                "w2": _he(generator, (3, 3, mid, cout)).to(device), "bn2": _bn_identity(cout, device)}

    for name, cin, mid, cout in _ENCODER:
        params[name] = double_conv(cin, mid, cout)
    for head in ("1", "2"):
        for name, cin, mid, cout in _DECODER:
            params[f"{name}_{head}"] = double_conv(cin, mid, cout)
        params[f"outc_{head}"] = {"w": _he(generator, (1, 1, 64, 2)).to(device),
                                  "b": torch.zeros(2, device=device)}
    return params


def load_eventnet_torch(path: str, device=None) -> Dict[str, Any]:
    """The reference ``UNet_2heads`` state dict (``.pth``) -> the parameter
    tree on ``device``: conv weights [out, in, kh, kw] -> HWIO, BatchNorm
    running statistics kept for inference-mode normalisation. Only tensors
    and plain containers are unpickled."""
    device = resolve_device(device)
    s = torch.load(path, map_location="cpu", weights_only=True)

    def t(key, conv=False):
        v = s[key].detach()
        v = v.permute(2, 3, 1, 0) if conv else v
        return v.contiguous().to(device, torch.float32)

    def dconv(prefix):
        # torch Sequential indices: 0 conv, 1 bn, 3 conv, 4 bn
        def bn(i):
            p = f"{prefix}.double_conv.{i}"
            return {"g": t(f"{p}.weight"), "b": t(f"{p}.bias"),
                    "m": t(f"{p}.running_mean"), "v": t(f"{p}.running_var")}
        return {"w1": t(f"{prefix}.double_conv.0.weight", True), "bn1": bn(1),
                "w2": t(f"{prefix}.double_conv.3.weight", True), "bn2": bn(4)}

    params: Dict[str, Any] = {"inc": dconv("inc")}
    for i in range(1, 5):
        params[f"down{i}"] = dconv(f"down{i}.maxpool_conv.1")
    for head in ("1", "2"):
        for i in range(1, 5):
            params[f"up{i}_{head}"] = dconv(f"up{i}_{head}.conv")
        params[f"outc_{head}"] = {"w": t(f"outc_{head}.conv.weight", True),
                                  "b": t(f"outc_{head}.conv.bias")}
    return params
