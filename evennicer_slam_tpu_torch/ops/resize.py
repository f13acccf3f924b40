"""Image resize ops with torch/torchvision semantics, written on ``[H, W, ...]``
images (counterpart of ``evennicer_slam_tpu/ops/resize.py``): half-pixel
sampling (align_corners=False) for bilinear, floor-index mapping for nearest.
"""

from __future__ import annotations

from typing import Tuple

import torch


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbor resize of ``[H, W, ...]`` to ``out_hw``: source index
    ``floor(dst * src_size / dst_size)``."""
    H, W = img.shape[0], img.shape[1]
    oh, ow = out_hw
    dev = img.device
    ri = torch.floor(
        torch.arange(oh, device=dev, dtype=torch.float32) * (H / oh)).to(torch.long)
    ci = torch.floor(
        torch.arange(ow, device=dev, dtype=torch.float32) * (W / ow)).to(torch.long)
    return img[ri][:, ci]


def resize_bilinear(
    img: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of ``[H, W, ...]`` to ``out_hw``.

    align_corners=False (torch default): source coordinate
    ``(dst + 0.5) * scale - 0.5`` clamped into range."""
    H, W = img.shape[0], img.shape[1]
    oh, ow = out_hw
    dev = img.device

    def src_coords(n_in: int, n_out: int):
        if align_corners and n_out > 1:
            return torch.linspace(0.0, n_in - 1.0, n_out, device=dev)
        scale = n_in / n_out
        u = (torch.arange(n_out, device=dev, dtype=torch.float32) + 0.5) * scale - 0.5
        return torch.clamp(u, 0.0, n_in - 1.0)

    uy = src_coords(H, oh)
    ux = src_coords(W, ow)
    y0 = torch.floor(uy).to(torch.long)
    x0 = torch.floor(ux).to(torch.long)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    fy = uy - y0
    fx = ux - x0

    # expand fractional weights over trailing dims
    extra = (1,) * (img.ndim - 2)
    fy_r = fy.reshape(-1, 1, *extra)
    fx_r = fx.reshape(1, -1, *extra)

    top = img[y0][:, x0] * (1 - fx_r) + img[y0][:, x1] * fx_r
    bot = img[y1][:, x0] * (1 - fx_r) + img[y1][:, x1] * fx_r
    return top * (1 - fy_r) + bot * fy_r
