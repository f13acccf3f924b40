"""Separable Gaussian blur matching
``torchvision.transforms.functional.gaussian_blur`` (counterpart of
``evennicer_slam_tpu/ops/gaussian_blur.py``): sigma derived from the kernel
size as ``0.3 * ((k - 1) * 0.5 - 1) + 0.8``, reflection padding, the taps
accumulated as shifted slices in tap order.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel1d(ksize: int, sigma: float | None = None) -> np.ndarray:
    if sigma is None:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float32) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(
    img: torch.Tensor, ksize: int, sigma: float | None = None
) -> torch.Tensor:
    """Blur ``[H, W, C]`` (or ``[H, W]``) with a ksize x ksize Gaussian,
    reflect padding. ``ksize`` must be odd."""
    k = _gaussian_kernel1d(ksize, sigma)
    r = ksize // 2

    def blur_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        # reflect padding (edge sample not repeated) as an index map
        idx = torch.arange(-r, n + r, device=x.device).abs()
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
        xp = x.index_select(axis, idx)
        out = None
        for t in range(ksize):
            term = float(k[t]) * xp.narrow(axis, t, n)
            out = term if out is None else out + term
        return out

    return blur_axis(blur_axis(img, 0), 1)
