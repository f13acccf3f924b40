"""Lens undistortion in numpy: a frozen copy of the port's
``data/undistort.py`` (it imports nothing of the port), the counterpart of
``cv2.undistort(img, K, dist)``. The check decodes a scene written with
``cam.distortion`` through it, as the port's readers do.

The map is ``initUndistortRectifyMap`` with ``R = I`` and
``newCameraMatrix = K``, for 4, 5 or 8 coefficients (k1 k2 p1 p2 [k3 [k4 k5
k6]]: the 8-coefficient rational model of ``configs/rpg/rpg.yaml``). It is
converted to fixed point as ``cv2.undistort`` converts it (``CV_16SC2``:
each source coordinate rounded to 1/32 of a pixel), then sampled bilinearly
with ``BORDER_CONSTANT`` 0 as ``cv2.remap`` samples it: uint8 images with
the 15-bit integer weights and rounding of ``FixedPtCast``, float images
with the float weights of the same table, accumulated in the image's type.
At 1/32 steps those weights are exact, ``(32 - a)(32 - b) / 1024`` and so on.

:class:`Undistorter` computes the map once per image size and reuses it;
cv2 recomputes it on every call, with the same result.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


def undistort_map(K, dist, hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray,
                                                          np.ndarray, np.ndarray]:
    """Fixed-point map of an ``hw`` image: integer source column and row
    ``[H, W]`` (int64) and their 1/32 fractions ``[H, W]`` (0-31)."""
    K = np.asarray(K, np.float64)
    d = np.asarray(dist, np.float64).reshape(-1)
    if d.size not in (4, 5, 8):
        raise ValueError(f"{d.size} distortion coefficients (4, 5 or 8 are supported)")
    k1, k2, p1, p2 = d[:4]
    k3 = d[4] if d.size >= 5 else 0.0
    k4, k5, k6 = d[5:8] if d.size == 8 else (0.0, 0.0, 0.0)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ir = np.linalg.inv(K)
    H, W = hw
    i = np.arange(H, dtype=np.float64)[:, None]
    j = np.arange(W, dtype=np.float64)[None, :]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    iu = np.rint(u * INTER_TAB_SIZE).astype(np.int64)
    iv = np.rint(v * INTER_TAB_SIZE).astype(np.int64)
    mask = INTER_TAB_SIZE - 1
    return iu >> INTER_BITS, iv >> INTER_BITS, iu & mask, iv & mask


def remap_fixed(img: np.ndarray, sx, sy, fx, fy) -> np.ndarray:
    """``cv2.remap(img, map1, map2, INTER_LINEAR, BORDER_CONSTANT)`` for a
    fixed-point map; ``img`` ``[H, W]`` or ``[H, W, C]``, uint8 or float."""
    H, W = img.shape[:2]
    # two zero pixels on every side: a neighbour outside the image reads 0
    pad = np.pad(img, ((2, 2), (2, 2)) + ((0, 0),) * (img.ndim - 2))
    x0 = np.clip(sx, -2, W) + 2
    y0 = np.clip(sy, -2, H) + 2
    v00, v01 = pad[y0, x0], pad[y0, x0 + 1]
    v10, v11 = pad[y0 + 1, x0], pad[y0 + 1, x0 + 1]
    w00 = (INTER_TAB_SIZE - fy) * (INTER_TAB_SIZE - fx)
    w01 = (INTER_TAB_SIZE - fy) * fx
    w10 = fy * (INTER_TAB_SIZE - fx)
    w11 = fy * fx
    if img.ndim == 3:
        w00, w01, w10, w11 = (w[..., None] for w in (w00, w01, w10, w11))
    if img.dtype == np.uint8:
        # 15-bit weights (these times 32), rounded: (sum + 2^14) >> 15
        acc = (v00.astype(np.int64) * w00 + v01 * w01 + v10 * w10 + v11 * w11 + 512) >> 10
        return np.clip(acc, 0, 255).astype(np.uint8)
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"undistort: uint8 or float images, got {img.dtype}")
    scale = 1.0 / (INTER_TAB_SIZE * INTER_TAB_SIZE)
    w = [(x * scale).astype(img.dtype) for x in (w00, w01, w10, w11)]
    return v00 * w[0] + v01 * w[1] + v10 * w[2] + v11 * w[3]


class Undistorter:
    """``cv2.undistort(img, K, dist)`` with the map of each image size
    computed once."""

    def __init__(self, K, dist):
        self.K = np.asarray(K, np.float64)
        self.dist = np.asarray(dist, np.float64).reshape(-1)
        self._maps: Dict[Tuple[int, int], tuple] = {}

    def __call__(self, img: np.ndarray) -> np.ndarray:
        hw = img.shape[:2]
        if hw not in self._maps:
            self._maps[hw] = undistort_map(self.K, self.dist, hw)
        return remap_fixed(img, *self._maps[hw])


def undistort(img: np.ndarray, K, dist) -> np.ndarray:
    """One image through ``cv2.undistort``'s arithmetic (see the module)."""
    return Undistorter(K, dist)(img)
