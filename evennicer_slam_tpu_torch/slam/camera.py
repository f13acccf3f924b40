"""Camera intrinsics record shared by tracker and renderer (counterpart of
``evennicer_slam_tpu/slam/camera.py``)."""

from __future__ import annotations

from typing import NamedTuple


class Camera(NamedTuple):
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_cfg(cfg) -> "Camera":
        """Intrinsics after the crop_size / crop_edge fixups."""
        cam = cfg["cam"]
        H, W = cam["H"], cam["W"]
        fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        if "crop_size" in cam:
            sx = cam["crop_size"][1] / W
            sy = cam["crop_size"][0] / H
            fx, fy, cx, cy = sx * fx, sy * fy, sx * cx, sy * cy
            W, H = cam["crop_size"][1], cam["crop_size"][0]
        edge = cam.get("crop_edge", 0)
        if edge > 0:
            H -= 2 * edge
            W -= 2 * edge
            cx -= edge
            cy -= edge
        return Camera(H, W, fx, fy, cx, cy)
