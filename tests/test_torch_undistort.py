"""The port's ``undistort`` (``data/undistort.py``) against
``cv2.undistort`` with the distortion of the shipped configurations: TUM
freiburg1 (5 coefficients, ``configs/TUM_RGBD/freiburg1_desk.yaml``) and RPG
(8, the rational model, ``configs/rpg/rpg.yaml``).

uint8 images: at most UINT8_LEVELS level apart, expected equal (the same
fixed-point map and 15-bit weights; measured 0 pixels apart). float64
images (the RPG event frames): within FLOAT_ATOL (the weights of the same
table are exact at 1/32 steps; measured 0.0). The map is computed once per
image size and reused.
"""

import os

import cv2
import numpy as np
import pytest

from evennicer_slam_tpu_torch.config import load_config
from evennicer_slam_tpu_torch.data.undistort import Undistorter, undistort
from torch_parity import cap_threads

cap_threads()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UINT8_LEVELS = 1
FLOAT_ATOL = 1e-4


def _camera(name):
    cam = load_config(os.path.join(ROOT, "configs", *name.split("/")))["cam"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    return K, np.array(cam["distortion"]), (cam["H"], cam["W"])


CAMERAS = {"tum_fr1": "TUM_RGBD/freiburg1_desk.yaml", "rpg": "rpg/rpg.yaml"}


@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("dtype", ["uint8", "float64"])
def test_undistort_equals_cv2(camera, dtype):
    K, dist, hw = _camera(CAMERAS[camera])
    assert dist.size == {"tum_fr1": 5, "rpg": 8}[camera]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    if dtype == "float64":
        img = img.astype(np.float64) * 0.37  # event counts are not whole levels
    got = undistort(img, K, dist)
    want = cv2.undistort(img, K, dist)
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want)
    print(f"{camera} {dtype}: max diff {d.max()}, {int((d > 0).sum())} values apart")
    if dtype == "uint8":
        assert d.max() <= UINT8_LEVELS
    else:
        assert d.max() <= FLOAT_ATOL


def test_four_coefficients_grey_images_and_the_cached_map():
    K, dist, _ = _camera(CAMERAS["tum_fr1"])
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    np.testing.assert_array_equal(undistort(grey, K, dist[:4]), cv2.undistort(grey, K, dist[:4]))
    und = Undistorter(K, dist)
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(und(a), cv2.undistort(a, K, dist))
    np.testing.assert_array_equal(und(b), cv2.undistort(b, K, dist))
    assert list(und._maps) == [(48, 64)]  # one map, computed once
    with pytest.raises(ValueError, match="distortion coefficients"):
        undistort(grey, K, dist[:3])
