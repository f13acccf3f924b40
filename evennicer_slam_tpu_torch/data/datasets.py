"""Dataset readers (counterpart of ``evennicer_slam_tpu/data/datasets.py``;
numpy only, the PNG files through ``data/png.py``).

Ported: ``replica`` and ``replica_event``, the format the synthetic scene
writer produces (``data/synthetic.py::make_synthetic_replica``). The other
families of the JAX package (rpg, rpg_event, rpg_event_dense, azure, scannet,
cofusion, tumrgbd), JPEG frames and ``cam.distortion`` raise
``NotImplementedError``: they need a JPEG decoder and a numpy ``undistort``
(ROADMAP Queue 1 item 4).

Every reader yields a :class:`Frame` with host numpy arrays: colour RGB in
[0, 1], depth scaled, the event image as counts with polarity order [-, +]
(all zero for non-event datasets), the pose with the y/z camera axes flipped
and the translation scaled, as the JAX package's readers do.
"""

from __future__ import annotations

import glob
from typing import Dict, List

import numpy as np

from evennicer_slam_tpu_torch.data.png import read_png
from evennicer_slam_tpu_torch.data.synthetic import Frame

LATER = "ROADMAP Queue 1 item 4 (host side, the other datasets, and tools)"


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intrinsics
    return K


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


def _resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize with half-pixel centres and edge clamping, the
    arithmetic of ``cv2.resize(..., INTER_LINEAR)`` on float images."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return img

    def axis(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(np.int64)
        w = f - i0
        w = np.where(i0 < 0, 0.0, np.where(i0 >= n_in - 1, 0.0, w))
        i0 = np.clip(i0, 0, n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), w

    y0, y1, wy = axis(oh, H)
    x0, x1, wx = axis(ow, W)
    shape = (-1, 1) + (1,) * (img.ndim - 2)
    wy = wy.reshape(shape)
    wx = wx.reshape((1, -1) + (1,) * (img.ndim - 2))
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


def _interp_align_corners(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize with align_corners=True (the reference's crop_size
    path) in float32, where the JAX package samples through ``cv2.remap``;
    the two agree to float32 rounding (``tests/test_torch_datasets.py``)."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    ys = np.linspace(0, H - 1, oh).astype(np.float32)
    xs = np.linspace(0, W - 1, ow).astype(np.float32)
    img = img.astype(np.float32)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)
    wy = (ys - y0).reshape((-1, 1) + (1,) * (img.ndim - 2))
    wx = (xs - x0).reshape((1, -1) + (1,) * (img.ndim - 2))
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _interp_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    H, W = img.shape[:2]
    oh, ow = out_hw
    ri = np.floor(np.arange(oh) * (H / oh)).astype(np.int64)
    ci = np.floor(np.arange(ow) * (W / ow)).astype(np.int64)
    return img[ri][:, ci]


def _load_traj_txt(path: str, n: int) -> List[np.ndarray]:
    """Replica-style traj.txt: 16 floats per line, y/z flipped."""
    with open(path) as f:
        lines = f.readlines()
    return [_flip_yz(np.array(list(map(float, lines[i].split()))).reshape(4, 4))
            .astype(np.float32) for i in range(n)]


class BaseDataset:
    """Shared preprocessing: colour /255, depth / png_depth_scale * scale,
    crop_size resize, crop_edge crop."""

    has_events = False

    def __init__(self, cfg, args=None, scale: float = 1.0):
        self.name = cfg["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy, self.cx, self.cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        if "distortion" in cam:
            raise NotImplementedError(f"cam.distortion needs a numpy undistort: {LATER}")
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam["crop_edge"]
        input_folder = getattr(args, "input_folder", None) if args else None
        self.input_folder = input_folder or cfg["data"]["input_folder"]
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0

    def __len__(self):
        return self.n_img

    def _read_color(self, path: str) -> np.ndarray:
        data = read_png(path)  # RGB: the file's order (cv2 would return BGR)
        if data.ndim == 2:
            data = np.repeat(data[..., None], 3, axis=-1)
        if data.dtype != np.uint8:
            raise ValueError(f"{path}: colour frames are 8-bit, got {data.dtype}")
        return data[..., :3].astype(np.float64) / 255.0

    def _read_depth(self, path: str) -> np.ndarray:
        if not path.endswith(".png"):
            raise NotImplementedError(f"{path}: depth other than PNG: {LATER}")
        return read_png(path).astype(np.float32) / self.png_depth_scale

    def _postprocess(self, color, depth, event=None):
        H, W = depth.shape
        color = _resize_bilinear(color, (H, W))
        depth = depth * self.scale
        if event is not None:
            event = _resize_bilinear(event, (H, W))
        if self.crop_size is not None:
            ch, cw = self.crop_size
            # bilinear with align_corners=True for colour and events, nearest
            # for depth, as the reference interpolates them
            color = _interp_align_corners(color, (ch, cw))
            depth = _interp_nearest(depth, (ch, cw))
            if event is not None:
                event = _interp_align_corners(event, (ch, cw))
        edge = self.crop_edge
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
            if event is not None:
                event = event[edge:-edge, edge:-edge]
        return color.astype(np.float32), depth.astype(np.float32), (
            None if event is None else event.astype(np.float32)
        )

    def _pose(self, index: int) -> np.ndarray:
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return pose.astype(np.float32)

    def __getitem__(self, index: int) -> Frame:
        color = self._read_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        color, depth, _ = self._postprocess(color, depth)
        event = np.zeros((*depth.shape, 2), np.float32)
        mask = np.zeros(depth.shape, np.int32)
        return Frame(index, color, depth, event, mask, self._pose(index))


class Replica(BaseDataset):
    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        if glob.glob(f"{self.input_folder}/results/frame*.jpg"):
            raise NotImplementedError(
                f"{self.input_folder}: JPEG frames need a JPEG decoder: {LATER}")
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.png"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.poses = _load_traj_txt(f"{self.input_folder}/traj.txt", self.n_img)


class ReplicaEvent(Replica):
    """Replica + ground-truth event PNGs. The event file holds
    [0, -, +] in RGB order (cv2 reads it as BGR [+, -, 0] and the JAX
    reader swaps it back); channels 1: are kept -> polarity order [-, +].
    Frame 0 gets an all-black event image."""

    has_events = True

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        event_folder = getattr(args, "event_folder", None) if args else None
        self.event_folder = event_folder or cfg["data"]["event_folder"]
        self.event_paths = sorted(glob.glob(f"{self.event_folder}/*frame*.png"))
        self.n_event = len(self.event_paths)
        if self.n_event != self.n_img - 1:
            raise ValueError(f"{self.event_folder}: {self.n_event} event frames for "
                             f"{self.n_img} images; expected one fewer")

    def _read_event(self, index: int, like_shape) -> np.ndarray:
        if index - 1 >= 0:
            data = read_png(self.event_paths[index - 1]).astype(np.float64)
        else:
            data = np.zeros(like_shape, np.float64)
        return data.astype(np.float32)

    def __getitem__(self, index: int) -> Frame:
        color = self._read_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        event = self._read_event(index, color.shape)
        color, depth, event = self._postprocess(color, depth, event)
        event = event[:, :, 1:]  # [-, +]
        mask = (np.any(event != 0, axis=-1)).astype(np.int32)
        return Frame(index, color, depth, event, mask, self._pose(index))


dataset_dict: Dict[str, type] = {
    "replica": Replica,
    "replica_event": ReplicaEvent,
}
# the JAX package's other readers
NOT_PORTED = ("rpg", "rpg_event", "rpg_event_dense", "azure", "scannet", "cofusion", "tumrgbd")


def get_dataset(cfg, args=None, scale: float = 1.0) -> BaseDataset:
    name = cfg["dataset"]
    if name in NOT_PORTED:
        raise NotImplementedError(f"dataset {name!r}: {LATER}")
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}")
    return dataset_dict[name](cfg, args, scale)
