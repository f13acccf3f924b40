"""Dataset readers (counterpart of ``evennicer_slam_tpu/data/datasets.py``):
all nine families of the JAX package,

    replica, replica_event, rpg, rpg_event, rpg_event_dense,
    azure, scannet, cofusion, tumrgbd

in numpy, without OpenCV: images through :func:`read_image` (``data/png.py``,
``data/jpeg.py``, chosen by the file's magic bytes as ``cv2.imread`` does),
``cam.distortion`` through ``data/undistort.py`` (the map computed once per
reader), EXR depth through ``data/exr.py``.

Spans (``utils/telemetry.py``): ``slam.reader.undistort`` around each lens
undistortion of a colour or event image, carrying the frame's index and
detached like the prefetch worker's ``slam.reader.decode``, inside which it
runs; the counter ``slam.reader.image_reread`` counts the dense event
reader's steps that decode again the colour and depth of an image an
earlier step read (``index % density != 0``).

Every reader yields a :class:`Frame` with host numpy arrays: colour RGB in
[0, 1], depth scaled, the event image as counts with polarity order [-, +]
(all zero for non-event datasets), the pose with the y/z camera axes flipped
and the translation scaled, as the JAX package's readers do. Images stay in
the file's channel order (RGB), so the JAX readers' BGR -> RGB swaps have no
counterpart here; the frames come out equal.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from evennicer_slam_tpu_torch.data.exr import read_exr_depth
from evennicer_slam_tpu_torch.data.jpeg import SOI, decode_jpeg
from evennicer_slam_tpu_torch.data.png import SIGNATURE, decode_png, read_png
from evennicer_slam_tpu_torch.data.synthetic import Frame
from evennicer_slam_tpu_torch.data.undistort import Undistorter
from evennicer_slam_tpu_torch.utils.telemetry import TRACER


def _png_grey(rgb: np.ndarray) -> np.ndarray:
    """An RGB PNG read as grey, as ``cv2.imread(..., IMREAD_GRAYSCALE)``
    returns it: libpng's ``rgb_to_gray`` with OpenCV's weights 0.299 and
    0.587 in 15-bit fixed point, truncated (9797, 19234, 3737 / 32768)."""
    rgb = rgb.astype(np.int64)
    return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1] + 3737 * rgb[..., 2]) >> 15).astype(
        np.uint8)


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """An 8-bit PNG or JPEG file -> ``[H, W, 3]`` RGB uint8, or ``[H, W]``
    with ``grayscale``: ``cv2.imread`` with ``IMREAD_COLOR`` /
    ``IMREAD_GRAYSCALE``, channels in the file's order. The format is told
    by the magic bytes, not by the extension."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == SIGNATURE:
        img = decode_png(data, path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: colour frames are 8-bit, got {img.dtype}")
        if img.ndim == 3:
            img = img[..., :3]
            if grayscale:
                img = _png_grey(img)
    elif data[:2] == SOI:
        img = decode_jpeg(data, grayscale, path)
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    if not grayscale and img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


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
    """Replica/RPG-style traj.txt: 16 floats per line, y/z flipped."""
    with open(path) as f:
        lines = f.readlines()
    return [_flip_yz(np.array(list(map(float, lines[i].split()))).reshape(4, 4))
            .astype(np.float32) for i in range(n)]


class BaseDataset:
    """Shared preprocessing: colour /255 after the optional undistortion,
    depth / png_depth_scale * scale, crop_size resize, crop_edge crop."""

    has_events = False

    def __init__(self, cfg, args=None, scale: float = 1.0):
        self.name = cfg["dataset"]
        self.scale = scale
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy, self.cx, self.cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
        self.distortion = np.array(cam["distortion"]) if "distortion" in cam else None
        self.undistort = None if self.distortion is None else Undistorter(
            as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy]), self.distortion)
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

    def _undistorted(self, data: np.ndarray, index: int) -> np.ndarray:
        """``data`` through the lens undistortion, if the camera has a lens."""
        if self.undistort is None:
            return data
        with TRACER.span("slam.reader.undistort", frame=index, detached=True):
            return self.undistort(data)

    def _read_color(self, path: str, index: int, grayscale: bool = False) -> np.ndarray:
        data = read_image(path, grayscale)
        if grayscale:
            data = np.repeat(data[..., None], 3, axis=-1)
        return self._undistorted(data, index).astype(np.float64) / 255.0

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".exr"):
            depth = read_exr_depth(path)
        else:
            depth = read_png(path)
        return depth.astype(np.float32) / self.png_depth_scale

    def _read_event_image(self, path: str, index: int) -> np.ndarray:
        """An event PNG as float64 RGB, undistorted as the colour is."""
        return self._undistorted(read_image(path).astype(np.float64), index)

    def _read_event(self, index: int, like_shape) -> np.ndarray:
        """Step ``index``'s event image (event file ``index - 1``); all zero
        at step 0."""
        if index >= 1:
            return self._read_event_image(self.event_paths[index - 1], index).astype(np.float32)
        return np.zeros(like_shape, np.float32)

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
        color = self._read_color(self.color_paths[index], index)
        depth = self._read_depth(self.depth_paths[index])
        color, depth, _ = self._postprocess(color, depth)
        event = np.zeros((*depth.shape, 2), np.float32)
        mask = np.zeros(depth.shape, np.int32)
        return Frame(index, color, depth, event, mask, self._pose(index))




def _event_frame(index, color, depth, event, pose) -> Frame:
    mask = (np.any(event != 0, axis=-1)).astype(np.int32)
    return Frame(index, color, depth, event, mask, pose)


class Replica(BaseDataset):
    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        if not self.color_paths:  # the synthetic scenes write PNG
            self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*.png"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        self.poses = _load_traj_txt(f"{self.input_folder}/traj.txt", self.n_img)


def _event_folder(cfg, args) -> str:
    event_folder = getattr(args, "event_folder", None) if args else None
    return event_folder or cfg["data"]["event_folder"]


class ReplicaEvent(Replica):
    """Replica + ground-truth event PNGs. The event file holds [0, -, +] in
    RGB order; channels 1: are kept -> polarity order [-, +]. Frame 0 gets
    an all-black event image."""

    has_events = True

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.event_folder = _event_folder(cfg, args)
        self.event_paths = sorted(glob.glob(f"{self.event_folder}/*frame*.png"))
        self.n_event = len(self.event_paths)
        if self.n_event != self.n_img - 1:
            raise ValueError(f"{self.event_folder}: {self.n_event} event frames for "
                             f"{self.n_img} images; expected one fewer")

    def __getitem__(self, index: int) -> Frame:
        color = self._read_color(self.color_paths[index], index)
        depth = self._read_depth(self.depth_paths[index])
        event = self._read_event(index, color.shape)
        color, depth, event = self._postprocess(color, depth, event)
        return _event_frame(index, color, depth, event[:, :, 1:], self._pose(index))


class RPG(BaseDataset):
    """RPG: grey frames (read as grey, repeated to three channels)."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(f"{self.input_folder}/results/frame*"))
        self.depth_paths = sorted(glob.glob(f"{self.input_folder}/results/depth*"))
        self.n_img = len(self.color_paths)
        self.poses = _load_traj_txt(f"{self.input_folder}/traj.txt", self.n_img)

    def __getitem__(self, index: int) -> Frame:
        color = self._read_color(self.color_paths[index], index, grayscale=True)
        depth = self._read_depth(self.depth_paths[index])
        color, depth, _ = self._postprocess(color, depth)
        event = np.zeros((*depth.shape, 2), np.float32)
        mask = np.zeros(depth.shape, np.int32)
        return Frame(index, color, depth, event, mask, self._pose(index))


class RPGEvent(RPG):
    """RPG grey frames + event PNGs, which hold [+, -, 0] in RGB order: the
    green and red channels, in that order, give polarity order [-, +]."""

    has_events = True

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.event_folder = _event_folder(cfg, args)
        self.event_paths = sorted(glob.glob(f"{self.event_folder}/*.png"))
        self.n_event = len(self.event_paths)
        if self.n_event != self.n_img - 1:
            raise ValueError(f"{self.event_folder}: {self.n_event} event frames for "
                             f"{self.n_img} images; expected one fewer")

    def __getitem__(self, index: int) -> Frame:
        color = self._read_color(self.color_paths[index], index, grayscale=True)
        depth = self._read_depth(self.depth_paths[index])
        event = self._read_event(index, color.shape)
        color, depth, event = self._postprocess(color, depth, event)
        return _event_frame(index, color, depth, event[:, :, [1, 0]], self._pose(index))


class RPGEventDense(RPGEvent):
    """Densified event frames: ``density`` event frames per RGB frame, poses
    from ``traj_density{d}.txt``; colour and depth are those of frame
    ``index // density``."""

    def __init__(self, cfg, args=None, scale=1.0):
        RPG.__init__(self, cfg, args, scale)  # its own event count check
        self.event_folder = _event_folder(cfg, args)
        self.event_paths = sorted(glob.glob(f"{self.event_folder}/*.png"))
        self.density = cfg["data"]["density"]
        self.n_event = len(self.event_paths)
        if self.n_event != self.n_img * self.density - self.density:
            raise ValueError(f"{self.event_folder}: {self.n_event} event frames for "
                             f"{self.n_img} images at density {self.density}")
        self.poses = _load_traj_txt(f"{self.input_folder}/traj_density{self.density}.txt",
                                    self.n_event + 1)

    def __len__(self):
        return self.n_event + 1

    def __getitem__(self, index: int) -> Frame:
        if index % self.density:
            TRACER.add("slam.reader.image_reread")
        color = self._read_color(self.color_paths[index // self.density], index, grayscale=True)
        depth = self._read_depth(self.depth_paths[index // self.density])
        event = self._read_event(index, color.shape)
        color, depth, event = self._postprocess(color, depth, event)
        return _event_frame(index, color, depth, event[:, :, [1, 0]], self._pose(index))


class Azure(BaseDataset):
    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        self.n_img = len(self.color_paths)
        self._load_poses(os.path.join(self.input_folder, "scene", "trajectory.log"))

    def _load_poses(self, path):
        """trajectory.log: a header line and four matrix rows a frame;
        identity poses where there is none."""
        if not os.path.exists(path):
            self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]
            return
        with open(path) as f:
            content = f.readlines()
        self.poses = [
            _flip_yz(np.array(list(map(float, "".join(content[i + 1:i + 5]).strip().split())))
                     .reshape(4, 4)).astype(np.float32)
            for i in range(0, len(content), 5)]


def _by_number(path: str) -> int:
    return int(os.path.basename(path)[:-4])


class ScanNet(BaseDataset):
    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.input_folder = os.path.join(self.input_folder, "frames")
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "color", "*.jpg")),
                                  key=_by_number)
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")),
                                  key=_by_number)
        pose_paths = sorted(glob.glob(os.path.join(self.input_folder, "pose", "*.txt")),
                            key=_by_number)
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4)).astype(np.float32)
                      for p in pose_paths]
        self.n_img = len(self.color_paths)


class CoFusion(BaseDataset):
    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths = sorted(glob.glob(os.path.join(self.input_folder, "colour", "*.png")))
        self.depth_paths = sorted(glob.glob(os.path.join(self.input_folder, "depth_noise",
                                                         "*.exr")))
        self.n_img = len(self.color_paths)
        # identity poses, as the reference gives (the ATE aligns them)
        self.poses = [np.eye(4, dtype=np.float32) for _ in range(self.n_img)]


class TUMRGBD(BaseDataset):
    """TUM RGB-D: rgb / depth / ground truth associated by timestamp,
    thinned to at most 32 frames a second, poses relative to the first."""

    def __init__(self, cfg, args=None, scale=1.0):
        super().__init__(cfg, args, scale)
        self.color_paths, self.depth_paths, self.poses = self._loadtum(
            self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if np.abs(t_depth[j] - t) < max_dt and np.abs(t_pose[k] - t) < max_dt:
                associations.append((i, j, k))
        return associations

    def _loadtum(self, datapath, frame_rate=-1):
        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        associations = self._associate(t_img, t_depth, t_pose)

        indices = [0]
        for i in range(1, len(associations)):
            t0 = t_img[associations[indices[-1]][0]]
            t1 = t_img[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = associations[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = self._pose_from_quat(pose_vecs[k])
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_flip_yz(c2w).astype(np.float32))
        return images, depths, poses

    @staticmethod
    def _pose_from_quat(pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose


dataset_dict: Dict[str, type] = {
    "replica": Replica,
    "replica_event": ReplicaEvent,
    "rpg": RPG,
    "rpg_event": RPGEvent,
    "rpg_event_dense": RPGEventDense,
    "azure": Azure,
    "scannet": ScanNet,
    "cofusion": CoFusion,
    "tumrgbd": TUMRGBD,
}


def get_dataset(cfg, args=None, scale: float = 1.0) -> BaseDataset:
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}")
    return dataset_dict[name](cfg, args, scale)
