"""Every reader family of the port (``data/datasets.py``) against the JAX
package's, which reads through OpenCV, on tiny folders built the way
``tests/test_datasets.py`` builds them (its ``write_png_frame``, the JAX
``write_exr_float``): the same frames, colour, depth, events, event
masks and poses equal; TUM's poses (quaternions through scipy in both)
within TUM_POSE_ATOL (measured: equal). Replica reads JPEG frames through a
distorted camera, TUM undistorts with its five coefficients and the RPG
families with the eight of ``configs/rpg/rpg.yaml``.

Also the port's EXR reader (``data/exr.py``) against the JAX one on FLOAT
and HALF channels with NONE, ZIPS and ZIP compression, and every YAML under
``configs/`` accepted by the port's ``load_config`` and its device plan
(``parallel/sharding.py``) on one slot; the demo configuration's loose
split against the JAX package's ``concurrent_submeshes``.
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from evennicer_slam_tpu.data import datasets as jd
from evennicer_slam_tpu.data import exr as jexr
from evennicer_slam_tpu.data.exr import write_exr_float
from evennicer_slam_tpu.data.synthetic import make_synthetic_replica
from evennicer_slam_tpu.parallel.sharding import concurrent_submeshes
from evennicer_slam_tpu_torch.config import load_config
from evennicer_slam_tpu_torch.data import datasets as td
from evennicer_slam_tpu_torch.data import exr as texr
from evennicer_slam_tpu_torch.parallel.sharding import concurrent_groups, pipeline_dp_devices
from test_datasets import CAM, H, W, write_png_frame
from torch_parity import cap_threads

cap_threads()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("color", "depth", "event", "event_mask", "c2w")
TUM_POSE_ATOL = 1e-6
TUM_FR1 = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]  # configs/TUM_RGBD/freiburg1_desk.yaml
RPG_DIST = [-0.08409333, 0.05335822, -0.00065521, -0.0001679, 0, 0, 0, 0]  # configs/rpg


def _pose(k):
    pose = np.eye(4)
    c, s = np.cos(0.1 * k), np.sin(0.1 * k)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = [0.1 * k, -0.05 * k, 0.02 * k]
    return pose


def _traj(path, n):
    with open(path, "w") as f:
        f.write("\n".join(" ".join(map(str, _pose(k).reshape(-1))) for k in range(n)))


def _events(folder, n, name="ev{k:04d}.png"):
    """Event PNGs, written by cv2 (BGR): counts in two channels, zero in the third."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(9)
    for k in range(n):
        ev = np.zeros((H, W, 3), np.uint8)
        ev[..., 1:] = rng.integers(0, 4, (H, W, 2)) * (rng.random((H, W, 2)) < 0.3)
        cv2.imwrite(os.path.join(folder, name.format(k=k)), ev)


def build_replica(root):
    res = os.path.join(root, "results")
    os.makedirs(res)
    for k in range(3):
        write_png_frame(os.path.join(res, f"frame{k:06d}.jpg"),
                        os.path.join(res, f"depth{k:06d}.png"), k)
    _traj(os.path.join(root, "traj.txt"), 3)
    return {"dataset": "replica", "cam": dict(CAM, distortion=TUM_FR1),
            "data": {"input_folder": root}}


def build_replica_event(root):
    frag = make_synthetic_replica(root, n_frames=3, H=H, W=W, fx=20.0, fy=20.0,
                                  traj_step=0.05, furnished=True)
    return {"dataset": "replica_event", "cam": dict(frag["cam"], distortion=TUM_FR1),
            "data": frag["data"]}


def _rpg(root, n_img, n_event, density=None):
    res = os.path.join(root, "results")
    os.makedirs(res)
    for k in range(n_img):
        write_png_frame(os.path.join(res, f"frame{k:04d}.png"),
                        os.path.join(res, f"depth{k:04d}.png"), k)
    _traj(os.path.join(root, "traj.txt"), n_img)
    if density:
        _traj(os.path.join(root, f"traj_density{density}.txt"), n_event + 1)
    _events(os.path.join(root, "events"), n_event)
    data = {"input_folder": root, "event_folder": os.path.join(root, "events")}
    if density:
        data["density"] = density
    return {"cam": dict(CAM, distortion=RPG_DIST), "data": data}


def build_rpg(root):
    return dict(_rpg(root, 3, 2), dataset="rpg")


def build_rpg_event(root):
    return dict(_rpg(root, 3, 2), dataset="rpg_event")


def build_rpg_event_dense(root):
    return dict(_rpg(root, 3, 4, density=2), dataset="rpg_event_dense")


def build_azure(root):
    for sub in ("color", "depth", "scene"):
        os.makedirs(os.path.join(root, sub))
    lines = []
    for k in range(3):
        write_png_frame(os.path.join(root, "color", f"{k:04d}.jpg"),
                        os.path.join(root, "depth", f"{k:04d}.png"), k)
        lines.append(f"{k} {k} 1.0")
        lines += [" ".join(f"{v:.6f}" for v in row) for row in _pose(k)]
    with open(os.path.join(root, "scene", "trajectory.log"), "w") as f:
        f.write("\n".join(lines))
    return {"dataset": "azure", "cam": CAM, "data": {"input_folder": root}}


def build_scannet(root):
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(root, "frames", sub))
    for k in (0, 1, 2, 10):  # sorted by number, not by name
        write_png_frame(os.path.join(root, "frames", "color", f"{k}.jpg"),
                        os.path.join(root, "frames", "depth", f"{k}.png"), k)
        np.savetxt(os.path.join(root, "frames", "pose", f"{k}.txt"), _pose(k))
    return {"dataset": "scannet", "cam": CAM, "data": {"input_folder": root}}


def build_cofusion(root):
    os.makedirs(os.path.join(root, "colour"))
    os.makedirs(os.path.join(root, "depth_noise"))
    rng = np.random.default_rng(3)
    for k in range(2):
        cv2.imwrite(os.path.join(root, "colour", f"{k:04d}.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        write_exr_float(os.path.join(root, "depth_noise", f"{k:04d}.exr"),
                        {"Y": rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)})
    return {"dataset": "cofusion", "cam": dict(CAM, png_depth_scale=1.0),
            "data": {"input_folder": root}}


def build_tumrgbd(root):
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb, dep, gt = [], [], ["# timestamp tx ty tz qx qy qz qw"]
    for k in range(6):  # 40 ms apart: the 32 frames a second keep every other
        t = 1000.0 + 0.02 * k
        write_png_frame(os.path.join(root, "rgb", f"{t:.2f}.png"),
                        os.path.join(root, "depth", f"{t:.2f}.png"), k)
        rgb.append(f"{t:.4f} rgb/{t:.2f}.png")
        dep.append(f"{t + 0.005:.4f} depth/{t:.2f}.png")
        q = np.array([0.1 * k, -0.05, 0.02 * k, 1.0])
        q /= np.linalg.norm(q)
        gt.append(f"{t - 0.003:.4f} {0.1 * k:.4f} {0.02 * k:.4f} {-0.03 * k:.4f} "
                  + " ".join(f"{v:.6f}" for v in q))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gt)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines))
    return {"dataset": "tumrgbd", "cam": dict(CAM, distortion=TUM_FR1),
            "data": {"input_folder": root}}


FOLDERS = {name: globals()[f"build_{name}"] for name in td.dataset_dict}


@pytest.mark.parametrize("family", sorted(FOLDERS))
def test_family_reads_the_jax_readers_frames(family, tmp_path):
    cfg = FOLDERS[family](str(tmp_path / family))
    t_reader, j_reader = td.get_dataset(cfg), jd.get_dataset(cfg)
    assert type(t_reader).__name__ == type(j_reader).__name__
    assert len(t_reader) == len(j_reader) >= 2 and t_reader.has_events == j_reader.has_events
    for i in range(len(j_reader)):
        a, b = t_reader[i], j_reader[i]
        assert a.index == b.index == i
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.shape == y.shape, (family, i, k)
            if family == "tumrgbd" and k == "c2w":
                np.testing.assert_allclose(x, y, atol=TUM_POSE_ATOL, rtol=0)
            else:
                assert np.array_equal(x, y), (family, i, k, float(np.abs(x - y).max()))
    if t_reader.has_events:
        assert any(t_reader[i].event.any() for i in range(1, len(t_reader)))
    if family == "tumrgbd":
        assert len(t_reader) == 3  # thinned to 32 frames a second


# ---- EXR -----------------------------------------------------------------------------

def _exr_forward(raw: bytes) -> bytes:
    """EXR's ZIP pre-processing: interleave the bytes, then delta-predict."""
    a = np.frombuffer(raw, np.uint8)
    half = (a.size + 1) // 2
    inter = np.empty(a.size, np.uint8)
    inter[:half], inter[half:] = a[0::2], a[1::2]
    x = inter.astype(np.int64)
    return bytes([inter[0]]) + ((x[1:] - x[:-1] + 128) % 256).astype(np.uint8).tobytes()


def write_exr(path, channels, ptype, comp):
    """A scanline EXR with HALF (1) or FLOAT (2) channels, NONE (0), ZIPS
    (2) or ZIP (3) compression."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    dt = {1: "<f2", 2: "<f4"}[ptype]

    def attr(name, tname, payload):
        return name.encode() + b"\0" + tname.encode() + b"\0" + struct.pack(
            "<i", len(payload)) + payload

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i4Bii", ptype, 0, 0, 0, 0, 1, 1)
                      for n in names) + b"\0"
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = struct.pack("<ii", 20000630, 2) + b"".join([
        attr("channels", "chlist", chlist), attr("compression", "compression", bytes([comp])),
        attr("dataWindow", "box2i", dw), attr("displayWindow", "box2i", dw),
        attr("lineOrder", "lineOrder", b"\0"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0))]) + b"\0"
    lines = 16 if comp == 3 else 1
    blocks = []
    for y0 in range(0, h, lines):
        raw = b"".join(channels[n][y].astype(dt).tobytes()
                       for y in range(y0, min(y0 + lines, h)) for n in names)
        if comp:
            packed = zlib.compress(_exr_forward(raw))
            raw = packed if len(packed) < len(raw) else raw
        blocks.append(struct.pack("<ii", y0, len(raw)) + raw)
    at = len(header) + 8 * len(blocks)
    offsets = []
    for b in blocks:
        offsets.append(at)
        at += len(b)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(offsets)}q", *offsets) + b"".join(blocks))


@pytest.mark.parametrize("ptype", [1, 2], ids=["HALF", "FLOAT"])
@pytest.mark.parametrize("comp", [0, 2, 3], ids=["NONE", "ZIPS", "ZIP"])
def test_exr_reader_equals_the_jax_reader(tmp_path, ptype, comp):
    rng = np.random.default_rng(ptype * 10 + comp)
    h, w = 37, 21
    smooth = np.tile(np.linspace(0.5, 2.0, w, dtype=np.float32), (h, 1))  # compresses
    sets = [{"Y": smooth}, {"Z": rng.uniform(0.1, 4.0, (h, w)).astype(np.float32)},
            {"R": smooth, "G": smooth * 2, "B": smooth * 3},
            {"depth": smooth + rng.uniform(0, 1e-3, (h, w)).astype(np.float32)}]
    for i, chans in enumerate(sets):
        path = str(tmp_path / f"{i}.exr")
        write_exr(path, chans, ptype, comp)
        got, want = texr.read_exr(path), jexr.read_exr(path)
        assert list(got) == list(want) == sorted(chans)
        for k in chans:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_allclose(got[k], chans[k], rtol=1e-3 if ptype == 1 else 0)
        np.testing.assert_array_equal(texr.read_exr_depth(path), jd.readEXR_onlydepth(path))


def test_every_shipped_config_is_supported():
    """Every shipped configuration builds its device plan: on one slot none
    goes concurrent or data-parallel. The demo configuration's loose
    schedule with ``parallel.map_devices`` splits 2 and 4 slots as the JAX
    package's rule does (the last k slots map; ``'auto'`` is max(1, n // 4)),
    and 8 slots exactly as the JAX package splits its eight devices."""
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
    assert len(paths) >= 50
    for path in paths:
        cfg = load_config(path)
        assert concurrent_groups(cfg, ["cpu"]) is None, path
        assert pipeline_dp_devices(cfg, ["cpu"]) is None, path
    demo = load_config(os.path.join(ROOT, "configs", "Demo", "demo.yaml"))
    assert demo["sync_method"] == "loose"
    plan = concurrent_groups(dict(demo, parallel={"map_devices": 1}), ["cpu"] * 2)
    assert (plan.n_track, plan.n_map, plan.track_dp, plan.map_dp) == (1, 1, None, None)
    assert concurrent_groups(dict(demo, parallel={"map_devices": "auto"}), ["cpu"]) is None
    plan = concurrent_groups(dict(demo, parallel={"map_devices": "auto"}), ["cpu"] * 4)
    assert (plan.n_track, plan.n_map) == (3, 1) and len(plan.track_dp) == 3
    for want in (1, 2, "auto"):
        change = dict(demo, parallel={"map_devices": want})
        plan, ref = concurrent_groups(change, ["cpu"] * 8), concurrent_submeshes(change)
        assert (plan.n_track, plan.n_map) == (ref.n_track, ref.n_map)