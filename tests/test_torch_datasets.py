"""The port's dataset reader and scene writer (``data/datasets.py``,
``data/synthetic.py``'s disk half) against the JAX package's, which read
and write through OpenCV.

A scene written by either package's writer reads back through either
package's ``ReplicaEvent`` reader to the same arrays, bit for bit: colour,
depth, events, event mask and pose. Each package's ``reuse_if_current``
accepts the other's scene. The ``crop_size`` path resamples colour and
events in numpy where the JAX package goes through ``cv2.remap``: within
CROP_ATOL of it.
"""

import copy
import os

import cv2
import numpy as np
import pytest

from evennicer_slam_tpu.data import datasets as jd
from evennicer_slam_tpu.data import synthetic as js
from evennicer_slam_tpu_torch.data import datasets as td
from evennicer_slam_tpu_torch.data import synthetic as ts
from torch_parity import cap_threads

cap_threads()

SCENE = dict(n_frames=4, H=40, W=56, fx=50.0, fy=50.0, traj_step=0.03, furnished=True)
FIELDS = ("color", "depth", "event", "event_mask", "c2w")
# measured: colour 6.0e-8 (float32 rounding), events 0 (counts up to 255):
# cv2.remap with float32 maps interpolates these inputs in float arithmetic
CROP_ATOL = {"color": 1e-6, "event": 1e-4}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return {"jax": js.make_synthetic_replica(str(root / "jax"), **SCENE),
            "port": ts.make_synthetic_replica(str(root / "port"), **SCENE)}


def _cfg(frag, **cam):
    cfg = {"dataset": frag["dataset"], "data": dict(frag["data"]), "cam": dict(frag["cam"])}
    cfg["cam"].update(cam)
    return cfg


def _assert_frames_equal(a, b, msg):
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, (msg, k)
        assert np.array_equal(x, y), (msg, k, float(np.abs(x.astype(float) - y).max()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_writers_scene_reads_the_same_through_either_reader(scenes, writer):
    cfg = _cfg(scenes[writer])
    j_reader, t_reader = jd.get_dataset(cfg), td.get_dataset(cfg)
    assert len(j_reader) == len(t_reader) == SCENE["n_frames"]
    for i in range(SCENE["n_frames"]):
        _assert_frames_equal(t_reader[i], j_reader[i], f"{writer} scene, frame {i}")
    assert t_reader[2].event.any() and not t_reader[0].event.any()


def test_both_writers_write_the_same_pixels_and_config(scenes):
    j, t = scenes["jax"], scenes["port"]
    assert t["cam"] == j["cam"] and t["mapping"] == j["mapping"] and t["dataset"] == j["dataset"]
    for sub, pattern in (("results", "frame000002.png"), ("results", "depth000002.png"),
                         ("events", "frame000001.png")):
        a = cv2.imread(os.path.join(j["data"]["input_folder"], sub, pattern), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(t["data"]["input_folder"], sub, pattern), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and np.array_equal(a, b), pattern
    with open(os.path.join(j["data"]["input_folder"], "traj.txt")) as fa, \
            open(os.path.join(t["data"]["input_folder"], "traj.txt")) as fb:
        assert fa.read() == fb.read()


def test_synthetic_frames_equal_the_readers_frames(scenes):
    reader = td.get_dataset(_cfg(scenes["port"]))
    for f in ts.synthetic_frames(**{k: v for k, v in SCENE.items()}):
        _assert_frames_equal(f, reader[f.index], f"frame {f.index}")


def _mtimes(folder):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, fs in os.walk(folder) for f in fs}


@pytest.mark.parametrize("writer,checker", [("jax", "port"), ("port", "jax")])
def test_reuse_if_current_accepts_the_other_packages_scene(scenes, writer, checker):
    folder = scenes[writer]["data"]["input_folder"]
    before = _mtimes(folder)
    make = ts.make_synthetic_replica if checker == "port" else js.make_synthetic_replica
    frag = make(folder, reuse_if_current=True, **SCENE)
    assert _mtimes(folder) == before  # nothing rewritten
    assert frag["cam"] == scenes[writer]["cam"]


@pytest.mark.parametrize("change", [{"event_gain": 21.0}, {"n_frames": 3}, {"traj_step": 0.02}])
def test_reuse_if_current_rewrites_another_scene(tmp_path, change):
    folder = str(tmp_path / "s")
    ts.make_synthetic_replica(folder, **SCENE)
    args = dict(SCENE, **change)
    frag = ts.make_synthetic_replica(folder, reuse_if_current=True, **args)
    reader = td.get_dataset(_cfg(frag))
    assert len(reader) == args["n_frames"]
    for f in ts.synthetic_frames(**args):
        _assert_frames_equal(f, reader[f.index], f"frame {f.index} after {change}")


def test_crop_size_path_against_the_jax_reader(scenes):
    cfg = _cfg(scenes["jax"], crop_size=[30, 44], crop_edge=2)
    j_reader, t_reader = jd.get_dataset(cfg), td.get_dataset(cfg)
    for i in (0, 2):
        a, b = t_reader[i], j_reader[i]
        assert a.color.shape == b.color.shape == (26, 40, 3)
        np.testing.assert_array_equal(a.depth, b.depth)  # nearest: exact
        np.testing.assert_array_equal(a.c2w, b.c2w)
        np.testing.assert_allclose(a.color, b.color, atol=CROP_ATOL["color"], rtol=0)
        np.testing.assert_allclose(a.event, b.event, atol=CROP_ATOL["event"], rtol=0)


@pytest.mark.parametrize("out_hw", [(30, 50), (52, 70), (40, 56)])
def test_resize_matches_cv2_on_float_images(out_hw):
    img = np.random.default_rng(4).random((40, 56, 3))
    want = cv2.resize(img, (out_hw[1], out_hw[0]))
    np.testing.assert_allclose(td._resize_bilinear(img, out_hw), want, atol=1e-6, rtol=0)


def test_what_is_not_ported_raises_and_names_its_roadmap_item(scenes, tmp_path):
    """What this test once refused (the other families, ``cam.distortion``,
    JPEG frames) now reads: the port's ``dataset_dict`` has every family of
    the JAX package's; a distorted camera and JPEG colour frames give the
    JAX reader's frames (``test_torch_dataset_families.py`` holds every
    family). An unknown family and a short event folder still raise."""
    cfg = _cfg(scenes["port"])
    assert set(td.dataset_dict) == set(jd.dataset_dict)
    assert not hasattr(td, "NOT_PORTED")
    with pytest.raises(ValueError, match="unknown dataset"):
        td.get_dataset(dict(cfg, dataset="nope"))
    distorted = _cfg(scenes["port"], distortion=[0.1, 0.0, 0.0, 0.0, 0.0])
    for i in (0, 2):
        _assert_frames_equal(td.get_dataset(distorted)[i], jd.get_dataset(distorted)[i],
                             f"distorted camera, frame {i}")
    jpg = copy.deepcopy(cfg)
    jpg["data"]["input_folder"] = str(tmp_path)
    os.makedirs(tmp_path / "results")
    src = scenes["port"]["data"]["input_folder"]
    for i in range(SCENE["n_frames"]):
        rgb = cv2.imread(os.path.join(src, "results", f"frame{i:06d}.png"))
        cv2.imwrite(str(tmp_path / "results" / f"frame{i:06d}.jpg"), rgb)
        os.link(os.path.join(src, "results", f"depth{i:06d}.png"),
                tmp_path / "results" / f"depth{i:06d}.png")
    os.link(os.path.join(src, "traj.txt"), tmp_path / "traj.txt")
    jpg["dataset"] = "replica"
    t_reader, j_reader = td.get_dataset(jpg), jd.get_dataset(jpg)
    assert t_reader.color_paths[0].endswith(".jpg") and len(t_reader) == SCENE["n_frames"]
    _assert_frames_equal(t_reader[1], j_reader[1], "JPEG frames")
    short = copy.deepcopy(cfg)
    short["data"]["event_folder"] = str(tmp_path / "results")
    with pytest.raises(ValueError, match="event frames"):
        td.get_dataset(short)
