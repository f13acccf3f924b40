"""The benchmark's scene against ``data/synthetic.py`` at a small size on
the CPU, and the loop on disk: exactly periodic, the event that closes it
included."""

import os

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch.data import synthetic as syn
from portbench import scene

BOUND = np.array([[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]], np.float32)
H, W, F = 48, 80, 40.0


def test_poses_match_the_circular_trajectory():
    center = BOUND.mean(axis=1)
    ref = syn.circular_trajectory(5, center, step=0.07)
    ours = scene.trajectory(np.arange(5) * 0.07, center)
    assert np.array_equal(ref, ours)
    for k in range(5):
        assert np.array_equal(scene.look_at(ours[k][:3, 3], ours[k][:3, 3] + np.ones(3)),
                              syn._look_at(ours[k][:3, 3], ours[k][:3, 3] + np.ones(3)))


def test_colour_depth_and_events_match_synthetic():
    n = 4
    poses = syn.circular_trajectory(n, BOUND.mean(axis=1), step=0.05)
    ref = list(syn._scene_images(n, H, W, F, F, BOUND, 20.0, 0.05, 0.0, 7, True, None))
    ours = list(scene.quantised_frames(poses, H, W, F, F, BOUND, 20.0, torch.device("cpu")))
    for k in range(n):
        _, c8, d16, e8 = ref[k]
        oc, od, oe = ours[k]
        assert np.array_equal(c8, oc), k
        assert np.array_equal(d16, od), k
        if k > 0:  # synthetic's frame 0 has no events; the loop's has the closing ones
            assert np.array_equal(e8, oe), k
    # the float renders agree to float32 rounding
    c, d = syn.render_box_views(poses[1], H, W, F, F, (W - 1) / 2, (H - 1) / 2, BOUND,
                                prims=syn.scene_primitives(BOUND))
    oc, od = scene.render_view(poses[1], H, W, F, F, BOUND, scene.scene_primitives(BOUND), "cpu")
    assert np.abs(c - oc.numpy()).max() < 1e-6 and np.array_equal(d, od.numpy())


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    params = {"H": H, "W": W, "fx": F, "fy": F, "bound": BOUND.tolist(), "margin": 0.02,
              "loop_frames": 5, "frames": 13, "amplitude": 0.3, "event_gain": 20.0}
    root = str(tmp_path_factory.mktemp("pb"))
    frag = scene.write_scene(root, params, torch.device("cpu"))
    assert scene.write_scene(root, params, torch.device("cpu")) == frag  # kept, not rewritten
    return params, frag


def test_loop_is_exactly_periodic(loop):
    from evennicer_slam_tpu_torch.data.datasets import ReplicaEvent

    params, frag = loop
    cfg = dict(frag, cam=dict(frag["cam"]), data=dict(frag["data"]))
    reader = ReplicaEvent(cfg, None, 1.0)
    P = params["loop_frames"]
    assert len(reader) == params["frames"]
    for k in range(1, params["frames"] - P):
        a, b = reader[k], reader[k + P]
        for x, y in ((a.color, b.color), (a.depth, b.depth), (a.event, b.event),
                     (a.c2w, b.c2w)):
            assert np.array_equal(x, y), k
    # the event closing the loop: frame P is loop frame 0 seen from loop frame P - 1
    poses = scene.loop_poses(params)
    box = scene.room_box(params)
    frames = list(scene.quantised_frames(poses, H, W, F, F, box, 20.0, torch.device("cpu")))
    assert np.array_equal(reader[P].event, frames[0][2].astype(np.float32))
    assert np.array_equal(reader[P].color, reader[0].color)
    assert reader[P].event.any() and not reader[0].event.any()


# -- the layouts ---------------------------------------------------------------

RPG_DIST = [-0.08409333, 0.05335822, -0.00065521, -0.0001679, 0, 0, 0, 0]
SMALL = {"H": H, "W": W, "fx": F, "fy": F, "bound": BOUND.tolist(), "margin": 0.02,
         "loop_frames": 5, "frames": 8, "amplitude": 0.3, "event_gain": 20.0}
REPLICA_CAM = {"cam": {"png_depth_scale": 6553.5}, "data": {}}
# the camera of upstream's configs/rpg/*_density*.yaml, at density 3
RPG_CAM = {"cam": {"png_depth_scale": 1000.0, "distortion": RPG_DIST}, "data": {"density": 3}}
LAYOUTS = {
    "replica_event": ({}, REPLICA_CAM),
    "replica": ({"layout": "replica"}, REPLICA_CAM),
    "rpg_event_dense": ({"layout": "rpg_event_dense"}, RPG_CAM),
}


def _cfg(frag):
    return dict(frag, cam=dict(frag["cam"]), data=dict(frag["data"]), scale=1.0)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("layouts"))
    out = {}
    for name, (keys, cfg) in LAYOUTS.items():
        params = scene.recorded(dict(SMALL, **keys), cfg)
        out[name] = (params, scene.write_scene(root, params, torch.device("cpu")))
    return out


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_reader_and_check_decode_alike(written, name):
    """Every frame of each layout, read by the port's reader of the
    fragment's dataset and by the check's own decode: exactly equal."""
    from evennicer_slam_tpu_torch.data.datasets import get_dataset
    from portbench.check import Frames

    params, frag = written[name]
    reader = get_dataset(_cfg(frag), None, 1.0)
    frames = Frames(_cfg(frag), torch.device("cpu"))
    assert reader.has_events == (scene.layout(params) != "replica")
    d = scene.density(params)
    assert len(reader) == params["frames"] * d - d + 1
    for k in range(len(reader)):
        f = reader[k]
        for a, b in zip((f.color, f.depth, f.event), frames.host(k)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, k)
    assert any(reader[k].event.any() for k in range(1, len(reader))) == reader.has_events


def test_camera_is_the_configurations(written):
    """What the camera records comes from the configuration: a Replica
    configuration adds nothing to the mix's scene, the RPG one its lens,
    depth scale and density; a mix that states them is refused."""
    assert written["replica_event"][0] == SMALL
    assert written["rpg_event_dense"][0] == dict(
        SMALL, layout="rpg_event_dense", png_depth_scale=1000.0, distortion=RPG_DIST, density=3)
    for key in ("png_depth_scale", "distortion", "density"):
        with pytest.raises(ValueError):
            scene.recorded(dict(SMALL, **{key: 1}), REPLICA_CAM)


def test_replica_layout_shares_the_event_scene(written):
    (p_ev, f_ev), (p_rgbd, f_rgbd) = written["replica_event"], written["replica"]
    assert scene.scene_key(p_ev) == scene.scene_key(p_rgbd)
    assert f_ev["data"]["input_folder"] == f_rgbd["data"]["input_folder"]
    assert (f_ev["dataset"], f_rgbd["dataset"]) == ("replica_event", "replica")
    assert "event_folder" not in f_rgbd["data"]


def test_dense_layout_files(written):
    """The RPG dense-event layout: n_img x d - d event files, each the uint8
    change between consecutive dense poses in [+, -, 0] order; dense step k
    carries image k // d; the two trajectory files' lengths."""
    from evennicer_slam_tpu_torch.data.datasets import RPGEventDense
    from portbench.reference.data.png import read_png

    params, frag = written["rpg_event_dense"]
    P, N, d = params["loop_frames"], params["frames"], params["density"]
    data = frag["data"]["input_folder"]
    assert (frag["dataset"], frag["data"]["density"]) == ("rpg_event_dense", d)
    assert frag["cam"]["distortion"] == RPG_DIST and frag["cam"]["png_depth_scale"] == 1000.0
    events = sorted(os.listdir(frag["data"]["event_folder"]))
    assert len(events) == N * d - d
    loop = list(scene.loop_frames(params, torch.device("cpu")))
    assert len(loop) == P * d
    for e, fname in enumerate(events):
        raw = read_png(os.path.join(frag["data"]["event_folder"], fname))
        ev = loop[(e + 1) % (P * d)][2]  # the change from dense pose e to e + 1, [-, +]
        assert np.array_equal(raw, np.stack([ev[..., 1], ev[..., 0], 0 * ev[..., 0]], -1)), e
    for k in range(N):
        assert np.array_equal(read_png(os.path.join(data, "results", f"frame{k:06d}.png")),
                              loop[(k % P) * d][0])
    with open(os.path.join(data, "traj.txt")) as f:
        assert len(f.read().splitlines()) == N
    with open(os.path.join(data, f"traj_density{d}.txt")) as f:
        assert len(f.read().splitlines()) == N * d - d + 1
    reader = RPGEventDense(_cfg(frag), None, 1.0)
    poses = scene.loop_poses(params)
    for k in range(len(reader)):
        f = reader[k]
        img = reader[(k // d) * d]
        assert np.array_equal(f.color, img.color) and np.array_equal(f.depth, img.depth), k
        assert np.allclose(f.c2w, scene.raw_traj(scene.raw_traj(poses[k % (P * d)])),
                           atol=1e-6), k


def test_lens_gives_back_the_pinhole_view(tmp_path):
    """At the RPG camera's size and lens, the reader's undistortion of a
    scene rendered through the lens against the pinhole scene, 8 px in from
    the border (where the lens has no pixel): colour within 1 grey level on
    average, since the reader resamples an 8-bit image bilinearly at 1/32 px,
    which costs a fraction of a level on smooth texture and more on its
    edges (the lens left in reads 4.3 levels, the pinhole one pixel off
    3.1); events within a fifth of their mean magnitude, for the same
    resampling of a difference of two such images. Depth is left as the
    sensor records it, at the lens's rays, so it is not compared."""
    from evennicer_slam_tpu_torch.data.datasets import get_dataset

    f = 196.71854278974607
    base = {"H": 260, "W": 346, "fx": f, "fy": f, "bound": [[-7.0, 9.4], [-6.5, 3.6], [-9.2, 9.5]],
            "margin": 0.02, "loop_frames": 5, "frames": 2, "amplitude": 0.3, "event_gain": 20.0,
            "layout": "rpg_event_dense"}
    read = {}
    for name, lens in (("pinhole", {}), ("lens", {"distortion": RPG_DIST})):
        cfg = {"cam": dict(png_depth_scale=1000.0, **lens), "data": {"density": 2}}
        frag = scene.write_scene(str(tmp_path), scene.recorded(base, cfg), torch.device("cpu"))
        read[name] = get_dataset(_cfg(frag), None, 1.0)[1]
    e = 8
    pin, lens = read["pinhole"], read["lens"]
    gap = np.abs(pin.color - lens.color)[e:-e, e:-e] * 255
    assert gap.mean() < 1.0, gap.mean()
    ev_gap = np.abs(pin.event - lens.event)[e:-e, e:-e].mean()
    assert ev_gap < 0.2 * np.abs(pin.event)[e:-e, e:-e].mean(), ev_gap


def test_first_cells_are_unchanged():
    """``nice.event_k5`` and ``imap.rgbd``: the scene key and the merged
    configuration of the benchmark's first version (``golden_run_config.json``,
    written by it), so that their scene, files and run are as they were."""
    import json

    from portbench import cells, harness

    with open(os.path.join(os.path.dirname(__file__), "golden_run_config.json")) as f:
        golden = json.load(f)
    bench = cells.load_benchmark()
    for name, want in golden.items():
        w = cells.workload(bench, name)
        tr = cells.traffic(w["traffic"])
        config = cells.config(bench, w["config"])
        params = scene.recorded(tr["scene"], harness.mix_config(config, tr))
        assert params == tr["scene"], name
        frag = scene.scene_fragment("SCENE", params)
        assert scene.scene_key(params) == want["scene_key"], name
        cfg = harness.run_config(config, tr, frag, "OUT", 2 ** 31 + 7)
        assert json.loads(json.dumps(cfg)) == want["config"], name
