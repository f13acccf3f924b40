"""The benchmark's scene against ``data/synthetic.py`` at a small size on
the CPU, and the loop on disk: exactly periodic, the event that closes it
included."""

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
