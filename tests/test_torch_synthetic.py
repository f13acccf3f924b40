"""The port's in-memory synthetic scene (``data/synthetic.py``, numpy only)
against the JAX package's: the analytic renderer, the trajectory and the
furniture are equal copies (exact), and the frames ``synthetic_frames`` yields
equal what the JAX package's Replica-event reader returns for the dataset its
``make_synthetic_replica`` writes to disk — colour, depth and events at the
reader's own quantisation (exact), poses to 1e-7 (the reader parses them from
nine decimals of text)."""

import numpy as np
import pytest

from evennicer_slam_tpu_torch.data import synthetic as ts

from torch_parity import cap_threads

cap_threads()
BOUND = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)


@pytest.fixture(scope="module")
def js():
    """The JAX package's module; it needs cv2 to be imported at all."""
    pytest.importorskip("cv2", reason="the JAX package's synthetic module imports cv2")
    from evennicer_slam_tpu.data import synthetic

    return synthetic


def _tree_equal(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_scene_primitives_are_an_equal_copy(js):
    for bound in (BOUND, np.array([[-2.0, 2.0], [-1.6, 1.6], [-1.2, 1.2]], np.float32)):
        got, want = ts.scene_primitives(bound), js.scene_primitives(bound)
        assert len(got) == 15
        _tree_equal(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(n=5, step=None),
    dict(n=6, step=0.05, jitter=0.01, jitter_seed=3),
    dict(n=4, step=0.02, gaze_mult=3.0, pitch_base=-0.2, pitch_amp=0.9, pitch_freq=2.0,
         radius=0.2, height_amp=0.1),
])
def test_circular_trajectory(js, kwargs):
    kwargs = dict(kwargs)
    n = kwargs.pop("n")
    center = BOUND.mean(axis=1)
    got = ts.circular_trajectory(n, center, **kwargs)
    want = js.circular_trajectory(n, center, **kwargs)
    assert got.shape == (n, 4, 4) and got.dtype == want.dtype
    assert np.array_equal(got, want)
    rot = got[:, :3, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)


@pytest.mark.parametrize("furnished", [False, True])
def test_render_box_views(js, furnished):
    H, W, fx = 30, 44, 28.0
    poses = ts.circular_trajectory(3, BOUND.mean(axis=1), step=0.4)
    prims_t = ts.scene_primitives(BOUND) if furnished else None
    prims_j = js.scene_primitives(BOUND) if furnished else None
    seen = 0
    for c2w in poses:
        got = ts.render_box_views(c2w, H, W, fx, fx, (W - 1) / 2, (H - 1) / 2, BOUND, prims_t)
        want = js.render_box_views(c2w, H, W, fx, fx, (W - 1) / 2, (H - 1) / 2, BOUND, prims_j)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
        color, depth = got
        assert color.shape == (H, W, 3) and depth.shape == (H, W)
        assert 0.0 <= color.min() and color.max() <= 1.0 and depth.min() > 0
        if furnished:
            bare = ts.render_box_views(c2w, H, W, fx, fx, (W - 1) / 2, (H - 1) / 2, BOUND)
            seen += int((bare[1] != depth).sum())
    assert not furnished or seen > 0  # the furniture occludes something


def test_look_at_and_wall_texture(js):
    eye, target = np.array([0.1, -0.2, 0.3]), np.array([1.0, 0.5, -0.4])
    assert np.array_equal(ts._look_at(eye, target), js._look_at(eye, target))
    up = ts._look_at(eye, eye + np.array([0.0, 0.0, 2.0]))  # straight up: the other up vector
    assert np.array_equal(up, js._look_at(eye, eye + np.array([0.0, 0.0, 2.0])))
    u, v = np.linspace(0, 1, 7), np.linspace(1, 0, 7)
    for face in range(6):
        assert np.array_equal(ts._wall_texture(u, v, face), js._wall_texture(u, v, face))


@pytest.mark.parametrize("furnished,jitter", [(False, 0.0), (True, 0.004)])
def test_frames_equal_the_dataset_round_trip(js, tmp_path, furnished, jitter):
    """Three 24x40 frames: written by the JAX package, read back by its
    Replica-event reader, against the port's frames made in memory."""
    from evennicer_slam_tpu.data.datasets import ReplicaEvent

    kw = dict(n_frames=3, H=24, W=40, fx=30.0, fy=30.0, bound=BOUND, event_gain=20.0,
              traj_step=0.06, traj_jitter=jitter, traj_seed=5, furnished=furnished)
    frag = js.make_synthetic_replica(str(tmp_path), **kw)
    reader = ReplicaEvent({"dataset": "replica_event", **frag})
    frames = list(ts.synthetic_frames(**kw))
    assert len(reader) == len(frames) == 3
    for k, got in enumerate(frames):
        want = reader[k]
        assert got.index == want.index == k
        for name in ("color", "depth", "event", "event_mask"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert np.array_equal(g, w), (k, name)
        np.testing.assert_allclose(got.c2w, np.asarray(want.c2w), atol=1e-7, rtol=0)
        assert got.c2w.dtype == np.float32 and got.c2w.shape == (4, 4)
    assert frames[0].event.sum() == 0 and frames[1].event.sum() > 0
    assert frames[1].event.shape == (24, 40, 2) and frames[1].event_mask.max() == 1
    # polarity order [-, +]: brightness that rose fires the second channel only
    assert not np.any((frames[1].event[..., 0] > 0) & (frames[1].event[..., 1] > 0))


def test_default_frames_need_no_arguments_and_no_cv2():
    import sys

    fr = next(iter(ts.synthetic_frames(n_frames=1, H=12, W=20)))
    assert fr.color.shape == (12, 20, 3) and fr.c2w.shape == (4, 4)
    src = open(ts.__file__).read()
    assert "cv2" not in src and "import os" not in src
    assert "evennicer_slam_tpu_torch.data.synthetic" in sys.modules
