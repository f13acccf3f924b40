"""The keyframe registry of the port (``slam/keyframes.py``) against the JAX
package's on the CPU: the same numpy inputs, and the JAX package's random
draws handed in where the port draws on the device.

Tolerances. Host selection (overlap scorer, ``random_select``) makes the same
numpy generator calls: equal lists, exactly. The device frustum masks are
held to ``_frustum_mask_trace`` exactly (same float32 arithmetic); the host
mask (numpy bilinear remap) to the cv2 one with at most 0.5 % of the voxels
different (cv2 interpolates with 5-bit fixed-point weights; none differed on
these inputs). Window assembly: indices, images, poses and ``opt_mask``
exactly, camera 7-vectors at atol 1e-6; the BA write-back at atol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.core import quaternion as jq
from evennicer_slam_tpu.slam import keyframes as jk
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.core import quaternion as tq
from evennicer_slam_tpu_torch.slam import keyframes as tk
from evennicer_slam_tpu_torch.slam.camera import Camera

from torch_parity import assert_close, cap_threads, t

cap_threads()
CAM = (48, 64, 40.0, 40.0, 31.5, 23.5)
BOUND = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)


def _pose(angle, t_xyz):
    """Rotation about y by ``angle`` (the camera looks along -z rotated)."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = t_xyz
    return m


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    return [_pose(rng.uniform(-0.6, 0.6) + (np.pi if i % 4 == 3 else 0.0),
                  rng.uniform(-0.2, 0.2, 3)) for i in range(n)]


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    H, W = CAM[:2]
    cols = rng.random((n, H, W, 3)).astype(np.float32)
    deps = rng.uniform(0.5, 1.8, (n, H, W)).astype(np.float32)
    deps[:, :, :5] = 0.0  # pixels without a depth reading
    return cols, deps


def _frames(poses):
    cols, deps = _images(len(poses))
    return [{"idx": i, "color": cols[i], "depth": deps[i],
             "event": np.zeros(deps[i].shape + (2,), np.float32),
             "est_c2w": p, "gt_c2w": p} for i, p in enumerate(poses)]


# ---- the numpy pose twins ----------------------------------------------------------

def test_numpy_quaternion_twins_equal_the_jax_packages():
    for p in _poses(12, seed=3):
        q_t, q_j = tq.tensor_from_pose_matrix_np(p[:3]), jq.tensor_from_pose_matrix_np(p[:3])
        np.testing.assert_array_equal(q_t, q_j)
        np.testing.assert_array_equal(tq.tensor_from_pose_matrix_np(p[:3], t_first=True),
                                      jq.tensor_from_pose_matrix_np(p[:3], t_first=True))
        np.testing.assert_array_equal(tq.pose_matrix_from_tensor_np(q_t),
                                      jq.pose_matrix_from_tensor_np(q_j))
        np.testing.assert_allclose(tq.pose_matrix_from_tensor_np(q_t), p[:3], atol=1e-6)


# ---- host selection ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_selection_matches_exactly(seed):
    poses = _poses(7, seed=seed)
    frames = _frames(poses)
    cur = _pose(0.1, [0.05, 0.0, 0.1])
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for k in (1, 3, 6):
        got = tk.keyframe_selection_overlap(frames[-1]["color"], frames[-1]["depth"], cur,
                                            frames[:-1], k, Camera(*CAM), rng=rng_t)
        want = jk.keyframe_selection_overlap(frames[-1]["color"], frames[-1]["depth"], cur,
                                             frames[:-1], k, JCamera(*CAM), rng=rng_j)
        assert [int(x) for x in got] == [int(x) for x in want]
        assert len(got) <= k
    # the candidates looking the other way (every 4th) overlap nowhere
    assert 3 not in got
    assert rng_t.integers(1 << 30) == rng_j.integers(1 << 30)


def test_random_select_matches_exactly():
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    for n, k in ((0, 3), (1, 3), (4, 3), (9, 3), (9, 20)):
        got = tk.random_select(n, k, rng_t)
        assert [int(x) for x in got] == [int(x) for x in jk.random_select(n, k, rng_j)]
        assert len(set(got)) == len(got) == min(n, k)


# ---- frustum masks ---------------------------------------------------------------------

SHAPES = [(3, 4, 5), (5, 6, 7), (11, 13, 16)]


def _frustum_inputs(seed):
    rng = np.random.default_rng(seed)
    c2w = _pose(rng.uniform(0, 2 * np.pi), rng.uniform(-0.4, 0.4, 3))
    depth = (0.4 + 1.4 * rng.random(CAM[:2])).astype(np.float32)
    depth[:, :6] = 0.0  # a zero-depth stripe exercises the max-fill rule
    return c2w, depth


@pytest.mark.parametrize("seed", range(6))
def test_device_frustum_masks_equal_the_jax_trace(seed):
    c2w, depth = _frustum_inputs(seed)
    got = tk.frustum_feature_masks(t(c2w), SHAPES, t(depth), BOUND, Camera(*CAM))
    want = jk.frustum_feature_masks_dev(jnp.asarray(c2w), SHAPES, jnp.asarray(depth), BOUND,
                                        JCamera(*CAM))
    assert len(got) == len(SHAPES)
    for g, w, shape in zip(got, want, SHAPES):
        assert tuple(g.shape) == shape + (1,) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any(bool(g.any()) and not bool(g.all()) for g in got)


def test_host_frustum_mask_against_cv2():
    """The numpy remap against cv2.remap: at most 0.5 % of the voxels may
    differ (fixed-point weights); also against the port's device version."""
    n_diff = n_dev = n_all = 0
    for seed in range(6):
        c2w, depth = _frustum_inputs(seed)
        dev = tk.frustum_feature_masks(t(c2w), SHAPES, t(depth), BOUND, Camera(*CAM))
        for shape, d in zip(SHAPES, dev):
            got = tk.frustum_feature_mask(c2w, shape, depth, BOUND, Camera(*CAM))
            want = jk.frustum_feature_mask(c2w, shape, depth, BOUND, JCamera(*CAM))
            assert got.shape == want.shape == shape and got.dtype == bool
            n_diff += int((got != want).sum())
            n_dev += int((got != d[..., 0].numpy().astype(bool)).sum())
            n_all += got.size
    assert n_diff <= 0.005 * n_all, (n_diff, n_all)
    assert n_dev <= 0.02 * n_all, (n_dev, n_all)


def test_remap_zero_border():
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    u = np.array([0.0, 1.5, 3.0, 3.5, -0.5, 1e30], np.float32)
    v = np.array([0.0, 0.5, 2.0, 0.0, 1.0, 1.0], np.float32)
    got = tk.remap_bilinear_zero_border(img, u, v)
    np.testing.assert_allclose(got, [0.0, 3.5, 11.0, 1.5, 2.0, 0.0], atol=1e-6)


# ---- device selection, assembly and write-back ------------------------------------

def _device_store_inputs(n):
    poses = np.stack(_poses(n, seed=4))
    cols, deps = _images(n + 1, seed=6)
    cur = _pose(0.05, [0.02, 0.01, 0.05])
    return poses, cols[:n], deps[:n], cols[n], deps[n], cur


@pytest.mark.parametrize("n,k_sel", [(3, 1), (6, 3)])
def test_select_assemble_window_matches_jax(n, k_sel):
    poses, cols, deps, cur_col, cur_dep, cur = _device_store_inputs(n)
    key = jax.random.PRNGKey(11 + n)
    want = jk.select_assemble_window_dev(key, jnp.asarray(cols), jnp.asarray(deps),
                                         jnp.asarray(poses), jnp.asarray(cur_col),
                                         jnp.asarray(cur_dep), jnp.asarray(cur), k_sel,
                                         JCamera(*CAM))
    # the JAX package's draws, handed to the port
    k_pix, k_pri = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_pix, (100,), 0, CAM[0] * CAM[1]))
    pri = np.asarray(jax.random.uniform(k_pri, (n - 1,)))
    got = tk.select_assemble_window(t(cols), t(deps), t(poses), t(cur_col), t(cur_dep), t(cur),
                                    k_sel, Camera(*CAM), pixel_idx=torch.from_numpy(idx.astype(np.int64)),
                                    priorities=t(pri))
    colors, depths, fixed, cams, window_idx, opt_mask = got
    np.testing.assert_array_equal(window_idx.numpy(), np.asarray(want[4]))
    for g, w in zip((colors, depths, fixed, opt_mask), (want[0], want[1], want[2], want[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_close(cams, want[3], atol=1e-6)
    assert tuple(colors.shape) == (k_sel + 2,) + cols.shape[1:]
    assert int(window_idx[-1]) == n - 1 and float(opt_mask.sum()) == k_sel + 1
    assert float(opt_mask[int(torch.argmin(window_idx))]) == 0.0


def test_scatter_window_poses_matches_jax():
    poses = np.stack(_poses(5, seed=8))
    window_idx = np.array([2, 1, 4], np.int64)
    cur = _pose(0.3, [0.0, 0.5, 1.0])
    fixed = np.concatenate([poses[window_idx], cur[None]], axis=0)
    opt_mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    new_cams = np.stack([jq.tensor_from_pose_matrix_np(_pose(0.1 * i, [9.0 + i, 0, 0])[:3])
                         for i in range(4)])
    want = jk.scatter_window_poses_dev(jnp.asarray(poses), jnp.asarray(window_idx, jnp.int32),
                                       jnp.asarray(new_cams), jnp.asarray(fixed),
                                       jnp.asarray(opt_mask))
    got = tk.scatter_window_poses(t(poses), torch.from_numpy(window_idx), t(new_cams), t(fixed),
                                  t(opt_mask))
    assert_close(got[0], want[0], atol=1e-6)
    assert_close(got[1], want[1], atol=1e-6)
    np.testing.assert_array_equal(got[0][1].numpy(), poses[1])  # the anchor keeps its pose
    np.testing.assert_array_equal(got[0][[0, 3]].numpy(), poses[[0, 3]])
    assert_close(got[1][3], [0.0, 0.0, 0.0, 1.0], atol=0.0)


# ---- the registry's semantics --------------------------------------------------------------

def _store(n):
    store = tk.KeyframeStore(device="cpu")
    for f in _frames([_pose(0.0, [0.1 * i, 0.0, 1.0]) for i in range(n)]):
        store.append(f["idx"], f["color"], f["depth"], f["event"], f["est_c2w"], f["gt_c2w"])
    return store


def test_store_append_preserves_device_updates_and_sync():
    store = _store(3)
    cols, _, kf_poses = store.device_stack()
    assert tuple(cols.shape) == (3,) + CAM[:2] + (3,) and store.indices == [0, 1, 2]
    updated = kf_poses.clone()
    updated[1, 0, 3] = 5.0
    store.set_poses_device(updated)
    assert store.host_poses_stale
    assert store.frames[1]["est_c2w"][0, 3] != 5.0  # stale until synced
    f0 = store.frames[0]
    store.append(3, f0["color"], f0["depth"], f0["event"], _pose(0.0, [9, 9, 9]),
                 _pose(0.0, [9, 9, 9]))
    cols, deps, stacked = store.device_stack()
    assert cols.shape[0] == 4 and deps.shape[0] == 4 and not store._device_cache
    assert float(stacked[1, 0, 3]) == 5.0
    assert_close(stacked[3][:3, 3], [9, 9, 9], atol=0.0)
    # folded frames are served as views of the stack
    c2, _ = store.device_images(2)
    assert c2.data_ptr() == cols[2].data_ptr()
    store.sync_host_poses()
    assert not store.host_poses_stale and store.frames[1]["est_c2w"][0, 3] == 5.0


def test_store_set_pose_needs_fresh_rows_and_rebuilds_from_host():
    store = _store(2)
    _, _, kf_poses = store.device_stack()
    updated = kf_poses.clone()
    updated[0, 1, 3] = 7.0
    store.set_poses_device(updated)
    with pytest.raises(AssertionError, match="sync_host_poses"):
        store.set_pose(0, _pose(0.0, [3, 3, 3]))
    store.sync_host_poses()
    store.set_pose(0, _pose(0.0, [3, 3, 3]))
    _, _, stacked = store.device_stack()
    assert_close(stacked[0][:3, 3], [3, 3, 3], atol=0.0)
    assert float(stacked[1, 0, 3]) == store.frames[1]["est_c2w"][0, 3]


def test_store_appends_a_device_pose_without_reading_it():
    store = _store(2)
    dev_pose = t(_pose(0.2, [0.5, 0.5, 0.5]))
    f0 = store.frames[0]
    store.append(7, f0["color"], f0["depth"], f0["event"], dev_pose, np.eye(4, dtype=np.float32),
                 device_images=(t(f0["color"]), t(f0["depth"])))
    assert store.host_poses_stale
    np.testing.assert_array_equal(store.frames[2]["est_c2w"], np.eye(4))  # placeholder
    _, _, stacked = store.device_stack()
    assert_close(stacked[2], dev_pose, atol=0.0)
    store.sync_host_poses()
    np.testing.assert_array_equal(store.frames[2]["est_c2w"], dev_pose.numpy())


def test_store_carries_across_from_the_jax_package():
    jstore = jk.KeyframeStore()
    for f in _frames(_poses(3, seed=2)):
        jstore.append(f["idx"], f["color"], f["depth"], f["event"], f["est_c2w"], f["gt_c2w"])
    got = convert.keyframe_store_from_numpy(jstore.frames, device="cpu")
    assert got.indices == jstore.indices and not got.host_poses_stale
    _, _, jposes = jstore.device_stack()
    cols, deps, poses = got.device_stack()
    np.testing.assert_array_equal(poses.numpy(), np.asarray(jposes))
    np.testing.assert_array_equal(cols.numpy(), np.stack([f["color"] for f in jstore.frames]))
    stale = convert.keyframe_store_from_numpy(jstore.frames, poses=np.asarray(jposes) * 2,
                                              device="cpu")
    assert stale.host_poses_stale
    np.testing.assert_array_equal(stale.device_stack()[2].numpy(), np.asarray(jposes) * 2)


def test_store_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: device=None is allowed to run")
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.KeyframeStore()
