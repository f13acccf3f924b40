"""The concurrent loose / free schedule of the port's pipeline
(``slam/pipeline.py``) on eight CPU slots, the counterpart of the JAX
package's eight virtual CPU devices: the invariants of
``tests/test_concurrent.py``, and one trajectory against the JAX package's.

On the CPU a mapping call has completed when it returns, so the port's
probe is always ready and its schedule does not depend on timing. The JAX
package's does (asynchronous dispatch); the comparison makes it
deterministic by patching the JAX test object's ``_adopt_pending_map`` to
block on every call (the non-blocking one at the start of a frame
included), so that both adopt every call at the first chance: the mapping
calls land on the same frames, each frame is tracked on the same adopted
map, and the poses stay within the closed-loop band of
``test_torch_pipeline.py`` (POSE_MM, 2 mm), the JAX pipeline's initial
state and draws handed across.
"""

import numpy as np
import pytest
import torch

from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.config import update_recursive as j_update
from evennicer_slam_tpu.slam.pipeline import EvenNICERSLAM as JaxSLAM
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
from evennicer_slam_tpu_torch.utils.optim import tree_leaves
from torch_parity import cap_threads, jax_to_np
from torch_pipeline_parity import mm_apart, port_pipeline, tiny_cfg

cap_threads()
SLOTS = ["cpu"] * 8
POSE_MM = 2.0


def loose_cfg(tmp, n_frames=8, events=False, map_devices=2, **overrides):
    cfg = tiny_cfg(str(tmp / "scene"), n_frames, events, sync_method="loose",
                   parallel={"map_devices": map_devices}, **overrides)
    cfg["data"]["output"] = str(tmp / "out")
    return cfg


def spy_dispatch(slam):
    """Record the frame of every mapping call (colour refinement aside)."""
    seen = []
    orig = slam._map_frame

    def spy(idx, *a, **kw):
        if not kw.get("color_refine"):
            seen.append(idx)
        return orig(idx, *a, **kw)

    slam._map_frame = spy
    return seen


@pytest.fixture(scope="module")
def loose(tmp_path_factory):
    """Loose over eight frames, two slots mapping, colour refinement off."""
    tmp = tmp_path_factory.mktemp("loose")
    slam = EvenNICERSLAM(loose_cfg(tmp, mapping={"color_refine": False}), device="cpu",
                         devices=SLOTS)
    dispatched = spy_dispatch(slam)
    est = slam.run(mesh=False, checkpoint=False).copy()
    return slam, est, dispatched


def test_loose_runs_and_tracks(loose):
    slam, est, _ = loose
    assert slam.concurrent and slam.groups.n_track == 6 and slam.groups.n_map == 2
    assert slam.tracker.dp == slam.groups.track and slam.mapper.dp == slam.groups.map
    n = slam.n_img
    assert np.isfinite(est[:n]).all()
    err = np.linalg.norm(est[:n, :3, 3] - slam.gt_c2w_list[:n, :3, 3], axis=-1)
    assert err.max() < 0.5
    # the scene state on the map group's lead, the snapshot on the track group's
    assert all(x.device == slam.groups.map_lead for x in tree_leaves(slam.grids))
    assert all(x.device == slam.groups.track_lead for x in tree_leaves(slam._track_grids))
    assert slam.mapper.keyframes.device == slam.groups.map_lead
    assert slam.n_concurrent_maps >= 3


def test_loose_lag_bound(loose):
    slam, _, _ = loose
    every = slam.m_cfg.every_frame
    assert [i for i, _ in slam.lag_trace] == list(range(1, slam.n_img))
    for idx, adopted in slam.lag_trace:
        assert idx - every - every // 2 <= adopted <= idx


def test_loose_mapper_cadence(loose):
    slam, _, dispatched = loose
    assert (np.diff(dispatched) >= max(1, slam.m_cfg.every_frame // 2)).all()
    assert dispatched[0] == 0 and dispatched[-1] == slam.n_img - 1
    assert slam.n_concurrent_maps == len(dispatched)


def test_final_snapshot_equals_the_mappers_state(loose):
    """With colour refinement off the last adoption leaves the tracker's
    snapshot equal to the mapper's final grids (a copy, not a recompute)."""
    slam, _, _ = loose
    for k in slam.grids:
        assert torch.equal(slam._track_grids[k], slam.grids[k])


def test_free_runs(tmp_path):
    cfg = tiny_cfg(str(tmp_path / "scene"), 5, False, sync_method="free",
                   parallel={"map_devices": 2})
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, device="cpu", devices=SLOTS)
    assert slam.concurrent and slam.sync_method == "free"
    assert np.isfinite(slam.run(mesh=False, checkpoint=False)[: slam.n_img]).all()
    assert slam.n_concurrent_maps >= 2


def test_loose_with_events(tmp_path):
    """Calls off the RGB-D cadence integrate their own event window."""
    slam = EvenNICERSLAM(loose_cfg(tmp_path, n_frames=4, events=True), device="cpu",
                         devices=SLOTS)
    assert slam.use_events and slam.concurrent
    assert np.isfinite(slam.run(mesh=False, checkpoint=False)[: slam.n_img]).all()
    assert slam.n_concurrent_maps >= 3


def test_loose_resume(tmp_path):
    """Restore puts the scene state on the map group and restarts the
    adoption bookkeeping at the checkpoint's frame."""
    cfg = loose_cfg(tmp_path, n_frames=6)
    slam = EvenNICERSLAM(cfg, device="cpu", devices=SLOTS)
    for idx in range(5):
        slam.step(idx)
    path = slam.logger.log(slam, 4)
    slam2 = EvenNICERSLAM(cfg, device="cpu", devices=SLOTS)
    assert CheckpointLogger.restore(slam2, path) == 5
    assert slam2.adopted_map_idx == slam2._last_map_dispatch_idx == 4
    assert slam2._track_grids is None and slam2._pending_map is None
    for k in slam.grids:
        assert torch.equal(slam2.grids[k], slam.grids[k])
    slam2.run(start_frame=5, mesh=False, checkpoint=False)
    assert np.isfinite(slam2.estimate_c2w_list[: slam2.n_img]).all()
    assert slam2.n_concurrent_maps >= 1 and slam2._track_grids is not None


def test_loose_grown_registry_fast_path(tmp_path):
    """With more than one keyframe and overlap selection the concurrent
    calls take the device path: selection, assembly and BA write-back on the
    map group, the tracker initialised from its own poses."""
    cfg = loose_cfg(tmp_path, n_frames=12,
                    mapping={"keyframe_catchup": True, "color_refine": False})
    slam = EvenNICERSLAM(cfg, device="cpu", devices=SLOTS)
    n = slam.n_img
    for idx in range(n):
        slam.step(idx)
        slam._adopt_pending_map(block=True)
    est = slam.estimate_c2w_list
    assert np.isfinite(est[:n]).all()
    assert np.linalg.norm(est[:n, :3, 3] - slam.gt_c2w_list[:n, :3, 3], axis=-1).max() < 0.5
    assert slam.mapper.BA_active and slam.n_fast_maps >= 2
    kf = slam.mapper.keyframes
    assert kf.device_stack()[2].device == slam.groups.map_lead
    assert kf.host_poses_stale
    kf.sync_host_poses()
    assert not kf.host_poses_stale and np.isfinite(kf.frames[-1]["est_c2w"]).all()
    assert not np.allclose(kf.frames[-1]["est_c2w"], np.eye(4))
    assert set(slam._track_pose_cache) <= {n - 1, n - 2, n - 3}


def test_one_group_falls_back_to_the_strict_schedule(tmp_path):
    """Too few slots for a map group: loose runs the strict schedule, bit
    for bit."""
    runs = []
    for name, change, devices in (("strict", {}, None),
                                  ("loose", {"sync_method": "loose",
                                             "parallel": {"map_devices": 1}}, ["cpu"])):
        cfg = tiny_cfg(str(tmp_path / "scene"), 3, False, mapping={"color_refine": False},
                       **change)
        cfg["data"]["output"] = str(tmp_path / name)
        slam = EvenNICERSLAM(cfg, device="cpu", devices=devices)
        runs.append((slam, slam.run(mesh=False, checkpoint=False).copy()))
    (strict, a), (loose, b) = runs
    assert not loose.concurrent and loose.n_concurrent_maps == 0 and not loose.lag_trace
    np.testing.assert_array_equal(a, b)


def test_loose_trajectory_follows_the_jax_package(tmp_path):
    """``every_frame`` 4: loose then maps every second frame (frames 0, 2,
    4 and the last), the cadence at which the strict runs of
    ``test_torch_pipeline.py`` keep POSE_MM. With ``every_frame`` 2 loose
    maps every frame, and the two packages' closed loops part by 5.4 mm in
    six frames, as their strict schedules do when mapping every frame (7.9
    mm; 6-iteration calls from maps already apart, measured)."""
    n = 6
    over = {"sync_method": "loose", "parallel": {"map_devices": 2},
            "mapping": {"every_frame": 4}}
    cfg = tiny_cfg(str(tmp_path / "scene"), n, False, j_load_config, j_update, **over)
    cfg["data"]["output"] = str(tmp_path / "jax")
    jslam = JaxSLAM(cfg, nice=True)
    assert jslam.concurrent
    orig = jslam._adopt_pending_map
    jslam._adopt_pending_map = lambda block=False: orig(block=True)
    j_seen = spy_dispatch(jslam)
    state = tuple(jax_to_np(x) for x in (jslam.grids, jslam.decoders, jslam.eventnet))
    j_est = jslam.run(mesh=False).copy()

    port = port_pipeline(str(tmp_path), "port", n, False, state, devices=SLOTS, **over)
    assert port.concurrent
    p_seen = spy_dispatch(port)
    p_est = port.run(mesh=False)
    assert p_seen == j_seen == [0, 2, 4, 5]
    assert port.lag_trace == jslam.lag_trace
    assert port.n_concurrent_maps == jslam.n_concurrent_maps
    apart = mm_apart(p_est, j_est)
    assert apart[0] == 0.0 and apart.max() <= POSE_MM, apart
