"""Device slots in the port (``parallel/sharding.py``): the group plan and
the dp slots against the JAX package's ``concurrent_submeshes`` and
``pipeline_dp_sharding`` on its eight virtual CPU devices (the port's
counterpart: eight slots of the CPU), and data-parallel rays.

dp = N against dp = 1 in the port, from the same state and draws. The rays
are split with ``tensor_split``, each part rendered alone, the outputs
gathered and the gradients of the map's copies summed by autograd: only the
sums' order changes. One mapping loss (colour stage, and the depth-free
coarse term): the value within 1e-6 and every leaf's gradient within 1e-5
relative (measured: renders bit-equal, gradients 1e-7 to 1.3e-6). The
tracked frame 1 (three iterations; RGB-D, and event-only on the 64x80 event
scene) from the dp = 1 map: pose within 1e-5 (measured: equal, or 1.2e-10).
The whole first mapping call of frame 0 (12 iterations): every leaf within
1e-3 relative L2 (measured up to 2.3e-4: Adam's first steps are about
``lr * sign(g)``, so a reordered sum that flips the sign of a cancelling
gradient moves the cell by a whole step; the JAX package's own dp test,
``tests/test_pipeline_sharding.py``, allows 2e-4 absolute after its first
call for the same reason).

The port at dp = 8 against the JAX package at dp = 8 (the JAX pipeline
with ``parallel.data_parallel: 8``), the JAX pipeline's initial state and
draws handed across: each leaf's update of the first mapping call within
the relative L2 distance ``test_torch_mapper.py`` holds dp = 1 to (1e-2),
and the tracked pose within the POSE_MM of ``test_torch_pipeline.py``
(2 mm).
"""

import numpy as np
import pytest
import torch

from evennicer_slam_tpu.config import load_config as j_load_config
from evennicer_slam_tpu.config import update_recursive as j_update
from evennicer_slam_tpu.parallel.sharding import concurrent_submeshes, pipeline_dp_sharding
from evennicer_slam_tpu.slam.pipeline import EvenNICERSLAM as JaxSLAM
from evennicer_slam_tpu_torch.parallel.sharding import (
    concurrent_groups,
    gather_rows,
    pipeline_dp_devices,
    shard_rows,
)
from evennicer_slam_tpu_torch.slam import mapper as tm
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils.optim import tree_leaves, tree_map
from torch_parity import cap_threads, jax_to_np
from torch_pipeline_parity import mm_apart, port_pipeline, tiny_cfg

cap_threads()
SLOTS = ["cpu"] * 8
DP_RTOL = 1e-5
CALL_REL = 1e-3
LEAF_UPDATE_REL = 1e-2  # test_torch_mapper.py's band for a whole call
POSE_MM = 2.0           # test_torch_pipeline.py's band for a tracked frame


@pytest.mark.parametrize("cfg", [
    {"sync_method": "loose", "parallel": {"map_devices": 2}},
    {"sync_method": "free", "parallel": {"map_devices": "auto"}},
    {"sync_method": "loose", "parallel": {"map_devices": 1}},
    {"sync_method": "free", "parallel": {"map_devices": 7}},
    {"sync_method": "loose", "parallel": {"map_devices": 8}},
    {"sync_method": "strict", "parallel": {"map_devices": 2}},
    {"sync_method": "loose"},
    {"sync_method": "loose", "parallel": {"map_devices": 0}},
], ids=["loose-2", "free-auto", "loose-1", "free-7", "loose-8", "strict", "no-map-devices",
        "map-devices-0"])
def test_group_plan_equals_the_jax_submeshes(cfg):
    got, want = concurrent_groups(cfg, SLOTS), concurrent_submeshes(cfg)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.n_track, got.n_map) == (want.n_track, want.n_map)
    assert (got.track_dp is None) == (want.track_dp is None)
    assert (got.map_dp is None) == (want.map_dp is None)
    if want.track_dp is not None:
        assert len(got.track_dp) == want.track_dp.mesh.devices.size
    if want.map_dp is not None:
        assert len(got.map_dp) == want.map_dp.mesh.devices.size
    assert got.track_lead == got.track[0] and got.map_lead == got.map[0]


@pytest.mark.parametrize("want", ["auto", 1, 2, 3, 8, 100])
def test_dp_slots_equal_the_jax_dp_mesh(want):
    cfg = {"parallel": {"data_parallel": want}}
    got, ref = pipeline_dp_devices(cfg, SLOTS), pipeline_dp_sharding(cfg)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert len(got) == ref.mesh.devices.size
    # on CUDA 'auto' takes every slot
    assert pipeline_dp_devices({"parallel": {"data_parallel": "auto"}},
                               ["cuda:0", "cuda:1"]) == [torch.device("cuda", 0),
                                                         torch.device("cuda", 1)]


def test_shard_and_gather_rows_split_unevenly_and_back():
    x = torch.arange(22.0).reshape(11, 2)
    parts = shard_rows(x, [torch.device("cpu")] * 3)
    assert [len(p) for p in parts] == [4, 4, 3]
    assert torch.equal(gather_rows(parts, torch.device("cpu")), x)


def _pipeline(tmp_path, events, dp, name=None):
    cfg = tiny_cfg(str(tmp_path / ("ev" if events else "rgbd")), 3, events,
                   parallel={"data_parallel": dp})
    cfg["data"]["output"] = str(tmp_path / (name or f"out{dp}"))
    slam = EvenNICERSLAM(cfg, device="cpu", devices=SLOTS)
    assert (slam.dp_devices is None) == (dp == 1)
    assert slam.tracker.dp == slam.mapper.dp == slam.dp_devices
    return slam


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.fixture(scope="module", params=[False, True], ids=["rgbd", "events"])
def reference(request, tmp_path_factory):
    """dp = 1: the map after frame 0's first mapping call, and frame 1
    tracked from it."""
    tmp = tmp_path_factory.mktemp("dp1")
    slam = _pipeline(tmp, request.param, 1)
    slam.step(0)
    state = {k: v.clone() for k, v in slam.grids.items()}, tree_map(torch.clone, slam.decoders)
    slam.step(1)
    return request.param, tmp, state, slam.estimate_c2w_list[1].copy(), slam.tracker.last_losses


def _loss_and_grads(slam, stage, dp):
    """One mapping loss of frame 0 (80 drawn pixels, the map as it is) and
    the gradient of every grid and decoder leaf."""
    f = slam.frame_reader[0]
    colors = torch.from_numpy(np.array(f.color))[None]
    depths = torch.from_numpy(np.array(f.depth))[None]
    fixed = torch.from_numpy(np.array(f.c2w, np.float32))[None]
    pix = torch.randint(0, slam.cam.H * slam.cam.W, (1, 80),
                        generator=torch.Generator().manual_seed(5))
    params = tree_map(lambda x: x.detach().clone().requires_grad_(),
                      (slam.grids, slam.decoders))
    coarse = stage == "coarse"
    loss = tm._map_loss((params[0], params[1], None), fixed, colors, depths, slam.mapper.bound,
                        pix, slam.m_cfg, slam.cam, slam.settings, stage, False, coarse, dp=dp)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), list(grads)


@pytest.mark.parametrize("dp", [2, 3, 8])
def test_dp_equals_dp1_for_a_mapping_call_and_a_tracked_frame(reference, dp):
    events, tmp, (grids, decoders), pose, losses = reference
    slam = _pipeline(tmp, events, dp, name=f"out{dp}")
    assert len(slam.dp_devices) == dp
    for stage in ("color", "coarse"):
        (l1, g1), (ln, gn) = (_loss_and_grads(slam, stage, d) for d in (None, slam.dp_devices))
        assert abs(ln - l1) <= 1e-6 * abs(l1), stage
        for a, b in zip(gn, g1):
            assert (a is None) == (b is None)
            if b is not None and float(b.norm()) > 0:
                assert _rel(a, b) <= DP_RTOL, stage
    slam.step(0)
    for k, want in grids.items():
        assert _rel(slam.grids[k], want) <= CALL_REL, k
    # frame 1 from the dp = 1 map, so that only the tracked frame differs
    slam.grids = {k: v.clone() for k, v in grids.items()}
    slam.decoders = tree_map(torch.clone, decoders)
    slam.step(1)
    got = slam.estimate_c2w_list[1]
    assert np.abs(got - pose).max() <= DP_RTOL * np.abs(pose).max()
    assert not slam.tracker.cfg.use_events or "event" in slam.tracker.last_losses
    for k, v in losses.items():
        np.testing.assert_allclose(slam.tracker.last_losses[k].numpy(), v.numpy(),
                                   rtol=DP_RTOL, atol=1e-6, err_msg=k)


def test_port_dp8_follows_the_jax_package_at_dp8(tmp_path):
    cfg = tiny_cfg(str(tmp_path / "scene"), 3, False, j_load_config, j_update,
                   parallel={"data_parallel": 8})
    cfg["data"]["output"] = str(tmp_path / "jax")
    jslam = JaxSLAM(cfg, nice=True)
    assert jslam.dp_sharding is not None and jslam.dp_sharding.mesh.devices.size == 8
    state = tuple(jax_to_np(x) for x in (jslam.grids, jslam.decoders, jslam.eventnet))
    port = port_pipeline(str(tmp_path), "port", 3, False, state, devices=SLOTS,
                         parallel={"data_parallel": 8})
    assert len(port.dp_devices) == 8
    before = {k: np.asarray(v) for k, v in state[0].items()}
    jslam.step(0)
    port.step(0)
    for k, b in before.items():
        want = np.asarray(jslam.grids[k]) - b
        got = port.grids[k].numpy() - b
        assert np.linalg.norm(got - want) <= LEAF_UPDATE_REL * np.linalg.norm(want), k
    jslam.step(1)
    port.step(1)
    apart = mm_apart(port.estimate_c2w_list[:2], jslam.estimate_c2w_list[:2])
    assert apart[0] == 0.0 and apart[1] <= POSE_MM, apart
