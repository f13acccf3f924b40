"""The port's ``EvenNICERSLAM(nice=False)`` (iMAP) against the JAX package's
on an RGB-D scene read from disk (36x48, five frames), configured as
``tests/test_slam.py::test_imap_mode`` configures it (the set-up is
``torch_pipeline_parity.py``: its ``IMAP`` over ``tiny_cfg``): no grids,
the single MLP, 32 + 12 samples with density compositing and the free-space
regulation, the first mapping call 12 iterations, then three calls of
``iters // 3`` iterations every second frame, no final colour refinement.

The JAX pipeline runs once, ``run(mesh=False)`` with a checkpoint every
second frame; the port starts from its initial state with its tracker and
mapper draws and runs the same schedule. Per frame the tracked position
within POSE_MM of the JAX pipeline's (measured: see ``POSE_MM``); the
schedule's state equal; a checkpoint of each package in the JAX package's
key layout, and the port's restored bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
from torch_parity import cap_threads
from torch_pipeline_parity import (
    IMAP,
    mm_apart,
    port_pipeline,
    read_records,
    run_jax,
    tiny_cfg,
)

cap_threads()

N_FRAMES = 5
# measured 0, 0.17, 0.49, 1.01, 2.60 mm over frames 0-4: the closed loops part
# as the NICE pipeline's do (test_torch_pipeline.py), the iMAP MLP's Adam
# steps more so (test_torch_imap_mapping.py). Steady calls made as one call
# of ``iters`` iterations (NICE's schedule) read 4.39 and 12.46 mm at frames
# 3 and 4. A skipped or stale steady call does not leave the band (2.15 and
# 2.51 mm): six iterations at the steady rate move this random map less than
# the rounding does.
POSE_MM = 5.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("imap_pipeline"))
    jax_run = run_jax(tmp, N_FRAMES, events=False, nice=False, **IMAP)
    port = port_pipeline(tmp, "port", N_FRAMES, False, jax_run["state"], nice=False, **IMAP)
    est = port.run(mesh=False).copy()
    return {"tmp": tmp, "jax": jax_run, "port": port, "port_est": est}


def test_imap_poses_follow_the_jax_pipeline(runs):
    j, est = runs["jax"], runs["port_est"]
    assert j["state"][0] == {} and set(j["state"][1]) == {"imap"}
    apart = mm_apart(est, j["est"])
    assert apart[0] == 0.0
    assert apart.max() <= POSE_MM, apart
    # and the trajectory moved: the tracker ran on the fitted map
    assert np.abs(est[1:, :3, 3] - est[0, :3, 3]).max() > 1e-3


def test_a_nice_steady_schedule_leaves_the_band(runs):
    """Planted fault: every steady call made as one call of ``iters``
    iterations instead of three of ``iters // 3``."""
    port = port_pipeline(runs["tmp"], "fault", N_FRAMES, False, runs["jax"]["state"],
                         nice=False, **IMAP)
    port.nice = True  # the schedule reads it; the models stay iMAP's
    apart = mm_apart(port.run(mesh=False, checkpoint=False), runs["jax"]["est"])
    assert apart.max() > POSE_MM, apart


def test_imap_schedule_state_matches(runs):
    j, p = runs["jax"]["slam"], runs["port"]
    assert p.grids == {} and set(p.decoders) == {"imap"}
    assert not p.tracker.settings.fused_decode and not p.settings.nice
    assert p.mapper.keyframes.indices == j.mapper.keyframes.indices == [0, 2, 4]
    # frames 0, 2 and 4 mapped, no colour refinement at the last frame
    assert (p.mapping_idx, p.mapping_cnt, p.n_fast_maps) == (
        j.mapping_idx, j.mapping_cnt, j.n_fast_maps) == (4, 3, 2)
    recs_p, recs_j = read_records(p.output), runs["jax"]["records"]
    assert [sorted(r) for r in recs_p] == [sorted(r) for r in recs_j]


def test_imap_checkpoint_round_trips_bit_for_bit(runs):
    """Each package's checkpoint of frame 4 holds the same keys (no grids,
    ``decoders.imap.*``); the port's restores into a fresh port pipeline bit
    for bit, and the JAX package's restores to the JAX run's decoders."""
    port, tmp = runs["port"], runs["tmp"]
    ckpt_p = os.path.join(port.output, "ckpts", "00004.npz")
    ckpt_j = os.path.join(runs["jax"]["slam"].output, "ckpts", "00004.npz")
    with np.load(ckpt_p) as a, np.load(ckpt_j) as b:
        assert sorted(a.files) == sorted(b.files)
        assert not any(k.startswith("grids") for k in a.files)
        assert "decoders.imap.lin_w[3]" in a.files
    cfg = tiny_cfg(os.path.join(tmp, "scene"), N_FRAMES, False, **IMAP)
    cfg["data"]["output"] = os.path.join(tmp, "restored")
    for path, want_dec, want_est in (
            (ckpt_p, port.decoders, port.estimate_c2w_list),
            (ckpt_j, runs["jax"]["slam"].decoders, runs["jax"]["est"])):
        fresh = EvenNICERSLAM(cfg, nice=False, device="cpu")
        assert CheckpointLogger.restore(fresh, path) == N_FRAMES
        assert fresh.grids == {}
        for name, leaf in fresh.decoders["imap"].items():
            want = want_dec["imap"][name]
            for a, b in (zip(leaf, want) if isinstance(leaf, list) else [(leaf, want)]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(fresh.estimate_c2w_list, want_est)
        assert fresh.mapper.keyframes.indices == [0, 2, 4]


def test_the_port_pipeline_refuses_no_imap_option(tmp_path):
    """iMAP's shipped mesh colours and the steady schedule need no option:
    a pipeline built with ``render_ray_along_normal`` steps three frames."""
    cfg = tiny_cfg(str(tmp_path / "scene"), 3, False, **IMAP)
    cfg["meshing"]["color_mesh_extraction_method"] = "render_ray_along_normal"
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, nice=False, device="cpu")
    for idx in range(3):
        slam.step(idx)
    assert torch.isfinite(torch.from_numpy(slam.estimate_c2w_list[:3])).all()
    assert slam.mapping_cnt == 2
