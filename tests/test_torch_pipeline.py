"""The port's ``EvenNICERSLAM`` (``slam/pipeline.py``) against the JAX
package's, on an RGB-D scene read from disk (36x48, six frames; the set-up
is ``torch_pipeline_parity.py``).

The JAX pipeline runs once, ``run(mesh=False)`` with a checkpoint every
second frame. The port starts from its initial state
(``convert.pipeline_state_from_numpy``) with its tracker and mapper draws,
and runs the same schedule. Per frame: the tracked position within
POSE_MM of the JAX pipeline's (measured: 0.002, 0.029, 0.061, 0.090,
1.34 mm over frames 1-5 — the closed loops part by rounding, which Adam's
first steps, ``lr * sign(g)``, turn into whole steps); the tracking losses
and the mapping loss of each metrics record within ``loss_rtol``; the keyframes,
``mapping_idx`` and ``n_fast_maps`` equal. A planted schedule fault — the
mapping call at frame 2 skipped — breaks POSE_MM (measured 2.0, 4.4, 7.1 mm
at frames 3-5), and so does a stale pose handed to the mapper — each steady
call mapping from the previous frame's pose (measured 1.6, 4.0, 4.4 mm). The port resumes from the JAX pipeline's frame-2
checkpoint and follows the JAX run's own frames 3-5 within POSE_MM. Without
the JAX package: ``step`` equals a hand-driven ``Tracker`` / ``Mapper``
loop with the same seeds, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
from torch_parity import cap_threads
from torch_pipeline_parity import (
    mm_apart,
    port_pipeline,
    read_records,
    run_jax,
    skip_mapping_at,
    stale_mapping_pose,
    tiny_cfg,
)

cap_threads()

N_FRAMES = 6
POSE_MM = 2.0


def loss_rtol(key, frame):
    """The mapping loss of a record within 5e-3 (measured 1.4e-3); the
    tracking losses within 2e-3 up to frame 2 (measured 5.4e-4), then, on the
    maps the two mapping calls at frame 2 left slightly apart, within 0.25
    (measured 0.18: a loss of a few hundred on a map fitted for 18
    iterations moves by tenths with a millimetre of pose)."""
    if key == "mapping/loss":
        return 5e-3
    return 2e-3 if frame <= 2 else 0.25


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    jax_run = run_jax(tmp, N_FRAMES, events=False)
    port = port_pipeline(tmp, "port", N_FRAMES, False, jax_run["state"])
    est = port.run(mesh=False).copy()
    return {"tmp": tmp, "jax": jax_run, "port": port, "port_est": est}


def test_poses_follow_the_jax_pipeline(runs):
    j, est = runs["jax"], runs["port_est"]
    apart = mm_apart(est, j["est"])
    assert apart[0] == 0.0
    assert apart.max() <= POSE_MM, apart
    np.testing.assert_array_equal(runs["port"].gt_c2w_list, j["slam"].gt_c2w_list)


def test_schedule_state_matches(runs):
    j, p = runs["jax"]["slam"], runs["port"]
    assert p.mapper.keyframes.indices == j.mapper.keyframes.indices == [0, 2, 4]
    assert (p.mapping_idx, p.mapping_cnt, p.n_fast_maps) == (
        j.mapping_idx, j.mapping_cnt, j.n_fast_maps)
    assert p.n_fast_maps == 2  # frames 2 and 4 took the device pose


def test_metrics_records_match(runs):
    j_recs = runs["jax"]["records"]
    p_recs = read_records(runs["port"].output)
    assert [r["frame"] for r in p_recs] == [r["frame"] for r in j_recs] == list(range(N_FRAMES))
    for a, b in zip(p_recs, j_recs):
        assert set(a) == set(b), (a["frame"], set(a) ^ set(b))
        for k in a:
            if k in ("t", "frame"):
                continue
            np.testing.assert_allclose(a[k], b[k], rtol=loss_rtol(k, a["frame"]),
                                       err_msg=f"{k} {a['frame']}")


def test_a_skipped_mapping_call_breaks_the_limit(runs):
    port = port_pipeline(runs["tmp"], "skip", N_FRAMES, False, runs["jax"]["state"])
    skip_mapping_at(port, 2)
    apart = mm_apart(port.run(mesh=False), runs["jax"]["est"])
    assert apart.max() > POSE_MM, apart


def test_a_stale_mapping_pose_breaks_the_limit(runs):
    port = port_pipeline(runs["tmp"], "stale", N_FRAMES, False, runs["jax"]["state"])
    stale_mapping_pose(port)
    apart = mm_apart(port.run(mesh=False), runs["jax"]["est"])
    assert apart.max() > POSE_MM, apart


def test_resume_from_the_jax_checkpoint(runs):
    j = runs["jax"]["slam"]
    port = port_pipeline(runs["tmp"], "resume", N_FRAMES, False, runs["jax"]["state"])
    start = CheckpointLogger.restore(port, f"{j.output}/ckpts/00002.npz")
    assert start == 3 and port.mapper.keyframes.indices == [0, 2]
    est = port.run(start_frame=start, mesh=False)
    apart = mm_apart(est, runs["jax"]["est"])
    assert np.all(apart[:3] == 0.0) and apart.max() <= POSE_MM, apart
    assert port.mapper.keyframes.indices == j.mapper.keyframes.indices


def _hand_driven(slam, n):
    """The strict schedule written out with the tracker and the mapper."""
    tr, mp, m = slam.tracker, slam.mapper, slam.m_cfg
    grids, decoders = slam.grids, slam.decoders
    est, prev_color = {}, None
    for idx in range(n):
        f, (color, depth, event) = slam.frame_reader.get_with_device(idx)
        if idx == 0:
            est[0] = f.c2w
            mp.update_ba_state()
            grids, decoders, _ = mp.optimize_map(
                m.iters_first, m.lr_first_factor, 0, f.color, f.depth, f.event, f.c2w.copy(),
                seed=0, grids=grids, decoders=decoders, cur_images_dev=(color, depth))
            mp.maybe_add_keyframe(0, n, f.color, f.depth, f.event, f.c2w, f.c2w,
                                  device_images=(color, depth))
            prev_color = color
            tr.pre_gt_color = color
        else:
            est[idx] = tr.track(idx, color, depth, event, est[idx - 1],
                                est[idx - 2] if idx >= 2 else None, decoders, grids, seed=idx)
        tr.end_of_window(idx, color, m.every_frame)
        calls = []
        if idx and idx % m.every_frame == 0:
            calls.append((1, m.iters, mp.cfg))
        if idx == n - 1:
            calls.append((5, m.iters, mp.cfg._replace(window_size=2 * mp.cfg.window_size)))
        for outer, iters, cfg in calls:
            base, mp.cfg = mp.cfg, cfg
            mp.update_ba_state()
            pose = est[idx] if outer == 1 else np.asarray(est[idx]).copy()
            for it in range(outer):
                grids, decoders, new = mp.optimize_map(
                    iters, m.lr_factor, idx, f.color, f.depth, f.event, pose,
                    pre_gt_color=prev_color, color_refine=outer == 5, seed=idx * 97 + it,
                    grids=grids, decoders=decoders, cur_images_dev=(color, depth))
                if new is not None:
                    pose = est[idx] = new
            mp.cfg = base
            mp.maybe_add_keyframe(idx, n, f.color, f.depth, f.event, pose, f.c2w,
                                  device_images=(color, depth))
            prev_color = color
    return grids, decoders, np.stack([np.asarray(est[i]) for i in range(n)])


def test_step_equals_a_hand_driven_tracker_mapper_loop(tmp_path):
    n = 4
    cfg = tiny_cfg(str(tmp_path / "scene"), n, events=False)
    cfg["data"]["output"] = str(tmp_path / "a")
    slam = EvenNICERSLAM(cfg, device="cpu")
    for idx in range(n):
        slam.step(idx)
    cfg["data"]["output"] = str(tmp_path / "b")
    hand = EvenNICERSLAM(cfg, device="cpu")
    grids, decoders, est = _hand_driven(hand, n)
    np.testing.assert_array_equal(slam.estimate_c2w_list, est)
    for lvl in grids:
        assert torch.equal(slam.grids[lvl], grids[lvl]), lvl
    assert torch.equal(slam.decoders["color"]["out_w"], decoders["color"]["out_w"])
    assert slam.mapper.keyframes.indices == hand.mapper.keyframes.indices == [0, 2]


def test_first_mapping_call_fits_the_coarse_grid_and_cpu_tracking_is_plain(tmp_path):
    """The coarse level is optimised inside the mapper's own calls: the first
    mapping call moves the coarse grid. On the CPU the tracker decodes through
    the plain version, as the JAX package's does there."""
    cfg = tiny_cfg(str(tmp_path / "scene"), 2, events=False)
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, device="cpu")
    assert slam.mapper.fuse_coarse and not slam.tracker.settings.fused_decode
    coarse0 = slam.grids["coarse"].clone()
    slam.step(0)
    assert not torch.equal(slam.grids["coarse"], coarse0)
    assert slam.mapper.keyframes.indices == [0]


@pytest.fixture(scope="module")
def strict_three(tmp_path_factory):
    """Three frames of the strict schedule on the CPU: the trajectory."""
    tmp = tmp_path_factory.mktemp("strict")
    cfg = tiny_cfg(str(tmp / "scene"), 3, events=False)
    cfg["data"]["output"] = str(tmp / "out")
    return EvenNICERSLAM(cfg, device="cpu").run(mesh=False, checkpoint=False).copy()


@pytest.mark.parametrize("change,item", [
    ({"sync_method": "loose"}, "item 5"),
    ({"sync_method": "free"}, "item 5"),
    ({"parallel": {"map_devices": 1}}, "item 5"),
    ({"parallel": {"data_parallel": 2}}, "item 5"),
    ({"enable_vis": True}, "item 4"),
])
def test_unported_options_raise_before_the_first_frame(tmp_path, strict_three, change, item):
    """The five options this test once saw refused (ROADMAP Queue 1 items 4
    and 5, both ported) all run now. On one device slot (the CPU alone)
    ``sync_method: loose|free`` and ``parallel.map_devices`` find no second
    slot group and run the strict schedule, and ``parallel.data_parallel: 2``
    is clamped to the one slot, as the JAX package clamps it to its devices:
    three frames with poses bit-equal to the strict run's. ``enable_vis``
    runs and writes the visualiser's panels."""
    cfg = tiny_cfg(str(tmp_path / "scene"), 3, events=False)
    cfg["data"]["output"] = str(tmp_path / "out")
    cfg.update(change)
    if change.get("enable_vis"):
        cfg["tracking"]["vis_freq"] = cfg["mapping"]["vis_freq"] = 2
    slam = EvenNICERSLAM(cfg, device="cpu")
    assert not slam.concurrent and slam.dp_devices is None
    assert slam.devices == [torch.device("cpu")]
    est = slam.run(mesh=False, checkpoint=False)
    np.testing.assert_array_equal(est, strict_three)
    if change.get("enable_vis"):
        out = cfg["data"]["output"]
        assert os.listdir(os.path.join(out, "tracking_vis")) == ["00002_0000.jpg"]
        assert "00000_0000.jpg" in os.listdir(os.path.join(out, "mapping_vis"))


def test_loose_follows_the_jax_packages_loose_run(tmp_path):
    """``sync_method: loose`` on one device group in both packages (the JAX
    package falls back to the strict schedule there): the port's trajectory
    from the JAX run's initial state and draws within POSE_MM of the JAX
    run's, as the strict runs are."""
    jax_run = run_jax(str(tmp_path), N_FRAMES, events=False, sync_method="loose")
    assert not jax_run["slam"].concurrent
    port = port_pipeline(str(tmp_path), "loose", N_FRAMES, False, jax_run["state"],
                         sync_method="loose")
    apart = mm_apart(port.run(mesh=False), jax_run["est"])
    assert apart[0] == 0.0 and apart.max() <= POSE_MM, apart


def test_nice_false_builds_and_maps_the_imap_model(tmp_path):
    """``nice=False`` (no longer refused) builds iMAP from the same
    configuration: no grids, the single MLP, no coarse term, the tracker on
    the plain decode; frame 0's first mapping call trains the whole MLP
    (``test_torch_imap_pipeline.py`` holds the run against the JAX
    package's)."""
    cfg = tiny_cfg(str(tmp_path / "scene"), 2, events=False)
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, nice=False, device="cpu")
    assert slam.grids == {} and set(slam.decoders) == {"imap"}
    assert not slam.coarse and not slam.mapper.fuse_coarse
    assert not slam.tracker.settings.fused_decode and not slam.settings.nice
    before = {k: v.clone() for k, v in slam.decoders["imap"].items() if torch.is_tensor(v)}
    slam.step(0)
    assert all(not torch.equal(slam.decoders["imap"][k], v) for k, v in before.items())
    assert slam.mapper.keyframes.indices == [0] and slam.grids == {}


def test_default_run_meshes_and_device_none_needs_cuda(tmp_path):
    """``run()`` with its defaults meshes since the mesher is ported: it runs
    the scene to its end and writes ``mesh/final_mesh.ply`` (no longer a
    ``NotImplementedError`` before the first frame)."""
    cfg = tiny_cfg(str(tmp_path / "scene"), 2, events=False)
    cfg["data"]["output"] = str(tmp_path / "out")
    cfg["meshing"]["resolution"] = 24
    slam = EvenNICERSLAM(cfg, device="cpu")
    slam.run()
    assert slam.idx == 1 and slam.mapper.keyframes.indices
    assert os.listdir(os.path.join(cfg["data"]["output"], "mesh")) == ["final_mesh.ply"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            EvenNICERSLAM(cfg)
