"""Checkpoints, telemetry and the weight loaders of the port against the JAX
package's.

- A checkpoint the JAX package's ``CheckpointLogger`` writes restores into a
  port ``EvenNICERSLAM``, and the port's into a JAX one: grids, decoders,
  poses, the keyframe registry and the rebuilt transient state equal, bit
  for bit (the ``.npz`` holds float32 arrays under the same keys, the
  keyframe pickle numpy arrays only).
- ``MetricsLogger`` writes the same lines for the same records (but ``t``).
- ``load_pretrained_decoders`` and ``load_eventnet_torch`` read a ``.pt`` /
  ``.pth`` that the test writes with ``torch.save`` in the reference's key
  layout to the JAX package's trees, exactly.
- ``init_eventnet`` gives the JAX package's shapes, He-normal weights and
  identity BatchNorm statistics.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from evennicer_slam_tpu.models import eventnet as je
from evennicer_slam_tpu.models import pretrained as jpre
from evennicer_slam_tpu.slam.pipeline import EvenNICERSLAM as JaxSLAM
from evennicer_slam_tpu.utils import logger as jlog
from evennicer_slam_tpu.utils import telemetry as jtel
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.models import eventnet as te
from evennicer_slam_tpu_torch.models import pretrained as tpre
from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
from evennicer_slam_tpu_torch.utils import logger as tlog
from evennicer_slam_tpu_torch.utils import telemetry as ttel
from test_models import random_torch_mlp_state
from torch_parity import cap_threads, jax_to_np
from torch_pipeline_parity import tiny_cfg

cap_threads()

N_FRAMES = 4


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k


@pytest.fixture
def pipelines(tmp_path):
    cfg = tiny_cfg(str(tmp_path / "scene"), N_FRAMES, events=True)
    jcfg = dict(cfg, data=dict(cfg["data"], output=str(tmp_path / "jax")))
    tcfg = dict(cfg, data=dict(cfg["data"], output=str(tmp_path / "port")))
    return JaxSLAM(jcfg), EvenNICERSLAM(tcfg, device="cpu")


def _fill_state(slam, rng, kf_pose):
    """A mid-run state: a trajectory, keyframes 0 and 2 with their images."""
    est = np.stack([f.c2w for f in (slam.frame_reader[i] for i in range(N_FRAMES))])
    est[:, :3, 3] += rng.normal(scale=0.01, size=(N_FRAMES, 3)).astype(np.float32)
    slam.estimate_c2w_list = est
    slam.gt_c2w_list[:] = np.stack([slam.frame_reader[i].c2w for i in range(N_FRAMES)])
    for i in (0, 2):
        f = slam.frame_reader[i]
        slam.mapper.keyframes.append(i, f.color, f.depth, f.event, kf_pose(est[i]), f.c2w)
    slam.mapper.selected_keyframes = {2: [{"idx": 0, "est_c2w": est[0].copy()}]}


def _check_restored(dst, src, start):
    assert start == 3 and dst.idx == dst.mapping_idx == 2
    assert_trees_equal(dst.grids, src.grids)
    assert_trees_equal(dst.decoders, src.decoders)
    np.testing.assert_array_equal(dst.estimate_c2w_list, src.estimate_c2w_list)
    np.testing.assert_array_equal(dst.gt_c2w_list, src.gt_c2w_list)
    assert dst.mapper.keyframes.indices == src.mapper.keyframes.indices == [0, 2]
    for a, b in zip(dst.mapper.keyframes.frames, src.mapper.keyframes.frames):
        for k in ("color", "depth", "event", "est_c2w", "gt_c2w"):
            assert np.array_equal(a[k], b[k]), k
    assert dst.mapper.selected_keyframes.keys() == {2}
    frame2 = dst.frame_reader[2]
    np.testing.assert_array_equal(np.asarray(dst.tracker.pre_gt_color), frame2.color)
    np.testing.assert_array_equal(np.asarray(dst.pre_gt_color_mapper), frame2.color)
    assert not np.asarray(dst.tracker.gt_event_integrate).any()


def test_a_jax_checkpoint_restores_into_the_port(pipelines):
    js, ts = pipelines
    _fill_state(js, np.random.default_rng(1), lambda p: p)
    path = js.logger.log(js, 2)
    start = tlog.CheckpointLogger.restore(ts, path)
    _check_restored(ts, js, start)
    assert ts.mapper.keyframes.device.type == "cpu"


def test_a_port_checkpoint_restores_into_the_jax_package(pipelines):
    js, ts = pipelines
    # the port's own initial map, and a keyframe pose still on the device
    _fill_state(ts, np.random.default_rng(2), torch.from_numpy)
    ts.mapper.keyframes.sync_host_poses()
    path = ts.logger.log(ts, 2)
    with open(path.replace(".npz", ".keyframes.pkl"), "rb") as f:
        kf = f.read()
    assert b"torch" not in kf  # numpy arrays only
    start = jlog.CheckpointLogger.restore(js, path)
    _check_restored(js, ts, start)
    assert jlog.CheckpointLogger.latest(os.path.dirname(path)) == path


def test_metrics_logger_writes_the_jax_packages_lines(tmp_path):
    recs = [{"frame": 0, "mapping/loss": 0.0},
            {"frame": 1, "tracking/rgbd_first": 3.25, "tracking/rgbd_last": 1.5},
            {"frame": 4, "event_guard_fired": 1, "fallback": "esim"}]
    for pkg, name in ((jtel, "jax"), (ttel, "port")):
        m = pkg.MetricsLogger(str(tmp_path / name))
        for r in recs:
            m.log(dict(r))
        m.close()

    def lines(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]

    assert lines("port") == lines("jax") == recs
    # the tracer's totals by span name summarise as the JAX package's phase
    # timers do, under the same keys and rounding
    timers = jtel.PhaseTimers()
    timers.total.update(track=1.25, map=0.5)
    timers.count.update(track=5, map=2)
    tracer = ttel.Tracer()
    tracer.total.update({"slam.track": 1.25, "slam.map": 0.5})
    tracer.count.update({"slam.track": 5, "slam.map": 2})
    assert tracer.summary() == timers.summary()


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with ttel.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with ttel.torch_trace(None) as none:
        assert none is None


def test_load_pretrained_decoders_matches_the_jax_loader(tmp_path):
    from evennicer_slam_tpu.models.decoders import init_nice_decoders

    rng = np.random.default_rng(3)
    model = {f"decoder.coarse_{k}": torch.from_numpy(v)
             for k, v in random_torch_mlp_state(rng, c_dim=32).items()}
    model.update({f"decoder.fine_{k}": torch.from_numpy(v)
                  for k, v in random_torch_mlp_state(rng, c_dim=64).items()})
    model["encoder.conv.weight"] = torch.zeros(3, 3)
    mf = str(tmp_path / "middle_fine.pt")
    torch.save({"model": model}, mf)
    coarse = {f"decoder.{k}": torch.from_numpy(v)
              for k, v in random_torch_mlp_state(rng, emb=32, c_dim=0).items()
              if not k.startswith("embedder")}
    cp = str(tmp_path / "coarse.pt")
    torch.save({"model": coarse}, cp)

    j_dec = init_nice_decoders(jax.random.PRNGKey(0), coarse=True)
    want = jax_to_np(jpre.load_pretrained_decoders(j_dec, mf, cp))
    got = tpre.load_pretrained_decoders(convert.decoders_from_numpy(jax_to_np(j_dec), "cpu"),
                                        mf, cp)
    assert_trees_equal(got, want)
    assert set(got) == {"coarse", "middle", "fine", "color"}
    # the pipeline loads them when the configured files exist
    cfg = tiny_cfg(str(tmp_path / "scene"), 2, events=False,
                   pretrained_decoders={"middle_fine": mf, "coarse": cp})
    cfg["data"]["output"] = str(tmp_path / "out")
    slam = EvenNICERSLAM(cfg, device="cpu")
    for mlp in ("coarse", "middle", "fine"):
        assert_trees_equal(slam.decoders[mlp], want[mlp])


def _unet_state(params, rng):
    """A reference UNet_2heads state dict holding ``params`` (HWIO -> OIHW)
    with random BatchNorm statistics written into ``params`` too."""
    state = {}

    def conv(key, w):
        state[key] = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))

    def dconv(prefix, p):
        conv(f"{prefix}.double_conv.0.weight", p["w1"])
        conv(f"{prefix}.double_conv.3.weight", p["w2"])
        for i, bn in ((1, "bn1"), (4, "bn2")):
            c = p[bn]["g"].shape[0]
            p[bn] = {"g": rng.random(c, np.float32) + 0.5, "b": rng.normal(size=c).astype(np.float32),
                     "m": rng.normal(size=c).astype(np.float32),
                     "v": rng.random(c, np.float32) + 0.1}
            for s, name in (("g", "weight"), ("b", "bias"), ("m", "running_mean"),
                            ("v", "running_var")):
                state[f"{prefix}.double_conv.{i}.{name}"] = torch.from_numpy(p[bn][s])
            state[f"{prefix}.double_conv.{i}.num_batches_tracked"] = torch.tensor(7)

    dconv("inc", params["inc"])
    for i in range(1, 5):
        dconv(f"down{i}.maxpool_conv.1", params[f"down{i}"])
    for head in ("1", "2"):
        for i in range(1, 5):
            dconv(f"up{i}_{head}.conv", params[f"up{i}_{head}"])
        conv(f"outc_{head}.conv.weight", params[f"outc_{head}"]["w"])
        params[f"outc_{head}"]["b"] = rng.normal(size=2).astype(np.float32)
        state[f"outc_{head}.conv.bias"] = torch.from_numpy(params[f"outc_{head}"]["b"])
    return state


def test_load_eventnet_torch_matches_the_jax_loader(tmp_path):
    params = jax_to_np(je.init_eventnet(jax.random.PRNGKey(4)))
    state = _unet_state(params, np.random.default_rng(5))
    path = str(tmp_path / "unet.pth")
    torch.save(state, path)
    want = jax_to_np(je.load_eventnet_torch(path))
    got = te.load_eventnet_torch(path, device="cpu")
    assert_trees_equal(got, want)
    assert_trees_equal(got, params)


def test_init_eventnet_shapes_and_he_scale():
    got = te.init_eventnet(torch.Generator().manual_seed(0), device="cpu")
    want = jax_to_np(je.init_eventnet(jax.random.PRNGKey(0)))
    shapes = {k: v.shape for k, v in _leaves(got)}
    assert shapes == {k: v.shape for k, v in _leaves(want)}
    for path, w in _leaves(got):
        if path.endswith((".w1", ".w2", ".w")):
            fan_in = w.shape[0] * w.shape[1] * w.shape[2]
            # the sample standard deviation of n normal draws lies within
            # 5 / sqrt(2 n) of sigma, relative, and their mean within
            # 5 sigma / sqrt(n) of 0, but for one in 1.7 million
            sigma = np.sqrt(2.0 / fan_in)
            assert abs(w.std() / sigma - 1.0) < 5.0 / np.sqrt(2 * w.size), path
            assert abs(w.mean()) < 5.0 * sigma / np.sqrt(w.size), path
        elif path.endswith((".g", ".v")):
            assert np.all(w == 1.0), path
        else:
            assert np.all(w == 0.0), path
    again = te.init_eventnet(torch.Generator().manual_seed(0), device="cpu")
    assert_trees_equal(again, got)
