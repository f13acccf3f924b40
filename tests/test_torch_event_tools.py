"""The port's event-network tools against the JAX package's on the CPU:
``predict_event`` (the same image pair and weights through both tools: the
PNGs they write compared pixel by pixel), ``event_ablation`` (the variant
table, ``summarize``, ``build_cfg``, and the tool's own run at a tiny size:
the map-domain net trained, written and read back by the JAX loader, and
the dead-reckoning and event variants tracked to a finite ATE),
``prep_own_data`` (the same YAML) and the ``train_eventnet`` command line
(its ``.npz`` read by the JAX loader)."""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import yaml

from evennicer_slam_tpu.models.eventnet_train import load_eventnet_npz as j_load_npz
from evennicer_slam_tpu.tools import event_ablation as j_ablation
from evennicer_slam_tpu.tools import predict_event as j_predict
from evennicer_slam_tpu.tools import prep_own_data as j_prep
from evennicer_slam_tpu_torch.data.jpeg import write_jpeg
from evennicer_slam_tpu_torch.data.png import read_png, write_png
from evennicer_slam_tpu_torch.data.synthetic import render_box_views
from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.tools import event_ablation, predict_event, prep_own_data
from evennicer_slam_tpu_torch.tools import train_eventnet as train_cli

from torch_parity import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "pretrained", "eventnet_mapdomain.npz")


def run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()
    monkeypatch.undo()


# ---- predict_event --------------------------------------------------------------------

def _pair(tmp_path, ext):
    """Two consecutive 64x96 views of the synthetic room as 8-bit files."""
    bound = np.array([[-1.2, 1.2], [-1.0, 1.0], [-0.8, 0.8]], np.float32)
    paths = []
    for i, th in enumerate((0.0, 0.04)):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        color, _ = render_box_views(c2w, 64, 96, 60.0, 60.0, 47.5, 31.5, bound)
        rgb = (color * 255).astype(np.uint8)
        path = str(tmp_path / f"view{i}.{ext}")
        (write_png if ext == "png" else write_jpeg)(path, rgb)
        paths.append(path)
    return paths


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_predict_event_writes_the_jax_tools_pngs(tmp_path, monkeypatch, ext):
    img1, img2 = _pair(tmp_path, ext)
    out = {}
    for name in ("jax", "port"):
        ev, binary = str(tmp_path / f"{name}_event.png"), str(tmp_path / f"{name}_bin.png")
        argv = ["--model", NPZ, "-img1", img1, "-img2", img2, "--scale", "0.5",
                "--event", ev, "--binary", binary]
        if name == "jax":
            run_jax_main(monkeypatch, j_predict, argv)
        else:
            predict_event.main(argv + ["--device", "cpu"])
        out[name] = (read_png(ev), read_png(binary))
    for got, want in zip(out["port"], out["jax"]):
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        # float32 EventNet in two frameworks: at most one step of 8 bits
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).sum() <= 0.01 * diff.size
    assert out["port"][0].shape == (32, 48, 3) and out["port"][0].max() > 0
    # cv2 reads the port's files as it reads the JAX tool's
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_bin.png"), 0),
                                  out["port"][1])


def test_predict_event_refuses_what_is_not_an_image(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(SystemExit, match="cannot read image"):
        predict_event.main(["--model", NPZ, "-img1", str(bad), "-img2", str(bad),
                            "--device", "cpu"])


# ---- event_ablation -------------------------------------------------------------------

def test_the_variant_table_is_the_jax_tools():
    assert event_ablation.VARIANTS == j_ablation.VARIANTS
    assert len(event_ablation.VARIANTS) == 13


@pytest.mark.parametrize("per_seed", [
    {"A_dead_reckoning": [0.3, 0.2], "C_events_reference": [0.1, 0.12],
     "D_non_rgbd_only": [0.08, 0.09]},
    {"D_non_rgbd_only": [0.08]},
    {"A_dead_reckoning": [0.3], "D_non_rgbd_only": [0.08]},
    {"A_dead_reckoning": [0.2], "O_esim_oracle": [0.05], "R_full_rgbd_anchor": [0.01],
     "C_events_reference": [0.25]},
])
def test_summarize_equals_the_jax_tool(per_seed):
    """``tests/test_tools.py``'s inputs and one with the oracle and the
    anchor, which may not set the best event mode."""
    got = event_ablation.summarize(per_seed, seeds=[7, 1007], frames=100)
    assert got == j_ablation.summarize(per_seed, seeds=[7, 1007], frames=100)
    if "O_esim_oracle" in per_seed:
        assert got["best_event_mode"] == "C_events_reference"
        assert got["events_beat_dead_reckoning_reference"] is False


def _without_paths(cfg, scene):
    text = json.dumps(cfg, sort_keys=True)
    return json.loads(text.replace(scene, "<scene>"))


def test_build_cfg_equals_the_jax_tools(tmp_path):
    kw = dict(traj_jitter=0.004, traj_seed=1007, keyframe_every=10, traj_step=0.02)
    got = event_ablation.build_cfg(str(tmp_path / "port"), 4, 48, 64, **kw)
    want = j_ablation.build_cfg(str(tmp_path / "jax"), 4, 48, 64, **kw)
    assert _without_paths(got, str(tmp_path / "port")) == _without_paths(
        want, str(tmp_path / "jax"))
    assert got["event"]["pretrained_path"] == "/nonexistent"
    assert got["cam"]["fx"] == 32.0 and got["mapping"]["keyframe_every"] == 10
    # the two scenes' frames are the same files
    for name in ("results/frame000003.png", "events/frame000002.png"):
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / name)),
                                      read_png(str(tmp_path / "jax" / name)))


def test_the_ablation_trains_writes_and_tracks(tmp_path, monkeypatch, capsys):
    """The tool at a tiny size (112x144: the 0.15-scale event image is 16x21,
    the least the UNet's four halvings take; loops cut): the map-domain net
    trained from scratch on triples with perturbed poses, written, read by
    the JAX loader; dead reckoning and events tracked to finite ATEs."""
    build = event_ablation.build_cfg

    def small(*a, **kw):
        cfg = build(*a, **kw)
        cfg["mapping"].update(iters_first=4, iters=2, pixels=200)
        cfg["tracking"].update(iters=2, pixels=200)
        return cfg

    monkeypatch.setattr(event_ablation, "build_cfg", small)
    out = str(tmp_path / "net.npz")
    event_ablation.main(["--frames", "6", "--hw", "112", "144", "--train_steps", "2",
                         "--scene", str(tmp_path / "scene"), "--out", out,
                         "--variants", "A_dead_reckoning", "C_events_reference",
                         "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    summary = lines[-1]
    assert set(summary["summary"]) == {"A_dead_reckoning", "C_events_reference"}
    assert all(np.isfinite(s["mean"]) for s in summary["summary"].values())
    assert "events_beat_dead_reckoning_reference" in summary
    net = j_load_npz(out)
    assert np.isfinite(np.asarray(net["outc_1"]["w"])).all()


# ---- prep_own_data --------------------------------------------------------------------

@pytest.mark.parametrize("with_mesh", [True, False])
def test_prep_own_data_writes_the_jax_tools_yaml(tmp_path, monkeypatch, with_mesh):
    folder = tmp_path / "capture"
    os.makedirs(folder / "scene")
    # open3d stores the matrix column-major: fx, 0, 0, 0, fy, 0, cx, cy, 1
    intr = {"width": 640, "height": 480,
            "intrinsic_matrix": [600.5, 0, 0, 0, 601.25, 0, 319.5, 239.75, 1]}
    (folder / "intrinsic.json").write_text(json.dumps(intr))
    if with_mesh:
        rng = np.random.default_rng(0)
        Mesh(rng.uniform(-1.5, 2.5, (30, 3)), np.array([[0, 1, 2], [3, 4, 5]])).export(
            str(folder / "scene" / "integrated.ply"))
    outs = {}
    for name in ("jax", "port"):
        out = str(tmp_path / name / "generated.yaml")
        argv = ["--input_folder", str(folder), "--out", out]
        if name == "jax":
            run_jax_main(monkeypatch, j_prep, argv)
        else:
            prep_own_data.main(argv)
        with open(out) as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    cfg = yaml.safe_load(outs["port"])
    assert cfg["cam"]["fx"] == 600.5 and cfg["cam"]["cy"] == 239.75
    if not with_mesh:
        assert cfg["mapping"]["bound"] == [[-5.0, 5.0]] * 3


# ---- train_eventnet ------------------------------------------------------------------

def test_train_eventnet_command_line_writes_a_net_the_jax_package_loads(tmp_path):
    out = str(tmp_path / "synth.npz")
    train_cli.main(["--out", out, "--steps", "2", "--batch", "2", "--height", "16",
                    "--width", "24", "--device", "cpu"])
    net = j_load_npz(out)
    with np.load(out) as raw:
        assert raw["eventnet.inc.w1"].dtype == np.float16
        assert raw["eventnet.inc.bn1.v"].dtype == np.float32
    assert np.asarray(net["inc"]["w1"]).shape == (3, 3, 6, 64)
