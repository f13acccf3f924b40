"""The port's boundaries: weights carried across from the JAX package
(``convert``), its own config loader, the rule that it imports neither
``jax`` nor the JAX package, and the rule that an entry point called without
``device`` raises where there is no CUDA device instead of running on the CPU."""

import ast
import os
import pkgutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import evennicer_slam_tpu_torch
from evennicer_slam_tpu import config as jconfig
from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.slam.camera import Camera as JCamera
from evennicer_slam_tpu_torch import config as tconfig
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.models import decoders as td
from evennicer_slam_tpu_torch.models.eventnet import load_eventnet_npz
from evennicer_slam_tpu_torch.models.grids import init_grids
from evennicer_slam_tpu_torch.mesh.mesher import Mesher
from evennicer_slam_tpu_torch.render.renderer import Renderer, RenderSettings
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.keyframes import KeyframeStore
from evennicer_slam_tpu_torch.slam.mapper import Mapper, MapperConfig, map_frame
from evennicer_slam_tpu_torch.slam.tracker import (
    Tracker,
    TrackerConfig,
    track_frame,
    tracking_loss,
)
from evennicer_slam_tpu_torch.utils import runtime

from torch_parity import cap_threads, jax_to_np

cap_threads()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}


# ---- weights carried across -------------------------------------------------

def test_decoders_and_grids_carry_across_unchanged():
    dj = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    gj = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    gj = jd.pack_grids_for_tracking(gj)
    dt = convert.decoders_from_numpy(jax_to_np(dj), device="cpu")
    gt = convert.grids_from_numpy(jax_to_np(gj), device="cpu")
    assert set(dt) == {"middle", "fine", "color", "coarse"}
    for name, m in dj.items():
        for key, val in m.items():
            if isinstance(val, (list, tuple)):
                assert isinstance(dt[name][key], list)
                for a, b in zip(dt[name][key], val):
                    assert np.array_equal(a.numpy(), np.asarray(b))
            else:
                assert np.array_equal(dt[name][key].numpy(), np.asarray(val))
    assert dt["fine"]["fc_w"][0].shape == (64, 32)  # stored [in, out]
    for level, g in gj.items():
        assert tuple(gt[level].shape) == g.shape
        if g.dtype == jnp.bfloat16:
            assert gt[level].dtype == torch.bfloat16
            assert np.array_equal(gt[level].view(torch.int16).numpy(),
                                  np.asarray(g).view(np.int16))
        else:
            assert np.array_equal(gt[level].numpy(), np.asarray(g))
    # the port packs the carried grids to the very same rows
    repacked = td.pack_grids_for_tracking({k: gt[k] for k in ("middle", "fine", "color")})
    assert torch.equal(repacked["fc_packed"], gt["fc_packed"])


def test_convert_rejects_what_is_not_a_grid_or_decoder():
    with pytest.raises(ValueError):
        convert.grids_from_numpy({"middle": np.zeros((4, 4, 4))}, device="cpu")
    with pytest.raises(ValueError):
        convert.decoders_from_numpy({"middle": {"B": np.zeros((3, 93))}}, device="cpu")


# ---- config -------------------------------------------------------------------

def test_config_loader_is_an_equal_copy(tmp_path):
    assert tconfig.default_config_path(True) == jconfig.default_config_path(True)
    want = jconfig.load_config(jconfig.default_config_path(True))
    got = tconfig.load_config(tconfig.default_config_path(True))
    assert got == want and got["model"]["c_dim"] == 32
    child = tmp_path / "child.yaml"
    child.write_text("inherit_from: configs/nice_slam.yaml\ntracking: {pixels: 77}\n")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        got, want = tconfig.load_config(str(child)), jconfig.load_config(str(child))
    finally:
        os.chdir(cwd)
    assert got == want and got["tracking"]["pixels"] == 77 and got["tracking"]["iters"] == 10
    a, b = {"x": {"y": 1, "z": 2}}, {"x": {"y": 5}, "w": 3}
    tconfig.update_recursive(a, b)
    assert a == {"x": {"y": 5, "z": 2}, "w": 3}
    cfg = tconfig.load_config(tconfig.default_config_path(True))
    assert Camera.from_cfg(cfg) == tuple(JCamera.from_cfg(cfg))
    cfg["cam"].update(crop_size=[340, 600], crop_edge=10)
    assert Camera.from_cfg(cfg) == tuple(JCamera.from_cfg(cfg))


def test_get_model_builds_the_ports_decoders():
    cfg = tconfig.load_config(tconfig.default_config_path(True))
    dec = tconfig.get_model(cfg, nice=True, device="cpu")
    assert set(dec) == {"middle", "fine", "color", "coarse"}
    again = tconfig.get_model(cfg, nice=True, device="cpu")
    assert torch.equal(dec["color"]["out_w"], again["color"]["out_w"])  # seeded by cfg
    imap = tconfig.get_model(tconfig.load_config(tconfig.default_config_path(False)),
                             nice=False, device="cpu")
    assert set(imap) == {"imap"} and tuple(imap["imap"]["out_w"].shape) == (256, 4)


# ---- imports ------------------------------------------------------------------

def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def _port_sources():
    pkg_dir = os.path.dirname(evennicer_slam_tpu_torch.__file__)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg_dir):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    paths = _port_sources()
    assert len(paths) > 20
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), (path, mod)
            assert top != "evennicer_slam_tpu", (path, mod)
            # the machine with the card has no OpenCV, no image or plotting
            # library and no OpenEXR: the port has its own codecs
            assert top not in ("cv2", "PIL", "imageio", "matplotlib", "OpenEXR", "Imath"), (
                path, mod)


def test_every_port_module_imports_here():
    """No module needs nvcc, triton or a GPU to be imported."""
    names = [m.name for m in pkgutil.walk_packages(
        evennicer_slam_tpu_torch.__path__, "evennicer_slam_tpu_torch.")]
    assert "evennicer_slam_tpu_torch.ops.fused_decode" in names
    for new in ("utils.optim", "data.synthetic", "slam.tracker", "ops.cuda_build",
                "slam.mapper", "slam.keyframes", "data.png", "data.datasets", "data.prefetch",
                "utils.telemetry", "utils.logger", "models.pretrained", "slam.pipeline",
                "mesh.trimesh_lite", "mesh.marching", "mesh.raster", "mesh.mesher", "run",
                "tools.eval_ate", "tools.eval_recon", "tools.cull_mesh",
                "tools.validate_synthetic", "data.jpeg", "data.undistort", "data.exr",
                "utils.visualizer", "models.eventnet_train", "tools.train_eventnet",
                "tools.predict_event", "tools.event_ablation", "tools.prep_own_data"):
        assert f"evennicer_slam_tpu_torch.{new}" in names
    for name in names:
        __import__(name)


# ---- device -------------------------------------------------------------------

def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: device=None is allowed to run")


def test_resolve_device():
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device(None)


ENTRY_POINTS = {
    "init_grids": lambda: init_grids(torch.Generator().manual_seed(0), BOUND, GRID_LEN, 32, False),
    "init_nice_decoders": lambda: td.init_nice_decoders(torch.Generator().manual_seed(0)),
    "get_model": lambda: tconfig.get_model(
        tconfig.load_config(tconfig.default_config_path(True))),
    "load_eventnet_npz": lambda: load_eventnet_npz(
        os.path.join(ROOT, "pretrained", "eventnet_mapdomain.npz")),
    "Renderer": lambda: Renderer(20, 30, 18.0, 18.0, 14.5, 9.5, BOUND, RenderSettings()),
    "convert": lambda: convert.tree_from_numpy({"a": np.zeros(3, np.float32)}),
    "tracking_loss": lambda: tracking_loss(
        torch.tensor([1.0, 0, 0, 0, 0, 0, 0]), {}, {}, {}, torch.as_tensor(BOUND),
        torch.zeros(20, 30, 3), torch.zeros(20, 30), torch.zeros(10, 15, 2),
        torch.zeros(10, 15, 3), torch.zeros(150), torch.zeros(10, 15),
        TrackerConfig(), Camera(20, 30, 18.0, 18.0, 14.5, 9.5), RenderSettings(),
        rgbd=False, event=False),
    "track_frame": lambda: track_frame(
        torch.eye(4), torch.eye(4), {}, {}, {}, torch.as_tensor(BOUND), None,
        torch.zeros(20, 30, 3), torch.zeros(20, 30), torch.zeros(10, 15, 2),
        torch.zeros(10, 15, 3), torch.zeros(150), torch.zeros(10, 15), torch.zeros(7), 1.0,
        TrackerConfig(), Camera(20, 30, 18.0, 18.0, 14.5, 9.5), RenderSettings(),
        rgbd=False, event=False, const_speed=False),
    "Tracker": lambda: Tracker(TrackerConfig(), Camera(20, 30, 18.0, 18.0, 14.5, 9.5),
                               RenderSettings(), BOUND),
    "adam_state_from_numpy": lambda: convert.adam_state_from_numpy(
        np.zeros(3, np.float32), np.zeros(3, np.float32), np.zeros((), np.int32)),
    "Mapper": lambda: Mapper(MapperConfig(), Camera(20, 30, 18.0, 18.0, 14.5, 9.5),
                             RenderSettings(), BOUND),
    "KeyframeStore": lambda: KeyframeStore(),
    "Mesher": lambda: Mesher(tconfig.load_config(tconfig.default_config_path(True)),
                             Camera(20, 30, 18.0, 18.0, 14.5, 9.5), RenderSettings(), BOUND),
    "keyframe_store_from_numpy": lambda: convert.keyframe_store_from_numpy([]),
    "map_frame": lambda: map_frame(
        {}, {}, torch.zeros(1, 7), None, None, torch.eye(4)[None], torch.ones(1),
        torch.zeros(1, 20, 30, 3), torch.zeros(1, 20, 30), {}, torch.as_tensor(BOUND), {}, {},
        1.0, None, None, None, {}, 0.0, None, None, None, None, MapperConfig(),
        Camera(20, 30, 18.0, 18.0, 14.5, 9.5), RenderSettings(), False, False, False, (),
        False, False),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_cuda(name):
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def test_tracking_loss_refuses_tensors_on_another_device():
    with pytest.raises(ValueError, match="runs on"):
        runtime.require_on(torch.device("cuda"), torch.zeros(1))
    runtime.require_on(torch.device("cpu"), torch.zeros(1), torch.ones(2))


def test_fused_decode_on_cpu_tensors_never_builds_a_kernel():
    from evennicer_slam_tpu_torch.ops import cuda_build, fused_decode

    before = dict(cuda_build.BUILD_LOG)
    dec = td.init_nice_decoders(torch.Generator().manual_seed(0), device="cpu")
    out = fused_decode.fused_decode_packed(
        dec, torch.zeros(5, 3), torch.rand(5, 3), torch.rand(5, 3),
        torch.zeros(5, 256, dtype=torch.bfloat16), torch.zeros(5, 512, dtype=torch.bfloat16))
    assert tuple(out.shape) == (5, 4) and cuda_build.BUILD_LOG == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_decode.launch_fused_decode_fwd(*[torch.zeros(5, 3)] * 7)


def test_kernel_digest_covers_included_headers(tmp_path, monkeypatch):
    """The library's name carries a digest of the source, of every header it
    includes (recursively) and of the flags: a changed header builds anew.
    Hashing starts no compiler."""
    from evennicer_slam_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n  #  include "sub/deep.cuh"\n'
                                   "#include <cuda_runtime.h>\nint k;\n")
    (tmp_path / "common.cuh").write_text('#include "sub/deep.cuh"\nint c;\n')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "deep.cuh").write_text("int d;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    files = cuda_build.source_files("k")
    assert [os.path.relpath(f, tmp_path) for f in files] == \
        ["k.cu", "common.cuh", os.path.join("sub", "deep.cuh")]
    base = cuda_build.source_digest("k")
    assert base == cuda_build.source_digest("k") and len(base) == 12
    assert cuda_build.source_digest("k", ("-DX=1",)) != base
    (tmp_path / "other.cuh").write_text("int changed;\n")  # not included: no effect
    assert cuda_build.source_digest("k") == base
    (tmp_path / "sub" / "deep.cuh").write_text("int d2;\n")
    deep = cuda_build.source_digest("k")
    assert deep != base
    (tmp_path / "common.cuh").write_text('#include "sub/deep.cuh"\nint c2;\n')
    assert cuda_build.source_digest("k") not in (base, deep)


def test_both_kernels_share_the_common_header():
    from evennicer_slam_tpu_torch.ops import cuda_build

    for name in ("fused_decode", "fused_decode_bwd"):
        files = [os.path.basename(f) for f in cuda_build.source_files(name)]
        assert files == [f"{name}.cu", "fused_decode_common.cuh"]


def test_setup_torch_turns_tf32_off_and_says_so(capsys):
    torch.backends.cudnn.allow_tf32 = True
    state = runtime.setup_torch()
    assert state == {"matmul_allow_tf32": False, "cudnn_allow_tf32": False,
                     "cudnn_benchmark": True, "cudnn_deterministic": True}
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert "TF32" in capsys.readouterr().out
