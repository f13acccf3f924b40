#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--out build/profile_torch_port.txt]

Builds the same full-width scene and frame as ``chip_smoke.py`` (it imports
them from there), then for ``tracking_loss`` (event only, and RGB-D + event)
and for one ``render_img``:
  - times the call on the host clock around ``torch.cuda.synchronize()``,
  - traces it with ``torch.profiler`` and prints device time by kernel name,
    the sum of device time and its share of the wall time (the rest is the
    device waiting for the host).
Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from evennicer_slam_tpu_torch.models.eventnet import inference_event  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def wall_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def device_table(fn, iters, top):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels and copies): the operators that
        # launched them carry the same time again
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / iters, e.count / iters, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    lines = [f"  {ms:9.3f} ms  {cnt:7.1f} x  {name[:110]}" for ms, cnt, name in rows[:top]]
    return total, sum(r[1] for r in rows), lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_port.txt")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--cudnn-benchmark", choices=["on", "off"], default=None,
                    help="override torch.backends.cudnn.benchmark for an A/B run "
                         "(default: what setup_torch sets)")
    opts = ap.parse_args()
    dev = torch.device("cuda")
    out = []

    def say(msg):
        print(msg, flush=True)
        out.append(msg)

    say(f"device: {cs.nvidia_smi_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.setup_torch(verbose=False)
    if opts.cudnn_benchmark is not None:
        torch.backends.cudnn.benchmark = opts.cudnn_benchmark == "on"
    say(f"cudnn.benchmark={torch.backends.cudnn.benchmark}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    cs.fused_decode.kernel_library()
    cfg, grids, decoders, packed = cs.make_scene(dev)
    bound_t = torch.from_numpy(cs.BOUND).to(dev)
    mp = cs.main_path_inputs(cfg, bound_t, dev)
    cam, settings = mp.cam, mp.settings
    gen = torch.Generator().manual_seed(1)

    def score(rgbd):
        with torch.no_grad():
            return cs.tracking_loss(
                mp.true_pose, decoders, packed, mp.eventnet, bound_t, mp.color, mp.depth,
                mp.gt_event_lo, mp.prev_color_lo, mp.gt_depth_lo_flat, mp.gt_mask_lo,
                mp.tcfg, cam, settings, rgbd=rgbd, event=True, generator=gen)

    renderer = cs.Renderer(cam.H, cam.W, cam.fx, cam.fy, cam.cx, cam.cy, cs.BOUND,
                           settings, device=dev)
    c2w = cs.pose_matrix_from_tensor(mp.true_pose)

    def render():
        with torch.no_grad():
            return renderer.render_img(decoders, packed, c2w, "color", gt_depth=mp.depth)

    def eventnet_only():
        with torch.no_grad():
            return inference_event(mp.eventnet, mp.prev_color_lo, mp.prev_color_lo)

    for name, fn, iters in (
        ("tracking_loss, event only", lambda: score(False), opts.iters),
        ("tracking_loss, RGB-D + event", lambda: score(True), opts.iters),
        ("EventNet inference_event 102x180 alone", eventnet_only, opts.iters),
        ("render_img 680x1200", render, 2),
    ):
        ms = wall_ms(fn, iters)
        total, n_kernels, lines = device_table(fn, iters, opts.top)
        say(f"\n== {name}: {ms:.2f} ms wall per call; device busy {total:.2f} ms "
            f"({100 * total / ms:.0f} % of the wall time, idle {100 * (1 - total / ms):.0f} %) "
            f"in {n_kernels:.0f} kernels and copies")
        for line in lines:
            say(line)

    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        f.write("\n".join(out) + "\n")


if __name__ == "__main__":
    main()
