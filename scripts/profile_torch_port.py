#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--out build/profile_torch_port.txt]
                                          [--traces build/profile_traces]

Builds the same full-width scene and frames as ``chip_smoke.py`` (it imports
them from there), then for ``tracking_loss`` (event only, and RGB-D + event),
for one tracked frame (``track_frame``: ten iterations of forward, backward
and Adam; event only, and RGB-D + event), for one ``render_img`` and for one
steady mapping call (``Mapper.optimize_map``: 60 iterations, a K = 5 window
selected on the device, BA, the coarse mapper fused, from a device pose),
and for blocks of the pipeline from disk (``chip_smoke.py`` phase 12:
``EvenNICERSLAM.step`` over five preloaded frames, the block ending with its
steady mapping call; frames 11-15 timed, frames 21-25 traced, after a warm
block each):
  - times the call on the host clock around ``torch.cuda.synchronize()``,
  - traces it with ``torch.profiler`` (``utils/telemetry.py::torch_trace``,
    one Chrome trace a call under ``--traces``, ``NN/trace.json`` in the
    order below) and prints device time by kernel name,
    the sum of device time and its share of the wall time (the rest is the
    device waiting for the host), and the host's stream synchronisations
    (``cudaStreamSynchronize``) inside the call.
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
from evennicer_slam_tpu_torch.utils.telemetry import torch_trace  # noqa: E402


def wall_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def device_table(fn, iters, top, trace_dir):
    fn()
    torch.cuda.synchronize()
    with torch_trace(trace_dir) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    syncs = 0
    for e in prof.key_averages():
        if e.key == "cudaStreamSynchronize":
            syncs += e.count / iters
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
    return total, sum(r[1] for r in rows), lines, syncs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/profile_torch_port.txt")
    ap.add_argument("--traces", default="build/profile_traces")
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
    cs.cuda_build.build_all(["fused_decode", "fused_decode_bwd"])
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

    # one frame of the synthetic scene, tracked from the previous frame's pose
    frames = cs.upload_frames(cam, dev, n=2)
    f = frames[1]
    _, ev_lo, prev_lo, depth_lo, mask_lo = cs._prep_event_inputs(
        torch.zeros_like(f.event), f.event, frames[0].color, f.depth, mp.lo_hw,
        mp.tcfg.prev_resize)
    track_gen = torch.Generator(device=dev).manual_seed(1)

    def track(rgbd):
        return cs.track_frame(
            frames[0].c2w, torch.eye(4, device=dev), decoders, packed, mp.eventnet, bound_t,
            track_gen, f.color, f.depth, ev_lo, prev_lo, depth_lo, mask_lo,
            torch.zeros(7, device=dev), 1.0, mp.tcfg, cam, settings, rgbd=rgbd, event=True,
            const_speed=False)

    # one steady mapping call from the state chip_smoke.py checks card vs CPU:
    # keyframes at frames 0, 5, ..., 20, frame 25 mapped from its device pose
    mframes = cs.room_frames(cs.write_room_scene(cam), dev, cs.MAP_FRAMES)
    mapper, m_grids, m_decoders, mf, m_pose = cs.steady_mapping_state(cfg, cam, dev, mframes)
    mcfg = mapper.cfg

    def map_call():
        return mapper.optimize_map(mcfg.iters, mcfg.lr_factor, mf.index, mf.np.color,
                                   mf.np.depth, mf.np.event, m_pose, seed=mf.index * 97,
                                   grids=m_grids, decoders=m_decoders,
                                   cur_images_dev=(mf.color, mf.depth))

    # the pipeline from disk: frames 0-5 warm, 6-26 preloaded, then blocks of
    # five frames; each call of block() steps the next block
    slam = cs.EvenNICERSLAM(cs.pipeline_config(cs.write_room_scene(cam)), device=dev)
    for idx in range(cs.PIPE_WARM):
        slam.step(idx)
    slam.frame_reader.preload_device(range(cs.PIPE_WARM, cs.PIPE_WARM + 4 * cs.PIPE_BLOCK + 1))
    starts = iter(range(cs.PIPE_WARM, cs.PIPE_WARM + 4 * cs.PIPE_BLOCK, cs.PIPE_BLOCK))

    def block():
        start = next(starts)
        for idx in range(start, start + cs.PIPE_BLOCK):
            slam.step(idx)

    for i, (name, fn, iters) in enumerate((
        ("tracking_loss, event only", lambda: score(False), opts.iters),
        ("tracking_loss, RGB-D + event", lambda: score(True), opts.iters),
        (f"track_frame, event only ({mp.tcfg.iters} iterations)", lambda: track(False), 2),
        (f"track_frame, RGB-D + event ({mp.tcfg.iters} iterations)", lambda: track(True), 2),
        ("EventNet inference_event 102x180 alone", eventnet_only, opts.iters),
        ("render_img 680x1200", render, 2),
        (f"Mapper.optimize_map, steady ({mcfg.iters} iterations, K = {mcfg.window_size}, "
         f"BA, coarse fused, device pose)", map_call, 2),
        ("pipeline block: EvenNICERSLAM.step x 5 ending in a steady mapping call "
         "(timed: frames 11-15, K = 4; traced: frames 21-25, K = 5 with BA)", block, 1),
    )):
        ms = wall_ms(fn, iters)
        total, n_kernels, lines, syncs = device_table(fn, iters, opts.top,
                                                      os.path.join(opts.traces, f"{i:02d}"))
        say(f"\n== {name}: {ms:.2f} ms wall per call; device busy {total:.2f} ms "
            f"({100 * total / ms:.0f} % of the wall time, idle {100 * (1 - total / ms):.0f} %) "
            f"in {n_kernels:.0f} kernels and copies; {syncs:.0f} host stream "
            f"synchronisations per call")
        for line in lines:
            say(line)

    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        f.write("\n".join(out) + "\n")


if __name__ == "__main__":
    main()
