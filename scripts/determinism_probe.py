#!/usr/bin/env python3
"""Which ops make two identical runs on the card differ? A probe outside
the main path, on one NVIDIA GPU.

    python3 scripts/determinism_probe.py [--out chiprun_out/determinism.json]

Runs, each twice from the same state in one process, and compares bit for
bit:
  - ten EventNet training steps at 102x180, batch 4 (``models/eventnet_train.py
    ::train_step``, the batches of ``chip_smoke.py`` phase 16);
  - the tracker's path through EventNet: the gradient of a fixed cotangent of
    ``inference_event`` with respect to the rendered image, batch 1 at
    102x180;
  - one tracked frame (``track_frame``, ten iterations through both decode
    kernels, ``chip_smoke.py`` phase 8's call);
and ten steps at 36x48 (the shipped net's recipe), with their times (a
training step by CUDA events, a tracked frame and the gradient on the host
clock around a synchronise; as the port runs, also the device time under
torch.profiler), under four settings: as the port runs (``setup_torch``:
cuDNN picks its algorithms by timing them, among the deterministic ones;
EventNet's x2 upsample with its backward as two matrix products,
``models/eventnet.py::upsample2x``), with cuDNN's choice left free
(``cudnn.deterministic`` off), with ``F.interpolate``'s own backward (atomic
adds), and with both (the port before PR 10). The timed choice is made once
a process and cached: a setting that turned ``cudnn.benchmark`` off inside
this process would reuse it, so the heuristic choice is not among them (its
cost: ``scripts/profile_torch_port.py --cudnn-benchmark off``). Then it
runs each piece under ``torch.use_deterministic_algorithms(True)`` (PyTorch
raises at the first op it knows to be nondeterministic, and keeps cuDNN to
deterministic algorithms), times three x2 upsamples (forward + backward, CUDA
events) at the shapes of a training step and of a tracked frame, and prints
a digest of every result: run it twice to compare two processes, in which
cuDNN may time its way to other algorithms. Prints the card's name and power
limit first.
"""

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time

# cuBLAS is deterministic on one stream; without this setting
# use_deterministic_algorithms(True) would raise at the first matrix product
# instead of at the op under test (set before the first cuBLAS call)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from evennicer_slam_tpu_torch.models import eventnet, eventnet_train  # noqa: E402
from evennicer_slam_tpu_torch.slam.tracker import _prep_event_inputs, track_frame  # noqa: E402
from evennicer_slam_tpu_torch.utils.optim import adam_init  # noqa: E402

SETTINGS = ("as_run", "cudnn_choice_free", "atomic_upsample_backward", "neither")


def interpolate_upsample(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def matrices_upsample(x):
    """The x2 upsample as two matrix products both ways (timed only)."""
    n, c, h, w = x.shape
    y = x.reshape(n * c * h, w) @ eventnet._upsample_matrix(w, x.device).T
    y = eventnet._upsample_matrix(h, x.device) @ y.reshape(n * c, h, 2 * w)
    return y.reshape(n, c, 2 * h, 2 * w)


@contextlib.contextmanager
def setting(name):
    up, det = eventnet.upsample2x, torch.backends.cudnn.deterministic
    if name in ("atomic_upsample_backward", "neither"):
        eventnet.upsample2x = interpolate_upsample
    if name in ("cudnn_choice_free", "neither"):
        torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        eventnet.upsample2x, torch.backends.cudnn.deterministic = up, det


def timed(fn, n):
    """(result of the last run, median host ms around a synchronise)."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, float(np.median(ms))


def tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)


def digest(obj):
    h = hashlib.sha1()
    for t in tensors(obj):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def compare(a, b):
    leaves = list(zip(tensors(a), tensors(b)))
    differ = [i for i, (x, y) in enumerate(leaves) if not torch.equal(x, y)]
    return {"bitwise_equal": not differ, "leaves": len(leaves), "leaves_differing": len(differ),
            "max_abs_diff": max((float((leaves[i][0] - leaves[i][1]).abs().max())
                                 for i in differ), default=0.0),
            "digest": digest(a)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    smi = cs.nvidia_smi_line()
    cs.say(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.setup_torch(verbose=False)
    dev = torch.device("cuda")

    batches = cs.pair_batches(cs.EVNET_REPEAT_STEPS, dev)
    # the shape of the shipped net's recipe (event_ablation at 240x320)
    rng = np.random.default_rng(cs.SEED)
    small = [tuple(torch.from_numpy(a).to(dev) for a in eventnet_train.make_pair_batch(
        rng, cs.EVNET_BATCH, (36, 48), eventnet_train.DEFAULT_BOUND))
        for _ in range(cs.EVNET_REPEAT_STEPS)]
    init = eventnet.init_eventnet(torch.Generator().manual_seed(cs.SEED), device=dev)
    cfg, grids, decoders, packed = cs.make_scene(dev)
    bound_t = torch.from_numpy(cs.BOUND).to(dev)
    mp = cs.main_path_inputs(cfg, bound_t, dev)
    frames = cs.upload_frames(mp.cam, dev, n=2)
    f = frames[1]
    tcfg = mp.tcfg
    _, ev_lo, prev_lo, depth_lo, mask_lo = _prep_event_inputs(
        torch.zeros_like(f.event), f.event, frames[0].color, f.depth, mp.lo_hw,
        tcfg.prev_resize)
    g = torch.Generator(device=dev).manual_seed(3)
    cur = torch.rand(*mp.lo_hw, 3, device=dev, generator=g)
    cot = torch.randn(*mp.lo_hw, 2, device=dev, generator=g)

    def train():
        params, _ = cs.evnet_steps(init, batches, cs.EVNET_REPEAT_STEPS)
        return params

    def train_small():
        params, _ = cs.evnet_steps(init, small, cs.EVNET_REPEAT_STEPS)
        return params

    def input_grad():
        x = cur.clone().requires_grad_(True)
        ev, _ = eventnet.inference_event(mp.eventnet, prev_lo, x)
        return torch.autograd.grad((ev * cot).sum(), x)[0]

    def tracked_frame():
        cam, _, losses, _ = track_frame(
            frames[0].c2w, torch.eye(4, device=dev), decoders, packed, mp.eventnet,
            bound_t, torch.Generator(device=dev).manual_seed(1), f.color, f.depth,
            ev_lo, prev_lo, depth_lo, mask_lo, torch.zeros(7, device=dev), 1.0,
            tcfg, mp.cam, mp.settings, rgbd=False, event=True, const_speed=False,
            device=dev)
        return [cam, losses["event"]]

    def train_step_ms():
        params, state = init, adam_init(init)
        marks = []
        for step in range(cs.EVNET_REPEAT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, state, _ = eventnet_train.train_step(params, state, *batches[step],
                                                         cs.EVNET_LR)
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in marks]))

    pieces = (("training_10_steps", train), ("training_10_steps_36x48", train_small),
              ("tracker_input_gradient", input_grad), ("tracked_frame", tracked_frame))
    res = {"device": smi, "runs": {}}
    for name in SETTINGS:
        with setting(name):
            out = {}
            for label, fn in pieces:
                fn()  # warm-up: cuDNN times its algorithms on first sight of a shape
                a, ms = timed(fn, 2)
                b = fn()
                torch.cuda.synchronize()
                out[label] = {**compare(a, b), "ms": ms}
            out["train_step_ms_cuda_events"] = train_step_ms()
            if name == "as_run":
                # device time (torch.profiler), hidden or not behind the host
                out["device_ms"] = {
                    label: sum(ms for ms, _ in cs._device_ms(fn, 1)[0].values())
                    for label, fn in pieces}
            res["runs"][name] = out
            cs.say(f"{name}: " + json.dumps(out))

    # the ops that PyTorch itself knows to be nondeterministic: in
    # use_deterministic_algorithms(True) the first one raises, naming itself;
    # what does not raise runs twice and is compared
    named = {}
    for name in ("as_run", "atomic_upsample_backward"):
        with setting(name):
            for label, fn in pieces:
                torch.use_deterministic_algorithms(True)
                try:
                    a = fn()
                    b = fn()
                    torch.cuda.synchronize()
                    named[f"{name}/{label}"] = {"raised": None, **compare(a, b)}
                except RuntimeError as e:
                    named[f"{name}/{label}"] = {
                        "raised": str(e).split(" does not have")[0].strip()[:200]}
                finally:
                    torch.use_deterministic_algorithms(False)
    res["use_deterministic_algorithms"] = named
    cs.say("use_deterministic_algorithms(True): " + json.dumps(named))

    # three x2 upsamples at the shapes of a training step (batch 4) and of a
    # tracked frame (batch 1): agreement and cost
    times = []
    for n in (cs.EVNET_BATCH, 1):
        for c, h, w in ((512, 6, 11), (256, 12, 22), (128, 25, 45), (64, 51, 90)):
            x = torch.randn(n, c, h, w, device=dev, requires_grad=True)
            gy = torch.randn(n, c, 2 * h, 2 * w, device=dev)
            rows = {}
            for label, up in (("interpolate", interpolate_upsample),
                              ("port", eventnet.upsample2x), ("matrices", matrices_upsample)):
                def fwd_bwd(up=up):
                    y = up(x)
                    return y, torch.autograd.grad(y, x, gy)[0]

                rows[label] = (fwd_bwd(), cs.cuda_ms(fwd_bwd, 20, warmup=2))
            (y0, g0), _ = rows["interpolate"]
            times.append({"shape": [n, c, h, w]} | {
                f"{k}_fwd_bwd_ms": ms for k, (_, ms) in rows.items()} | {
                f"{k}_max_abs_diff": [float((y - y0).detach().abs().max()),
                                      float((g - g0).abs().max())]
                for k, ((y, g), _) in rows.items() if k != "interpolate"})
    res["upsample"] = times
    cs.say("x2 upsample, forward + backward: " + json.dumps(times))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    cs.say(smi)
    cs.say(json.dumps(res))


if __name__ == "__main__":
    main()
