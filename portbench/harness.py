"""One run of one cell: set-up, the measured window, the trace, the check.

The run drives the port's normal entry, ``EvenNICERSLAM.step(idx)``, on one
card under the strict schedule, over the benchmark's scene as the port's
own reader and prefetch thread read it from disk.

Set-up (all of it counted in ``setup_s``): the scene's files (first run in
a checkout only), the EventNet weights drawn from the seed, the pipeline,
the warm frames (frame 0's first mapping call, then tracked frames to the
first steady call), the keyframe registry grown by hand where the mix says
so, the warm periods, and the checked period (see ``check.py``).

The window opens at a mapping-period boundary after a synchronise, and
closes at the first boundary after ``seconds``, after the one synchronise
that ends it; it holds whole periods. Inside it the harness adds no host
synchronisation: the tracking spans are CUDA events, read afterwards.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from portbench import cells, check, scene, spans, work

FORBIDDEN = ("jax", "jaxlib", "flax", "evennicer_slam_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _update(d: Dict, u: Dict):
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _update(d[k], v)
        else:
            d[k] = v


def card() -> Dict[str, Any]:
    """The card's name and power limit (``nvidia-smi``, where it answers)."""
    import subprocess

    info = {"kind": torch.cuda.get_device_name(0), "power_limit": "unknown"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def write_eventnet(path: str, seed: int, device) -> str:
    """EventNet's weights drawn on the card from ``seed`` (He-normal
    convolutions, identity BatchNorm statistics), written as the ``.npz``
    layout that the port and the reference both read."""
    from portbench.reference.models.eventnet import _param_names, init_eventnet

    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    params = init_eventnet(gen, device=device)
    flat = {}
    for name in _param_names():
        node = params
        for part in name:
            node = node[part]
        flat["eventnet." + ".".join(name)] = node.detach().cpu().numpy().astype(np.float32)
    np.savez(path, **flat)
    return path


def mix_config(config: Dict, traffic: Dict) -> Dict:
    """The configuration with the mix's overrides, before the scene's fragment."""
    cfg = copy.deepcopy(config["config"])
    _update(cfg, copy.deepcopy(traffic.get("cfg_overrides", {})))
    return cfg


def run_config(config: Dict, traffic: Dict, frag: Dict, out_dir: str, seed: int) -> Dict:
    cfg = mix_config(config, traffic)
    _update(cfg, copy.deepcopy(frag))
    cfg["data"]["output"] = os.path.join(out_dir, "output")
    cfg["seed"] = seed
    return cfg


def p90(values):
    """The 90th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 90))


class Run:
    """Everything one run of a cell holds."""

    def __init__(self, cell: Dict, seed: int, seconds: int, trace: bool, t0: float,
                 root: str = cells.ROOT, device: str = "cuda", overrides: Optional[Dict] = None,
                 packed: Optional[bool] = None):
        """``device``, ``overrides`` ({"config": ..., "traffic": ...},
        merged over the files) and ``packed`` (the tracker's packed decode
        on or off, where the program would choose by the device) are for
        the CPU tests of the harness: a measured run takes none of them."""
        self.cell, self.seed, self.seconds, self.trace, self.t0 = cell, seed, seconds, trace, t0
        self.root = root
        bench = cells.load_benchmark(root)
        self.bench = bench
        self.config = cells.config(bench, cell["config"], root)
        self.traffic = cells.traffic(cell["traffic"])
        for key, target in (("config", self.config["config"]), ("traffic", self.traffic)):
            _update(target, copy.deepcopy((overrides or {}).get(key, {})))
        self.nice = bool(self.config["nice"])
        self.packed = packed
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def setup(self, fault: Optional[str] = None):
        """``fault`` (a name of ``faults.FAULTS``) is planted in the program
        for the checked period: for the readings of the check's limits."""
        from evennicer_slam_tpu_torch.models import decoders as dec_mod
        from evennicer_slam_tpu_torch.slam import mapper as map_mod
        from evennicer_slam_tpu_torch.slam import tracker as track_mod
        from evennicer_slam_tpu_torch.slam.pipeline import EvenNICERSLAM
        from evennicer_slam_tpu_torch.utils.runtime import setup_torch

        tr = self.traffic
        frag = scene.write_scene(os.path.join(self.root, "build", "portbench"),
                                 scene.recorded(tr["scene"], mix_config(self.config, tr)),
                                 self.device)
        # the run's own directory under TMPDIR (the system's where it is
        # unset), removed when the run ends
        self.out_dir = tempfile.mkdtemp(prefix=f"portbench-{self.cell['name']}-")
        cfg = run_config(self.config, tr, frag, self.out_dir, self.seed)
        self.eventnet_path = None
        if check.uses_events(cfg):
            self.eventnet_path = write_eventnet(os.path.join(self.out_dir, "eventnet.npz"),
                                                self.seed, self.device)
            cfg["event"]["pretrained_path"] = self.eventnet_path
        self.cfg = cfg
        if self.cuda:
            setup_torch(verbose=False)
        self.slam = slam = EvenNICERSLAM(cfg, nice=self.nice, device=self.device)
        if self.packed is not None:
            slam.tracker.settings = slam.tracker.settings._replace(fused_decode=self.packed)
        m = cfg["model"]
        self.ins = spans.Instruments(
            slam, {"decoders": dec_mod, "tracker": track_mod, "mapper": map_mod},
            c_dim=m["c_dim"], hidden=32).install()
        self.every = slam.m_cfg.every_frame
        idx = 0
        for _ in range(tr["warm_frames"]):
            slam.step(idx)
            idx += 1
        if tr.get("grow_keyframes"):
            for kf in tr["grow_keyframes"]:
                f = slam.frame_reader[kf]
                slam.mapper.keyframes.append(kf, f.color, f.depth, np.asarray(f.event),
                                             f.c2w.copy(), f.c2w)
            slam.mapper.update_ba_state()
        idx = self._periods(idx, tr["warm_periods"])
        self.capture = check.Capture()
        self.ins.capture = self.capture
        if fault is None:
            idx = self._periods(idx, tr["checked_periods"])
        else:
            from portbench.faults import planted

            # the wrappers go outside the fault, so that the capture sees what
            # the broken call returns
            self.ins.remove()
            with planted(fault, {"tracker": track_mod, "mapper": map_mod,
                                 "decoders": dec_mod}):
                self.ins.install()
                idx = self._periods(idx, tr["checked_periods"])
                self.ins.remove()
            self.ins.install()
        self.ins.capture = None
        self.capture.release()
        self.idx = idx

    def _periods(self, idx: int, n: int) -> int:
        for _ in range(n):
            while True:
                mapped = self.slam.step(idx)
                idx += 1
                if mapped:
                    break
        return idx

    def window(self):
        """The measured window. A ``--trace 1`` run first runs untraced as a
        ``--trace 0`` run's whole window does, closed by a synchronise, then
        traces ``device_periods`` with the card alone (kernels and copies:
        the idle share and the arithmetic), then ``span_periods`` with the
        host too (the annotations and the launches inside them; the host
        runs slower under it), each stretch between two synchronises."""
        slam, ins, tr = self.slam, self.ins, self.traffic
        acts = torch.profiler.ProfilerActivity
        plan = []
        if self.trace:
            plan = [("device", tr["device_periods"], [acts.CUDA]),
                    ("span", tr["span_periods"], [acts.CPU, acts.CUDA])]
        # the collector's later passes skip what set-up made
        gc.collect()
        gc.freeze()
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t0
        self.traced = {}
        ins.window = self.cuda
        idx, frames, periods = self.idx, 0, 0
        self.first_frame = idx
        t_open = time.perf_counter()
        self.period_ends = []
        stage = None
        # the untraced stretch, a --trace 0 run's whole window: (its seconds,
        # to a synchronise; its frames; its tracked frames)
        self.untraced_end = None
        while True:
            mapped = slam.step(idx)
            idx += 1
            frames += 1
            if not mapped:
                continue
            periods += 1
            self.period_ends.append(time.perf_counter() - t_open)
            if stage is not None:
                stage["left"] -= 1
                if stage["left"] == 0:
                    self._trace_stop(stage)
                    stage = self._trace_start(plan)
                    if stage is None:
                        break
            elif time.perf_counter() - t_open >= self.seconds:
                if not plan:
                    break
                self.sync()
                self.untraced_end = (time.perf_counter() - t_open, frames,
                                     len(ins.track_events))
                stage = self._trace_start(plan)
        self.sync()
        self.window_s = time.perf_counter() - t_open
        if self.untraced_end is None:
            self.untraced_end = (self.window_s, frames, len(ins.track_events))
        ins.window = False
        self.frames, self.periods, self.last_frame = frames, periods, idx
        self.peak_bytes = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.track_ms = [s.elapsed_time(e) for s, e in ins.track_events]
        self.map_ms = [s.elapsed_time(e) for s, e in ins.map_events]
        self.poses_finite = [bool(np.isfinite(slam._pose_np(i)).all())
                             for i in range(self.first_frame, idx)]

    def _trace_start(self, plan):
        if not plan:
            return None
        name, periods, activities = plan.pop(0)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self.sync()
        setattr(self.ins, "counting" if name == "device" else "spanning", True)
        return {"name": name, "left": periods, "prof": prof, "ns": time.time_ns()}

    def _trace_stop(self, stage):
        self.sync()
        ns = (stage["ns"], time.time_ns())
        self.ins.counting = self.ins.spanning = False
        stage["prof"].stop()
        self.traced[stage["name"]] = (stage["prof"].profiler.kineto_results.events(), ns)

    def untraced(self) -> Dict[str, Any]:
        """The window's untraced stretch: its frames, its seconds (to the
        synchronise that closes it) and each of its tracked frames' span on
        the device."""
        seconds, frames, tracked = self.untraced_end
        return {"frames": frames, "seconds": seconds, "track_ms": self.track_ms[:tracked]}

    def layer_metrics(self) -> Dict[str, Any]:
        """Per-layer readings of the traced periods: each metric's reader
        takes what it needs from the two traces and the counters."""
        import threading

        from portbench.trace import Trace

        main = threading.get_native_id()
        dev_events, (lo, hi) = self.traced.pop("device")
        device = Trace.from_events(dev_events, main)
        span_events, span_ns = self.traced.pop("span")
        spans_trace = Trace.from_events(span_events, main)
        del dev_events, span_events
        reading = {
            "device_trace": device, "window_ns": (lo, hi), "window_s": (hi - lo) * 1e-9,
            "trace": spans_trace,
            "flops": dict(self.ins.flops), "imap_flops": self.ins.imap_flops,
            "decode": self.ins.decode_vertices(), "frame_wait_s": list(self.ins.frame_wait_s),
            "n_track": self.ins.n_track, "c_dim": self.cfg["model"]["c_dim"], "hidden": 32,
            "untraced": self.untraced(),
        }
        self.busy_s = sum(e - s for s, e in device.busy(lo, hi)) * 1e-9
        self.traced_s = (hi - lo) * 1e-9
        out = {}
        for m in cells.cell_metrics(self.bench, self.cell["name"], "per_layer"):
            value = cells.reader(m["name"])(reading)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        self.breakdown = {"device_ops": device.device_ops(lo, hi),
                          "idle_gaps": spans_trace.idle_gaps(*span_ns)}
        return out

    def cleanup(self):
        """Remove the run's own directory."""
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def free_program(self):
        self.ins.remove()
        self.slam.frame_reader._join()
        del self.slam
        self.ins.slam = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def correctness(self):
        ref = check.Reference(self.cfg, self.nice, self.eventnet_path, self.device,
                              packed=self.packed)
        followed = check.follow(self.capture, ref)
        nums = check.numbers(self.capture, followed)
        return check.verdict(nums, check.limits(self.cell["name"]))


def execute(workload: str, seed: int, seconds: int, trace: bool, t0: float) -> int:
    bench = cells.load_benchmark()
    cell = cells.workload(bench, workload)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    info = card()
    print(f"portbench: {workload} seed {seed} on {info['kind']}, power limit "
          f"{info['power_limit']} (peaks held against: {work.PEAK_POWER_W:.0f} W)", flush=True)
    run = Run(cell, seed, seconds, trace, t0)
    run.setup()
    run.window()
    metrics: Dict[str, Any] = {}
    breakdown = None
    if trace:
        metrics = run.layer_metrics()
        breakdown = run.breakdown
    else:
        values = {"fps": run.frames / run.window_s,
                  "track_p90_ms": p90(run.track_ms),
                  "peak_mem_gib": run.peak_bytes / 2 ** 30,
                  "setup_s": run.setup_s}
        for m in cells.cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        print(f"portbench: window {run.window_s:.3f} s, {run.frames} frames in "
              f"{run.periods} periods, track_p90_ms over {len(run.track_ms)} tracked frames "
              f"(median {statistics.median(run.track_ms):.3f} ms)", flush=True)
        # where a run's time went, for the spread between runs: each mapping
        # call's span on the device and each period's end on the host clock
        print("portbench: map_span_ms " + json.dumps([round(v, 3) for v in run.map_ms])
              + " period_end_s " + json.dumps([round(v, 3) for v in run.period_ends]),
              flush=True)
    failed = sum(not f for f in run.poses_finite)
    run.free_program()
    t_ref = time.perf_counter()
    correct, rows = run.correctness()
    run.cleanup()
    print(f"portbench: setup_s {run.setup_s:.3f}, window {run.window_s:.3f} s, reference "
          f"{time.perf_counter() - t_ref:.3f} s, whole run {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": info["kind"], "count": 1,
              "memory_peak_bytes": int(run.peak_bytes)}
    if trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.traced_s
    result = {"correct": bool(correct), "attempted": run.frames, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
