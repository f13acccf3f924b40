"""EvenNICER-SLAM pipeline: the tracker and the mapper interleaved in one
process under the strict schedule (counterpart of
``evennicer_slam_tpu/slam/pipeline.py``).

Under ``sync_method: strict`` the reference's three processes run exactly in
sequence: map frame 0, then track frame k, and map whenever
``k % every_frame == 0`` before tracking k + 1. This pipeline runs that
schedule directly, the map handed to the tracker as plain data.

What overlaps is the host and the device: every per-frame quantity (tracked
pose, losses, event integrals) stays on the device; frames are decoded and
uploaded one frame ahead on a worker thread (``data/prefetch.py``); metrics
are read back in deferred batches, one copy a batch; a steady mapping call
takes the tracker's device pose; the host is held back only by an event
``MAX_INFLIGHT_MAPS`` mapping calls old. In steady state the host enqueues
work and does not wait for the device.

Not ported yet, and raising ``NotImplementedError`` before the first frame:
``sync_method: loose|free``, ``parallel.map_devices`` and data parallelism
(ROADMAP Queue 1 item 5), iMAP (``nice=False``, item 3), the visualiser
(``enable_vis``, item 4) and the mesher (``run(mesh=True)``, item 2).
"""

from __future__ import annotations

import os
import sys
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from evennicer_slam_tpu_torch.config import get_model
from evennicer_slam_tpu_torch.data.datasets import get_dataset
from evennicer_slam_tpu_torch.data.prefetch import PrefetchingReader
from evennicer_slam_tpu_torch.models.eventnet import (
    init_eventnet,
    load_eventnet_npz,
    load_eventnet_torch,
)
from evennicer_slam_tpu_torch.models.grids import init_grids
from evennicer_slam_tpu_torch.models.pretrained import load_pretrained_decoders
from evennicer_slam_tpu_torch.render.renderer import RenderSettings
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.mapper import Mapper, MapperConfig
from evennicer_slam_tpu_torch.slam.tracker import Tracker, TrackerConfig
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
from evennicer_slam_tpu_torch.utils.runtime import resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import MetricsLogger, PhaseTimers

ROADMAP_CONCURRENCY = "ROADMAP Queue 1 item 5 (concurrency and multi-GPU)"
# steady mapping calls the host may run ahead of the device
MAX_INFLIGHT_MAPS = 4


def load_scene_bound(cfg) -> np.ndarray:
    """Scene bound scaled and rounded up to ``grid_len.bound_divisible``."""
    scale = cfg["scale"]
    bound = np.array(cfg["mapping"]["bound"], np.float64) * scale
    bd = cfg["grid_len"]["bound_divisible"]
    bound[:, 1] = (((bound[:, 1] - bound[:, 0]) / bd).astype(int) + 1) * bd + bound[:, 0]
    return bound.astype(np.float32)


def check_supported(cfg: Dict[str, Any], nice: bool) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP item that ports it,
    for a configuration this port cannot run yet."""
    sync = cfg.get("sync_method", "strict")
    if sync != "strict":
        raise NotImplementedError(f"sync_method {sync!r}: only 'strict' is ported; "
                                  f"loose/free come with {ROADMAP_CONCURRENCY}")
    par = cfg.get("parallel", {})
    if par.get("map_devices", 0):
        raise NotImplementedError(f"parallel.map_devices: {ROADMAP_CONCURRENCY}")
    dp = par.get("data_parallel", "auto")
    if dp != "auto" and int(dp) > 1:
        raise NotImplementedError(f"parallel.data_parallel {dp}: {ROADMAP_CONCURRENCY}")
    if not nice:
        raise NotImplementedError("nice=False (iMAP): ROADMAP Queue 1 item 3 "
                                  "(the non-Fourier embeddings and iMAP)")
    if cfg.get("enable_vis", True):
        raise NotImplementedError(
            "enable_vis: the visualiser is not ported (ROADMAP Queue 1 item 4); "
            "set enable_vis: false, as bench.py does")


def _seeds(seed: int, n: int):
    """``n`` independent generator seeds from one configuration seed."""
    return [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]


class EvenNICERSLAM:
    """Allocates the scene state, builds the dataset reader, tracker and
    mapper, and runs the strict interleaved schedule. ``device=None`` means
    the CUDA device."""

    def __init__(self, cfg: Dict[str, Any], args=None, nice: bool = True, device=None):
        check_supported(cfg, nice)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.coarse = cfg["coarse"] and nice
        self.verbose = cfg.get("verbose", False)

        out = getattr(args, "output", None) if args else None
        self.output = out or cfg["data"]["output"]
        self.logger = CheckpointLogger(os.path.join(self.output, "ckpts"), verbose=self.verbose)

        self.cam = Camera.from_cfg(cfg)
        self.bound = load_scene_bound(cfg)
        self.settings = RenderSettings.from_cfg(cfg, nice=nice)

        # separate streams for the grids, the decoders and EventNet; drawn
        # on the host, so a CPU run starts from the card's map
        g_grid, g_dec, g_ev = (torch.Generator().manual_seed(s)
                               for s in _seeds(int(cfg.get("seed", 42)), 3))
        dev = self.device
        self.grids = init_grids(g_grid, self.bound, cfg["grid_len"], cfg["model"]["c_dim"],
                                self.coarse, cfg["model"]["coarse_bound_enlarge"], device=dev)
        self.decoders = get_model(dict(cfg, coarse=self.coarse), nice=True, generator=g_dec,
                                  device=dev)
        pre = cfg.get("pretrained_decoders", {})
        mf = pre.get("middle_fine")
        if mf and os.path.exists(mf):
            self.decoders = load_pretrained_decoders(
                self.decoders, mf, pre.get("coarse") if self.coarse else None)

        self.frame_reader = PrefetchingReader(get_dataset(cfg, args, cfg["scale"]), device=dev)
        self.n_img = len(self.frame_reader)
        self.use_events = bool(self.frame_reader.has_events and cfg.get("event", {}))

        # EventNet: .npz (the JAX package's) or .pth (the reference's)
        # weights; the analytic predictor ("event.predictor: esim") needs none
        self.eventnet: Dict[str, Any] = {}
        if self.use_events and cfg["event"].get("predictor", "unet") != "esim":
            path = cfg["event"].get("pretrained_path")
            if path and os.path.exists(path):
                load = load_eventnet_npz if path.endswith(".npz") else load_eventnet_torch
                self.eventnet = load(path, device=dev)
            else:
                if path:
                    print(f"[enslam] WARNING: event.pretrained_path {path!r} not found - "
                          "EventNet runs from RANDOM init (throughput unaffected; quality "
                          "meaningless)", file=sys.stderr)
                self.eventnet = init_eventnet(g_ev, device=dev)

        t_cfg = TrackerConfig.from_cfg(cfg, self.use_events)
        m_cfg = MapperConfig.from_cfg(cfg, use_events=cfg.get("mapping", {}).get("use_events",
                                                                                 False))
        # tracking never trains the decoders, so on the card it decodes
        # through the fused kernels; on the CPU the JAX package turns its
        # fused decode off, and so does this port, so that CPU runs of both
        # compare like with like
        fused = dev.type == "cuda"
        self.tracker = Tracker(t_cfg, self.cam, self.settings._replace(fused_decode=fused),
                               self.bound, self.eventnet, device=dev)
        self.mapper = Mapper(m_cfg, self.cam, self.settings, self.bound,
                             eventnet=self.eventnet, device=dev)
        # the coarse level is optimised inside the fine mapper's calls
        self.mapper.fuse_coarse = self.coarse
        self.t_cfg, self.m_cfg = t_cfg, m_cfg

        # poses: recent tracked poses stay on the device until read
        self._est_np = np.zeros((self.n_img, 4, 4), np.float32)
        self._est_dev: Dict[int, torch.Tensor] = {}
        # pinned host copies started as soon as a pose that a synced mapping
        # call will read is tracked: {idx: (host tensor, event)}
        self._host_copies: Dict[int, tuple] = {}
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.idx = 0
        self.mapping_idx = -1
        self.mapping_cnt = 0
        self.pre_gt_color_mapper = None
        # steady mapping calls that took the device pose, and the events of
        # the last ones, which hold the host's run-ahead
        self.n_fast_maps = 0
        self._inflight_maps: deque = deque()
        self.timers = PhaseTimers()

        # event divergence guard: the tracker emits the predicted-vs-GT event
        # correlation each frame; if it stays below guard_corr_threshold for
        # guard_window consecutive event-bearing frames, warn once and
        # (guard_fallback: esim) switch the tracker's predictor to the
        # analytic model. The mapper's predictor stays as it is, as in the
        # JAX package (ROADMAP Queue 3).
        e = cfg.get("event", {}) if self.use_events else {}
        self._guard_enabled = (bool(e.get("guard", True)) and self.use_events
                               and t_cfg.predictor == "unet")
        self._guard_thr = float(e.get("guard_corr_threshold", 0.1))
        self._guard_window = int(e.get("guard_window", 20))
        self._guard_min_energy = float(e.get("guard_min_gt_energy", 1.0))
        self._guard_fallback = e.get("guard_fallback", "warn")
        self._guard_bad_streak = 0
        self.guard_fired = False
        # deferred per-frame metrics: (host part, device part), read back
        # metrics_flush_batch records at a time
        self._metric_queue: list = []
        self._metric_batch = int(cfg.get("metrics_flush_batch", 16))
        self.metrics = MetricsLogger(self.output)

    # ------------------------------------------------------------------
    # poses: device-backed, read back in one copy on access

    @property
    def estimate_c2w_list(self) -> np.ndarray:
        """Estimated trajectory [n_img, 4, 4]. Reading it copies every pose
        still on the device to the host, all in one copy."""
        if self._est_dev:
            idxs = list(self._est_dev)
            mats = torch.stack([self._est_dev[i] for i in idxs]).cpu().numpy()
            self._est_np[idxs] = mats
            self._est_dev.clear()
            self._host_copies.clear()
        return self._est_np

    @estimate_c2w_list.setter
    def estimate_c2w_list(self, value):
        self._est_np = np.asarray(value, np.float32).copy()
        self._est_dev.clear()
        self._host_copies.clear()

    def _set_pose(self, idx: int, c2w):
        self._host_copies.pop(idx, None)
        if isinstance(c2w, torch.Tensor):
            self._est_dev[idx] = c2w
        else:
            self._est_np[idx] = np.asarray(c2w, np.float32)
            self._est_dev.pop(idx, None)

    def _pose(self, idx: int):
        """The pose as it is now: a device tensor while still pending."""
        return self._est_dev.get(idx, self._est_np[idx])

    def _pose_np(self, idx: int) -> np.ndarray:
        p = self._est_dev.pop(idx, None)
        if p is not None:
            staged = self._host_copies.pop(idx, None)
            if staged is not None:
                staged[1].synchronize()
                self._est_np[idx] = staged[0].numpy()
            else:
                self._est_np[idx] = p.cpu().numpy()
        return self._est_np[idx]

    def _stage_host_copy(self, idx: int, c2w: torch.Tensor):
        """Start the copy of a tracked pose to pinned host memory now, so
        that the synced mapping call that reads it finds it there."""
        if c2w.device.type != "cuda":
            return
        host = torch.empty(c2w.shape, dtype=c2w.dtype, pin_memory=True)
        host.copy_(c2w, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._host_copies[idx] = (host, done)

    # ------------------------------------------------------------------
    # deferred metrics

    def _flush_metrics(self, force: bool = False, batch: Optional[int] = None):
        """Log the queued records once ``batch`` (default
        ``metrics_flush_batch``) have gathered, or now with ``force``. The
        device values of the whole batch come back in one copy."""
        if not self._metric_queue:
            return
        batch = self._metric_batch if batch is None else batch
        if not force and len(self._metric_queue) < batch:
            return
        pending, self._metric_queue = self._metric_queue, []
        dev_vals = [v.detach().reshape(-1).double() for _, d in pending
                    for v in d.values() if isinstance(v, torch.Tensor)]
        flat = torch.cat(dev_vals).cpu().numpy() if dev_vals else np.zeros(0)
        pos = 0
        for rec, dev in pending:
            for k, v in dev.items():
                if isinstance(v, torch.Tensor):
                    n, ndim = v.numel(), v.ndim
                    v = flat[pos:pos + n]
                    pos += n
                else:
                    v = np.asarray(v, np.float64)
                    n, ndim = v.size, v.ndim
                    v = v.reshape(-1)
                if ndim == 0:
                    rec[k] = float(v[0])
                elif n > 0:  # e.g. a 0-iteration tracking configuration
                    rec[f"{k}_first"] = float(v[0])
                    rec[f"{k}_last"] = float(v[-1])
            self.metrics.log(rec)
            self._event_guard(rec)

    def _event_guard(self, rec: Dict[str, Any]):
        """Detect a diverging (out-of-domain) EventNet from the flushed
        per-frame metrics: the correlation of the prediction with the GT
        events at the last tracking iteration. It reads nothing of its own
        from the device, so it lags tracking by up to a metrics batch."""
        if not self._guard_enabled or self.guard_fired:
            return
        corr = rec.get("tracking/event_corr_last")
        energy = rec.get("tracking/event_gt_energy_last")
        if corr is None or energy is None or energy < self._guard_min_energy:
            return  # no events, or none to correlate against
        if corr >= self._guard_thr:
            self._guard_bad_streak = 0
            return
        self._guard_bad_streak += 1
        if self._guard_bad_streak < self._guard_window:
            return
        self.guard_fired = True
        fall = self._guard_fallback == "esim"
        print(
            f"[enslam] EVENT GUARD: EventNet prediction has correlated "
            f"< {self._guard_thr} with GT events for {self._guard_bad_streak} consecutive "
            f"event frames (through frame {rec.get('frame')}) — the net looks out-of-domain "
            "and its loss is steering the pose. "
            + ("Falling back to the analytic esim predictor." if fall else
               "Set event.guard_fallback: esim to auto-switch, or retrain "
               "with tools/train_eventnet.py / event.predictor: esim."),
            file=sys.stderr,
        )
        self.metrics.log({"frame": rec.get("frame"), "event_guard_fired": 1,
                          "fallback": self._guard_fallback})
        if fall:
            self.tracker.cfg = self.tracker.cfg._replace(predictor="esim")
            self.t_cfg = self.tracker.cfg

    # ------------------------------------------------------------------

    def _integrated_event(self, idx: int):
        """Sum of the last ``every_frame`` GT event frames ending at ``idx``.
        At a window boundary the tracker has accumulated exactly this sum on
        the device and hands it off (consumed once); an out-of-cadence call
        (the final frame's colour refinement) sums its own window from the
        reader."""
        handoff = self.tracker.consume_event_handoff(idx)
        if handoff is not None:
            return handoff
        total = None
        for i in range(self.m_cfg.every_frame):
            if idx - i < 0:
                break
            ev = self.frame_reader[idx - i].event
            total = ev if total is None else total + ev
        return total

    def _async_map_ok(self) -> bool:
        """True when a steady mapping call can take the tracker's DEVICE pose
        without the host ever reading it: pose-free selection (at most one
        keyframe, or 'global') with BA unable to turn on, or overlap
        selection with a grown registry (the mapper's device selection,
        assembly and BA write-back). Per-window keyframe logging always
        takes the host path."""
        if self.mapper.cfg.save_selected_keyframes_info:
            return False
        kf_count = len(self.mapper.keyframes)
        if self.mapper.selection == "overlap" and kf_count > 1:
            return True
        pose_free = kf_count <= 1 or self.mapper.selection == "global"
        return pose_free and not (self.mapper.cfg.BA and kf_count > 4)

    def _map_frame(self, idx: int, frame, init: bool, color_refine: bool = False,
                   images_dev=None):
        m = self.m_cfg
        gt_event_int = self._integrated_event(idx) if self.use_events else frame.event
        # steady state: the call takes the tracker's device pose; otherwise
        # one pose read a call
        fast = not init and not color_refine and self._async_map_ok()
        if fast:
            self.n_fast_maps += 1
            cur_c2w = self._pose(idx)
            if isinstance(cur_c2w, np.ndarray):
                cur_c2w = cur_c2w.copy()
        else:
            cur_c2w = self._pose_np(idx).copy()

        if init:
            outer, num_iters, lr_factor = 1, m.iters_first, m.lr_first_factor
        elif color_refine:
            outer, num_iters, lr_factor = 5, m.iters, m.lr_factor
        else:
            outer, num_iters, lr_factor = 1, m.iters, m.lr_factor

        mapper = self.mapper
        mapper.update_ba_state()
        # the final colour refinement doubles the mapper's window
        old_cfg = mapper.cfg
        if color_refine:
            mapper.cfg = old_cfg._replace(window_size=old_cfg.window_size * 2)
        for outer_it in range(outer):
            self.grids, self.decoders, new_c2w = mapper.optimize_map(
                num_iters, lr_factor, idx, frame.color, frame.depth, gt_event_int,
                cur_c2w, pre_gt_color=self.pre_gt_color_mapper,
                color_refine=color_refine, seed=idx * 97 + outer_it,
                grids=self.grids, decoders=self.decoders, cur_images_dev=images_dev)
            if new_c2w is not None:
                cur_c2w = new_c2w
                self._set_pose(idx, new_c2w)
        mapper.cfg = old_cfg
        # a device pose joins the registry without a read-back
        mapper.maybe_add_keyframe(idx, self.n_img, frame.color, frame.depth,
                                  frame.event, cur_c2w, frame.c2w,
                                  device_images=images_dev)

        self.mapping_idx = idx
        self.mapping_cnt += 1
        self.pre_gt_color_mapper = images_dev[0] if images_dev is not None else frame.color
        if fast and self.device.type == "cuda":
            # hold the host's run-ahead: with no pose read, nothing else
            # paces it, and each call in flight holds its own grids and
            # window buffers on the device. Waiting for the call
            # MAX_INFLIGHT_MAPS calls back waits, in steady state, for work
            # already done, so the device queue never runs dry.
            done = torch.cuda.Event()
            done.record()
            self._inflight_maps.append(done)
            while len(self._inflight_maps) > MAX_INFLIGHT_MAPS:
                self._inflight_maps.popleft().synchronize()

    def step(self, idx: int) -> bool:
        """Process frame ``idx`` through the strict schedule; returns whether
        it was mapped. In steady state this only enqueues device work: the
        frame was uploaded ahead of time by the reader's worker thread."""
        frame, dev = self.frame_reader.get_with_device(idx)
        self.gt_c2w_list[idx] = frame.c2w
        gt_color, gt_depth, gt_event = dev

        if idx == 0 or self.t_cfg.gt_camera:
            self._set_pose(idx, frame.c2w)
            if idx == 0:
                if self.use_events:
                    self.tracker.reset_event_integration(frame.event.shape)
                with self.timers.phase("map"):
                    self._map_frame(idx, frame, init=True, images_dev=(gt_color, gt_depth))
                self.tracker.pre_gt_color = gt_color
        else:
            with self.timers.phase("track"):
                c2w = self.tracker.track(
                    idx, gt_color, gt_depth, gt_event, self._pose(idx - 1),
                    self._pose(idx - 2) if idx >= 2 else None,
                    self.decoders, self.grids, seed=idx)
                self._set_pose(idx, c2w)
                boundary = idx % self.m_cfg.every_frame == 0 or idx == self.n_img - 1
                if boundary and (idx == self.n_img - 1 or not self._async_map_ok()):
                    # a synced mapping call (or the final colour refinement)
                    # will read this pose
                    self._stage_host_copy(idx, c2w)

        self.tracker.end_of_window(idx, gt_color, self.m_cfg.every_frame)

        # per-frame metrics; the device parts are read back in batches
        dev_rec = {f"tracking/{k}": v for k, v in self.tracker.last_losses.items()}
        dev_rec["mapping/loss"] = self.mapper.last_loss
        self._metric_queue.append(({"frame": idx}, dev_rec))
        self._flush_metrics()

        mapped = False
        if idx != 0 and idx % self.m_cfg.every_frame == 0:
            with self.timers.phase("map"):
                self._map_frame(idx, frame, init=False, images_dev=(gt_color, gt_depth))
            mapped = True
        if idx == self.n_img - 1:
            if self.m_cfg.color_refine:
                with self.timers.phase("map"):
                    self._map_frame(idx, frame, init=False, color_refine=True,
                                    images_dev=(gt_color, gt_depth))
            mapped = True
        self.idx = idx
        return mapped

    def run(self, end_frame: Optional[int] = None, mesh: bool = True, checkpoint: bool = True,
            start_frame: int = 0) -> np.ndarray:
        """The whole sequence; ``start_frame > 0`` resumes after
        ``CheckpointLogger.restore``. Checkpoints every ``ckpt_freq`` mapped
        frames and after the last. ``mesh=True`` raises before the first
        frame: the mesher is not ported (ROADMAP Queue 1 item 2)."""
        if mesh:
            raise NotImplementedError("meshing: the mesher is not ported (ROADMAP Queue 1 "
                                      "item 2); run(mesh=False)")
        n = self.n_img if end_frame is None else min(end_frame, self.n_img)
        ckpt_freq = self.cfg["mapping"].get("ckpt_freq", 500)
        for idx in range(start_frame, n):
            mapped = self.step(idx)
            if self.verbose:
                # host time spent enqueueing each phase: the device runs behind
                t = self.timers.total
                print(f"[enslam] frame {idx}/{n} track_dispatch={t['track']:.1f}s "
                      f"map_dispatch={t['map']:.1f}s")
            if mapped and checkpoint and idx > 0 and idx % ckpt_freq == 0:
                self.mapper.keyframes.sync_host_poses()
                self.logger.log(self, idx)
        self._flush_metrics(force=True)
        self.mapper.keyframes.sync_host_poses()
        if checkpoint:
            self.logger.log(self, n - 1)
        return self.estimate_c2w_list
