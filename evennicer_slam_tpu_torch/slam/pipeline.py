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

``run`` meshes the map every ``mesh_freq`` mapped frames and at the end
(``mesh/mesher.py``): between frames, since meshing reads data-dependent
shapes back to the host.

``nice=False`` runs iMAP: no grids, the single MLP of ``get_model``, no
pretrained decoders and no coarse term; the tracker decodes through the
plain ops (the fused kernels cover the NICE trio only); a steady mapping
call is three calls of ``iters // 3`` iterations, and the sequence's end
has no colour refinement.

``enable_vis`` (the shipped default) writes the visualiser's panels
(``utils/visualizer.py``): tracking panels every ``tracking.vis_freq``-th
frame, mapping panels inside every ``mapping.vis_freq``-th frame's mapping
call, none of those for an output directory named ``Demo``.

Devices are a list of slots (``devices``; default: every CUDA device when
``device`` is CUDA, else ``device`` alone), which may repeat one device:
``["cpu"] * 8`` is the counterpart of the JAX package's eight virtual CPU
devices. ``parallel.data_parallel`` splits the rays of every render over the
first n slots (``parallel/sharding.py``).

``sync_method: loose|free`` with ``parallel.map_devices`` k and at least
k + 1 slots run the tracker and the mapper on two slot groups
(``concurrent_groups``): the mapper's calls are enqueued on the map group's
lead device, the tracker's on the track group's, each with ray dp over its
own group. The tracker adopts each COMPLETED mapping call by a snapshot
(``_adopt_pending_map``, the reference's ``update_para_from_mapping``): a
``torch.cuda.Event`` recorded after the call was enqueued says when it has
completed (on the CPU every call has completed when it returns). The
reference's lag bound holds in ``_loose_wait``. The schedule is the JAX
package's, single-threaded: the host enqueues a mapping call's launches
while the tracker waits. Otherwise loose / free run the strict schedule, as
the JAX package's do on one device group.
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
from evennicer_slam_tpu_torch.mesh.mesher import Mesher
from evennicer_slam_tpu_torch.models.eventnet import (
    inference_event,
    init_eventnet,
    load_eventnet_npz,
    load_eventnet_torch,
)
from evennicer_slam_tpu_torch.models.grids import init_grids
from evennicer_slam_tpu_torch.models.pretrained import load_pretrained_decoders
from evennicer_slam_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from evennicer_slam_tpu_torch.parallel.sharding import (
    as_slots,
    concurrent_groups,
    default_slots,
    pipeline_dp_devices,
    replicate,
)
from evennicer_slam_tpu_torch.render.renderer import Renderer, RenderSettings
from evennicer_slam_tpu_torch.slam.camera import Camera
from evennicer_slam_tpu_torch.slam.mapper import Mapper, MapperConfig
from evennicer_slam_tpu_torch.slam.tracker import Tracker, TrackerConfig, esim_predict
from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger
from evennicer_slam_tpu_torch.utils.runtime import resolve_device
from evennicer_slam_tpu_torch.utils.telemetry import TRACER, MetricsLogger
from evennicer_slam_tpu_torch.utils.visualizer import Visualizer

# steady mapping calls the host may run ahead of the device
MAX_INFLIGHT_MAPS = 4


def load_scene_bound(cfg) -> np.ndarray:
    """Scene bound scaled and rounded up to ``grid_len.bound_divisible``."""
    scale = cfg["scale"]
    bound = np.array(cfg["mapping"]["bound"], np.float64) * scale
    bd = cfg["grid_len"]["bound_divisible"]
    bound[:, 1] = (((bound[:, 1] - bound[:, 0]) / bd).astype(int) + 1) * bd + bound[:, 0]
    return bound.astype(np.float32)


def _seeds(seed: int, n: int):
    """``n`` independent generator seeds from one configuration seed."""
    return [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]


class EvenNICERSLAM:
    """Allocates the scene state, builds the dataset reader, tracker and
    mapper, and runs the interleaved schedule. ``device=None`` means the
    CUDA device; ``devices`` lists the device slots (default: every CUDA
    device when ``device`` is CUDA, else ``device`` alone).

    ``tracer`` is the process's span tracer (``utils/telemetry.py``): off
    unless ``verbose`` turns it on, ``tracer.enable()`` is called, or a
    ``torch.profiler`` session records."""

    tracer = TRACER

    def __init__(self, cfg: Dict[str, Any], args=None, nice: bool = True, device=None,
                 devices=None):
        self.device = resolve_device(device)
        self.devices = default_slots(self.device) if devices is None else as_slots(devices)
        self.sync_method = cfg.get("sync_method", "strict")
        # sync_method loose / free + parallel.map_devices: the tracker and the
        # mapper on disjoint slot groups (GroupPlan); otherwise both share
        # one set of dp slots and the schedule is strict
        self.groups = concurrent_groups(cfg, self.devices)
        self.concurrent = self.groups is not None
        if self.concurrent:
            self.dp_devices = None
            track_dp, map_dp = self.groups.track_dp, self.groups.map_dp
            # frames, the tracker and the aux subsystems on the track group,
            # the scene state and the keyframe registry on the map group
            self.device = self.groups.track_lead
            map_dev = self.groups.map_lead
        else:
            self.dp_devices = pipeline_dp_devices(cfg, self.devices)
            track_dp = map_dp = self.dp_devices
            map_dev = self.device
        self.cfg = cfg
        self.nice = nice
        self.coarse = cfg["coarse"] and nice
        self.verbose = cfg.get("verbose", False)
        if self.verbose:
            self.tracer.enable()

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
        if nice:
            self.grids = init_grids(g_grid, self.bound, cfg["grid_len"], cfg["model"]["c_dim"],
                                    self.coarse, cfg["model"]["coarse_bound_enlarge"],
                                    device=map_dev)
            self.decoders = get_model(dict(cfg, coarse=self.coarse), nice=True,
                                      generator=g_dec, device=map_dev)
            pre = cfg.get("pretrained_decoders", {})
            mf = pre.get("middle_fine")
            if mf and os.path.exists(mf):
                self.decoders = load_pretrained_decoders(
                    self.decoders, mf, pre.get("coarse") if self.coarse else None)
        else:
            self.grids = {}
            self.decoders = get_model(cfg, nice=False, generator=g_dec, device=map_dev)

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
        # tracking never trains the decoders, so on the card it decodes the
        # NICE trio through the fused kernels; on the CPU the JAX package
        # turns its fused decode off, and so does this port, so that CPU runs
        # of both compare like with like
        fused = dev.type == "cuda" and nice
        self.tracker = Tracker(t_cfg, self.cam, self.settings._replace(fused_decode=fused),
                               self.bound, self.eventnet, device=dev, dp=track_dp)
        # each group its own copy of the EventNet weights
        self.mapper = Mapper(m_cfg, self.cam, self.settings, self.bound,
                             eventnet=replicate(self.eventnet, map_dev), device=map_dev,
                             dp=map_dp)
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
        # concurrent (loose / free) scheduling: the tracker's snapshot of the
        # last COMPLETED map, the one mapping call in flight, and the trace
        # of (tracked idx, adopted mapping_idx) pairs
        self._track_grids = None
        self._track_decoders = None
        self._pending_map: Optional[Dict[str, Any]] = None
        self._last_map_dispatch_idx = -1
        self.adopted_map_idx = -1
        self.n_concurrent_maps = 0
        self.lag_trace: list = []
        # concurrent mode: the tracker's own recent poses. A BA write-back
        # replaces _est_dev rows with the map group's output; the tracker's
        # constant-speed initialisation must not take those, or the next
        # tracked frame would wait for the whole mapping call (the
        # reference's mapper writes its poses back behind the tracker too)
        self._track_pose_cache: Dict[int, torch.Tensor] = {}
        self._mesher = None
        self._renderer = None
        self._vis: Dict[str, Visualizer] = {}

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

    @property
    def mesher(self) -> Mesher:
        """The mesher, built on first use from the pipeline's own render
        settings: the sweep and the vertex colours decode in f32 through the
        plain ops, as the mapper's decode does (only the tracker's settings
        turn the fused kernels on)."""
        if self._mesher is None:
            self._mesher = Mesher(self.cfg, self.cam, self.settings, self.bound,
                                  device=self.device)
        return self._mesher

    @property
    def renderer(self) -> Renderer:
        """Whole-image renderer of the visualiser, built on first use from
        the pipeline's own render settings (the fused decode off, as in the
        JAX package: only the tracker's settings turn it on)."""
        if self._renderer is None:
            c = self.cam
            self._renderer = Renderer(c.H, c.W, c.fx, c.fy, c.cx, c.cy, self.bound,
                                      self.settings, device=self.device)
        return self._renderer

    def _get_vis(self, which: str) -> Visualizer:
        """The tracking or mapping visualiser. Under an output directory
        named ``Demo`` the tracking panels go to ``vis/``; the mapping
        visualiser fires every ``2 * vis_inside_freq - 1`` iterations ("to
        see start and end", as the reference has it)."""
        if which not in self._vis:
            if which == "tracking":
                t = self.cfg["tracking"]
                sub = "vis" if "Demo" in self.output else "tracking_vis"
                freq, inside = t.get("vis_freq", 50), 1
            else:
                m = self.cfg["mapping"]
                sub = "mapping_vis"
                freq, inside = m.get("vis_freq", 50), max(1, 2 * m.get("vis_inside_freq", 25) - 1)
            self._vis[which] = Visualizer(freq, inside, os.path.join(self.output, sub),
                                          self.renderer, self.verbose)
        return self._vis[which]

    def _predict_event_for_vis(self, idx: int, gt_depth):
        """The low-resolution GT event integral and the predicted events of
        frame ``idx`` for the tracking panels, with the tracker's predictor
        (ESIM or the UNet)."""
        tr = self.tracker
        gt_ev_lo = resize_nearest(tr.gt_event_integrate, tr.lo_hw)
        prev_fn = resize_nearest if self.t_cfg.prev_resize == "nearest" else resize_bilinear
        prev_lo = prev_fn(tr.pre_gt_color, tr.lo_hw)
        pose = torch.as_tensor(self._pose_np(idx)[:3]).to(self.device)
        g, d = self._track_state()
        with torch.no_grad():
            _, _, cur_lo = self.renderer.render_img_rescale(
                d, g, pose, "color", gt_depth=gt_depth,
                scale_factor=self.t_cfg.scale_factor)
            if self.t_cfg.predictor == "esim":
                pred, _ = esim_predict(prev_lo, cur_lo, self.t_cfg.esim_gain)
            else:
                pred, _ = inference_event(self.eventnet, prev_lo, cur_lo)
        with TRACER.span("slam.sync.vis"):
            return gt_ev_lo.cpu().numpy(), pred.cpu().numpy()

    # ------------------------------------------------------------------
    # poses: device-backed, read back in one copy on access

    @property
    def estimate_c2w_list(self) -> np.ndarray:
        """Estimated trajectory [n_img, 4, 4]. Reading it copies every pose
        still on the device to the host, all in one copy."""
        if self._est_dev:
            idxs = list(self._est_dev)
            # tracked poses on the track group, BA write-backs on the map group
            with TRACER.span("slam.sync.pose"):
                mats = torch.stack([self._est_dev[i].to(self.device)
                                    for i in idxs]).cpu().numpy()
            self._est_np[idxs] = mats
            self._est_dev.clear()
            self._host_copies.clear()
        return self._est_np

    @estimate_c2w_list.setter
    def estimate_c2w_list(self, value):
        self._est_np = np.asarray(value, np.float32).copy()
        self._est_dev.clear()
        self._host_copies.clear()
        self._track_pose_cache.clear()

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
            with TRACER.span("slam.sync.pose"):
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
        done.record(torch.cuda.current_stream(c2w.device))
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
        dev_vals = [v.detach().reshape(-1).double().to(self.device) for _, d in pending
                    for v in d.values() if isinstance(v, torch.Tensor)]
        with TRACER.span("slam.sync.metrics"):
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

    # ------------------------------------------------------------------
    # concurrent (loose / free) scheduling

    def _init_pose(self, idx: int):
        """The pose that initialises tracking (constant-speed extrapolation):
        in concurrent mode the tracker's own output (``_track_pose_cache``)
        before ``_pose``."""
        if self.concurrent and idx in self._track_pose_cache:
            return self._track_pose_cache[idx]
        return self._pose(idx)

    def _track_state(self):
        """(grids, decoders) the tracker reads: in concurrent mode the
        snapshot of the last completed mapping call on the track group,
        otherwise the mapper's live state."""
        if not self.concurrent:
            return self.grids, self.decoders
        if self._track_grids is None:
            self._adopt_map_snapshot()
        return self._track_grids, self._track_decoders

    def _adopt_map_snapshot(self):
        """Copy the mapper's grids and decoders to the track group's lead
        device. A mapping call returns new tensors and nothing writes into
        the ones it returned (``utils/optim.py::adam_update`` is
        functional), so on one device the snapshot may share them."""
        self._track_grids, self._track_decoders = replicate((self.grids, self.decoders),
                                                            self.groups.track_lead)

    def _map_probe(self):
        """The completion signal of the mapping call just enqueued: an event
        on the map group's lead device, recorded after it. None on the CPU,
        where a call has completed when it returns."""
        dev = self.groups.map_lead
        if dev.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return done

    def _adopt_pending_map(self, block: bool = False) -> bool:
        """Adopt the in-flight mapping call's output into the tracker's
        snapshot if it has COMPLETED (``block``: wait for it). Adopting an
        unfinished call would make the tracker's next frame wait for the
        mapper, so the non-blocking path asks the event first."""
        p = self._pending_map
        if p is None:
            return False
        probe = p["probe"]
        if probe is not None:
            if block:
                with TRACER.span("slam.sync.loose_wait"):
                    probe.synchronize()
            elif not probe.query():
                return False
        self._adopt_map_snapshot()
        self.adopted_map_idx = p["idx"]
        self._pending_map = None
        return True

    def _maybe_dispatch_map(self, idx: int, frame, images_dev) -> bool:
        """The reference's mapper-side rule: a new mapping call starts once
        the previous one completed AND tracking advanced at least
        ``every_frame // 2`` frames past the last mapped index ('free': any
        advance). It maps the latest tracked frame."""
        if self._pending_map is not None and not self._adopt_pending_map():
            return False
        gap = idx - self._last_map_dispatch_idx
        min_gap = 1 if self.sync_method == "free" else max(1, self.m_cfg.every_frame // 2)
        if gap < min_gap:
            return False
        self._dispatch_concurrent_map(idx, frame, images_dev)
        return True

    def _dispatch_concurrent_map(self, idx: int, frame, images_dev=None):
        """Enqueue one concurrent mapping call and its bookkeeping."""
        self._map_frame(idx, frame, init=False, images_dev=images_dev)
        self._pending_map = {"idx": idx, "probe": self._map_probe()}
        self._last_map_dispatch_idx = idx
        self.n_concurrent_maps += 1

    def _loose_wait(self, idx: int):
        """The reference's tracker-side bound: wait while the adopted map is
        more than ``every_frame + every_frame // 2`` frames behind the frame
        about to be tracked."""
        every = self.m_cfg.every_frame
        while self.adopted_map_idx < idx - every - every // 2:
            if self._adopt_pending_map(block=True):
                continue
            # the mapper idle but stale (only after a resume): map the newest
            # tracked frame so that the bound can hold
            if self._last_map_dispatch_idx < idx - 1 and idx >= 1:
                self._dispatch_concurrent_map(idx - 1, self.frame_reader[idx - 1])
            else:
                break

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
        """The mapping of frame ``idx``: its inputs, the mapping call(s), the
        keyframe registry and the back-pressure; the span ``slam.step.map``."""
        with TRACER.span("slam.step.map"):
            self._map_phase(idx, frame, init, color_refine, images_dev)

    def _map_phase(self, idx, frame, init, color_refine, images_dev):
        m = self.m_cfg
        gt_event_int = self._integrated_event(idx) if self.use_events else frame.event
        if self.concurrent:
            # the call's inputs on the map group, so that it runs there
            map_dev = self.groups.map_lead
            if images_dev is None:
                # a call without the frame's upload (the rescue in _loose_wait)
                images_dev = (frame.color, frame.depth)
            images_dev = tuple(torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                               else x).to(map_dev) for x in images_dev)
            if isinstance(gt_event_int, torch.Tensor):
                gt_event_int = gt_event_int.to(map_dev)
        # steady state: the call takes the tracker's device pose; otherwise
        # one pose read a call
        fast = not init and not color_refine and self._async_map_ok()
        if fast:
            self.n_fast_maps += 1
            cur_c2w = self._pose(idx)
            if isinstance(cur_c2w, np.ndarray):
                cur_c2w = cur_c2w.copy()
            elif self.concurrent:
                cur_c2w = cur_c2w.to(self.groups.map_lead)
        else:
            cur_c2w = self._pose_np(idx).copy()

        if init:
            outer, num_iters, lr_factor = 1, m.iters_first, m.lr_first_factor
        elif color_refine:
            outer, num_iters, lr_factor = 5, m.iters, m.lr_factor
        elif self.nice:
            outer, num_iters, lr_factor = 1, m.iters, m.lr_factor
        else:
            outer, num_iters, lr_factor = 3, m.iters // 3, m.lr_factor

        # the mapping panels, every vis_inside_freq iterations inside the
        # call (none for a Demo output directory)
        vis_cb, vis_inside = None, 0
        if self.cfg.get("enable_vis", True) and "Demo" not in self.output:
            mvis = self._get_vis("mapping")
            if mvis.should_vis(idx, 0):
                vis_inside = mvis.inside_freq

                def vis_cb(it, g, d, cams):
                    g, d = replicate((g, d), self.device)
                    mvis.vis(idx, it, frame.depth, frame.color, self._pose_np(idx), g, d)

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
                grids=self.grids, decoders=self.decoders, cur_images_dev=images_dev,
                vis_callback=vis_cb, vis_inside_freq=vis_inside)
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
        if fast and self.mapper.device.type == "cuda":
            # hold the host's run-ahead: with no pose read, nothing else
            # paces it, and each call in flight holds its own grids and
            # window buffers on the device. Waiting for the call
            # MAX_INFLIGHT_MAPS calls back waits, in steady state, for work
            # already done, so the device queue never runs dry. Concurrent
            # mode: a call is enqueued only once the previous one completed,
            # so this holds the TRACKER's run-ahead (under 'free' no lag
            # bound does).
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.mapper.device))
            self._inflight_maps.append(done)
            while len(self._inflight_maps) > MAX_INFLIGHT_MAPS:
                with TRACER.span("slam.sync.inflight_map"):
                    self._inflight_maps.popleft().synchronize()

    def step(self, idx: int) -> bool:
        """Process frame ``idx`` through the schedule; returns whether it was
        mapped. In steady state this only enqueues device work: the frame was
        uploaded ahead of time by the reader's worker thread."""
        with self.tracer.step(idx):
            return self._step(idx)

    def _step(self, idx: int) -> bool:
        frame, dev = self.frame_reader.get_with_device(idx)
        self.gt_c2w_list[idx] = frame.c2w
        gt_color, gt_depth, gt_event = dev

        if idx == 0 or self.t_cfg.gt_camera:
            self._set_pose(idx, frame.c2w)
            if idx == 0:
                if self.use_events:
                    self.tracker.reset_event_integration(frame.event.shape)
                self._map_frame(idx, frame, init=True, images_dev=(gt_color, gt_depth))
                if self.concurrent:
                    # the reference tracks only after the first mapping
                    # call: adopt it before frame 1
                    self._pending_map = {"idx": 0, "probe": self._map_probe()}
                    self._last_map_dispatch_idx = 0
                    self.n_concurrent_maps += 1
                    self._adopt_pending_map(block=True)
                self.tracker.pre_gt_color = gt_color
        else:
            if self.concurrent:
                self._adopt_pending_map(block=False)
                if self.sync_method == "loose":
                    self._loose_wait(idx)
                self.lag_trace.append((idx, self.adopted_map_idx))
            track_grids, track_decoders = self._track_state()
            c2w = self.tracker.track(
                idx, gt_color, gt_depth, gt_event, self._init_pose(idx - 1),
                self._init_pose(idx - 2) if idx >= 2 else None,
                track_decoders, track_grids, seed=idx)
            self._set_pose(idx, c2w)
            if self.concurrent:
                self._track_pose_cache[idx] = c2w
                self._track_pose_cache.pop(idx - 3, None)
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
        if idx > 0 and self.cfg.get("enable_vis", True):
            vis = self._get_vis("tracking")
            if vis.should_vis(idx, 0):
                with TRACER.span("slam.vis"):
                    gt_ev_lo = pred_ev = None
                    if self.use_events and self.tracker.pre_gt_color is not None:
                        gt_ev_lo, pred_ev = self._predict_event_for_vis(idx, gt_depth)
                    g, d = self._track_state()
                    vis.vis(idx, 0, gt_depth, gt_color, self._pose_np(idx), g, d,
                            gt_event=gt_ev_lo, pred_event=pred_ev)

        mapped = False
        if self.concurrent and idx != 0:
            if idx == self.n_img - 1:
                # the last frame is always mapped: wait for the call in
                # flight, then map it
                self._adopt_pending_map(block=True)
                if self._last_map_dispatch_idx != idx:
                    self._map_frame(idx, frame, init=False,
                                    images_dev=(gt_color, gt_depth))
                    self._last_map_dispatch_idx = idx
                    self.n_concurrent_maps += 1
                    self.adopted_map_idx = idx
                    self._adopt_map_snapshot()
                mapped = True
            else:
                mapped = self._maybe_dispatch_map(idx, frame, (gt_color, gt_depth))
        elif idx != 0 and idx % self.m_cfg.every_frame == 0:
            self._map_frame(idx, frame, init=False, images_dev=(gt_color, gt_depth))
            mapped = True
        if idx == self.n_img - 1:
            if self.m_cfg.color_refine and self.nice:
                self._map_frame(idx, frame, init=False, color_refine=True,
                                images_dev=(gt_color, gt_depth))
            mapped = True
        self.idx = idx
        return mapped

    def run(self, end_frame: Optional[int] = None, mesh: bool = True, checkpoint: bool = True,
            start_frame: int = 0) -> np.ndarray:
        """The whole sequence; ``start_frame > 0`` resumes after
        ``CheckpointLogger.restore`` with the same checkpoint and mesh
        cadence. Checkpoints every ``ckpt_freq`` mapped frames and after the
        last; with ``mesh``, a mesh every ``mesh_freq`` mapped frames, then
        ``mesh/final_mesh.ply`` and, with ``meshing.eval_rec``,
        ``mesh/final_mesh_eval_rec.ply`` cleaned by every frame's frustum."""
        n = self.n_img if end_frame is None else min(end_frame, self.n_img)
        mesh_freq = self.cfg["mapping"].get("mesh_freq", 50)
        ckpt_freq = self.cfg["mapping"].get("ckpt_freq", 500)
        mesh_dir = os.path.join(self.output, "mesh")
        if mesh:
            os.makedirs(mesh_dir, exist_ok=True)
        for idx in range(start_frame, n):
            mapped = self.step(idx)
            if self.verbose:
                # host time spent enqueueing each phase: the device runs behind
                t = self.tracer.total
                print(f"[enslam] frame {idx}/{n} track_dispatch={t['slam.track']:.1f}s "
                      f"map_dispatch={t['slam.map']:.1f}s")
            if mapped and checkpoint and idx > 0 and idx % ckpt_freq == 0:
                self.mapper.keyframes.sync_host_poses()
                self.logger.log(self, idx)
            if mapped and mesh and idx > 0 and idx % mesh_freq == 0 and idx != n - 1:
                self._get_mesh(os.path.join(mesh_dir, f"{idx:05d}_mesh.ply"), idx)
        last = n - 1
        self._flush_metrics(force=True)
        self.mapper.keyframes.sync_host_poses()
        if checkpoint:
            self.logger.log(self, last)
        if mesh:
            self._get_mesh(os.path.join(mesh_dir, "final_mesh.ply"), last)
            if self.cfg["meshing"].get("eval_rec", False):
                self._get_mesh(os.path.join(mesh_dir, "final_mesh_eval_rec.ply"), last,
                               get_mask_use_all_frames=True)
        return self.estimate_c2w_list

    def _get_mesh(self, path: str, idx: int, **kw):
        self.mapper.keyframes.sync_host_poses()
        grids, decoders = replicate((self.grids, self.decoders), self.device)
        return self.mesher.get_mesh(path, grids, decoders,
                                    self.mapper.keyframes.frames, self.estimate_c2w_list,
                                    idx, **kw)
