"""Spans, counters and captures that the harness puts around the program's
calls, from its own files: it wraps the instance methods and module
attributes where the program's call sites look them up, and takes nothing
out of the program's code.

- Always, in the window: a CUDA event pair around every ``Tracker.track``
  and ``Mapper.optimize_map`` call (read after the window; recording an
  event does not wait).
- In a ``--trace 1`` run's first profiled periods (the card alone traced):
  the arithmetic of every decoder and EventNet call, counted from shapes.
- In its later profiled periods (host and card traced): ``torch.profiler``
  annotations ``pb.<layer>`` around the calls into each layer; marks that
  bracket the backward of the decode and of EventNet (an identity autograd
  node on the outputs, whose backward runs first, and one on the inputs,
  whose backward runs last); the host time of each reader call.
- In the checked period of set-up: host copies of what each tracking and
  mapping call started from and what it produced (``check.Capture``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List

import torch

from portbench import work


class _Mark(torch.autograd.Function):
    """Identity whose backward leaves an annotation in the trace."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(ctx.name):
            pass
        return (None,) + grads


def _mark(name: str, tensors):
    """``tensors`` through a mark where they carry a gradient."""
    idx = [i for i, t in enumerate(tensors) if isinstance(t, torch.Tensor) and t.requires_grad]
    if not idx:
        return list(tensors)
    out = list(tensors)
    marked = _Mark.apply(name, *[tensors[i] for i in idx])
    for i, t in zip(idx, marked):
        out[i] = t
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Instruments:
    """Installs the wrappers on one pipeline and holds what they record."""

    def __init__(self, slam, modules, c_dim: int, hidden: int):
        self.slam = slam
        self.modules = modules  # {"decoders", "tracker", "mapper"}: the program's modules
        self.c_dim, self.hidden = c_dim, hidden
        self.window = False      # time tracking calls with CUDA events
        self.counting = False    # count the step's arithmetic (first profiled periods)
        self.spanning = False    # annotations, marks, reader times (later profiled periods)
        self.capture = None      # a check.Capture during the checked period
        self.track_events: List[tuple] = []
        self.map_events: List[tuple] = []
        self.flops: Dict[str, float] = defaultdict(float)   # step arithmetic by precision
        self.imap_flops = 0.0                                # iMAP forward products
        self.decode_calls: List[tuple] = []
        self.frame_wait_s: List[float] = []
        self.n_track = 0
        self._undo: List[tuple] = []

    # -- installing ---------------------------------------------------------

    def _patch(self, obj, name: str, fn):
        self._undo.append((obj, name, obj.__dict__.get(name, None), name in obj.__dict__))
        setattr(obj, name, fn)

    def install(self):
        slam = self.slam
        self._patch(slam.tracker, "track", self._wrap_track(slam.tracker.track))
        self._patch(slam.mapper, "optimize_map", self._wrap_map(slam.mapper.optimize_map))
        self._patch(slam.frame_reader, "get_with_device",
                    self._wrap_reader(slam.frame_reader.get_with_device))
        dec = self.modules["decoders"]
        self._patch(dec, "nice_forward", self._wrap_nice(dec.nice_forward))
        self._patch(dec, "nice_forward_packed", self._wrap_packed(dec.nice_forward_packed))
        self._patch(dec, "imap_forward", self._wrap_imap(dec.imap_forward))
        for mod in (self.modules["tracker"], self.modules["mapper"]):
            self._patch(mod, "inference_event", self._wrap_eventnet(mod.inference_event))
        trk = self.modules["tracker"]
        self._patch(trk, "adam_update", self._wrap_adam(trk.adam_update))
        return self

    def remove(self):
        for obj, name, old, had in reversed(self._undo):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo = []

    # -- wrappers -------------------------------------------------------------

    def _wrap_track(self, orig):
        def track(idx, gt_color, gt_depth, gt_event, pre_c2w, pre_pre_c2w, decoders, grids,
                  seed=0, pixel_draws=None):
            rec = None
            if self.capture is not None:
                rec = self.capture.track_before(self.slam, idx, gt_color, gt_depth, gt_event,
                                                pre_c2w, pre_pre_c2w, decoders, grids, seed)
            ev = None
            if self.window:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with _span("pb.track", self.spanning):
                out = orig(idx, gt_color, gt_depth, gt_event, pre_c2w, pre_pre_c2w, decoders,
                           grids, seed=seed, pixel_draws=pixel_draws)
            if ev is not None:
                ev[1].record()
                self.track_events.append(ev)
            if self.spanning:
                self.n_track += 1
            if rec is not None:
                self.capture.track_after(rec, out, self.slam.tracker.last_losses)
            return out
        return track

    def _wrap_adam(self, orig):
        """The tracker's Adam steps of a checked frame: the gradient as the
        optimizer gets it, and the pose before and after the step."""
        def adam_update(grads, state, params, lr_tree, *a, **k):
            out = orig(grads, state, params, lr_tree, *a, **k)
            if self.capture is not None:
                self.capture.step(grads, params, out[0])
            return out
        return adam_update

    def _wrap_map(self, orig):
        def optimize_map(*args, **kw):
            rec = None
            if self.capture is not None:
                rec = self.capture.map_before(self.slam, args, kw)
            ev = None
            if self.window:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with _span("pb.map", self.spanning):
                out = orig(*args, **kw)
            if ev is not None:
                ev[1].record()
                self.map_events.append(ev)
            if rec is not None:
                self.capture.map_after(self.slam, rec, out)
            return out
        return optimize_map

    def _wrap_reader(self, orig):
        def get_with_device(idx):
            if not self.spanning:
                return orig(idx)
            t0 = time.perf_counter()
            with _span("pb.frame_wait", True):
                out = orig(idx)
            self.frame_wait_s.append(time.perf_counter() - t0)
            return out
        return get_with_device

    def _count_decode(self, decoders, grids, p, names, out, emb_prec, other_prec, emb, other):
        n = p.shape[0]
        mult = 1
        if out.requires_grad:
            w_grad = any(t.requires_grad for nm in names for t in _leaves(decoders[nm]))
            x_grad = p.requires_grad or any(t.requires_grad for t in _leaves(grids or {}))
            mult += int(w_grad) + int(x_grad)
        self.flops[emb_prec] += mult * n * emb
        self.flops[other_prec] += mult * n * other

    def _wrap_nice(self, orig):
        def nice_forward(decoders, grids, p, bound, stage, coarse_bound_enlarge=2.0,
                         fused=False):
            out = orig(decoders, grids, p, bound, stage, coarse_bound_enlarge, fused=fused)
            if self.counting:
                emb, other = work.nice_point_flops(self.c_dim, self.hidden, stage)
                packed = fused and stage == "color"
                self._count_decode(decoders, grids, p, work.STAGE_DECODERS[stage], out,
                                   "f32", "bf16" if packed else "f32", emb, other)
            return out
        return nice_forward

    def _wrap_packed(self, orig):
        def nice_forward_packed(decoders, grids, p, bound):
            if self.capture is not None and self.capture.wants_decode():
                out = orig(decoders, grids, p, bound)
                self.capture.decode(p, out, bound)
                return out
            if not self.spanning:
                return orig(decoders, grids, p, bound)
            bwd = p.requires_grad
            (p,) = _mark("pb.decode_bwd.end", [p])
            with _span("pb.decode_fwd", True):
                out = orig(decoders, grids, p, bound)
            (out,) = _mark("pb.decode_bwd.begin", [out])
            shapes = {"middle": tuple(grids["middle"].shape[:3]),
                      "fc": tuple(grids["fine"].shape[:3])}
            self.decode_calls.append((p.detach(), bound, shapes, bwd))
            return out
        return nice_forward_packed

    def _wrap_imap(self, orig):
        def imap_forward(decoders, p):
            with _span("pb.imap_fwd", self.spanning):
                out = orig(decoders, p)
            f = work.imap_point_flops()
            if self.spanning:
                self.imap_flops += p.shape[0] * f
            if self.counting:
                # one product chain: the embedding counts with the rest
                self._count_decode(decoders, None, p, ["imap"], out, "f32", "f32", 0, f)
            return out
        return imap_forward

    def _wrap_eventnet(self, orig):
        def inference_event(params, img1, img2):
            if self.counting:
                prec = "tf32" if torch.backends.cudnn.allow_tf32 else "f32"
                f = work.eventnet_forward_flops(img2.shape[0], img2.shape[1])
                grad = img1.requires_grad or img2.requires_grad
                self.flops[prec] += f * (2 if grad else 1)
            if self.capture is not None and self.capture.wants_eventnet():
                out = orig(params, img1, img2)
                self.capture.eventnet(img1, img2, out)
                return out
            if not self.spanning:
                return orig(params, img1, img2)
            img1, img2 = _mark("pb.eventnet_bwd.end", [img1, img2])
            with _span("pb.eventnet", True):
                out = orig(params, img1, img2)
            return tuple(_mark("pb.eventnet_bwd.begin", list(out)))
        return inference_event

    # -- after the profiled periods -----------------------------------------

    def decode_vertices(self) -> List[Dict[str, Any]]:
        """For each recorded tracking decode: its point count and the grid
        vertices its points touch, each counted once (middle; fine and
        colour share one lattice)."""
        from portbench.reference.core.bounds import normalize_3d_coordinate
        from portbench.reference.ops.grid_sample import _unnormalize

        out = []
        with torch.no_grad():
            for p, bound, shapes, bwd in self.decode_calls:
                p_nor = normalize_3d_coordinate(p, bound)
                verts = {}
                for level, (Z, Y, X) in shapes.items():
                    ux, uy, uz = _unnormalize(p_nor, Z, Y, X)
                    x0, y0, z0 = (torch.floor(u).long() for u in (ux, uy, uz))
                    lin = []
                    for dz in (0, 1):
                        for dy in (0, 1):
                            for dx in (0, 1):
                                z = torch.clamp(z0 + dz, max=Z - 1)
                                y = torch.clamp(y0 + dy, max=Y - 1)
                                x = torch.clamp(x0 + dx, max=X - 1)
                                lin.append((z * Y + y) * X + x)
                    verts[level] = int(torch.unique(torch.cat(lin)).numel())
                out.append({"n": int(p.shape[0]), "vertices": verts, "bwd": bwd})
        self.decode_calls = []
        return out
