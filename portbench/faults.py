"""Faults planted under a run's timed path, to show that the check catches
them: a step that returns its state unchanged (the tracker's Adam step,
the mapping call), half of the batch left out with the sum taken over the
rest twice (the mean over the rest), and an answer altered where it is
produced (the tracked pose, the fine grid; ``frame_loss``: the loss record
of every fifth tracked frame, one frame of a mapping period of five, one
per cent high, the pose and its gradient left as they were). One card has no exchange between chips
to leave out.

Two more break the backward of the tracker's packed decode, which runs the
fused kernels on the card (``DECODE_FAULTS``): the gradient it passes to its points comes back zero,
or negated, as from a backward kernel that writes nothing or the wrong
sign.

``planted(name, modules)`` patches the module attributes that the calls
look up: ``modules`` holds the tracker and mapper modules of the program,
or of the reference put in its place, and for ``DECODE_FAULTS`` its
decoders module.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

FAULTS = ("unchanged", "half_batch", "altered", "frame_loss")
DECODE_FAULTS = ("zero_grad", "flipped_grad")


class _ScaledGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _halved(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    half = x.shape[dim] // 2
    first = x.narrow(dim, 0, half)
    return torch.cat([first, first], dim=dim) if x.shape[dim] % 2 == 0 else torch.cat(
        [first, first, x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)


@contextlib.contextmanager
def planted(name: str, modules: Dict):
    tracker, mapper = modules["tracker"], modules["mapper"]
    saved = []

    def patch(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if name == "unchanged":
        adam_update, map_frame = tracker.adam_update, mapper.map_frame

        def step_unchanged(grads, state, params, *a, **k):
            _, new_state = adam_update(grads, state, params, *a, **k)
            return params, new_state

        def map_unchanged(grids, decoders, cams, *a, **k):
            out = map_frame(grids, decoders, cams, *a, **k)
            return (grids, decoders, cams) + tuple(out[3:])

        patch(tracker, "adam_update", step_unchanged)
        patch(mapper, "map_frame", map_unchanged)
    elif name == "half_batch":
        get_samples, sample_window = tracker.get_samples, mapper._sample_window_rays

        def half_samples(*a, **k):
            return tuple(_halved(t) for t in get_samples(*a, **k))

        def half_window(pixel_idx, *a, **k):
            return sample_window(_halved(pixel_idx, dim=1), *a, **k)

        patch(tracker, "get_samples", half_samples)
        patch(mapper, "_sample_window_rays", half_window)
    elif name == "altered":
        track_frame, map_frame = tracker.track_frame, mapper.map_frame

        def track_altered(*a, **k):
            best_cam, best_c2w, losses, bias = track_frame(*a, **k)
            best_c2w = best_c2w.clone()
            best_c2w[0, 3] += 0.01  # one centimetre along x
            return best_cam, best_c2w, losses, bias

        def map_altered(*a, **k):
            out = map_frame(*a, **k)
            grids = dict(out[0])
            level = "fine" if "fine" in grids else None
            decoders = out[1]
            if level:
                grids[level] = grids[level] + 1e-3
            else:
                decoders = {k2: dict(v) for k2, v in decoders.items()}
                mlp = decoders["imap"]
                mlp["out_b"] = mlp["out_b"] + 1e-3
            return (grids, decoders) + tuple(out[2:])

        patch(tracker, "track_frame", track_altered)
        patch(mapper, "map_frame", map_altered)
    elif name == "frame_loss":
        track_frame, calls = tracker.track_frame, []

        def loss_altered(*a, **k):
            best_cam, best_c2w, losses, bias = track_frame(*a, **k)
            if len(calls) % 5 == 0:
                losses = {key: v * 1.01 for key, v in losses.items()}
            calls.append(1)
            return best_cam, best_c2w, losses, bias

        patch(tracker, "track_frame", loss_altered)
    elif name in DECODE_FAULTS:
        decoders = modules["decoders"]
        packed = decoders.nice_forward_packed
        scale = 0.0 if name == "zero_grad" else -1.0

        def packed_broken(dec, grids, p, bound):
            return packed(dec, grids, _ScaledGrad.apply(p, scale), bound)

        patch(decoders, "nice_forward_packed", packed_broken)
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of "
                         f"{FAULTS + DECODE_FAULTS}")
    try:
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)
