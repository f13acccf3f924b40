"""Data parallelism over rays, and the tracker / mapper device groups of the
concurrent schedule (counterpart of ``evennicer_slam_tpu/parallel/sharding.py``).

The JAX package places arrays on a ``jax.sharding.Mesh`` and lets GSPMD
partition a jitted program: ray batches shard row-wise, and the compiler
inserts the psum of the loss and of the gradients. The port works over an
explicit list of device **slots**: ``torch.device`` objects, which may
repeat one device. Rays are split over the slots with ``torch.tensor_split``
(an uneven split works, as GSPMD pads one), each slot renders its rows
through the same ``render_rays``, the per-ray outputs are gathered to the
lead device, and the loss is computed there as at dp = 1. The parameters
reach each slot through a differentiable ``.to(slot)``, so autograd sums the
gradients of the copies back: GSPMD's psum.

With one slot per card the public behaviour is the JAX package's. Repeated
slots of one device (``["cpu"] * 8`` in the tests, the counterpart of their
eight virtual CPU devices; ``[cuda:0] * 2`` on a one-card machine) run the
same schedule and the same splits on that device: they show the mechanics,
not overlap between cards.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch

from evennicer_slam_tpu_torch.utils.optim import tree_map

Slots = List[torch.device]


def as_slots(devices: Sequence) -> Slots:
    """A list of ``torch.device`` from names or devices."""
    return [torch.device(d) for d in devices]


def default_slots(device: torch.device) -> Slots:
    """Every CUDA device when ``device`` is the index-less CUDA device, else
    ``device`` alone."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [device]
    return [device]


def pipeline_dp_devices(cfg: Dict[str, Any], devices: Sequence) -> Optional[Slots]:
    """The ray-dp slots of the strict pipeline (tracker and mapper).

    ``cfg['parallel']['data_parallel']``: ``'auto'`` (default) uses every
    slot on CUDA and one on the CPU, so that CPU runs keep their one-device
    numerics unless a caller asks for more with an int; an int is clamped
    to the number of slots. Returns the first n slots, or None at n = 1."""
    devices = as_slots(devices)
    want = cfg.get("parallel", {}).get("data_parallel", "auto")
    if want == "auto":
        n = len(devices) if devices[0].type == "cuda" else 1
    else:
        n = int(want)
    n = max(1, min(n, len(devices)))
    return None if n == 1 else devices[:n]


def shard_rows(x: torch.Tensor, dp: Slots) -> List[torch.Tensor]:
    """Rows of ``x`` split over the slots (``torch.tensor_split``: the first
    ``len(x) % len(dp)`` parts hold one row more), each part on its slot."""
    return [p.to(d) for p, d in zip(torch.tensor_split(x, len(dp)), dp)]


def gather_rows(parts: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The parts of ``shard_rows`` back in order on ``lead``."""
    return torch.cat([p.to(lead) for p in parts])


def replicate(tree: Any, device: torch.device) -> Any:
    """The tensors of ``tree`` on ``device``, by a differentiable ``.to`` (a
    tensor already there is returned as it is)."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


# ---------------------------------------------------------------------------
# concurrent tracker / mapper device groups (sync_method: loose | free)
# ---------------------------------------------------------------------------

class GroupPlan(NamedTuple):
    """Disjoint slot groups for tracker / mapper concurrency.

    The reference lets the tracker run ahead of the mapper under
    ``sync_method: loose | free`` because they are separate processes on one
    GPU. The JAX package runs them as two device groups in one process,
    asynchronous dispatch draining both queues; the port enqueues the
    tracker's work on the ``track`` group's lead device and the mapper's on
    the ``map`` group's, each with ray dp over its own group's slots."""

    track: Slots
    map: Slots

    @property
    def n_track(self) -> int:
        return len(self.track)

    @property
    def n_map(self) -> int:
        return len(self.map)

    @property
    def track_dp(self) -> Optional[Slots]:
        """Ray dp over the track group (None with one slot)."""
        return self.track if len(self.track) > 1 else None

    @property
    def map_dp(self) -> Optional[Slots]:
        return self.map if len(self.map) > 1 else None

    @property
    def track_lead(self) -> torch.device:
        return self.track[0]

    @property
    def map_lead(self) -> torch.device:
        return self.map[0]


def concurrent_groups(cfg: Dict[str, Any], devices: Sequence) -> Optional[GroupPlan]:
    """The (track, map) split of the slots, or None when there is none.

    Enabled by ``sync_method: loose | free`` with ``parallel.map_devices`` k
    (an int; ``'auto'`` means max(1, n // 4)). The map group takes the LAST
    k slots, the track group the rest. With fewer than k + 1 slots this
    returns None and loose / free run the strict schedule, as the JAX
    package does on one device group."""
    if cfg.get("sync_method", "strict") not in ("loose", "free"):
        return None
    devices = as_slots(devices)
    want = cfg.get("parallel", {}).get("map_devices", 0)
    k = max(1, len(devices) // 4) if want == "auto" else int(want or 0)
    if k <= 0 or len(devices) < k + 1:
        return None
    return GroupPlan(devices[: len(devices) - k], devices[len(devices) - k:])
