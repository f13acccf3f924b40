"""Background frame prefetcher with the device upload done ahead of time
(counterpart of ``evennicer_slam_tpu/data/prefetch.py``).

The SLAM loop reads frames strictly in order. While frame ``i`` is tracked, a
worker thread decodes frame ``i + 1``, compacts it (colour and events as
uint8 when that is exact: they were 8-bit images) and uploads it: each array
is pinned, then copied with ``non_blocking`` on a CUDA stream of the
reader's own, and an event is recorded after the copies. The main thread
then only expands the frame on its current stream (:func:`expand_device_frame`),
which waits for that event on the device, not on the host. Decoding
(``zlib``, numpy) and the copies release the interpreter lock, so the overlap
is real. Random access falls through to the wrapped reader.

On the CPU device (the tests) the arrays are copied into tensors; nothing is
pinned, as a CPU-only build cannot pin memory.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from evennicer_slam_tpu_torch.utils.runtime import resolve_device


class DeviceFrame(NamedTuple):
    """A frame's compact arrays on the device and the upload's completion
    event (None on the CPU)."""

    color: torch.Tensor   # uint8 [H, W, 3] if exact, else float32
    depth: torch.Tensor   # float32 [H, W]
    event: torch.Tensor   # uint8 [H, W, 2] if exact, else float32
    exact: bool
    ready: Optional[torch.cuda.Event]


def _compact(frame):
    """(color_u8 | color_f32, depth_f32, event_u8 | event_f32, exact) on the host."""
    color_u8 = np.rint(frame.color * 255.0).astype(np.uint8)
    color_exact = (
        np.abs(color_u8.astype(np.float32) / 255.0 - frame.color).max() < 1e-6
    )
    event_u8 = np.rint(frame.event).astype(np.uint8)
    event_exact = np.abs(event_u8.astype(np.float32) - frame.event).max() < 1e-6
    if color_exact and event_exact:
        return color_u8, frame.depth, event_u8, True
    return frame.color, frame.depth, frame.event, False


def _upload(frame, device: torch.device, stream) -> DeviceFrame:
    """Copy the compact frame arrays to ``device``: on a card through pinned
    memory on ``stream``, without blocking, with an event recorded after the
    copies."""
    *arrays, exact = _compact(frame)
    if device.type != "cuda":
        return DeviceFrame(*(torch.from_numpy(np.array(a)).to(device) for a in arrays),
                           exact, None)
    with torch.cuda.stream(stream):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(device, non_blocking=True) for a in arrays]
        ready = torch.cuda.Event()
        ready.record(stream)
    return DeviceFrame(*tensors, exact, ready)


def expand_device_frame(dev: DeviceFrame) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The compact device frame as a float32 (color, depth, event) triple,
    made on the current stream. The stream first waits for the upload, and
    each uploaded tensor is marked as used by it, so that the caching
    allocator does not hand its memory out while this stream may still read
    it."""
    if dev.ready is not None:
        current = torch.cuda.current_stream(dev.color.device)
        current.wait_event(dev.ready)
        for t in (dev.color, dev.depth, dev.event):
            t.record_stream(current)
    if not dev.exact:
        return dev.color, dev.depth, dev.event
    return dev.color.to(torch.float32) / 255.0, dev.depth, dev.event.to(torch.float32)


class PrefetchingReader:
    """Wraps a dataset reader: sequential reads decode (and, through
    :meth:`get_with_device`, upload) the next frame on a worker thread.
    ``device=None`` means the CUDA device."""

    def __init__(self, reader, device=None):
        self._reader = reader
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._lock = threading.Lock()
        self._cache = {}
        self._pinned: set = set()
        self._thread: Optional[threading.Thread] = None
        self._last_idx: Optional[int] = None
        self.has_events = getattr(reader, "has_events", False)

    def _put(self, frame) -> DeviceFrame:
        return _upload(frame, self.device, self._stream)

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def preload_device(self, indices):
        """Decode AND upload a range of frames now, pinned in the cache (not
        evicted, not popped on read). A benchmark keeps the decoding and the
        uploads out of its measured window this way."""
        self._join()
        for idx in indices:
            with self._lock:
                have = idx in self._cache and self._cache[idx][1] is not None
            if not have:
                frame = self._reader[idx]
                dev = self._put(frame)
                with self._lock:
                    self._cache[idx] = (frame, dev)
            with self._lock:
                self._pinned.add(idx)

    def release_device(self, indices):
        """Unpin and drop frames preloaded by :meth:`preload_device` (a later
        phase frees the earlier phase's frames)."""
        with self._lock:
            for idx in indices:
                self._pinned.discard(idx)
                self._cache.pop(idx, None)

    def __len__(self):
        return len(self._reader)

    def __getattr__(self, name):
        return getattr(self._reader, name)

    def _prefetch(self, idx: int, need_device: bool):
        try:
            frame = self._reader[idx]
            dev = self._put(frame) if need_device else None
        except Exception:  # noqa: BLE001 - the caller's own read of idx repeats it and raises
            return
        with self._lock:
            # merge: a random host-side access must not clobber the loop's
            # already uploaded next frame
            self._cache[idx] = (frame, dev)
            for k in [k for k in self._cache if k < idx - 1 and k not in self._pinned]:
                self._cache.pop(k)

    def _fetch(self, idx: int, need_device: bool):
        self._join()
        with self._lock:
            if idx in self._pinned:
                entry = self._cache.get(idx)
            else:
                entry = self._cache.pop(idx, None)
        if entry is None or (need_device and entry[1] is None):
            frame = self._reader[idx] if entry is None else entry[0]
            # upload only for a caller that wants device tensors: plain host
            # reads (resume, event re-integration) skip the copy
            entry = (frame, self._put(frame) if need_device else None)
            if idx in self._pinned:
                # a pinned frame preloaded host-only keeps its upload
                with self._lock:
                    self._cache[idx] = entry
        # decode ahead on forward reads only: a backward sweep (event
        # re-integration reads idx, idx - 1, ...) or a repeated read would
        # decode a frame the caller never wants and wait for it next fetch
        forward = self._last_idx is None or idx > self._last_idx
        self._last_idx = idx
        nxt = idx + 1
        with self._lock:
            nxt_ready = nxt in self._cache and (
                not need_device or self._cache[nxt][1] is not None
            )
        if forward and nxt < len(self._reader) and not nxt_ready:
            self._thread = threading.Thread(
                target=self._prefetch, args=(nxt, need_device), daemon=True
            )
            self._thread.start()
        return entry

    def __getitem__(self, idx: int):
        return self._fetch(idx, need_device=False)[0]

    def get_with_device(self, idx: int):
        """(host Frame, (color, depth, event) float32 tensors on the device)."""
        frame, dev = self._fetch(idx, need_device=True)
        return frame, expand_device_frame(dev)
