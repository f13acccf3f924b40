"""Minimal OpenEXR reader (scanline images, HALF, FLOAT or UINT channels,
NONE, ZIP or ZIPS compression): the port's copy of
``evennicer_slam_tpu/data/exr.py``. CoFusion's depth maps are EXR files,
and the port reads them without OpenEXR or an EXR-enabled OpenCV.

:func:`read_exr_depth` picks the depth channel as the JAX package's
``readEXR_onlydepth`` does: Y, else Z, else R, else the first channel.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PIX_TYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _parse_channels(data: bytes):
    channels = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        # record: int type, uchar pLinear, 3 reserved bytes, int xs, int ys
        (ptype,) = struct.unpack_from("<i", data, off)
        xs, ys = struct.unpack_from("<ii", data, off + 8)
        off += 16
        channels.append((name, ptype, xs, ys))
    return channels


def _unpredict(raw: bytes) -> bytes:
    """EXR ZIP post-processing: undo the delta predictor, then de-interleave
    (first half -> even byte positions, second half -> odd)."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    # predictor: stored[i] = t[i] - t[i-1] + 128; recover t by prefix sum
    deltas = arr[1:] - 128
    vals = ((arr[0] + np.concatenate([[0], np.cumsum(deltas)])) % 256).astype(np.uint8)
    n = len(vals)
    half = (n + 1) // 2
    out8 = np.empty(n, np.uint8)
    out8[0::2] = vals[:half]
    out8[1::2] = vals[half:]
    return out8.tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read an EXR file -> {channel_name: [H, W] float32 array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR not supported")
    off = 8

    attrs = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        _, off = _read_cstr(buf, off)  # type name
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = buf[off : off + size]
        off += size
    off += 1  # trailing null of the header

    channels = _parse_channels(attrs["channels"])
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"])
    W = xmax - xmin + 1
    H = ymax - ymin + 1
    (comp,) = struct.unpack("<b", attrs["compression"][:1])
    if comp not in (_COMP_NONE, _COMP_ZIPS, _COMP_ZIP):
        raise IOError(f"{path}: unsupported EXR compression {comp}")
    lines_per_block = 1 if comp in (_COMP_NONE, _COMP_ZIPS) else 16

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    # channels are stored per scanline in alphabetical order
    channels_sorted = sorted(channels, key=lambda c: c[0])
    bytes_per_px = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(W * bytes_per_px[c[1]] for c in channels_sorted)

    out = {c[0]: np.empty((H, W), np.float32) for c in channels_sorted}
    for boff in offsets:
        y0, size = struct.unpack_from("<ii", buf, boff)
        data = buf[boff + 8 : boff + 8 + size]
        rows_here = min(lines_per_block, ymax - y0 + 1)
        expect = line_bytes * rows_here
        if comp != _COMP_NONE and size < expect:
            data = _unpredict(zlib.decompress(data))
        # uncompressed (or stored-raw when compression didn't shrink)
        p = 0
        for r in range(rows_here):
            for name, ptype, _, _ in channels_sorted:
                nb = W * bytes_per_px[ptype]
                row = np.frombuffer(data[p : p + nb], _PIX_TYPE[ptype])
                out[name][y0 - ymin + r] = row.astype(np.float32)
                p += nb
    return out


def read_exr_depth(path: str) -> np.ndarray:
    """The depth channel of an EXR file, ``[H, W]`` float32."""
    chans = read_exr(path)
    for key in ("Y", "Z", "R"):
        if key in chans:
            return chans[key]
    return next(iter(chans.values()))
