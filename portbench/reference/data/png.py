"""PNG codec in numpy and ``zlib`` (the port reads and writes its scenes
without OpenCV; the JAX package calls ``cv2.imread`` / ``cv2.imwrite``).

Non-interlaced images only: 8- or 16-bit samples, grey, RGB or RGBA. Arrays
come back in the file's channel order (RGB), never BGR as cv2 returns them:
a caller that mirrors cv2 code swaps channels itself.

Decoding implements all five row filters. Sub (1) is the fast path, a
wrapping ``uint8`` cumulative sum along the row: cv2 at its default
settings writes Sub on every row, and so does :func:`write_png`. None and Up
are a vector operation a row; Average and Paeth depend on the decoded pixel
to their left and run a Python loop over the pixels of a row (correct and
slow).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}
IDAT_BYTES = 1 << 16  # the encoder splits its compressed stream into chunks of this size
# zlib level of the encoder: the fastest (a 680x1200 colour frame in about 20 ms
# on one CPU core, about twice the size of level 6, which takes four times as long)
ZLIB_LEVEL = 1


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or corrupt")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One reconstructed row of bytes from its filtered bytes ``line`` and
    the reconstructed row above, ``prev``."""
    if kind == 0:
        return line
    if kind == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG row filter {kind}")
    out = np.zeros(line.shape, np.int32)
    raw, up = line.astype(np.int32), prev.astype(np.int32)
    left = upleft = np.zeros(bpp, np.int32)
    for x in range(0, line.size, bpp):
        b = up[x:x + bpp]
        pred = (left + b) >> 1 if kind == 3 else _paeth(left, b, upleft)
        left = (raw[x:x + bpp] + pred) & 0xFF
        out[x:x + bpp] = left
        upleft = b
    return out.astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes -> ``[H, W]`` (grey) or ``[H, W, C]`` array of
    ``uint8`` or ``uint16``, channels in file order."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"{path}: colour type {colour}, bit depth {depth}, interlace "
                         f"{interlace} is not supported (grey/RGB/RGBA, 8 or 16 bits, "
                         "not interlaced)")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data is {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    kinds = rows[:, 0]
    pix = rows[:, 1:].copy()
    if np.all(kinds <= 1):
        # no row depends on the row above: every Sub row at once
        sub = kinds == 1
        pix[sub] = np.cumsum(pix[sub].reshape(-1, width, bpp), axis=1,
                             dtype=np.uint8).reshape(-1, stride)
    else:
        prev = np.zeros(stride, np.uint8)
        for y in range(height):
            prev = pix[y] = _unfilter_row(int(kinds[y]), pix[y], prev, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16)
    else:
        img = pix
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """``[H, W]`` or ``[H, W, C]`` (C = 1, 3, 4) ``uint8`` / ``uint16`` array
    -> PNG bytes, channels in file order, the Sub filter on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"expected [H, W] or [H, W, 1|3|4], got {img.shape}")
    height, width, channels = img.shape
    depth = 8 * img.dtype.itemsize
    bpp = channels * img.dtype.itemsize
    pix = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    pix = pix.reshape(height, width * bpp)
    filtered = pix.copy()
    filtered[:, bpp:] -= pix[:, :-bpp]
    rows = np.concatenate([np.ones((height, 1), np.uint8), filtered], axis=1)
    stream = zlib.compress(rows.tobytes(), ZLIB_LEVEL)
    header = struct.pack(">IIBBBBB", width, height, depth, _COLOUR_TYPE[channels], 0, 0, 0)
    idat = b"".join(_chunk(b"IDAT", stream[i:i + IDAT_BYTES])
                    for i in range(0, max(len(stream), 1), IDAT_BYTES))
    return SIGNATURE + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")


def write_png(path: str, img: np.ndarray) -> None:
    """Encode ``img`` (see :func:`encode_png`) into the file at ``path``."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
