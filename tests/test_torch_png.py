"""The port's PNG codec (``evennicer_slam_tpu_torch/data/png.py``) against
OpenCV, which the JAX package reads and writes its scenes with (only the
tests import cv2: the machine with the card has none).

Every comparison is exact: PNG is lossless. Images are made from a numpy
seed; the test's own encoder writes any row filter (the port's encoder and
cv2 write Sub on every row), and cv2 checks that encoder too.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from evennicer_slam_tpu_torch.data import png
from torch_parity import cap_threads

cap_threads()

_TYPE = {1: 0, 3: 2, 4: 6}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(kind, row, prev, bpp):
    """Filter one row of bytes, byte by byte (PNG specification, section 9)."""
    out = []
    for x, v in enumerate(row):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((v - pred) % 256)
    return out


def encode_with_filters(img, kinds, idat_bytes=7):
    """PNG bytes of ``img`` with row ``y`` filtered by ``kinds[y % len(kinds)]``
    and the compressed stream split into IDAT chunks of ``idat_bytes``."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    bpp = c * img.dtype.itemsize
    raw = img.astype(img.dtype.newbyteorder(">")).tobytes()
    stride = w * bpp
    prev, body = [0] * stride, b""
    for y in range(h):
        row = list(raw[y * stride:(y + 1) * stride])
        kind = kinds[y % len(kinds)]
        body += bytes([kind] + _filter_row(kind, row, prev, bpp))
        prev = row
    stream = zlib.compress(body)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, _TYPE[c], 0, 0, 0)
    idat = b"".join(chunk(b"IDAT", stream[i:i + idat_bytes])
                    for i in range(0, len(stream), idat_bytes))
    return png.SIGNATURE + chunk(b"IHDR", ihdr) + idat + chunk(b"IEND", b"")


def _image(seed, dtype, channels, h=9, w=11):
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=np.int64).astype(dtype)


def _cv2_to_file_order(a):
    """cv2's BGR / BGRA -> the file's RGB / RGBA."""
    if a.ndim == 3:
        return a[..., [2, 1, 0, 3][:a.shape[2]]]
    return a


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decoder_reads_every_filter_depth_and_channel_count(dtype, channels, kinds):
    img = _image(sum(kinds) * 7 + channels, dtype, channels)
    data = encode_with_filters(img, kinds)
    got = png.decode_png(data)
    assert got.dtype == dtype and np.array_equal(got, img)
    # cv2 agrees that the test's file holds ``img``
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(_cv2_to_file_order(ref), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_port_encoded_files_read_back_by_cv2(tmp_path, dtype, channels):
    img = _image(100 + channels, dtype, channels, h=70, w=300)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref.dtype == dtype and np.array_equal(_cv2_to_file_order(ref), img)
    assert np.array_equal(png.read_png(path), img)


def test_encoder_writes_sub_rows_in_several_idat_chunks():
    img = _image(3, np.uint8, 3, h=200, w=300)
    data = png.encode_png(img)
    kinds = [k for k, _ in png._chunks(data, "x")]
    assert kinds.count(b"IDAT") > 1
    body = zlib.decompress(b"".join(b for k, b in png._chunks(data, "x") if k == b"IDAT"))
    assert set(np.frombuffer(body, np.uint8).reshape(200, -1)[:, 0]) == {1}


def test_cv2_written_frames_decode_as_cv2_reads_them(tmp_path):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:48, :64]
    colour = (np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) + rng.integers(0, 8, (48, 64, 3)))
    colour = colour.astype(np.uint8)
    depth = (yy * 900 + xx * 37 + rng.integers(0, 50, (48, 64))).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "c.png"), colour)   # cv2 writes BGR arrays
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    got_c = png.read_png(str(tmp_path / "c.png"))
    assert np.array_equal(got_c, cv2.cvtColor(cv2.imread(str(tmp_path / "c.png")),
                                              cv2.COLOR_BGR2RGB))
    assert np.array_equal(png.read_png(str(tmp_path / "d.png")),
                          cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_UNCHANGED))


def test_malformed_files_raise():
    img = _image(1, np.uint8, 3)
    data = bytearray(png.encode_png(img))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    bad = bytearray(data)
    bad[40] ^= 0xFF  # inside the first IDAT: its CRC no longer matches
    with pytest.raises(ValueError, match="corrupt"):
        png.decode_png(bytes(bad))
    interlaced = bytearray(png.encode_png(img))
    interlaced[28] = 1  # IHDR interlace byte, with its CRC fixed up
    interlaced[29:33] = struct.pack(">I", zlib.crc32(bytes(interlaced[12:29])))
    with pytest.raises(ValueError, match="not supported"):
        png.decode_png(bytes(interlaced))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode_png(img.astype(np.float32))
