"""The port's JPEG codec (``data/jpeg.py``) and image reader
(``data/datasets.py::read_image``) against OpenCV, which reads JPEG through
libjpeg-turbo.

The decoder reproduces libjpeg-turbo's default output (ISLOW IDCT, fancy
upsampling, the fixed-point YCbCr -> RGB tables), so the expected result is
equality with ``cv2.imread`` (channels swapped to RGB). The check allows at
most MAX_LEVELS level of difference on at most MAX_SHARE of the pixels and
prints what it found; measured: 0 pixels apart in every case here (37x53
and 36x48 images, qualities 50-100, 4:4:4 / 4:2:2 / 4:4:0 / 4:2:0, grey
files, grey reads of colour files, restart intervals, optimised tables).
The encoder's output decodes through cv2 as well as cv2's own encoder's
output does (see ``test_encoder_output_reads_in_cv2_and_in_the_decoder``).
"""

import itertools

import cv2
import numpy as np
import pytest

from evennicer_slam_tpu_torch.data import jpeg
from evennicer_slam_tpu_torch.data.datasets import read_image
from evennicer_slam_tpu_torch.data.png import write_png
from evennicer_slam_tpu_torch.data.synthetic import synthetic_frames
from torch_parity import cap_threads

cap_threads()

MAX_LEVELS = 1
MAX_SHARE = 1e-3
PSNR_MIN = 40.0
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _image(hw, seed=0):
    """Smooth colour waves plus noise: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c) for c in range(3)],
                    -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _assert_like(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, (what, got.shape, want.shape)
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    share = float((d > 0).mean())
    print(f"{what}: max diff {d.max()}, {share:.2e} of the pixels apart")
    assert d.max() <= MAX_LEVELS and share <= MAX_SHARE, (what, int(d.max()), share)


def _encode(bgr, *params):
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("hw,quality,sampling", list(itertools.product(
    [(37, 53), (36, 48)], [50, 75, 95, 100], ["444", "422", "420"])))
def test_decoder_equals_cv2(hw, quality, sampling):
    bgr = _image(hw, seed=quality)
    data = _encode(bgr, cv2.IMWRITE_JPEG_QUALITY, quality,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    _assert_like(jpeg.decode_jpeg(data), want, f"{hw} q{quality} {sampling}")
    grey = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    _assert_like(jpeg.decode_jpeg(data, grayscale=True), grey,
                 f"{hw} q{quality} {sampling} read as grey")


@pytest.mark.parametrize("case", ["grey file", "440", "restart 1", "restart 3",
                                  "optimised tables", "restart + optimised"])
def test_decoder_equals_cv2_on_other_streams(case, tmp_path):
    bgr = _image((37, 53), seed=3)
    params = {"440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["440"]],
              "restart 1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
              "restart 3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
              "optimised tables": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
              "restart + optimised": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                      cv2.IMWRITE_JPEG_OPTIMIZE, 1]}.get(case, [])
    src = bgr[..., 1] if case == "grey file" else bgr
    data = _encode(src, *params)
    if case.startswith("restart"):
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for flag, grey in ((cv2.IMREAD_COLOR, False), (cv2.IMREAD_GRAYSCALE, True)):
        want = cv2.imread(path, flag)
        _assert_like(read_image(path, grayscale=grey), want[..., ::-1] if want.ndim == 3 else
                     want, f"{case}, grey={grey}")


def test_progressive_and_twelve_bit_files_raise():
    data = _encode(_image((16, 16)), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(ValueError, match="SOF2 \\(progressive\\)"):
        jpeg.decode_jpeg(data)
    baseline = _encode(_image((16, 16)))
    at = baseline.index(b"\xff\xc0")
    twelve = baseline[:at + 4] + bytes([12]) + baseline[at + 5:]
    with pytest.raises(ValueError, match="SOF0 with 12-bit"):
        jpeg.decode_jpeg(twelve)
    arith = baseline[:at + 1] + b"\xc9" + baseline[at + 2:]
    with pytest.raises(ValueError, match="SOF9 \\(arithmetic"):
        jpeg.decode_jpeg(arith)


def test_png_bytes_under_a_jpg_name_read_as_png(tmp_path):
    rgb = _image((20, 30))
    path = str(tmp_path / "frame000000.jpg")
    write_png(path, rgb)
    np.testing.assert_array_equal(read_image(path), rgb)
    # an RGB PNG read as grey: libpng's weights, as cv2.imread applies them
    np.testing.assert_array_equal(read_image(path, grayscale=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    grey = rgb[..., 0]
    write_png(path, grey)
    np.testing.assert_array_equal(read_image(path), cv2.imread(path)[..., ::-1])
    with open(path, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(path)


def _room_frame():
    rgb = next(iter(synthetic_frames(n_frames=1, H=68, W=120, fx=60.0, fy=60.0,
                                     furnished=True))).color
    return (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)


def _smooth(hw):
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    noise = np.random.default_rng(1).normal(0, 2, hw + (3,))
    return np.clip(np.stack([128 + 100 * np.sin(x / 37.0 + c) * np.cos(y / 25.0 - c)
                             for c in range(3)], -1) + noise, 0, 255).astype(np.uint8)


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


@pytest.mark.parametrize("kind", ["colour", "grey", "room"])
def test_encoder_output_reads_in_cv2_and_in_the_decoder(kind, tmp_path):
    """The port writes 4:2:0 (one component for grey) at quality 95. cv2
    decodes it to within 0.1 dB of the PSNR of cv2's own encoder at its
    defaults, and at PSNR_MIN or more on a smooth image (colour waves with
    noise of sigma 2: measured 41.59 dB colour, 44.77 dB grey). The
    furnished room at 68x120 has colour edges a pixel or two wide, which
    4:2:0 halves: 31.71 dB (cv2 31.73 dB; 41.2 dB at 680x1200).
    The port's decoder reads the file as cv2 does."""
    src = {"colour": _smooth((68, 120)), "grey": _smooth((68, 120))[..., 1].copy(),
           "room": _room_frame()}[kind]
    path = str(tmp_path / "x.jpg")
    jpeg.write_jpeg(path, src, quality=95)
    data = open(path, "rb").read()
    flag = cv2.IMREAD_GRAYSCALE if kind == "grey" else cv2.IMREAD_COLOR
    dec = cv2.imread(path, flag)
    ref = cv2.imdecode(np.frombuffer(_encode(src if kind == "grey" else src[..., ::-1],
                                             cv2.IMWRITE_JPEG_QUALITY, 95), np.uint8), flag)
    if kind != "grey":
        assert bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]) in data  # 4:2:0
        dec, ref = dec[..., ::-1], ref[..., ::-1]
    psnr, psnr_cv2 = _psnr(dec, src), _psnr(ref, src)
    print(f"{kind}: PSNR {psnr:.2f} dB (cv2's encoder {psnr_cv2:.2f} dB), {len(data)} bytes")
    assert psnr >= psnr_cv2 - 0.1
    if kind != "room":
        assert psnr >= PSNR_MIN
    _assert_like(jpeg.decode_jpeg(data), dec, f"port-encoded {kind}")


def test_encoder_tables_are_cv2s_at_its_defaults():
    """Quality 95's quantisation tables and the standard Huffman tables: the
    DQT and DHT segments cv2 writes at its defaults."""
    ref = _encode(_image((16, 16)), cv2.IMWRITE_JPEG_QUALITY, 95)
    mine = jpeg.encode_jpeg(_image((16, 16))[..., ::-1], 95)

    def segments(data, marker):
        out, at = [], 0
        while (at := data.find(b"\xff" + bytes([marker]), at)) >= 0:
            n = int.from_bytes(data[at + 2:at + 4], "big")
            out.append(data[at + 4:at + 2 + n])
            at += 2 + n
        return b"".join(out)

    assert segments(mine, 0xDB) == segments(ref, 0xDB)

    def tables(body):
        found, at = {}, 0
        while at < len(body):
            n = sum(body[at + 1:at + 17])
            found[body[at]] = body[at + 1:at + 17 + n]
            at += 17 + n
        return found

    assert tables(segments(mine, 0xC4)) == tables(segments(ref, 0xC4))
