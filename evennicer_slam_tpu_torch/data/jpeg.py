"""JPEG codec in numpy (the port reads Replica, ScanNet and Azure colour
frames and writes its visualiser panels without OpenCV; the JAX package
calls ``cv2.imread`` / ``cv2.imwrite``).

Decoding reads baseline and extended-sequential 8-bit Huffman files (SOF0,
SOF1): one or three components with sampling factors up to 2x2,
interleaved and non-interleaved scans, restart intervals, byte stuffing and
any Huffman tables the file defines. It reproduces libjpeg-turbo's default
output, which ``cv2.imread`` returns: the ``ISLOW`` integer IDCT
(``jidctint.c``), "fancy" triangular upsampling (``jdsample.c``: h2v1, h1v2,
h2v2) and the fixed-point YCbCr -> RGB tables of ``jdcolor.c``.
Progressive, arithmetic-coded, lossless and 12-bit files raise
``ValueError`` naming their SOF marker.

The Huffman walk is the one loop over symbols in Python: a 16-bit lookahead
table gives each code's length and symbol, and the bits come from 64-bit
windows of the entropy-coded bytes. Dequantisation, the IDCT (all blocks of
a component at once), upsampling and colour conversion are numpy.

Encoding writes what ``cv2.imwrite`` writes at its defaults: baseline, 4:2:0
(one component for grey), the Annex K quantisation tables scaled by the IJG
quality formula and the standard Huffman tables. Its Huffman stage is
vectorised: the code and extra bits of every symbol, then bit-packed.

Arrays are RGB (the file's order), never BGR as cv2 returns them.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

import numpy as np

SOI = b"\xff\xd8"
# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# SOF markers this decoder does not read
_UNSUPPORTED_SOF = {
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (differential arithmetic sequential)",
    0xCE: "SOF14 (differential arithmetic progressive)",
    0xCF: "SOF15 (differential arithmetic lossless)",
}
# a run of 0xFF then a marker code: the end of a scan's entropy-coded data
# (restart markers 0xD0-0xD7 split it into intervals)
_MARKER = re.compile(rb"\xff+[^\x00\xff]")


# ---- Huffman tables -------------------------------------------------------------------

def _canonical_codes(bits, vals) -> Tuple[List[int], List[int]]:
    """Code and code length of each symbol of a table (JPEG Annex C)."""
    codes, lengths, code = [], [], 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes.append(code)
            lengths.append(length)
            code += 1
        code <<= 1
    if len(codes) != len(vals):
        raise ValueError("Huffman table: code counts and symbols disagree")
    return codes, lengths


def _lookahead(bits, vals) -> List[int]:
    """16-bit lookahead table: ``(length << 8) | symbol`` for every 16-bit
    prefix, 0 where no code starts."""
    table = [0] * 65536
    for c, n, v in zip(*_canonical_codes(bits, vals), vals):
        lo = c << (16 - n)
        if lo >= 65536:
            raise ValueError("Huffman table: codes overflow 16 bits")
        table[lo:lo + (1 << (16 - n))] = [(n << 8) | v] * (1 << (16 - n))
    return table


# ---- the integer IDCT of jidctint.c (jpeg_idct_islow) ----------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: int(val * (1 << _CONST_BITS) + 0.5) for name, val in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _islow_pass(x: np.ndarray, axis: int, shift: int) -> np.ndarray:
    """One pass of ``jpeg_idct_islow`` along ``axis`` (length 8), int64,
    descaled by ``shift`` bits with rounding."""
    g = [np.take(x, i, axis=axis) for i in range(8)]
    z1 = (g[2] + g[6]) * _F["0_541196100"]
    tmp2 = z1 - g[6] * _F["1_847759065"]
    tmp3 = z1 + g[2] * _F["0_765366865"]
    tmp0 = (g[0] + g[4]) << _CONST_BITS
    tmp1 = (g[0] - g[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = g[7], g[5], g[3], g[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([(o + rnd) >> shift for o in outs], axis=axis)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients ``[N, 8, 8]`` (natural order, rows the
    vertical frequency) -> samples ``[N, 8, 8]`` uint8, with libjpeg's
    post-IDCT range limit (10-bit wrap, then clamp around 128)."""
    ws = _islow_pass(coef.astype(np.int64), 1, _CONST_BITS - _PASS1_BITS)
    out = _islow_pass(ws, 2, _CONST_BITS + _PASS1_BITS + 3) & 1023
    out = np.where(out >= 512, out - 1024, out)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# ---- upsampling (jdsample.c, fancy) and colour (jdcolor.c) ----------------------------

def _up_h2v1(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int32)
    w = p.shape[1]
    out = np.empty((p.shape[0], 2 * w), np.int32)
    out[:, 0] = p[:, 0]
    out[:, 2::2] = (3 * p[:, 1:] + p[:, :-1] + 1) >> 2
    out[:, 1:-1:2] = (3 * p[:, :-1] + p[:, 1:] + 2) >> 2
    out[:, -1] = p[:, -1]
    return out


def _up_h1v2(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]])
    below = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (3 * p + above + 1) >> 2
    out[1::2] = (3 * p + below + 2) >> 2
    return out


def _up_h2v2(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int32)
    above = np.concatenate([p[:1], p[:-1]])
    below = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for v, nbr in ((0, above), (1, below)):
        cs = 3 * p + nbr
        row = out[v::2]
        row[:, 0] = (4 * cs[:, 0] + 8) >> 4
        row[:, 2::2] = (3 * cs[:, 1:] + cs[:, :-1] + 8) >> 4
        row[:, 1:-1:2] = (3 * cs[:, :-1] + cs[:, 1:] + 7) >> 4
        row[:, -1] = (4 * cs[:, -1] + 7) >> 4
    return out


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    if p.shape[1] < 2 and fh == 2:
        raise ValueError("JPEG: a subsampled component narrower than 2 samples")
    if (fh, fv) == (1, 1):
        return p
    return {(2, 1): _up_h2v1, (1, 2): _up_h1v2, (2, 2): _up_h2v2}[(fh, fv)](p)


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _ONE_HALF


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert``: uint8 planes -> ``[H, W, 3]`` uint8."""
    y = y.astype(np.int64)
    cb = cb.astype(np.intp)
    cr = cr.astype(np.intp)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's ``rgb_gray_convert``, for an RGB-coded file read as grey."""
    rgb = rgb.astype(np.int64)
    y = (_fix(0.299) * rgb[..., 0] + _fix(0.587) * rgb[..., 1] + _fix(0.114) * rgb[..., 2]
         + _ONE_HALF) >> _SCALEBITS
    return y.astype(np.uint8)


# ---- decoding ------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "tq", "quant", "coef", "bw", "bh", "grid_w")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None


def _entropy_windows(seg: bytes) -> List[int]:
    """64-bit big-endian window at every byte of an unstuffed segment."""
    raw = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + bytes(8), np.uint8)
    n = raw.size - 7
    w = np.zeros(n, np.uint64)
    for k in range(8):
        w |= raw[k:k + n].astype(np.uint64) << np.uint64(56 - 8 * k)
    return w.tolist()


def _decode_interval(seg: bytes, steps, dc_tabs, ac_tabs, pos: list, val: list) -> None:
    """Huffman-decode the blocks of one restart interval. ``steps`` holds,
    per block in decode order, (component slot, 64 x global block index);
    each coefficient is appended as (64 * block + zigzag index) to ``pos``
    and its value to ``val``."""
    win = _entropy_windows(seg)
    pos_append, val_append = pos.append, val.append
    pred = [0] * len(dc_tabs)
    p = 0
    try:
        for slot, base in steps:
            dct, act = dc_tabs[slot], ac_tabs[slot]
            x = (win[p >> 3] >> (32 - (p & 7))) & 0xFFFFFFFF
            e = dct[x >> 16]
            n = e >> 8
            if not n:
                raise ValueError("JPEG: bad Huffman code")
            s = e & 255
            p += n
            if s:
                d = (x >> (32 - n - s)) & ((1 << s) - 1)
                if d < (1 << (s - 1)):
                    d -= (1 << s) - 1
                p += s
                pred[slot] += d
            pos_append(base)
            val_append(pred[slot])
            k = 1
            while k < 64:
                x = (win[p >> 3] >> (32 - (p & 7))) & 0xFFFFFFFF
                e = act[x >> 16]
                n = e >> 8
                if not n:
                    raise ValueError("JPEG: bad Huffman code")
                rs = e & 255
                s = rs & 15
                p += n
                if s:
                    k += rs >> 4
                    d = (x >> (32 - n - s)) & ((1 << s) - 1)
                    if d < (1 << (s - 1)):
                        d -= (1 << s) - 1
                    p += s
                    pos_append(base + k)
                    val_append(d)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
    except IndexError:
        raise ValueError("JPEG: entropy-coded data ends inside a block") from None


def _scan_steps(comps: List[_Component], mcux: int, mcuy: int,
                offsets: Dict[int, int]) -> List[Tuple[int, int]]:
    """(slot, 64 * global block index) of every block of a scan, in decode order."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.mgrid[0:c.bh, 0:c.bw]
        idx = offsets[c.cid] + by * c.grid_w + bx
        return [(0, int(b) * 64) for b in idx.reshape(-1)]
    cols = []
    for slot, c in enumerate(comps):
        my, mx, vy, hx = np.meshgrid(np.arange(mcuy), np.arange(mcux), np.arange(c.v),
                                     np.arange(c.h), indexing="ij")
        idx = offsets[c.cid] + (my * c.v + vy) * c.grid_w + mx * c.h + hx
        cols.append((slot, idx.reshape(mcuy * mcux, c.v * c.h)))
    per_mcu = np.concatenate([i for _, i in cols], axis=1)
    slots = np.concatenate([np.full(i.shape[1], s) for s, i in cols])
    return list(zip(np.broadcast_to(slots, per_mcu.shape).reshape(-1).tolist(),
                    (per_mcu.reshape(-1) * 64).tolist()))


def decode_jpeg(data: bytes, grayscale: bool = False, path: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> ``[H, W, 3]`` RGB uint8 (``[H, W]`` for a
    one-component file), or with ``grayscale`` the ``[H, W]`` luminance, as
    ``cv2.IMREAD_GRAYSCALE`` returns it."""
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    dc_tables: Dict[int, list] = {}
    ac_tables: Dict[int, list] = {}
    quant: Dict[int, np.ndarray] = {}
    comps: List[_Component] = []
    restart = 0
    adobe_transform = None
    frame = None
    coefs = None
    offsets: Dict[int, int] = {}
    coef_pos: list = []
    coef_val: list = []
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEG files are not supported "
                             "(baseline and extended sequential Huffman only)")
        if marker == 0xCC:
            raise ValueError(f"{path}: DAC (arithmetic coding) is not supported")
        if marker in (0xC0, 0xC1):
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                name = "SOF0" if marker == 0xC0 else "SOF1"
                raise ValueError(f"{path}: {name} with {precision}-bit samples is not "
                                 "supported (8-bit only)")
            if height == 0:
                raise ValueError(f"{path}: a height given by a DNL marker is not supported")
            if nf not in (1, 3):
                raise ValueError(f"{path}: {nf} components (1 or 3 are supported)")
            for i in range(nf):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            if nf == 1:
                comps[0].h = comps[0].v = hmax = vmax = 1
            for c in comps:
                if hmax % c.h or vmax % c.v or hmax // c.h > 2 or vmax // c.v > 2:
                    raise ValueError(f"{path}: sampling factors {[(d.h, d.v) for d in comps]} "
                                     "are not supported (ratios 1 or 2)")
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            total = 0
            for c in comps:
                c.bw = -(-(-(-width * c.h // hmax)) // 8)
                c.bh = -(-(-(-height * c.v // vmax)) // 8)
                c.grid_w = mcux * c.h
                offsets[c.cid] = total
                total += mcuy * c.v * c.grid_w
            frame = (height, width, hmax, vmax, mcux, mcuy)
            coefs = np.zeros(total * 64, np.int64)
        elif marker == 0xC4:  # DHT
            off = 0
            while off < len(body):
                tc_th = body[off]
                bits = list(body[off + 1:off + 17])
                nv = sum(bits)
                vals = list(body[off + 17:off + 17 + nv])
                (dc_tables if tc_th >> 4 == 0 else ac_tables)[tc_th & 15] = _lookahead(bits, vals)
                off += 17 + nv
        elif marker == 0xDB:  # DQT
            off = 0
            while off < len(body):
                pq, tq = body[off] >> 4, body[off] & 15
                if pq:
                    q = np.frombuffer(body[off + 1:off + 129], ">u2").astype(np.int64)
                    off += 129
                else:
                    q = np.frombuffer(body[off + 1:off + 65], np.uint8).astype(np.int64)
                    off += 65
                nat = np.empty(64, np.int64)
                nat[ZIGZAG] = q
                quant[tq] = nat
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: SOS before SOF")
            ns = body[0]
            by_id = {c.cid: c for c in comps}
            scan, dc_tabs, ac_tabs = [], [], []
            for i in range(ns):
                cs, tda = body[1 + 2 * i:3 + 2 * i]
                c = by_id[cs]
                if c.quant is None:  # latched at the component's first scan
                    c.quant = quant[c.tq]
                scan.append(c)
                dc_tabs.append(dc_tables[tda >> 4])
                ac_tabs.append(ac_tables[tda & 15])
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahl) != (0, 63, 0):
                raise ValueError(f"{path}: spectral selection {ss}-{se}, approximation "
                                 f"{ahl} in a sequential file")
            steps = _scan_steps(scan, frame[4], frame[5], offsets)
            per_interval = len(steps) if restart == 0 else restart * (
                1 if ns == 1 else sum(c.h * c.v for c in scan))
            start = pos
            done = 0
            for m in _MARKER.finditer(data, pos):
                code = data[m.end() - 1]
                _decode_interval(data[start:m.start()], steps[done:done + per_interval],
                                 dc_tabs, ac_tabs, coef_pos, coef_val)
                done += per_interval
                start = m.end()
                if not 0xD0 <= code <= 0xD7:
                    pos = m.start()
                    break
            else:
                raise ValueError(f"{path}: the scan has no end marker")
        # APPn, COM and anything else: skipped
    if frame is None or not coef_pos:
        raise ValueError(f"{path}: no image data")
    height, width, hmax, vmax, mcux, mcuy = frame
    at = np.asarray(coef_pos, np.int64)
    coefs[(at & ~63) + ZIGZAG[at & 63]] = np.asarray(coef_val, np.int64)

    rgb_coded = len(comps) == 3 and (
        adobe_transform == 0
        or (adobe_transform is None and [c.cid for c in comps] == [82, 71, 66]))
    wanted = comps[:1] if grayscale and not rgb_coded else comps
    planes = []
    for c in wanted:
        if c.quant is None:
            raise ValueError(f"{path}: component {c.cid} has no scan")
        rows = mcuy * c.v
        blk = coefs[offsets[c.cid] * 64:(offsets[c.cid] + rows * c.grid_w) * 64]
        samples = idct_islow(blk.reshape(-1, 8, 8) * c.quant.reshape(8, 8))
        plane = samples.reshape(rows, c.grid_w, 8, 8).transpose(0, 2, 1, 3).reshape(
            rows * 8, c.grid_w * 8)
        dh, dw = -(-height * c.v // vmax), -(-width * c.h // hmax)
        plane = _upsample(plane[:dh, :dw], hmax // c.h, vmax // c.v)
        planes.append(plane[:height, :width].astype(np.uint8))
    if len(planes) == 1:
        return planes[0]
    if rgb_coded:
        rgb = np.stack(planes, axis=-1)
        return rgb_to_grey(rgb) if grayscale else rgb
    return ycc_to_rgb(*planes)


# ---- encoding ------------------------------------------------------------------------

# Annex K.1 quantisation tables, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)


def _ac_values(head: List[int]) -> List[int]:
    """An Annex K.3 AC table's symbols: its irregular head, then every
    other run/size symbol in increasing order."""
    rest = [r << 4 | s for r in range(16) for s in range(1, 11)]
    return head + [v for v in rest if v not in head]


# Annex K.3 Huffman tables: (counts of codes of length 1-16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1]))


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Annex K tables scaled by the IJG quality formula (``jcparam.c``),
    limited to 1-255 for baseline. Natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA))


def _code_arrays(table) -> Tuple[np.ndarray, np.ndarray]:
    """Per-symbol (code, length) arrays of 256 entries."""
    codes, lengths = _canonical_codes(*table)
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    code[table[1]] = codes
    length[table[1]] = lengths
    return code, length


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """``[8R, 8C]`` plane -> ``[R, C, 8, 8]`` blocks."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3)


def _quantised(plane: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """Forward DCT and quantisation of a plane's blocks -> ``[R, C, 64]``
    int64 in zigzag order."""
    b = _blocks(plane.astype(np.float64) - 128.0)
    d = _DCT @ b @ _DCT.T
    q = np.rint(d / qtab.reshape(8, 8)).astype(np.int64)
    return q.reshape(*q.shape[:2], 64)[..., ZIGZAG]


def _size(v: np.ndarray) -> np.ndarray:
    """Bits needed for ``|v|`` (JPEG's SSSS category)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << s) - 1, v)


def _entropy_code(blocks: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code ``blocks`` ``[N, 64]`` (zigzag order, in scan order;
    ``comp[i]`` is block i's component, ``tables[c]`` component c's (DC, AC)
    tables) -> stuffed scan bytes."""
    nb = blocks.shape[0]
    dc_codes = [_code_arrays(t[0]) for t in tables]
    ac_codes = [_code_arrays(t[1]) for t in tables]
    # DC differences within each component, in scan order
    dc = blocks[:, 0].copy()
    diff = np.empty(nb, np.int64)
    for c in range(len(tables)):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    # events sorted by (block, coefficient, sub-event); each is a Huffman
    # code followed by extra bits, at most 27 bits together
    keys, vals, lens = [], [], []

    def add(key, code, clen, extra, elen):
        keys.append(key)
        vals.append((code << elen) | extra)
        lens.append(clen + elen)

    s = _size(diff)
    dcc = np.stack([dc_codes[c][0] for c in range(len(tables))])[comp, s]
    dcl = np.stack([dc_codes[c][1] for c in range(len(tables))])[comp, s]
    add(np.arange(nb) * 1024, dcc, dcl, _extra(diff, s), s)

    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[b, k]
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    acc = np.stack([ac_codes[c][0] for c in range(len(tables))])
    acl = np.stack([ac_codes[c][1] for c in range(len(tables))])
    cb = comp[b]
    n_zrl = run // 16
    if n_zrl.any():
        zb = np.repeat(np.arange(b.size), n_zrl)
        j = np.arange(zb.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        add(b[zb] * 1024 + k[zb] * 16 + j, acc[cb[zb], 0xF0], acl[cb[zb], 0xF0],
            np.zeros(zb.size, np.int64), np.zeros(zb.size, np.int64))
    s = _size(v)
    sym = (run % 16) * 16 + s
    add(b * 1024 + k * 16 + 15, acc[cb, sym], acl[cb, sym], _extra(v, s), s)
    # end of block, unless the last coefficient is non-zero
    eob = blocks[:, 63] == 0
    bi = np.flatnonzero(eob)
    add(bi * 1024 + 1023, acc[comp[bi], 0], acl[comp[bi], 0],
        np.zeros(bi.size, np.int64), np.zeros(bi.size, np.int64))

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    aligned = (val << (32 - ln)).astype(">u4").view(np.uint8).reshape(-1, 4)
    bits = np.unpackbits(aligned, axis=1)[np.arange(32)[None, :] < ln[:, None]]
    pad = (-bits.size) % 8
    packed = np.packbits(np.concatenate([bits, np.ones(pad, np.uint8)]))
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dht(tc_th: int, table) -> bytes:
    return bytes([tc_th]) + bytes(table[0]) + bytes(table[1])


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """``[H, W, 3]`` RGB or ``[H, W]`` grey uint8 -> baseline JPEG bytes:
    4:2:0 for colour, the Annex K tables at ``quality``, the standard
    Huffman tables."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected [H, W] or [H, W, 3] uint8, got {img.shape} {img.dtype}")
    H, W = img.shape[:2]
    q_luma, q_chroma = quality_tables(quality)
    colour = img.ndim == 3
    mcu = 16 if colour else 8
    ph, pw = -(-H // mcu) * mcu, -(-W // mcu) * mcu
    x = np.pad(img.astype(np.int64), ((0, ph - H), (0, pw - W)) + ((0, 0),) * (img.ndim - 2),
               mode="edge")
    if colour:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> 16
        cb = (-_fix(0.16874) * r - _fix(0.33126) * g + (b << 15) + (128 << 16)
              + _ONE_HALF - 1) >> 16
        cr = ((r << 15) - _fix(0.41869) * g - _fix(0.08131) * b + (128 << 16)
              + _ONE_HALF - 1) >> 16
        bias = np.tile([1, 2], pw // 2)[: pw // 2]

        def down(p):
            s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            return (s + bias) >> 2

        qy = _quantised(y, q_luma)
        qcb = _quantised(down(cb), q_chroma)
        qcr = _quantised(down(cr), q_chroma)
        my, mx = ph // 16, pw // 16
        yb = qy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
        blocks = np.concatenate([yb, qcb[:, :, None], qcr[:, :, None]], axis=2).reshape(-1, 64)
        comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
        tables = [(_DC_LUMA, _AC_LUMA)] + [(_DC_CHROMA, _AC_CHROMA)] * 2
        sof_comps = bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
        sos_comps = bytes([1, 0x00, 2, 0x11, 3, 0x11])
        dqt = bytes([0]) + bytes(q_luma[ZIGZAG].tolist()) + bytes([1]) + bytes(
            q_chroma[ZIGZAG].tolist())
        dht = (_dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA) + _dht(0x01, _DC_CHROMA)
               + _dht(0x11, _AC_CHROMA))
    else:
        blocks = _quantised(x, q_luma).reshape(-1, 64)
        comp = np.zeros(blocks.shape[0], np.int64)
        tables = [(_DC_LUMA, _AC_LUMA)]
        sof_comps = bytes([1, 0x11, 0])
        sos_comps = bytes([1, 0x00])
        dqt = bytes([0]) + bytes(q_luma[ZIGZAG].tolist())
        dht = _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
    nc = len(sof_comps) // 3
    scan = _entropy_code(blocks, comp, tables)
    return b"".join([
        SOI,
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, dqt),
        _segment(0xC0, struct.pack(">BHHB", 8, H, W, nc) + sof_comps),
        _segment(0xC4, dht),
        _segment(0xDA, bytes([nc]) + sos_comps + bytes([0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Encode ``img`` (see :func:`encode_jpeg`) into the file at ``path``."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
