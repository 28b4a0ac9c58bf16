"""JPEG decode and encode on numpy and the standard library, bit for bit
with libjpeg-turbo's defaults (the library under PIL and OpenCV).

- `decode_jpeg`: every 8-bit JPEG file libjpeg-turbo decodes, as PIL and
  OpenCV read it:
  - sequential Huffman (SOF0 / SOF1), progressive Huffman (SOF2; T.81
    Annex G: DC first and refinement scans, AC first scans with EOB runs,
    AC refinement with its correction bits), sequential and progressive
    arithmetic coding (SOF9 / SOF10; the QM decoder of Annex D with the
    DC and AC statistics of F.1.4.4 and G.1.3, DAC conditioning, default
    L = 0, U = 1, Kx = 5), and lossless Huffman (SOF3; Annex H,
    predictors 1-7 and the point transform);
  - 1, 3 or 4 components, sampling factors 1-4 in integer ratios,
    restart intervals (which reset DC predictions, EOB runs and the
    arithmetic statistics), 8- and 16-bit quantisation tables;
  - colour: JFIF YCbCr, RGB (an Adobe transform of 0 or the component
    ids 'R', 'G', 'B'), CMYK and YCCK (an Adobe transform other than 0,
    converted as `ycck_cmyk_convert` does) handed back as a `CMYK` array;
    a lossless file is RGB unless a marker says otherwise, and then
    raises, as libjpeg-turbo converts no colour space of it.
  The steps are libjpeg-turbo's default decode: the block smoothing of a
  progressive file whose coefficients 1-9 are not all known to full
  precision (`jdcoefct.c`, `decompress_smooth_data`: the 5x5 DC window,
  the DC itself estimated when no AC coefficient was coded), the integer
  "islow" IDCT (`jidctint.c`) with the range-limit table's 10-bit wrap,
  fancy upsampling (`jdsample.c`: the triangle filters of h2v1, h2v2 and
  h1v2 with their alternating biases, replication where a downsampled
  row is at most two samples wide, and for every other integer ratio
  and every lossless file), the fixed-point YCbCr -> RGB of `jdcolor.c`,
  the padded blocks cropped to the image.
- `encode_jpeg`: the file `cv2.imencode('.jpg')` writes at its defaults
  (PIL's at quality 95): JFIF APP0, `jpeg_set_quality`'s tables forced
  to baseline, 4:2:0 by `h2v2_downsample` (alternating bias 1, 2) after
  the edge expansion of `jcprepct.c`, `rgb_ycc_convert`'s tables, the
  islow FDCT (`jfdctint.c`), rounded quantisation, the dummy blocks of
  `jccoefct.c`, the standard Huffman tables, 0xFF stuffing and a last
  byte padded with 1 bits. Grey images are one component.
- `exif_orientation`: the EXIF orientation tag (1-8) of a file, or 1.
- `read_coefficients`: a file's quantised coefficients (the entropy
  decode alone); `frame_kind`: its SOF marker and component count.

What libjpeg-turbo does not decode raises `NotImplementedError` naming
that limit (PIL and OpenCV raise there too): hierarchical processes
(SOF5-7, SOF13-15), arithmetic-coded lossless (SOF11), precisions other
than 8 (PIL opens 8-bit files only), 2 components, fractional sampling
ratios. Corrupt or truncated data raises `ValueError`.

Only entropy decoding is sequential: a Python loop over Huffman symbols
with one 16-bit peek a symbol into a table that also holds the
coefficient's value when code and value fit 16 bits; the arithmetic
decoder a Python call a binary decision (several a coefficient, so an
arithmetic-coded file decodes several times slower than a Huffman one);
the lossless predictors 4-7, which read the sample just decoded, a loop
over samples. Everything after it, and the whole encoder, is vectorised
over all blocks in int64 numpy.
"""
from __future__ import annotations

import array
import re
import struct
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

# zigzag position -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# islow DCT constants (CONST_BITS 13)
_CONST_BITS = 13
_PASS1_BITS = 2
_F0_298 = 2446
_F0_390 = 3196
_F0_541 = 4433
_F0_765 = 6270
_F0_899 = 7373
_F1_175 = 9633
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_562 = 20995
_F3_072 = 25172

# ---------------------------------------------------------------------------
# the islow transforms
# ---------------------------------------------------------------------------

def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, shift):
    """One pass of `jpeg_idct_islow` along axis 1 of (N, 8, M) int64:
    the eight outputs, descaled by `shift`."""
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * _F0_541
    tmp2 = z1 - z3 * _F1_847
    tmp3 = z1 + z2 * _F0_765
    tmp0 = (x[:, 0] + x[:, 4]) << _CONST_BITS
    tmp1 = (x[:, 0] - x[:, 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0 = t0 * _F0_298
    t1 = t1 * _F2_053
    t2 = t2 * _F3_072
    t3 = t3 * _F1_501
    z1 = z1 * -_F0_899
    z2 = z2 * -_F2_562
    z3 = z3 * -_F1_961 + z5
    z4 = z4 * -_F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3],
                    1) + (1 << (shift - 1)) >> shift


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) uint8 samples, as
    `jpeg_idct_islow` with libjpeg's range-limit table: the descaled
    value wraps to 10 bits (signed), then +128 is clamped to [0, 255]."""
    c = coef.astype(np.int64)
    ws = _idct_1d(c, _CONST_BITS - _PASS1_BITS)  # columns
    out = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)
    out = out.transpose(0, 2, 1)  # rows
    v = out & 1023
    v = np.where(v >= 512, v - 1024, v)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _fdct_1d(x, even_shift, odd_shift, up):
    """One pass of `jpeg_fdct_islow` along axis 1 of (N, 8, M)."""
    tmp0, tmp7 = x[:, 0] + x[:, 7], x[:, 0] - x[:, 7]
    tmp1, tmp6 = x[:, 1] + x[:, 6], x[:, 1] - x[:, 6]
    tmp2, tmp5 = x[:, 2] + x[:, 5], x[:, 2] - x[:, 5]
    tmp3, tmp4 = x[:, 3] + x[:, 4], x[:, 3] - x[:, 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if up:
        o0, o4 = (tmp10 + tmp11) << up, (tmp10 - tmp11) << up
    else:
        o0 = _descale(tmp10 + tmp11, even_shift)
        o4 = _descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * _F0_541
    o2 = _descale(z1 + tmp13 * _F0_765, odd_shift)
    o6 = _descale(z1 - tmp12 * _F1_847, odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1_175
    tmp4 = tmp4 * _F0_298
    tmp5 = tmp5 * _F2_053
    tmp6 = tmp6 * _F3_072
    tmp7 = tmp7 * _F1_501
    z1 = z1 * -_F0_899
    z2 = z2 * -_F2_562
    z3 = z3 * -_F1_961 + z5
    z4 = z4 * -_F0_390 + z5
    o7 = _descale(tmp4 + z1 + z3, odd_shift)
    o5 = _descale(tmp5 + z2 + z4, odd_shift)
    o3 = _descale(tmp6 + z2 + z3, odd_shift)
    o1 = _descale(tmp7 + z1 + z4, odd_shift)
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], 1)


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples - 128 -> (N, 8, 8) coefficients scaled by 8, as
    `jpeg_fdct_islow` (rows, then columns)."""
    x = blocks.astype(np.int64).transpose(0, 2, 1)
    ws = _fdct_1d(x, 0, _CONST_BITS - _PASS1_BITS, _PASS1_BITS)
    ws = ws.transpose(0, 2, 1)  # rows done; back to (N, row, col)
    return _fdct_1d(ws, _PASS1_BITS, _CONST_BITS + _PASS1_BITS, 0)


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

def _fix(x):
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """`jdcolor.c::ycc_rgb_convert`: 16-bit fixed-point tables."""
    y = y.astype(np.int64)
    xb = cb.astype(np.int64) - 128
    xr = cr.astype(np.int64) - 128
    r = y + ((_fix(1.40200) * xr + 32768) >> 16)
    g = y + ((-_fix(0.34414) * xb + 32768 - _fix(0.71414) * xr) >> 16)
    b = y + ((_fix(1.77200) * xb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _rgb_to_ycc(rgb: np.ndarray):
    """`jccolor.c::rgb_ycc_convert` -> (y, cb, cr) int64 planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off + half - 1) >> 16
    return y, cb, cr


# ---------------------------------------------------------------------------
# upsampling (jdsample.c)
# ---------------------------------------------------------------------------

def _fancy_h2(x: np.ndarray, biases) -> np.ndarray:
    """The triangle filter doubling axis 1 of (rows, w) int64 samples,
    before its shift: out[2i] = 3 x[i] + x[i-1] + biases[0], out[2i+1] =
    3 x[i] + x[i+1] + biases[1], the edge samples replicated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = 3 * x + left + biases[0]
    out[:, 1::2] = 3 * x + right + biases[1]
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int, fancy=True) -> np.ndarray:
    """libjpeg-turbo's upsampling of one downsampled plane (its real rows
    and columns only) by the integer ratios (fh, fv): with `fancy`, the
    triangle filters of h2v1, h1v2 and h2v2; other ratios, and all
    without `fancy`, by replication (`int_upsample`)."""
    if fh == 1 and fv == 1:
        return plane
    x = plane.astype(np.int64)
    w = x.shape[1]
    if not fancy or (fh, fv) not in ((2, 1), (1, 2), (2, 2)) or (
            fh == 2 and w <= 2):
        return np.repeat(np.repeat(plane, fv, 0), fh, 1)
    if fv == 1:  # h2v1
        return (_fancy_h2(x, (1, 2)) >> 2).astype(np.uint8)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    if fh == 1:  # h1v2: (3 near + far + bias) >> 2, bias 1 above, 2 below
        out = np.empty((2 * x.shape[0], w), np.int64)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    out = np.empty((2 * x.shape[0], 2 * w), np.int64)
    out[0::2] = _fancy_h2(3 * x + above, (8, 7)) >> 4
    out[1::2] = _fancy_h2(3 * x + below, (8, 7)) >> 4
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

def _codes(counts, values):
    """Canonical Huffman codes: [(code, length, symbol)]."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((code, length, values[k]))
            code += 1
            k += 1
        code <<= 1
    return out


_TABLES: Dict[tuple, list] = {}


def _decode_table(counts, values, kind: str):
    """`_build_table`, kept for the next file with the same table."""
    key = (tuple(counts), tuple(values), kind)
    if key not in _TABLES:
        if len(_TABLES) >= 64:
            _TABLES.clear()
        _TABLES[key] = _build_table(counts, values, kind)
    return _TABLES[key]


def _build_table(counts, values, kind: str):
    """A 65536-entry list indexed by the next 16 bits of the stream:
    (bits consumed, run, value, extra bits still to read), or None for a
    code that is not in the table. With code and value within 16 bits
    the entry holds the value; otherwise `extra` bits follow. The symbol
    is read as `kind` says:
    - "dc": a size (run 0);
    - "ac": run / size, EOB (and, as libjpeg reads it, any zero size but
      ZRL's) as run 64, ZRL as run 15 with value 0;
    - "prog": run / size as they are (a zero size with value 0 is an EOB
      run of 2^run blocks, or ZRL at run 15);
    - "lossless": a size, 16 standing for the difference 32768 with no
      extra bits."""
    lengths = np.zeros(65536, np.int64)
    symbols = np.zeros(65536, np.int64)
    valid = np.zeros(65536, bool)
    for code, length, sym in _codes(counts, values):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        if hi > 65536:
            raise ValueError("corrupt JPEG Huffman table")
        lengths[lo:hi], symbols[lo:hi], valid[lo:hi] = length, sym, True
    p = np.arange(65536, dtype=np.int64)
    size = symbols & (31 if kind == "lossless" else 15)
    run = (symbols >> 4) if kind in ("ac", "prog") else np.zeros_like(symbols)
    if kind == "ac":
        run = np.where((size == 0) & (run != 15), 64, run)
    if kind == "lossless":
        wide = size >= 16
        size = np.where(wide, 0, size)
    total = lengths + size
    fits = total <= 16
    bits = np.where(fits, (p >> np.maximum(16 - total, 0))
                    & ((1 << size) - 1), 0)
    val = np.where(size > 0,
                   np.where(bits < (1 << np.maximum(size - 1, 0)),
                            bits - (1 << size) + 1, bits), 0)
    if kind == "lossless":
        val = np.where(wide, 32768, val)
    consumed = np.where(fits, total, lengths)
    extra = np.where(fits, 0, size)
    key = np.where(valid, ((consumed * 128 + run) * 131072 + val + 65536)
                   * 32 + extra, -1)
    uniq, inverse = np.unique(key, return_inverse=True)
    entries = [None if k < 0 else (int(k >> 29), int((k >> 22) & 127),
                                   int(((k >> 5) & 131071) - 65536),
                                   int(k & 31)) for k in uniq.tolist()]
    return [entries[i] for i in inverse.tolist()]


# ---------------------------------------------------------------------------
# the arithmetic decoder (T.81 Annex D; libjpeg-turbo's jdarith.c)
# ---------------------------------------------------------------------------

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) of each
# state, and 113, libjpeg's fixed 0.5 estimate of the sign bins
_QM = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
_QE = [q for q, _, _, _ in _QM]
_NLPS = [(sw << 7) | nl for _, nl, _, sw in _QM]  # with the MPS switch
_NMPS = [nm for _, _, nm, _ in _QM]


class _Arith:
    """The QM decoder over one restart interval's entropy-coded bytes;
    past their end it reads zeros, as libjpeg does at a marker.
    `bit(st, i)` decodes one decision with statistics bin `st[i]` (state
    index in bits 0-6, the more probable symbol in bit 7) and updates the
    bin."""
    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, seg: bytes):
        self.data = seg.replace(b"\xff\x00", b"\xff")
        self.pos, self.c, self.a, self.ct = 0, 0, 0, -16

    def bit(self, st, i) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ _NMPS[sv & 0x7F]
            else:
                st[i] = (sv & 0x80) ^ _NLPS[sv & 0x7F]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ _NLPS[sv & 0x7F]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ _NMPS[sv & 0x7F]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc_diff(dec, st, ctx, si, cond) -> int:
    """One DC difference (F.1.4.4.1) from statistics `st`; ctx[si] is the
    component's conditioning context, updated; cond = (L, U)."""
    s = ctx[si]
    if not dec.bit(st, s):
        ctx[si] = 0
        return 0
    sign = dec.bit(st, s + 1)
    s += 2 + sign
    m = dec.bit(st, s)
    if m:
        s = 20
        while dec.bit(st, s):
            m <<= 1
            if m == 0x8000:
                raise ValueError("corrupt JPEG arithmetic-coded data")
            s += 1
    L, U = cond
    if m < (1 << L) >> 1:
        ctx[si] = 0
    elif m > (1 << U) >> 1:
        ctx[si] = 12 + 4 * sign
    else:
        ctx[si] = 4 + 4 * sign
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if dec.bit(st, s):
            v |= m
    v += 1
    return -v if sign else v


def _arith_ac_value(dec, st, s, k, kx) -> int:
    """The magnitude of a nonzero AC coefficient at bin s = SN (F.1.4.4.2)
    and its sign from the fixed bin."""
    sign = dec.bit(_FIXED_BIN, 0)
    m = dec.bit(st, s)
    if m and dec.bit(st, s):
        m <<= 1
        s = 189 if k <= kx else 217
        while dec.bit(st, s):
            m <<= 1
            if m == 0x8000:
                raise ValueError("corrupt JPEG arithmetic-coded data")
            s += 1
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if dec.bit(st, s):
            v |= m
    v += 1
    return -v if sign else v


# the fixed-probability bin of the signs: state 113 with MPS 0, which
# every decision leaves as it is
_FIXED_BIN = [113]


def _arith_ac(dec, st, coefs, base, ss, se, al, kx) -> None:
    """AC coefficients ss..se of one block (sequential, or a progressive
    first scan at point transform al)."""
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if dec.bit(st, s):
            return  # EOB
        while not dec.bit(st, s + 1):
            s += 3
            k += 1
            if k > se:
                raise ValueError("corrupt JPEG arithmetic-coded data")
        coefs[base + k] = _arith_ac_value(dec, st, s + 2, k, kx) * (1 << al)
        k += 1


def _arith_ac_refine(dec, st, coefs, base, ss, se, al) -> None:
    """One block of a successive-approximation AC scan (G.1.3.3)."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coefs[base + kex]:
        kex -= 1
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if k > kex and dec.bit(st, s):
            return  # EOB
        while True:
            cur = coefs[base + k]
            if cur:
                if dec.bit(st, s + 2):
                    coefs[base + k] = cur + (m1 if cur < 0 else p1)
                break
            if dec.bit(st, s + 1):
                coefs[base + k] = m1 if dec.bit(_FIXED_BIN, 0) else p1
                break
            s += 3
            k += 1
            if k > se:
                raise ValueError("corrupt JPEG arithmetic-coded data")
        k += 1


# ---------------------------------------------------------------------------
# entropy-coded segments
# ---------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "vd", "tq", "qt", "coefs", "grid_w",
                 "grid_h", "width", "height", "bw", "bh", "coef_bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.vd = v  # the declared factor (a lone component's MCU is 1x1)
        self.qt = None
        # the point transform each of the first ten zigzag coefficients
        # was last coded at, -1 for never (libjpeg's coef_bits)
        self.coef_bits = [-1] * 10


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")


def _words(seg: bytes):
    """The unstuffed bytes of a Huffman-coded segment as one 32-bit window
    per byte, and its length in bits."""
    data = seg.replace(b"\xff\x00", b"\xff")
    b = np.frombuffer(data + bytes(8), np.uint8).astype(np.int64)
    w = ((b[:-4] << 24) | (b[1:-3] << 16) | (b[2:-2] << 8) | b[3:-1])
    return w.tolist(), 8 * len(data)


def _decode_scan(seg: bytes, blocks, comps_in_scan, al=0):
    """Decode one restart interval's Huffman-coded bytes of a sequential
    scan, or of a progressive DC first scan (no AC table; point transform
    `al`): `blocks` lists (component in scan, dc table, ac table,
    coefficient buffer, base) in decoding order."""
    w, n_bits = _words(seg)
    pred = [0] * comps_in_scan
    pos = 0
    try:
        for ci, dct, act, coefs, base in blocks:
            c, _, v, x = dct[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += c
            if x:
                v = (w[pos >> 3] >> (32 - (pos & 7) - x)) & ((1 << x) - 1)
                pos += x
                if v < (1 << (x - 1)):
                    v -= (1 << x) - 1
            v += pred[ci]
            pred[ci] = v
            coefs[base] = v << al
            if act is None:
                continue
            k = 1
            while k < 64:
                c, r, v, x = act[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += c
                if x:
                    v = (w[pos >> 3] >> (32 - (pos & 7) - x)) & ((1 << x) - 1)
                    pos += x
                    if v < (1 << (x - 1)):
                        v -= (1 << x) - 1
                k += r
                if k > 63:
                    break
                coefs[base + k] = v
                k += 1
    except (TypeError, IndexError):
        raise ValueError("corrupt JPEG entropy-coded data") from None
    if pos > n_bits:
        raise ValueError("truncated JPEG entropy-coded data")


def _decode_dc_refine(seg: bytes, blocks, al):
    """One restart interval of a progressive DC refinement scan
    (G.1.2.1): the next bit of each block's DC, one raw bit a block."""
    w, n_bits = _words(seg)
    if len(blocks) > n_bits:
        raise ValueError("truncated JPEG entropy-coded data")
    p1 = 1 << al
    for pos, (_, _, _, coefs, base) in enumerate(blocks):
        if (w[pos >> 3] >> (31 - (pos & 7))) & 1:
            coefs[base] |= p1


def _decode_ac_first(seg: bytes, bases, coefs, table, ss, se, al):
    """One restart interval of a progressive AC first scan (G.1.2.2): one
    component's blocks at `bases`, EOB runs across blocks."""
    w, n_bits = _words(seg)
    pos = eobrun = 0
    try:
        for base in bases:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                c, r, v, x = table[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += c
                if x:
                    v = (w[pos >> 3] >> (32 - (pos & 7) - x)) & ((1 << x) - 1)
                    pos += x
                    if v < (1 << (x - 1)):
                        v -= (1 << x) - 1
                elif v == 0:  # a zero size: ZRL, or an EOB run
                    if r == 15:
                        k += 16
                        continue
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[pos >> 3] >> (32 - (pos & 7) - r)) \
                            & ((1 << r) - 1)
                        pos += r
                    eobrun -= 1
                    break
                k += r
                coefs[base + min(k, 63)] = v * (1 << al)
                k += 1
    except (TypeError, IndexError):
        raise ValueError("corrupt JPEG entropy-coded data") from None
    if pos > n_bits:
        raise ValueError("truncated JPEG entropy-coded data")


def _decode_ac_refine(seg: bytes, bases, coefs, table, ss, se, al):
    """One restart interval of a progressive AC refinement scan
    (G.1.2.3): newly nonzero coefficients of +-2^al and one correction
    bit for each coefficient already nonzero (`jdphuff.c`)."""
    w, n_bits = _words(seg)
    p1, m1 = 1 << al, -1 << al
    pos = eobrun = 0
    try:
        for base in bases:
            k = ss
            if eobrun == 0:
                while k <= se:
                    c, r, v, x = table[(w[pos >> 3] >> (16 - (pos & 7)))
                                       & 0xFFFF]
                    pos += c
                    if x:
                        v = (w[pos >> 3] >> (32 - (pos & 7) - x)) \
                            & ((1 << x) - 1)
                        pos += x
                        if v < (1 << (x - 1)):
                            v -= (1 << x) - 1
                    s = 0
                    if v:
                        s = p1 if v > 0 else m1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[pos >> 3] >> (32 - (pos & 7) - r)) \
                                & ((1 << r) - 1)
                            pos += r
                        break
                    while k <= se:
                        cur = coefs[base + k]
                        if cur:
                            if (w[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                                    not cur & p1:
                                coefs[base + k] = cur + (p1 if cur >= 0
                                                         else m1)
                            pos += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        coefs[base + min(k, 63)] = s
                    k += 1
            if eobrun:
                while k <= se:
                    cur = coefs[base + k]
                    if cur:
                        if (w[pos >> 3] >> (31 - (pos & 7))) & 1 and \
                                not cur & p1:
                            coefs[base + k] = cur + (p1 if cur >= 0 else m1)
                        pos += 1
                    k += 1
                eobrun -= 1
    except (TypeError, IndexError):
        raise ValueError("corrupt JPEG entropy-coded data") from None
    if pos > n_bits:
        raise ValueError("truncated JPEG entropy-coded data")


def _decode_arith(seg: bytes, blocks, n_comps, dc_cond, ac_cond, *,
                  progressive, ss, se, ah, al):
    """One restart interval of an arithmetic-coded scan: `blocks` lists
    (component in scan, dc table, ac table, coefficient buffer, base).
    The statistics of the scan's tables start from zero here, as at every
    restart marker (F.1.4.4.1, G.1.3)."""
    dec = _Arith(seg)
    dc_st = {td: [0] * 64 for _, td, _, _, _ in blocks[:10]}
    ac_st = {ta: [0] * 256 for _, _, ta, _, _ in blocks[:10]}
    ctx = [0] * n_comps
    pred = [0] * n_comps
    for si, td, ta, coefs, base in blocks:
        if not progressive:
            v = (pred[si] + _arith_dc_diff(dec, dc_st[td], ctx, si,
                                           dc_cond[td]) + 32768) & 0xFFFF
            pred[si] = v - 32768
            coefs[base] = v - 32768
            _arith_ac(dec, ac_st[ta], coefs, base, 1, 63, 0, ac_cond[ta])
        elif ss == 0 and ah == 0:
            pred[si] += _arith_dc_diff(dec, dc_st[td], ctx, si, dc_cond[td])
            coefs[base] = pred[si] * (1 << al)
        elif ss == 0:
            if dec.bit(_FIXED_BIN, 0):
                coefs[base] |= 1 << al
        elif ah == 0:
            _arith_ac(dec, ac_st[ta], coefs, base, ss, se, al, ac_cond[ta])
        else:
            _arith_ac_refine(dec, ac_st[ta], coefs, base, ss, se, al)


def _decode_lossless(seg: bytes, units, tables):
    """One restart interval of a Huffman-coded lossless scan: `units`
    lists (table, difference buffer, index) in decoding order; the
    differences (H.1.2.2: sizes 0-16, 16 standing for 32768) go into the
    buffers."""
    w, n_bits = _words(seg)
    pos = 0
    try:
        for t, buf, i in units:
            c, _, v, x = tables[t][(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += c
            if x:
                v = (w[pos >> 3] >> (32 - (pos & 7) - x)) & ((1 << x) - 1)
                pos += x
                if v < (1 << (x - 1)):
                    v -= (1 << x) - 1
            buf[i] = v
    except (TypeError, IndexError):
        raise ValueError("corrupt JPEG entropy-coded data") from None
    if pos > n_bits:
        raise ValueError("truncated JPEG entropy-coded data")


def _scan_blocks(comps, scan, mcux, mcuy, unit=64):
    """Per data unit (component in scan, dc table, ac table, buffer, base)
    in decoding order, and the units an MCU holds: a lone component's
    real blocks in raster order, else the MCUs of the interleaved scan
    (their dummy blocks included). `unit` is the size of one data unit
    in its buffer (64 coefficients, or 1 lossless sample)."""
    if len(scan) == 1:
        ci, td, ta = scan[0]
        c = comps[ci]
        by, bx = np.mgrid[0:c.bh, 0:c.bw]
        bases = ((by * c.grid_w + bx) * unit).reshape(-1).tolist()
        kind = (0, td, ta, c.coefs)
        return [kind + (b,) for b in bases], 1
    per_mcu = []
    for si, (ci, td, ta) in enumerate(scan):
        c = comps[ci]
        for y in range(c.v):
            for x in range(c.h):
                per_mcu.append((si, ci, y, x, td, ta))
    if len(per_mcu) > 10:
        raise ValueError(f"JPEG MCU of {len(per_mcu)} data units (at most "
                         "10)")
    my, mx = np.mgrid[0:mcuy, 0:mcux]
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    out_cols = []
    for si, ci, y, x, td, ta in per_mcu:
        c = comps[ci]
        out_cols.append((((my * c.v + y) * c.grid_w + mx * c.h + x) * unit)
                        .reshape(-1))
    kinds = [(si, td, ta, comps[ci].coefs) for si, ci, y, x, td, ta in per_mcu]
    bases = np.stack(out_cols, 1).reshape(-1).tolist()
    n = len(kinds)
    return [kinds[i % n] + (b,) for i, b in enumerate(bases)], n


def _u16(seg, i):
    return (seg[i] << 8) | seg[i + 1]


def _exif_orientation(exif: bytes) -> int:
    if len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", exif[4:8])
        (n,) = struct.unpack(e + "H", exif[ifd:ifd + 2])
        for k in range(n):
            ent = exif[ifd + 2 + 12 * k:ifd + 14 + 12 * k]
            tag, typ = struct.unpack(e + "HH", ent[:4])
            if tag == 0x0112 and typ == 3:
                (o,) = struct.unpack(e + "H", ent[8:10])
                return o if 1 <= o <= 8 else 1
    except struct.error:
        return 1
    return 1


def _segments(data: bytes):
    """(marker, segment body) of each marker segment to EOI; an SOS
    segment's body is (its header, the entropy-coded bytes after it)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    pos = 2
    n = len(data)
    while True:
        if pos >= n or data[pos] != 0xFF:
            raise ValueError("truncated or corrupt JPEG: expected a marker")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("truncated JPEG")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            yield marker, b""
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG marker segment")
        length = _u16(data, pos)
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError("truncated JPEG marker segment")
        pos += length
        if marker == 0xDA:
            m = _SCAN_END.search(data, pos)
            if m is None:
                raise ValueError("truncated JPEG: a scan without its end")
            yield marker, (body, data[pos:m.start()])
            pos = m.start()
        else:
            yield marker, body


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG file's APP1 segment, or 1."""
    try:
        for marker, body in _segments(data):
            if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
                return _exif_orientation(body[6:])
            if marker in (0xDA, 0xD9):
                break
    except ValueError:
        pass
    return 1


# ---------------------------------------------------------------------------
# block smoothing (libjpeg-turbo's jdcoefct.c, decompress_smooth_data)
# ---------------------------------------------------------------------------

# natural positions of zigzag coefficients 1-9 and the 5x5 DC kernels
# (rows of DC01..DC25, DC13 the block's own) of their estimates: without
# DC interpolation (any of 1-9 coded), and with it (none coded)
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_K_AC = {
    1: {10: -7, 11: 50, 13: -50, 14: 7},
    2: {2: -7, 7: 50, 17: -50, 22: 7},
    3: {2: -1, 7: 13, 12: -24, 17: 13, 22: -1},
    4: {9: 1, 15: 1, 16: -10, 18: 10, 1: -1, 19: -1, 21: 1, 23: -1, 3: 1,
        5: -1, 6: 10, 8: -10},
    5: {10: -1, 11: 13, 12: -24, 13: 13, 14: -1},
}
_K_DC = {
    1: {0: -1, 1: -1, 3: 1, 4: 1, 5: -3, 6: 13, 8: -13, 9: 3, 10: -3,
        11: 38, 13: -38, 14: 3, 15: -3, 16: 13, 18: -13, 19: 3, 20: -1,
        21: -1, 23: 1, 24: 1},
    2: {0: -1, 1: -3, 2: -3, 3: -3, 4: -1, 5: -1, 6: 13, 7: 38, 8: 13,
        9: -1, 15: 1, 16: -13, 17: -38, 18: -13, 19: 1, 20: 1, 21: 3,
        22: 3, 23: 3, 24: 1},
    3: {2: 1, 6: 2, 7: 7, 8: 2, 11: -5, 12: -14, 13: -5, 16: 2, 17: 7,
        18: 2, 22: 1},
    4: {0: -1, 4: 1, 6: 9, 8: -9, 16: -9, 18: 9, 20: 1, 24: -1},
    5: {6: 2, 7: -5, 8: 2, 10: 1, 11: 7, 12: -14, 13: 7, 14: 1, 16: 2,
        17: -5, 18: 2},
    6: {6: 1, 8: -1, 11: 2, 13: -2, 16: 1, 18: -1},
    7: {6: 1, 7: -3, 8: 1, 16: -1, 17: 3, 18: -1},
    8: {6: 1, 8: -1, 11: -3, 13: 3, 16: 1, 18: -1},
    9: {6: 1, 7: 2, 8: 1, 16: -1, 17: -2, 18: -1},
    0: {0: -2, 1: -6, 2: -8, 3: -6, 4: -2, 5: -6, 6: 6, 7: 42, 8: 6,
        9: -6, 10: -8, 11: 42, 12: 152, 13: 42, 14: -8, 15: -6, 16: 6,
        17: 42, 18: 6, 19: -6, 20: -2, 21: -6, 22: -8, 23: -6, 24: -2},
}


def _smooth_rows(bh: int, v: int, total: int) -> np.ndarray:
    """(bh, 5) block rows each block row's 5x5 window reads, as
    `decompress_smooth_data` points them: an iMCU row of `v` block rows,
    the last one holding `bh % v` (or v), and the image's row count
    taken as that row count times `total` iMCU rows (so a short last
    iMCU row sees itself as the image's last rows)."""
    out = []
    for r in range(total):
        br = v if r < total - 1 else (bh % v or v)
        n = br * total
        for b in range(br):
            row = r * v + b
            i = r * br + b
            prev = row - 1 if i > 0 else row
            nxt = row + 1 if i < n - 1 else row
            out.append((row - 2 if i > 1 else prev, prev, row, nxt,
                        row + 2 if i < n - 2 else nxt))
    return np.array(out[:bh], np.int64)


def _smooth(c: _Component, coef: np.ndarray, total: int) -> np.ndarray:
    """(bh*bw, 64) zigzag coefficients of component c -> the same with
    coefficients 1-9 (and, when none of them was coded, the DC) estimated
    from the 5x5 neighbourhood of DC values where they are zero and not
    known to full precision."""
    bits = c.coef_bits
    change_dc = all(b == -1 for b in bits[1:10])
    rows = _smooth_rows(c.bh, c.vd, total)
    # the coefficient array is padded to whole iMCU rows of the declared
    # factor (a lone component's rows there were never coded: zero)
    grid = np.zeros((max(c.grid_h, int(rows.max()) + 1), c.grid_w), np.int64)
    grid[:c.grid_h] = np.frombuffer(c.coefs, np.int32).reshape(
        c.grid_h, c.grid_w, 64)[..., 0]
    cols = np.clip(np.arange(c.bw)[:, None] + np.arange(-2, 3), 0,
                   c.bw - 1)
    # dcs[j]: DC(j + 1) of every block, (bh, bw)
    dcs = [grid[rows[:, j // 5][:, None], cols[:, j % 5][None, :]]
           .reshape(-1) for j in range(25)]
    q = c.qt
    out = coef.copy()
    q00 = int(q[0])
    for zz in range(1, 10 if change_dc else 6):
        al = bits[zz]
        if al == 0:
            continue
        kern = (_K_DC if change_dc else _K_AC)[zz]
        num = q00 * sum(w * dcs[j] for j, w in kern.items())
        qk = int(q[_SMOOTH_POS[zz - 1]])
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        col = out[:, zz]
        out[:, zz] = np.where(col == 0, pred, col)
    if change_dc:
        num = q00 * sum(w * dcs[j] for j, w in _K_DC[0].items())
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[:, 0] = np.where(num >= 0, pred, -pred)
    return out


def _smoothing_ok(comps) -> bool:
    """`smoothing_ok`: every component's DC coded at least in part, the
    quantisers of coefficients 0-9 nonzero, and some coefficient 1-9 of
    some component not known to full precision."""
    useful = False
    for c in comps:
        if c.qt is None or c.coef_bits[0] < 0 or \
                not all(c.qt[p] for p in (0,) + _SMOOTH_POS):
            return False
        useful = useful or any(b != 0 for b in c.coef_bits[1:10])
    return useful


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class CMYK(np.ndarray):
    """A 4-component JPEG's (h, w, 4) uint8 samples as libjpeg-turbo hands
    them to a reader asking for CMYK (an Adobe file's values stay
    inverted; YCCK is converted, `ycck_cmyk_convert`). The type tells
    `imageio.to_rgb` / `to_l` / `imread_color` apart from RGBA."""


# SOF marker -> (progressive, lossless, arithmetic)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, True, False),
        0xC9: (False, False, True), 0xCA: (True, False, True)}
_UNSUPPORTED = {0xC5: "a hierarchical (differential sequential)",
                0xC6: "a hierarchical (differential progressive)",
                0xC7: "a hierarchical (differential lossless)",
                0xC8: "a JPG-extension",
                0xCB: "an arithmetic-coded lossless",
                0xCD: "an arithmetic-coded hierarchical (differential "
                      "sequential)",
                0xCE: "an arithmetic-coded hierarchical (differential "
                      "progressive)",
                0xCF: "an arithmetic-coded hierarchical (differential "
                      "lossless)"}
_READERS = "libjpeg-turbo (the library PIL and OpenCV read JPEG with)"


def _frame_header(body):
    """(H, W, [components]) of an SOF segment, checked as libjpeg-turbo
    and PIL check it."""
    if len(body) < 6:
        raise ValueError("corrupt JPEG frame header")
    prec, H, W, nc = body[0], _u16(body, 1), _u16(body, 3), body[5]
    if prec != 8:
        raise NotImplementedError(
            f"a {prec}-bit JPEG file: PIL opens 8-bit JPEG files only")
    if nc not in (1, 3, 4):
        raise NotImplementedError(
            f"a {nc}-component JPEG file: PIL opens 1, 3 or 4 components")
    if H == 0 or W == 0 or len(body) != 6 + 3 * nc:
        raise ValueError("corrupt JPEG frame header")
    comps = []
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"corrupt JPEG frame header: sampling factors "
                             f"({h}, {v}), table {tq}")
        comps.append(_Component(cid, h, v, tq))
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise NotImplementedError(
                f"JPEG sampling factors {[(d.h, d.v) for d in comps]}: "
                f"{_READERS} upsamples integer ratios only ('Fractional "
                "sampling not implemented yet')")
    return H, W, comps


def _undifference(diff: np.ndarray, pred: int, pt: int, first_rows):
    """Lossless samples of one component (H.1.2.1; libjpeg-turbo's
    jdlossls.c): (h, w) differences -> values mod 2^16 before the point
    transform. Each row of `first_rows` (the first, and the first after a
    restart) is predicted along itself from 2^(7 - pt); every other row's
    first sample from the one above, the rest by predictor `pred`."""
    d = diff.astype(np.int64)
    h, w = d.shape
    out = np.zeros_like(d)
    for r in range(h):
        row = d[r]
        if r in first_rows:
            row = row.copy()
            row[0] += 1 << (7 - pt)
            out[r] = np.cumsum(row) & 0xFFFF
            continue
        up = out[r - 1]
        if pred in (1, 2, 3):
            base = {1: None, 2: up, 3: np.concatenate([up[:1], up[:-1]])}
            if pred == 1:
                row = row.copy()
                row[0] += up[0]
                out[r] = np.cumsum(row) & 0xFFFF
            else:
                b = base[pred].copy()
                b[0] = up[0]
                out[r] = (row + b) & 0xFFFF
            continue
        cur = out[r]
        ra = cur[0] = (row[0] + up[0]) & 0xFFFF
        rows = row.tolist()
        ups = up.tolist()
        for x in range(1, w):
            rb, rc = ups[x], ups[x - 1]
            if pred == 4:
                p = ra + rb - rc
            elif pred == 5:
                p = ra + ((rb - rc) >> 1)
            elif pred == 6:
                p = rb + ((ra - rc) >> 1)
            else:
                p = (ra + rb) >> 1
            ra = (rows[x] + p) & 0xFFFF
            cur[x] = ra
    return out


def read_coefficients(data: bytes) -> SimpleNamespace:
    """Entropy-decode every scan of a JPEG file: `frame` (the SOF marker),
    `height`, `width`, `comps` (each with its id, factors `h`, `v`,
    table `tq` and `qt` (natural order), and `coefs`, its quantised
    coefficients in zigzag order over the whole MCU grid, or its samples
    for a lossless file), `jfif` and `adobe`."""
    qts: Dict[int, np.ndarray] = {}
    tables = {}
    dc_cond = {t: (0, 1) for t in range(4)}
    ac_cond = {t: 5 for t in range(4)}
    comps: List[_Component] = []
    W = H = 0
    restart = 0
    jfif = False
    adobe = None
    frame = None
    mcux = mcuy = 0
    for marker, body in _segments(data):
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq not in (0, 1) or tq > 3:
                    raise ValueError("corrupt JPEG quantisation table")
                nb = 64 * (pq + 1)
                raw = body[i + 1:i + 1 + nb]
                if len(raw) != nb:
                    raise ValueError("truncated JPEG quantisation table")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = vals
                qts[tq] = qt
                i += 1 + nb
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                nv = sum(counts)
                values = list(body[i + 17:i + 17 + nv])
                if tc > 1 or th > 3 or len(counts) != 16 or len(values) != nv:
                    raise ValueError("corrupt JPEG Huffman table")
                tables[tc, th] = (counts, values)
                i += 17 + nv
        elif marker == 0xCC:
            if len(body) % 2:
                raise ValueError("corrupt JPEG DAC segment")
            for i in range(0, len(body), 2):
                tc, tb, cs = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc > 1 or tb > 3:
                    raise ValueError("corrupt JPEG DAC segment")
                if tc:
                    if not 1 <= cs <= 63:
                        raise ValueError("corrupt JPEG DAC segment")
                    ac_cond[tb] = cs
                else:
                    L, U = cs & 15, cs >> 4
                    if L > U:
                        raise ValueError("corrupt JPEG DAC segment")
                    dc_cond[tb] = (L, U)
        elif marker in _UNSUPPORTED:
            raise NotImplementedError(
                f"{_UNSUPPORTED[marker]} JPEG file (SOF 0x{marker:02X}): "
                f"{_READERS} does not decode this process")
        elif marker in _SOF:
            if frame is not None:
                raise ValueError("JPEG with two frame headers")
            progressive, lossless, arithmetic = _SOF[marker]
            H, W, comps = _frame_header(body)
            frame = marker
            if len(comps) == 1:  # one component: its MCU is one unit
                comps[0].h = comps[0].v = 1
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            unit = 1 if lossless else 8
            mcux = -(-W // (unit * hmax))
            mcuy = -(-H // (unit * vmax))
            for c in comps:
                c.width = -(-W * c.h // hmax)
                c.height = -(-H * c.v // vmax)
                c.bw, c.bh = -(-c.width // unit), -(-c.height // unit)
                c.grid_w, c.grid_h = mcux * c.h, mcuy * c.v
                c.coefs = array.array("i", bytes(4 * (unit * unit)
                                                 * c.grid_w * c.grid_h))
        elif marker == 0xDD:
            if len(body) != 2:
                raise ValueError("corrupt JPEG restart interval")
            restart = _u16(body, 0)
        elif marker == 0xE0:
            jfif = jfif or body[:5] == b"JFIF\x00"
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            header, ecs = body
            ns = header[0]
            if not 1 <= ns <= 4 or len(header) != 4 + 2 * ns:
                raise ValueError("corrupt JPEG scan header")
            scan = []
            for k in range(ns):
                cid, t = header[1 + 2 * k:3 + 2 * k]
                ci = next((i for i, c in enumerate(comps) if c.cid == cid),
                          None)
                if ci is None:
                    raise ValueError("JPEG scan names an unknown component")
                scan.append((ci, t >> 4, t & 15))
            ss, se = header[1 + 2 * ns], header[2 + 2 * ns]
            ah, al = header[3 + 2 * ns] >> 4, header[3 + 2 * ns] & 15
            _scan(comps, scan, ecs, ss, se, ah, al, frame, tables, qts,
                  dc_cond, ac_cond, restart, mcux, mcuy)
        elif marker == 0xD9:
            break
    else:
        raise ValueError("truncated JPEG: no end of image")
    if frame is None or any(c.qt is None for c in comps):
        raise ValueError("JPEG without a complete scan")
    return SimpleNamespace(frame=frame, height=H, width=W, comps=comps,
                           jfif=jfif, adobe=adobe)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> (h, w) uint8 for one component, (h, w, 3) uint8
    RGB for three, a (h, w, 4) uint8 `CMYK` for four: libjpeg-turbo's
    default decode, bit for bit."""
    f = read_coefficients(data)
    comps, H, W, jfif, adobe = f.comps, f.height, f.width, f.jfif, f.adobe
    progressive, lossless, _ = _SOF[f.frame]
    planes = []
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    smooth = progressive and _smoothing_ok(comps)
    total = -(-H // (8 * max(c.vd for c in comps)))
    for c in comps:
        if lossless:
            px = np.frombuffer(c.coefs, np.int32).reshape(
                c.grid_h, c.grid_w)[:c.height, :c.width]
            planes.append(px.astype(np.uint8))
            continue
        coef = np.frombuffer(c.coefs, np.int32).reshape(
            c.grid_h, c.grid_w, 64)[:c.bh, :c.bw].reshape(-1, 64)
        if smooth:
            coef = _smooth(c, coef.astype(np.int64), total)
        nat = np.zeros_like(coef, dtype=np.int64)
        nat[:, ZIGZAG] = coef
        px = _idct_islow((nat * c.qt).reshape(-1, 8, 8))
        px = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            c.bh * 8, c.bw * 8)[:c.height, :c.width]
        planes.append(px)
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    full = [_upsample(p, hmax // c.h, vmax // c.v, fancy=not lossless)[:H, :W]
            for p, c in zip(planes, comps)]
    # the colour space as libjpeg-turbo guesses it: 4 components are YCCK
    # by an Adobe transform other than 0, else CMYK; 3 are YCbCr by JFIF,
    # by an Adobe transform other than 0, or (a DCT file without either)
    # by ids other than 'R', 'G', 'B', else RGB
    if len(comps) == 4:
        ycc = adobe not in (None, 0)
    elif jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    else:
        ycc = not lossless and [c.cid for c in comps] != [82, 71, 66]
    if ycc and lossless:
        raise NotImplementedError(
            f"a lossless JPEG file in {'YCCK' if len(comps) == 4 else 'YCbCr'}"
            f": {_READERS} converts no colour space of a lossless file")
    if len(comps) == 4:
        if ycc:
            rgb = _ycc_to_rgb(*full[:3])
            full = [255 - rgb[..., i] for i in range(3)] + [full[3]]
        return np.stack(full, -1).view(CMYK)
    if ycc:
        return _ycc_to_rgb(*full)
    return np.stack(full, -1)


def frame_kind(data: bytes):
    """(SOF marker, number of components) of a JPEG file's frame, read
    from its header alone."""
    for marker, body in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC):
            return marker, body[5] if len(body) > 5 else 0
        if marker == 0xDA:
            break
    raise ValueError("JPEG without a frame header")


def _scan(comps, scan, ecs, ss, se, ah, al, frame, tables, qts, dc_cond,
          ac_cond, restart, mcux, mcuy):
    """Decode one scan into the components' buffers."""
    progressive, lossless, arithmetic = _SOF[frame]
    for ci, _, _ in scan:
        c = comps[ci]
        if c.qt is None:  # latched at the component's first scan
            if lossless:
                c.qt = np.zeros(64, np.int64)  # a lossless file has none
            elif c.tq not in qts:
                raise ValueError("JPEG component without its quantisation "
                                 "table")
            else:
                c.qt = qts[c.tq]
    if lossless:
        if not 1 <= ss <= 7 or al > 15:
            raise ValueError(f"corrupt JPEG lossless scan: predictor {ss}, "
                             f"point transform {al}")
    elif progressive:
        dc = ss == 0
        bad = (dc and se != 0) or (not dc and (ss > se or se > 63
                                                or len(scan) != 1))
        if bad or (ah and al != ah - 1) or al > 13:
            raise ValueError(f"corrupt JPEG progression: Ss {ss}, Se {se}, "
                             f"Ah {ah}, Al {al}")
        for ci, _, _ in scan:
            bits = comps[ci].coef_bits
            for k in range(ss, min(se, 9) + 1):
                bits[k] = al
    elif ss != 0 or se != 63:
        raise ValueError("corrupt JPEG scan header")
    need_dc = lossless or not progressive or (ss == 0 and ah == 0)
    need_ac = not lossless and (not progressive or ss > 0)
    if not arithmetic:
        for ci, td, ta in scan:
            if (need_dc and (0, td) not in tables) or \
                    (need_ac and (1, ta) not in tables):
                raise ValueError("JPEG scan without its Huffman tables")
    blocks, per_mcu = _scan_blocks(comps, scan, mcux, mcuy,
                                   unit=1 if lossless else 64)
    n_units = len(blocks) // per_mcu
    parts = _RST.split(ecs) if restart else [ecs]
    interval = restart or n_units
    if len(parts) != -(-n_units // interval):
        raise ValueError(
            f"JPEG scan holds {len(parts)} restart intervals, "
            f"expected {-(-n_units // interval)}")
    step = interval * per_mcu
    if lossless:
        _lossless_scan(comps, scan, parts, blocks, step, ss, al, tables,
                       restart, mcux)
        return
    for k, part in enumerate(parts):
        chunk = blocks[k * step:(k + 1) * step]
        if arithmetic:
            _decode_arith(part, chunk, len(scan), dc_cond, ac_cond,
                          progressive=progressive, ss=ss, se=se, ah=ah,
                          al=al)
            continue
        if progressive and ss == 0 and ah:
            _decode_dc_refine(part, chunk, al)
        elif not progressive or ss == 0:
            chunk = [(si, _decode_table(*tables[0, td], "dc"),
                      _decode_table(*tables[1, ta], "ac") if not progressive
                      else None, coefs, base)
                     for si, td, ta, coefs, base in chunk]
            _decode_scan(part, chunk, len(scan), al)
        else:
            table = _decode_table(*tables[1, scan[0][2]], "prog")
            bases = [base for _, _, _, _, base in chunk]
            fn = _decode_ac_first if ah == 0 else _decode_ac_refine
            fn(part, bases, comps[scan[0][0]].coefs, table, ss, se, al)


def _lossless_scan(comps, scan, parts, blocks, step, pred, pt, tables,
                   restart, mcux):
    """Decode a lossless scan's differences, undo the prediction and the
    point transform into the components' sample buffers."""
    diffs = {ci: array.array("i", bytes(4 * comps[ci].grid_w
                                        * comps[ci].grid_h))
             for ci, _, _ in scan}
    huff = {td: _decode_table(*tables[0, td], "lossless")
            for _, td, _ in scan}
    for k, part in enumerate(parts):
        units = [(td, diffs[scan[si][0]], base)
                 for si, td, _, _, base in blocks[k * step:(k + 1) * step]]
        _decode_lossless(part, units, huff)
    per_row = comps[scan[0][0]].bw if len(scan) == 1 else mcux
    if restart % per_row:
        raise NotImplementedError(
            f"a lossless JPEG file whose restart interval ({restart} MCUs) "
            f"is not a whole number of MCU rows ({per_row} MCUs)")
    for ci, _, _ in scan:
        c = comps[ci]
        v = 1 if len(scan) == 1 else c.v
        rows_per = (restart // per_row) * v if restart else c.grid_h
        first = set(range(0, c.grid_h, rows_per))
        d = np.frombuffer(diffs[ci], np.int32).reshape(c.grid_h, c.grid_w)
        vals = _undifference(d[:, :c.width], pred, pt, first)
        out = np.frombuffer(c.coefs, np.int32).reshape(c.grid_h, c.grid_w)
        np.copyto(out[:, :c.width], ((vals << pt) & 0xFF).astype(np.int32))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

# the standard tables (ITU-T T.81 K.1 / K.3), natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """`jpeg_set_quality(..., force_baseline=TRUE)`'s table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _encode_table(counts, values):
    """symbol -> (code, length) arrays of 256."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for c, length, sym in _codes(counts, list(values)):
        code[sym], size[sym] = c, length
    return code, size


def _marker(tag: int, body: bytes) -> bytes:
    return bytes([0xFF, tag]) + struct.pack(">H", len(body) + 2) + body


def _pad_plane(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to (h, w)."""
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), "edge")


def _blocks_of(plane: np.ndarray) -> np.ndarray:
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _nbits(v):
    """Bits of |v| (JPEG's size category) of an int64 array."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while True:
        m = a > 0
        if not m.any():
            return n
        n += m
        a = a >> 1


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(h, w, 3) uint8 RGB or (h, w) uint8 grey -> the JPEG file bytes
    `cv2.imencode('.jpg', ...)` writes at `IMWRITE_JPEG_QUALITY`
    = quality (4:2:0 for colour)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (h, w, 3) or (h, w) uint8, got "
                         f"{img.shape} {img.dtype}")
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"encode_jpeg: size {W}x{H} outside JPEG's limits")
    colour = img.ndim == 3
    qt = [_quality_table(_STD_LUMA_Q, quality)]
    if colour:
        qt.append(_quality_table(_STD_CHROMA_Q, quality))
        samp = [(2, 2), (1, 1), (1, 1)]
        y, cb, cr = _rgb_to_ycc(img)
        mx, my = -(-W // 16), -(-H // 16)
        # chroma: the full-resolution plane's edges expanded to the MCU
        # width and an even height, then h2v2_downsample (bias 1, 2, ...)
        chroma = []
        for p in (cb, cr):
            p = _pad_plane(p, H + (H & 1), 16 * mx)
            s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            s = (s + np.where(np.arange(s.shape[1]) & 1, 2, 1)) >> 2
            chroma.append(_pad_plane(s, 8 * my, 8 * mx))
        planes = [_pad_plane(y, 8 * -(-H // 8), 8 * -(-W // 8))] + chroma
    else:
        samp = [(1, 1)]
        mx, my = -(-W // 8), -(-H // 8)
        planes = [_pad_plane(img.astype(np.int64), 8 * my, 8 * mx)]

    # quantised coefficients of every real block, in zigzag order
    coefs = []
    for i, p in enumerate(planes):
        blk = _blocks_of(p - 128)
        bh, bw = blk.shape[:2]
        t = _fdct_islow(blk.reshape(-1, 8, 8)).reshape(-1, 64)
        d = (qt[min(i, 1)] << 3)
        q = np.sign(t) * ((np.abs(t) + (d >> 1)) // d)
        coefs.append(q[:, ZIGZAG].reshape(bh, bw, 64))

    # blocks in MCU order; dummy blocks (right and bottom of an MCU
    # beyond the component's blocks) are zero with the DC of the block
    # before them in the MCU (`jccoefct.c::compress_data`)
    order, comp_of = [], []
    for ci, ((h, v), c) in enumerate(zip(samp, coefs)):
        bh, bw = c.shape[:2]
        full = np.zeros((my * v, mx * h, 64), np.int64)
        full[:bh, :bw] = c
        if h == 2 and bw < mx * h:  # an odd last column
            full[:bh, bw, 0] = full[:bh, bw - 1, 0]
        if v == 2 and bh < my * v:  # an odd last row
            full[bh, :, 0] = np.repeat(full[bh - 1, 1::2, 0], 2)
        mcu = full.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
        order.append(mcu.reshape(my * mx, v * h, 64))
        comp_of += [ci] * (v * h)
    blocks = np.concatenate(order, 1).reshape(-1, 64)
    comp = np.tile(np.array(comp_of), my * mx)
    luma = comp == 0

    tabs = {(0, True): _encode_table(*_DC_LUMA),
            (1, True): _encode_table(*_AC_LUMA),
            (0, False): _encode_table(*_DC_CHROMA),
            (1, False): _encode_table(*_AC_CHROMA)}

    def lookup(cls, sym, is_luma):
        cl, ll = tabs[cls, True]
        cc, lc = tabs[cls, False]
        return (np.where(is_luma, cl[sym], cc[sym]),
                np.where(is_luma, ll[sym], lc[sym]))

    nb = blocks.shape[0]
    # DC differences per component, in block order
    dc = blocks[:, 0]
    diff = np.empty(nb, np.int64)
    for ci in range(len(samp)):
        sel = np.flatnonzero(comp == ci)
        diff[sel] = np.diff(dc[sel], prepend=0)
    size = _nbits(diff)
    code, clen = lookup(0, size, luma)
    keys = [np.arange(nb) * 520 + 3, np.arange(nb) * 520 + 4]
    vals = [code, (diff - (diff < 0)) & ((1 << size) - 1)]
    lens = [clen, size]

    ac = blocks[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    v = ac[b, k - 1]
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    size = _nbits(v)
    code, clen = lookup(1, ((run & 15) << 4) | size, luma[b])
    zrl_c, zrl_l = lookup(1, np.full(b.size, 0xF0), luma[b])
    base = (b * 65 + k) * 8
    for z in range(3):  # up to three ZRLs before a coefficient
        has = (run >> 4) > z
        keys.append(base[has] + z)
        vals.append(zrl_c[has])
        lens.append(zrl_l[has])
    keys += [base + 3, base + 4]
    vals += [code, (v - (v < 0)) & ((1 << size) - 1)]
    lens += [clen, size]
    last = np.zeros(nb, np.int64)
    last[b] = k  # the last nonzero index of each block (0 for none)
    eob = np.flatnonzero(last < 63)
    ec, el = lookup(1, np.zeros(eob.size, np.int64), luma[eob])
    keys.append(eob * 520 + 64 * 8)
    vals.append(ec)
    lens.append(el)

    key = np.concatenate(keys)
    o = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[o]
    ln = np.concatenate(lens)[o]
    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    ev = np.repeat(np.arange(ln.size), ln)
    bit = np.arange(total) - start[ev]
    bits = (val[ev] >> (ln[ev] - 1 - bit)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])
    ecs = np.packbits(bits.astype(np.uint8)).tobytes().replace(
        b"\xff", b"\xff\x00")

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(qt):
        out.append(_marker(0xDB, bytes([i]) + bytes(
            t[ZIGZAG].astype(np.uint8).tolist())))
    nc = len(samp)
    sof = struct.pack(">BHHB", 8, H, W, nc) + b"".join(
        bytes([ci + 1, (h << 4) | v, min(ci, 1)])
        for ci, (h, v) in enumerate(samp))
    out.append(_marker(0xC0, sof))
    for t, (cls, lum) in ((0x00, (0, True)), (0x10, (1, True)),
                          (0x01, (0, False)), (0x11, (1, False))):
        if not lum and not colour:
            continue
        counts, values = {(0, True): _DC_LUMA, (1, True): _AC_LUMA,
                          (0, False): _DC_CHROMA,
                          (1, False): _AC_CHROMA}[cls, lum]
        out.append(_marker(0xC4, bytes([t] + counts) + bytes(values)))
    sos = bytes([nc]) + b"".join(
        bytes([ci + 1, 0x00 if ci == 0 else 0x11]) for ci in range(nc)) \
        + b"\x00\x3f\x00"
    out.append(_marker(0xDA, sos))
    out.append(ecs)
    out.append(b"\xff\xd9")
    return b"".join(out)
