"""Baseline JPEG decode and encode on numpy and the standard library,
bit for bit with libjpeg-turbo's defaults (the library under PIL and
OpenCV).

- `decode_jpeg`: sequential Huffman files (SOF0 / SOF1) of 8-bit samples,
  1 or 3 components, sampling factors 1 or 2 on each axis, restart
  intervals, 8- and 16-bit quantisation tables, any Huffman tables,
  interleaved or not; JFIF YCbCr, or RGB (an Adobe transform of 0 or
  the component ids 'R', 'G', 'B'). The steps are libjpeg-turbo's
  default decode: the integer "islow" IDCT (`jidctint.c`) with the
  range-limit table's 10-bit wrap, fancy upsampling
  (`jdsample.c`: the triangle filters of h2v1, h2v2 and h1v2 with their
  alternating biases, replication where a downsampled row is at most
  two samples wide), the fixed-point YCbCr -> RGB of `jdcolor.c`, the
  padded blocks cropped to the image.
- `encode_jpeg`: the file `cv2.imencode('.jpg')` writes at its defaults
  (PIL's at quality 95): JFIF APP0, `jpeg_set_quality`'s tables forced
  to baseline, 4:2:0 by `h2v2_downsample` (alternating bias 1, 2) after
  the edge expansion of `jcprepct.c`, `rgb_ycc_convert`'s tables, the
  islow FDCT (`jfdctint.c`), rounded quantisation, the dummy blocks of
  `jccoefct.c`, the standard Huffman tables, 0xFF stuffing and a last
  byte padded with 1 bits. Grey images are one component.
- `exif_orientation`: the EXIF orientation tag (1-8) of a file, or 1.

Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files
and 4-component (CMYK / YCCK) files raise `NotImplementedError`; corrupt
or truncated data raises `ValueError`.

Only the Huffman decode is sequential: a Python loop over symbols with
one 16-bit peek a symbol into a table that also holds the coefficient's
value when code and value fit 16 bits. Everything after it, and the
whole encoder, is vectorised over all blocks in int64 numpy.
"""
from __future__ import annotations

import array
import re
import struct
from typing import Dict, List

import numpy as np

_UNPORTED = "(ROADMAP.md queue A, 'progressive JPEG')"

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

_SOF_KINDS = {
    0xC2: "a progressive JPEG", 0xC3: "a lossless JPEG",
    0xC5: "a hierarchical JPEG", 0xC6: "a hierarchical progressive JPEG",
    0xC7: "a hierarchical lossless JPEG",
    0xC9: "an arithmetic-coded JPEG",
    0xCA: "an arithmetic-coded progressive JPEG",
    0xCB: "an arithmetic-coded lossless JPEG",
    0xCD: "an arithmetic-coded hierarchical JPEG",
    0xCE: "an arithmetic-coded hierarchical progressive JPEG",
    0xCF: "an arithmetic-coded hierarchical lossless JPEG"}


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


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of one downsampled plane (its
    real rows and columns only) by (fh, fv) in {1, 2}."""
    if fh == 1 and fv == 1:
        return plane
    x = plane.astype(np.int64)
    w = x.shape[1]
    if fv == 1:  # h2v1
        if w <= 2:
            return np.repeat(plane, 2, 1)
        return (_fancy_h2(x, (1, 2)) >> 2).astype(np.uint8)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    if fh == 1:  # h1v2: (3 near + far + bias) >> 2, bias 1 above, 2 below
        out = np.empty((2 * x.shape[0], w), np.int64)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    if w <= 2:  # h2v2 without context: replication
        return np.repeat(np.repeat(plane, 2, 0), 2, 1)
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


def _decode_table(counts, values, ac: bool):
    """`_build_table`, kept for the next file with the same table."""
    key = (tuple(counts), tuple(values), ac)
    if key not in _TABLES:
        if len(_TABLES) >= 64:
            _TABLES.clear()
        _TABLES[key] = _build_table(counts, values, ac)
    return _TABLES[key]


def _build_table(counts, values, ac: bool):
    """A 65536-entry list indexed by the next 16 bits of the stream:
    (bits consumed, run, value, extra bits still to read), or None for a
    code that is not in the table. With code and value within 16 bits
    the entry holds the value; otherwise `extra` bits follow. DC entries
    have run 0; EOB has run 64; ZRL run 15 with value 0."""
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
    size = symbols & 15
    run = (symbols >> 4) if ac else np.zeros_like(symbols)
    if ac:
        # EOB, and (as libjpeg reads it) any zero size but ZRL's, ends
        # the block
        run = np.where((size == 0) & (run != 15), 64, run)
    total = lengths + size
    fits = total <= 16
    bits = np.where(fits, (p >> np.maximum(16 - total, 0))
                    & ((1 << size) - 1), 0)
    val = np.where(size > 0,
                   np.where(bits < (1 << np.maximum(size - 1, 0)),
                            bits - (1 << size) + 1, bits), 0)
    consumed = np.where(fits, total, lengths)
    extra = np.where(fits, 0, size)
    key = np.where(valid, ((consumed * 128 + run) * 65536 + val + 32768)
                   * 32 + extra, -1)
    uniq, inverse = np.unique(key, return_inverse=True)
    entries = [None if k < 0 else (int(k >> 28), int((k >> 21) & 127),
                                   int(((k >> 5) & 65535) - 32768),
                                   int(k & 31)) for k in uniq.tolist()]
    return [entries[i] for i in inverse.tolist()]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "coefs", "grid_w", "grid_h",
                 "width", "height", "bw", "bh")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")


def _decode_scan(seg: bytes, blocks, comps_in_scan):
    """Decode one restart interval's entropy-coded bytes: `blocks` lists
    (component index, dc table, ac table, coefficient buffer, base) in
    decoding order."""
    data = seg.replace(b"\xff\x00", b"\xff")
    b = np.frombuffer(data + bytes(8), np.uint8).astype(np.int64)
    w = ((b[:-4] << 24) | (b[1:-3] << 16) | (b[2:-2] << 8) | b[3:-1]).tolist()
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
            coefs[base] = v
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
    if pos > 8 * len(data):
        raise ValueError("truncated JPEG entropy-coded data")


def _scan_blocks(comps, scan, mcux, mcuy, tables):
    """Per-block (component in scan, dc, ac, buffer, base) in decoding
    order, and the blocks an MCU holds."""
    if len(scan) == 1:
        ci, td, ta = scan[0]
        c = comps[ci]
        by, bx = np.mgrid[0:c.bh, 0:c.bw]
        bases = ((by * c.grid_w + bx) * 64).reshape(-1).tolist()
        kind = (0, tables[0, td], tables[1, ta], c.coefs)
        return [kind + (b,) for b in bases], 1
    per_mcu = []
    for si, (ci, td, ta) in enumerate(scan):
        c = comps[ci]
        for y in range(c.v):
            for x in range(c.h):
                per_mcu.append((si, ci, y, x, td, ta))
    my, mx = np.mgrid[0:mcuy, 0:mcux]
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    out_cols = []
    for si, ci, y, x, td, ta in per_mcu:
        c = comps[ci]
        out_cols.append((((my * c.v + y) * c.grid_w + mx * c.h + x) * 64)
                        .reshape(-1))
    kinds = [(si, tables[0, td], tables[1, ta], comps[ci].coefs)
             for si, ci, y, x, td, ta in per_mcu]
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


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG file bytes -> (h, w) uint8 for one component, (h, w, 3) uint8
    RGB for three: libjpeg-turbo's default decode, bit for bit."""
    qts: Dict[int, np.ndarray] = {}
    tables = {}
    comps: List[_Component] = []
    W = H = 0
    restart = 0
    jfif = False
    adobe = None
    frame = False
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
                tables[tc, th] = _decode_table(counts, values, bool(tc))
                i += 17 + nv
        elif marker in _SOF_KINDS:
            raise NotImplementedError(
                f"{_SOF_KINDS[marker]} file {_UNPORTED}")
        elif marker in (0xC0, 0xC1):
            if len(body) < 6:
                raise ValueError("corrupt JPEG frame header")
            prec, H, W, nc = body[0], _u16(body, 1), _u16(body, 3), body[5]
            if prec != 8:
                raise NotImplementedError(
                    f"a {prec}-bit JPEG file {_UNPORTED}")
            if nc == 4:
                raise NotImplementedError(
                    f"a 4-component (CMYK or YCCK) JPEG file {_UNPORTED}")
            if nc not in (1, 3):
                raise NotImplementedError(
                    f"a {nc}-component JPEG file {_UNPORTED}")
            if H == 0 or W == 0 or len(body) != 6 + 3 * nc:
                raise ValueError("corrupt JPEG frame header")
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            if nc == 1:  # one component: its MCU is one block
                comps[0].h = comps[0].v = 1
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                if c.h not in (1, 2) or c.v not in (1, 2) or \
                        hmax % c.h or vmax % c.v:
                    raise NotImplementedError(
                        f"JPEG sampling factors {[(d.h, d.v) for d in comps]}"
                        f" {_UNPORTED}")
            mcux = -(-W // (8 * hmax))
            mcuy = -(-H // (8 * vmax))
            for c in comps:
                c.width = -(-W * c.h // hmax)
                c.height = -(-H * c.v // vmax)
                c.bw, c.bh = -(-c.width // 8), -(-c.height // 8)
                c.grid_w, c.grid_h = mcux * c.h, mcuy * c.v
                c.coefs = array.array("i", bytes(4 * 64 * c.grid_w
                                                  * c.grid_h))
            frame = True
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
            if not frame:
                raise ValueError("JPEG scan before its frame header")
            header, ecs = body
            ns = header[0]
            scan = []
            for k in range(ns):
                cid, t = header[1 + 2 * k:3 + 2 * k]
                ci = next((i for i, c in enumerate(comps) if c.cid == cid),
                          None)
                if ci is None:
                    raise ValueError("JPEG scan names an unknown component")
                if (0, t >> 4) not in tables or (1, t & 15) not in tables:
                    raise ValueError("JPEG scan without its Huffman tables")
                if comps[ci].qt is None:
                    if comps[ci].tq not in qts:
                        raise ValueError("JPEG component without its "
                                         "quantisation table")
                    comps[ci].qt = qts[comps[ci].tq]
                scan.append((ci, t >> 4, t & 15))
            ss, se = header[1 + 2 * ns], header[2 + 2 * ns]
            if ss != 0 or se != 63:
                raise ValueError("corrupt JPEG scan header")
            blocks, per_mcu = _scan_blocks(comps, scan, mcux, mcuy, tables)
            n_units = len(blocks) // per_mcu
            parts = _RST.split(ecs) if restart else [ecs]
            interval = restart or n_units
            if len(parts) != -(-n_units // interval):
                raise ValueError(
                    f"JPEG scan holds {len(parts)} restart intervals, "
                    f"expected {-(-n_units // interval)}")
            step = interval * per_mcu
            for k, part in enumerate(parts):
                _decode_scan(part, blocks[k * step:(k + 1) * step],
                             len(scan))
        elif marker == 0xD9:
            break
    else:
        raise ValueError("truncated JPEG: no end of image")
    if not frame or any(c.qt is None for c in comps):
        raise ValueError("JPEG without a complete scan")
    planes = []
    for c in comps:
        coef = np.frombuffer(c.coefs, np.int32).reshape(
            c.grid_h, c.grid_w, 64)[:c.bh, :c.bw].reshape(-1, 64)
        nat = np.zeros_like(coef, dtype=np.int64)
        nat[:, ZIGZAG] = coef
        px = _idct_islow((nat * c.qt).reshape(-1, 8, 8))
        px = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            c.bh * 8, c.bw * 8)[:c.height, :c.width]
        planes.append(px)
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    full = [_upsample(p, hmax // c.h, vmax // c.v)[:H, :W]
            for p, c in zip(planes, comps)]
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.cid for c in comps] == [82, 71, 66]
    if rgb:
        return np.stack(full, -1)
    return _ycc_to_rgb(*full)


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
