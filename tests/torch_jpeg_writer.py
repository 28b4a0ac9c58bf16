"""JPEG files in every coding the readers take, written from quantised
coefficients (or, lossless, from samples) on numpy and the standard
library alone, so that both the CPU tests and `chip_smoke.py` (on a
machine without PIL or OpenCV) can make them.

- `Frame`: the frame description: size, components (id, h, v, table),
  quantisation tables (natural order), precision.
- `dct_coefficients`: quantised coefficients of an RGB, grey or CMYK
  image at any sampling factors (the full MCU grid of each component,
  zigzag order), for files no library writes; `coefficients_of`: those
  of a JPEG file, to rewrite them in another coding.
- `write_dct`: sequential (SOF1 / SOF9) or progressive (SOF2 / SOF10)
  files, Huffman or arithmetic coded, with any scan script (default:
  libjpeg's `jpeg_simple_progression`, PIL's and OpenCV's), restart
  intervals, DAC conditioning, JFIF or Adobe markers (transform 0, 1 or
  2) and the SOF marker overridden (hierarchical kinds, to check that
  they raise).
- `write_lossless`: lossless files (SOF3 / SOF11), any predictor 1-7,
  point transform and restart interval (whole MCU rows).

Huffman tables are made per scan from the symbols it uses, all codes of
one length. The arithmetic coder is libjpeg's `jcarith.c` (T.81 Annex D)
with its statistics bins; the decoder under test has its own.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nsff_pl_tpu_torch.scene import jpeg

ZIGZAG = jpeg.ZIGZAG


@dataclass
class Frame:
    width: int
    height: int
    # (component id, h, v, quantisation table id)
    comps: List[Tuple[int, int, int, int]]
    qtables: Dict[int, np.ndarray] = field(default_factory=dict)
    precision: int = 8

    @property
    def hmax(self):
        return max(c[1] for c in self.comps)

    @property
    def vmax(self):
        return max(c[2] for c in self.comps)

    def mcus(self, unit=8):
        return (-(-self.width // (unit * self.hmax)),
                -(-self.height // (unit * self.vmax)))

    def comp_blocks(self, ci, unit=8):
        """(blocks across, blocks down) of component ci's real area."""
        _, h, v, _ = self.comps[ci]
        w = -(-self.width * h // self.hmax)
        hh = -(-self.height * v // self.vmax)
        return -(-w // unit), -(-hh // unit)


# ---------------------------------------------------------------------------
# coefficients of an image
# ---------------------------------------------------------------------------

def dct_coefficients(img: np.ndarray, factors, quality=90, ycc=True):
    """(h, w, c) or (h, w) uint8 -> (Frame, [(grid_h, grid_w, 64) int64 zigzag
    coefficients a component]). Colour is converted to YCbCr when `ycc`
    (the first three channels of a 4-channel image: YCCK); each
    component is point-sampled to its size, padded by edge
    replication to its MCU grid, transformed with the islow FDCT and
    quantised with the quality-scaled standard tables."""
    img = np.asarray(img)
    planes = [img] if img.ndim == 2 else [img[..., i] for i in
                                          range(img.shape[2])]
    planes = [p.astype(np.int64) for p in planes]
    if ycc and len(planes) >= 3:
        y, cb, cr = jpeg._rgb_to_ycc(np.stack(planes[:3], -1))
        planes = [y, cb, cr] + planes[3:]
    H, W = img.shape[:2]
    qt = {0: jpeg._quality_table(jpeg._STD_LUMA_Q, quality),
          1: jpeg._quality_table(jpeg._STD_CHROMA_Q, quality)}
    ids = [1, 2, 3, 4][:len(planes)]
    comps = [(cid, h, v, 0 if i in (0, 3) else 1)
             for i, (cid, (h, v)) in enumerate(zip(ids, factors))]
    frame = Frame(W, H, comps, {k: qt[k] for k in {c[3] for c in comps}})
    mx, my = frame.mcus()
    out = []
    for (cid, h, v, tq), p in zip(comps, planes):
        ch, cw = -(-H * v // frame.vmax), -(-W * h // frame.hmax)
        p = p[(np.arange(ch) * frame.vmax) // v][
            :, (np.arange(cw) * frame.hmax) // h]
        gh, gw = my * v * 8, mx * h * 8
        p = np.pad(p, ((0, gh - p.shape[0]), (0, gw - p.shape[1])), "edge")
        blk = jpeg._blocks_of(p.astype(np.int64) - 128)
        bh, bw = blk.shape[:2]
        t = jpeg._fdct_islow(blk.reshape(-1, 8, 8)).reshape(-1, 64)
        d = qt[tq] << 3
        q = np.sign(t) * ((np.abs(t) + (d >> 1)) // d)
        out.append(q[:, ZIGZAG].reshape(bh, bw, 64))
    return frame, out


def coefficients_of(data: bytes):
    """(Frame, coefficients) of a DCT-based JPEG file, as
    `jpeg.read_coefficients` reads them: rewriting them in another coding
    gives a file that decodes to the same pixels (block smoothing aside,
    which a complete progression never triggers)."""
    f = jpeg.read_coefficients(data)
    frame = Frame(f.width, f.height,
                  [(c.cid, c.h, c.v, c.tq) for c in f.comps],
                  {c.tq: c.qt for c in f.comps})
    coefs = [np.frombuffer(c.coefs, np.int32).reshape(
        c.grid_h, c.grid_w, 64).astype(np.int64) for c in f.comps]
    return frame, coefs


# ---------------------------------------------------------------------------
# bits
# ---------------------------------------------------------------------------

class _Bits:
    """A Huffman-coded segment: bits in, bytes out (0xFF stuffed, the last
    byte padded with ones)."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value, nbits):
        if nbits <= 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _nbits(v):
    return int(abs(int(v))).bit_length()


def _huff_table(symbols):
    """A table over the symbols used, every code of one length: (counts,
    values, {symbol: (code, length)})."""
    syms = sorted(set(symbols)) or [0]
    length = max(1, (len(syms)).bit_length())
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return counts, syms, {s: (i, length) for i, s in enumerate(syms)}


# ---------------------------------------------------------------------------
# the arithmetic coder (jcarith.c)
# ---------------------------------------------------------------------------

class _Arith:
    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1
        self.out = bytearray()

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm = (jpeg._QE[sv & 0x7F], jpeg._NLPS[sv & 0x7F],
                      jpeg._NMPS[sv & 0x7F])
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self.out += b"\xff\x00"
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self.out += b"\xff\x00"
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_magnitude(coder, st, s, v, x_bin):
    """Magnitude category and bits of |v| - 1 = v (Figures F.8, F.9) from
    bin `s`; `x_bin` is the first X bin after the first decision (DC:
    X1 = 20 at once; AC: the second decision also at `s`, then X2 = 189
    or 217, passed as an int), or None."""
    m = 0
    if v:
        coder.encode(st, s, 1)
        m = 1
        v2 = v >> 1
        if x_bin[0] == "dc":
            s = 20
            v2 = v
            while True:
                v2 >>= 1
                if not v2:
                    break
                coder.encode(st, s, 1)
                m <<= 1
                s += 1
        elif v2:
            coder.encode(st, s, 1)
            m <<= 1
            s = x_bin[1]
            while True:
                v2 >>= 1
                if not v2:
                    break
                coder.encode(st, s, 1)
                m <<= 1
                s += 1
    coder.encode(st, s, 0)
    s += 14
    while m > 1:
        m >>= 1
        coder.encode(st, s, int(bool(m & v)))


def _arith_dc(coder, st, ctx, ci, diff, cond):
    """One DC difference (F.1.4.1); ctx[ci] is the component's
    conditioning context (0, 4, 8, 12, 16)."""
    s0 = ctx[ci]
    if diff == 0:
        coder.encode(st, s0, 0)
        ctx[ci] = 0
        return
    coder.encode(st, s0, 1)
    neg = int(diff < 0)
    coder.encode(st, s0 + 1, neg)
    v = abs(diff) - 1
    m = 1 << (v.bit_length() - 1) if v else 0
    _arith_magnitude(coder, st, s0 + 2 + neg, v, ("dc",))
    L, U = cond
    if m < (1 << L) >> 1:
        ctx[ci] = 0
    elif m > (1 << U) >> 1:
        ctx[ci] = 12 + 4 * neg
    else:
        ctx[ci] = 4 + 4 * neg


def _arith_ac(coder, st, fixed, zz, ss, se, al, kx):
    """AC coefficients ss..se of one block at point transform al (F.5)."""
    vals = {k: _shift(zz[k], al) for k in range(1, se + 1)}
    ke = max((k for k, x in vals.items() if x), default=0)
    k = ss
    while k <= ke:
        s0 = 3 * (k - 1)
        coder.encode(st, s0, 0)
        while vals[k] == 0:
            coder.encode(st, s0 + 1, 0)
            s0 += 3
            k += 1
        coder.encode(st, s0 + 1, 1)
        coder.encode(fixed, 0, int(vals[k] < 0))
        _arith_magnitude(coder, st, s0 + 2, abs(vals[k]) - 1,
                         ("ac", 189 if k <= kx else 217))
        k += 1
    if k <= se:
        coder.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(coder, st, fixed, zz, ss, se, ah, al):
    """Successive-approximation AC refinement of one block (G.10)."""
    ke = max((k for k in range(1, se + 1) if abs(int(zz[k])) >> al),
             default=0)
    kex = max((k for k in range(1, ke + 1) if abs(int(zz[k])) >> ah),
              default=0)
    k = ss
    while k <= ke:
        s0 = 3 * (k - 1)
        if k > kex:
            coder.encode(st, s0, 0)
        while True:
            v = abs(int(zz[k])) >> al
            if v:
                if v >> 1:
                    coder.encode(st, s0 + 2, v & 1)
                else:
                    coder.encode(st, s0 + 1, 1)
                    coder.encode(fixed, 0, int(zz[k] < 0))
                break
            coder.encode(st, s0 + 1, 0)
            s0 += 3
            k += 1
        k += 1
    if k <= se:
        coder.encode(st, 3 * (k - 1), 1)


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def simple_progression(n_comps: int):
    """libjpeg's `jpeg_simple_progression` script: (components, Ss, Se,
    Ah, Al) a scan."""
    if n_comps == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    scans = [(tuple(range(n_comps)), 0, 0, 0, 1)]
    for c in range(n_comps):
        scans += [((c,), 1, 5, 0, 2), ((c,), 6, 63, 0, 2)]
    for c in range(n_comps):
        scans.append(((c,), 1, 63, 2, 1))
    scans.append((tuple(range(n_comps)), 0, 0, 1, 0))
    for c in range(n_comps):
        scans.append(((c,), 1, 63, 1, 0))
    return scans


def _units(frame: Frame, comps_in_scan, unit=8):
    """The data units of one scan in coding order, grouped by MCU:
    [[(component, row, col), ...] an MCU]."""
    if len(comps_in_scan) == 1:
        ci = comps_in_scan[0]
        bw, bh = frame.comp_blocks(ci, unit)
        return [[(ci, r, c)] for r in range(bh) for c in range(bw)]
    mx, my = frame.mcus(unit)
    out = []
    for r in range(my):
        for c in range(mx):
            mcu = []
            for ci in comps_in_scan:
                _, h, v, _ = frame.comps[ci]
                mcu += [(ci, r * v + y, c * h + x) for y in range(v)
                        for x in range(h)]
            out.append(mcu)
    return out


def _shift(x, al):
    """The point transform of an AC coefficient: |x| >> al with x's sign."""
    x = int(x)
    return -((-x) >> al) if x < 0 else x >> al


def _huff_scan(frame, coefs, scan, progressive, restart):
    """Huffman-coded scan: (DHT bodies, the entropy-coded bytes with its
    RST markers). Events are gathered first, then the tables made."""
    comps_in, ss, se, ah, al = scan
    units = _units(frame, comps_in)
    interval = restart or len(units)
    segments = []  # lists of (table key, symbol or None, bits, nbits)
    for start in range(0, len(units), interval):
        ev = []
        pred = {ci: 0 for ci in comps_in}
        eobrun, be = 0, []

        def emit_eobrun():
            nonlocal eobrun, be
            if eobrun:
                n = eobrun.bit_length() - 1
                ev.append((("ac", comps_in[0]), n << 4, eobrun, n))
                eobrun = 0
            for b in be:
                ev.append((None, None, b, 1))
            be = []

        for mcu in units[start:start + interval]:
            for ci, r, c in mcu:
                zz = coefs[ci][r, c]
                if not progressive:
                    dc = int(zz[0])
                    diff = dc - pred[ci]
                    pred[ci] = dc
                    n = _nbits(diff)
                    ev.append((("dc", ci), n, diff - (diff < 0), n))
                    run = 0
                    last = max((k for k in range(1, 64) if zz[k]), default=0)
                    for k in range(1, last + 1):
                        x = int(zz[k])
                        if x == 0:
                            run += 1
                            continue
                        while run > 15:
                            ev.append((("ac", ci), 0xF0, 0, 0))
                            run -= 16
                        n = _nbits(x)
                        ev.append((("ac", ci), (run << 4) | n, x - (x < 0),
                                   n))
                        run = 0
                    if last < 63:
                        ev.append((("ac", ci), 0x00, 0, 0))
                elif ss == 0 and ah == 0:
                    dc = int(zz[0]) >> al
                    diff = dc - pred[ci]
                    pred[ci] = dc
                    n = _nbits(diff)
                    ev.append((("dc", ci), n, diff - (diff < 0), n))
                elif ss == 0:
                    ev.append((None, None, (int(zz[0]) >> al) & 1, 1))
                elif ah == 0:
                    run = 0
                    for k in range(ss, se + 1):
                        x = _shift(zz[k], al)
                        if x == 0:
                            run += 1
                            continue
                        emit_eobrun()
                        while run > 15:
                            ev.append((("ac", ci), 0xF0, 0, 0))
                            run -= 16
                        n = _nbits(x)
                        ev.append((("ac", ci), (run << 4) | n, x - (x < 0),
                                   n))
                        run = 0
                    if run:
                        eobrun += 1
                        if eobrun == 0x7FFF:
                            emit_eobrun()
                else:
                    absv = {k: abs(int(zz[k])) >> al for k in
                            range(ss, se + 1)}
                    eob = max((k for k, a in absv.items() if a == 1),
                              default=0)
                    run, br = 0, []
                    for k in range(ss, se + 1):
                        a = absv[k]
                        if a == 0:
                            run += 1
                            continue
                        while run > 15 and k <= eob:
                            emit_eobrun()
                            ev.append((("ac", ci), 0xF0, 0, 0))
                            run -= 16
                            ev += [(None, None, b, 1) for b in br]
                            br = []
                        if a > 1:
                            br.append(a & 1)
                            continue
                        emit_eobrun()
                        ev.append((("ac", ci), (run << 4) | 1,
                                   int(zz[k] > 0), 1))
                        ev += [(None, None, b, 1) for b in br]
                        br, run = [], 0
                    if run or br:
                        eobrun += 1
                        be += br
                        if eobrun == 0x7FFF or len(be) > 1000 - 64 + 1:
                            emit_eobrun()
        emit_eobrun()
        segments.append(ev)
    # one table per kind and component, table ids in component order
    keys = sorted({e[0] for ev in segments for e in ev if e[0] is not None},
                  key=lambda k: (k[0], comps_in.index(k[1])))
    tabs, dht = {}, []
    ids = {"dc": {}, "ac": {}}
    for key in keys:
        kind, ci = key
        tid = len(ids[kind])
        ids[kind][ci] = tid
        counts, values, codes = _huff_table(
            [e[1] for ev in segments for e in ev if e[0] == key])
        tabs[key] = codes
        dht.append(bytes([(kind == "ac") << 4 | tid] + counts)
                   + bytes(values))
    out = []
    for i, ev in enumerate(segments):
        bits = _Bits()
        for key, sym, val, n in ev:
            if key is not None:
                code, length = tabs[key][sym]
                bits.put(code, length)
            bits.put(val, n)
        out.append(bits.flush())
        if i + 1 < len(segments):
            out.append(bytes([0xFF, 0xD0 + i % 8]))
    tsel = [(ids["dc"].get(ci, 0) << 4) | ids["ac"].get(ci, 0)
            for ci in comps_in]
    return dht, b"".join(out), tsel


def _arith_scan(frame, coefs, scan, progressive, restart, cond):
    """Arithmetic-coded scan: (entropy-coded bytes, table selectors).
    Component i of the frame uses conditioning tables i % 4 (DC) and
    i % 4 (AC); `cond` maps ("dc", t) -> (L, U) and ("ac", t) -> Kx."""
    comps_in, ss, se, ah, al = scan
    units = _units(frame, comps_in)
    interval = restart or len(units)
    tsel = [((ci % 4) << 4) | (ci % 4) for ci in comps_in]
    out = []
    for n_seg, start in enumerate(range(0, len(units), interval)):
        coder = _Arith()
        dc_st = {ci % 4: [0] * 64 for ci in comps_in}
        ac_st = {ci % 4: [0] * 256 for ci in comps_in}
        fixed = [113]
        ctx = {ci: 0 for ci in comps_in}
        pred = {ci: 0 for ci in comps_in}
        for mcu in units[start:start + interval]:
            for ci, r, c in mcu:
                zz = coefs[ci][r, c]
                t = ci % 4
                dcc = cond.get(("dc", t), (0, 1))
                kx = cond.get(("ac", t), 5)
                if not progressive or (ss == 0 and ah == 0):
                    dc = int(zz[0]) >> (al if progressive else 0)
                    _arith_dc(coder, dc_st[t], ctx, ci, dc - pred[ci], dcc)
                    pred[ci] = dc
                    if not progressive:
                        _arith_ac(coder, ac_st[t], fixed, zz, 1, 63, 0, kx)
                elif ss == 0:
                    coder.encode(fixed, 0, (int(zz[0]) >> al) & 1)
                elif ah == 0:
                    _arith_ac(coder, ac_st[t], fixed, zz, ss, se, al, kx)
                else:
                    _arith_ac_refine(coder, ac_st[t], fixed, zz, ss, se, ah,
                                     al)
        out.append(coder.finish())
        if start + interval < len(units):
            out.append(bytes([0xFF, 0xD0 + n_seg % 8]))
    return b"".join(out), tsel


def _marker(tag, body):
    return bytes([0xFF, tag]) + struct.pack(">H", len(body) + 2) + body


def _header(frame, sof, restart, jfif, adobe, dac, qtables=True):
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00"))
    if adobe is not None:
        out.append(_marker(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                        adobe)))
    if qtables:
        for tq, t in sorted(frame.qtables.items()):
            t = np.asarray(t)[ZIGZAG]
            if t.max() > 255:
                out.append(_marker(0xDB, bytes([0x10 | tq]) + b"".join(
                    struct.pack(">H", int(x)) for x in t)))
            else:
                out.append(_marker(0xDB, bytes([tq]) + bytes(
                    t.astype(np.uint8).tolist())))
    out.append(_marker(sof, struct.pack(
        ">BHHB", frame.precision, frame.height, frame.width,
        len(frame.comps)) + b"".join(
            bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in frame.comps)))
    if dac:
        out.append(_marker(0xCC, b"".join(
            bytes([(kind == "ac") << 4 | t, val if kind == "ac"
                   else (val[1] << 4) | val[0]])
            for (kind, t), val in sorted(dac.items()))))
    if restart:
        out.append(_marker(0xDD, struct.pack(">H", restart)))
    return out


def write_dct(frame: Frame, coefs: Sequence[np.ndarray], *,
              progressive=False, arithmetic=False,
              scans: Optional[list] = None, restart: int = 0,
              jfif: bool = True, adobe: Optional[int] = None,
              dac: Optional[dict] = None, sof: Optional[int] = None) -> bytes:
    """A DCT-based file of the quantised coefficients `coefs` (one (grid_h,
    grid_w, 64) zigzag array a component, the full MCU grid). `scans`
    lists (components, Ss, Se, Ah, Al) for a progressive file (default
    `simple_progression`); a sequential file has one interleaved scan.
    `dac` maps ("dc", table) -> (L, U) and ("ac", table) -> Kx."""
    n = len(frame.comps)
    if sof is None:
        sof = {(False, False): 0xC1, (True, False): 0xC2,
               (False, True): 0xC9, (True, True): 0xCA}[
                   progressive, arithmetic]
    if not progressive:
        scans = [(tuple(range(n)), 0, 63, 0, 0)]
    elif scans is None:
        scans = simple_progression(n)
    out = _header(frame, sof, restart, jfif, adobe, dac)
    cond = dict(dac or {})
    for scan in scans:
        comps_in, ss, se, ah, al = scan
        if arithmetic:
            ecs, tsel = _arith_scan(frame, coefs, scan, progressive,
                                    restart, cond)
        else:
            dht, ecs, tsel = _huff_scan(frame, coefs, scan, progressive,
                                        restart)
            out += [_marker(0xC4, t) for t in dht]
        sos = bytes([len(comps_in)]) + b"".join(
            bytes([frame.comps[ci][0], t]) for ci, t in zip(comps_in, tsel))
        out.append(_marker(0xDA, sos + bytes([ss, se, (ah << 4) | al])))
        out.append(ecs)
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------

def _predict(rows, pred, pt, precision, restart_rows_at):
    """Differences of one component's (h, w) samples (already shifted
    right by pt) under predictor `pred`, the first row of the image and
    of each restart interval predicted from the row itself."""
    x = rows.astype(np.int64)
    h, w = x.shape
    diff = np.zeros_like(x)
    init = 1 << (precision - pt - 1)
    for r in range(h):
        first = r in restart_rows_at
        for c in range(w):
            if first:
                p = init if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, 0]
            else:
                ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
                p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                     5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                     7: (ra + rb) >> 1}[pred]
            diff[r, c] = ((x[r, c] - p + 32768) & 0xFFFF) - 32768
    return diff


def write_lossless(planes: Sequence[np.ndarray], factors, *, predictor=1,
                   pt=0, arithmetic=False, restart_rows=0, jfif=False,
                   adobe=None, ids=None, dac=None) -> bytes:
    """A lossless file (SOF3 / SOF11, one interleaved scan) of 8-bit
    sample planes (component i at its own size, factors[i] = (h, v)).
    `restart_rows` sets the restart interval to that many MCU rows."""
    ids = ids or list(range(1, len(planes) + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    W = planes[0].shape[1] * hmax // factors[0][0]
    H = planes[0].shape[0] * vmax // factors[0][1]
    frame = Frame(W, H, [(cid, h, v, 0) for cid, (h, v) in zip(ids,
                                                                factors)])
    mx, my = frame.mcus(unit=1)
    restart = restart_rows * mx
    # restarts reset the predictor at these rows of each component
    diffs = []
    for ci, (p, (h, v)) in enumerate(zip(planes, factors)):
        at = {0} | ({k * restart_rows * v for k in range(1, my)}
                    if restart_rows else set())
        d = _predict(np.asarray(p) >> pt, predictor, pt, 8, at)
        full = np.zeros((my * v, mx * h), np.int64)
        full[:d.shape[0], :d.shape[1]] = d
        diffs.append(full)
    comps_in = tuple(range(len(planes)))
    units = _units(frame, comps_in, unit=1)
    interval = restart or len(units)
    out = _header(frame, 0xCB if arithmetic else 0xC3, restart, jfif, adobe,
                  dac, qtables=False)
    segs = []
    if arithmetic:
        cond = dict(dac or {})
        for start in range(0, len(units), interval):
            coder = _Arith()
            st = {ci % 4: [0] * 64 for ci in comps_in}
            ctx = {ci: 0 for ci in comps_in}
            for mcu in units[start:start + interval]:
                for ci, r, c in mcu:
                    t = ci % 4
                    _arith_dc(coder, st[t], ctx, ci, int(diffs[ci][r, c]),
                              cond.get(("dc", t), (0, 1)))
            segs.append(coder.finish())
        tsel = [(ci % 4) << 4 for ci in comps_in]
    else:
        syms = {}
        for ci in comps_in:
            n = np.vectorize(_nbits)(diffs[ci])
            syms[ci] = set(n.reshape(-1).tolist())
        tabs = {ci: _huff_table(syms[ci]) for ci in comps_in}
        for ci in comps_in:
            counts, values, _ = tabs[ci]
            out.append(_marker(0xC4, bytes([ci] + counts) + bytes(values)))
        for start in range(0, len(units), interval):
            bits = _Bits()
            for mcu in units[start:start + interval]:
                for ci, r, c in mcu:
                    d = int(diffs[ci][r, c])
                    n = _nbits(d)
                    code, length = tabs[ci][2][n]
                    bits.put(code, length)
                    if n < 16:
                        bits.put(d - (d < 0), n)
            segs.append(bits.flush())
        tsel = [ci << 4 for ci in comps_in]
    ecs = []
    for i, s in enumerate(segs):
        ecs.append(s)
        if i + 1 < len(segs):
            ecs.append(bytes([0xFF, 0xD0 + i % 8]))
    sos = bytes([len(comps_in)]) + b"".join(
        bytes([ids[ci], t]) for ci, t in zip(comps_in, tsel))
    out.append(_marker(0xDA, sos + bytes([predictor, 0, pt])))
    out.append(b"".join(ecs))
    out.append(b"\xff\xd9")
    return b"".join(out)
