"""PNG reading and writing, and the resize rules of the scene loader, on
numpy and the standard library.

The JAX package reads frames with PIL and disparities and flows with
OpenCV (`nsff_pl_tpu/scene/monocular.py:35-55`, `scene/flowio.py:44-55`).
Neither is needed here; each rule below reproduces the one the JAX
scene applies, bit for bit where it works on integers:

- `read_png`: non-interlaced PNG of 1-bit, 8-bit and 16-bit grey, 8-bit
  grey + alpha, RGB and RGBA, every row filter. Palette, interlaced and
  other depths, and JPEG files, raise `NotImplementedError`.
- `to_rgb` / `to_l`: PIL's `convert("RGB")` / `convert("L")` (ITU-R 601-2
  luma in PIL's integer weights; 16-bit grey clipped at 255).
- `imread_anydepth`: OpenCV's `imread(path, IMREAD_ANYDEPTH)` of a grey
  file (1-bit as 0/255).
- `resize_lanczos`: PIL's `resize(..., LANCZOS)` of an 8-bit image: the
  a=3 kernel widened by the scale when shrinking, each output pixel's
  weights normalised and quantised to 22 fractional bits, a horizontal
  then a vertical pass, each rounded and clipped to uint8.
- `resize_nearest_pil`: PIL's `NEAREST` (pixel centres, positions summed
  along the row as PIL does).
- `resize_nearest_cv2`: `cv2.INTER_NEAREST` (floor(x * src/dst)).
- `resize_linear_cv2`: `cv2.INTER_LINEAR` of a float32 image (centres
  aligned, edges clamped, float weights).
- `png_bytes` / `write_png`: PNG files of 8-bit grey and RGB and 16-bit
  grey, with a chosen row filter per row.
- `gif_bytes` / `write_gif`: an animated GIF of RGB frames (the eval
  CLI's video where no ffmpeg is installed), on a fixed 3-3-2 palette.

The row filters of a decoded image are undone in one pass over its
anti-diagonals: a pixel depends only on its left, upper and upper-left
neighbours, so every pixel of one anti-diagonal is decoded at once from
the two before it, whatever each row's filter.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_UNPORTED = ("(ROADMAP.md queue A, 'JPEG frames': only non-interlaced "
             "grey, grey + alpha, RGB and RGBA PNG files are read)")
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_DEPTHS = {0: (1, 8, 16), 2: (8,), 4: (8,), 6: (8,)}


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield tag, body
        pos += 12 + n
        if tag == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of (h, stride) bytes, `bpp` bytes a
    filter unit. Rows of filters None / Sub / Up only go row by row;
    otherwise every anti-diagonal of (row, unit) cells is decoded at
    once."""
    h, stride = data.shape
    n = stride // bpp
    x = data.reshape(h, n, bpp).astype(np.int16)
    kinds = set(int(f) for f in np.unique(ftype))
    if kinds <= {0, 1, 2}:
        prev = np.zeros((n, bpp), np.int16)
        out = np.empty_like(x)
        for r in range(h):
            f = ftype[r]
            row = x[r]
            if f == 1:
                row = np.cumsum(row, 0, dtype=np.int64).astype(np.int16)
            elif f == 2:
                row = row + prev
            prev = out[r] = row & 255
        return out.reshape(h, stride).astype(np.uint8)
    # skewed layout: z[d + 2, r + 1] holds cell (r, d - r); z[:, 0] and
    # z[:2] stay zero (the row above the first, the units left of the
    # first)
    D = h + n - 1
    rz = np.zeros((D, h, bpp), np.int16)
    rr, cc = np.meshgrid(np.arange(h), np.arange(n), indexing="ij")
    rz[rr + cc, rr] = x
    z = np.zeros((D + 2, h + 1, bpp), np.int16)
    f = ftype.reshape(h, 1)
    for d in range(D):
        r0, r1 = max(0, d - n + 1), min(h, d + 1)
        a = z[d + 1, r0 + 1:r1 + 1]
        b = z[d + 1, r0:r1]
        c = z[d, r0:r1]
        fd = f[r0:r1]
        pred = np.where(fd == 1, a, 0)
        if 2 in kinds:
            pred = np.where(fd == 2, b, pred)
        if 3 in kinds:
            pred = np.where(fd == 3, (a + b) >> 1, pred)
        if 4 in kinds:
            pred = np.where(fd == 4, _paeth(a, b, c), pred)
        z[d + 2, r0 + 1:r1 + 1] = (rz[d, r0:r1] + pred) & 255
    out = z[rr + cc + 2, rr + 1]
    return out.reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> array: (h, w) bool for 1-bit grey, (h, w) uint8
    or uint16 for grey, (h, w, 2 | 3 | 4) uint8 for grey + alpha, RGB,
    RGBA."""
    if data[:3] == b"\xff\xd8\xff":
        raise NotImplementedError(f"JPEG file {_UNPORTED}")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise NotImplementedError(
            f"PNG of color type {ctype} at {depth} bits {_UNPORTED}")
    if interlace:
        raise NotImplementedError(f"interlaced PNG {_UNPORTED}")
    if comp != 0 or filt != 0:
        raise ValueError("unknown PNG compression or filter method")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError("unknown PNG row filter")
    px = _unfilter(rows[:, 1:], ftype, max(1, bits // 8))
    if depth == 1:
        return np.unpackbits(px, axis=1)[:, :w].astype(bool)
    if depth == 16:
        return (px[:, 0::2].astype(np.uint16) << 8) | px[:, 1::2]
    img = px.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _grey8(img: np.ndarray) -> np.ndarray:
    """1-bit -> 0/255, 16-bit -> clipped at 255 (PIL's rules)."""
    if img.dtype == bool:
        return img.astype(np.uint8) * 255
    if img.dtype == np.uint16:
        return np.minimum(img, 255).astype(np.uint8)
    return img


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGB")` -> (h, w, 3) uint8."""
    if img.ndim == 2:
        return np.repeat(_grey8(img)[..., None], 3, -1)
    if img.shape[-1] == 2:  # grey + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def to_l(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("L")` -> (h, w) uint8."""
    if img.ndim == 2:
        return _grey8(img)
    if img.shape[-1] == 2:
        return img[..., 0].copy()
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def imread_anydepth(path: str) -> np.ndarray:
    """OpenCV's `imread(path, IMREAD_ANYDEPTH)` of a grey PNG: uint8 or
    uint16 (h, w); 1-bit files read as 0/255."""
    img = read_png(path)
    if img.ndim != 2:
        raise NotImplementedError(
            f"{path}: a disparity map must be a grey PNG {_UNPORTED}")
    return img.astype(np.uint8) * 255 if img.dtype == bool else img


# ---------------------------------------------------------------------------
# resize rules
# ---------------------------------------------------------------------------

_PRECISION_BITS = 22


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's precomputed coefficients for one axis: the first source
    index of each output pixel (out,) and the 22-bit fixed-point weights
    (out, ksize), zero past each pixel's support."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        xmins[xx] = xmin
    q = kk * (1 << _PRECISION_BITS)
    q = np.trunc(np.where(q < 0, q - 0.5, q + 0.5)).astype(np.int64)
    return xmins, q


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmins, kk = _lanczos_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmins + k, in_size - 1)
        acc += src[idx] * kk[:, k].reshape((out_size,) + extra)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, LANCZOS)` of an 8-bit (h, w) or (h, w, c)
    image; `size` is (w, h)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {img.dtype}")
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _lanczos_pass(out, w, 1)
    if h != img.shape[0]:
        out = _lanczos_pass(out, h, 0)
    return out.copy() if out is img else out


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel under PIL's NEAREST: the pixel
    centre's position, summed step by step as PIL's scaler does."""
    step = in_size / out_size
    idx = np.empty(out_size, np.int64)
    pos = step * 0.5
    for i in range(out_size):
        idx[i] = min(int(pos), in_size - 1)
        pos += step
    return idx


def resize_nearest_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, NEAREST)`; `size` is (w, h)."""
    w, h = size
    if (h, w) == img.shape[:2]:
        return img.copy()
    ys = _pil_nearest_index(img.shape[0], h)
    xs = _pil_nearest_index(img.shape[1], w)
    return img[ys[:, None], xs[None, :]]


def resize_nearest_cv2(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`; `size` is
    (w, h)."""
    w, h = size
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    return img[ys.astype(np.int64)[:, None], xs.astype(np.int64)[None, :]]


def _linear_taps(in_size: int, out_size: int):
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    high = s >= in_size - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = in_size - 1
    return s, np.minimum(s + 1, in_size - 1), f


def resize_linear_cv2(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)` of a float32
    (h, w) or (h, w, c) image; `size` is (w, h)."""
    img = np.asarray(img, np.float32)
    w, h = size
    x0, x1, fx = _linear_taps(img.shape[1], w)
    y0, y1, fy = _linear_taps(img.shape[0], h)
    extra = (1,) * (img.ndim - 2)
    ax = fx.reshape((1, w) + extra)
    rows = img[:, x0] * (np.float32(1) - ax) + img[:, x1] * ax
    ay = fy.reshape((h, 1) + extra)
    return rows[y0] * (np.float32(1) - ay) + rows[y1] * ay


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _filter_rows(px: np.ndarray, filters: np.ndarray, bpp: int) -> bytes:
    """Apply PNG row filter `filters[r]` to each row of (h, stride) bytes."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    f = np.asarray(filters).reshape(-1, 1)
    pred = np.choose(np.broadcast_to(f, x.shape), preds)
    out = ((x - pred) & 255).astype(np.uint8)
    return np.concatenate([f.astype(np.uint8), out], 1).tobytes()


def png_bytes(img: np.ndarray,
              filters: Optional[Sequence[int]] = None) -> bytes:
    """PNG file bytes of an (h, w, 3) uint8 RGB, (h, w) uint8 grey or
    (h, w) uint16 grey image. `filters` gives each row's filter type
    (0-4), cycled over the rows; none by default."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, bpp = 16, 0, 2
        px = img.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype, bpp = 8, 0, 1
        px = img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, ctype, bpp = 8, 2, 3
        px = img.reshape(h, 3 * w)
    else:
        raise ValueError(f"png_bytes takes (h, w, 3) uint8 or (h, w) uint8 "
                         f"/ uint16, got {img.shape} {img.dtype}")
    rows = np.resize(np.asarray(filters if filters is not None else [0],
                                np.int64), h)
    raw = _filter_rows(px, rows, bpp)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filters: Optional[Sequence[int]] = None) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img, filters))


# the GIF's fixed palette: 3 bits of red, 3 of green, 2 of blue
_GIF_PALETTE = np.stack(np.meshgrid(
    np.round(np.arange(8) * 255 / 7), np.round(np.arange(8) * 255 / 7),
    np.round(np.arange(4) * 255 / 3), indexing="ij"), -1).reshape(
        256, 3).astype(np.uint8)
# literal codes between two clear codes: the decoder's table then never
# reaches 512 entries, so every code stays 9 bits wide
_GIF_RUN = 250


def _gif_lzw(index: np.ndarray) -> bytes:
    """The LZW image data of one frame of 8-bit palette indices, without
    compression: 9-bit literal codes, a clear code before every
    `_GIF_RUN` of them, the end code last; packed least significant bit
    first into sub-blocks of 255 bytes."""
    px = index.reshape(-1).astype(np.uint16)
    n_runs = -(-px.size // _GIF_RUN)
    codes = np.full((n_runs, _GIF_RUN + 1), -1, np.int32)
    codes[:, 0] = 256  # clear
    flat = np.full(n_runs * _GIF_RUN, -1, np.int32)
    flat[:px.size] = px
    codes[:, 1:] = flat.reshape(n_runs, _GIF_RUN)
    codes = np.append(codes[codes >= 0], 257).astype(np.uint16)  # end
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(
        np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
              for i in range(0, len(data), 255)]
    return bytes([8]) + b"".join(blocks) + b"\x00"


def gif_bytes(frames: Sequence[np.ndarray], fps: float = 10) -> bytes:
    """Animated GIF file bytes of (h, w, 3) uint8 RGB frames, looping,
    `fps` frames a second, each quantised to the 3-3-2 palette."""
    h, w = frames[0].shape[:2]
    delay = max(int(round(100 / fps)), 1)  # hundredths of a second
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           _GIF_PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        f = np.asarray(f)
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"gif frames: (h, w, 3) uint8 of one size, got "
                             f"{f.shape} {f.dtype}")
        index = ((f[..., 0] >> 5).astype(np.uint8) << 5) \
            | ((f[..., 1] >> 5).astype(np.uint8) << 2) | (f[..., 2] >> 6)
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(index))
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 10) -> None:
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, fps))
