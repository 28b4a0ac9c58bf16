"""The port's JPEG codec and image readers (`nsff_pl_tpu_torch/scene/
jpeg.py`, `scene/imageio.py`) against PIL and OpenCV, on files they write
here (no JAX).

Tolerances: none. Every comparison is bit for bit:
- `decode_jpeg` / `read_image` (+ `to_rgb` / `to_l`) equal PIL's
  `convert("RGB")` / `convert("L")`, and `imread_color` equals
  `cv2.imread(IMREAD_COLOR)`, on 4:4:4, 4:2:2, 4:2:0 and 4:4:0 files at
  qualities 50-100, sizes 1x1 to 64x48, grey files, restart intervals,
  optimised Huffman tables, 16-bit quantisation tables (SOF1), and
  non-interleaved scans; `imread_color` turns by EXIF orientations 1-8
  as OpenCV does, `read_image` does not, as PIL does not;
- `encode_jpeg` writes `cv2.imencode('.jpg')`'s bytes (RGB and grey);
- PNG: palette at 1/2/4/8 bits, grey at 2/4 bits, 16-bit RGB, RGBA and
  grey + alpha, each also Adam7-interlaced (built here: PIL writes no
  interlaced file), decode to PIL's and OpenCV's pixels;
- `resize_area_cv2` equals `cv2.resize(INTER_AREA)` at ratios 2, 3 and 4
  and at the non-integer ratios of real frames; `erode_cv2` equals
  `cv2.erode`.
"""
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from nsff_pl_tpu_torch.scene import imageio, jpeg

SIZES = [(1, 1), (2, 1), (3, 2), (17, 9), (37, 29), (64, 48)]
QUALITIES = (50, 75, 95, 100)
SAMPLING = {"444": 0, "422": 1, "420": 2, "440": None}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _content(h, w, seed):
    """Structured content with noise: smooth areas, edges and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 5.0 + y / 9.0),
                    128 + 90 * np.cos(x / 3.0),
                    128 + 80 * np.sin(y / 2.0)], -1)
    img = img + rng.normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, params=()):
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), list(params))
    assert ok
    return enc.tobytes()


def _check_decode(data, tmp_path):
    """decode_jpeg / read_image against PIL, imread_color against cv2."""
    ref = Image.open(io.BytesIO(data))
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, np.asarray(ref))
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    img = imageio.read_image(str(path))
    np.testing.assert_array_equal(imageio.to_rgb(img),
                                  np.asarray(ref.convert("RGB")))
    np.testing.assert_array_equal(imageio.to_l(img),
                                  np.asarray(ref.convert("L")))
    np.testing.assert_array_equal(
        imageio.imread_color(str(path)),
        cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_colour(size, sampling, tmp_path):
    w, h = size
    img = _content(h, w, w * 7 + h)
    for q in QUALITIES:
        if SAMPLING[sampling] is None:  # 4:4:0: only OpenCV writes it
            data = _cv2_jpeg(img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
        else:
            data = _pil_jpeg(img, quality=q, subsampling=SAMPLING[sampling])
        _check_decode(data, tmp_path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_grey(size, tmp_path):
    w, h = size
    img = _content(h, w, w + h)[..., 1]
    for q in QUALITIES:
        data = _pil_jpeg(img, quality=q)
        assert jpeg.decode_jpeg(data).shape == (h, w)
        _check_decode(data, tmp_path)


def _restart(n):
    return lambda img: _cv2_jpeg(img, [cv2.IMWRITE_JPEG_RST_INTERVAL, n])


STREAMS = {
    "restart_1": _restart(1),
    "restart_3": _restart(3),
    "restart_7_grey": lambda img: _cv2_jpeg(
        img[..., 0], [cv2.IMWRITE_JPEG_RST_INTERVAL, 7]),
    "optimize_pil": lambda img: _pil_jpeg(img, optimize=True, quality=85),
    "optimize_cv2": lambda img: _cv2_jpeg(img, [cv2.IMWRITE_JPEG_OPTIMIZE,
                                                1]),
    # tables above 255 go out as 16-bit DQT in an SOF1 file
    "qtables_16bit": lambda img: _pil_jpeg(
        img, qtables=[list(range(200, 264)), list(range(300, 364))]),
}


@pytest.mark.parametrize("kind", list(STREAMS))
def test_decode_streams(kind, tmp_path):
    img = _content(29, 37, 3)
    data = STREAMS[kind](img)
    if kind == "qtables_16bit":
        assert b"\xff\xc1" in data
    if kind.startswith("restart"):
        assert b"\xff\xdd" in data
    _check_decode(data, tmp_path)


def _scan_data(grey_jpeg: bytes) -> bytes:
    """The entropy-coded bytes of a one-scan file (SOS to EOI)."""
    sos = grey_jpeg.index(b"\xff\xda")
    (n,) = struct.unpack(">H", grey_jpeg[sos + 2:sos + 4])
    return grey_jpeg[sos + 2 + n:grey_jpeg.rindex(b"\xff\xd9")]


def _marker(tag, body):
    return bytes([0xFF, tag]) + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_decode_non_interleaved(sampling):
    """A sequential file with one scan a component: each plane encoded by
    OpenCV as a grey file, its scan moved into a three-component file
    (grey files hold one block a unit, raster order: a non-interleaved
    scan's layout)."""
    w, h = 37, 29
    img = _content(h, w, 11)
    full = sampling == "444"
    cw, ch = (w, h) if full else (-(-w // 2), -(-h // 2))
    planes = [img[..., 0], img[:ch, :cw, 1], img[:ch, :cw, 2]]
    files = [_cv2_jpeg(np.ascontiguousarray(p), [cv2.IMWRITE_JPEG_QUALITY,
                                                 90]) for p in planes]
    head = files[0][:files[0].index(b"\xff\xc0")]  # SOI, JFIF, DQT
    samp = 0x11 if full else 0x22
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, samp, 0, 2, 0x11, 0, 3, 0x11, 0])
    dht = files[0][files[0].index(b"\xff\xc4"):files[0].index(b"\xff\xda")]
    out = [head, _marker(0xC0, sof), dht]
    for cid, f in zip((1, 2, 3), files):
        out.append(_marker(0xDA, bytes([1, cid, 0x00, 0, 63, 0])))
        out.append(_scan_data(f))
    data = b"".join(out) + b"\xff\xd9"
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_array_equal(
        got, cv2.imdecode(np.frombuffer(data, np.uint8),
                          cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path):
    """cv2.imread turns a JPEG by its EXIF orientation; PIL's open does
    not: `imread_color` follows the first, `read_image` the second."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pil_jpeg(_content(20, 30, orientation), exif=exif.tobytes())
    assert jpeg.exif_orientation(data) == orientation
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(
        imageio.imread_color(str(path)),
        cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(
        imageio.read_image(str(path)),
        np.asarray(Image.open(str(path)).convert("RGB")))
    assert imageio.read_image(str(path)).shape == (20, 30, 3)


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_matches_cv2(size, grey):
    w, h = size
    img = _content(h, w, 5 * w + h)
    if grey:
        img = np.ascontiguousarray(img[..., 2])
    for q in (75, 95):
        assert jpeg.encode_jpeg(img, q) == _cv2_jpeg(
            img, [cv2.IMWRITE_JPEG_QUALITY, q])
    # OpenCV's default quality, which is also PIL's bytes at 95
    assert jpeg.encode_jpeg(img) == _cv2_jpeg(img)
    if not grey:
        assert jpeg.encode_jpeg(img) == _pil_jpeg(img, quality=95)


def test_write_image_picks_the_format(tmp_path):
    img = _content(9, 17, 1)
    for ext in ("jpg", "jpeg", "JPG", "png"):
        path = str(tmp_path / f"x.{ext}")
        imageio.write_image(path, img)
        ref = str(tmp_path / f"ref.{ext}")
        cv2.imwrite(ref, img[..., ::-1])
        if ext == "png":
            np.testing.assert_array_equal(cv2.imread(path), cv2.imread(ref))
        else:
            assert open(path, "rb").read() == open(ref, "rb").read()
    with pytest.raises(ValueError, match="writes"):
        imageio.write_image(str(tmp_path / "x.bmp"), img)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(rows, bpp):
    """Row filters 0-4 in turn (a plain loop over bytes)."""
    out, prev = [], bytes(len(rows[0]))
    for r, row in enumerate(rows):
        f = r % 5
        enc = bytearray([f])
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            enc.append((x - pred) & 255)
        out.append(bytes(enc))
        prev = row
    return b"".join(out)


def _pack(samples, depth):
    """(h, w, ch) ints -> packed rows of big-endian samples."""
    h = samples.shape[0]
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples.reshape(h, -1)]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples.reshape(h, -1)]
    bits = ((samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1))
            & 1).reshape(h, -1).astype(np.uint8)
    return [np.packbits(r).tobytes() for r in bits]


def _png(samples, depth, ctype, plte=None, interlace=False):
    """A PNG file of (h, w, ch) samples, Adam7 when asked (each pass's
    rows filtered on their own), with every filter type."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)] if interlace
              else [(0, 0, 1, 1)])
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))

    out = imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _png_case(kind, rng, h=13, w=11):
    """(samples, depth, color type, palette) of one kind of PNG."""
    if kind.startswith("palette"):
        depth = int(kind[7:])
        n = 1 << depth
        plte = rng.integers(0, 256, (n, 3))
        return rng.integers(0, n, (h, w, 1)), depth, 3, plte
    if kind.startswith("grey"):
        depth = int(kind[4:])
        return rng.integers(0, 1 << depth, (h, w, 1)), depth, 0, None
    ch, ctype = {"rgb": (3, 2), "rgba": (4, 6), "la": (2, 4)}[
        kind.rstrip("0123456789")]
    depth = int(kind.lstrip("rgbla"))
    return rng.integers(0, 1 << depth, (h, w, ch)), depth, ctype, None


PNG_KINDS = ["palette1", "palette2", "palette4", "palette8", "grey1",
             "grey2", "grey4", "grey8", "grey16", "rgb8", "rgb16", "rgba8",
             "rgba16", "la8", "la16"]


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("kind", PNG_KINDS)
def test_png_matches_pil_and_cv2(kind, interlace, tmp_path):
    rng = np.random.default_rng(len(kind) * 31 + interlace)
    samples, depth, ctype, plte = _png_case(kind, rng)
    data = _png(samples, depth, ctype, plte, interlace)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    ref = Image.open(str(path))
    img = imageio.read_image(str(path))
    np.testing.assert_array_equal(imageio.to_rgb(img),
                                  np.asarray(ref.convert("RGB")))
    np.testing.assert_array_equal(imageio.to_l(img),
                                  np.asarray(ref.convert("L")))
    np.testing.assert_array_equal(
        imageio.imread_color(str(path)),
        cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
    if ctype == 0:
        np.testing.assert_array_equal(
            imageio.imread_anydepth(str(path)),
            cv2.imread(str(path), cv2.IMREAD_ANYDEPTH))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pil_palette_files(bits, tmp_path):
    """PIL's own palette files (`bits=`), fewer colours than indices."""
    img = _content(12, 10, bits)
    pal = Image.fromarray(img).quantize(1 << bits)
    path = str(tmp_path / "p.png")
    pal.save(path, bits=bits)
    ref = Image.open(path)
    np.testing.assert_array_equal(imageio.to_rgb(imageio.read_image(path)),
                                  np.asarray(ref.convert("RGB")))
    np.testing.assert_array_equal(imageio.to_l(imageio.read_image(path)),
                                  np.asarray(ref.convert("L")))
    np.testing.assert_array_equal(imageio.imread_color(path),
                                  cv2.imread(path)[..., ::-1])


# ---------------------------------------------------------------------------
# resize and erode
# ---------------------------------------------------------------------------

RESIZES = {"ratio2": ((160, 90), (80, 45)), "ratio3": ((99, 63), (33, 21)),
           "ratio4": ((64, 48), (16, 12)),
           "1536x864_to_1024x576": ((1536, 864), (1024, 576)),
           "1920x1080_to_1280x720": ((1920, 1080), (1280, 720)),
           "1000x700_to_997x411": ((1000, 700), (997, 411)),
           "mixed_2x3": ((64, 63), (32, 21))}


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_area_matches_cv2(case):
    (sw, sh), size = RESIZES[case]
    rng = np.random.default_rng(sw)
    for img in (rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8),
                _content(sh, sw, sh), _content(sh, sw, 1)[..., 0]):
        np.testing.assert_array_equal(
            imageio.resize_area_cv2(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("k", [15, 4])
def test_erode_matches_cv2(k):
    rng = np.random.default_rng(k)
    mask = ((rng.random((40, 57)) > 0.05) * 255).astype(np.uint8)
    mask[:3] = 0
    np.testing.assert_array_equal(
        imageio.erode_cv2(mask, k),
        cv2.erode(mask, np.ones((k, k), np.uint8)))
