"""The port's JPEG decode (`nsff_pl_tpu_torch/scene/jpeg.py`) on every
coding libjpeg-turbo reads, against PIL and OpenCV, which read these files
here. Files come from PIL and OpenCV themselves where they write the
coding, else from `tests/torch_jpeg_writer.py` (numpy alone).

Tolerances: none. Each comparison is bit for bit:
- `read_image` equals PIL's pixels (a CMYK file as PIL opens it,
  inverted), `to_rgb` / `to_l` equal PIL's `convert("RGB")` /
  `convert("L")`, `imread_color` equals `cv2.imread(IMREAD_COLOR)`, or
  raises where OpenCV gives None, and on a grey file `imread_anydepth`
  equals `cv2.imread(IMREAD_ANYDEPTH)`;
- progressive Huffman: PIL's and OpenCV's own files (colour and grey,
  with and without restart intervals), and scan scripts that leave
  coefficients uncoded or unrefined, which switch on libjpeg-turbo's
  block smoothing (each case asserts that it does);
- sampling factors: OpenCV's 4:1:1, (3, 1), (4, 1), (1, 2), (4, 2) and
  (1, 4) luma against (1, 1) chroma;
- four components: PIL's Adobe CMYK file, CMYK without an Adobe marker,
  YCCK (Adobe transform 2), progressive and arithmetic-coded;
- arithmetic coding, sequential and progressive, with restart intervals,
  DAC conditioning, grey and colour;
- lossless: predictors 1-7, point transforms, restart intervals, grey,
  RGB, 4:2:0 and CMYK;
- the progressive, CMYK and relabelled arithmetic-coded files
  tests/test_torch_scene_io.py::test_unreadable_files_raise once asserted
  to raise (`test_moved_cases`);
- files both readers refuse (hierarchical processes, arithmetic-coded
  lossless, 12-bit, 2 components, a lossless file marked YCbCr or YCCK,
  fractional sampling, an MCU of 11 blocks) raise;
- the same quantised coefficients rewritten progressive, arithmetic and
  progressive arithmetic decode to the baseline file's exact pixels;
- a 5-frame synthetic scene on progressive JPEG frames loads into the
  JAX `MonocularScene`'s ray table (rgb bit for bit; rays 1e-5, uv +
  flow 1e-4, as tests/test_torch_scene.py).
Sizes are at most 64x48.
"""
import glob
import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from nsff_pl_tpu.scene import MonocularScene as JScene
from nsff_pl_tpu_torch.scene import MonocularScene as TScene
from nsff_pl_tpu_torch.scene import imageio, jpeg
from tests import torch_jpeg_writer as jw
from tests.helpers_scene import make_synthetic_scene

RAYS_TOL, FLOW_TOL = 1e-5, 1e-4


def _content(h, w, seed, ch=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 5.0 + y / 9.0),
                    128 + 90 * np.cos(x / 3.0),
                    128 + 80 * np.sin(y / 2.0),
                    128 + 70 * np.cos((x + y) / 4.0)][:ch], -1)
    img = np.clip(img + rng.normal(0, 25, img.shape), 0, 255)
    return img.astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, params):
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), params)
    assert ok
    return enc.tobytes()


def _check(data, tmp_path):
    """The port's readers against PIL's and OpenCV's on one file."""
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    got = imageio.read_image(path)
    im = Image.open(path)
    if isinstance(got, jpeg.CMYK):
        assert im.mode == "CMYK"
        np.testing.assert_array_equal(255 - np.asarray(got), np.asarray(im))
    else:
        np.testing.assert_array_equal(got, np.asarray(im))
    np.testing.assert_array_equal(imageio.to_rgb(got),
                                  np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(imageio.to_l(got),
                                  np.asarray(im.convert("L")))
    if got.ndim == 2:  # a disparity map's read
        np.testing.assert_array_equal(imageio.imread_anydepth(path),
                                      cv2.imread(path, cv2.IMREAD_ANYDEPTH))
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(NotImplementedError):
            imageio.imread_color(path)
    else:
        np.testing.assert_array_equal(imageio.imread_color(path),
                                      want[..., ::-1])
    return got


# ---------------------------------------------------------------------------
# progressive Huffman and block smoothing
# ---------------------------------------------------------------------------

LIBRARY_FILES = {
    "pil-colour": lambda: _pil_jpeg(_content(48, 64, 1), quality=90,
                                    progressive=True),
    "pil-colour-444": lambda: _pil_jpeg(_content(29, 37, 2), quality=95,
                                        progressive=True, subsampling=0),
    "pil-grey": lambda: _pil_jpeg(_content(29, 37, 3)[..., 0],
                                  progressive=True),
    "cv2-colour": lambda: _cv2_jpeg(_content(48, 64, 4), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "cv2-colour-rst2": lambda: _cv2_jpeg(_content(48, 64, 5), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "cv2-grey-rst1": lambda: _cv2_jpeg(_content(17, 33, 6)[..., 0], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
}


@pytest.mark.parametrize("name", list(LIBRARY_FILES))
def test_library_progressive_files(name, tmp_path):
    data = LIBRARY_FILES[name]()
    assert jpeg.frame_kind(data)[0] == 0xC2
    _check(data, tmp_path)


def _all(n):
    return tuple(range(n))


# scan scripts that leave coefficients 1-9 uncoded or unrefined
SMOOTHING_SCRIPTS = {
    "bands-6-63-uncoded": lambda n: [(_all(n), 0, 0, 0, 0)] + [
        ((c,), 1, 5, 0, 0) for c in range(n)],
    "dc-only": lambda n: [(_all(n), 0, 0, 0, 0)],
    "dc-al2-only": lambda n: [(_all(n), 0, 0, 0, 2)],
    "ac-al1-unrefined": lambda n: [(_all(n), 0, 0, 0, 0)] + [
        ((c,), 1, 63, 0, 1) for c in range(n)],
    "bands-1-2-refined-dc": lambda n: [(_all(n), 0, 0, 0, 1)] + [
        ((c,), 1, 2, 0, 0) for c in range(n)] + [(_all(n), 0, 0, 1, 0)],
}


@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
@pytest.mark.parametrize("layout", ["colour-420-40x52", "grey-17x33",
                                    "colour-440-17x33"])
@pytest.mark.parametrize("script", list(SMOOTHING_SCRIPTS))
def test_block_smoothing(script, layout, coding, tmp_path):
    """Files whose progression is incomplete: libjpeg-turbo estimates the
    missing low coefficients (and with no AC coefficient at all, the DC)
    from the 5x5 DC neighbourhood (`jdcoefct.c::decompress_smooth_data`);
    odd block counts exercise its edge rows and columns."""
    h, w = (40, 52) if "40x52" in layout else (17, 33)
    img = _content(h, w, 7)
    if layout.startswith("grey"):
        frame, coefs = jw.dct_coefficients(img[..., 0], ((1, 1),))
    else:
        factors = (2, 2) if "420" in layout else (1, 2)
        frame, coefs = jw.dct_coefficients(img, (factors, (1, 1), (1, 1)))
    data = jw.write_dct(frame, coefs, progressive=True,
                        arithmetic=coding == "arithmetic",
                        scans=SMOOTHING_SCRIPTS[script](len(frame.comps)))
    assert jpeg._smoothing_ok(jpeg.read_coefficients(data).comps)
    _check(data, tmp_path)


# ---------------------------------------------------------------------------
# sampling factors, four components, arithmetic coding
# ---------------------------------------------------------------------------

SAMPLING = {
    "cv2-411": None,
    "3x1": ((3, 1), (1, 1), (1, 1)),
    "4x1": ((4, 1), (1, 1), (1, 1)),
    "1x2": ((1, 2), (1, 1), (1, 1)),
    "4x2": ((4, 2), (1, 1), (1, 1)),
    "1x4": ((1, 4), (1, 1), (1, 1)),
    "2x2-1x2-1x1": ((2, 2), (1, 2), (1, 1)),
}


@pytest.mark.parametrize("coding", ["sequential", "progressive",
                                    "arithmetic"])
@pytest.mark.parametrize("name", list(SAMPLING))
def test_sampling_factors(name, coding, tmp_path):
    """Ratios other than 2 upsample by replication (`int_upsample`)."""
    img = _content(29, 37, 8)
    if SAMPLING[name] is None:
        base = _cv2_jpeg(img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
        frame, coefs = jw.coefficients_of(base)
        assert [c[1:3] for c in frame.comps] == [(4, 1), (1, 1), (1, 1)]
        if coding == "sequential":
            _check(base, tmp_path)
            return
    else:
        frame, coefs = jw.dct_coefficients(img, SAMPLING[name])
    _check(jw.write_dct(frame, coefs, progressive=coding == "progressive",
                        arithmetic=coding == "arithmetic"), tmp_path)


FOUR = {
    "pil-cmyk": None,
    "cmyk-no-adobe": dict(adobe=None, ycc=False),
    "ycck": dict(adobe=2, ycc=True),
    "ycck-progressive": dict(adobe=2, ycc=True, progressive=True),
    "cmyk-arithmetic": dict(adobe=0, ycc=False, arithmetic=True),
    "ycck-progressive-arithmetic": dict(adobe=2, ycc=True, progressive=True,
                                        arithmetic=True),
}


@pytest.mark.parametrize("name", list(FOUR))
def test_four_components(name, tmp_path):
    """CMYK as libjpeg hands it over (`jpeg.CMYK`); PIL inverts it and
    converts by Pillow's `cmyk2rgb`, OpenCV by its own rule, and the two
    part by up to 2 on the same file."""
    img = _content(24, 40, 9, ch=4)
    kw = FOUR[name]
    if kw is None:
        buf = io.BytesIO()
        Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90)
        data = buf.getvalue()
    else:
        kw = dict(kw)
        frame, coefs = jw.dct_coefficients(img, ((2, 2), (1, 1), (1, 1),
                                                 (2, 2)), ycc=kw.pop("ycc"))
        data = jw.write_dct(frame, coefs, jfif=False, **kw)
    got = _check(data, tmp_path)
    assert isinstance(got, jpeg.CMYK) and got.shape == (24, 40, 4)
    path = str(tmp_path / "f.jpg")
    pil_rgb = np.asarray(Image.open(path).convert("RGB")).astype(int)
    cv_rgb = imageio.imread_color(path).astype(int)
    assert 0 < np.abs(pil_rgb - cv_rgb).max() <= 2
    with pytest.raises(ValueError, match="CMYK"):
        imageio.imread_anydepth(path)


ARITH = {
    "sequential": dict(),
    "sequential-grey": dict(grey=True),
    "sequential-444-rst3": dict(factors=((1, 1),) * 3, restart=3),
    "progressive": dict(progressive=True),
    "progressive-grey-rst2": dict(progressive=True, grey=True, restart=2),
    "progressive-rst5": dict(progressive=True, restart=5),
    "dac": dict(dac={("dc", 0): (1, 3), ("ac", 0): 10, ("dc", 1): (0, 0),
                     ("ac", 1): 2}),
    "progressive-dac": dict(progressive=True, dac={("dc", 0): (2, 5),
                                                   ("ac", 1): 63}),
}


@pytest.mark.parametrize("name", list(ARITH))
def test_arithmetic_coding(name, tmp_path):
    kw = dict(ARITH[name])
    img = _content(48, 64, 10)
    if kw.pop("grey", False):
        frame, coefs = jw.dct_coefficients(img[..., 0], ((1, 1),))
    else:
        frame, coefs = jw.dct_coefficients(
            img, kw.pop("factors", ((2, 2), (1, 1), (1, 1))))
    data = jw.write_dct(frame, coefs, arithmetic=True, **kw)
    assert jpeg.frame_kind(data)[0] in (0xC9, 0xCA)
    _check(data, tmp_path)


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------

LOSSLESS = {f"rgb-p{p}-pt{pt}": dict(predictor=p, pt=pt)
            for p in range(1, 8) for pt in ((0, 2) if p in (1, 6) else (0,))}
LOSSLESS.update({
    "rgb-ids-p4-rst2": dict(predictor=4, restart_rows=2, ids=[82, 71, 66]),
    "rgb-adobe0-p7": dict(predictor=7, adobe=0),
    "420-p5": dict(predictor=5, layout="420"),
    "grey-p3-rst3": dict(predictor=3, layout="grey", restart_rows=3),
    "grey-p6-pt1": dict(predictor=6, layout="grey", pt=1),
    "cmyk-p2": dict(predictor=2, layout="cmyk"),
})


@pytest.mark.parametrize("name", list(LOSSLESS))
def test_lossless(name, tmp_path):
    """Lossless files: RGB unless a marker says otherwise; subsampled
    components replicated. OpenCV's colour read of a grey lossless file
    fails (libjpeg-turbo converts no colour space of a lossless file),
    and so does `imread_color`."""
    kw = dict(LOSSLESS[name])
    layout = kw.pop("layout", "rgb")
    img = _content(24, 40, 11, ch=4)
    if layout == "grey":
        planes, factors = [img[..., 0]], [(1, 1)]
    elif layout == "420":
        planes = [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]]
        factors = [(2, 2), (1, 1), (1, 1)]
    elif layout == "cmyk":
        planes, factors = [img[..., i] for i in range(4)], [(1, 1)] * 4
    else:
        planes, factors = [img[..., i] for i in range(3)], [(1, 1)] * 3
    got = _check(jw.write_lossless(planes, factors, **kw), tmp_path)
    if layout == "rgb":
        shift = kw.get("pt", 0)
        np.testing.assert_array_equal(got, (img[..., :3] >> shift) << shift)


# ---------------------------------------------------------------------------
# files both readers refuse
# ---------------------------------------------------------------------------

def _refused():
    img = _content(24, 40, 12)
    frame, coefs = jw.dct_coefficients(img, ((2, 2), (1, 1), (1, 1)))
    planes = [img[..., i] for i in range(3)]
    out = {f"sof-{m:02x}": jw.write_dct(frame, coefs, sof=m)
           for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)}
    out["lossless-arithmetic"] = jw.write_lossless(planes, [(1, 1)] * 3,
                                                   arithmetic=True)
    out["lossless-jfif"] = jw.write_lossless(planes, [(1, 1)] * 3, jfif=True)
    out["lossless-ycck"] = jw.write_lossless(planes + planes[:1],
                                             [(1, 1)] * 4, adobe=2)
    f12 = jw.Frame(frame.width, frame.height, frame.comps, frame.qtables, 12)
    out["12-bit"] = jw.write_dct(f12, [c * 16 for c in coefs])
    f2, c2 = jw.dct_coefficients(img[..., :2], ((1, 1), (1, 1)), ycc=False)
    out["2-components"] = jw.write_dct(f2, c2)
    f32, c32 = jw.dct_coefficients(img, ((3, 1), (2, 1), (1, 1)))
    out["fractional-3x1-2x1"] = jw.write_dct(f32, c32)
    f11, c11 = jw.dct_coefficients(img, ((4, 2), (2, 1), (1, 1)))
    out["mcu-of-11-blocks"] = jw.write_dct(f11, c11)
    return out


REFUSED = _refused()


@pytest.mark.parametrize("name", list(REFUSED))
def test_files_both_readers_refuse_raise(name, tmp_path):
    data = REFUSED[name]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    path = str(tmp_path / "f.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for read in (lambda: imageio.decode_image(data),
                 lambda: imageio.read_image(path),
                 lambda: imageio.imread_color(path)):
        with pytest.raises((ValueError, NotImplementedError)) as e:
            read()
        assert "progressive JPEG" not in str(e.value)


def _moved(name):
    """The files tests/test_torch_scene_io.py::test_unreadable_files_raise
    once asserted to raise (8x8 noise, seed 4)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    if name == "progressive":
        return _pil_jpeg(a, progressive=True)
    if name == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(a).convert("CMYK").save(buf, format="JPEG")
        return buf.getvalue()
    # the baseline file relabelled arithmetic-coded: its Huffman bytes
    # decode as (meaningless) arithmetic-coded data in libjpeg-turbo too
    base = _pil_jpeg(a)
    sof = base.index(b"\xff\xc0")
    return base[:sof + 1] + b"\xc9" + base[sof + 2:]


@pytest.mark.parametrize("name", ["progressive", "cmyk", "arithmetic"])
def test_moved_cases(name, tmp_path):
    _check(_moved(name), tmp_path)


# ---------------------------------------------------------------------------
# one set of coefficients in every coding; a scene on progressive frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coding", ["progressive", "arithmetic",
                                    "progressive-arithmetic"])
def test_rewritten_coefficients_decode_to_the_baseline(coding, tmp_path):
    """A q95 frame of the port's own encoder, its coefficients rewritten
    (the check `chip_smoke.py` runs on 1024x576 frames)."""
    base = jpeg.encode_jpeg(_content(48, 64, 13))
    frame, coefs = jw.coefficients_of(base)
    data = jw.write_dct(frame, coefs, progressive="progressive" in coding,
                        arithmetic="arithmetic" in coding)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                  jpeg.decode_jpeg(base))
    _check(data, tmp_path)


def test_scene_on_progressive_frames_matches_jax(tmp_path):
    root = str(tmp_path / "scene")
    make_synthetic_scene(root, W=48, H=36, N=5, learnable=True)
    for path in sorted(glob.glob(os.path.join(root, "images", "*.png"))):
        Image.open(path).save(path[:-4] + ".jpg", quality=90,
                              progressive=True)
        os.remove(path)
    kw = dict(img_wh=(48, 36), start_end=(0, 5))
    j = JScene(root, "train", **kw)
    t = TScene(root, "train", device="cpu", **kw)
    assert all(jpeg.frame_kind(open(p, "rb").read())[0] == 0xC2
               for p in t.image_paths)
    jr, tr = np.asarray(j.rays), t.rays.numpy()
    assert tr.shape == jr.shape == (5, 48 * 36, 16)
    np.testing.assert_array_equal(tr[..., 6:12], jr[..., 6:12])
    assert np.abs(tr[..., 0:6] - jr[..., 0:6]).max() <= RAYS_TOL
    assert np.abs(tr[..., 12:16] - jr[..., 12:16]).max() <= FLOW_TOL
