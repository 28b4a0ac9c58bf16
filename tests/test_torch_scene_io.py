"""The port's scene I/O on numpy and the standard library
(`nsff_pl_tpu_torch/scene/imageio.py`, `colmap.py`, `flowio.py`,
`depthio.py`, `poses.py`) against PIL, OpenCV and the JAX package's
modules, which this container has.

Tolerances:
- PNG decode: bit-equal to PIL's and OpenCV's reads of files they wrote
  (RGB, grey, 16-bit grey) and of the port's own files, at widths 1, 7
  and 33 on random and structured content; the port's files use every
  row filter, and the files read here hold filters 0-4 between them. The
  port's PNGs read back equal through PIL and OpenCV.
- NEAREST (PIL's for masks, OpenCV's for disparities) and LANCZOS (PIL,
  8-bit RGB and grey): bit-equal, 64x48 -> 32x24, 40x30 and 100x75 (and
  1024x576 -> 512x288 for LANCZOS, the card's scene).
- INTER_LINEAR on float flows: 1e-5 of the largest magnitude; `resize_flow`
  also rescales the components.
- COLMAP, `.flo`, PFM, poses: against the JAX modules, equal (the same
  numpy code; poses 1e-12).
"""
import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from nsff_pl_tpu.scene import colmap as jcolmap
from nsff_pl_tpu.scene import depthio as jdepthio
from nsff_pl_tpu.scene import flowio as jflowio
from nsff_pl_tpu.scene import poses as jposes
from nsff_pl_tpu_torch.scene import colmap, depthio, flowio, imageio, poses

SIZES = [(32, 24), (40, 30), (100, 75)]
WIDTHS = (1, 7, 33)


def _filters(data: bytes):
    """The row filter types of a PNG file."""
    hdr, idat = None, b""
    for tag, body in imageio._png_chunks(data):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    w, h, depth, ctype = hdr[:4]
    stride = (w * imageio._CHANNELS[ctype] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


def _content(kind, h, w, rng):
    if kind == "rgb":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "smooth":  # filters other than None win on such rows
        y, x = np.mgrid[0:h, 0:w]
        return np.stack([(7 * x + 3 * y) % 256, (x * x + y) % 256,
                         (5 * y) % 256], -1).astype(np.uint8)
    if kind == "l":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    return rng.integers(0, 65536, (h, w), dtype=np.uint16)


@pytest.mark.parametrize("w", WIDTHS)
def test_png_decode_matches_pil_and_cv2(w):
    rng = np.random.default_rng(w)
    seen = set()
    for kind in ("rgb", "smooth", "l", "l16"):
        for h in (1, 5, 17):
            a = _content(kind, h, w, rng)
            files = []
            if kind != "l16":
                buf = io.BytesIO()
                Image.fromarray(a).save(buf, format="PNG")
                files.append(buf.getvalue())
            ok, enc = cv2.imencode(".png", a[..., ::-1] if a.ndim == 3
                                   else a)
            files.append(enc.tobytes())
            files.append(imageio.png_bytes(a, filters=[0, 1, 2, 3, 4]))
            for data in files:
                seen |= _filters(data)
                np.testing.assert_array_equal(imageio.decode_png(data), a)
            own = files[-1]
            via_pil = np.asarray(Image.open(io.BytesIO(own)))
            np.testing.assert_array_equal(via_pil.astype(a.dtype), a)
            flags = cv2.IMREAD_ANYDEPTH | (cv2.IMREAD_COLOR if a.ndim == 3
                                           else 0)
            via_cv2 = cv2.imdecode(np.frombuffer(own, np.uint8), flags)
            np.testing.assert_array_equal(
                via_cv2[..., ::-1] if a.ndim == 3 else via_cv2, a)
    assert seen == {0, 1, 2, 3, 4}


def test_png_other_modes_and_conversions(tmp_path):
    """1-bit, grey + alpha and RGBA files through PIL's convert("RGB") /
    convert("L") and OpenCV's ANYDEPTH read; 16-bit grey clips at 255
    under PIL's conversions."""
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    la = rng.integers(0, 256, (9, 13, 2), dtype=np.uint8)
    bits = rng.random((9, 13)) > 0.5
    l16 = rng.integers(0, 65536, (9, 13), dtype=np.uint16)
    l16[0, :4] = [0, 1, 255, 256]
    for name, pil in (("rgba", Image.fromarray(rgba, "RGBA")),
                      ("la", Image.fromarray(la, "LA")),
                      ("bits", Image.fromarray(bits)),
                      ("rgb", Image.fromarray(rgba[..., :3]))):
        path = str(tmp_path / f"{name}.png")
        pil.save(path)
        img = imageio.read_png(path)
        ref = Image.open(path)
        np.testing.assert_array_equal(imageio.to_rgb(img),
                                      np.asarray(ref.convert("RGB")))
        np.testing.assert_array_equal(imageio.to_l(img),
                                      np.asarray(ref.convert("L")))
    path = str(tmp_path / "bits.png")
    np.testing.assert_array_equal(imageio.imread_anydepth(path),
                                  cv2.imread(path, cv2.IMREAD_ANYDEPTH))
    path = str(tmp_path / "l16.png")
    cv2.imwrite(path, l16)
    np.testing.assert_array_equal(imageio.imread_anydepth(path),
                                  cv2.imread(path, cv2.IMREAD_ANYDEPTH))
    ref = Image.open(path)
    np.testing.assert_array_equal(imageio.to_l(imageio.read_png(path)),
                                  np.asarray(ref.convert("L")))
    np.testing.assert_array_equal(imageio.to_rgb(imageio.read_png(path)),
                                  np.asarray(ref.convert("RGB")))


def test_unreadable_files_raise(tmp_path):
    """The port raises exactly where PIL (and, for `imread_color`,
    OpenCV) raises: a 12-bit JPEG file (the progressive, CMYK and
    arithmetic-coded files this test once saw raise now decode, held to
    PIL in tests/test_torch_jpeg_modes.py::test_moved_cases). A file that
    is neither PNG nor JPEG, and truncated PNG or JPEG data, raise too; no
    reader falls back to another."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    base = io.BytesIO()
    Image.fromarray(a).save(base, format="JPEG")
    base = base.getvalue()
    sof = base.index(b"\xff\xc0")
    data = base[:sof + 4] + b"\x0c" + base[sof + 5:]  # 12-bit
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(NotImplementedError, match="12-bit"):
        imageio.decode_image(data)
    (tmp_path / "12-bit.jpg").write_bytes(data)
    with pytest.raises(NotImplementedError, match="12-bit"):
        imageio.read_image(str(tmp_path / "12-bit.jpg"))
    with pytest.raises(NotImplementedError, match="12-bit"):
        imageio.imread_color(str(tmp_path / "12-bit.jpg"))
    with pytest.raises(ValueError):
        imageio.decode_image(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError):
        imageio.decode_png(base)
    good = imageio.png_bytes(a)
    with pytest.raises(Exception):
        imageio.decode_png(good[:-30])
    for cut in (2, 30, len(base) // 2):
        with pytest.raises(ValueError):
            imageio.decode_image(base[:-cut])
    (tmp_path / "x.png").write_bytes(base[:-30])
    with pytest.raises(ValueError):
        imageio.imread_anydepth(str(tmp_path / "x.png"))
    # a colour file is no disparity map
    (tmp_path / "rgb.png").write_bytes(good)
    with pytest.raises(ValueError, match="colour"):
        imageio.imread_anydepth(str(tmp_path / "rgb.png"))


@pytest.mark.parametrize("size", SIZES + [(512, 288)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_lanczos_matches_pil(size):
    rng = np.random.default_rng(size[0])
    src = (1024, 576) if size == (512, 288) else (64, 48)
    for a in (rng.integers(0, 256, (src[1], src[0], 3), dtype=np.uint8),
              _content("smooth", src[1], src[0], rng),
              rng.integers(0, 256, (src[1], src[0]), dtype=np.uint8)):
        want = np.asarray(Image.fromarray(a).resize(size, Image.LANCZOS))
        np.testing.assert_array_equal(imageio.resize_lanczos(a, size), want)
    same = imageio.resize_lanczos(a, src)
    np.testing.assert_array_equal(same, a)
    assert same is not a


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_nearest_rules_match_pil_and_cv2(size):
    rng = np.random.default_rng(size[1])
    mask = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    want = np.asarray(Image.fromarray(mask).resize(size, Image.NEAREST))
    np.testing.assert_array_equal(imageio.resize_nearest_pil(mask, size),
                                  want)
    disp = rng.normal(0, 3, (48, 64)).astype(np.float32)
    want = cv2.resize(disp, size, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(imageio.resize_nearest_cv2(disp, size),
                                  want)


@pytest.mark.parametrize("size", SIZES + [(512, 288)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_linear_flow_resize_matches_cv2(size):
    rng = np.random.default_rng(size[0] + 1)
    src = (1024, 576) if size == (512, 288) else (64, 48)
    flow = rng.normal(0, 3, (src[1], src[0], 2)).astype(np.float32)
    want = cv2.resize(flow, size, interpolation=cv2.INTER_LINEAR)
    got = imageio.resize_linear_cv2(flow, size)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    want = jflowio.resize_flow(flow, *size)
    got = flowio.resize_flow(flow, *size)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert flowio.resize_flow(flow, *src) is flow


def test_colmap_flo_pfm_and_poses_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    cams = {1: colmap.Camera(1, "SIMPLE_RADIAL", 64, 48,
                             np.array([57.6, 32.0, 24.0, 0.0]))}
    images = {i + 1: colmap.Image(
        i + 1, poses.rotmat2qvec(np.eye(3)), rng.normal(size=3), 1,
        f"{i:05d}.png", rng.normal(size=(3, 2)), np.arange(3) + 5 * i)
        for i in range(3)}
    pts = {j: colmap.Point3D(j, rng.normal(size=3),
                             np.array([1, 2, 3], np.uint8), 0.5,
                             np.arange(1, 4), np.arange(3))
           for j in range(1, 6)}
    colmap.write_model(cams, images, pts, str(tmp_path / "m"))
    jm = jcolmap.read_model(str(tmp_path / "m"))
    tm = colmap.read_model(str(tmp_path / "m"))
    for jd, td in zip(jm, tm):
        assert set(jd) == set(td)
        for k in jd:
            for f in jd[k].__dataclass_fields__:
                a, b = getattr(jd[k], f), getattr(td[k], f)
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b
    np.testing.assert_array_equal(images[2].qvec2rotmat(),
                                  jm[1][2].qvec2rotmat())

    flow = rng.normal(size=(6, 5, 2)).astype(np.float32)
    flowio.write_flow(flow, str(tmp_path / "a.flo"))
    np.testing.assert_array_equal(jflowio.read_flow(str(tmp_path / "a.flo")),
                                  flow)
    np.testing.assert_array_equal(flowio.read_flow(str(tmp_path / "a.flo")),
                                  flow)
    np.testing.assert_array_equal(flowio.flow_to_image(flow),
                                  jflowio.flow_to_image(flow))

    depth = rng.normal(size=(6, 5)).astype(np.float32)
    depthio.save_pfm(str(tmp_path / "d.pfm"), depth)
    for mod in (depthio, jdepthio):
        data, scale = mod.read_pfm(str(tmp_path / "d.pfm"))
        np.testing.assert_array_equal(data, depth)
        assert scale == 1.0

    R = jposes.qvec2rotmat(poses.normalize(rng.normal(size=4)))
    np.testing.assert_allclose(poses.rotmat2qvec(R), jposes.rotmat2qvec(R),
                               atol=1e-12)
    traj = np.concatenate([np.tile(np.eye(3), (6, 1, 1)),
                           rng.normal(size=(6, 3, 1))], -1)
    for fn, args in ((poses.center_poses, (traj,)),
                     (poses.create_spiral_poses,
                      (traj, np.array([0.1, 0.1, 0.0]), 12)),
                     (poses.create_wander_path, (traj[0], 0.2, 9))):
        jfn = getattr(jposes, fn.__name__)
        np.testing.assert_allclose(fn(*args), jfn(*args), atol=1e-12)
