"""The port's preprocess driver and motion masks
(`nsff_pl_tpu_torch/apps/preprocess.py`, `scene/masks.py`) and its scene
loader on JPEG frames, against the JAX package's (which run OpenCV and
PIL here).

Tolerances:
- `get_opts`: every flag, default, type and choice the same;
- `resize_frames` (160x90 -> 80x45, a ratio of 2, and 150x100 ->
  99x66, a non-integer one; PNG and JPEG frames): the same file names,
  the same JPEG bytes, the same PNG pixels; a second run skips;
- `trivial_masks`: the same names and pixels; the stages without their
  tools exit with the JAX package's messages;
- `MonocularScene` on a synthetic scene whose frames are q95 JPEG files
  (`tests/helpers_scene.py::make_synthetic_scene`, re-saved in a copy):
  the image-derived channels of the train table (rgb, t, disparity,
  mask) and of a test item's rgb equal the JAX scene's bit for bit; rays
  1e-5 and flow targets 1e-4 abs, as `tests/test_torch_scene.py` holds
  them (XLA's multiply-add, ROADMAP C, not the frames).
"""
import glob
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from nsff_pl_tpu.apps import preprocess as jpre
from nsff_pl_tpu.scene import MonocularScene as JScene
from nsff_pl_tpu.scene import masks as jmasks
from nsff_pl_tpu_torch.apps import preprocess as tpre
from nsff_pl_tpu_torch.scene import MonocularScene as TScene
from nsff_pl_tpu_torch.scene import imageio, jpeg
from nsff_pl_tpu_torch.scene import masks as tmasks
from tests.helpers_scene import make_synthetic_scene

RAYS_TOL, FLOW_TOL = 1e-5, 1e-4


def _actions(mod):
    parser = None
    orig = mod.argparse.ArgumentParser.parse_args

    def grab(self, argv=None, namespace=None):
        nonlocal parser
        parser = self
        return orig(self, argv, namespace)

    mod.argparse.ArgumentParser.parse_args = grab
    try:
        mod.get_opts(["--root_dir", "x"])
    finally:
        mod.argparse.ArgumentParser.parse_args = orig
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices or ()), a.nargs, a.required)
            for a in parser._actions}


def test_get_opts_match_jax():
    assert _actions(tpre) == _actions(jpre)
    argv = ["--root_dir", "r", "--max_w", "640", "--max_h", "360",
            "--stages", "resize", "colmap"]
    assert vars(tpre.get_opts(argv)) == vars(jpre.get_opts(argv))


def _frames(root, ext, size, n=3):
    os.makedirs(os.path.join(root, "frames"))
    w, h = size
    rng = np.random.default_rng(w)
    y, x = np.mgrid[0:h, 0:w]
    for i in range(n):
        img = np.stack([(x * 3 + i * 20) % 256, (y * 5) % 256,
                        (x + y) % 256], -1).astype(np.float64)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, "frames", f"{i:03d}.{ext}"),
            **({"quality": 95} if ext == "jpg" else {}))


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("case", [((160, 90), (80, 45)),
                                  ((150, 100), (100, 66))],
                         ids=["ratio2", "non_integer"])
def test_resize_frames_match_jax(case, ext, tmp_path, capsys):
    size, (max_w, max_h) = case
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for root in roots.values():
        _frames(root, ext, size)
    jpre.resize_frames(roots["jax"], max_w, max_h)
    tpre.resize_frames(roots["torch"], max_w, max_h)
    names = {k: sorted(os.listdir(os.path.join(r, "frames_resized")))
             for k, r in roots.items()}
    assert names["jax"] == names["torch"] and len(names["jax"]) == 3
    for name in names["jax"]:
        j, t = (os.path.join(r, "frames_resized", name)
                for r in roots.values())
        if ext == "jpg":
            assert open(t, "rb").read() == open(j, "rb").read()
        else:
            np.testing.assert_array_equal(imageio.read_image(t),
                                          imageio.read_image(j))
        assert imageio.read_image(t).shape[:2] == (
            int(size[1] * min(max_w / size[0], max_h / size[1])),
            int(size[0] * min(max_w / size[0], max_h / size[1])))
    capsys.readouterr()
    tpre.main(tpre.get_opts(["--root_dir", roots["torch"], "--stages",
                             "resize"]))
    assert "frames_resized exists, skipping" in capsys.readouterr().out


def test_resize_frames_never_enlarge(tmp_path):
    root = str(tmp_path / "s")
    _frames(root, "jpg", (40, 30), n=1)
    tpre.resize_frames(root, 1280, 720)
    src = os.path.join(root, "frames", "000.jpg")
    out = os.path.join(root, "frames_resized", "000.jpg")
    # read and written again: the bytes cv2 writes for the decoded frame
    assert open(out, "rb").read() == jpeg.encode_jpeg(
        imageio.imread_color(src))
    with pytest.raises(SystemExit, match="no frames found"):
        tpre.resize_frames(str(tmp_path / "empty"), 10, 10)


def test_masks_match_jax(tmp_path, capsys):
    roots = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for root in roots.values():
        _frames(root, "jpg", (37, 29), n=2)
        shutil.copytree(os.path.join(root, "frames"),
                        os.path.join(root, "images"))
    assert jmasks.trivial_masks(roots["jax"]) == 2
    assert tmasks.trivial_masks(roots["torch"]) == 2
    names = sorted(os.listdir(os.path.join(roots["jax"], "masks")))
    assert names == sorted(os.listdir(os.path.join(roots["torch"], "masks")))
    assert names == ["000.jpg.png", "001.jpg.png"]
    for name in names:
        np.testing.assert_array_equal(
            imageio.read_image(os.path.join(roots["torch"], "masks", name)),
            imageio.read_image(os.path.join(roots["jax"], "masks", name)))
    assert (tmasks.DYNAMIC_CATEGORIES, tmasks.SCORE_THRESHOLD,
            tmasks.ERODE_KERNEL) == (jmasks.DYNAMIC_CATEGORIES,
                                     jmasks.SCORE_THRESHOLD,
                                     jmasks.ERODE_KERNEL)
    with pytest.raises(RuntimeError, match="detectron2") as t_err:
        tmasks.predict_masks(roots["torch"])
    with pytest.raises(RuntimeError, match="detectron2") as j_err:
        jmasks.predict_masks(roots["jax"])
    assert str(t_err.value) == str(j_err.value)
    # the masks stage: the temporary images/ copy goes again
    root = str(tmp_path / "stage")
    _frames(root, "jpg", (20, 10), n=1)
    tpre.resize_frames(root)
    with pytest.raises(RuntimeError, match="detectron2"):
        tpre.main(tpre.get_opts(["--root_dir", root, "--stages", "masks"]))
    assert not os.path.exists(os.path.join(root, "images"))


@pytest.mark.parametrize("stage", ["colmap", "depth", "flow"])
def test_stages_without_tools_exit_as_jax(stage, tmp_path):
    root = str(tmp_path)
    argv = ["--root_dir", root, "--stages", stage, "--colmap_bin",
            "no-such-colmap", "--dpt_root", str(tmp_path / "no_dpt"),
            "--raft_root", str(tmp_path / "no_raft")]
    with pytest.raises(SystemExit) as t_exit:
        tpre.main(tpre.get_opts(argv))
    with pytest.raises(SystemExit) as j_exit:
        jpre.main(jpre.get_opts(argv))
    assert str(t_exit.value.code) == str(j_exit.value.code)
    assert {"colmap": "COLMAP binary", "depth": "DPT checkout",
            "flow": "RAFT checkout"}[stage] in str(t_exit.value.code)


@pytest.fixture(scope="module")
def jpeg_scene(tmp_path_factory):
    """The synthetic scene with its frames re-saved as q95 JPEG files."""
    root = str(tmp_path_factory.mktemp("jpeg_scene"))
    make_synthetic_scene(root, W=48, H=36, N=4, learnable=True)
    for path in sorted(glob.glob(os.path.join(root, "images", "*.png"))):
        Image.open(path).save(path[:-4] + ".jpg", quality=95)
        os.remove(path)
    return root


@pytest.mark.parametrize("wh", [(48, 36), (32, 24)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_scene_on_jpeg_frames_matches_jax(jpeg_scene, wh, tmp_path):
    kw = dict(img_wh=wh, start_end=(0, 4))
    j = JScene(jpeg_scene, "train", **kw)
    t = TScene(jpeg_scene, "train", device="cpu", **kw)
    assert all(p.endswith(".jpg") for p in t.image_paths)
    jr, tr = np.asarray(j.rays), t.rays.numpy()
    assert tr.shape == jr.shape == (4, wh[0] * wh[1], 16)
    np.testing.assert_array_equal(tr[..., 6:12], jr[..., 6:12])
    assert np.abs(tr[..., 0:6] - jr[..., 0:6]).max() <= RAYS_TOL
    assert np.abs(tr[..., 12:16] - jr[..., 12:16]).max() <= FLOW_TOL
    cached = TScene(jpeg_scene, "train", device="cpu",
                    cache_dir=str(tmp_path), **kw)
    again = TScene(jpeg_scene, "train", device="cpu",
                   cache_dir=str(tmp_path), **kw)
    np.testing.assert_array_equal(cached.rays.numpy(), tr)
    np.testing.assert_array_equal(again.rays.numpy(), tr)
    j = JScene(jpeg_scene, "test", **kw)
    t = TScene(jpeg_scene, "test", device="cpu", **kw)
    ji, ti = j.test_item(1), t.test_item(1)
    assert set(ji) == set(ti)
    np.testing.assert_array_equal(ti["rgbs"].numpy(), ji["rgbs"])
    np.testing.assert_array_equal(ti["ts"].numpy(), ji["ts"])
    assert np.abs(ti["rays"].numpy() - ji["rays"]).max() <= RAYS_TOL
