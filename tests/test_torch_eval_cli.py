"""The port's eval CLI (`nsff_pl_tpu_torch/apps/evaluate.py`, on the CPU)
against the JAX package's (`nsff_pl_tpu/apps/evaluate.py`) on one
synthetic scene (`tests/helpers_scene.py`, 32x24, 3 frames, S=8,
encode_t, chunk 512: two equal chunks a frame) with one set of params
(the JAX initializer with the colour and flow heads scaled up, so frames
and flows are not flat), saved as an orbax checkpoint for the JAX CLI and
converted (`params_from_jax`) into a port checkpoint. Torch runs on one
thread.

For the splits `test` (with `--save_depth`), `test_spiral`,
`test_fixview1_interp2` and `test_spiral --fix_view_dir`:
- the same file names;
- the frame PNGs decoded equal, but for at most 0.1% of a split's pixel
  channels one level off (float32 sums in another order move a value
  across a 1/255 step now and then; measured 0);
- the depth PNGs: at most 1% of a split's pixels one colormap entry off
  (each map is min-max normalised before its 256 colours, which magnifies
  a depth difference by the inverse of the frame's depth range; measured
  11 of 2304 pixels);
- the psnr / ssim tables within 1e-4, the LPIPS table all "n/a" (NaN)
  without a weights file;
- the GIF videos: the same frame count and size, decoded with PIL.
"""
import io
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.helpers_scene import make_synthetic_scene

W, H, N = 32, 24, 3
TABLE_TOL = 1e-4
PNG_SHARE = 1e-3
DEPTH_SHARE = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from nsff_pl_tpu.config import NSFFConfig
    from nsff_pl_tpu.training import checkpoint as jckpt
    from nsff_pl_tpu.training.trainer import build_params
    from nsff_pl_tpu_torch.training import checkpoint as tckpt

    tmp = tmp_path_factory.mktemp("evalcli")
    scene = make_synthetic_scene(str(tmp / "scene"), W=W, H=H, N=N,
                                 learnable=True)
    cfg = NSFFConfig(root_dir=scene, img_wh=(W, H), start_end=(0, N),
                     N_samples=8, encode_t=True, N_tau=8)
    params = jax.tree.map(np.asarray,
                          build_params(cfg, jax.random.PRNGKey(5)))
    fine = params["nerf_fine"]
    for name, scale in (("static_rgb", 6.0), ("transient_rgb", 6.0),
                        ("transient_flow_fw", 30.0),
                        ("transient_flow_bw", 30.0)):
        fine[name] = {k: v * scale for k, v in fine[name].items()}
    jax_ckpt = jckpt.save_checkpoint(str(tmp / "jax_ckpt"), 0,
                                     {"params": params})
    torch_ckpt = tckpt.save_checkpoint(
        str(tmp / "torch_ckpt"), 0,
        {"params": tckpt.params_from_jax(params, "cpu")})
    return str(tmp), scene, jax_ckpt, torch_ckpt


SPLITS = {"test": ("test", ("--save_depth",)),
          "spiral": ("test_spiral", ()),
          "interp": ("test_fixview1_interp2", ()),
          "fix_view_dir": ("test_spiral", ("--fix_view_dir",))}


def _argv(scene, ckpt, split, name, extra):
    return ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh", str(W),
            str(H), "--start_end", "0", str(N), "--N_samples", "8",
            "--encode_t", "--N_tau", "8", "--split", split, "--scene_name",
            name, "--video_format", "gif", "--chunk", "512", *extra]


def _run(cwd, fn):
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        fn()
    finally:
        os.chdir(here)


def _levels(path):
    """A PNG's levels: the channel values of a frame, the colormap index
    of each pixel of a depth map."""
    from nsff_pl_tpu_torch.utils.visualization import JET

    img = np.asarray(Image.open(path), np.int16)
    if os.path.basename(path).startswith("depth"):
        dist = np.abs(img[..., None, :] - JET.astype(np.int16)).sum(-1)
        img = dist.argmin(-1)
    return img


def _frames(path):
    im = Image.open(path)
    return im.n_frames, im.size


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_eval_cli_matches_jax(setup, case, capsys):
    from nsff_pl_tpu.apps import evaluate as jeval
    from nsff_pl_tpu_torch.apps import evaluate as teval

    tmp, scene, jax_ckpt, torch_ckpt = setup
    split, extra = SPLITS[case]
    jdir, tdir = os.path.join(tmp, "jax"), os.path.join(tmp, "torch")
    _run(jdir, lambda: jeval.main(jeval.get_opts(
        _argv(scene, jax_ckpt, split, case, extra))))
    capsys.readouterr()
    _run(tdir, lambda: teval.cli(_argv(scene, torch_ckpt, split, case,
                                       extra), device="cpu"))
    out = capsys.readouterr().out
    jout = os.path.join(jdir, "results", "monocular", case)
    tout = os.path.join(tdir, "results", "monocular", case)
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    pngs = [f for f in names if f.endswith(".png")]
    assert pngs
    off = {False: [0, 0], True: [0, 0]}  # frames, depth maps
    for f in pngs:
        a, b = (_levels(os.path.join(d, f)) for d in (jout, tout))
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1, f
        tally = off[f.startswith("depth")]
        tally[0] += int((a != b).sum())
        tally[1] += a.size
    assert off[False][0] <= PNG_SHARE * off[False][1], off
    assert off[True][0] <= DEPTH_SHARE * off[True][1], off
    for f in names:
        if f.endswith(".gif"):
            assert _frames(os.path.join(tout, f)) \
                == _frames(os.path.join(jout, f)), f
    if split == "test":
        for table in ("psnr.npy", "ssim.npy"):
            np.testing.assert_allclose(np.load(os.path.join(tout, table)),
                                       np.load(os.path.join(jout, table)),
                                       atol=TABLE_TOL, rtol=0)
        assert np.isnan(np.load(os.path.join(tout, "lpips.npy"))).all()
        assert "LPIPS unavailable" in out and "n/a" in out
    if case == "fix_view_dir":
        assert "fix_view_dir" in out
    with open(os.path.join(tout, f"{case}.gif"), "rb") as fh:
        n_frames, size = _frames(io.BytesIO(fh.read()))
    assert size == (W, H) and n_frames == len(
        [f for f in pngs if not f.startswith("depth")])


def test_gif_writer_round_trips():
    """`scene/imageio.py::gif_bytes`: PIL decodes every frame to the 3-3-2
    palette colour of each pixel, exactly, across many clear codes (a
    288x512 frame holds ~590 runs of 250 literal codes)."""
    from nsff_pl_tpu_torch.scene.imageio import _GIF_PALETTE, gif_bytes

    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (288, 512, 3)).astype(np.uint8)
              for _ in range(3)]
    im = Image.open(io.BytesIO(gif_bytes(frames, fps=10)))
    assert im.n_frames == 3 and im.size == (512, 288)
    for k, f in enumerate(frames):
        im.seek(k)
        idx = ((f[..., 0] >> 5) << 5) | ((f[..., 1] >> 5) << 2) \
            | (f[..., 2] >> 6)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                      _GIF_PALETTE[idx])
