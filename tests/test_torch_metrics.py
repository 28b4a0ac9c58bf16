"""The port's metrics (`nsff_pl_tpu_torch/training/metrics.py`) and
visualization helpers (`nsff_pl_tpu_torch/utils/visualization.py`)
against the JAX package's on the same numpy inputs.

Tolerances:
- psnr: 1e-4 dB (with and without a `valid_mask`);
- ssim: 1e-5, the mean and `reduction="none"` (per pixel and channel),
  with a `valid_mask`, and on smooth bright content where E[x^2] - mu^2
  cancels (the mean-centred variance of the JAX package, pinned in
  tests/test_metrics_optim.py);
- visualization: bit for bit (the colormap tables against OpenCV's
  `applyColorMap`, `blend_images` against `cv2.addWeighted`).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.training import metrics as jm
from nsff_pl_tpu.utils import visualization as jviz
from nsff_pl_tpu_torch.training import metrics as tm
from nsff_pl_tpu_torch.utils import visualization as tviz

PSNR_TOL, SSIM_TOL = 1e-4, 1e-5


def _pair(kind, rng, h=24, w=32):
    if kind == "noise":
        a = rng.rand(h, w, 3)
        b = np.clip(a + 0.1 * rng.randn(h, w, 3), 0, 1)
    else:  # smooth bright content with micro-texture
        a = 0.9 + 1e-3 * rng.randn(h, w, 3)
        b = a + 2e-2 * rng.randn(h, w, 3)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "smooth_bright"])
def test_psnr_and_ssim_match_jax(kind):
    rng = np.random.RandomState(0 if kind == "noise" else 7)
    a, b = _pair(kind, rng)
    mask = rng.rand(24, 32) > 0.5
    ja, jb, jmask = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    ta, tb, tmask = (torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(mask))
    assert abs(float(tm.psnr(ta, tb)) - float(jm.psnr(ja, jb))) <= PSNR_TOL
    assert abs(float(tm.psnr(ta, tb, tmask))
               - float(jm.psnr(ja, jb, jmask))) <= PSNR_TOL
    assert abs(float(tm.ssim(ta, tb)) - float(jm.ssim(ja, jb))) <= SSIM_TOL
    np.testing.assert_allclose(
        tm.ssim(ta, tb, reduction="none").numpy(),
        np.asarray(jm.ssim(ja, jb, reduction="none")), atol=SSIM_TOL)
    np.testing.assert_allclose(
        tm.ssim(ta, tb, tmask, reduction="none").numpy(),
        np.asarray(jm.ssim(ja, jb, jmask, reduction="none")),
        atol=SSIM_TOL)
    assert abs(float(tm.ssim(ta, tb, tmask))
               - float(jm.ssim(ja, jb, jmask))) <= SSIM_TOL
    np.testing.assert_allclose(tm.ssim_map(ta, tb).numpy(),
                               np.asarray(jm.ssim_map(ja, jb)),
                               atol=2 * SSIM_TOL)
    assert abs(float(tm.ssim(ta, ta)) - 1.0) <= SSIM_TOL


def test_colormaps_match_cv2():
    x = np.arange(256, dtype=np.uint8)[:, None]
    for table, cmap in ((tviz.JET, cv2.COLORMAP_JET),
                        (tviz.BONE, cv2.COLORMAP_BONE)):
        np.testing.assert_array_equal(
            table, cv2.applyColorMap(x, cmap)[:, 0, ::-1])


@pytest.mark.parametrize("shape", [(7, 5), (30, 40), (13, 17)])
def test_visualization_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    d = rng.normal(0, 1, shape).astype(np.float32)
    d[0, 0] = np.nan
    m = rng.uniform(-0.2, 1.2, shape)
    np.testing.assert_array_equal(tviz.visualize_depth(d),
                                  jviz.visualize_depth(d))
    np.testing.assert_array_equal(tviz.visualize_mask(m),
                                  jviz.visualize_mask(m))
    a = rng.uniform(-0.1, 1.1, shape + (3,))
    b = rng.uniform(-0.1, 1.1, shape + (3,))
    for alpha in (0.5, 0.3, 0.77):
        np.testing.assert_array_equal(tviz.blend_images(a, b, alpha),
                                      jviz.blend_images(a, b, alpha))
    imgs = [a, d, np.clip(b, 0, 1)]
    np.testing.assert_array_equal(tviz.make_grid(imgs, nrow=2),
                                  jviz.make_grid(imgs, nrow=2))
