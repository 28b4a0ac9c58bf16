"""Image quality metrics on device tensors (port of
`nsff_pl_tpu/training/metrics.py`): MSE, PSNR and SSIM.

SSIM is the reference's kornia score: a Gaussian window (11, sigma 1.5)
with reflect padding, reported as 1 - clamp((1 - ssim) / 2, 0, 1). The
separable window runs as two `conv2d` passes. Variance and covariance are
taken on globally mean-centred images (the JAX package's fix: E[x^2] -
mu^2 cancels badly on smooth bright content), with the means added back
for the luminance terms. Every metric takes a `valid_mask` for the
dynamic-region variants. LPIPS is not ported (ROADMAP.md queue A,
'LPIPS': it needs a weights file).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(image_gt, image_pred, valid_mask=None, reduction: str = "mean"):
    value = (image_gt - image_pred) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_gt, image_pred, valid_mask=None, reduction: str = "mean"):
    """-10 log10(mse)."""
    return -10 * torch.log10(mse(image_gt, image_pred, valid_mask,
                                 reduction))


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_sep(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2D filtering of (H, W, C) with reflect padding: rows
    first, then columns."""
    pad = (len(k1d) - 1) // 2
    k = torch.as_tensor(k1d, device=img.device)
    C = img.shape[-1]
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.pad(x, (0, 0, pad, pad), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(C, 1, -1, 1), groups=C)
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)
    return x[0].permute(1, 2, 0)


def ssim_map(image_gt, image_pred, window_size: int = 11,
             sigma: float = 1.5, max_val: float = 1.0):
    """Per-pixel, per-channel SSIM of (H, W, C) images."""
    k = _gaussian_kernel1d(window_size, sigma)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    cx = torch.mean(image_gt)
    cy = torch.mean(image_pred)
    xs = image_gt - cx
    ys = image_pred - cy
    mu_xs = _filter2d_sep(xs, k)
    mu_ys = _filter2d_sep(ys, k)
    mu_x = mu_xs + cx
    mu_y = mu_ys + cy
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x = _filter2d_sep(xs * xs, k) - mu_xs * mu_xs
    sigma_y = _filter2d_sep(ys * ys, k) - mu_ys * mu_ys
    sigma_xy = _filter2d_sep(xs * ys, k) - mu_xs * mu_ys
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return num / den


def ssim(image_gt, image_pred, valid_mask=None, window_size: int = 11,
         reduction: str = "mean"):
    """1 - clamp((1 - ssim) / 2, 0, 1) per pixel and channel (the mean
    over channels is the caller's)."""
    loss = torch.clamp((1.0 - ssim_map(image_gt, image_pred, window_size))
                       / 2.0, 0.0, 1.0)
    value = 1.0 - loss
    if valid_mask is not None:
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value
