"""Image quality metrics on device tensors (port of
`nsff_pl_tpu/training/metrics.py`): MSE, PSNR and SSIM.

SSIM is the reference's kornia score: a Gaussian window (11, sigma 1.5)
with reflect padding, reported as 1 - clamp((1 - ssim) / 2, 0, 1). The
separable window runs as two `conv2d` passes. Variance and covariance are
taken on globally mean-centred images (the JAX package's fix: E[x^2] -
mu^2 cancels badly on smooth bright content), with the means added back
for the luminance terms. Every metric takes a `valid_mask` for the
dynamic-region variants.

LPIPS is the AlexNet-LPIPS (spatial) of the `lpips` package, computed
with `conv2d` from a state dict of `lpips.LPIPS(net='alex')` that the
caller supplies (`load_lpips_weights`): no weights ship with the repo and
none are fetched, so without a file `get_lpips_model` returns None and
`lpips` None (the eval CLI prints "n/a").
"""
from __future__ import annotations

from typing import Optional

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


# the `lpips` package's AlexNet `features` layout (conv index, stride,
# padding, max-pool before this conv); a tap after each conv's ReLU,
# channels (64, 192, 384, 256, 256)
_ALEX_CONVS = (
    ("0", 4, 2, False),
    ("3", 1, 2, True),
    ("6", 1, 1, True),
    ("8", 1, 1, False),
    ("10", 1, 1, False),
)
_ALEX_SLICES = ("slice1", "slice2", "slice3", "slice4", "slice5")
# the package's ScalingLayer constants
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _lpips_features(params, x):
    taps = []
    for (w, b), (_, stride, pad, pool) in zip(params["convs"], _ALEX_CONVS):
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        taps.append(x)
    return taps


def _lpips_distance(params, a, b):
    """a, b: (1, 3, H, W) in [0, 1] -> (H, W) spatial LPIPS map."""
    H, W = a.shape[-2:]
    # [0, 1] -> [-1, 1], then the scaling layer
    a = (2.0 * a - 1.0 - params["shift"]) / params["scale"]
    b = (2.0 * b - 1.0 - params["shift"]) / params["scale"]
    total = a.new_zeros((H, W))
    for fa, fb, lin in zip(_lpips_features(params, a),
                           _lpips_features(params, b), params["lins"]):
        na = fa * torch.rsqrt((fa * fa).sum(1, keepdim=True) + 1e-10)
        nb = fb * torch.rsqrt((fb * fb).sum(1, keepdim=True) + 1e-10)
        m = ((na - nb) ** 2 * lin.reshape(1, -1, 1, 1)).sum(1, keepdim=True)
        total = total + F.interpolate(m, size=(H, W), mode="bilinear",
                                      align_corners=False)[0, 0]
    return total


class AlexLPIPS:
    """AlexNet-LPIPS, spatial (port of the JAX package's `JaxLPIPS`):
    scale the inputs, the five AlexNet conv taps, each unit-normalised
    along channels, squared difference, a 1x1 linear head per tap, each
    map bilinearly upsampled to the input size, summed. The convolutions
    run with cuDNN's TF32 off (`torch.backends.cudnn.allow_tf32 = False`
    for the call): cuDNN's float32 convolution takes TF32 by default,
    where a float32 matrix product does not."""

    def __init__(self, weights: dict, device="cpu"):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.params = {
            "convs": [(t(w), t(b)) for w, b in weights["convs"]],
            "lins": [t(w) for w in weights["lins"]],
            "shift": t(weights["shift"]).reshape(1, 3, 1, 1),
            "scale": t(weights["scale"]).reshape(1, 3, 1, 1)}

    def __call__(self, image_gt, image_pred) -> np.ndarray:
        """(H, W, 3) in [0, 1] each -> (H, W) numpy LPIPS map."""
        dev = self.params["shift"].device

        def nchw(x):
            return torch.as_tensor(np.asarray(x, np.float32)
                                   if not torch.is_tensor(x) else x,
                                   dtype=torch.float32,
                                   device=dev).permute(2, 0, 1)[None]

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                m = _lpips_distance(self.params, nchw(image_gt),
                                    nchw(image_pred))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return m.cpu().numpy()


def load_lpips_weights(path: str, device="cpu") -> AlexLPIPS:
    """An `AlexLPIPS` from a torch state dict of the `lpips` package's
    `LPIPS(net='alex')` module (keys `scaling_layer.{shift,scale}`,
    `net.sliceK.I.{weight,bias}`, `linK.model.1.weight`; `lins.K...` also
    accepted)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                        np.float32) for k, v in sd.items()}
    convs = []
    for sl, (idx, *_rest) in zip(_ALEX_SLICES, _ALEX_CONVS):
        wk, bk = f"net.{sl}.{idx}.weight", f"net.{sl}.{idx}.bias"
        if wk not in sd:
            raise ValueError(
                f"--lpips_weights: missing {wk!r}; expected the full "
                "AlexNet-LPIPS state dict (torch.save(lpips.LPIPS("
                "net='alex').state_dict(), ...)); the linear layers alone "
                "are not enough")
        convs.append((sd[wk], sd[bk]))
    lins = []
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                  f"lin{i}.weight"):
            if k in sd:
                lins.append(sd[k].reshape(-1))
                break
        else:
            raise ValueError(f"--lpips_weights: missing lin{i} weight")
    shift = sd.get("scaling_layer.shift", np.asarray(_LPIPS_SHIFT))
    scale = sd.get("scaling_layer.scale", np.asarray(_LPIPS_SCALE))
    return AlexLPIPS({"convs": convs, "lins": lins,
                      "shift": np.asarray(shift).reshape(-1),
                      "scale": np.asarray(scale).reshape(-1)}, device)


def get_lpips_model(weights_path: Optional[str] = None, device="cpu"):
    """The LPIPS model of the weights file `weights_path`, or None when
    no file is given."""
    if weights_path:
        return load_lpips_weights(weights_path, device)
    return None


def lpips(lpips_model, image_gt, image_pred, valid_mask=None,
          reduction: str = "mean"):
    """LPIPS of (H, W, 3) images in [0, 1]: a float (the mean over the
    pixels, or over `valid_mask`'s), the map with `reduction='none'`, or
    None without a model."""
    if lpips_model is None:
        return None
    value = lpips_model(image_gt, image_pred)
    if valid_mask is not None:
        mask = valid_mask.cpu().numpy() if torch.is_tensor(valid_mask) \
            else np.asarray(valid_mask)
        value = value[mask]
    if reduction == "mean":
        return float(value.mean())
    return value
