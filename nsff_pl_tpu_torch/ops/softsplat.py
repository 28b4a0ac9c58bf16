"""Softmax splatting (forward warping), deterministic (port of
`nsff_pl_tpu/ops/softsplat.py`).

Each source pixel is added into the four integer neighbours of
(x + flow_x, y + flow_y) with bilinear weights; corners outside the image
are dropped. The sums run in one of two forms, both giving the same bits
in every run (the JAX package's splat is deterministic by design;
`index_add_` on CUDA accumulates with atomics in an order that changes
from run to run):

- shifts (the JAX package's `softsplat_sum_rolls_planar`): for every
  integer offset (kx, ky) a pixel can reach, the planes times that
  offset's bilinear weight, shifted by it and summed; the cost grows with
  the product of the two offset ranges of the flows;
- scatter: `index_put_(accumulate=True)` per corner, which on a CUDA
  tensor sorts the targets and sums each one's terms in order (serially
  on the CPU); its cost grows more slowly with the flows.

`_splat_sum` reads the flows' offset ranges (one host read) and takes
the shifts up to `MAX_SHIFT_TERMS` terms, else the scatter. The splat
computes in plain PyTorch: the JAX package computes it in XLA, not in a
Pallas kernel. Not ported: its per-plane range probes and buckets
(`_bucket_groups`, `_jit_rolls*`, `_probe_*`), which exist to bound
XLA's recompiles; the ranges here are those of all planes of a call.

Layout: `softsplat_sum` / `softsplat` take (H, W, C) images and (H, W, 2)
flows (flow[..., 0] is the x/column displacement); the batched planar
splat takes (S, C, H, W) planes and (S, H, W) flow components.
"""
from __future__ import annotations

from typing import Optional

import torch

# the shifts' largest term count (x offsets times y offsets), the largest
# measured: average mode, 256 planes of 4 channels at 512x288 on an H100
# (scripts/time_splat.py): shifts 36 / 82 / 186 / 524 ms at 9 / 25 / 64 /
# 196 terms, the scatter 172 / 242 / 382 / 699 ms on the same flows; the
# shifts' cost grows with the terms, the scatter's more slowly
MAX_SHIFT_TERMS = 196
# planes per scatter call: bounds the index and value buffers (4 corners
# x planes x pixels)
PLANES_PER_CALL = 32


def _shift(a: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """The value at (y, x) of (..., H, W) moved to (y + ky, x + kx),
    zero fill: what leaves the image drops."""
    H, W = a.shape[-2:]
    out = torch.zeros_like(a)
    if abs(ky) >= H or abs(kx) >= W:
        return out
    out[..., max(ky, 0):H - max(-ky, 0), max(kx, 0):W - max(-kx, 0)] = \
        a[..., max(-ky, 0):H - max(ky, 0), max(-kx, 0):W - max(kx, 0)]
    return out


def _splat_sum(src: torch.Tensor, fx: torch.Tensor,
               fy: torch.Tensor) -> torch.Tensor:
    """Summation splat of planes: src (S, C, H, W), fx / fy (S, H, W)
    -> (S, C, H, W)."""
    S, C, H, W = src.shape
    xs = torch.arange(W, dtype=fx.dtype, device=fx.device)
    ys = torch.arange(H, dtype=fy.dtype, device=fy.device)[:, None]
    x0f, y0f = torch.floor(fx + xs), torch.floor(fy + ys)
    wx1, wy1 = fx + xs - x0f, fy + ys - y0f  # fraction toward x0 + 1 / y0 + 1
    ox, oy = (x0f - xs).long(), (y0f - ys).long()  # offsets of corner 0
    kx0, kx1, ky0, ky1 = torch.stack(
        [ox.min(), ox.max() + 1, oy.min(), oy.max() + 1]).tolist()
    if (kx1 - kx0 + 1) * (ky1 - ky0 + 1) <= MAX_SHIFT_TERMS:
        def sel(off, w1, k):  # the weight each pixel sends to offset k
            return (torch.where(off == k, 1.0 - w1, 0.0)
                    + torch.where(off + 1 == k, w1, 0.0))[:, None]

        sxs = {kx: sel(ox, wx1, kx) for kx in range(kx0, kx1 + 1)}
        out = torch.zeros_like(src)
        for ky in range(ky0, ky1 + 1):
            sy = sel(oy, wy1, ky)
            row = torch.zeros_like(src)
            for kx in range(kx0, kx1 + 1):
                row += _shift(src * (sy * sxs[kx]), 0, kx)
            out += _shift(row, ky, 0)
        return out
    out = torch.empty_like(src)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0, y0 = x0f.long(), y0f.long()
    for s0 in range(0, S, PLANES_PER_CALL):
        sl = slice(s0, s0 + PLANES_PER_CALL)
        n = src[sl].shape[0]
        rows = src[sl].permute(0, 2, 3, 1).reshape(n, H * W, C)
        base = (torch.arange(n, device=src.device) * (H * W))[:, None, None]
        dump = n * H * W  # one row past the end takes the dropped corners
        acc = src.new_zeros((n * H * W + 1, C))
        for yi, xi, w in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                          (y0 + 1, x0, wy1 * wx0),
                          (y0 + 1, x0 + 1, wy1 * wx1)):
            yi, xi, w = yi[sl], xi[sl], w[sl]
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = torch.where(inside, base + yi * W + xi, dump).reshape(-1)
            acc.index_put_((idx,), (rows * w.reshape(n, H * W, 1)).reshape(
                -1, C), accumulate=True)
        out[sl] = acc[:-1].reshape(n, H, W, C).permute(0, 3, 1, 2)
    return out


def softsplat_sum(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Summation-mode splat: (H, W, C) image forward-warped by (H, W, 2)
    flow."""
    return _splat_sum(image.permute(2, 0, 1)[None], flow[None, ..., 0],
                      flow[None, ..., 1])[0].permute(1, 2, 0)


def softsplat(image: torch.Tensor, flow: torch.Tensor,
              metric: Optional[torch.Tensor] = None,
              mode: str = "average", eps: float = 0.0) -> torch.Tensor:
    """Forward-warp `image` by `flow`.

    mode:
        'summation' - raw scatter-add
        'average'   - append a ones channel, divide by its splat
        'linear'    - weight by `metric` (H, W, 1)
        'softmax'   - weight by exp(metric)
    Output pixels that receive no weight keep 0 (the normaliser is set to
    1 where it is 0)."""
    if mode not in ("summation", "average", "linear", "softmax"):
        raise ValueError(f"unknown splat mode {mode!r}")
    if mode in ("linear", "softmax"):
        if metric is None or metric.shape[-1] != 1:
            raise ValueError("linear/softmax modes need a (H, W, 1) metric")
    if mode == "summation":
        return softsplat_sum(image, flow)
    if mode == "average":
        weighted, norm_src = image, torch.ones_like(image[..., :1])
    elif mode == "linear":
        weighted, norm_src = image * metric, metric
    else:  # softmax
        m = torch.exp(metric)
        weighted, norm_src = image * m, m
    out = softsplat_sum(torch.cat([weighted, norm_src], -1), flow)
    norm = out[..., -1:]
    norm = torch.where(norm == 0.0, 1.0, norm)
    return out[..., :-1] / (norm + eps)


def softsplat_batched_planar(images: torch.Tensor, fx: torch.Tensor,
                             fy: torch.Tensor,
                             mode: str = "average") -> torch.Tensor:
    """Splat a stack of planes, each by its own flow: (S, C, H, W) planes
    and two (S, H, W) flow components -> (S, C, H, W), in 'average' or
    'summation' mode (`softsplat`'s rules)."""
    if mode not in ("average", "summation"):
        raise ValueError(f"batched splat modes: average, summation; got "
                         f"{mode!r}")
    if mode == "summation":
        return _splat_sum(images, fx, fy)
    out = _splat_sum(torch.cat([images, torch.ones_like(images[:, :1])], 1),
                     fx, fy)
    norm = out[:, -1:]
    return out[:, :-1] / torch.where(norm == 0.0, 1.0, norm)
