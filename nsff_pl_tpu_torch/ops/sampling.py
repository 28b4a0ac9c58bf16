"""Depth sampling along rays (port of `nsff_pl_tpu/ops/sampling.py`):
stratified coarse samples and inverse-CDF hierarchical ("importance")
resampling of the coarse-to-fine path."""
from __future__ import annotations

from typing import Optional

import torch


def linspace01(n: int, *, device=None, dtype=torch.float32) -> torch.Tensor:
    """n evenly spaced values from 0 to 1 as XLA computes the JAX
    package's `jnp.linspace(0, 1, n)`: i * (1 / (n - 1)) in the dtype, the
    last one exactly 1 (torch.linspace differs by an ulp at some points,
    which can move a sample across a visibility border or a CDF step)."""
    v = torch.arange(n, dtype=dtype, device=device) * (1.0 / max(n - 1, 1))
    v[-1:].fill_(1.0)  # a fill kernel: no host copy, graph-capturable
    return v


def stratified_zs(n_rays: int, n_samples: int, perturb: float,
                  u: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None,
                  device=None, dtype=torch.float32):
    """Coarse sample depths in NDC z in [0, 1].

    linspace z, then (if perturb > 0) jitter each z uniformly inside its
    interval `z = lower + (upper - lower) * perturb * U[0,1)`. The
    uniforms come from `u` ((n_rays, n_samples), e.g. the draws another
    implementation made) or else from `generator`.

    Returns (zs, zs_mid) with shapes (n_rays, n_samples) and
    (n_rays, n_samples-1)."""
    zs = linspace01(n_samples, device=device, dtype=dtype)
    zs = zs.expand(n_rays, n_samples)
    zs_mid = 0.5 * (zs[:, :-1] + zs[:, 1:])
    if perturb > 0:
        upper = torch.cat([zs_mid, zs[:, -1:]], -1)
        lower = torch.cat([zs[:, :1], zs_mid], -1)
        if u is None:
            u = torch.rand((n_rays, n_samples), generator=generator,
                           dtype=dtype, device=device)
        zs = lower + (upper - lower) * perturb * u
    return zs, zs_mid


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = False, eps: float = 1e-5,
               u: Optional[torch.Tensor] = None, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Draw `n_importance` depths per ray from the piecewise-constant PDF
    that `weights` ((N, M)) puts on the bins with edges `bins` ((N, M+1)).

    `det=True` takes evenly spaced u (the reference's behaviour when
    perturb == 0); otherwise the uniforms come from `u` ((N, n_importance))
    or else from `generator`. Returns (N, n_importance) depths, unsorted.
    No host sync: graph-capturable."""
    n_rays, m = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)  # (N, M+1)
    if det:
        u = linspace01(n_importance, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(n_rays, n_importance)
    elif u is None:
        u = torch.rand((n_rays, n_importance), generator=generator,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, 0, m)
    above = torch.clamp(inds, 0, m)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, 1.0, denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)
