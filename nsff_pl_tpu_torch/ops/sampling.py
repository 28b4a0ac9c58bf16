"""Depth sampling along rays (port of `nsff_pl_tpu/ops/sampling.py`).

Only the stratified draw is ported; `sample_pdf` belongs to the
coarse-to-fine path, which is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch


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
    # linspace as XLA computes the JAX package's: i * (1 / (S - 1)) in the
    # dtype, the last one exactly 1 (torch.linspace differs by an ulp at
    # some samples, which can move a point across a visibility border)
    zs = torch.arange(n_samples, dtype=dtype, device=device) * (
        1.0 / max(n_samples - 1, 1))
    zs[-1:].fill_(1.0)  # a fill kernel: no host copy, graph-capturable
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
