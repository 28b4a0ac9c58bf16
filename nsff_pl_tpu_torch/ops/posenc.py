"""Sinusoidal positional encoding (port of `nsff_pl_tpu/ops/posenc.py`).

Channel order `[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]`,
frequencies `2**linspace(0, max_logscale, N_freqs)` (logscale) or
`linspace(1, 2**max_logscale, N_freqs)`. The frequencies of each device
are made once, by fills on the device, and kept: a copy from the host
would wait on it, which a captured CUDA graph cannot hold. They are made
outside inference mode, so a first call from a no-grad render leaves
tensors that training's autograd can save. Under `torch.export` they are
made in the traced program and not kept (a tensor made while tracing
must not outlive the trace).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def posenc_freqs(max_logscale: float, n_freqs: int,
                 logscale: bool = True) -> np.ndarray:
    if logscale:
        return 2.0 ** np.linspace(0, max_logscale, n_freqs)
    return np.linspace(1, 2.0 ** max_logscale, n_freqs)


@functools.lru_cache(maxsize=None)
def _freqs_on(max_logscale: float, n_freqs: int, logscale: bool, dtype,
              device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.stack([torch.full((), float(f), dtype=dtype,
                                       device=device)
                            for f in posenc_freqs(max_logscale, n_freqs,
                                                  logscale)])


def posenc(x: torch.Tensor, max_logscale: float, n_freqs: int,
           logscale: bool = True) -> torch.Tensor:
    """Embed (..., C) -> (..., C*(1+2*n_freqs)), f32 in, f32 out."""
    make = (_freqs_on.__wrapped__ if torch.compiler.is_exporting()
            else _freqs_on)
    freqs = make(max_logscale, n_freqs, logscale, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., N_freqs, C)
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    sc = sc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def posenc_dim(n_channels: int, n_freqs: int) -> int:
    return n_channels * (1 + 2 * n_freqs)
