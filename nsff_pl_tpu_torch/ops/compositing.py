"""Volume-rendering compositing primitives (port of the parts of
`nsff_pl_tpu/ops/compositing.py` the planar paths use).

NeRF-W additive two-field compositing: with tau = delta * softplus(sigma),
alpha = 1 - exp(-tau) and the shared transmittance
T_i = exp(-sum_{j<i} (tau_s + tau_t)_j).
"""
from __future__ import annotations

import torch

# the last interval is padded with 100 (static) / 1e-3 (transient)
STATIC_FAR_DELTA = 100.0
TRANSIENT_FAR_DELTA = 1e-3


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Sigma activation, log1p(exp(-|x|)) + max(x, 0), as
    `logaddexp(x, 0)`: the same values, and autograd gives sigmoid(x)
    everywhere, as JAX does (the explicit formula's autograd gives 1, not
    1/2, at x = 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def deltas_from_zs(zs: torch.Tensor):
    """(N, S) depths -> static & transient deltas, each (N, S)."""
    d = zs[:, 1:] - zs[:, :-1]
    static = torch.cat([d, torch.full_like(d[:, :1], STATIC_FAR_DELTA)], -1)
    transient = torch.cat(
        [d, torch.full_like(d[:, :1], TRANSIENT_FAR_DELTA)], -1)
    return static, transient


def exclusive_cumsum(v: torch.Tensor) -> torch.Tensor:
    """out[..., i] = sum_{j<i} v[..., j] along the last axis."""
    c = torch.cumsum(v, -1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)


def transmittance_from_taus(taus: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} exp(-tau_j) = exp(-sum_{j<i} tau_j)."""
    return torch.exp(-exclusive_cumsum(taus))
