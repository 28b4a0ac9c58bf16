"""Volume-rendering compositing primitives (port of
`nsff_pl_tpu/ops/compositing.py`).

NeRF-W additive two-field compositing: with tau = delta * softplus(sigma),
alpha_s = 1 - exp(-tau_s), alpha_t = 1 - exp(-tau_t),
alpha = 1 - (1 - alpha_s)(1 - alpha_t), the shared transmittance
T_i = prod_{j<i} (1 - alpha_j) = exp(-sum_{j<i} (tau_s + tau_t)_j) and the
weights w_s = alpha_s T, w_t = alpha_t T, w = alpha T.
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


def sigma2alpha(sigma_raw, deltas, noise=None):
    """Raw sigma -> alpha, with optional pre-activation noise (a tensor of
    the same shape, or None)."""
    if noise is not None:
        sigma_raw = sigma_raw + noise
    return 1.0 - torch.exp(-deltas * softplus(sigma_raw))


def transmittance(alphas: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - alpha_j): the exclusive cumulative product
    along the sample axis."""
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas[:, :-1]], -1)
    return torch.cumprod(shifted, -1)


def composite_two_fields(static_alphas, transient_alphas):
    """NeRF-W additive compositing of two alpha fields: (static_weights,
    transient_weights, weights, trans)."""
    alphas = 1.0 - (1.0 - static_alphas) * (1.0 - transient_alphas)
    trans = transmittance(alphas)
    return (static_alphas * trans, transient_alphas * trans, alphas * trans,
            trans)


def composite_one_field(alphas):
    """Single-field weights alpha * T."""
    return alphas * transmittance(alphas)


def weighted_sum(weights, values):
    """sum_i w_i v_i along the sample axis; weights (N, S), values (N, S)
    or (N, S, C)."""
    if values.ndim == weights.ndim + 1:
        return (weights[..., None] * values).sum(-2)
    return (weights * values).sum(-1)
