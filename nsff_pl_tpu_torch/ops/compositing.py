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
WARP = 32  # samples per warp of the compositor kernels' scans


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Sigma activation, log1p(exp(-|x|)) + max(x, 0), as
    `logaddexp(x, 0)`: the same values, and autograd gives sigmoid(x)
    everywhere, as JAX does (the explicit formula's autograd gives 1, not
    1/2, at x = 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def deltas_from_zs(zs: torch.Tensor):
    """(N, S) depths -> static & transient deltas, each (N, S): the last
    sample takes the far deltas, also when it is the ray's only one (as
    the JAX package's kernels and the port's give it; the JAX package's
    plain `deltas_from_zs` sizes the far column by the differences, so
    at S = 1 it returns no delta at all)."""
    d = zs[:, 1:] - zs[:, :-1]
    static = torch.cat([d, torch.full_like(zs[:, :1], STATIC_FAR_DELTA)], -1)
    transient = torch.cat(
        [d, torch.full_like(zs[:, :1], TRANSIENT_FAR_DELTA)], -1)
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


# Scans along the sample axis in the order of the compositor kernels
# (csrc/fused_compositing.cu): the samples in warps of 32, a Hillis-Steele
# scan inside each warp, the warps joined in order. The axis is padded to
# a multiple of 32 with the scan's identity, which leaves every value
# unchanged.

def _warps(v, fill):
    """(N, S) -> (N, W, 32): the samples in warps of 32, the tail padded
    with `fill`."""
    n, S = v.shape
    pad = -S % WARP
    if pad:
        v = torch.cat([v, v.new_full((n, pad), fill)], -1)
    return v.reshape(n, -1, WARP)


def _unwarp(b, S):
    return b.reshape(b.shape[0], -1)[:, :S]


def block_excl_cumprod(v):
    """out[:, j] = prod_{i<j} v[:, i], in the kernel's order: an inclusive
    Hillis-Steele scan inside each warp, shifted to exclusive, times the
    product of the earlier warps' totals taken in warp order."""
    inc = _warps(v, 1.0)
    off = 1
    while off < WARP:
        inc = torch.cat([inc[..., :off], inc[..., off:] * inc[..., :-off]],
                        -1)
        off *= 2
    exc = torch.cat([torch.ones_like(inc[..., :1]), inc[..., :-1]], -1)
    pre = [torch.ones_like(inc[:, 0, :1])]
    for w in range(1, inc.shape[1]):
        pre.append(pre[-1] * inc[:, w - 1, -1:])
    return _unwarp(torch.stack(pre, 1) * exc, v.shape[1])


def block_rev_excl_cumsum(v):
    """out[:, j] = sum_{i>j} v[:, i], directly, in the kernel's order: the
    next sample's term shifted in, an inclusive reverse Hillis-Steele scan
    inside each warp, plus the later warps' totals summed from the last
    warp down."""
    b = _warps(v, 0.0)
    inc = torch.cat([b[..., 1:], torch.zeros_like(b[..., :1])], -1)
    off = 1
    while off < WARP:
        inc = torch.cat([inc[..., :-off] + inc[..., off:], inc[..., -off:]],
                        -1)
        off *= 2
    tot = inc[..., :1] + b[..., :1]  # (N, W, 1)
    post = [torch.zeros_like(tot[:, 0])]
    for w in range(inc.shape[1] - 1, 0, -1):
        post.insert(0, post[0] + tot[:, w])
    return _unwarp(inc + torch.stack(post, 1), v.shape[1])


def block_sum(v):
    """sum_j v[:, j], in the kernel's order: each warp's butterfly (a
    halving tree), then the warps' partials in order."""
    b = _warps(v, 0.0)
    h = WARP // 2
    while h:
        b = b[..., :h] + b[..., h:]
        h //= 2
    acc = b[:, 0, 0]
    for w in range(1, b.shape[1]):
        acc = acc + b[:, w, 0]
    return acc


def transmittance(alphas: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - alpha_j): the exclusive cumulative product
    along the sample axis, by `block_excl_cumprod`, a log-depth scan as
    XLA gives the JAX package's cumprod. Its autograd is products only:
    torch.cumprod's backward looks for zeros on the host, which a captured
    CUDA graph cannot do, and divides."""
    return block_excl_cumprod(1.0 - alphas)


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
