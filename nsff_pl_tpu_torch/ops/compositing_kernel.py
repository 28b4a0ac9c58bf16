"""Fused NeRF-W compositor on the packed evaluator output: CUDA kernels +
plain PyTorch versions.

Port of `nsff_pl_tpu/ops/compositing_kernel.py::make_fused_compositing`.
The main evaluation's compositing reads the packed (N, S, 16) output of
`ops/mlp_train_kernel.py` directly: softplus(sigma + noise), the alphas
with the reference's far deltas, the shared transmittance of NeRF-W
additive compositing as an exclusive product of 1 - alpha, the static,
transient and total weights, and the rgb and depth maps.

The backward is the hand-written adjoint of the TPU kernel:

    dL/dalpha_j = g_w_j T_j - (sum_{i>j} g_T_i T_i) / max(1 - alpha_j, 1e-37)

with the trailing sum as a direct reverse scan of the next samples'
terms, never a total or an inclusive sum minus a prefix, so it is an
exact 0 at the far sample, where 1 - alpha ~ 1e-31 (0 in f32) would
divide any residue. The softplus derivative is the sigmoid, written out.
zs and the noises are data and get no gradient; columns 8-15 of the
packed cotangent are zero.

The plain versions take the transmittance products, the trailing sums
and the map sums in the CUDA kernels' order (`ops/compositing.py`:
`block_excl_cumprod`, `block_rev_excl_cumsum`, `block_sum`).

`fused_compositing_fwd` / `_bwd` launch `csrc/fused_compositing.cu` for
CUDA tensors and run the plain versions for CPU tensors. The CUDA
kernels take any S >= 1: a ray in chunks of at most 8 warps of 32
samples, the samples past S masked (the scans' identities, with which the
plain versions pad their last warp).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch

from nsff_pl_tpu_torch.ops.compositing import (block_excl_cumprod,
                                               block_rev_excl_cumsum,
                                               block_sum, deltas_from_zs,
                                               softplus)
from nsff_pl_tpu_torch.ops.raymarch_kernel import check_cuda, check_samples

N_PACKED = 16
TINY = 1e-37
# output planes, each (N, S); rgb (N, 3) and depth (N,) come as maps (N, 4)
OUT_KEYS = ("static_sigmas", "transient_sigmas", "static_alphas",
            "transient_alphas", "static_weights", "transient_weights",
            "weights")


def _fwd_core(packed, zs, noise_s, noise_t):
    """The forward quantities the adjoint reuses."""
    d_s, d_t = deltas_from_zs(zs)
    s_s = softplus(packed[..., 3] + noise_s)
    s_t = softplus(packed[..., 7] + noise_t)
    a_s = 1.0 - torch.exp(-d_s * s_s)
    a_t = 1.0 - torch.exp(-d_t * s_t)
    alpha = 1.0 - (1.0 - a_s) * (1.0 - a_t)
    return (d_s, d_t, s_s, s_t, a_s, a_t, alpha,
            block_excl_cumprod(1.0 - alpha))


def fused_compositing_fwd_ref(packed, zs, noise_s, noise_t):
    """The forward kernel's function: ((7, N, S) planes in `OUT_KEYS`
    order, (N, 4) maps [rgb(3), depth])."""
    _, _, s_s, s_t, a_s, a_t, alpha, T = _fwd_core(packed, zs, noise_s,
                                                   noise_t)
    w_s, w_t, w = a_s * T, a_t * T, alpha * T
    cols = [block_sum(w_s * packed[..., c] + w_t * packed[..., 4 + c])
            for c in range(3)]
    cols.append(block_sum(w * zs))
    return (torch.stack([s_s, s_t, a_s, a_t, w_s, w_t, w]),
            torch.stack(cols, -1))


def fused_compositing_bwd_ref(packed, zs, noise_s, noise_t,
                              g: Dict[str, Optional[torch.Tensor]],
                              gmap: Optional[torch.Tensor]) -> torch.Tensor:
    """The hand-written adjoint: cotangents of the seven planes (None =
    zero) and of the maps -> the (N, S, 16) cotangent of `packed`."""
    zero = torch.zeros_like(zs)
    if gmap is None:
        gmap = zs.new_zeros((zs.shape[0], 4))
    gz = {k: g.get(k) if g.get(k) is not None else zero for k in OUT_KEYS}
    d_s, d_t, s_s, s_t, a_s, a_t, alpha, T = _fwd_core(packed, zs, noise_s,
                                                       noise_t)
    # the rgb and depth map adjoints fold into the weight cotangents
    g_ws, g_wt = gz["static_weights"], gz["transient_weights"]
    for c in range(3):
        g_ws = g_ws + gmap[:, c:c + 1] * packed[..., c]
        g_wt = g_wt + gmap[:, c:c + 1] * packed[..., 4 + c]
    g_w = gz["weights"] + gmap[:, 3:4] * zs

    g_T = g_ws * a_s + g_wt * a_t + g_w * alpha
    trail = block_rev_excl_cumsum(g_T * T)
    g_alpha = g_w * T - trail / torch.clamp(1.0 - alpha, min=TINY)
    g_as = g_ws * T + g_alpha * (1.0 - a_t) + gz["static_alphas"]
    g_at = g_wt * T + g_alpha * (1.0 - a_s) + gz["transient_alphas"]
    g_ss = g_as * d_s * torch.exp(-d_s * s_s) + gz["static_sigmas"]
    g_st = g_at * d_t * torch.exp(-d_t * s_t) + gz["transient_sigmas"]

    dp = torch.zeros_like(packed)
    w_s, w_t = a_s * T, a_t * T
    for c in range(3):
        dp[..., c] = gmap[:, c:c + 1] * w_s
        dp[..., 4 + c] = gmap[:, c:c + 1] * w_t
    dp[..., 3] = g_ss * torch.sigmoid(packed[..., 3] + noise_s)
    dp[..., 7] = g_st * torch.sigmoid(packed[..., 7] + noise_t)
    return dp


# ---------------------------- CUDA kernels -----------------------------

def _checked(t, name, shape, dev):
    if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: need a contiguous float32 {tuple(shape)} "
                         f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")
    return t.data_ptr()


def _inputs(packed, zs, noise_s, noise_t):
    n, S = zs.shape
    check_samples(S, "the packed CUDA compositor (B6)")
    check_cuda(zs, "the packed CUDA compositor (B6)")
    dev = zs.device
    ptrs = [_checked(packed, "packed", (n, S, N_PACKED), dev)] + [
        _checked(t, k, (n, S), dev)
        for k, t in (("zs", zs), ("noise_s", noise_s), ("noise_t", noise_t))]
    return n, S, dev, ptrs


def _lib_fn(name, argtypes):
    from nsff_pl_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load("fused_compositing"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def fused_compositing_fwd_cuda(packed, zs, noise_s, noise_t):
    """Launch the forward kernel (a sample a thread, a ray in chunks of
    at most 8 warps) on the current stream; adds one to
    `fused_compositing_fwd_cuda.launches[S]`."""
    n, S, dev, ptrs = _inputs(packed, zs, noise_s, noise_t)
    out = torch.empty((len(OUT_KEYS), n, S), dtype=torch.float32, device=dev)
    maps = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out, maps
    P = ctypes.c_void_p
    fn = _lib_fn("nsff_fused_comp_fwd",
                 [P] * 4 + [ctypes.POINTER(P), P] + [ctypes.c_int] * 2 + [P])
    outs = (P * len(OUT_KEYS))(*[o.data_ptr() for o in out])
    rc = fn(*ptrs, outs, maps.data_ptr(), n, S,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_compositing forward launch failed: "
                           f"cudaError {rc}")
    fused_compositing_fwd_cuda.launches[S] += 1
    return out, maps


fused_compositing_fwd_cuda.launches = Counter()  # by sample count


def fused_compositing_bwd_cuda(packed, zs, noise_s, noise_t, g, gmap):
    """Launch the adjoint kernel (a sample a thread, a ray in chunks of
    at most 8 warps) on the current stream; adds one to
    `fused_compositing_bwd_cuda.launches[S]`."""
    n, S, dev, ptrs = _inputs(packed, zs, noise_s, noise_t)
    dp = torch.empty((n, S, N_PACKED), dtype=torch.float32, device=dev)
    if n == 0:
        return dp
    P = ctypes.c_void_p
    gp = (P * len(OUT_KEYS))()
    for i, k in enumerate(OUT_KEYS):
        if g.get(k) is not None:
            gp[i] = _checked(g[k], f"g[{k}]", (n, S), dev)
    fn = _lib_fn("nsff_fused_comp_bwd",
                 [P] * 4 + [ctypes.POINTER(P), P, P] + [ctypes.c_int] * 2
                 + [P])
    rc = fn(*ptrs, gp,
            _checked(gmap, "gmap", (n, 4), dev) if gmap is not None else None,
            dp.data_ptr(), n, S, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_compositing backward launch failed: "
                           f"cudaError {rc}")
    fused_compositing_bwd_cuda.launches[S] += 1
    return dp


fused_compositing_bwd_cuda.launches = Counter()  # by sample count


def fused_compositing_fwd(packed, zs, noise_s, noise_t):
    """CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if zs.is_cuda:
        return fused_compositing_fwd_cuda(packed, zs, noise_s, noise_t)
    return fused_compositing_fwd_ref(packed, zs, noise_s, noise_t)


def fused_compositing_bwd(packed, zs, noise_s, noise_t, g, gmap):
    """CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if zs.is_cuda:
        return fused_compositing_bwd_cuda(packed, zs, noise_s, noise_t, g,
                                          gmap)
    return fused_compositing_bwd_ref(packed, zs, noise_s, noise_t, g, gmap)


class _FusedCompositing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, zs, noise_s, noise_t):
        ctx.save_for_backward(packed, zs, noise_s, noise_t)
        out, maps = fused_compositing_fwd(packed, zs, noise_s, noise_t)
        return (*out, maps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        g = {k: (v.contiguous() if v is not None else None)
             for k, v in zip(OUT_KEYS, grads[:len(OUT_KEYS)])}
        gmap = grads[-1].contiguous() if grads[-1] is not None else None
        return (fused_compositing_bwd(*ctx.saved_tensors, g, gmap), None,
                None, None)


def make_fused_compositing(n_samples: int):
    """fn(packed, zs, noise_s, noise_t) with packed (N, S, 16) from the
    packed evaluator and zs / noises (N, S) -> dict of static_sigmas,
    transient_sigmas, static_alphas, transient_alphas, static_weights,
    transient_weights, weights (each (N, S)), rgb (N, 3) and depth (N,).
    Differentiable in `packed` only."""
    def fn(packed, zs, noise_s, noise_t):
        if zs.shape[1] != n_samples:
            raise ValueError(f"zs has {zs.shape[1]} samples, compositor "
                             f"built for {n_samples}")
        outs = _FusedCompositing.apply(packed.contiguous(), zs.contiguous(),
                                       noise_s.contiguous(),
                                       noise_t.contiguous())
        res = dict(zip(OUT_KEYS, outs[:len(OUT_KEYS)]))
        res["rgb"] = outs[-1][:, :3]
        res["depth"] = outs[-1][:, 3]
        return res

    return fn
