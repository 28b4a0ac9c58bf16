"""Fused planar compositor: CUDA kernels + plain PyTorch versions.

Port of `nsff_pl_tpu/ops/compositing_planar_kernel.py::make_planar_compositor`.
The planar train path composites the main evaluation and the two warped
evaluations together (they share the static optical thickness tau_s):
softplus(sigma + noise), the additive NeRF-W weights with the
transmittance T = exp(-exclusive_cumsum(tau_s + tau_c)), and the
rgb/depth/warped-rgb maps. The forward reads the 21 input planes
(`IN_KEYS`) once and writes five weight planes and one (N, 16) maps tile.

The backward is the hand-written adjoint of the TPU kernel: with
u = tau_s + tau_c and dT_j/du_i = -T_j for i < j, the cotangent of u is
the direct alpha terms minus the reverse exclusive cumsum of g_T * T (no
1/(1 - alpha) division), and the softplus derivative is sigmoid. zs and
the noises are data and get no gradient.

`planar_compositor_fwd` / `_bwd` launch `csrc/planar_compositor.cu` for
CUDA tensors and run the plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch

from nsff_pl_tpu_torch.ops.compositing import (deltas_from_zs,
                                               exclusive_cumsum, softplus)
from nsff_pl_tpu_torch.ops.raymarch_kernel import check_cuda, check_samples

# input planes: zs + 4 raw sigmas + 4 noises + 12 rgb planes
IN_KEYS = ("zs", "ssig", "tsig", "tsig_w1", "tsig_w2",
           "ns", "nt", "nw1", "nw2",
           "srgb_r", "srgb_g", "srgb_b",
           "trgb_r", "trgb_g", "trgb_b",
           "trgb_w1_r", "trgb_w1_g", "trgb_w1_b",
           "trgb_w2_r", "trgb_w2_g", "trgb_w2_b")
# output planes; maps is (N, 16): 0:3 rgb_fine, 3 depth_fine, 4:7 rgb_w1,
# 7:10 rgb_w2, 10:16 zero
OUT_KEYS = ("static_weights", "transient_weights", "weights",
            "tw_w1", "tw_w2")
N_MAP = 16
# the differentiable inputs, in the order of the backward's 16 planes
GRAD_KEYS = ("ssig", "tsig", "tsig_w1", "tsig_w2") + tuple(
    k for k in IN_KEYS if "rgb" in k)
_SIGMAS = (("ssig", "ns"), ("tsig", "nt"), ("tsig_w1", "nw1"),
           ("tsig_w2", "nw2"))
_COMPS = ("", "_w1", "_w2")


def rev_exclusive_cumsum(v: torch.Tensor) -> torch.Tensor:
    """out[..., j] = sum_{i > j} v[..., i] along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(v, [-1]), -1), [-1]) - v


def _fwd_core(ins):
    """The forward quantities the backward reuses."""
    d_s, d_t = deltas_from_zs(ins["zs"])
    sp = {k: softplus(ins[k] + ins[n]) for k, n in _SIGMAS}
    tau_s = d_s * sp["ssig"]
    q = {"d_s": d_s, "d_t": d_t, "a_s": 1.0 - torch.exp(-tau_s)}
    for c in _COMPS:
        tau_c = d_t * sp[f"tsig{c}"]
        u = tau_s + tau_c
        q[f"T{c}"] = torch.exp(-exclusive_cumsum(u))
        q[f"a{c}"] = 1.0 - torch.exp(-tau_c)
        q[f"alpha{c}"] = 1.0 - torch.exp(-u)
    return q


def planar_compositor_fwd_ref(ins: Dict[str, torch.Tensor]):
    """The forward kernel's function: ((5, N, S) weight planes in
    `OUT_KEYS` order, (N, 16) maps)."""
    q = _fwd_core(ins)
    a_s, T = q["a_s"], q["T"]
    sw, tw, w = a_s * T, q["a"] * T, q["alpha"] * T
    tw_w1, tw_w2 = q["a_w1"] * q["T_w1"], q["a_w2"] * q["T_w2"]
    sw_w1, sw_w2 = a_s * q["T_w1"], a_s * q["T_w2"]
    cols = [(sw * ins[f"srgb_{c}"] + tw * ins[f"trgb_{c}"]).sum(-1)
            for c in "rgb"]
    cols.append((w * ins["zs"]).sum(-1))
    for wc, swc, tag in ((tw_w1, sw_w1, "w1"), (tw_w2, sw_w2, "w2")):
        cols += [(swc * ins[f"srgb_{c}"] + wc * ins[f"trgb_{tag}_{c}"]).sum(-1)
                 for c in "rgb"]
    maps = torch.stack(cols, -1)
    maps = torch.cat([maps, maps.new_zeros((maps.shape[0], N_MAP - 10))], -1)
    return torch.stack([sw, tw, w, tw_w1, tw_w2]), maps


def planar_compositor_bwd_ref(ins: Dict[str, torch.Tensor],
                              g: Dict[str, Optional[torch.Tensor]],
                              gmap: Optional[torch.Tensor]) -> torch.Tensor:
    """The hand-written adjoint: cotangents of the five weight planes
    (None = zero) and of the maps -> (16, N, S) planes in `GRAD_KEYS`
    order."""
    zs = ins["zs"]
    zero = torch.zeros_like(zs)
    if gmap is None:
        gmap = zs.new_zeros((zs.shape[0], N_MAP))
    q = _fwd_core(ins)
    a_s, T = q["a_s"], q["T"]
    sw, tw = a_s * T, q["a"] * T
    tw_w1, tw_w2 = q["a_w1"] * q["T_w1"], q["a_w2"] * q["T_w2"]
    sw_w1, sw_w2 = a_s * q["T_w1"], a_s * q["T_w2"]
    gz = {k: g.get(k) if g.get(k) is not None else zero for k in OUT_KEYS}

    # map adjoints fold into weight-plane cotangents + rgb cotangents
    g_sw = gz["static_weights"]
    g_tw = gz["transient_weights"]
    g_w = gz["weights"] + gmap[:, 3:4] * zs
    g_tww1, g_tww2 = gz["tw_w1"], gz["tw_w2"]
    g_sww1, g_sww2 = zero, zero
    d = {}
    for i, c in enumerate("rgb"):
        gm, g1, g2 = gmap[:, i:i + 1], gmap[:, 4 + i:5 + i], gmap[:, 7 + i:8 + i]
        g_sw = g_sw + gm * ins[f"srgb_{c}"]
        g_tw = g_tw + gm * ins[f"trgb_{c}"]
        g_sww1 = g_sww1 + g1 * ins[f"srgb_{c}"]
        g_tww1 = g_tww1 + g1 * ins[f"trgb_w1_{c}"]
        g_sww2 = g_sww2 + g2 * ins[f"srgb_{c}"]
        g_tww2 = g_tww2 + g2 * ins[f"trgb_w2_{c}"]
        d[f"srgb_{c}"] = gm * sw + g1 * sw_w1 + g2 * sw_w2
        d[f"trgb_{c}"] = gm * tw
        d[f"trgb_w1_{c}"] = g1 * tw_w1
        d[f"trgb_w2_{c}"] = g2 * tw_w2

    # per-composite transmittance adjoints (additive exp form)
    g_tau_s = zero
    g_tau = {}
    exp_ms = 1.0 - a_s  # exp(-tau_s)
    for c, gs, gt, gw in (("", g_sw, g_tw, g_w), ("_w1", g_sww1, g_tww1, None),
                          ("_w2", g_sww2, g_tww2, None)):
        T_c, a_c, alpha_c = q[f"T{c}"], q[f"a{c}"], q[f"alpha{c}"]
        g_T = gs * a_s + gt * a_c
        g_u = zero
        if gw is not None:
            g_T = g_T + gw * alpha_c
            g_u = gw * T_c * (1.0 - alpha_c)  # d alpha/du = exp(-u)
        g_u = g_u - rev_exclusive_cumsum(g_T * T_c)
        g_tau_s = g_tau_s + g_u + gs * T_c * exp_ms
        g_tau[c] = g_u + gt * T_c * (1.0 - a_c)

    # tau = delta * softplus(sigma + noise); softplus' = sigmoid
    def sig(k, n):
        return torch.sigmoid(ins[k] + ins[n])

    d["ssig"] = g_tau_s * q["d_s"] * sig("ssig", "ns")
    for c, (k, n) in zip(_COMPS, _SIGMAS[1:]):
        d[k] = g_tau[c] * q["d_t"] * sig(k, n)
    return torch.stack([d[k] for k in GRAD_KEYS])


# ---------------------------- CUDA kernels -----------------------------

def _checked_ptrs(planes, keys, n, S, dev, allow_none=False):
    arr = (ctypes.c_void_p * len(keys))()
    for i, k in enumerate(keys):
        t = planes.get(k)
        if t is None:
            if not allow_none:
                raise ValueError(f"{k} is required")
            continue
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != (n, S)):
            raise ValueError(f"{k}: need a contiguous float32 ({n}, {S}) "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        arr[i] = t.data_ptr()
    return arr


def _lib_fn(name, nargs_ptr_arrays):
    from nsff_pl_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load("planar_compositor"), name)
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.POINTER(P)] * nargs_ptr_arrays + [
        P, ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


def _shape_of(ins):
    zs = ins["zs"]
    n, S = zs.shape
    check_samples(S, "the CUDA compositor")
    check_cuda(zs, "the CUDA compositor")
    return n, S, zs.device


def planar_compositor_fwd_cuda(ins):
    """Launch the forward kernel (one warp per ray) on the current stream;
    adds one to `planar_compositor_fwd_cuda.launches[S]`."""
    n, S, dev = _shape_of(ins)
    out = torch.empty((len(OUT_KEYS), n, S), dtype=torch.float32, device=dev)
    maps = torch.empty((n, N_MAP), dtype=torch.float32, device=dev)
    if n == 0:
        return out, maps
    fn = _lib_fn("nsff_planar_comp_fwd", 2)
    rc = fn(_checked_ptrs(ins, IN_KEYS, n, S, dev),
            _checked_ptrs(dict(zip(OUT_KEYS, out)), OUT_KEYS, n, S, dev),
            maps.data_ptr(), n, S, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"planar_compositor forward launch failed: "
                           f"cudaError {rc}")
    planar_compositor_fwd_cuda.launches[S] += 1
    return out, maps


planar_compositor_fwd_cuda.launches = Counter()  # by sample count


def planar_compositor_bwd_cuda(ins, g, gmap):
    """Launch the adjoint kernel (one warp per ray) on the current stream;
    adds one to `planar_compositor_bwd_cuda.launches[S]`."""
    n, S, dev = _shape_of(ins)
    out = torch.empty((len(GRAD_KEYS), n, S), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    if gmap is not None and (gmap.device != dev or gmap.dtype != torch.float32
                             or not gmap.is_contiguous()
                             or tuple(gmap.shape) != (n, N_MAP)):
        raise ValueError(f"gmap: need a contiguous float32 ({n}, {N_MAP}) "
                         f"tensor on {dev}")
    fn = _lib_fn("nsff_planar_comp_bwd", 3)
    rc = fn(_checked_ptrs(ins, IN_KEYS, n, S, dev),
            _checked_ptrs(g, OUT_KEYS, n, S, dev, allow_none=True),
            _checked_ptrs(dict(zip(GRAD_KEYS, out)), GRAD_KEYS, n, S, dev),
            gmap.data_ptr() if gmap is not None else None, n, S,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"planar_compositor backward launch failed: "
                           f"cudaError {rc}")
    planar_compositor_bwd_cuda.launches[S] += 1
    return out


planar_compositor_bwd_cuda.launches = Counter()


def planar_compositor_fwd(ins):
    """CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if ins["zs"].is_cuda:
        return planar_compositor_fwd_cuda(ins)
    return planar_compositor_fwd_ref(ins)


def planar_compositor_bwd(ins, g, gmap):
    """CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if ins["zs"].is_cuda:
        return planar_compositor_bwd_cuda(ins, g, gmap)
    return planar_compositor_bwd_ref(ins, g, gmap)


class _PlanarCompositor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *planes):
        ins = dict(zip(IN_KEYS, planes))
        ctx.save_for_backward(*planes)
        out, maps = planar_compositor_fwd(ins)
        return (*out, maps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        ins = dict(zip(IN_KEYS, ctx.saved_tensors))
        g = {k: (v.contiguous() if v is not None else None)
             for k, v in zip(OUT_KEYS, grads[:5])}
        gmap = grads[5].contiguous() if grads[5] is not None else None
        d = dict(zip(GRAD_KEYS, planar_compositor_bwd(ins, g, gmap)))
        return tuple(d.get(k) for k in IN_KEYS)


def make_planar_compositor(n_samples: int):
    """fn(inputs: dict of the 21 `IN_KEYS` (N, S) planes) -> dict of
    static_weights, transient_weights, weights (main composite), tw_w1,
    tw_w2 (warped transient weights against the shared static field) and
    maps (N, 16). Differentiable in the sigma and rgb planes."""
    def fn(ins: Dict[str, torch.Tensor]):
        if ins["zs"].shape[1] != n_samples:
            raise ValueError(f"zs has {ins['zs'].shape[1]} samples, "
                             f"compositor built for {n_samples}")
        outs = _PlanarCompositor.apply(*[ins[k].contiguous()
                                         for k in IN_KEYS])
        res = dict(zip(OUT_KEYS, outs[:5]))
        res["maps"] = outs[5]
        return res

    return fn
