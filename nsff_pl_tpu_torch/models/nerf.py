"""Static + transient NeRF with forward/backward scene-flow heads (port of
`nsff_pl_tpu/models/nerf.py`).

The parameters are a plain dict `{layer_name: {"w": (in, out), "b": (out,)}}`
with the JAX package's names and its (fan_in, fan_out) layout, so a
layer is `x @ w + b` and a JAX params pytree carries over without a
transpose (`training/checkpoint.py::params_from_jax`). A torch
`nn.Linear` stores the transpose; this port does not use it.

The towers compute in `compute_dtype` (float32 or bfloat16) with the
JAX package's casts: the inputs and every tower and feature layer in the
compute dtype, the sigma / rgb / flow heads in float32 on the features
cast back (`h.astype(float32)`). On the card the bfloat16 layers are
`torch.matmul` in bf16, where the JAX package leaves them to XLA.

Topology: static branch D=8, W=256 with the xyz embedding re-concatenated
at layer 4, sigma from the 8th ReLU feature, rgb from a final linear
(+ optional viewdir/appearance conditioning); transient branch of the
same shape on xyz-embedding (+) time-latent with sigma/rgb and, for the
fine model, `flow_scale * tanh` fw/bw flow heads.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from nsff_pl_tpu_torch import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]

DEFAULT_D = 8
DEFAULT_W = 256
DEFAULT_SKIPS = (4,)


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    """torch.nn.Linear's default init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * bound
    b = (torch.rand((fan_out,), generator=gen) * 2 - 1) * bound
    return {"w": w, "b": b}


def _linear(p, x, f32_out: bool = False):
    """`x @ w + b` in x's dtype, the f32 weights cast to it as the JAX
    package casts its params to the compute dtype. In bfloat16 the
    products accumulate in f32 and round once to bf16 (cuBLAS's bf16 GEMM
    on the card; on the CPU torch's bf16 matmul rounds otherwise, so
    there the product runs in f32 on the bf16 values and is rounded), then
    the bf16 bias is added. `f32_out`: the sum is cast to f32 at once, and
    XLA then adds the bias in f32 without rounding (measured on the CPU
    against the JAX package's bf16 transient feature)."""
    w, b = p["w"].to(x.dtype), p["b"].to(x.dtype)
    if x.dtype != torch.bfloat16:
        return x @ w + b
    z = x @ w if x.is_cuda else (x.float() @ w.float()).to(x.dtype)
    return z.float() + b.float() if f32_out else z + b


def init_nerf_params(
    generator: torch.Generator,
    typ: str = "fine",
    D: int = DEFAULT_D,
    W: int = DEFAULT_W,
    skips: Sequence[int] = DEFAULT_SKIPS,
    in_channels_xyz: int = 63,
    use_viewdir: bool = True,
    in_channels_dir: int = 27,
    encode_appearance: bool = False,
    in_channels_a: int = 48,
    encode_transient: bool = False,
    in_channels_t: int = 48,
    output_flow: bool = False,
    device="cuda",
) -> Params:
    """Build the parameter dict (f32). Draws come from `generator`, a CPU
    generator, so one seed gives the same weights on every device. The
    coarse model has no appearance and no flow heads."""
    dev = resolve_device(device)
    encode_appearance = False if typ == "coarse" else encode_appearance
    n_a = in_channels_a if encode_appearance else 0
    output_flow = encode_transient and output_flow and typ == "fine"

    p: Params = {}
    for i in range(D):
        fan_in = in_channels_xyz if i == 0 else (
            W + in_channels_xyz if i in skips else W)
        p[f"static_xyz_{i}"] = _linear_init(generator, fan_in, W)
    p["static_xyz_final"] = _linear_init(generator, W, W)
    if use_viewdir:
        p["static_dir"] = _linear_init(
            generator, W + in_channels_dir + n_a, W)
    p["static_sigma"] = _linear_init(generator, W, 1)
    p["static_rgb"] = _linear_init(generator, W, 3)

    if encode_transient:
        in_tr = in_channels_xyz + in_channels_t
        for i in range(D):
            fan_in = in_tr if i == 0 else (W + in_tr if i in skips else W)
            p[f"transient_xyz_{i}"] = _linear_init(generator, fan_in, W)
        p["transient_xyz_final"] = _linear_init(generator, W, W)
        p["transient_sigma"] = _linear_init(generator, W, 1)
        p["transient_rgb"] = _linear_init(generator, W, 3)
        if output_flow:
            p["transient_flow_fw"] = _linear_init(generator, W, 3)
            p["transient_flow_bw"] = _linear_init(generator, W, 3)
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in p.items()}


def _wide(h):
    """A head's input: bf16 features cast to float32, as the JAX package's
    `h.astype(float32)` (float32 or float64 stay as they are)."""
    return h.float() if h.dtype == torch.bfloat16 else h


def _tower(params: Params, prefix: str, inp, D: int, skips: Sequence[int]):
    """The D-layer ReLU tower with skip re-concatenation."""
    h = inp
    for i in range(D):
        if i in skips:
            h = torch.cat([inp, h], -1)
        h = torch.relu(_linear(params[f"{prefix}_{i}"], h))
    return h


def static_forward(params: Params, xyz_emb, dir_emb=None, a_emb=None,
                   sigma_only: bool = False, use_viewdir: bool = True,
                   D: int = DEFAULT_D, skips: Sequence[int] = DEFAULT_SKIPS,
                   compute_dtype=torch.float32):
    """Static branch. Returns (rgb, sigma_raw), or sigma_raw if
    `sigma_only`; both float32 (float64 in a float64 compute dtype)."""
    h = _tower(params, "static_xyz", xyz_emb.to(compute_dtype), D, skips)
    sigma = _linear(params["static_sigma"], _wide(h))[..., 0]
    if sigma_only:
        return sigma
    feat = _linear(params["static_xyz_final"], h)
    if use_viewdir:
        parts = [feat, dir_emb.to(compute_dtype)]
        if a_emb is not None:
            parts.append(a_emb.to(compute_dtype))
        feat = torch.relu(_linear(params["static_dir"], torch.cat(parts, -1)))
    rgb = torch.sigmoid(_linear(params["static_rgb"], _wide(feat)))
    return rgb, sigma


def transient_forward(params: Params, xyz_emb, t_emb,
                      output_flow: Tuple[str, ...] = (),
                      sigma_only: bool = False, flow_scale: float = 0.2,
                      D: int = DEFAULT_D,
                      skips: Sequence[int] = DEFAULT_SKIPS,
                      compute_dtype=torch.float32):
    """Transient branch. Returns a dict with 'sigma' (raw) and, unless
    `sigma_only`, 'rgb' and the requested 'flow_fw'/'flow_bw', all
    float32 (float64 in a float64 compute dtype)."""
    inp = torch.cat([xyz_emb, t_emb], -1).to(compute_dtype)
    h = _tower(params, "transient_xyz", inp, D, skips)
    feat = _linear(params["transient_xyz_final"], h, f32_out=True)
    out = {"sigma": _linear(params["transient_sigma"], feat)[..., 0]}
    if sigma_only:
        return out
    out["rgb"] = torch.sigmoid(_linear(params["transient_rgb"], feat))
    for f in ("fw", "bw"):
        if f in output_flow:
            out[f"flow_{f}"] = flow_scale * torch.tanh(
                _linear(params[f"transient_flow_{f}"], feat))
    return out


def init_embedding(generator: torch.Generator, n: int, dim: int,
                   device="cuda") -> torch.Tensor:
    """nn.Embedding's default init, N(0, 1), drawn on the CPU."""
    return torch.randn((n, dim), generator=generator).to(
        resolve_device(device))


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]

