"""Trainable packed-boundary NeRF evaluator: CUDA kernels + plain versions.

Port of `nsff_pl_tpu/ops/mlp_train_kernel.py::make_fused_nerf_train`. The
forward is the packed evaluator of `ops/mlp_kernel.py` ((N, S, 3) points
and per-ray embeddings -> (N, S, 16)); the backward is hand-written, one
pass per branch (static, transient) as the TPU kernel's
`_branch_bwd_host`: recompute the tower, backpropagate through the heads
and the tower with bf16 matmul inputs (every cotangent `dz` rounded to
bf16 before its products) and f32 accumulation, dW/db over all rows in
the padded weight layout, per-ray embedding gradients from the
ray-summed cotangents rounded to bf16, and the per-row xyz cotangent
through the positional encoding (`bf16(dxs) @ bf16(selector^T)`, summed
over both branches) unless `need_dxyz=False`, which skips that work.

Gradients reach every tower and head weight, xyz (the warped points are
xyz + flow(params)) and the per-ray embeddings. The weights are packed
once (`fn.pack`) for every evaluation of a step that shares them; the
transient heads are always packed with both flow columns and a call that
outputs one flow (or none) leaves exact zeros in the other's gradient.

`fused_nerf_train_bwd` launches `csrc/fused_nerf_train.cu` for CUDA
tensors and runs `fused_nerf_train_bwd_ref` for CPU tensors.

The backward takes a tower input (posenc [+ time latent]) of one 128-lane
segment. Past it the JAX `make_fused_nerf_train`'s gradient raises (its
weight packing is padded only), and so do the builder here and the
backward on either device (`check_train_width`); train such a model with
`train_backend='xla'`, the plain evaluators.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from types import SimpleNamespace
from typing import Dict, Tuple

import torch

from nsff_pl_tpu_torch.ops.mlp_kernel import (N_PACKED, check_train_width,
                                              fused_nerf_eval, packed_checks,
                                              packed_op_config,
                                              posenc_rows_xyz)
from nsff_pl_tpu_torch.ops.raymarch_kernel import (
    _SLOTS, MAX_FREQS, TRAIN_HEADS, _branch_bwd_rows, _check,
    _posenc_adjoint, _ptr, _slot_ptrs, branch_weight_names, check_cuda,
    pack_padded_weights, unpad_padded_grads)


def _branch_g_cols(branch: str, g: torch.Tensor, output_flow):
    """The branch's cotangent columns of the packed (N, S, 16) cotangent,
    as `_branch_bwd_rows` takes them: static (N*S, 4) [rgb, sigma];
    transient (N*S, 10) [rgb, sigma, fw, bw], zeros for a flow the call
    does not output."""
    g = g.reshape(-1, N_PACKED)
    if branch == "static":
        return g[:, 0:4]
    cols, c = [g[:, 4:8]], 8
    for f in TRAIN_HEADS:
        if f in output_flow:
            cols.append(g[:, c:c + 3])
            c += 3
        else:
            cols.append(g.new_zeros((g.shape[0], 3)))
    return torch.cat(cols, -1)


def fused_nerf_train_bwd_ref(branch: str, pw, xyz, dir_emb, a_emb, t_emb, g,
                             *, freqs, use_viewdir: bool, encode_a: bool,
                             output_flow, flow_scale: float, need_dxyz: bool,
                             D: int = 8, skips=(4,)):
    """One branch of the hand-written backward in plain PyTorch, from the
    cotangent `g` (N, S, 16) of the packed output. Returns {"dws": {name:
    {"w": padded f32 dW, "b": db}}} plus "ddir"/"da" (static) or "dt"
    (transient), and "dxyz" (N, S, 3) with `need_dxyz`."""
    n, S = xyz.shape[0], xyz.shape[1]
    static = branch == "static"
    xs, pe = posenc_rows_xyz(xyz, freqs)
    out, dinp = _branch_bwd_rows(
        branch, pw, pe, _branch_g_cols(branch, g, output_flow), S, dir_emb,
        a_emb, t_emb, xyz_w=3 + 6 * len(freqs),
        use_viewdir=use_viewdir and static, encode_a=encode_a and static,
        flow_scale=flow_scale, need_dinp=need_dxyz, D=D, skips=skips)
    if need_dxyz:
        out["dxyz"] = _posenc_adjoint(dinp, xs, freqs,
                                      round_ops=True).reshape(n, S, 3)
    return out


def fused_nerf_train_bwd_cuda(branch: str, pw, xyz, dir_emb, a_emb, t_emb, g,
                              *, freqs, use_viewdir: bool, encode_a: bool,
                              output_flow, flow_scale: float, need_dxyz: bool,
                              D: int = 8, skips=(4,)):
    """Launch `csrc/fused_nerf_train.cu` for one branch on the current
    stream (a per-ray chain kernel, the dW kernel and the fixed-order
    reductions); adds one to
    `fused_nerf_train_bwd_cuda.launches[branch][S]`.
    Same contract as `fused_nerf_train_bwd_ref`."""
    from nsff_pl_tpu_torch.ops import cuda_build

    if D != 8 or tuple(skips) != (4,):
        raise NotImplementedError("the CUDA kernels are built for D=8, skips=(4,)")
    if branch not in ("static", "transient"):
        raise ValueError(f"unknown branch {branch!r}")
    static = branch == "static"
    use_viewdir = use_viewdir and static
    encode_a = encode_a and use_viewdir
    n, dir_w, n_a, n_tau = packed_checks(
        xyz, dir_emb, a_emb, t_emb, freqs=freqs, use_viewdir=use_viewdir,
        encode_a=encode_a, encode_t=not static, backward=True)
    check_cuda(xyz, "the packed CUDA kernel (B4)")
    if n == 0:
        raise ValueError("no rays")
    S = xyz.shape[1]
    dev, f32 = xyz.device, torch.float32
    _check(g, "g", (n, S, N_PACKED), f32, dev)
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir, static_branch=True,
        encode_t=True)
    names = static_names if static else transient_names
    wp, bp = _slot_ptrs(pw, names, dev, len(TRAIN_HEADS) * 3 + 4, encode_a)
    dws = {name: {"w": torch.empty(pw[name]["w"].shape, dtype=f32, device=dev),
                  "b": torch.empty(pw[name]["b"].shape, dtype=f32, device=dev)}
           for name in names}
    out = {"dws": dws}
    if use_viewdir:
        out["ddir"] = torch.empty((n, dir_w), dtype=f32, device=dev)
    if encode_a:
        out["da"] = torch.empty((n, n_a), dtype=f32, device=dev)
    if not static:
        out["dt"] = torch.empty((n, n_tau), dtype=f32, device=dev)
    if need_dxyz:
        out["dxyz"] = torch.empty((n, S, 3), dtype=f32, device=dev)
    lib = cuda_build.load("fused_nerf_train")
    P, I = ctypes.c_void_p, ctypes.c_int
    size_fn = lib.nsff_fused_train_bwd_scratch_bytes
    size_fn.argtypes = [I] * 5
    size_fn.restype = ctypes.c_size_t
    scratch = torch.empty((int(size_fn(int(static), n, S, int(use_viewdir),
                                       int(encode_a))),),
                          dtype=torch.uint8, device=dev)
    dwp = (P * len(_SLOTS))()
    dbp = (P * len(_SLOTS))()
    for i, name in enumerate(_SLOTS):
        if name in dws:
            dwp[i] = dws[name]["w"].data_ptr()
            dbp[i] = dws[name]["b"].data_ptr()
    fn = lib.nsff_fused_train_bwd
    fn.argtypes = ([I] + [P] * 4 + [ctypes.POINTER(P)] * 2 + [P] + [I] * 2
                   + [ctypes.POINTER(P)] * 2 + [P] * 5 + [I] * 5
                   + [ctypes.POINTER(ctypes.c_float), I] + [I] * 2
                   + [ctypes.c_float, I, P])
    fn.restype = I
    cfreqs = (ctypes.c_float * MAX_FREQS)(*[float(f) for f in freqs])
    rc = fn(int(static), _ptr(xyz), _ptr(dir_emb) if use_viewdir else None,
            _ptr(a_emb) if encode_a else None,
            _ptr(t_emb) if not static else None, wp, bp, g.data_ptr(),
            int("fw" in output_flow), int("bw" in output_flow), dwp, dbp,
            _ptr(out.get("ddir")), _ptr(out.get("da")), _ptr(out.get("dt")),
            _ptr(out.get("dxyz")), scratch.data_ptr(), n, S,
            3 + 6 * len(freqs), dir_w, n_a, cfreqs, len(freqs),
            int(use_viewdir), int(encode_a), float(flow_scale), n_tau,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_nerf_train backward ({branch}) launch "
                           f"failed: cudaError {rc}")
    fused_nerf_train_bwd_cuda.launches[branch][S] += 1
    return out


# by branch and sample count
fused_nerf_train_bwd_cuda.launches = {"static": Counter(),
                                      "transient": Counter()}


def fused_nerf_train_bwd(branch, pw, xyz, dir_emb, a_emb, t_emb, g, **kw):
    """CUDA tensors launch the kernels; CPU tensors take the plain version.
    Either raises past one input segment."""
    check_train_width(3 + 6 * len(kw["freqs"]),
                      t_emb.shape[-1] if branch == "transient" else 0)
    if xyz.is_cuda:
        return fused_nerf_train_bwd_cuda(branch, pw, xyz, dir_emb, a_emb,
                                         t_emb, g, **kw)
    return fused_nerf_train_bwd_ref(branch, pw, xyz, dir_emb, a_emb, t_emb, g,
                                    **kw)


class _FusedNerfTrain(torch.autograd.Function):
    """The packed output of one evaluation; differentiable in the unpadded
    params (passed as the leaves named by `leaf_names`, so autograd reaches
    them), xyz and the per-ray embeddings. The packed weights `pw` travel
    beside them."""

    @staticmethod
    def forward(ctx, op, leaf_names, pw, xyz, dir_emb, a_emb, t_emb, *leaves):
        ctx.op, ctx.pw, ctx.leaf_names = op, pw, leaf_names
        ctx.save_for_backward(xyz, dir_emb, a_emb, t_emb)
        return fused_nerf_eval(pw, xyz, dir_emb, a_emb, t_emb, **op.kernel_kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        op = ctx.op
        xyz, dir_emb, a_emb, t_emb = ctx.saved_tensors
        kw = {k: op.kernel_kw[k] for k in (
            "freqs", "use_viewdir", "encode_a", "output_flow", "flow_scale",
            "D", "skips")}
        g = g.contiguous()
        dws, ddir, da, dt, dxyz = {}, None, None, None, None
        for branch in (["static"] if op.kernel_kw["static_branch"] else []) + (
                ["transient"] if op.kernel_kw["encode_t"] else []):
            r = fused_nerf_train_bwd(branch, ctx.pw, xyz, dir_emb, a_emb,
                                     t_emb, g, need_dxyz=op.need_dxyz, **kw)
            dws.update(r["dws"])
            ddir, da, dt = r.get("ddir", ddir), r.get("da", da), r.get("dt", dt)
            if op.need_dxyz:
                dxyz = r["dxyz"] if dxyz is None else dxyz + r["dxyz"]
        dparams = unpad_padded_grads(dws, op.weight_names, **op.pack_kw)
        grads = [dparams[name][part] for name, part in ctx.leaf_names]
        return (None, None, None, dxyz, ddir, da, dt, *grads)


def make_fused_nerf_train(
    n_samples: int,
    *,
    use_viewdir: bool,
    encode_a: bool,
    encode_t: bool,
    output_flow: Tuple[str, ...],
    n_emb_xyz: int = 10,
    s_emb_xyz: float = 9.0,
    n_emb_dir: int = 4,
    n_a: int = 48,
    n_tau: int = 48,
    flow_scale: float = 0.2,
    D: int = 8,
    skips=(4,),
    static_branch: bool = True,
    need_dxyz: bool = True,
):
    """Build fn(params, xyz, dir_emb, a_emb, t_emb, pw=None) -> (N, S, 16),
    packed exactly like `make_fused_nerf_eval`; differentiable in params,
    xyz and the per-ray embeddings.

    `need_dxyz=False` skips the xyz cotangent (its gradient is None):
    right only where the caller's xyz does not depend on trainable
    parameters, as at the main evaluation's ray-derived points. The
    warped evaluations (xyz + flow(params)) keep the default. `pw` takes
    weights already packed by `fn.pack` (once per step for every call
    that shares them); by default each call packs its own. Raises past one
    input segment, where the JAX function's gradient raises."""
    check_train_width(3 + 6 * n_emb_xyz, n_tau if encode_t else 0)
    weight_names, pack_kw, kernel_kw = packed_op_config(
        use_viewdir=use_viewdir, encode_a=encode_a, encode_t=encode_t,
        output_flow=output_flow, n_emb_xyz=n_emb_xyz, s_emb_xyz=s_emb_xyz,
        n_emb_dir=n_emb_dir, n_a=n_a, n_tau=n_tau, flow_scale=flow_scale,
        D=D, skips=skips, static_branch=static_branch)
    param_names = [n for n in weight_names if n != "transient_heads"] + (
        ["transient_sigma", "transient_rgb"]
        + [f"transient_flow_{f}" for f in TRAIN_HEADS] if encode_t else [])
    op = SimpleNamespace(weight_names=weight_names, pack_kw=pack_kw,
                         kernel_kw=kernel_kw, need_dxyz=need_dxyz)

    def pack(params):
        with torch.no_grad():
            return pack_padded_weights(params, weight_names, **pack_kw)

    def fn(params: Dict, xyz, dir_emb=None, a_emb=None, t_emb=None, pw=None):
        if xyz.shape[1] != n_samples:
            raise ValueError(f"xyz has {xyz.shape[1]} samples, evaluator "
                             f"built for {n_samples}")
        if encode_t and t_emb.shape[-1] != n_tau:
            raise ValueError(f"evaluator built for n_tau={n_tau}, t_emb has "
                             f"{t_emb.shape[-1]}")
        # a model without flow heads has no such leaves
        leaf_names = [(n, part) for n in param_names if n in params
                      for part in ("w", "b")]
        return _FusedNerfTrain.apply(
            op, leaf_names, pack(params) if pw is None else pw,
            xyz.contiguous(),
            dir_emb.contiguous() if kernel_kw["use_viewdir"] else None,
            a_emb.contiguous() if kernel_kw["encode_a"] else None,
            t_emb.contiguous() if encode_t else None,
            *[params[n][part] for n, part in leaf_names])

    fn.weight_names = weight_names
    fn.pack_kw = pack_kw
    fn.kernel_kw = kernel_kw
    fn.need_dxyz = need_dxyz
    fn.pack = pack
    return fn
