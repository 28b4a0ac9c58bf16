"""The no-grad evaluators B1 and B5, and B2's forward, as PyTorch custom
ops, so that `torch.export` can hold a kernel call as one node of its
graph:

    torch.ops.nsff_torch.planar_eval_comp       (ops/raymarch_kernel.py, B1)
    torch.ops.nsff_torch.fused_nerf_eval        (ops/mlp_kernel.py, B5)
    torch.ops.nsff_torch.planar_nerf_train_fwd  (ops/raymarch_kernel.py,
                                                 B2's forward)

The packed weights go in as two tensor lists, `weights` (bf16) and
`biases` (f32), holding the slots of `raymarch_kernel._SLOTS` that the
configuration has, in that order; `slots` gives their indices there.
The kernel's configuration goes in as ints, floats, bools and int and
float lists (B5's and B2's `output_flow` as two bools; B2's `flows` a
tensor list, empty for none). The implementation is the wrapper's: CUDA
tensors launch the kernel (`planar_eval_comp_cuda` / `fused_nerf_eval_cuda` /
`planar_nerf_train_fwd_cuda`, which count their launches), CPU tensors
run the plain version; a failed build or launch raises. `register_fake`
gives the output's shape, (N, n_map), (N, S, 16) and (n_planes, N, S)
float32.

The wrappers `raymarch_kernel.planar_eval_comp`,
`mlp_kernel.fused_nerf_eval` and `raymarch_kernel.planar_nerf_train_fwd`
call these ops while `torch.export` traces them
(`torch.compiler.is_exporting()`), and launch directly otherwise. B2's
forward is reached through `_PlanarNerfTrain.apply`, which under
`torch.no_grad()` runs its forward alone: the exported graph holds the
op node and no backward.
A program exported with them loads after `import
nsff_pl_tpu_torch.ops.library`, which registers the ops.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from nsff_pl_tpu_torch.ops import mlp_kernel as mk
from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

NAMESPACE = "nsff_torch"


def slot_lists(pw):
    """Packed weights {name: {"w", "b"}} -> (weights, biases, slots) in
    `_SLOTS` order."""
    slots = [i for i, name in enumerate(rk._SLOTS) if name in pw]
    return ([pw[rk._SLOTS[i]]["w"] for i in slots],
            [pw[rk._SLOTS[i]]["b"] for i in slots], slots)


def _output_flow(flow_fw: bool, flow_bw: bool):
    return tuple(f for f, on in (("fw", flow_fw), ("bw", flow_bw)) if on)


def _slot_dict(weights, biases, slots):
    return {rk._SLOTS[i]: {"w": w, "b": b}
            for i, w, b in zip(slots, weights, biases)}


@torch.library.custom_op(f"{NAMESPACE}::planar_eval_comp", mutates_args=())
def planar_eval_comp(
        weights: List[Tensor], biases: List[Tensor], slots: List[int],
        o: Tensor, d: Tensor, zs: Tensor, vis: Optional[Tensor],
        dir_emb: Optional[Tensor], a_emb: Optional[Tensor],
        t_emb: Optional[Tensor], freqs: List[float], encode_t: bool,
        flow_maps: bool, use_viewdir: bool, encode_a: bool, z_far: float,
        flow_scale: float, n_tau: int, n_map: int, D: int,
        skips: List[int]) -> Tensor:
    """B1: (N, n_map) f32 maps (`raymarch_kernel.planar_eval_comp_ref`
    has the function)."""
    fn = rk.planar_eval_comp_cuda if o.is_cuda else rk.planar_eval_comp_ref
    return fn(_slot_dict(weights, biases, slots), o, d, zs, vis, dir_emb,
              a_emb, t_emb, freqs=tuple(freqs), encode_t=encode_t,
              flow_maps=flow_maps, use_viewdir=use_viewdir,
              encode_a=encode_a, z_far=z_far, flow_scale=flow_scale,
              n_tau=n_tau, n_map=n_map, D=D, skips=tuple(skips))


@planar_eval_comp.register_fake
def _(weights, biases, slots, o, d, zs, vis, dir_emb, a_emb, t_emb, freqs,
      encode_t, flow_maps, use_viewdir, encode_a, z_far, flow_scale, n_tau,
      n_map, D, skips):
    return o.new_empty((o.shape[0], n_map), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::fused_nerf_eval", mutates_args=())
def fused_nerf_eval(
        weights: List[Tensor], biases: List[Tensor], slots: List[int],
        xyz: Tensor, dir_emb: Optional[Tensor], a_emb: Optional[Tensor],
        t_emb: Optional[Tensor], freqs: List[float], static_branch: bool,
        use_viewdir: bool, encode_a: bool, encode_t: bool, flow_fw: bool,
        flow_bw: bool, flow_scale: float, D: int,
        skips: List[int]) -> Tensor:
    """B5: (N, S, 16) f32 packed rows (`mlp_kernel.fused_nerf_eval_ref`
    has the function); `flow_fw` / `flow_bw` are its `output_flow`."""
    output_flow = _output_flow(flow_fw, flow_bw)
    fn = mk.fused_nerf_eval_cuda if xyz.is_cuda else mk.fused_nerf_eval_ref
    return fn(_slot_dict(weights, biases, slots), xyz, dir_emb, a_emb,
              t_emb, freqs=tuple(freqs), static_branch=static_branch,
              use_viewdir=use_viewdir, encode_a=encode_a, encode_t=encode_t,
              output_flow=output_flow, flow_scale=flow_scale, D=D,
              skips=tuple(skips))


@fused_nerf_eval.register_fake
def _(weights, biases, slots, xyz, dir_emb, a_emb, t_emb, freqs,
      static_branch, use_viewdir, encode_a, encode_t, flow_fw, flow_bw,
      flow_scale, D, skips):
    return xyz.new_empty((xyz.shape[0], xyz.shape[1], mk.N_PACKED),
                         dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::planar_nerf_train_fwd",
                         mutates_args=())
def planar_nerf_train_fwd(
        weights: List[Tensor], biases: List[Tensor], slots: List[int],
        o: Tensor, d: Tensor, zs: Tensor, flows: List[Tensor],
        dir_emb: Optional[Tensor], a_emb: Optional[Tensor],
        t_emb: Optional[Tensor], freqs: List[float], static_branch: bool,
        use_viewdir: bool, encode_a: bool, encode_t: bool, flow_fw: bool,
        flow_bw: bool, flow_scale: float, D: int,
        skips: List[int]) -> Tensor:
    """B2's forward: (n_planes, N, S) f32 planes in `planar_out_keys`
    order (`raymarch_kernel.planar_nerf_train_ref` has the function);
    `flows` holds the three flow planes, or nothing."""
    fn = (rk.planar_nerf_train_fwd_cuda if o.is_cuda
          else rk.planar_nerf_train_ref)
    return fn(_slot_dict(weights, biases, slots), o, d, zs,
              tuple(flows) if flows else None, dir_emb, a_emb,
              t_emb, freqs=tuple(freqs), static_branch=static_branch,
              use_viewdir=use_viewdir, encode_a=encode_a, encode_t=encode_t,
              output_flow=_output_flow(flow_fw, flow_bw),
              flow_scale=flow_scale, D=D, skips=tuple(skips))


@planar_nerf_train_fwd.register_fake
def _(weights, biases, slots, o, d, zs, flows, dir_emb, a_emb, t_emb, freqs,
      static_branch, use_viewdir, encode_a, encode_t, flow_fw, flow_bw,
      flow_scale, D, skips):
    n_planes = len(rk.planar_out_keys(
        static_branch=static_branch, encode_t=encode_t,
        output_flow=_output_flow(flow_fw, flow_bw)))
    return zs.new_empty((n_planes, zs.shape[0], zs.shape[1]),
                        dtype=torch.float32)


def call_planar_eval_comp(pw, o, d, zs, vis, dir_emb, a_emb, t_emb, *,
                          freqs, skips, **kw) -> Tensor:
    """`raymarch_kernel.planar_eval_comp`'s arguments -> the op."""
    return planar_eval_comp(*slot_lists(pw), o, d, zs, vis, dir_emb, a_emb,
                            t_emb, freqs=list(freqs), skips=list(skips), **kw)


def call_fused_nerf_eval(pw, xyz, dir_emb, a_emb, t_emb, *, freqs, skips,
                         output_flow, **kw) -> Tensor:
    """`mlp_kernel.fused_nerf_eval`'s arguments -> the op."""
    return fused_nerf_eval(*slot_lists(pw), xyz, dir_emb, a_emb, t_emb,
                           freqs=list(freqs), skips=list(skips),
                           flow_fw="fw" in output_flow,
                           flow_bw="bw" in output_flow, **kw)


def call_planar_nerf_train_fwd(pw, o, d, zs, flows, dir_emb, a_emb, t_emb,
                               *, freqs, skips, output_flow, **kw) -> Tensor:
    """`raymarch_kernel.planar_nerf_train_fwd`'s arguments -> the op."""
    return planar_nerf_train_fwd(
        *slot_lists(pw), o, d, zs,
        list(flows) if flows is not None else [], dir_emb, a_emb, t_emb,
        freqs=list(freqs), skips=list(skips), flow_fw="fw" in output_flow,
        flow_bw="bw" in output_flow, **kw)
