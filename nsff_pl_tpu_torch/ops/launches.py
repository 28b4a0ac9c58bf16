"""The launch counts of the port's kernel wrappers, by kernel name.

Each CUDA wrapper adds one to its own count where it launches its kernel
(`fn.launches`, or `fn.launches[branch]` for the two backward branches).
A wrapper called while a CUDA graph is captured counts the launch it
records; a replay of the graph calls no wrapper and adds nothing, so a
graphed dispatch reads its launches as the capture's counts times its
replays (`training/step.py`, `graph_launches` and `replays`).
"""
from __future__ import annotations

from typing import Dict


def _modules():
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    return rk, tck, mk, mtk, fck


def counts() -> Dict[str, int]:
    """Every wrapper's launch count."""
    rk, tck, mk, mtk, fck = _modules()
    return {"planar_eval_comp": rk.planar_eval_comp_cuda.launches,
            "planar_nerf_train_fwd": rk.planar_nerf_train_fwd_cuda.launches,
            "planar_nerf_train_bwd_static":
                rk.planar_nerf_train_bwd_cuda.launches["static"],
            "planar_nerf_train_bwd_transient":
                rk.planar_nerf_train_bwd_cuda.launches["transient"],
            "planar_compositor_fwd": tck.planar_compositor_fwd_cuda.launches,
            "planar_compositor_bwd": tck.planar_compositor_bwd_cuda.launches,
            "fused_nerf_eval": mk.fused_nerf_eval_cuda.launches,
            "fused_nerf_train_bwd_static":
                mtk.fused_nerf_train_bwd_cuda.launches["static"],
            "fused_nerf_train_bwd_transient":
                mtk.fused_nerf_train_bwd_cuda.launches["transient"],
            "fused_compositing_fwd": fck.fused_compositing_fwd_cuda.launches,
            "fused_compositing_bwd": fck.fused_compositing_bwd_cuda.launches}


def reset() -> None:
    """Set every count to 0."""
    rk, tck, mk, mtk, fck = _modules()
    rk.planar_eval_comp_cuda.launches = 0
    rk.planar_nerf_train_fwd_cuda.launches = 0
    rk.planar_nerf_train_bwd_cuda.launches = {"static": 0, "transient": 0}
    tck.planar_compositor_fwd_cuda.launches = 0
    tck.planar_compositor_bwd_cuda.launches = 0
    mk.fused_nerf_eval_cuda.launches = 0
    mtk.fused_nerf_train_bwd_cuda.launches = {"static": 0, "transient": 0}
    fck.fused_compositing_fwd_cuda.launches = 0
    fck.fused_compositing_bwd_cuda.launches = 0
