"""The launch counts of the port's kernel wrappers, by kernel name.

Each CUDA wrapper adds one to its own count where it launches its kernel
(`fn.launches`, or `fn.launches[branch]` for the two backward branches).
The planar kernels' wrappers count by sample count (`fn.launches[S]`);
`counts()` names their launches at 128 samples by the kernel's name and
those at another S as `<name>@<S>`.
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


def _planar():
    """(name, {S: launches}) of the planar kernels' wrappers."""
    rk, tck, _, _, _ = _modules()
    bwd = rk.planar_nerf_train_bwd_cuda.launches
    return (("planar_eval_comp", rk.planar_eval_comp_cuda.launches),
            ("planar_nerf_train_fwd", rk.planar_nerf_train_fwd_cuda.launches),
            ("planar_nerf_train_bwd_static", bwd["static"]),
            ("planar_nerf_train_bwd_transient", bwd["transient"]),
            ("planar_compositor_fwd", tck.planar_compositor_fwd_cuda.launches),
            ("planar_compositor_bwd", tck.planar_compositor_bwd_cuda.launches))


def counts() -> Dict[str, int]:
    """Every wrapper's launch count."""
    rk, tck, mk, mtk, fck = _modules()
    out = {}
    for name, by_s in _planar():
        for S in rk.PLANAR_SAMPLES:
            out[name if S == 128 else f"{name}@{S}"] = by_s[S]
    out.update({
        "fused_nerf_eval": mk.fused_nerf_eval_cuda.launches,
        "fused_nerf_train_bwd_static":
            mtk.fused_nerf_train_bwd_cuda.launches["static"],
        "fused_nerf_train_bwd_transient":
            mtk.fused_nerf_train_bwd_cuda.launches["transient"],
        "fused_compositing_fwd": fck.fused_compositing_fwd_cuda.launches,
        "fused_compositing_bwd": fck.fused_compositing_bwd_cuda.launches})
    return out


def reset() -> None:
    """Set every count to 0."""
    _, _, mk, mtk, fck = _modules()
    for _, by_s in _planar():
        by_s.clear()
    mk.fused_nerf_eval_cuda.launches = 0
    mtk.fused_nerf_train_bwd_cuda.launches = {"static": 0, "transient": 0}
    fck.fused_compositing_fwd_cuda.launches = 0
    fck.fused_compositing_bwd_cuda.launches = 0
