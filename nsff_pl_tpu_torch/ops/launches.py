"""The launch counts of the port's kernel wrappers, by kernel name.

Each CUDA wrapper adds one to its own count where it launches its kernel,
by sample count (`fn.launches[S]`, or `fn.launches[branch][S]` for the
backward branches; the kernels take any S >= 1); `counts()` names the
launches at 128 samples by the kernel's name, always present, and those
at every other S counted since the last `reset()` as `<name>@<S>` (a
reader takes a missing key as 0).
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


def _by_s():
    """(name, {S: launches}) of every kernel wrapper."""
    rk, tck, mk, mtk, fck = _modules()
    bwd = rk.planar_nerf_train_bwd_cuda.launches
    fbwd = mtk.fused_nerf_train_bwd_cuda.launches
    return (("planar_eval_comp", rk.planar_eval_comp_cuda.launches),
            ("planar_nerf_train_fwd", rk.planar_nerf_train_fwd_cuda.launches),
            ("planar_nerf_train_bwd_static", bwd["static"]),
            ("planar_nerf_train_bwd_transient", bwd["transient"]),
            ("planar_compositor_fwd", tck.planar_compositor_fwd_cuda.launches),
            ("planar_compositor_bwd", tck.planar_compositor_bwd_cuda.launches),
            ("fused_nerf_eval", mk.fused_nerf_eval_cuda.launches),
            ("fused_nerf_train_bwd_static", fbwd["static"]),
            ("fused_nerf_train_bwd_transient", fbwd["transient"]),
            ("fused_compositing_fwd", fck.fused_compositing_fwd_cuda.launches),
            ("fused_compositing_bwd", fck.fused_compositing_bwd_cuda.launches))


def counts() -> Dict[str, int]:
    """Every wrapper's launch count: `<name>` at 128 samples, `<name>@<S>`
    at each other S counted."""
    out = {}
    for name, by_s in _by_s():
        out[name] = by_s[128]
        for S in sorted(by_s):
            if S != 128:
                out[f"{name}@{S}"] = by_s[S]
    return out


def reset() -> None:
    """Set every count to 0."""
    for _, by_s in _by_s():
        by_s.clear()
