"""Render configuration and the test-time dispatch of `render_rays` (port
of the parts of `nsff_pl_tpu/models/rendering.py` the planar paths run).

Only the planar paths are ported: with `planar_eval_decision` engaged,
`render_rays` hands the rays to `models/raymarch.py::render_test_planar`;
training renders through `models/raymarch.py::render_train_planar`. The
reference-shaped packed path (the JAX package's XLA and packed-kernel
evaluators) is not ported yet (ROADMAP.md queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Z_FAR = 0.95  # flow is zeroed beyond this NDC depth


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (the fields the planar paths read;
    names and defaults as in the JAX package)."""
    N_samples: int = 128
    N_importance: int = 0
    perturb: float = 1.0
    noise_std: float = 1.0
    use_viewdir: bool = False
    encode_a: bool = False
    encode_t: bool = False
    flow_scale: float = 0.2
    max_t: int = 29  # N_frames - 1
    N_emb_xyz: int = 10
    S_emb_xyz: float = 9.0
    N_emb_dir: int = 4
    S_emb_dir: float = 3.0
    N_tau: int = 48
    N_a: int = 48
    img_wh: Tuple[int, int] = (512, 288)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # train backend: 'auto' = the hand-written kernels on a CUDA device
    # with bfloat16 compute (the JAX package's Pallas backend on a TPU);
    # 'pallas' forces them (the plain versions on CPU tensors)
    train_backend: str = "auto"
    # the fused three-way compositor of the planar train path: 'auto' and
    # 'on' use it (its plain version on CPU tensors); 'off' (compositing
    # outside the kernel) is not ported
    planar_compositing: str = "auto"
    # planar train path: 'auto' = whenever the train backend is active and
    # the configuration is in its envelope; 'on' forces it; 'off' (the
    # packed-boundary path) is not ported
    fused_train: str = "auto"
    # warp-evaluation subsampling / importance selection of the planar
    # train path; only the exact values (1, 0.0) are ported
    warp_subsample: int = 1
    warp_importance: float = 0.0
    # planar test-time path: 'auto' = on a CUDA device with bfloat16
    # compute (the JAX package's "TPU + bfloat16"); 'on' forces it (the
    # plain version on CPU tensors)
    planar_eval: str = "auto"


def planar_eval_decision(cfg: RenderConfig, device) -> Tuple[bool, list]:
    """Whether the planar test path serves a render on `device`, and why
    not otherwise. Returns (engaged, reasons)."""
    if cfg.planar_eval == "on":
        return True, []
    if cfg.planar_eval != "auto":
        raise ValueError(f"unknown planar_eval {cfg.planar_eval!r}")
    if (torch.device(device).type == "cuda"
            and cfg.compute_dtype == "bfloat16"):
        return True, []
    return False, ["planar_eval='auto' takes the kernel path only on a CUDA "
                   "device with bfloat16 compute (pass planar_eval='on' to "
                   "force it)"]


def render_rays(
    params: Dict[str, Dict],
    embeddings: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    ts: Optional[torch.Tensor],
    cfg: RenderConfig,
    *,
    output_transient: bool = True,
    output_transient_flow: Tuple[str, ...] = (),
    vis_poses=None,
    vis_K=None,
    view_dir: Optional[torch.Tensor] = None,
    keys: Optional[Tuple[str, ...]] = None,
) -> Dict[str, torch.Tensor]:
    """Test-time render of a batch of (N, 6) NDC rays at frame indices `ts`
    (no random draws: perturb and sigma noise are 0 at test time).

    params: {'fine': ...}; embeddings: {'a'?, 't'?} (N_frames, C) tables;
    vis_poses/vis_K enable transient visibility culling; `view_dir`
    overrides the (N, 3) directions of the view embedding; `keys` filters
    the result (and picks the composited route)."""
    output_transient = output_transient and cfg.encode_t
    flow = tuple(output_transient_flow) if output_transient else ()
    engaged, reasons = planar_eval_decision(cfg, rays.device)
    if not engaged:
        raise NotImplementedError(
            "the packed-boundary render path is not ported yet (ROADMAP.md "
            "queue A, 'f32 / packed render path'); the planar path does not "
            f"serve this render: {'; '.join(reasons)}")
    from nsff_pl_tpu_torch.models import raymarch

    out = raymarch.render_test_planar(
        params["fine"], embeddings, rays, ts, cfg,
        output_transient=output_transient, output_transient_flow=flow,
        vis_poses=vis_poses, vis_K=vis_K, view_dir=view_dir, keys=keys)
    if keys is not None:
        out = {k: v for k, v in out.items() if k in keys}
    return out
