"""Configuration (port of the `NSFFConfig` fields the serving and
training paths read, from `nsff_pl_tpu/config.py`, and of
`nsff_pl_tpu/training/trainer.py::render_config` / `build_params`).

Field names and defaults match the JAX package so a configuration reads
the same in both. Scene, checkpoint, logging and distributed fields
arrive with the slices that read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Tuple

from nsff_pl_tpu_torch.models.rendering import RenderConfig


@dataclass
class NSFFConfig:
    img_wh: Tuple[int, int] = (512, 288)
    start_end: Tuple[int, int] = (0, 100)
    use_viewdir: bool = False
    N_samples: int = 128
    N_importance: int = 0
    N_emb_xyz: int = 10
    S_emb_xyz: float = 9.0
    N_emb_dir: int = 4
    S_emb_dir: float = 3.0
    perturb: float = 1.0
    noise_std: float = 1.0
    encode_a: bool = False
    N_a: int = 48
    encode_t: bool = False
    N_tau: int = 48
    lambda_geo_init: float = 0.04
    thickness: int = 1
    flow_scale: float = 0.2
    # training
    batch_size: int = 512
    num_epochs: int = 16
    hard_sampling: bool = False
    optimizer: str = "adam"
    lr: float = 5e-4
    topk: float = 1.0
    weight_decay: float = 0.0
    lr_scheduler: str = "steplr"
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    decay_step: List[int] = field(default_factory=lambda: [20])
    decay_gamma: float = 0.1
    poly_exp: float = 0.9
    planar_eval: str = "auto"
    mlp_backend: str = "auto"
    train_backend: str = "auto"
    fused_train: str = "auto"
    fused_compositing: bool = False
    warp_subsample: int = 1
    warp_importance: float = 0.0
    dtype: str = "float32"  # compute dtype: 'float32' | 'bfloat16'
    seed: int = 42

    @property
    def N_frames(self) -> int:
        return self.start_end[1] - self.start_end[0]

    @property
    def in_channels_xyz(self) -> int:
        return 6 * self.N_emb_xyz + 3

    @property
    def in_channels_dir(self) -> int:
        return 6 * self.N_emb_dir + 3

    @property
    def output_transient(self) -> bool:
        return self.encode_t

    @property
    def output_transient_flow(self) -> List[str]:
        return ["fw", "bw", "disocc"] if self.encode_t else []

    def replace(self, **kw) -> "NSFFConfig":
        return dataclasses.replace(self, **kw)


def render_config(cfg: NSFFConfig) -> RenderConfig:
    return RenderConfig(
        N_samples=cfg.N_samples, N_importance=cfg.N_importance,
        perturb=cfg.perturb, noise_std=cfg.noise_std,
        use_viewdir=cfg.use_viewdir, encode_a=cfg.encode_a,
        encode_t=cfg.encode_t, flow_scale=cfg.flow_scale,
        max_t=cfg.N_frames - 1,
        N_emb_xyz=cfg.N_emb_xyz, S_emb_xyz=cfg.S_emb_xyz,
        N_emb_dir=cfg.N_emb_dir, S_emb_dir=cfg.S_emb_dir,
        img_wh=tuple(cfg.img_wh), compute_dtype=cfg.dtype,
        train_backend=cfg.train_backend, fused_train=cfg.fused_train,
        N_tau=cfg.N_tau, N_a=cfg.N_a,
        warp_subsample=cfg.warp_subsample,
        warp_importance=cfg.warp_importance, planar_eval=cfg.planar_eval,
        mlp_backend=cfg.mlp_backend, fused_compositing=cfg.fused_compositing)


def loss_config(cfg: NSFFConfig):
    from nsff_pl_tpu_torch.training.loss import LossConfig

    return LossConfig(lambda_geo_init=cfg.lambda_geo_init,
                      thickness=cfg.thickness, topk=cfg.topk,
                      max_t=cfg.N_frames - 1)


def build_params(cfg: NSFFConfig, generator, device="cuda"):
    """Initialize the full parameter dict (port of
    `nsff_pl_tpu/training/trainer.py::build_params`, same keys); draws
    come from the CPU `generator` in a fixed order."""
    from nsff_pl_tpu_torch.models import nerf as nerf_m

    params = {"nerf_fine": nerf_m.init_nerf_params(
        generator, "fine", in_channels_xyz=cfg.in_channels_xyz,
        use_viewdir=cfg.use_viewdir, in_channels_dir=cfg.in_channels_dir,
        encode_appearance=cfg.encode_a, in_channels_a=cfg.N_a,
        encode_transient=cfg.encode_t, in_channels_t=cfg.N_tau,
        output_flow=len(cfg.output_transient_flow) > 0, device=device)}
    if cfg.N_importance > 0:
        params["nerf_coarse"] = nerf_m.init_nerf_params(
            generator, "coarse", in_channels_xyz=cfg.in_channels_xyz,
            use_viewdir=cfg.use_viewdir, in_channels_dir=cfg.in_channels_dir,
            encode_transient=cfg.encode_t, in_channels_t=cfg.N_tau,
            device=device)
    if cfg.encode_a:
        params["embedding_a"] = nerf_m.init_embedding(
            generator, cfg.N_frames, cfg.N_a, device=device)
    if cfg.encode_t:
        params["embedding_t"] = nerf_m.init_embedding(
            generator, cfg.N_frames, cfg.N_tau, device=device)
    return params
