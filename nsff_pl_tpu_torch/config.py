"""Configuration (port of `nsff_pl_tpu/config.py` and of
`nsff_pl_tpu/training/trainer.py::render_config` / `build_params`).

Every `NSFFConfig` field of the JAX package, with its name and default,
and the training CLI's flags (`add_train_args`, `get_opts`) with the same
names, defaults and choices; the port adds `fused_compositing` and the
flags `--fused_compositing`, `--val_every_steps`, `--log_dir` and
`--ckpt_dir`. Options
whose features are not ported parse, and raise `NotImplementedError`
naming their ROADMAP item where they are used.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from nsff_pl_tpu_torch.models.rendering import RenderConfig


@dataclass
class NSFFConfig:
    # ---- dataset (opt.py:6-16) ----
    root_dir: str = ""
    cache_dir: str = ""
    dataset_name: str = "monocular"
    img_wh: Tuple[int, int] = (512, 288)
    start_end: Tuple[int, int] = (0, 100)

    # ---- original NeRF parameters (opt.py:19-36) ----
    use_viewdir: bool = False
    N_samples: int = 128
    N_importance: int = 0
    N_emb_xyz: int = 10
    S_emb_xyz: float = 9.0
    N_emb_dir: int = 4
    S_emb_dir: float = 3.0
    perturb: float = 1.0
    noise_std: float = 1.0

    # ---- NeRF-W / NSFF parameters (opt.py:39-52) ----
    encode_a: bool = False
    N_a: int = 48
    encode_t: bool = False
    N_tau: int = 48
    lambda_geo_init: float = 0.04
    thickness: int = 1
    flow_scale: float = 0.2

    # ---- training (opt.py:54-61) ----
    batch_size: int = 512
    chunk: int = 32 * 1024
    num_epochs: int = 16
    hard_sampling: bool = False

    # ---- distributed (opt.py:63-66): data-parallel training over
    # torch.distributed (`parallel/`) ----
    num_gpus: int = 1
    num_nodes: int = 1
    coordinator_address: str = ""
    node_rank: int = -1

    # ---- checkpointing (opt.py:68-73) ----
    ckpt_path: Optional[str] = None
    prefixes_to_ignore: List[str] = field(default_factory=lambda: ["loss"])
    weight_path: Optional[str] = None

    # ---- optimizer / scheduler (opt.py:75-103) ----
    optimizer: str = "adam"
    lr: float = 5e-4
    topk: float = 1.0
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_scheduler: str = "steplr"
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    decay_step: List[int] = field(default_factory=lambda: [20])
    decay_gamma: float = 0.1
    poly_exp: float = 0.9

    # ---- misc (opt.py:107-112) ----
    exp_name: str = "exp"
    refresh_every: int = 1
    debug: bool = False

    # ---- kernel knobs (the JAX package's names; 'pallas' selects the
    # port's CUDA kernels, 'xla' the plain evaluators) ----
    mlp_backend: str = "auto"  # eval backend: 'auto' | 'xla' | 'pallas'
    # planar no-grad eval path (models/raymarch.py::render_test_planar):
    # 'auto' = whenever the kernel eval backend is active and the config
    # fits the planar envelope; 'off' = packed eval kernel path
    planar_eval: str = "auto"
    # train backend: 'auto' | 'xla' | 'pallas' | 'stub' (a profiling
    # stand-in of the field on the packed path, models/rendering.py)
    train_backend: str = "auto"
    # planar fused train path (dense (N,S) kernel boundaries,
    # models/raymarch.py): 'auto' | 'on' | 'off'
    fused_train: str = "auto"
    # packed path: composite in the fused compositing kernel (B6)
    fused_compositing: bool = False
    # warp-evaluation subsampling on the planar path: 1 = exact (both
    # warp directions per ray), 2 = one direction per ray at 2x loss
    # weight (~25% train FLOP cut; see RenderConfig.warp_subsample)
    warp_subsample: int = 1
    # importance-concentrated warp evaluation on the planar path:
    # 0 = off (exact); f in (0, 1] evaluates BOTH warp directions on
    # K = round(f*batch) rays drawn by transient-weight importance with
    # unbiased Horvitz-Thompson loss weighting (~25% train FLOP cut at
    # f=0.5; see RenderConfig.warp_importance)
    warp_importance: float = 0.0
    dtype: str = "float32"  # compute dtype for MLP matmuls: 'float32'|'bfloat16'
    seed: int = 42
    log_dir: str = "logs"
    ckpt_dir: str = "ckpts"
    val_every_steps: int = 0  # 0 => validate once per epoch (reference behavior)
    # a torch.profiler trace of steps 10-15 under this directory (forces
    # scan_steps to 1; utils/profiling.py)
    profile_dir: str = ""
    # train steps per dispatch: one CUDA graph of K steps on the card
    # (training/step.py::_MultiStep); per-step semantics are unchanged
    scan_steps: int = 1
    # the JAX package's compilation cache; parsed, unused by the port
    jax_cache_dir: str = ""
    # wall-clock budget in seconds (0 = unlimited): fit() checkpoints and
    # returns at the first group boundary past the budget; resume with
    # --ckpt_path
    time_budget_s: float = 0.0

    # ------------------------------------------------------------------
    @property
    def N_frames(self) -> int:
        """Number of frames (train.py:51)."""
        return self.start_end[1] - self.start_end[0]

    @property
    def in_channels_xyz(self) -> int:
        """6*N_emb_xyz+3 (train.py:66)."""
        return 6 * self.N_emb_xyz + 3

    @property
    def in_channels_dir(self) -> int:
        """6*N_emb_dir+3 (train.py:68)."""
        return 6 * self.N_emb_dir + 3

    @property
    def output_transient(self) -> bool:
        """train.py:61 — transient output follows encode_t."""
        return self.encode_t

    @property
    def output_transient_flow(self) -> List[str]:
        """train.py:62 — flow heads + disocc when encode_t."""
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


def add_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The training CLI surface, flag for flag with the JAX package's
    (and the reference `opt.py:3-114`), plus `--fused_compositing`,
    `--val_every_steps`, `--log_dir` and `--ckpt_dir`."""
    d = NSFFConfig()
    parser.add_argument("--root_dir", type=str, required=True,
                        help="root directory of dataset")
    parser.add_argument("--cache_dir", type=str, default=d.cache_dir,
                        help="cache directory")
    parser.add_argument("--dataset_name", type=str, default="monocular",
                        choices=["monocular"], help="which dataset to train/val")
    parser.add_argument("--img_wh", nargs="+", type=int, default=list(d.img_wh),
                        help="resolution (img_w, img_h) of the image")
    parser.add_argument("--start_end", nargs="+", type=int, default=list(d.start_end),
                        help="start and end frames (end is excluded)")

    parser.add_argument("--use_viewdir", default=False, action="store_true",
                        help="whether to use view dependency in static network")
    parser.add_argument("--N_samples", type=int, default=d.N_samples,
                        help="number of coarse samples")
    parser.add_argument("--N_importance", type=int, default=d.N_importance,
                        help="number of additional fine samples")
    parser.add_argument("--N_emb_xyz", type=int, default=d.N_emb_xyz,
                        help="number of features in xyz embedding")
    parser.add_argument("--S_emb_xyz", type=float, default=d.S_emb_xyz,
                        help="max frequency in xyz embedding")
    parser.add_argument("--N_emb_dir", type=int, default=d.N_emb_dir,
                        help="number of features in dir embedding")
    parser.add_argument("--S_emb_dir", type=float, default=d.S_emb_dir,
                        help="max frequency in dir embedding")
    parser.add_argument("--perturb", type=float, default=d.perturb,
                        help="factor to perturb depth sampling points")
    parser.add_argument("--noise_std", type=float, default=d.noise_std,
                        help="std dev of noise added to regularize sigma")

    parser.add_argument("--encode_a", default=False, action="store_true",
                        help="whether to encode appearance (NeRF-A)")
    parser.add_argument("--N_a", type=int, default=d.N_a,
                        help="number of embeddings for appearance")
    parser.add_argument("--encode_t", default=False, action="store_true",
                        help="whether to encode transient object (NeRF-U)")
    parser.add_argument("--N_tau", type=int, default=d.N_tau,
                        help="number of embeddings for transient objects")
    parser.add_argument("--lambda_geo_init", type=float, default=d.lambda_geo_init,
                        help="2d-3d flow consistency loss coefficient")
    parser.add_argument("--thickness", type=int, default=d.thickness,
                        help="prior about dynamic object thickness")
    parser.add_argument("--flow_scale", type=float, default=d.flow_scale,
                        help="flow scale to multiply to flow network output")

    parser.add_argument("--batch_size", type=int, default=d.batch_size)
    parser.add_argument("--chunk", type=int, default=d.chunk,
                        help="chunk size to split the input to avoid OOM")
    parser.add_argument("--num_epochs", type=int, default=d.num_epochs)
    parser.add_argument("--hard_sampling", default=False, action="store_true",
                        help="sample hard rays more according to SSIM")

    parser.add_argument("--num_gpus", type=int, default=1,
                        help="GPUs per node: one rank each, data-parallel "
                             "over rays (training only)")
    parser.add_argument("--num_nodes", type=int, default=1,
                        help="nodes to train data-parallel across")
    parser.add_argument("--coordinator_address", type=str,
                        default=d.coordinator_address,
                        help="host:port of node 0 for multi-node "
                             "bootstrap")
    parser.add_argument("--node_rank", type=int, default=d.node_rank,
                        help="this process's rank when "
                             "--coordinator_address is set")

    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="pretrained checkpoint to load (including optimizers, etc)")
    parser.add_argument("--prefixes_to_ignore", nargs="+", type=str, default=["loss"])
    parser.add_argument("--weight_path", type=str, default=None,
                        help="pretrained weight to load (do not load optimizers, etc)")

    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["sgd", "adam", "radam", "ranger"])
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--topk", type=float, default=d.topk,
                        help="propagate loss only for the topk hard examples")
    parser.add_argument("--momentum", type=float, default=d.momentum)
    parser.add_argument("--weight_decay", type=float, default=d.weight_decay)
    parser.add_argument("--lr_scheduler", type=str, default="steplr",
                        choices=["const", "steplr", "cosine", "poly"])
    parser.add_argument("--warmup_multiplier", type=float, default=d.warmup_multiplier)
    parser.add_argument("--warmup_epochs", type=int, default=d.warmup_epochs)
    parser.add_argument("--decay_step", nargs="+", type=int, default=list(d.decay_step))
    parser.add_argument("--decay_gamma", type=float, default=d.decay_gamma)
    parser.add_argument("--poly_exp", type=float, default=d.poly_exp)

    parser.add_argument("--exp_name", type=str, default="exp")
    parser.add_argument("--refresh_every", type=int, default=1)
    parser.add_argument("--debug", default=False, action="store_true")

    # kernel knobs
    parser.add_argument("--mlp_backend", type=str, default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="eval backend: 'pallas' = the CUDA kernels, "
                             "'xla' = the plain evaluators")
    parser.add_argument("--planar_eval", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="planar no-grad eval path (in-kernel xyz, "
                             "(N,S)-plane boundaries). 'auto': taken when "
                             "the kernel eval backend is active; 'on': "
                             "force the planar kernel; 'off': packed path")
    parser.add_argument("--train_backend", type=str, default="auto",
                        choices=["auto", "xla", "pallas", "stub"],
                        help="training MLP backend ('stub': a profiling "
                             "stand-in of the field on the packed path, "
                             "not a model)")
    parser.add_argument("--fused_train", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="planar fused train path (dense-boundary "
                             "kernels; auto = when the kernel backend "
                             "is active)")
    parser.add_argument("--fused_compositing", default=False,
                        action="store_true",
                        help="packed path: composite in the fused "
                             "compositing kernel")
    parser.add_argument("--warp_subsample", type=int, default=1,
                        choices=[1, 2],
                        help="2 = one warp-direction evaluation per ray "
                             "per step at 2x loss weight (planar path "
                             "only; ~25%% train FLOP cut, expectation-"
                             "equal loss)")
    parser.add_argument("--warp_importance", type=float, default=0.0,
                        help="importance-concentrated warp evaluation "
                             "(planar path only): f in (0, 1] evaluates "
                             "both warp directions on round(f*batch) "
                             "transient-weighted rays with unbiased HT "
                             "loss weights (~25%% train FLOP cut at 0.5)")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of steps "
                             "10-15 here (TensorBoard / Perfetto JSON; "
                             "forces --scan_steps 1)")
    parser.add_argument("--scan_steps", type=int, default=1,
                        help="train steps per dispatch, one CUDA graph of "
                             "K steps on the card; >1 amortizes host "
                             "dispatch overhead at small batch sizes "
                             "(e.g. 10 at --batch_size 512); per-step "
                             "training semantics are unchanged")
    parser.add_argument("--jax_cache_dir", type=str, default="",
                        help="the JAX package's compilation cache "
                             "directory; parsed and unused by the port")
    # the port's additions: NSFFConfig fields the JAX CLI leaves at
    # their defaults
    parser.add_argument("--val_every_steps", type=int,
                        default=d.val_every_steps,
                        help="validate every this many steps (0: once "
                             "per epoch)")
    parser.add_argument("--log_dir", type=str, default=d.log_dir,
                        help="TensorBoard / JSONL logs go to "
                             "<log_dir>/<exp_name>")
    parser.add_argument("--ckpt_dir", type=str, default=d.ckpt_dir,
                        help="checkpoints go to <ckpt_dir>/<exp_name>/"
                             "step_<n>")
    parser.add_argument("--time_budget_s", type=float, default=0.0,
                        help="wall-clock budget in seconds (0 = unlimited): "
                             "checkpoint and exit cleanly at the first "
                             "dispatch-group boundary past the budget; "
                             "resume with --ckpt_path")
    return parser


def config_from_args(args: argparse.Namespace) -> NSFFConfig:
    names = {f.name for f in dataclasses.fields(NSFFConfig)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    if "img_wh" in kw:
        kw["img_wh"] = tuple(kw["img_wh"])
    if "start_end" in kw:
        kw["start_end"] = tuple(kw["start_end"])
    return NSFFConfig(**kw)


def get_opts(argv=None) -> NSFFConfig:
    """Parse training CLI flags into an NSFFConfig."""
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    return config_from_args(parser.parse_args(argv))
