"""Learning-rate schedules and the Adam optimizer (port of
`nsff_pl_tpu/training/optim.py`).

The schedule is a step function of `epoch = step // steps_per_epoch`:
const | steplr | cosine | poly, optionally behind a linear warmup over
`warmup_epochs` epochs (epochs 0..warmup inclusive ramp base_lr ->
base_lr * multiplier; from epoch warmup+1 the after-scheduler runs with
its own epoch counter from 0 and base lr base_lr * multiplier).

`make_optimizer` ports the `adam` branch: `torch.optim.Adam` with eps
1e-8 and coupled (L2) weight decay computes optax's `adam` update, and
the lr of each update is the schedule at the number of updates made
before it, as optax's `scale_by_schedule` reads its count. sgd, radam
and ranger raise `NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

EPS = 1e-8


def make_lr_schedule(cfg, steps_per_epoch: int):
    """Return sched(step) -> lr (a Python float)."""
    base_lr = cfg.lr
    # radam/ranger skip the warmup wrap
    warmup = cfg.warmup_epochs \
        if cfg.optimizer not in ("radam", "ranger") else 0
    mult = cfg.warmup_multiplier if warmup > 0 else 1.0

    def after(e, base):
        if cfg.lr_scheduler == "const":
            return base
        if cfg.lr_scheduler == "steplr":
            lr = base
            for m in sorted(cfg.decay_step):
                lr = lr * (cfg.decay_gamma if e >= m else 1.0)
            return lr
        if cfg.lr_scheduler == "cosine":
            return EPS + (base - EPS) * 0.5 * (
                1 + math.cos(math.pi * e / cfg.num_epochs))
        if cfg.lr_scheduler == "poly":
            return base * (1 - e / cfg.num_epochs) ** cfg.poly_exp
        raise ValueError(f"scheduler {cfg.lr_scheduler} not recognized!")

    def sched(step: int) -> float:
        e = int(step) // max(steps_per_epoch, 1)
        if warmup <= 0:
            return after(e, base_lr)
        if e <= warmup:
            return base_lr * ((mult - 1.0) * e / warmup + 1.0)
        return after(max(e - (warmup + 1), 0), base_lr * mult)

    return sched


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tensors in sorted-key order (the order of
    `jax.tree.leaves` over the same nested dict)."""
    if isinstance(params, dict):
        return [leaf for k in sorted(params) for leaf in param_leaves(params[k])]
    return [params]


class Adam:
    """The `adam` branch of `make_optimizer`."""

    def __init__(self, schedule, weight_decay: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay

    def init(self, params) -> torch.optim.Adam:
        """A `torch.optim.Adam` over the params (made leaves that require
        grad)."""
        leaves = [p.requires_grad_(True) for p in param_leaves(params)]
        return torch.optim.Adam(leaves, lr=self.schedule(0),
                                betas=(0.9, 0.999), eps=EPS,
                                weight_decay=self.weight_decay)

    def step(self, opt: torch.optim.Adam, count: int) -> None:
        """Apply one update with lr = schedule(count); a parameter the loss
        did not reach gets a zero gradient, as optax updates every leaf."""
        lr = float(self.schedule(count))
        for group in opt.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()


def make_optimizer(cfg, steps_per_epoch: int) -> Adam:
    sched = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.optimizer == "adam":
        return Adam(sched, cfg.weight_decay)
    if cfg.optimizer in ("sgd", "radam", "ranger"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP.md "
            "queue A, 'sgd/radam/ranger')")
    raise ValueError(f"optimizer {cfg.optimizer} not recognized!")


def moments(opt: torch.optim.Adam) -> Dict[str, list]:
    """Adam's count and per-leaf moments (leaf order of `param_leaves`)."""
    params = opt.param_groups[0]["params"]
    st = [opt.state.get(p, {}) for p in params]
    return {"count": int(st[0]["step"]) if st and "step" in st[0] else 0,
            "mu": [s.get("exp_avg") for s in st],
            "nu": [s.get("exp_avg_sq") for s in st]}
