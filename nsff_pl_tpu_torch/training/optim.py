"""Learning-rate schedules and the Adam optimizer (port of
`nsff_pl_tpu/training/optim.py`).

The schedule is a step function of `epoch = step // steps_per_epoch`:
const | steplr | cosine | poly, optionally behind a linear warmup over
`warmup_epochs` epochs (epochs 0..warmup inclusive ramp base_lr ->
base_lr * multiplier; from epoch warmup+1 the after-scheduler runs with
its own epoch counter from 0 and base lr base_lr * multiplier). It takes
a Python int (-> float) or a device tensor (-> an f32 tensor on that
device, as the JAX schedule computes in f32).

`make_optimizer` ports the `adam` branch: optax's `adam` (eps 1e-8) after
coupled (L2) weight decay, written out on the device. Its state (the
update count and the moments) lives beside the params, and the lr of an
update is the schedule at the count of updates made before it, as
optax's `scale_by_schedule` reads its count; an update reads nothing on
the host, so it can be captured in a CUDA graph. sgd, radam and ranger
raise `NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

EPS = 1e-8
B1, B2 = 0.9, 0.999


def make_lr_schedule(cfg, steps_per_epoch: int):
    """Return sched(step) -> lr: a Python float for an int step, an f32
    tensor on its device for a tensor step."""
    base_lr = cfg.lr
    # radam/ranger skip the warmup wrap
    warmup = cfg.warmup_epochs \
        if cfg.optimizer not in ("radam", "ranger") else 0
    mult = cfg.warmup_multiplier if warmup > 0 else 1.0

    def sched(step):
        on_device = isinstance(step, torch.Tensor)
        if on_device:
            cos = torch.cos
            where = torch.where

            def floor0(x):
                return torch.clamp(x, min=0)
        else:
            cos, floor0 = math.cos, (lambda x: max(x, 0))

            def where(c, a, b):
                return a if c else b

        def after(e, base):
            if cfg.lr_scheduler == "const":
                return base + 0.0 * e
            if cfg.lr_scheduler == "steplr":
                lr = base
                for m in sorted(cfg.decay_step):
                    lr = lr * where(e >= m, cfg.decay_gamma, 1.0)
                return lr
            if cfg.lr_scheduler == "cosine":
                return EPS + (base - EPS) * 0.5 * (
                    1 + cos(math.pi * e / cfg.num_epochs))
            if cfg.lr_scheduler == "poly":
                return base * (1 - e / cfg.num_epochs) ** cfg.poly_exp
            raise ValueError(f"scheduler {cfg.lr_scheduler} not recognized!")

        spe = max(steps_per_epoch, 1)
        e = torch.div(step, spe, rounding_mode="floor") if on_device \
            else int(step) // spe
        if warmup <= 0:
            return after(e, base_lr)
        return where(e <= warmup, base_lr * ((mult - 1.0) * e / warmup + 1.0),
                     after(floor0(e - (warmup + 1)), base_lr * mult))

    return sched


def param_leaves(params) -> List[torch.Tensor]:
    """The parameter tensors in sorted-key order (the order of
    `jax.tree.leaves` over the same nested dict)."""
    if isinstance(params, dict):
        return [leaf for k in sorted(params) for leaf in param_leaves(params[k])]
    return [params]


class AdamState:
    """Adam's state on the params' device: the leaves it updates, the
    number of updates made (a 0-d int64 tensor) and the first and second
    moments, in the leaf order of `param_leaves`."""

    def __init__(self, leaves: List[torch.Tensor]):
        self.params = leaves
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=leaves[0].device)
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


class Adam:
    """The `adam` branch of `make_optimizer`."""

    def __init__(self, schedule, weight_decay: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay

    def init(self, params) -> AdamState:
        """The state over the params (made leaves that require grad)."""
        return AdamState([p.requires_grad_(True)
                          for p in param_leaves(params)])

    @torch.no_grad()
    def step(self, opt: AdamState) -> None:
        """One update in optax's order, on the device; a parameter the
        loss did not reach gets a zero gradient, as optax updates every
        leaf."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in opt.params]
        if self.weight_decay:
            grads = torch._foreach_add(grads, opt.params,
                                       alpha=self.weight_decay)
        lr = self.schedule(opt.count)
        opt.count += 1
        count = opt.count.to(torch.float32)
        torch._foreach_mul_(opt.mu, B1)
        torch._foreach_add_(opt.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(opt.nu, B2)
        torch._foreach_addcmul_(opt.nu, grads, grads, value=1 - B2)
        mu_hat = torch._foreach_div(opt.mu, 1 - B1 ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(opt.nu,
                                                       1 - B2 ** count))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(opt.params, upd)


def make_optimizer(cfg, steps_per_epoch: int) -> Adam:
    sched = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.optimizer == "adam":
        return Adam(sched, cfg.weight_decay)
    if cfg.optimizer in ("sgd", "radam", "ranger"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP.md "
            "queue A, 'sgd/radam/ranger')")
    raise ValueError(f"optimizer {cfg.optimizer} not recognized!")


def moments(opt: AdamState) -> Dict[str, list]:
    """Adam's count and per-leaf moments (leaf order of `param_leaves`)."""
    return {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}
