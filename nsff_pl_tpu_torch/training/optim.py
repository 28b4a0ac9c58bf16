"""Learning-rate schedules and the Adam optimizer (port of
`nsff_pl_tpu/training/optim.py`).

The schedule is a step function of `epoch = step // steps_per_epoch`:
const | steplr | cosine | poly, optionally behind a linear warmup over
`warmup_epochs` epochs (epochs 0..warmup inclusive ramp base_lr ->
base_lr * multiplier; from epoch warmup+1 the after-scheduler runs with
its own epoch counter from 0 and base lr base_lr * multiplier). It takes
a Python int (-> float) or a device tensor (-> an f32 tensor on that
device, as the JAX schedule computes in f32).

`make_optimizer` ports every branch of the JAX package's, each written
out on the device in optax's order:

- adam: optax's `adam` (eps 1e-8) after coupled (L2) weight decay;
- sgd: optax's `sgd` (a momentum trace) after coupled weight decay;
- radam: `scale_by_radam` (eps 1e-8, the rectification from a
  variance-tractability threshold of 5), then decoupled decay (weight
  decay times the lr), then the lr;
- ranger: radam inside the JAX package's own `lookahead` (every 6
  updates the slow weights move half way to the fast ones, and the fast
  weights are set to them; the slow weights live in the state).

Each state (`OptState`: the update count, the moments, the trace, the
slow weights) lives beside the params, and the lr of an update is the
schedule at the count of updates made before it, as optax's
`scale_by_schedule` reads its count. An update reads nothing on the
host (the rectification and the sync are `torch.where`s on device
values), so it can be captured in a CUDA graph, and it updates every
state tensor in place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

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


class OptState:
    """An optimizer's state on the params' device: the leaves it updates
    (`params`, in the order of `param_leaves`) and its own tensors by
    field (`fields`): the 0-d int64 counts named in COUNTS, and the lists
    of one tensor per leaf named in LISTS, all made as zeros."""

    COUNTS: Tuple[str, ...] = ()
    LISTS: Tuple[str, ...] = ()

    def __init__(self, leaves: List[torch.Tensor]):
        self.params = leaves
        for k in self.COUNTS:
            setattr(self, k, torch.zeros((), dtype=torch.int64,
                                         device=leaves[0].device))
        for k in self.LISTS:
            setattr(self, k, [torch.zeros_like(p) for p in leaves])

    def fields(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in self.COUNTS + self.LISTS}

    def tensors(self) -> List[torch.Tensor]:
        """Every state tensor, in a fixed order."""
        return [getattr(self, k) for k in self.COUNTS] + [
            t for k in self.LISTS for t in getattr(self, k)]

    @torch.no_grad()
    def copy_(self, other: "OptState") -> None:
        """Copy `other`'s state (of the same optimizer) into this one's
        tensors."""
        for k in self.COUNTS:
            getattr(self, k).copy_(getattr(other, k))
        for k in self.LISTS:
            torch._foreach_copy_(getattr(self, k), getattr(other, k))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


class AdamState(OptState):
    """Adam's and RAdam's state: the number of updates made, the first and
    second moments."""
    COUNTS = ("count",)
    LISTS = ("mu", "nu")


class SgdState(OptState):
    """SGD's state: the number of updates made and the momentum trace."""
    COUNTS = ("count",)
    LISTS = ("trace",)


class RangerState(AdamState):
    """Ranger's state: the inner RAdam's, the lookahead's slow weights
    (the params at the start) and its own count of updates."""
    COUNTS = ("count", "lookahead_count")
    LISTS = ("mu", "nu", "slow")

    def __init__(self, leaves: List[torch.Tensor]):
        super().__init__(leaves)
        with torch.no_grad():
            torch._foreach_copy_(self.slow, leaves)


class Adam:
    """The `adam` branch of `make_optimizer`."""

    State = AdamState

    def __init__(self, schedule, weight_decay: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay

    def init(self, params) -> OptState:
        """The state over the params (made leaves that require grad)."""
        return self.State([p.requires_grad_(True)
                           for p in param_leaves(params)])

    @staticmethod
    def _grads(opt: OptState) -> List[torch.Tensor]:
        """The leaves' gradients; a parameter the loss did not reach gets
        a zero gradient, as optax updates every leaf."""
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in opt.params]

    def _moments(self, opt: AdamState, grads):
        """Advance the count and both moments; the bias-corrected moments
        and the count after the update as f32."""
        opt.count += 1
        count = opt.count.to(torch.float32)
        torch._foreach_mul_(opt.mu, B1)
        torch._foreach_add_(opt.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(opt.nu, B2)
        torch._foreach_addcmul_(opt.nu, grads, grads, value=1 - B2)
        return (torch._foreach_div(opt.mu, 1 - B1 ** count),
                torch._foreach_div(opt.nu, 1 - B2 ** count), count)

    @torch.no_grad()
    def step(self, opt: AdamState) -> None:
        """One update in optax's order, on the device."""
        grads = self._grads(opt)
        if self.weight_decay:
            grads = torch._foreach_add(grads, opt.params,
                                       alpha=self.weight_decay)
        lr = self.schedule(opt.count)
        mu_hat, nu_hat, _ = self._moments(opt, grads)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(opt.params, upd)


class Sgd(Adam):
    """The `sgd` branch: coupled decay, then trace = g + momentum * trace
    and p -= lr * trace."""

    State = SgdState

    def __init__(self, schedule, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        super().__init__(schedule, weight_decay)
        self.momentum = momentum

    @torch.no_grad()
    def step(self, opt: SgdState) -> None:
        grads = self._grads(opt)
        if self.weight_decay:
            grads = torch._foreach_add(grads, opt.params,
                                       alpha=self.weight_decay)
        lr = self.schedule(opt.count)
        opt.count += 1
        torch._foreach_mul_(opt.trace, self.momentum)
        torch._foreach_add_(opt.trace, grads)
        torch._foreach_sub_(opt.params, torch._foreach_mul(opt.trace, lr))


RADAM_THRESHOLD = 5.0
RO_INF = 2.0 / (1.0 - B2) - 1.0


class RAdam(Adam):
    """The `radam` branch: optax's `scale_by_radam`, then decoupled decay
    (wd * p added to the update, so scaled by the lr), then the lr."""

    def _updates(self, opt: AdamState) -> List[torch.Tensor]:
        """The rectified update before the lr: r * mu_hat / (sqrt(nu_hat)
        + eps) once the length of the approximated moving average rho
        reaches the threshold, mu_hat before; decided on the device."""
        mu_hat, nu_hat, count = self._moments(opt, self._grads(opt))
        b2t = B2 ** count
        ro = RO_INF - 2 * count * b2t / (1 - b2t)
        rect = ro >= RADAM_THRESHOLD
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * RO_INF
                       / ((RO_INF - 4.0) * (RO_INF - 2.0) * ro))
        # mu_hat * (r on) / denom + mu_hat * (1 - on): one term is the
        # update's bits and the other an exact zero (r is NaN below rho =
        # 4, and where() drops it); no foreach op takes a device scalar
        # as an addend without a host read
        on = rect.to(torch.float32)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_mul(mu_hat, torch.where(rect, r, 0.0))
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(mu_hat, 1.0 - on))
        if self.weight_decay:
            torch._foreach_add_(upd, opt.params, alpha=self.weight_decay)
        return upd

    @torch.no_grad()
    def step(self, opt: AdamState) -> None:
        lr = self.schedule(opt.count)
        upd = self._updates(opt)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(opt.params, upd)


LOOKAHEAD_SYNC, LOOKAHEAD_ALPHA = 6, 0.5


class Ranger(RAdam):
    """The `ranger` branch: RAdam inside the JAX package's `lookahead`:
    with the inner update u, every LOOKAHEAD_SYNC-th update sets
    slow += alpha * ((p + u) - slow) and p := slow (as p + (slow - p));
    the others apply u."""

    State = RangerState

    @torch.no_grad()
    def step(self, opt: RangerState) -> None:
        lr = self.schedule(opt.count)
        u = self._updates(opt)
        torch._foreach_mul_(u, -lr)
        opt.lookahead_count += 1
        on = ((opt.lookahead_count % LOOKAHEAD_SYNC) == 0).to(torch.float32)
        # slow_next = slow + alpha * ((p + u) - slow)
        s_next = torch._foreach_add(opt.params, u)
        torch._foreach_sub_(s_next, opt.slow)
        torch._foreach_mul_(s_next, LOOKAHEAD_ALPHA)
        torch._foreach_add_(s_next, opt.slow)
        # the sync's choices as x * on + y * (1 - on): one term is the
        # chosen value's bits, the other an exact zero
        delta = torch._foreach_sub(s_next, opt.params)
        torch._foreach_mul_(delta, on)
        torch._foreach_add_(delta, torch._foreach_mul(u, 1.0 - on))
        torch._foreach_add_(opt.params, delta)
        torch._foreach_mul_(s_next, on)
        torch._foreach_mul_(opt.slow, 1.0 - on)
        torch._foreach_add_(opt.slow, s_next)


def make_optimizer(cfg, steps_per_epoch: int) -> Adam:
    sched = make_lr_schedule(cfg, steps_per_epoch)
    if cfg.optimizer == "adam":
        return Adam(sched, cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return Sgd(sched, cfg.weight_decay, cfg.momentum)
    if cfg.optimizer == "radam":
        return RAdam(sched, cfg.weight_decay)
    if cfg.optimizer == "ranger":
        return Ranger(sched, cfg.weight_decay)
    raise ValueError(f"optimizer {cfg.optimizer} not recognized!")


def moments(opt: AdamState) -> Dict[str, list]:
    """The count and per-leaf moments of an Adam, RAdam or Ranger state
    (leaf order of `param_leaves`)."""
    return {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu}
