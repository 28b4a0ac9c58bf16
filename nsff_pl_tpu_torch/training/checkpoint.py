"""Parameters in and out of the port.

`params_from_jax` carries a JAX params pytree (given as numpy arrays,
e.g. `jax.tree.map(np.asarray, params)`) over to port tensors. Both
packages keep weights in the (in, out) layout, so nothing is
transposed. `opt_state_from_jax` / `opt_state_to_numpy` carry Adam's
count and moments across the same way. `save`/`load` write and read the
port's own parameters with `torch.save`; reading the JAX package's orbax
checkpoints is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_tree, device="cuda"):
    """Nested dict of arrays -> the same nested dict of f32 tensors."""
    dev = resolve_device(device)
    return _map(np_tree, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev))


def params_to_numpy(params):
    """Port params -> nested dict of numpy arrays (the inverse bridge)."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def save(path, params) -> None:
    torch.save(_map(params, lambda t: t.detach().cpu()), path)


def load(path, device="cuda"):
    dev = resolve_device(device)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return _map(tree, lambda t: t.to(dev))


def to_device(params, device):
    """A copy of the params dict on `device`."""
    dev = resolve_device(device)
    return _map(params, lambda t: t.to(dev))


def _adam_state(tree):
    """(count, mu, nu) of the first node of a (numpy) optax state tree
    with Adam's `count`, `mu` and `nu` (also `opt_state_to_numpy`'s dict)."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return tree["count"], tree["mu"], tree["nu"]
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree.count, tree.mu, tree.nu
    for sub in (tree.values() if isinstance(tree, dict) else
                tree if isinstance(tree, (tuple, list)) else ()):
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def opt_state_from_jax(np_opt_state, opt, params):
    """Load the Adam count and moments of an optax `adam` state (as
    numpy, e.g. `jax.tree.map(np.asarray, opt_state)`) into the
    `optim.AdamState` that `optim.Adam.init(params)` made, in place."""
    from nsff_pl_tpu_torch.training.optim import param_leaves

    st = _adam_state(np_opt_state)
    if st is None:
        raise ValueError("no Adam state (count, mu, nu) in the given tree")
    count, mu, nu = st[0], param_leaves(st[1]), param_leaves(st[2])
    leaves = param_leaves(params)
    if len(mu) != len(leaves):
        raise ValueError(f"{len(mu)} moments for {len(leaves)} parameters")
    opt.count.fill_(int(np.asarray(count)))
    for p, m, v, om, ov in zip(leaves, mu, nu, opt.mu, opt.nu):
        om.copy_(torch.as_tensor(np.asarray(m), dtype=p.dtype).reshape(
            p.shape))
        ov.copy_(torch.as_tensor(np.asarray(v), dtype=p.dtype).reshape(
            p.shape))


def opt_state_to_numpy(opt, params):
    """Adam's count and moments as {"count", "mu", "nu"}, the moments
    nested like `params`, as numpy."""
    from nsff_pl_tpu_torch.training.optim import moments

    m = moments(opt)
    it_mu, it_nu = iter(m["mu"]), iter(m["nu"])

    def rebuild(tree, it):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], it) for k in sorted(tree)}
        v = next(it)
        return (v.detach().cpu().numpy() if v is not None
                else np.zeros(tuple(tree.shape), np.float32))

    return {"count": m["count"], "mu": rebuild(params, it_mu),
            "nu": rebuild(params, it_nu)}
