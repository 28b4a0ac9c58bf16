"""Parameters and trainer state in and out of the port (port of
`nsff_pl_tpu/training/checkpoint.py`).

`params_from_jax` carries a JAX params pytree (given as numpy arrays,
e.g. `jax.tree.map(np.asarray, params)`) over to port tensors. Both
packages keep weights in the (in, out) layout, so nothing is
transposed. `opt_state_from_jax` / `opt_state_to_numpy` carry Adam's
count and moments across the same way. `save`/`load` write and read the
port's own parameters with `torch.save`.

A trainer checkpoint is `ckpt_dir/step_<n>/state.pt`, one `torch.save`
of a nested dict of CPU tensors (`save_checkpoint`, `restore_checkpoint`,
`latest_checkpoint`); the trainer's config sits beside the step
directories as `config.json`. The JAX package's orbax checkpoints are
converted by `scripts/jax_ckpt_to_torch.py`, where both packages import.
`import_pl_checkpoint` reads a reference Lightning `.ckpt`, with the JAX
package's key map; `merge_params` is its non-strict partial load.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

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
    def as_numpy(leaves):
        return _map(tree_like(params, leaves),
                    lambda t: t.detach().cpu().numpy())

    return {"count": int(opt.count), "mu": as_numpy(opt.mu),
            "nu": as_numpy(opt.nu)}


def tree_like(params, leaves):
    """`leaves` (in `optim.param_leaves` order) nested like `params`."""
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    return rebuild(params)


# ---------------------------------------------------------------------------
# trainer checkpoints
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Save a nested dict of tensors and Python values under
    `ckpt_dir/step_<step>`; returns that directory. The file is written
    whole, then renamed into place."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote to `path` (a `step_<n>`
    directory, or its file), on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


# ---------------------------------------------------------------------------
# reference Lightning checkpoints
# ---------------------------------------------------------------------------

def _map_nerf_keys(sd: Dict[str, torch.Tensor], model_name: str):
    """The reference's module names -> the port's (and the JAX
    package's) param keys; torch Linear weights (out, in) transposed."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def put(ours: str, w_key: str, b_key: str):
        if w_key in sd:
            out[ours] = {"w": sd[w_key].t().contiguous(),
                         "b": sd[b_key].clone()}

    for i in range(8):
        put(f"static_xyz_{i}",
            f"{model_name}.static_xyz_encoding_{i+1}.0.weight",
            f"{model_name}.static_xyz_encoding_{i+1}.0.bias")
        put(f"transient_xyz_{i}",
            f"{model_name}.transient_xyz_encoding_{i+1}.0.weight",
            f"{model_name}.transient_xyz_encoding_{i+1}.0.bias")
    put("static_xyz_final", f"{model_name}.static_xyz_encoding_final.weight",
        f"{model_name}.static_xyz_encoding_final.bias")
    put("static_dir", f"{model_name}.static_dir_encoding.0.weight",
        f"{model_name}.static_dir_encoding.0.bias")
    put("static_sigma", f"{model_name}.static_sigma.weight",
        f"{model_name}.static_sigma.bias")
    put("static_rgb", f"{model_name}.static_rgb.0.weight",
        f"{model_name}.static_rgb.0.bias")
    put("transient_xyz_final",
        f"{model_name}.transient_xyz_encoding_final.weight",
        f"{model_name}.transient_xyz_encoding_final.bias")
    put("transient_sigma", f"{model_name}.transient_sigma.weight",
        f"{model_name}.transient_sigma.bias")
    put("transient_rgb", f"{model_name}.transient_rgb.0.weight",
        f"{model_name}.transient_rgb.0.bias")
    put("transient_flow_fw", f"{model_name}.transient_flow_fw.0.weight",
        f"{model_name}.transient_flow_fw.0.bias")
    put("transient_flow_bw", f"{model_name}.transient_flow_bw.0.weight",
        f"{model_name}.transient_flow_bw.0.bias")
    return out


def load_pl_state_dict(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """A Lightning checkpoint's (or a bare) state dict, as f32 CPU
    tensors."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: torch.as_tensor(v).detach().float() for k, v in ckpt.items()}


def import_pl_checkpoint(ckpt_path: str,
                         prefixes_to_ignore: Optional[List[str]] = None
                         ) -> Dict[str, Any]:
    """A reference Lightning checkpoint as the port's params dict
    ({'nerf_fine', 'nerf_coarse'?, 'embedding_a'?, 'embedding_t'?}, CPU
    tensors); keys under `prefixes_to_ignore` (default ['loss']) are
    dropped."""
    prefixes_to_ignore = prefixes_to_ignore or ["loss"]
    sd = load_pl_state_dict(ckpt_path)
    sd = {k: v for k, v in sd.items()
          if not any(k.startswith(p) for p in prefixes_to_ignore)}
    params: Dict[str, Any] = {}
    fine = _map_nerf_keys(sd, "nerf_fine")
    if fine:
        params["nerf_fine"] = fine
    coarse = _map_nerf_keys(sd, "nerf_coarse")
    if coarse:
        params["nerf_coarse"] = coarse
    if "embedding_a.weight" in sd:
        params["embedding_a"] = sd["embedding_a.weight"].clone()
    if "embedding_t.weight" in sd:
        params["embedding_t"] = sd["embedding_t.weight"].clone()
    return params


def merge_params(init_params, loaded_params):
    """Non-strict partial load: the loaded leaves where the keys match,
    the initial ones elsewhere."""
    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            return {k: merge(a[k], b[k]) if k in b else a[k] for k in a}
        return b if b is not None else a

    return merge(init_params, loaded_params)
