"""Parameters and trainer state in and out of the port (port of
`nsff_pl_tpu/training/checkpoint.py`).

`params_from_jax` carries a JAX params pytree (given as numpy arrays,
e.g. `jax.tree.map(np.asarray, params)`) over to port tensors. Both
packages keep weights in the (in, out) layout, so nothing is
transposed. `opt_state_from_jax` / `opt_state_to_numpy` carry every
optimizer's state across the same way (adam's and radam's count and
moments, sgd's trace, ranger's slow weights and lookahead count). `save`/`load` write and read the
port's own parameters with `torch.save` (`load` also takes a checkpoint).

A trainer checkpoint is `ckpt_dir/step_<n>/state.pt`, one `torch.save`
of a nested dict of CPU tensors (`save_checkpoint`, `restore_checkpoint`,
`latest_checkpoint`); the trainer's config sits beside the step
directories as `config.json`. `save_weights_only` strips one to its
params. The JAX package's orbax checkpoints are
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
    """Params written by `save`, or those of a checkpoint (a `step_<n>`
    directory or its file, full or params-only), on `device`."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if "params" in tree:
        tree = tree["params"]
    return _map(tree, lambda t: t.to(dev))


def to_device(params, device):
    """A copy of the params dict on `device`."""
    dev = resolve_device(device)
    return _map(params, lambda t: t.to(dev))


def _has(node, *names) -> bool:
    """Does a dict, or an optax state (a NamedTuple), hold these fields?"""
    if isinstance(node, dict):
        keys = node
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        keys = node._fields
    else:
        return False
    return all(k in keys for k in names)


def _get(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _find(tree, pred):
    """The first node of a (numpy) optax state tree, depth first, for
    which `pred` holds; None if none does."""
    if pred(tree):
        return tree
    for sub in (tree.values() if isinstance(tree, dict) else
                tree if isinstance(tree, (tuple, list)) else ()):
        found = _find(sub, pred)
        if found is not None:
            return found
    return None


def jax_opt_fields(np_opt_state) -> Dict[str, Any]:
    """The fields of the port's optimizer state (`optim.OptState`) in an
    optax state tree of the JAX package's `make_optimizer` (as numpy, or
    as an orbax checkpoint's dicts), by its structure: a `lookahead`
    state is ranger's (the inner RAdam's count and moments, the slow
    weights and the lookahead's count), a trace sgd's (the trace and the
    schedule's count), else the count and moments of adam or radam.
    Counts come as scalars, the rest as trees nested like the params."""
    la = _find(np_opt_state, lambda t: _has(t, "inner", "slow", "count"))
    if la is not None:
        out = jax_opt_fields(_get(la, "inner"))
        return {**out, "slow": _get(la, "slow"),
                "lookahead_count": _get(la, "count")}
    tr = _find(np_opt_state, lambda t: _has(t, "trace"))
    if tr is not None:
        sched = _find(np_opt_state,
                      lambda t: _has(t, "count") and not _has(t, "mu"))
        return {"count": _get(sched, "count"), "trace": _get(tr, "trace")}
    adam = _find(np_opt_state, lambda t: _has(t, "count", "mu", "nu"))
    if adam is None:
        raise ValueError("no optimizer state (a count and moments, a "
                         "trace or a lookahead state) in the given tree")
    return {k: _get(adam, k) for k in ("count", "mu", "nu")}


def load_opt_fields(opt, fields: Dict[str, Any], params) -> None:
    """Copy `fields` (counts as scalars, the rest as trees nested like
    `params`) into the optimizer state `opt`, in place; the fields must be
    the state's own."""
    from nsff_pl_tpu_torch.training.optim import param_leaves

    if set(fields) != set(opt.fields()):
        raise ValueError(f"optimizer state with {sorted(fields)}, this "
                         f"optimizer keeps {sorted(opt.fields())}")
    leaves = param_leaves(params)
    with torch.no_grad():
        for k in opt.COUNTS:
            getattr(opt, k).fill_(int(np.asarray(fields[k])))
        for k in opt.LISTS:
            src = param_leaves(fields[k])
            if len(src) != len(leaves):
                raise ValueError(f"{k}: {len(src)} tensors for "
                                 f"{len(leaves)} parameters")
            for p, a, dst in zip(leaves, src, getattr(opt, k)):
                dst.copy_(torch.as_tensor(np.asarray(a), dtype=p.dtype)
                          .reshape(p.shape))


def opt_state_from_jax(np_opt_state, opt, params):
    """Load the state of an optax optimizer from the JAX package's
    `make_optimizer` (as numpy, e.g. `jax.tree.map(np.asarray,
    opt_state)`) into the `optim.OptState` that the port's optimizer of
    the same name made (`init(params)`), in place: adam's and radam's
    count and moments, sgd's trace and count, ranger's inner radam state,
    slow weights and lookahead count."""
    load_opt_fields(opt, jax_opt_fields(np_opt_state), params)


def opt_state_tree(opt, params, leaf=lambda t: t):
    """An optimizer state as {field: count (int) or tree nested like
    `params`}, each tensor through `leaf`."""
    out = {k: int(getattr(opt, k)) for k in opt.COUNTS}
    for k in opt.LISTS:
        out[k] = _map(tree_like(params, getattr(opt, k)), leaf)
    return out


def opt_state_to_numpy(opt, params):
    """The optimizer state's fields (`opt_state_tree`) as numpy: Adam's
    {"count", "mu", "nu"}, and the fields of the others."""
    return opt_state_tree(opt, params, lambda t: t.detach().cpu().numpy())


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


def _write_state(path: str, state: Dict[str, Any]) -> str:
    """`state` on the CPU to `path/state.pt`, written whole, then renamed
    into place; returns `path` made absolute."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Save a nested dict of tensors and Python values under
    `ckpt_dir/step_<step>`; returns that directory."""
    return _write_state(os.path.join(ckpt_dir, f"step_{step}"), state)


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote to `path` (a `step_<n>`
    directory, or its file), on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def save_weights_only(ckpt_path: str, out_path: str) -> str:
    """Strip a checkpoint to its bare params (the analog of the
    reference's `utils/save_weights_only.py:12-15`): a port checkpoint
    (`step_<n>` or its file, whatever optimizer wrote it) or a reference
    Lightning `.ckpt` becomes the params-only checkpoint `out_path`
    (a directory holding `state.pt`, {"params": ...}), which
    `restore_checkpoint`, `load` and the eval CLI read. Returns
    `out_path`."""
    if ckpt_path.endswith(".ckpt"):
        params = import_pl_checkpoint(ckpt_path)
    else:
        params = restore_checkpoint(ckpt_path)["params"]
    _write_state(out_path, {"params": params})
    return out_path


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
