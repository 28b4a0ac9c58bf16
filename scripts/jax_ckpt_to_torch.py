#!/usr/bin/env python
"""Convert a JAX package trainer checkpoint (orbax, `<exp>/step_<n>`) into
the PyTorch port's (`<out_dir>/step_<n>/state.pt`), which
`NSFFSystem(cfg with ckpt_path=...)` and `apps.train --ckpt_path` resume
from:

    python scripts/jax_ckpt_to_torch.py ckpts/smoke_full/step_15 out/exp

It carries the params, the optimizer's state (adam's and radam's count
and moments, sgd's momentum trace and count, ranger's inner radam state,
slow weights and lookahead count), the step and the hard-sampling
weights. The train generator's and frame scheduler's
states are not in a JAX checkpoint (the JAX trainer re-seeds both on a
resume), so the port's resume re-seeds them too.

This bridge imports both packages (orbax for the JAX side), so it runs
where both are installed, not on the card's machine.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def read_orbax(path: str):
    """The raw pytree of an orbax `step_<n>` directory, as numpy."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    try:
        tree = ckptr.restore(os.path.abspath(path))
    finally:
        ckptr.close()
    return tree


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_tree(tree):
    """A JAX trainer checkpoint's tree -> the port's checkpoint dict."""
    import torch

    from nsff_pl_tpu_torch.training.checkpoint import jax_opt_fields

    state = tree["state"]
    fields = jax_opt_fields(state["opt_state"])

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, dtype=np.float32))

    return {
        "params": tensors(_np_tree(state["params"])),
        "opt_state": {k: int(np.asarray(v)) if k.endswith("count")
                      else tensors(_np_tree(v)) for k, v in fields.items()},
        "step": int(np.asarray(state["step"])),
        "sampling_weights": torch.from_numpy(
            np.array(tree["sampling_weights"], dtype=np.float32)),
    }


def convert(src: str, out_dir: str) -> str:
    """Write the port's checkpoint of orbax `src` under `out_dir`; returns
    its `step_<n>` directory."""
    from nsff_pl_tpu_torch.training.checkpoint import save_checkpoint

    tree = port_tree(read_orbax(src))
    return save_checkpoint(out_dir, tree["step"], tree)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the JAX checkpoint, <exp>/step_<n>")
    p.add_argument("out_dir", help="where step_<n>/state.pt is written")
    args = p.parse_args(argv)
    print(convert(args.src, args.out_dir))


if __name__ == "__main__":
    main()
