"""Strip a training checkpoint to bare model weights (port of
`tools/save_weights_only.py`, the reference's
`utils/save_weights_only.py:4-15`):

- a port checkpoint (`ckpts/<exp>/step_<n>` or its `state.pt`, written
  with any optimizer) -> a params-only checkpoint directory;
- a reference Lightning `.ckpt` -> the same, through the importer.

    python -m nsff_pl_tpu_torch.tools.save_weights_only \
        --ckpt_path ckpts/exp/step_100 --out weights/exp

The eval CLI (`--ckpt_path weights/exp`), `training.checkpoint.load` and
the render server (`apps/serve.py --ckpt_path weights/exp`) read the
result as they read the full checkpoint. Runs on the CPU.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)

    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.optim import param_leaves

    ckpt_lib.save_weights_only(args.ckpt_path, args.out)
    params = ckpt_lib.restore_checkpoint(args.out)["params"]
    n = sum(p.numel() for p in param_leaves(params))
    print(f"saved params-only checkpoint ({n:,} params) to {args.out}")
    return n


if __name__ == "__main__":
    main()
