#!/usr/bin/env python
"""Train an NSFF model on the card (port of `nsff_pl_tpu/apps/train.py`):

    python -m nsff_pl_tpu_torch.apps.train --root_dir <scene> \
        --img_wh 512 288 --start_end 0 30 --encode_t --use_viewdir \
        --N_samples 128 --batch_size 512 --lr 5e-4 --lr_scheduler cosine \
        --dtype bfloat16 --hard_sampling --scan_steps 10 --exp_name exp

The flags are the JAX package's (`config.add_train_args`) plus
`--fused_compositing`. It trains on one CUDA card; `main(cfg,
device="cpu")` and `cli(argv, device="cpu")` run the kernels' plain
versions on the CPU instead (for tests).

`--num_gpus N` (N > 1) trains data-parallel, one rank a GPU
(`parallel/`): fewer GPUs than asked for print a note and train on
those present (a world of one still takes the distributed path); on the
CPU N gloo ranks. Over nodes, each node runs the same command with
`--num_nodes M --coordinator_address <node 0's host:port> --node_rank
<its index>`. Local rank 0 runs in this process (`main` returns its
system), the node's other ranks in spawned processes.
"""
from __future__ import annotations

import os

from nsff_pl_tpu_torch.config import get_opts


def backup_files(cfg, files):
    """--debug: a copy of the numerically sensitive sources."""
    import shutil

    backup_dir = os.path.join("files_backup", cfg.exp_name)
    os.makedirs(backup_dir, exist_ok=True)
    for f in files:
        if os.path.exists(f):
            shutil.copy(f, backup_dir)


def _debug_backup_list():
    import nsff_pl_tpu_torch

    pkg = os.path.dirname(os.path.abspath(nsff_pl_tpu_torch.__file__))
    return [os.path.join(pkg, "models", "nerf.py"),
            os.path.join(pkg, "models", "rendering.py"),
            os.path.join(pkg, "models", "raymarch.py"),
            os.path.join(pkg, "training", "loss.py"),
            os.path.join(pkg, "apps", "train.py")]


def main(cfg, device="cuda"):
    from nsff_pl_tpu_torch import resolve_device
    from nsff_pl_tpu_torch.parallel import distributed as dist_lib

    dev = resolve_device(device)
    if dist_lib.asked(cfg) > 1:
        return dist_lib.launch(_train_rank, cfg, dev, (cfg,))
    return train(cfg, dev)


def _train_rank(mesh, cfg):
    return train(cfg, mesh.device, mesh)


def train(cfg, dev, mesh=None):
    """Build the system on `dev` (one rank of `mesh`), print its notes
    (rank 0) and fit."""
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

    system = NSFFSystem(cfg, device=dev, mesh=mesh)
    if system.primary:
        _notes(system, cfg, dev)
    system.fit(log_every=max(cfg.refresh_every, 1) * 50)
    return system


def _notes(system, cfg, dev):
    print(f"scene: {system.train_scene.N_frames} frames "
          f"{cfg.img_wh[0]}x{cfg.img_wh[1]} loaded in "
          f"{system.load_seconds:.2f} s; {system.steps_per_epoch} "
          f"steps/epoch x {cfg.num_epochs} epochs", flush=True)
    if dev.type == "cuda" and cfg.dtype == "float32":
        # the CUDA kernels run in bfloat16; float32 trains on the plain
        # evaluators
        print("note: training in float32 on the plain evaluators; pass "
              "--dtype bfloat16 for the kernels (PERF.md)", flush=True)
    if dev.type == "cuda" and cfg.scan_steps == 1 and cfg.batch_size <= 2048:
        # per-step host dispatch dominates small batches; a K-step
        # dispatch replays one CUDA graph
        print("note: --scan_steps 1; pass e.g. --scan_steps 10 to run K "
              "steps a dispatch as one CUDA graph (PERF.md)", flush=True)


def cli(argv=None, device="cuda"):
    """Console entry point (`nsff-train-torch`)."""
    cfg = get_opts(argv)
    if cfg.debug:
        backup_files(cfg, _debug_backup_list())
    return main(cfg, device=device)


if __name__ == "__main__":
    cli()
