"""The ranks' side of tests/test_torch_parallel.py. It imports torch and
the port only: the spawned gloo ranks import this module, and nothing of
JAX need load there. The sizes are tests/torch_train_helpers.py's (that
file imports JAX; the test checks that the two agree)."""
import dataclasses

import numpy as np
import torch

from nsff_pl_tpu_torch.config import (NSFFConfig, build_params, loss_config,
                                      render_config)
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training.optim import make_optimizer, param_leaves
from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

N, S, FRAMES, NTAU = 48, 16, 4, 16
STEPS = 2
SPE = 10  # steps per epoch of the schedule
# the five train paths: {case: (config flags, render config fields)}
PLANAR = {"planar_compositing": "on"}
CASES = {
    "planar": ({}, PLANAR),
    "ws2": ({"warp_subsample": 2}, PLANAR),
    "wi": ({"warp_importance": 0.5}, PLANAR),
    "c2f": ({"N_importance": 24}, PLANAR),  # S_fine = 64
    "packed": ({"fused_train": "off", "train_backend": "pallas",
                "fused_compositing": True}, {}),
}


# the recipe of tests/test_torch_train_step.py (its JAX side too)
CFG_KW = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
              encode_t=True, N_samples=S, N_tau=NTAU, optimizer="adam",
              lr=1e-3, lr_scheduler="cosine", num_epochs=2, batch_size=N,
              dtype="bfloat16", fused_train="on")


def config(case, **extra) -> NSFFConfig:
    return NSFFConfig(**{**CFG_KW, **CASES[case][0], **extra})


def train_step(case, mesh, scan_steps=1, batch=N):
    cfg = config(case, batch_size=batch)
    rc = dataclasses.replace(render_config(cfg), **CASES[case][1])
    tx = make_optimizer(cfg, SPE)
    step = make_train_step(
        rc, loss_config(cfg), tx, output_transient=True,
        output_transient_flow=tuple(cfg.output_transient_flow),
        steps_per_epoch=SPE, batch_size=batch, scan_steps=scan_steps,
        device="cpu", mesh=mesh)
    return cfg, tx, step


def table_args():
    """A seeded ray table of FRAMES x 256 rays, its sampling weights and
    the cameras (as tests/test_torch_train_step.py builds them)."""
    rng = np.random.RandomState(1)
    table = rng.rand(FRAMES, 256, 16).astype(np.float32)
    rays = np.zeros((FRAMES * 256, 6), np.float32)
    rays[:, 0:2] = rng.rand(FRAMES * 256, 2) * 2 - 1
    rays[:, 2] = -1.0 + 0.1 * rng.rand(FRAMES * 256)
    rays[:, 3:5] = (rng.rand(FRAMES * 256, 2) - 0.5) * 0.4
    rays[:, 5] = 1.0 - rays[:, 2]
    table[..., 0:6] = rays.reshape(FRAMES, 256, 6)
    table[..., 9] = np.arange(FRAMES, dtype=np.float32)[:, None]
    f = 20.0
    Ks = np.array([[[f, 0, 8], [0, f, 8], [0, 0, 1]]], np.float32)
    Ps = np.tile(np.eye(3, 4, dtype=np.float32), (1, FRAMES, 1, 1))
    weights = np.ones(table.shape[:2], np.float32)
    return tuple(torch.from_numpy(a) for a in (table, weights, Ks, Ps))


def _end(state, rows):
    return {"losses": rows,
            "params": [p.detach().clone() for p in param_leaves(state.params)],
            "moments": [t.clone() for t in state.opt_state.tensors()]}


def run_case(case, mesh, scan_steps=1):
    """STEPS steps of `case` from seeded weights, every draw from one
    seeded generator: the loss terms of each step, the params and the
    optimizer's state after them."""
    cfg, tx, step = train_step(case, mesh, scan_steps)
    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    state = TrainState(params, tx.init(params), 0)
    gen = torch.Generator().manual_seed(7)
    args = table_args()
    if scan_steps > 1:
        state, _, m = step(state, torch.zeros((1, 1, 3)), *args, gen,
                           torch.arange(1, STEPS + 1))
        rows = [{k: float(v[i]) for k, v in m.items()} for i in range(STEPS)]
        return _end(state, rows)
    rows = []
    for t in range(1, STEPS + 1):
        state, m, _ = step(state, *args, gen, t)
        rows.append({k: float(v) for k, v in m.items()})
    return _end(state, rows)


def run_given(mesh, jax_params, idx, draws):
    """One planar step from JAX-initialised weights (`jax_params`, numpy)
    on given pixel ids and draws: the JAX comparison's port side."""
    cfg, tx, step = train_step("planar", mesh)
    params = tckpt.params_from_jax(jax_params, "cpu")
    state = TrainState(params, tx.init(params), 0)
    state, m, _ = step(state, *table_args(), None, 1, idx=idx, draws=draws)
    return _end(state, [{k: float(v) for k, v in m.items()}])


def rank_main(mesh, out_dir, jax_in):
    """Every case on the two-rank mesh (single steps, and the planar case
    as one K = 2 dispatch), the JAX comparison's step, then this rank's
    share of the one-rank references, and what a CUDA device on this
    gloo group raises; written to out_dir/rank<r>.pt."""
    from nsff_pl_tpu_torch.parallel import distributed, make_mesh

    try:
        make_mesh("cuda")
    except ValueError as e:  # a CUDA device never runs on gloo
        cuda_on_gloo = str(e)
    res = {"cuda_on_gloo": cuda_on_gloo,
           "roles": (mesh.rank, mesh.size, distributed.is_primary(),
                     distributed.multiprocess())}
    res.update({f"dp_{c}": run_case(c, mesh) for c in CASES})
    res["dp_planar_k2"] = run_case("planar", mesh, scan_steps=STEPS)
    res["dp_given"] = run_given(mesh, *jax_in)
    for i, c in enumerate(CASES):
        if i % mesh.size == mesh.rank:
            res[f"one_{c}"] = run_case(c, None)
    torch.save(res, f"{out_dir}/rank{mesh.rank}.pt")


def launch_ranks(_, out_dir, jax_in):
    """In a process of its own: the two gloo ranks of `rank_main`,
    started by the port's launcher (this process is rank 0), one torch
    thread each."""
    from nsff_pl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.launch(rank_main, NSFFConfig(num_gpus=2), "cpu",
                       (out_dir, jax_in))


def cli_runs(_, out_dir, one_argv, dp_argv):
    """In a process of its own, one torch thread a rank and without the
    TensorBoard writer (tests/test_torch_parallel.py::jsonl_logs_only):
    the train CLI on `one_argv` in this process alone, then on `dp_argv`
    (`--num_gpus 2`, this process rank 0) with both ranks' standard
    output sent to out_dir/dp_stdout.txt; rank 0's system goes to
    out_dir/dp_system.json."""
    import json
    import os
    import sys

    from nsff_pl_tpu_torch.apps.train import cli

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    cli(one_argv, device="cpu")
    with open(os.path.join(out_dir, "dp_stdout.txt"), "w") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)  # the spawned rank inherits it
        try:
            dp = cli(dp_argv, device="cpu")
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
    with open(os.path.join(out_dir, "dp_system.json"), "w") as f:
        json.dump({"rank": dp.mesh.rank, "size": dp.mesh.size,
                   "step": dp.state.step,
                   "steps_per_epoch": dp.steps_per_epoch}, f)
