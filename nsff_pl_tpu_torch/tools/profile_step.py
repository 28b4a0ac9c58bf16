"""Time the flagship train step and capture a torch.profiler trace of it
(port of `tools/profile_step.py`).

    python -m nsff_pl_tpu_torch.tools.profile_step [fused_train] [outdir] \
        [batch_size] [--device cuda|cpu]

    fused_train: auto | on | off  (default auto: the planar path, B2 + B3;
                 off: the packed path, B5's forward and B4)
    outdir:      trace directory  (default <tmp>/prof_planar)
    batch_size:  rays per step    (default 8192)

`build` sets up what the JAX repo's `bench.py::build` does: 30 frames at
512x288, the flagship model (encode_t, use_viewdir, N_samples 128,
bfloat16) initialised from seed 0, Adam at lr 1e-6 with a cosine
schedule over 50 epochs, and a seeded random ray table of NDC-like rays
on the device. `main` runs one warm-up step, `timed_steps` steps timed
with a forced fetch (prints ms/step), then `traced_steps` steps under
`utils/profiling.trace`; open the trace with TensorBoard or Perfetto.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

N_FRAMES, W, H = 30, 512, 288


def build(batch_size: int, fused_train: str = "auto", device="cuda"):
    """(step, state, (table, weights, Ks, Ps)) of the flagship recipe on
    `device` (on the CPU the kernels' plain versions)."""
    from nsff_pl_tpu_torch import resolve_device
    from nsff_pl_tpu_torch.config import (NSFFConfig, build_params,
                                          loss_config, render_config)
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

    dev = resolve_device(device)
    # tiny lr: the random table makes the flow losses huge and the
    # reference lr diverges within ~20 steps; NaN params change kernel
    # timing
    cfg = NSFFConfig(img_wh=(W, H), start_end=(0, N_FRAMES),
                     use_viewdir=True, encode_t=True, N_samples=128,
                     dtype="bfloat16", fused_train=fused_train,
                     train_backend="pallas", optimizer="adam", lr=1e-6,
                     lr_scheduler="cosine", num_epochs=50)
    params = build_params(cfg, torch.Generator().manual_seed(0), device=dev)
    steps_per_epoch = W * H * N_FRAMES // 1000
    tx = make_optimizer(cfg, steps_per_epoch)
    state = TrainState(params, tx.init(params), 0)

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((N_FRAMES, W * H, 16), generator=gen, device=dev)
    # NDC-like rays (o_z ~= -1, d_z = 1 - o_z as get_ndc_rays gives for a
    # camera at the near plane), so that xyz_z stays in [-1, 1]
    table[..., 0:2] = table[..., 0:2] * 2 - 1
    table[..., 2] = -1.0 + 0.1 * table[..., 2]
    table[..., 3:5] = (table[..., 3:5] - 0.5) * 0.4
    table[..., 5] = 1.0 - table[..., 2]
    table[..., 9] = torch.arange(N_FRAMES, dtype=torch.float32,
                                 device=dev)[:, None]
    f = 500.0 * W / 960
    Ks = torch.tensor([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                      device=dev)
    Ps = torch.eye(3, 4, device=dev).expand(1, N_FRAMES, 3, 4).contiguous()
    step = make_train_step(
        render_config(cfg), loss_config(cfg), tx, output_transient=True,
        output_transient_flow=tuple(cfg.output_transient_flow),
        steps_per_epoch=steps_per_epoch, batch_size=batch_size, device=dev)
    weights = torch.ones((N_FRAMES, W * H), device=dev)
    return step, state, (table, weights, Ks, Ps)


def get_opts(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("fused_train", nargs="?", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("outdir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "prof_planar"))
    p.add_argument("batch_size", nargs="?", type=int, default=8192)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    return p.parse_args(argv)


def main(argv=None, *, timed_steps: int = 30, traced_steps: int = 4):
    """Returns {"ms_per_step", "loss", "outdir", "step"}; `step` is the
    train step (its wrappers count the launches)."""
    from nsff_pl_tpu_torch.utils import profiling

    args = get_opts(argv)
    step, state, (table, weights, Ks, Ps) = build(
        args.batch_size, args.fused_train, args.device)
    gen = torch.Generator(device=table.device).manual_seed(0)

    def run(n, t0):
        nonlocal state
        m = None
        for i in range(n):
            state, m, _ = step(state, table, weights, Ks, Ps, gen,
                               (t0 + i) % N_FRAMES)
        return m

    print("warm loss", profiling.force(run(1, 0)["loss"]), flush=True)
    with profiling.Timer() as timer:
        loss = profiling.force(run(timed_steps, 0)["loss"])
    ms = timer.elapsed / max(timed_steps, 1) * 1e3
    print("loss", loss, "ms/step", ms, flush=True)
    with profiling.trace(args.outdir, table.device):
        profiling.force(run(traced_steps, 0)["loss"])
    print("trace ->", args.outdir, flush=True)
    return {"ms_per_step": ms, "loss": loss, "outdir": args.outdir,
            "step": step}


if __name__ == "__main__":
    main()
