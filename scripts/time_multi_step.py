#!/usr/bin/env python3
"""Time the port's training step on the card two ways, in turns: eager
single steps, and the K-step dispatch (`make_train_step(scan_steps=K)`,
one CUDA graph of K steps).

    python3 scripts/time_multi_step.py [--steps K] [--turns N]

At `chip_smoke.py`'s flagship training recipe (its synthetic 30 x
147456 x 16 ray table, batch 512, S=128, bfloat16, seeded weights), on
the planar path and on the packed path (`fused_train="off"`,
`fused_compositing=True`): for each way, device ms per step by CUDA
events around a dispatch of K steps (K eager steps) and host ms per step
by the clock from call to the end of a synchronize, in N turns of
(eager, graph, graph, eager); the graph's capture seconds and
`torch.cuda.max_memory_allocated` after its capture. The steps' draws are drawn up front on the card. The
recipe, state set-up and timers are `chip_smoke.py`'s, loaded by path.
Prints one JSON line per measurement. Needs one CUDA card.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_multi_step: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.training.step import clone_state

    card = cs.card_line()
    cuda_build.build(["planar_nerf_train", "planar_compositor",
                      "fused_nerf_eval", "fused_nerf_train",
                      "fused_compositing"])
    K = args.steps
    Kc, poses = cs.scene(np)
    table, Ks, Ps = cs.train_scene(torch, np, Kc, poses)
    weights = torch.ones(table.shape[:2], device="cuda")
    tcfg = NSFFConfig(img_wh=(cs.W_IMG, cs.H_IMG),
                      start_end=(0, cs.N_FRAMES), use_viewdir=True,
                      encode_t=True, N_samples=128, batch_size=cs.BATCH,
                      num_epochs=50, lr=5e-4, lr_scheduler="cosine",
                      dtype="bfloat16")
    for path, cfg in (("planar", tcfg),
                      ("packed", tcfg.replace(fused_train="off",
                                              fused_compositing=True))):
        params = build_params(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        state, single = cs.train_setup(torch, cfg, params, "cuda", cs.BATCH)
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        ts, idx, draws = cs.step_rows(
            torch, cfg, FrameScheduler(cs.N_FRAMES, seed=cfg.seed), gen, K)
        ts_dev = torch.tensor(ts, device="cuda")
        tmp = torch.zeros((1, 1, 3), device="cuda")
        gstate = clone_state(state)
        multi = cs.train_setup(torch, cfg, gstate.params, "cuda", cs.BATCH,
                               scan_steps=K)[1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gstate, _, _ = multi(gstate, tmp, table, weights, Ks, Ps, gen,
                             ts_dev, idx=idx, draws=draws)
        torch.cuda.synchronize()
        print(json.dumps({
            "path": path, "way": "graph", "capture_s": multi.capture_seconds,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "card": card}), flush=True)
        for turn in range(args.turns):
            for way in ("eager", "graph", "graph", "eager"):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev0.record()
                if way == "eager":
                    for i in range(K):
                        state, _, _ = single(
                            state, table, weights, Ks, Ps, gen, ts[i],
                            idx=idx[i],
                            draws={k: v[i] for k, v in draws.items()})
                else:
                    gstate, _, _ = multi(gstate, tmp, table, weights, Ks,
                                         Ps, gen, ts_dev, idx=idx,
                                         draws=draws)
                ev1.record()
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) * 1e3 / K
                print(json.dumps({"path": path, "way": way, "turn": turn,
                                  "ms": ev0.elapsed_time(ev1) / K,
                                  "host_ms": host, "card": card}),
                      flush=True)
        del multi, gstate
    return 0


if __name__ == "__main__":
    sys.exit(main())
