#!/usr/bin/env python3
"""Where the train CLI's time goes outside its steps, on the card:

    python3 scripts/profile_scene_training.py [--validations 4]

Writes `chip_smoke.py`'s scene (30 frames at 1024x576, to
chip_smoke_out/scene/), then builds the flagship `NSFFSystem` on it and
prints:
- the scene load under cProfile (the functions with the most cumulative
  time), and the load again from its `rays.npy` cache;
- the seconds of each of `--validations` validations, and of their parts
  (the frame render on B1, the PSNR / SSIM, the hard-sampling refresh)
  each timed alone between synchronisations;
- cProfile and torch.profiler tables over one more validation.

Needs one CUDA card; builds the serving and training kernels first. The
scene and its cache are `chip_smoke.py`'s: after a `chip_smoke.py` run in
the same copy, the first load also reads the cached table.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _profiled(fn, sort, n):
    prof = cProfile.Profile()
    prof.enable()
    out = fn()
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats(sort).print_stats(n)
    print(buf.getvalue(), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--validations", type=int, default=4)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_scene_training: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nsff_pl_tpu_torch.config import get_opts
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.scene import MonocularScene
    from nsff_pl_tpu_torch.training import metrics
    from nsff_pl_tpu_torch.training.step import render_full_image
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cuda_build.build(["planar_eval_comp", "planar_nerf_train",
                      "planar_compositor"])
    torch.zeros(1, device="cuda")  # CUDA up before the timed load
    cs.write_scene(np, cs.SCENE_DIR)
    cfg = get_opts(cs.scene_argv("profile"))
    t0 = time.perf_counter()
    system = _profiled(lambda: NSFFSystem(cfg), "cumulative", 30)
    print(f"scene load (under cProfile) {time.perf_counter() - t0:.3f} s",
          flush=True)
    t0 = time.perf_counter()
    MonocularScene(cfg.root_dir, "train", img_wh=cfg.img_wh,
                   start_end=cfg.start_end, cache_dir=cfg.cache_dir)
    torch.cuda.synchronize()
    print(f"train scene from the rays.npy cache "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    for i in range(args.validations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.validate(i)
        torch.cuda.synchronize()
        print(f"validation {i}: {time.perf_counter() - t0:.4f} s on {card}",
              flush=True)
    item = system._val_item
    w, h = cfg.img_wh
    chunk = min(max(cfg.chunk // 4, 1024), w * h)
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_full_image(system.val_render, system.state.params,
                                item["rays"], item["ts"], chunk=chunk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = torch.clamp(out["rgb_fine"].float().reshape(h, w, 3), 0, 1)
        gt = item["rgbs"].reshape(h, w, 3)
        metrics.psnr(gt, img)
        metrics.ssim(gt, img, reduction="none").mean(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        system.refresh_weights()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"validation parts: render {t1 - t0:.4f} s, psnr/ssim "
              f"{t2 - t1:.4f} s, hard-sampling refresh {t3 - t2:.4f} s",
              flush=True)
    _profiled(lambda: (system.validate(9), torch.cuda.synchronize()),
              "tottime", 20)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        system.validate(10)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
