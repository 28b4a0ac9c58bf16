#!/usr/bin/env python3
"""Time the splat of the eval CLI's space-time interpolation on the card,
in its two deterministic forms (`nsff_pl_tpu_torch/ops/softsplat.py`), on
the interpolation's shapes (256 planes of 4 channels at 512x288, average
mode):

- scatter: a sort-based `index_put_(accumulate=True)` per corner and
  plane group;
- shifts: the shift decomposition the JAX package runs on a TPU, one
  term per integer offset the flows reach (the product of the two offset
  ranges over all planes).

`ops/softsplat.py` picks the form by that term count
(`MAX_SHIFT_TERMS`); here each form is forced through that constant. For
flows drawn uniform within +-D pixels (D = 0.5, 1.5, 3, 6) it prints each
form's ms per call (CUDA events, the mean of 3 calls after one), the term
count and the largest difference between the two (the same sums in
another order), beside the card's name and power limit:

    PYTHONPATH=. python3 scripts/time_splat.py
"""
import subprocess
import sys

import torch

S, C, H, W = 256, 4, 288, 512


def cuda_ms(fn, iters=3):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("time_splat: no CUDA device", file=sys.stderr)
        return 2
    from nsff_pl_tpu_torch.ops import softsplat as ss

    def splat(max_terms):
        ss.MAX_SHIFT_TERMS = max_terms
        return ss.softsplat_batched_planar(images, fx, fy, "average")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand(S, C, H, W, device="cuda", generator=g)
    for D in (0.5, 1.5, 3.0, 6.0):
        fx, fy = ((torch.rand(2, S, H, W, device="cuda", generator=g) - 0.5)
                  * 2 * D)
        ox = torch.floor(fx + torch.arange(W, device="cuda")) \
            - torch.arange(W, device="cuda")
        oy = torch.floor(fy + torch.arange(H, device="cuda")[:, None]) \
            - torch.arange(H, device="cuda")[:, None]
        terms = int((ox.max() - ox.min() + 2) * (oy.max() - oy.min() + 2))
        err = float((splat(0) - splat(10 ** 9)).abs().max())
        ms_scatter = cuda_ms(lambda: splat(0))
        ms_shifts = cuda_ms(lambda: splat(10 ** 9))
        print(f"flows within +-{D} px: scatter {ms_scatter:.3f} ms, shifts "
              f"{ms_shifts:.3f} ms ({terms} terms), max abs difference "
              f"{err:.3e}; {S} planes x {C} channels at {W}x{H} on {card}",
              flush=True)
        del fx, fy, ox, oy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
