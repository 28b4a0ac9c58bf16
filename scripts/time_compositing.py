#!/usr/bin/env python3
"""Time the packed compositor (`csrc/fused_compositing.cu`, forward and
adjoint) on the card, alone or against another tree's version in one
process.

    PYTHONPATH=<tree> python3 scripts/time_compositing.py [--label L]
        [--against OTHER] [--turns N]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's
`fused_compositing` and, at 512 and 8192 rays x 128 samples (seeded
random packed rows, depths, noises and cotangents), prints per call:
- `ms`: device ms per call by CUDA-graph replay of `--iters` calls,
  `chip_smoke.py`'s own stopwatch (`cuda_ms`, loaded from the repo that
  holds this script, so every tree is timed alike);
- `kernel_us`: the kernel's own duration by torch.profiler over
  `--iters` eager calls (from its first instruction to its last, no
  launch gap);
- for a tree with `csrc/launch_floor.cu`, the launch floor: that empty
  kernel on the compositor's grid by both clocks (`chip_smoke.py`'s
  `empty_launch`).
With `--against OTHER` (a tree whose `fused_compositing.cu` has the same
C interface) it also builds OTHER's source with the same `nvcc` flags,
and in `--turns` turns times both libraries through the same wrapper on
the same inputs, in the order (tree, other), then (other, tree), and so
on: the A/B of two versions within one process. Results are checked by
`chip_smoke.py` and the card tests, not here. Prints one JSON line per
call. Needs one CUDA card.
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def kernel_us(torch, fn, name, iters):
    """Mean device microseconds of kernel `name` over `iters` calls, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if name in e.key
          and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    total = sum(e.self_device_time_total for e in ev)
    count = sum(e.count for e in ev)
    return total / count if count else None


def other_library(cuda_build, tree: Path) -> ctypes.CDLL:
    """`tree`'s fused_compositing.cu (with its own headers) built by
    `cuda_build`'s flags into `cuda_build`'s build directory, loaded."""
    src = tree / "nsff_pl_tpu_torch" / "csrc" / "fused_compositing.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    so = cuda_build.BUILD_DIR / f"libfused_compositing_other_" \
        f"{h.hexdigest()[:16]}.so"
    if not so.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(so), str(src)], check=True,
                       stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_compositing: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--against", type=Path, default=None)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()

    cs = _chip_smoke()
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import cuda_build

    card = cs.card_line()
    libs = {args.label or "tree": cuda_build.load("fused_compositing")}
    if args.against is not None:
        libs[f"against {args.against}"] = other_library(cuda_build,
                                                        args.against)
    has_floor = (cuda_build.CSRC_DIR / "launch_floor.cu").exists()
    s = 128
    for n in (512, 8192):
        g = torch.Generator(device="cuda").manual_seed(n)
        packed = torch.randn(n, s, 16, generator=g, device="cuda")
        zs = torch.sort(torch.rand(n, s, generator=g, device="cuda"),
                        1).values.contiguous()
        ns, nt = (torch.randn(n, s, generator=g, device="cuda")
                  for _ in range(2))
        cot = {k: torch.randn(n, s, generator=g, device="cuda")
               for k in fck.OUT_KEYS}
        gmap = torch.randn(n, 4, generator=g, device="cuda")
        calls = [("fused_compositing_fwd", "fused_comp_fwd_kernel",
                  lambda: fck.fused_compositing_fwd_cuda(packed, zs, ns, nt)),
                 ("fused_compositing_bwd", "fused_comp_bwd_kernel",
                  lambda: fck.fused_compositing_bwd_cuda(packed, zs, ns, nt,
                                                         cot, gmap))]
        names = list(libs)
        for turn in range(args.turns):
            for label in names if turn % 2 == 0 else names[::-1]:
                # the wrapper loads its library through this cache
                cuda_build._loaded["fused_compositing"] = libs[label]
                for call, kname, fn in calls:
                    print(json.dumps({
                        "label": label, "turn": turn, "call": call,
                        "n_rays": n,
                        "ms": cs.cuda_ms(torch, fn, args.iters, graph=True),
                        "kernel_us": kernel_us(torch, fn, kname, args.iters),
                        "card": card}), flush=True)
        if has_floor:
            print(json.dumps({
                "call": "empty (launch floor)", "n_rays": n,
                "ms": cs.empty_launch_ms(torch, n),
                "kernel_us": kernel_us(torch, cs.empty_launch(torch, n),
                                       "empty_kernel", args.iters),
                "card": card}), flush=True)
    cuda_build._loaded["fused_compositing"] = libs[names[0]]
    return 0


if __name__ == "__main__":
    sys.exit(main())
