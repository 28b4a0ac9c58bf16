#!/usr/bin/env python3
"""Time a compositor on the card (the packed one, `csrc/fused_compositing.cu`,
or with `--kernel planar_compositor` the planar one, B3; forward and
adjoint), alone or against other trees' versions in one process.

    PYTHONPATH=<tree> python3 scripts/time_compositing.py [--label L]
        [--kernel K] [--samples S ...] [--rays N ...]
        [--against OTHER ...] [--turns N]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's kernel and,
at each of `--rays` rays (512 and 8192) x `--samples` samples (128;
seeded random packed rows or planes, depths, noises and cotangents),
prints per call:
- `ms`: device ms per call by CUDA-graph replay of `--iters` calls,
  `chip_smoke.py`'s own stopwatch (`cuda_ms`, loaded from the repo that
  holds this script, so every tree is timed alike);
- `kernel_us`: the kernel's own duration by torch.profiler over
  `--iters` eager calls (from its first instruction to its last, no
  launch gap);
- for a tree with `csrc/launch_floor.cu`, the launch floor: that empty
  kernel on the compositor's grid by both clocks (`chip_smoke.py`'s
  `empty_launch`).
With `--against OTHER` (a tree whose kernel source has the same C
interface; repeated for several) it also builds each OTHER's source with
the same `nvcc` flags, and in `--turns` turns times every library
through the same wrapper on the same inputs, in the order (tree, others),
then reversed, and so on: the A/B of versions within one process. Results are checked by
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


def other_library(cuda_build, tree: Path, kernel: str) -> ctypes.CDLL:
    """`tree`'s `<kernel>.cu` (with its own headers) built by
    `cuda_build`'s flags into `cuda_build`'s build directory, loaded."""
    src = tree / "nsff_pl_tpu_torch" / "csrc" / f"{kernel}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    so = cuda_build.BUILD_DIR / f"lib{kernel}_other_" \
        f"{h.hexdigest()[:16]}.so"
    if not so.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(so), str(src)], check=True,
                       stdout=subprocess.DEVNULL)
    return ctypes.CDLL(str(so))


def packed_calls(torch, fck, n, s):
    g = torch.Generator(device="cuda").manual_seed(n)
    packed = torch.randn(n, s, 16, generator=g, device="cuda")
    zs = torch.sort(torch.rand(n, s, generator=g, device="cuda"),
                    1).values.contiguous()
    ns, nt = (torch.randn(n, s, generator=g, device="cuda")
              for _ in range(2))
    cot = {k: torch.randn(n, s, generator=g, device="cuda")
           for k in fck.OUT_KEYS}
    gmap = torch.randn(n, 4, generator=g, device="cuda")
    return [("fused_compositing_fwd", "fused_comp_fwd_kernel",
             lambda: fck.fused_compositing_fwd_cuda(packed, zs, ns, nt)),
            ("fused_compositing_bwd", "fused_comp_bwd_kernel",
             lambda: fck.fused_compositing_bwd_cuda(packed, zs, ns, nt,
                                                    cot, gmap))]


def planar_calls(torch, tck, n, s):
    """B3 on planes drawn as tests/test_torch_cuda.py's compositor test
    draws them: sorted depths, sigmas and noises N(0, 2), rgb U(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(n)
    ins = {"zs": torch.sort(torch.rand(n, s, generator=g, device="cuda"),
                            1).values.contiguous()}
    for k in tck.IN_KEYS[1:9]:
        ins[k] = torch.randn(n, s, generator=g, device="cuda") * 2
    for k in tck.IN_KEYS[9:]:
        ins[k] = torch.rand(n, s, generator=g, device="cuda")
    cot = {k: torch.randn(n, s, generator=g, device="cuda")
           for k in tck.OUT_KEYS}
    gmap = torch.randn(n, tck.N_MAP, generator=g, device="cuda")
    return [("planar_compositor_fwd", "comp_fwd_kernel",
             lambda: tck.planar_compositor_fwd_cuda(ins)),
            ("planar_compositor_bwd", "comp_bwd_kernel",
             lambda: tck.planar_compositor_bwd_cuda(ins, cot, gmap))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_compositing: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--kernel", default="fused_compositing",
                    choices=["fused_compositing", "planar_compositor"])
    ap.add_argument("--samples", type=int, nargs="+", default=[128])
    ap.add_argument("--rays", type=int, nargs="+", default=[512, 8192])
    ap.add_argument("--against", type=Path, action="append", default=[])
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()

    cs = _chip_smoke()
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import cuda_build

    card = cs.card_line()
    kernel = args.kernel
    libs = {args.label or "tree": cuda_build.load(kernel)}
    for other in args.against:
        libs[f"against {other}"] = other_library(cuda_build, other, kernel)
    has_floor = (cuda_build.CSRC_DIR / "launch_floor.cu").exists()
    for s, n in ((s, n) for s in args.samples for n in args.rays):
        calls = (packed_calls(torch, fck, n, s)
                 if kernel == "fused_compositing"
                 else planar_calls(torch, tck, n, s))
        names = list(libs)
        for turn in range(args.turns):
            for label in names if turn % 2 == 0 else names[::-1]:
                # the wrapper loads its library through this cache
                cuda_build._loaded[kernel] = libs[label]
                for call, kname, fn in calls:
                    print(json.dumps({
                        "label": label, "turn": turn, "call": call,
                        "n_rays": n, "samples": s,
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
    cuda_build._loaded[kernel] = libs[names[0]]
    return 0


if __name__ == "__main__":
    sys.exit(main())
