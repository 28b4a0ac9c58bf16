#!/usr/bin/env python3
"""Time the port's two no-grad tower evaluators on the card, for A/B runs
of two versions of the kernels in one call.

    PYTHONPATH=<tree> python3 scripts/time_evaluators.py [--label L]
        [--samples S] [--static] [--n_tau T] [--save PATH]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's kernels and
times, with CUDA events, `planar_eval_comp_cuda` (serving variant:
encode_t, viewdir, no flow maps; `--static`: the static tower alone) and,
at 128 samples, `fused_nerf_eval_cuda` (full variant) at the serving
chunk, 32768 rays x S samples (sorted random depths), on seeded random
weights and rays. `--n_tau` sets the time latent's width (80 or 200: B5
on two or three input segments; B1 then runs only where the tower input
fits one segment). `--save` writes the kernels' outputs there
(`torch.save`, {kernel: tensor}), so that two trees' bits can be
compared. The results are checked by
`chip_smoke.py`, not here. Prints one JSON line per kernel. Needs one
CUDA card.
"""
import argparse
import json
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_evaluators: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--n_tau", type=int, default=48)
    ap.add_argument("--save", default="")
    args = ap.parse_args()

    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    s = args.samples
    cuda_build.build(["planar_eval_comp"] + (["fused_nerf_eval"] if s == 128
                                             else []))
    n = 32768
    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=True, output_flow=True,
                                 in_channels_t=args.n_tau, device="cuda")
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, args.n_tau, generator=g)
    o, d, zs, dirs, t = (x.cuda().contiguous() for x in (o, d, zs, dirs, t))
    xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()

    kernels = {}
    if 63 + (0 if args.static else args.n_tau) <= rk.SEG:
        fb = rk.make_planar_nerf_eval_comp(s, use_viewdir=True,
                                           encode_t=not args.static,
                                           n_tau=args.n_tau)
        b1_args = (fb.pack(params), o, d, zs, None, dirs, None,
                   None if args.static else t)
        kernels["planar_eval_comp"] = lambda: rk.planar_eval_comp_cuda(
            *b1_args, **fb.kernel_kw)
    if s == 128:
        fp = mk.make_fused_nerf_eval(s, use_viewdir=True, encode_a=False,
                                     encode_t=True, output_flow=("fw", "bw"),
                                     n_tau=args.n_tau)
        b5_args = (fp.pack(params), xyz, dirs, None, t)
        kernels["fused_nerf_eval"] = lambda: mk.fused_nerf_eval_cuda(
            *b5_args, **fp.kernel_kw)
    if args.save:
        torch.save({k: fn().cpu() for k, fn in kernels.items()}, args.save)
    for name, fn in kernels.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"label": args.label, "kernel": name, "n_rays": n,
                          "samples": s, "static": args.static,
                          "n_tau": args.n_tau,
                          "ms": start.elapsed_time(end) / args.iters,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
