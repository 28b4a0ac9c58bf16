#!/usr/bin/env python3
"""Time the backward of the port's two trainable evaluators on the card,
for A/B runs of two versions of the kernels in one call.

    PYTHONPATH=<tree> python3 scripts/time_backward.py [--label L]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's
`planar_nerf_train` and `fused_nerf_train` and times, at the training
batch (512 rays x 128 samples, seeded random weights, rays and
cotangents), the static and the transient branch of
`planar_nerf_train_bwd_cuda` (main call) and `fused_nerf_train_bwd_cuda`
(main call, no xyz cotangent): ms per call by CUDA events over `--iters`
calls, and the device ms per call of each kernel name by torch.profiler.
The results are checked by `chip_smoke.py` and the card tests, not here.
Prints one JSON line per call. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_backward: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    from torch.profiler import ProfilerActivity, profile

    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cuda_build.build(["planar_nerf_train", "fused_nerf_train"])
    n, s = 512, 128
    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, 48, generator=g)
    o, d, zs, dirs, t = (x.cuda().contiguous() for x in (o, d, zs, dirs, t))
    xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()

    fp = rk.make_planar_nerf_train(s, use_viewdir=True,
                                   output_flow=("fw", "bw"))
    pw = fp.pack(params)
    kw = {k: fp.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                       "flow_scale", "D", "skips")}
    cot = {k: torch.randn(n, s, generator=g).cuda() for k in fp.out_keys}
    pargs = (pw, o, d, zs, None, dirs, None, t, cot)
    fm = mtk.make_fused_nerf_train(s, use_viewdir=True, encode_a=False,
                                   encode_t=True, output_flow=("fw", "bw"))
    mkw = {k: fm.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                        "output_flow", "flow_scale", "D",
                                        "skips")}
    gp = torch.randn(n, s, 16, generator=g).cuda()
    margs = (fm.pack(params), xyz, dirs, None, t, gp)
    calls = {}
    for branch in ("static", "transient"):
        calls[f"planar_nerf_train_bwd_{branch}"] = (
            lambda b=branch: rk.planar_nerf_train_bwd_cuda(b, *pargs, **kw))
        calls[f"fused_nerf_train_bwd_{branch}"] = (
            lambda b=branch: mtk.fused_nerf_train_bwd_cuda(
                b, *margs, need_dxyz=False, **mkw))
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0) or 0.0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key[:60]] = round(us / 1e3 / args.iters, 4)
        print(json.dumps({"label": args.label, "call": name, "n_rays": n,
                          "ms": ms, "kernel_ms": kernels, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
