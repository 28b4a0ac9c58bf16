#!/usr/bin/env python3
"""Time the forward of the port's planar training step on the card, for
A/B runs of two versions of the kernels in one call.

    PYTHONPATH=<tree> python3 scripts/time_forward.py [--label L]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's
`planar_nerf_train`, `planar_compositor` and `fused_nerf_eval` and
times, at the training batch (512 rays x 128 samples, seeded random
weights, rays and planes):
- `planar_nerf_train_fwd_cuda` in the step's three calls (main: static +
  transient with both flow heads; fw and bw warps: transient only, flows
  in): device ms per call by CUDA-graph replay of `--iters` calls, and
  host microseconds per call from call to return (median of 7 runs of
  100 calls);
- `planar_compositor_fwd_cuda` and `planar_compositor_bwd_cuda`: device
  ms per call by CUDA-graph replay of 10 x `--iters` calls;
- `fused_nerf_eval_cuda` in a warp call's shape: host microseconds per
  call only (its launch encodes the same tensor maps).
The stopwatches are `chip_smoke.py`'s own (`cuda_ms`, `host_call_us`,
loaded from the repo that holds this script), and the default call
counts are its own, so the two read alike. The results are checked by
`chip_smoke.py` and the card tests, not here.
Prints one JSON line per call. Needs one CUDA card.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def _timers():
    """`cuda_ms` and `host_call_us` of the repo's chip_smoke.py (loaded by
    path, so both trees of an A/B are timed by the same stopwatch)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.cuda_ms, cs.host_call_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_forward: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    cuda_ms, host_call_us = _timers()
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cuda_build.build(["planar_nerf_train", "planar_compositor",
                      "fused_nerf_eval"])
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
    flows = tuple(0.05 * torch.randn(n, s, generator=g) for _ in range(3))
    o, d, zs, dirs, t = (x.cuda().contiguous() for x in (o, d, zs, dirs, t))
    flows = tuple(f.cuda().contiguous() for f in flows)
    xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()

    main_op = rk.make_planar_nerf_train(s, use_viewdir=True,
                                        output_flow=("fw", "bw"))
    pw = main_op.pack(params)
    calls = {"planar_nerf_train_fwd [main]": (
        pw, o, d, zs, None, dirs, None, t, main_op.kernel_kw)}
    for label, head in (("fw warp", "bw"), ("bw warp", "fw")):
        op = rk.make_planar_nerf_train(s, static_branch=False, flow_in=True,
                                       use_viewdir=True, output_flow=(head,))
        calls[f"planar_nerf_train_fwd [{label}]"] = (
            pw, o, d, zs, flows, None, None, t, op.kernel_kw)
    for name, (*a, kw) in calls.items():
        fn = (lambda a=a, kw=kw: rk.planar_nerf_train_fwd_cuda(*a, **kw))
        print(json.dumps({"label": args.label, "call": name, "n_rays": n,
                          "ms": cuda_ms(torch, fn, args.iters, graph=True),
                          "host_us": host_call_us(torch, fn), "card": card}),
              flush=True)

    ins = {"zs": zs}
    for k in tck.IN_KEYS[1:9]:
        ins[k] = (torch.randn(n, s, generator=g) * 2).cuda()
    for k in tck.IN_KEYS[9:]:
        ins[k] = torch.rand(n, s, generator=g).cuda()
    cot = {k: torch.randn(n, s, generator=g).cuda() for k in tck.OUT_KEYS}
    gmap = torch.randn(n, tck.N_MAP, generator=g).cuda()
    for name, fn in (
            ("planar_compositor_fwd",
             lambda: tck.planar_compositor_fwd_cuda(ins)),
            ("planar_compositor_bwd",
             lambda: tck.planar_compositor_bwd_cuda(ins, cot, gmap))):
        print(json.dumps({"label": args.label, "call": name, "n_rays": n,
                          "ms": cuda_ms(torch, fn, 10 * args.iters,
                                        graph=True),
                          "card": card}), flush=True)

    fp = mk.make_fused_nerf_eval(s, use_viewdir=True, encode_a=False,
                                 encode_t=True, output_flow=("bw",),
                                 static_branch=False)
    b5 = (fp.pack(params), xyz, None, None, t)
    print(json.dumps({"label": args.label, "call": "fused_nerf_eval [warp]",
                      "n_rays": n,
                      "host_us": host_call_us(
                          torch, lambda: mk.fused_nerf_eval_cuda(
                              *b5, **fp.kernel_kw)), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
