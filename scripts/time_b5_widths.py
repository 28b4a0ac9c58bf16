#!/usr/bin/env python3
"""Time the packed evaluator (B5) on the card at input widths of one to
eight 128-lane segments, and its streamed instance against the resident
ones.

    PYTHONPATH=<tree> python3 scripts/time_b5_widths.py [--label L]

Imports `nsff_pl_tpu_torch` from `<tree>` (the script's own directory
holds no package, so PYTHONPATH decides), builds that tree's
`fused_nerf_eval` and, for each width (N_emb_xyz, N_tau, N_emb_dir, N_a)
below, on seeded random weights and points (32768 rays x 128 samples,
sorted random depths, the full variant with both flow heads): times
`fused_nerf_eval_cuda` with CUDA events over `--iters` launches after
one warm-up, and checks its first 2048 rays against the plain version
(largest error, share of rows off by more than 1e-5). Where the packing
has one or two input segments it also launches the streamed instance
(`mlp_kernel.STREAM_FROM` lowered to 1) on the same inputs, reports
whether it gave the resident instance's bits, and times both. The
checks that decide are `chip_smoke.py`'s and the card tests', not these.
Prints one JSON line per width with the card's name and power limit.
Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys

# (N_emb_xyz, N_tau, N_emb_dir, N_a or None): one, two, three, four and
# eight input segments, and the wide direction and appearance embeddings
WIDTHS = ((10, 48, 4, None), (10, 80, 4, None), (10, 200, 4, None),
          (43, 48, 4, None), (10, 321, 4, None), (43, 200, 4, None),
          (10, 80, 22, 160), (10, 900, 4, None))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_b5_widths: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops.posenc import posenc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    cuda_build.build(["fused_nerf_eval"])
    n, S, m = 32768, 128, 2048
    g = torch.Generator().manual_seed(0)
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, S, generator=g), 1).values
    xyz = (o[:, None] + d[:, None] * zs[..., None]).cuda().contiguous()
    d = d.cuda()

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    for n_emb, n_tau, n_dir, n_a in WIDTHS:
        params = tn.init_nerf_params(
            torch.Generator().manual_seed(1), "fine",
            in_channels_xyz=3 + 6 * n_emb, use_viewdir=True,
            in_channels_dir=3 + 6 * n_dir, encode_appearance=n_a is not None,
            in_channels_a=n_a or 48, encode_transient=True,
            in_channels_t=n_tau, output_flow=True, device="cuda")
        fn = mk.make_fused_nerf_eval(
            S, use_viewdir=True, encode_a=n_a is not None, encode_t=True,
            output_flow=("fw", "bw"), n_emb_xyz=n_emb, n_tau=n_tau,
            n_emb_dir=n_dir, n_a=n_a or 48)
        pw = fn.pack(params)
        de = posenc(d, 3.0, n_dir).contiguous()
        a = (torch.randn(n, n_a, generator=g).cuda().contiguous()
             if n_a else None)
        t = torch.randn(n, n_tau, generator=g).cuda().contiguous()
        call = (pw, xyz, de, a, t)
        kw = fn.kernel_kw
        got = mk.fused_nerf_eval_cuda(*call, **kw)
        want = mk.fused_nerf_eval_ref(
            pw, xyz[:m], de[:m], a[:m] if a is not None else None, t[:m],
            **kw)
        err = (got[:m] - want).abs()
        segs = mk.packed_in_rows(pw) // 128
        rec = {"label": args.label, "n_emb_xyz": n_emb, "n_tau": n_tau,
               "n_emb_dir": n_dir, "n_a": n_a, "segments": segs,
               "max_abs_err": float(err.max()),
               "rows_off_1e-5": float((err.amax(-1) > 1e-5).float().mean()),
               "finite": bool(torch.isfinite(got).all()),
               "ms": ms(lambda: mk.fused_nerf_eval_cuda(*call, **kw))}
        if segs <= 2:
            stream_from = mk.STREAM_FROM
            mk.STREAM_FROM = 1
            try:
                streamed = mk.fused_nerf_eval_cuda(*call, **kw)
                torch.cuda.synchronize()
                rec["streamed_same_bits"] = bool(torch.equal(streamed, got))
                rec["streamed_ms"] = ms(
                    lambda: mk.fused_nerf_eval_cuda(*call, **kw))
            finally:
                mk.STREAM_FROM = stream_from
            rec["resident_ms_again"] = ms(
                lambda: mk.fused_nerf_eval_cuda(*call, **kw))
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        del params, pw, got, want, call
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
