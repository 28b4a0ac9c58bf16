#!/usr/bin/env python3
"""Where a ray's time goes inside the backward chain kernel
(`train_bwd_chain_kernel` of `csrc/tower_bwd_wgmma.cuh`) on the card.

    python3 scripts/profile_backward.py

Builds `csrc/fused_nerf_train.cu` a second time with `-DWG_PROFILE`
(phase stamps from the device's global timer and SM cycle counts, kept
per CTA; the normal build has none of it) into `nsff_pl_tpu_torch/_build/`,
makes `fused_nerf_train_bwd_cuda` use it, runs the static branch (main
call, viewdir) and the transient branch once each at the training batch
(512 rays x 128 samples) on seeded random weights, points and cotangents,
and prints per CTA (one ray): the mean time of each phase (set-up: ray
data, posenc tile, staged parameters; the forward tower; the final and
dir layers' products and epilogues, the heads; loading the cotangent
planes; head adjoints; the first backward epilogue, which computes the
head product; the final layer's backward; the seven tower backward
layers; the input cotangent and its posenc adjoint) and the cycles
warpgroup 0's first thread waited for weight slabs (forward and backward
products), spent in forward epilogues, in the heads, in backward
epilogues (column sums included), waiting for the previous TMA store to
have read the tile and in the column-sum hand-over, and the cycles the
producer waited for free slots. The instrumented kernel is slower
than the normal one by the stamps it writes. Needs one CUDA card.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
NCTA, NSLOT = 4096, 32


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_backward: no CUDA device", file=sys.stderr)
        return 2
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    so = cuda_build.BUILD_DIR / "libfused_nerf_train_profile.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DWG_PROFILE",
                    "-o", str(so),
                    str(cuda_build.CSRC_DIR / "fused_nerf_train.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    cuda_build._loaded["fused_nerf_train"] = lib
    lib.nsff_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

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
    xyz = (o[:, None] + d[:, None] * zs[..., None]).cuda().contiguous()
    dirs = (torch.rand(n, 27, generator=g) * 2 - 1).cuda()
    t = torch.randn(n, 48, generator=g).cuda()
    cot = torch.randn(n, s, 16, generator=g).cuda()
    op = mtk.make_fused_nerf_train(s, use_viewdir=True, encode_a=False,
                                   encode_t=True, output_flow=("fw", "bw"))
    pw = op.pack(params)
    kw = {k: op.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                       "output_flow", "flow_scale", "D",
                                       "skips")}
    # phase stamps of csrc/tower_bwd_wgmma.cuh: (from, to, name); on the
    # transient branch the dir layer's stamps equal the final epilogue's
    phases = [(0, 1, "set-up"), (1, 2, "forward tower"),
              (2, 3, "final products"), (3, 4, "final epilogue"),
              (4, 5, "dir products"), (5, 6, "last epilogue and heads"),
              (6, 7, "cotangent planes"), (7, 8, "head adjoints"),
              (8, 10, "first backward epilogue"),
              (10, 11, "to the tower backward"), (11, 12, "tower backward"),
              (12, 13, "input cotangent")]
    counters = {16: "slab waits forward", 17: "slab waits backward",
                18: "forward epilogues", 24: "heads",
                19: "backward epilogues",
                21: "waits for the tile's store", 22: "column-sum hand-over",
                23: "producer slot waits"}
    for branch in ("static", "transient"):
        def run():
            mtk.fused_nerf_train_bwd_cuda(branch, pw, xyz, dirs, None, t, cot,
                                          need_dxyz=False, **kw)
        run()
        torch.cuda.synchronize()
        lib.nsff_prof_clear()
        run()
        torch.cuda.synchronize()
        buf = np.zeros(NCTA * NSLOT, np.uint64)
        lib.nsff_prof_read(buf.ctypes.data, NCTA * NSLOT)
        P = buf.reshape(NCTA, NSLOT).astype(np.int64)[:n]
        us = {ph: float(((P[:, j] - P[:, i]) / 1e3).mean())
              for i, j, ph in phases}
        total = float(((P[:, 13] - P[:, 0]) / 1e3).mean())
        print(f"{branch}: per CTA us: total {total:.1f} = "
              + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
              + "; cycles: " + ", ".join(
                  f"{v} {P[:, k].mean():.0f}" for k, v in counters.items())
              + f" on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
