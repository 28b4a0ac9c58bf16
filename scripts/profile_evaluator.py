#!/usr/bin/env python3
"""Where a ray's time goes inside the serving evaluator (B1,
`csrc/planar_eval_comp.cu`) on the card.

    python3 scripts/profile_evaluator.py

Builds the kernel a second time with `-DWG_PROFILE` (phase stamps from
the device's global timer and SM cycle counts, kept per CTA for the
first 4096 CTAs; the normal build has none of it) into
`nsff_pl_tpu_torch/_build/`, runs the serving variant (encode_t, viewdir,
no flow maps) once at 32768 rays x 128 samples on seeded random weights
and rays, and prints per CTA (one ray): the mean time of each phase (set-up: ray data, posenc tile; the static and the
transient branch; compositing), when the helper warps had the parameters
staged and the dir bias ready, and the cycles the consumers waited for
weight slabs, the producer waited for free slots and warpgroup 0's first
thread spent in epilogues. The instrumented kernel is slower than the
normal one by the stamps it writes. Needs one CUDA card.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NCTA, NSLOT = 4096, 16


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_evaluator: no CUDA device", file=sys.stderr)
        return 2
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    so = cuda_build.BUILD_DIR / "libplanar_eval_comp_profile.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DWG_PROFILE",
                    "-o", str(so),
                    str(cuda_build.CSRC_DIR / "planar_eval_comp.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = rk._bind(lib)
    lib.nsff_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    n, s = 32768, 128
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
    op = rk.make_planar_nerf_eval_comp(s, use_viewdir=True, encode_t=True)
    pw, kw = op.pack(params), op.kernel_kw
    wp, bp = rk._slot_ptrs(pw, [k for k in rk._SLOTS if k in pw], o.device, 4,
                           False)
    out = torch.empty((n, kw["n_map"]), device="cuda")
    freqs = (ctypes.c_float * rk.MAX_FREQS)(*kw["freqs"])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = fn(o.data_ptr(), d.data_ptr(), zs.data_ptr(), None,
                dirs.data_ptr(), None, t.data_ptr(), wp, bp, out.data_ptr(),
                n, s, 3 + 6 * len(kw["freqs"]), 27, 0, freqs,
                len(kw["freqs"]), 1, 0, 1, 0, 0, kw["z_far"],
                kw["flow_scale"], kw["n_tau"], kw["n_map"], stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    launch()
    torch.cuda.synchronize()
    lib.nsff_prof_clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    buf = np.zeros(NCTA * NSLOT, np.uint64)
    lib.nsff_prof_read(buf.ctypes.data, NCTA * NSLOT)
    P = buf.reshape(NCTA, NSLOT).astype(np.int64)

    def us(a, b):
        return float(((P[:, b] - P[:, a]) / 1e3).mean())

    print(f"instrumented kernel {start.elapsed_time(end):.3f} ms; per CTA us:"
          f" total {us(0, 4):.1f} = set-up {us(0, 1):.1f} (ray data "
          f"{us(0, 8):.1f}, posenc tile {us(8, 9):.1f}) + static "
          f"{us(1, 2):.1f} + transient {us(2, 3):.1f} + compositing "
          f"{us(3, 4):.1f}; helpers: parameters staged at {us(0, 10):.1f}, "
          f"dir bias at {us(0, 11):.1f}; cycles: consumer slab waits "
          f"{P[:, 5].mean():.0f}, producer slot waits {P[:, 6].mean():.0f}, "
          f"epilogues {P[:, 7].mean():.0f} (of which barrier "
          f"{P[:, 13].mean():.0f}) on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
