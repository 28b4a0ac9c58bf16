#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`nsff_pl_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (`nvcc`); builds the port's
kernels from `nsff_pl_tpu_torch/csrc/` (one `nvcc` per source, all at
once), then:

1. kernel phase: every kernel against its plain PyTorch version on the
   same inputs at full width (D=8, W=256, S=128): the serving evaluator
   at the serving chunk (and at 4096 rays with flow maps and visibility,
   static only, and a ragged 37 rays); the train evaluator's forward and
   both backward branches on the main evaluation and both warped
   evaluations, and the compositor's forward and adjoint, at batch 512;
   the packed evaluator at the serving chunk (full, static only,
   transient only) and at 37 rays, its backward at batch 512 (static;
   transient with and without the xyz cotangent) and the packed
   compositor's forward and adjoint at batch 512 and 8192, beside the
   launch floor (an empty kernel on the compositor's grid, the same
   stopwatch). Prints each output's
   error, times the kernel and the plain version with CUDA events and
   computes the bound (operations or bytes) from the shapes; the train
   evaluator's forward is timed in all three calls (main and both warps,
   each with its bound) with its host time per call; the two no-grad
   evaluators also print their TFLOP/s and share of the bound;
   each backward's main calls also print the device ms per call of its
   chain, dW and reduction phases (torch.profiler) and, as a yardstick,
   the cuBLAS time of the dW products on operands of the same shapes;
2. serving phase (a main path): a `RenderService` at the flagship
   serving configuration (512x288, 30 frames, encode_t, use_viewdir,
   N_samples 128, bfloat16, chunk 32768) with seeded weights answers three
   `render_pose` calls and one `POST /render` on 127.0.0.1, with the
   launch counts read around exactly those requests;
3. training phase (a main path): the flagship training recipe (512x288,
   30 frames, encode_t, use_viewdir, N_samples 128, batch 512, Adam lr
   5e-4 cosine over 50 epochs, bfloat16) on a synthetic 30 x 147456 x 16
   ray table on the card, through `FrameScheduler` and `make_train_step`:
   one warm-up step, then `TRAIN_STEPS` timed steps with the launch
   counts read around exactly them, on frames and draws drawn up front;
   then the same steps from a copy of the state taken before them as one
   graphed dispatch (`make_train_step(scan_steps=TRAIN_STEPS)`, a CUDA
   graph): its loss terms must equal the eager ones within GRAPH_RTOL,
   a second dispatch is timed with its launches counted as the capture's
   times the replays, and torch.profiler over a third counts the kernels
   the replays ran; then `TRAIN_STEPS` eager steps on one repeated batch,
   whose loss must fall;
4. packed serving phase (a main path): one frame through a
   `RenderService` with `planar_eval="off"` in bfloat16 (the packed
   evaluator, once per chunk, compositing outside it), held against the
   planar frame, and one in float32 (the plain evaluators, no kernel);
5. packed training phase (a main path): the same recipe with
   `fused_train="off"` and `fused_compositing=True` (render_rays +
   compute_losses): the same eager, graphed and repeated-batch runs,
   and three steps of the static-only model (no `encode_t`), eager and
   graphed;
6. scene training phase (a main path): a seeded, learnable scene of 30
   frames at 1024x576 written to chip_smoke_out/scene/ with the port's
   own writers (RGB PNGs whose rows cycle through all five filters,
   16-bit disparity PNGs, grey masks, `.flo` flows, a COLMAP binary
   model), then the train CLI (`apps.train.cli`, in process) at the
   flagship recipe with `--hard_sampling --scan_steps 10 --num_epochs 1
   --val_every_steps 1000`: a fresh system's validation, a first run
   stopped mid-epoch by `--time_budget_s` (a checkpoint), its resume by
   `--ckpt_path` to the end of the epoch, and a packed run of a few
   hundred steps (`--fused_train off --fused_compositing`). Checks: one
   capture per dispatch shape, launches per step as PER_STEP /
   PER_STEP_PACKED (validations on the serving evaluator), the resume's
   params and Adam state equal to the checkpoint file bit for bit,
   finite loss rows, and the last validation's PSNR above the fresh
   one's by PSNR_GAIN_DB; prints the scene load, the CLI's ms per step
   beside the graphed step, seconds per validation and checkpoint, each
   validation's PSNR and SSIM;
7. eval phase (a main path): the eval CLI (`apps.evaluate`, in process)
   on that scene with the checkpoint run 2 wrote (trained weights), in
   bfloat16, each frame as 5 equal chunks of 29696 rays in one CUDA graph
   replay: the test split (30 frames, both towers with
   `--output_transient`, depth maps, PSNR / SSIM tables,
   LPIPS n/a), each frame held against the host loop's (GRAPH_TOL), its
   PSNR against the untrained render's (PSNR_GAIN_DB), a flatness floor
   (FLAT_STD), and three frames of the static tower in float32 on the
   plain evaluators against bfloat16 (F32_TOL); the spiral (180 frames), again with `--fix_view_dir`;
   `test_fixview0_interp4` (30 items) on the planes route (B2's forward
   + B3: held against B1's composited route within FRAME_TOL, its dt = 0
   frame against the t render, the splat twice for the same bits, in its
   shift form and in its scatter form, the two forms within SPLAT_TOL,
   every interpolated frame finite in [0, 1], ms per splat call and per
   interpolated frame); the test split with `--planar_eval off` (B5),
   its frame 0 against the B1 frame (FRAME_TOL). B2's forward, B3's
   forward and B5 are each held against their plain versions on the
   inputs their path gives them on the first 29696-ray chunk of frame 0
   (PLANE_TOL / PLANE_SHARE, COMP_TOL, PACKED_TOL / PACKED_SHARE). Each
   run's launches: the wrappers' counts against its graph's warm-up and
   capture, one graph, one replay a frame;
8. agreement: a small frame rendered on the card equals the plain CPU
   render of the same weights within `TOL`; one training step at batch
   64 on the card equals the plain CPU step from the same state, batch
   and draws (loss terms and Adam's first moments), on the planar and on
   the packed path.

The training phases end with a torch.profiler trace of 5 more steps
(device time by kernel, the device's busy share and the backward's
phases per step; the full tables go to chip_smoke_out/).

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the script exits non-zero and prints no result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

# kernel vs plain version: the same bf16 rounding points, f32 sums in
# another order (measured ~3e-5 at full width)
TOL = 5e-4
# train evaluator, kernel vs plain version: per-sample planes show a bf16
# rounding flip of an activation whole, so planes are held to PLANE_TOL
# abs with at most PLANE_SHARE of the samples off by more than 1e-5;
# gradients to GRAD_MAX of each leaf's largest entry and GRAD_FRO in
# Frobenius norm (such a flip can turn a ReLU mask of one sample)
PLANE_TOL, PLANE_SHARE = 2e-3, 0.2
GRAD_MAX, GRAD_FRO = 0.1, 5e-2
# compositor kernels vs plain versions: the same f32 formulas, scans and
# transcendentals in another order
COMP_TOL = 1e-4
# the graphed dispatch vs the same steps run eagerly on the card: the
# same kernels on the same inputs
GRAPH_RTOL = 1e-4
# card training step vs the plain CPU step: loss terms (the depth loss
# normalizes by the batch median and MAD, which carries a flip to every
# ray)
LOSS_RTOL = 2e-3
# packed evaluator vs plain version: per-sample rows, as PLANE_TOL above;
# the share counts a row whose largest of 14 columns is off (measured
# 1.9e-4, 4.9% of the rows at the serving chunk)
PACKED_TOL, PACKED_SHARE = 1e-3, 0.2
# per-sample xyz cotangent of the packed backward: a flipped ReLU mask
# shows whole in that sample's entry (no sum over rows dilutes it), so the
# largest entry is held to DX_MAX; the Frobenius bound is GRAD_FRO
DX_MAX = 0.25
# packed frame vs planar frame of the same weights: the posenc argument
# is (o + d*z)*f on one path and o*f + (d*f)*z on the other, and the
# transmittance a product on one and an exponential of a sum on the other
# (measured 5.0e-6 on the seeded weights)
FRAME_TOL = 5e-4
# float32 frame (plain evaluators) vs the bfloat16 frame (kernels): bf16
# rounding of every activation through nine layers (measured 4.4e-5 on
# the seeded weights, whose frame is nearly flat)
F32_TOL = 1e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
CHUNK = 32768
RAGGED = 37  # an odd ray count, below one wave of CTAs
W_IMG, H_IMG, N_FRAMES = 512, 288, 30
BATCH = 512
LARGE_BATCH = 8192  # the packed compositor is also timed here
TRAIN_STEPS = 10
# kernel launches per training step: train forward (main + two warps),
# backward static branch (main), backward transient branch (all three),
# compositor forward and adjoint
PER_STEP = {"planar_nerf_train_fwd": 3, "planar_nerf_train_bwd_static": 1,
            "planar_nerf_train_bwd_transient": 3,
            "planar_compositor_fwd": 1, "planar_compositor_bwd": 1}
# the packed path: three evaluator forwards (main + two warps), backward
# static branch (main), backward transient branch (all three), the fused
# compositor on the main evaluation
PER_STEP_PACKED = {"fused_nerf_eval": 3, "fused_nerf_train_bwd_static": 1,
                   "fused_nerf_train_bwd_transient": 3,
                   "fused_compositing_fwd": 1, "fused_compositing_bwd": 1}
PER_STEP_STATIC = {"fused_nerf_eval": 1, "fused_nerf_train_bwd_static": 1,
                   "fused_nerf_train_bwd_transient": 0,
                   "fused_compositing_fwd": 0, "fused_compositing_bwd": 0}
STATIC_STEPS = 3


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def scene(np):
    """Synthetic forward-facing scene: K and N_FRAMES poses on a small
    circle in the model's centered frame (cameras look down -z)."""
    f = 0.9 * W_IMG
    K = np.array([[f, 0, W_IMG / 2], [0, f, H_IMG / 2], [0, 0, 1]],
                 np.float32)
    poses = np.zeros((N_FRAMES, 3, 4), np.float32)
    for i in range(N_FRAMES):
        a = 2 * np.pi * i / N_FRAMES
        poses[i, :, :3] = np.eye(3)
        poses[i, :, 3] = [0.05 * np.cos(a), 0.03 * np.sin(a), 0.0]
    return K, poses


def cuda_ms(torch, fn, iters: int, warmup: int = 1,
            graph: bool = False) -> float:
    """Mean device ms of fn over iters calls between CUDA events. With
    `graph`, the calls are captured once in a CUDA graph and replayed, so
    a kernel shorter than its host-side launch is timed, not the launch
    rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_call_us(torch, fn, calls: int = 100, batches: int = 7) -> float:
    """Host microseconds of one call of a kernel wrapper, from call to
    return (the launch is asynchronous): the median over `batches` runs
    of `calls` calls each (the host is shared, so single runs scatter),
    after a warm-up, the device queue drained before each run."""
    fn()
    runs = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return sorted(runs)[batches // 2]


def eval_comp_work(params, kw, n: int, S: int, pw):
    """(flops, bytes) the composited evaluator must do for n rays: model
    MACs at the unpadded widths (per-ray direction/appearance terms once
    per ray), each input and weight read once, the maps written once."""
    def macs(name):
        w = params[name]["w"]
        return w.shape[0] * w.shape[1]

    per_sample = sum(macs(f"static_xyz_{i}") for i in range(8))
    per_sample += macs("static_xyz_final") + macs("static_sigma") \
        + macs("static_rgb")
    per_ray = 0
    if kw["use_viewdir"]:
        w = params["static_dir"]["w"]
        per_sample += 256 * w.shape[1]
        per_ray += (w.shape[0] - 256) * w.shape[1]
    if kw["encode_t"]:
        per_sample += sum(macs(f"transient_xyz_{i}") for i in range(8))
        per_sample += macs("transient_xyz_final")
        per_sample += 256 * (10 if kw["flow_maps"] else 4)
    flops = 2.0 * (per_sample * n * S + per_ray * n)
    in_bytes = n * (3 + 3 + S) * 4
    if kw["use_viewdir"]:
        in_bytes += n * 27 * 4
    if kw["encode_t"]:
        in_bytes += n * kw["n_tau"] * 4
    w_bytes = sum(t.numel() * t.element_size()
                  for v in pw.values() for t in v.values())
    return flops, in_bytes + w_bytes + n * kw["n_map"] * 4


def _mac(params, name):
    w = params[name]["w"]
    return w.shape[0] * w.shape[1]


def train_fwd_work(params, static_branch: bool, n_flow_out: int, n: int,
                   S: int, pw, n_out: int, flow_in: bool,
                   encode_t: bool = True, packed: bool = False):
    """(flops, bytes) of one train-evaluator forward call: model MACs at the
    unpadded widths (direction terms once per ray), each input and the
    weights the call reads once, its planes written once. `packed`: the
    packed-boundary evaluator, which reads (n, S, 3) points and writes
    `n_out`-column rows."""
    per_sample = per_ray = 0
    names = []
    if static_branch:
        names += [f"static_xyz_{i}" for i in range(8)] + [
            "static_xyz_final", "static_dir", "static_sigma", "static_rgb"]
        per_sample += sum(_mac(params, k) for k in names if k != "static_dir")
        w = params["static_dir"]["w"]
        per_sample += 256 * w.shape[1]
        per_ray += (w.shape[0] - 256) * w.shape[1]
    if encode_t:
        tnames = [f"transient_xyz_{i}" for i in range(8)] + [
            "transient_xyz_final"]
        per_sample += sum(_mac(params, k) for k in tnames)
        per_sample += 256 * (4 + 3 * n_flow_out)
        names += tnames + ["transient_heads"]
    flops = 2.0 * (per_sample * n * S + per_ray * n)
    if packed:
        nbytes = n * S * 3 * 4
    else:
        nbytes = n * (3 + 3 + S) * 4 + (3 * n * S * 4 if flow_in else 0)
    nbytes += n * 48 * 4 if encode_t else 0
    nbytes += n * 27 * 4 if static_branch else 0
    nbytes += sum(t.numel() * t.element_size() for k in names
                  for t in pw[k].values())
    return flops, nbytes + n_out * n * S * 4


def train_bwd_work(params, branch: str, n_flow_out: int, n: int, S: int,
                   pw, flow_in: bool, packed: bool = False,
                   need_dxyz: bool = False):
    """(flops, bytes) of one backward branch: the tower recompute, the
    weight gradient and the data gradient of every layer at the unpadded
    widths (the static branch has no input gradient unless the packed
    call asks for the xyz cotangent), each input, weight and cotangent
    read once, every gradient written once. `packed`: (n, S, 3) points in,
    16-column cotangent rows in, (n, S, 3) xyz cotangent out with
    `need_dxyz`."""
    if branch == "static":
        names = [f"static_xyz_{i}" for i in range(8)] + [
            "static_xyz_final", "static_sigma", "static_rgb"]
        per_sample = 3 * sum(_mac(params, k) for k in names)
        if not need_dxyz:
            # no data gradient into the encoding: layer 0 and the skip input
            per_sample -= 2 * 63 * 256
        w = params["static_dir"]["w"]
        per_sample += 3 * 256 * w.shape[1]
        per_ray = 2 * (w.shape[0] - 256) * w.shape[1]
        names.append("static_dir")
        n_g, extra_in = 4, n * 27 * 4
        out = sum(_mac(params, k) + params[k]["b"].numel() for k in names)
        out_bytes = out * 4 + n * 27 * 4
    else:
        names = [f"transient_xyz_{i}" for i in range(8)] + [
            "transient_xyz_final"]
        per_sample = 3 * (sum(_mac(params, k) for k in names)
                          + 256 * (4 + 3 * n_flow_out))
        per_ray = 0
        n_g = 4 + 3 * n_flow_out
        extra_in = n * 48 * 4 + (3 * n * S * 4 if flow_in else 0)
        out = sum(_mac(params, k) + params[k]["b"].numel() for k in names)
        out_bytes = (out + 257 * (4 + 3 * n_flow_out)) * 4 + n * 48 * 4 + (
            3 * n * S * 4 if flow_in else 0)
        names.append("transient_heads")
    flops = 2.0 * (per_sample * n * S + per_ray * n)
    if packed:
        nbytes = n * S * 3 * 4 + extra_in + 16 * n * S * 4
        out_bytes += 3 * n * S * 4 if need_dxyz else 0
    else:
        nbytes = n * (3 + 3 + S) * 4 + extra_in + n_g * n * S * 4
    nbytes += sum(t.numel() * t.element_size() for k in names
                  for t in pw[k].values())
    return flops, nbytes + out_bytes


# f32 operations per sample of the compositor (softplus, exponentials,
# products and scan steps; counted from csrc/planar_compositor.cu)
COMP_OPS = {"fwd": 80, "bwd": 200}
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def comp_work(which: str, n: int, S: int):
    planes = 21 + 5 if which == "fwd" else 21 + 5 + 16
    maps = 16 * n * 4
    return COMP_OPS[which] * n * S, planes * n * S * 4 + maps


# the packed compositor (counted from csrc/fused_compositing.cu)
PACKED_COMP_OPS = {"fwd": 50, "bwd": 110}


def packed_comp_work(which: str, n: int, S: int):
    """(operations, bytes): columns 0-7 of the packed (n, S, 16) rows (the
    compositor needs no other, and they are one 32-byte sector of each
    64-byte row), zs and two noise planes read once; forward writes seven
    planes and (n, 4) maps, the adjoint reads their cotangents and writes
    the whole (n, S, 16) cotangent, columns 8-15 as zeros."""
    words = 8 + 3 + 7 if which == "fwd" else 8 + 3 + 7 + 16
    return PACKED_COMP_OPS[which] * n * S, words * n * S * 4 + 4 * n * 4


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_errs(got, want):
    """(largest |got - want| over the largest |want|, Frobenius ratio,
    largest |got - want|)."""
    scale = max(float(want.abs().max()), 1e-12)
    fro = float((got - want).norm()) / max(float(want.norm()), 1e-12)
    err = float((got - want).abs().max())
    return err / scale, fro, err


def train_kernel_phase(torch, np, rk, tck, params, rays, card):
    """The four training kernels against their plain versions at batch
    512 on the main variant and both warps; returns their kernel records
    (launches filled in by the training phase)."""
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs

    S, n = 128, BATCH
    gen = torch.Generator(device="cuda").manual_seed(2)
    o, d = rays[:n, :3].contiguous(), rays[:n, 3:].contiguous()
    zs = stratified_zs(n, S, 1.0, torch.rand((n, S), generator=gen,
                                             device="cuda"),
                       device="cuda")[0].contiguous()
    de = posenc(d, 3.0, 4).contiguous()
    t_emb = params["embedding_t"][torch.randint(
        0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
    fine = params["nerf_fine"]
    main_op = rk.make_planar_nerf_train(S, use_viewdir=True,
                                        output_flow=("fw", "bw"))
    pw = main_op.pack(fine)
    # the weight packing runs once per step, for the three evaluations
    pack_ms = cuda_ms(torch, lambda: main_op.pack(fine), iters=10)
    print(f"weight packing (once per training step): {pack_ms:.3f} ms on "
          f"{card}", flush=True)
    records, planes = {}, {}
    src = "nsff_pl_tpu_torch/csrc/planar_nerf_train.cu"
    for label, static_branch, flow_in, flow in (
            ("main", True, False, ("fw", "bw")),
            ("fw warp", False, True, ("bw",)),
            ("bw warp", False, True, ("fw",))):
        op = rk.make_planar_nerf_train(S, static_branch=static_branch,
                                       flow_in=flow_in, use_viewdir=True,
                                       output_flow=flow)
        flows = tuple((0.05 * torch.randn((n, S), generator=gen,
                                          device="cuda")).contiguous()
                      for _ in range(3)) if flow_in else None
        args = (pw, o, d, zs, flows, de if static_branch else None, None,
                t_emb)
        kw = op.kernel_kw
        got = rk.planar_nerf_train_fwd_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = rk.planar_nerf_train_ref(*args, **kw)
        if not bool(torch.isfinite(got).all()):
            fail(f"train forward output not finite ({label})")
        err = (got - want).abs()
        worst = err.amax((1, 2)).cpu().numpy()
        share = float((err > 1e-5).float().mean())
        print(f"kernel planar_nerf_train_fwd [{label}] n={n} S={S}: max abs "
              f"err per plane {np.array2string(worst, precision=2)}, share "
              f"> 1e-5 {share:.3f} (tol {PLANE_TOL}, {PLANE_SHARE})",
              flush=True)
        if float(worst.max()) > PLANE_TOL or share > PLANE_SHARE:
            fail(f"planar_nerf_train forward disagrees ({label})")
        planes[label] = dict(zip(op.out_keys, got))
        ms = cuda_ms(torch, lambda: rk.planar_nerf_train_fwd_cuda(
            *args, **kw), iters=10, graph=True)
        host_us = host_call_us(torch, lambda: rk.planar_nerf_train_fwd_cuda(
            *args, **kw))
        flops, nbytes = train_fwd_work(fine, static_branch, len(flow), n, S,
                                       pw, len(op.out_keys), flow_in)
        bms, bby = bound(flops, nbytes)
        if label == "main":
            plain_ms = cuda_ms(torch, lambda: rk.planar_nerf_train_ref(
                *args, **kw), iters=3)
            records["planar_nerf_train_fwd"] = {
                "name": "planar_nerf_train_fwd", "route": "cuda",
                "source": src,
                "replaces": "nsff_pl_tpu/ops/raymarch_kernel.py:64",
                "launches": None, "max_abs_err": float(worst.max()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": bby, "library_ms": None, "host_us": host_us,
                "warp_ms_each": []}
            print(f"kernel planar_nerf_train_fwd [main] n={n}: {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bms:.3f} ms "
                  f"({flops / 1e12:.3f} TFLOP), host {host_us:.1f} us per "
                  f"call on {card}", flush=True)
        else:
            rec = records["planar_nerf_train_fwd"]
            rec["max_abs_err"] = max(rec["max_abs_err"], float(worst.max()))
            rec["warp_ms_each"].append(ms)
            rec["warp_ms"] = sum(rec["warp_ms_each"]) / len(
                rec["warp_ms_each"])
            rec["warp_bound_ms"] = bms
            rec["warp_host_us"] = host_us
            print(f"kernel planar_nerf_train_fwd [{label}] n={n}: {ms:.3f} "
                  f"ms, bound {bms:.3f} ms ({flops / 1e12:.3f} TFLOP), host "
                  f"{host_us:.1f} us per call on {card}", flush=True)

        cot = {k: torch.randn((n, S), generator=gen, device="cuda")
               for k in op.out_keys}
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "flow_scale", "D", "skips")}
        for branch in (["static"] if static_branch else []) + ["transient"]:
            got_b = rk.planar_nerf_train_bwd_cuda(branch, *args, cot, **bkw)
            torch.cuda.synchronize()
            want_b = rk.planar_nerf_train_bwd_ref(branch, *args, cot, **bkw)
            pairs = [(f"{k}.{p}", got_b["dws"][k][p], want_b["dws"][k][p])
                     for k in want_b["dws"] for p in ("w", "b")]
            pairs += [(k, got_b[k], want_b[k]) for k in ("ddir", "dt")
                      if k in want_b]
            pairs += [(f"dflow{c}", got_b["dflows"][c], want_b["dflows"][c])
                      for c in range(3) if "dflows" in want_b]
            errs = {}
            for name, a, b in pairs:
                if not bool(torch.isfinite(a).all()):
                    fail(f"train backward {name} not finite ({label})")
                errs[name] = rel_errs(a, b)
            w_max = max(errs, key=lambda k: errs[k][0])
            w_fro = max(errs, key=lambda k: errs[k][1])
            abs_err = max(e[2] for e in errs.values())
            print(f"kernel planar_nerf_train_bwd_{branch} [{label}]: "
                  f"{len(errs)} outputs, worst error/max {errs[w_max][0]:.2e} "
                  f"({w_max}), worst Frobenius {errs[w_fro][1]:.2e} "
                  f"({w_fro}) (tol {GRAD_MAX}, {GRAD_FRO})", flush=True)
            if errs[w_max][0] > GRAD_MAX or errs[w_fro][1] > GRAD_FRO:
                fail(f"planar_nerf_train backward ({branch}, {label}) "
                     "disagrees with its plain version")
            name = f"planar_nerf_train_bwd_{branch}"
            if label == "main":
                ms = cuda_ms(torch, lambda: rk.planar_nerf_train_bwd_cuda(
                    branch, *args, cot, **bkw), iters=5, graph=True)
                plain_ms = cuda_ms(torch, lambda: rk.planar_nerf_train_bwd_ref(
                    branch, *args, cot, **bkw), iters=2)
                flops, nbytes = train_bwd_work(fine, branch, 2, n, S, pw,
                                               False)
                bms, bby = bound(flops, nbytes)
                records[name] = {
                    "name": name, "route": "cuda", "source": src,
                    "replaces": "nsff_pl_tpu/ops/raymarch_kernel.py:64",
                    "launches": None, "max_abs_err": abs_err,
                    "max_rel_err": errs[w_max][0], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                    "library_ms": None}
                print(f"kernel {name} [main] n={n}: {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms, bound {bms:.3f} ms "
                      f"({flops / 1e12:.3f} TFLOP) on {card}", flush=True)
                bwd_phases(torch, records[name],
                           lambda: rk.planar_nerf_train_bwd_cuda(
                               branch, *args, cot, **bkw),
                           n, S, branch == "static", card)
            else:
                _fold_errs(records[name], abs_err, errs[w_max][0])
        del got, want

    # compositor on the three evaluations' planes
    main, w1, w2 = planes["main"], planes["fw warp"], planes["bw warp"]
    ins = {"zs": zs, "ssig": main["ssig"], "tsig": main["tsig"],
           "tsig_w1": w1["tsig"], "tsig_w2": w2["tsig"]}
    for k in ("ns", "nt", "nw1", "nw2"):
        ins[k] = torch.randn((n, S), generator=gen, device="cuda")
    for c in "rgb":
        ins[f"srgb_{c}"] = main[f"srgb_{c}"]
        ins[f"trgb_{c}"] = main[f"trgb_{c}"]
        ins[f"trgb_w1_{c}"] = w1[f"trgb_{c}"]
        ins[f"trgb_w2_{c}"] = w2[f"trgb_{c}"]
    ins = {k: v.contiguous() for k, v in ins.items()}
    cot = {k: torch.randn((n, S), generator=gen, device="cuda")
           for k in tck.OUT_KEYS}
    gmap = torch.randn((n, tck.N_MAP), generator=gen, device="cuda")
    w, maps = tck.planar_compositor_fwd_cuda(ins)
    dg = tck.planar_compositor_bwd_cuda(ins, cot, gmap)
    torch.cuda.synchronize()
    rw, rmaps = tck.planar_compositor_fwd_ref(ins)
    rdg = tck.planar_compositor_bwd_ref(ins, cot, gmap)
    fwd_err = max(float((w - rw).abs().max()),
                  float((maps - rmaps).abs().max()))
    bwd_errs = [rel_errs(dg[i], rdg[i]) for i in range(len(dg))]
    bwd_err = max(e[0] for e in bwd_errs)
    bwd_abs = max(e[2] for e in bwd_errs)
    print(f"kernel planar_compositor: forward max abs err {fwd_err:.2e}, "
          f"adjoint worst error/max {bwd_err:.2e} (tol {COMP_TOL})",
          flush=True)
    if fwd_err > COMP_TOL or bwd_err > COMP_TOL:
        fail("planar_compositor disagrees with its plain version")
    csrc = "nsff_pl_tpu_torch/csrc/planar_compositor.cu"
    for which, fn, ref, err in (
            ("fwd", lambda: tck.planar_compositor_fwd_cuda(ins),
             lambda: tck.planar_compositor_fwd_ref(ins), fwd_err),
            ("bwd", lambda: tck.planar_compositor_bwd_cuda(ins, cot, gmap),
             lambda: tck.planar_compositor_bwd_ref(ins, cot, gmap), bwd_abs)):
        ms = cuda_ms(torch, fn, iters=100, graph=True)
        plain_ms = cuda_ms(torch, ref, iters=10, graph=True)
        ops, nbytes = comp_work(which, n, S)
        bms, bby = bound(ops, nbytes, PEAK_F32_FLOPS)
        name = f"planar_compositor_{which}"
        records[name] = {
            "name": name, "route": "cuda", "source": csrc,
            "replaces": "nsff_pl_tpu/ops/compositing_planar_kernel.py:110",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None}
        if which == "bwd":
            records[name]["max_rel_err"] = bwd_err
        print(f"kernel {name} n={n}: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bms:.4f} ms ({nbytes / 1e6:.2f} MB) on {card}",
              flush=True)
    return records


def _fold_errs(record, abs_err, rel_err):
    """Keep a record's worst absolute and relative error over variants."""
    record["max_abs_err"] = max(record["max_abs_err"], abs_err)
    record["max_rel_err"] = max(record["max_rel_err"], rel_err)


def _record(name, source, replaces, err, ms, plain_ms, flops, nbytes,
            peak=PEAK_BF16_FLOPS):
    bms, bby = bound(flops, nbytes, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None}


def rate_line(flops, ms, bound_ms):
    """Achieved TFLOP/s and share of the bound of a kernel time."""
    return (f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{100 * bound_ms / ms:.1f}% of the bound")


def packed_kernel_phase(torch, np, params, rays, card):
    """The packed-boundary kernels against their plain versions: the
    evaluator at the serving chunk (full, static only, transient only),
    its backward at batch 512 (static; transient with and without the xyz
    cotangent) and the compositor at batch 512. Returns their kernel
    records (launches filled in by the packed phases)."""
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs

    S = 128
    fine = params["nerf_fine"]
    gen = torch.Generator(device="cuda").manual_seed(4)

    def inputs(n):
        o, d = rays[:n, :3], rays[:n, 3:]
        zs = stratified_zs(n, S, 1.0, torch.rand((n, S), generator=gen,
                                                 device="cuda"),
                           device="cuda")[0].contiguous()
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        t_emb = params["embedding_t"][torch.randint(
            0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
        return xyz, zs, posenc(d, 3.0, 4).contiguous(), t_emb

    records = {}
    # ---- the evaluator at the serving chunk
    n = CHUNK
    xyz, _, de, te = inputs(n)
    src = "nsff_pl_tpu_torch/csrc/fused_nerf_eval.cu"
    for label, static_branch, encode_t, flow, n in (
            ("full", True, True, ("fw", "bw"), CHUNK),
            ("static only", True, False, (), CHUNK),
            ("transient only", False, True, ("bw",), CHUNK),
            ("full, ragged", True, True, ("fw", "bw"), RAGGED)):
        fn = mk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                     encode_t=encode_t, output_flow=flow,
                                     static_branch=static_branch)
        pw = fn.pack(fine)
        args = (pw, xyz[:n], de[:n] if static_branch else None, None,
                te[:n] if encode_t else None)
        kw = fn.kernel_kw
        got = mk.fused_nerf_eval_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = mk.fused_nerf_eval_ref(*args, **kw)
        if not bool(torch.isfinite(got).all()):
            fail(f"packed evaluator output not finite ({label})")
        err = (got - want).abs()
        worst = err.amax((0, 1)).cpu().numpy()
        share = float((err.amax(-1) > 1e-5).float().mean())
        del err, want
        print(f"kernel fused_nerf_eval [{label}] n={n} S={S}: max abs err "
              f"per column {np.array2string(worst, precision=2)}, rows off "
              f"by > 1e-5 {share:.4f} (tol {PACKED_TOL}, {PACKED_SHARE})",
              flush=True)
        if float(worst.max()) > PACKED_TOL or share > PACKED_SHARE:
            fail(f"fused_nerf_eval disagrees with its plain version ({label})")
        zero_cols = ([] if static_branch else [0, 1, 2, 3]) + list(
            range(8 + 3 * len(flow) if encode_t else 4, 16))
        if bool(got[..., zero_cols].any()):
            fail(f"fused_nerf_eval wrote unused columns ({label})")
        del got
        err = float(worst.max())
        if label == "full, ragged":
            records["fused_nerf_eval"]["max_abs_err"] = max(
                records["fused_nerf_eval"]["max_abs_err"], err)
            continue
        flops, nbytes = train_fwd_work(fine, static_branch, len(flow), n, S,
                                       pw, 16, False, encode_t=encode_t,
                                       packed=True)
        ms = cuda_ms(torch, lambda: mk.fused_nerf_eval_cuda(*args, **kw),
                     iters=3)
        plain_ms = cuda_ms(torch, lambda: mk.fused_nerf_eval_ref(*args, **kw),
                           iters=1, warmup=0)
        bms = bound(flops, nbytes)[0]
        if label == "full":
            records["fused_nerf_eval"] = _record(
                "fused_nerf_eval", src,
                "nsff_pl_tpu/ops/mlp_kernel.py:121", err, ms,
                plain_ms, flops, nbytes)
        else:
            rec = records["fused_nerf_eval"]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(f"kernel fused_nerf_eval [{label}] n={n}: {ms:.3f} ms "
              f"({rate_line(flops, ms, bms)}), plain "
              f"{plain_ms:.3f} ms, bound {bms:.3f} ms "
              f"({flops / 1e12:.2f} TFLOP) on {card}", flush=True)
    del xyz, de, te

    # ---- the backward at the training batch
    n = BATCH
    xyz, zs, de, te = inputs(n)
    src = "nsff_pl_tpu_torch/csrc/fused_nerf_train.cu"
    g = torch.randn((n, S, 16), generator=gen, device="cuda")
    packed_main = None
    for label, static_branch, flow, branch, need_dxyz in (
            ("main", True, ("fw", "bw"), "static", False),
            ("main", True, ("fw", "bw"), "transient", False),
            ("fw warp", False, ("bw",), "transient", True),
            ("bw warp", False, ("fw",), "transient", True),
            ("main + dxyz", True, ("fw", "bw"), "static", True)):
        op = mtk.make_fused_nerf_train(S, use_viewdir=True, encode_a=False,
                                       encode_t=True, output_flow=flow,
                                       static_branch=static_branch,
                                       need_dxyz=need_dxyz)
        pw = op.pack(fine)
        kw = op.kernel_kw
        if packed_main is None:
            packed_main = mk.fused_nerf_eval_cuda(pw, xyz, de, None, te, **kw)
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "output_flow", "flow_scale", "D", "skips")}
        args = (branch, pw, xyz, de if static_branch else None, None, te, g)
        got = mtk.fused_nerf_train_bwd_cuda(*args, need_dxyz=need_dxyz, **bkw)
        torch.cuda.synchronize()
        want = mtk.fused_nerf_train_bwd_ref(*args, need_dxyz=need_dxyz, **bkw)
        if ("dxyz" in got) != need_dxyz:
            fail(f"need_dxyz={need_dxyz} but dxyz present: {'dxyz' in got}")
        pairs = [(f"{k}.{p}", got["dws"][k][p], want["dws"][k][p])
                 for k in want["dws"] for p in ("w", "b")]
        pairs += [(k, got[k], want[k]) for k in ("ddir", "dt") if k in want]
        errs = {}
        for name, a, b in pairs:
            if not bool(torch.isfinite(a).all()):
                fail(f"packed backward {name} not finite ({label})")
            errs[name] = rel_errs(a, b)
        w_max = max(errs, key=lambda k: errs[k][0])
        w_fro = max(errs, key=lambda k: errs[k][1])
        line = (f"kernel fused_nerf_train_bwd_{branch} [{label}]: "
                f"{len(errs)} outputs, worst error/max {errs[w_max][0]:.2e} "
                f"({w_max}), worst Frobenius {errs[w_fro][1]:.2e} ({w_fro}) "
                f"(tol {GRAD_MAX}, {GRAD_FRO})")
        bad = errs[w_max][0] > GRAD_MAX or errs[w_fro][1] > GRAD_FRO
        abs_err, rel_err = max(e[2] for e in errs.values()), errs[w_max][0]
        if need_dxyz:
            if not bool(torch.isfinite(got["dxyz"]).all()):
                fail(f"packed backward dxyz not finite ({label})")
            dx = rel_errs(got["dxyz"], want["dxyz"])
            line += (f"; dxyz error/max {dx[0]:.2e}, Frobenius {dx[1]:.2e} "
                     f"(tol {DX_MAX}, {GRAD_FRO})")
            bad = bad or dx[0] > DX_MAX or dx[1] > GRAD_FRO
            abs_err, rel_err = max(abs_err, dx[2]), max(rel_err, dx[0])
        print(line, flush=True)
        if bad:
            fail(f"fused_nerf_train backward ({branch}, {label}) disagrees "
                 "with its plain version")
        ms = cuda_ms(torch, lambda: mtk.fused_nerf_train_bwd_cuda(
            *args, need_dxyz=need_dxyz, **bkw), iters=5, graph=True)
        flops, nbytes = train_bwd_work(fine, branch, len(flow), n, S, pw,
                                       False, packed=True,
                                       need_dxyz=need_dxyz)
        name = f"fused_nerf_train_bwd_{branch}"
        if label == "main":
            plain_ms = cuda_ms(torch, lambda: mtk.fused_nerf_train_bwd_ref(
                *args, need_dxyz=need_dxyz, **bkw), iters=2)
            records[name] = _record(
                name, src, "nsff_pl_tpu/ops/mlp_train_kernel.py:141",
                abs_err, ms, plain_ms, flops, nbytes)
            records[name]["max_rel_err"] = rel_err
            print(f"kernel {name} [main] n={n}: {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound(flops, nbytes)[0]:.3f} "
                  f"ms ({flops / 1e12:.3f} TFLOP) on {card}", flush=True)
            bwd_phases(torch, records[name],
                       lambda: mtk.fused_nerf_train_bwd_cuda(
                           *args, need_dxyz=need_dxyz, **bkw),
                       n, S, branch == "static", card)
        else:
            _fold_errs(records[name], abs_err, rel_err)
            print(f"kernel {name} [{label}] n={n}: {ms:.3f} ms, bound "
                  f"{bound(flops, nbytes)[0]:.3f} ms on {card}", flush=True)

    # ---- the compositor on the main evaluation's packed output
    ns, nt = (torch.randn((n, S), generator=gen, device="cuda")
              for _ in range(2))
    cot = {k: torch.randn((n, S), generator=gen, device="cuda")
           for k in fck.OUT_KEYS}
    gmap = torch.randn((n, 4), generator=gen, device="cuda")
    cargs = (packed_main, zs, ns, nt)
    planes, maps = fck.fused_compositing_fwd_cuda(*cargs)
    dp = fck.fused_compositing_bwd_cuda(*cargs, cot, gmap)
    torch.cuda.synchronize()
    rplanes, rmaps = fck.fused_compositing_fwd_ref(*cargs)
    rdp = fck.fused_compositing_bwd_ref(*cargs, cot, gmap)
    fwd_err = max(float((planes - rplanes).abs().max()),
                  float((maps - rmaps).abs().max()))
    bwd_errs = [rel_errs(dp[..., c], rdp[..., c]) for c in range(8)]
    bwd_err = max(e[0] for e in bwd_errs)
    bwd_abs = max(e[2] for e in bwd_errs)
    print(f"kernel fused_compositing: forward max abs err {fwd_err:.2e}, "
          f"adjoint worst error/max per column {bwd_err:.2e} (tol "
          f"{COMP_TOL})", flush=True)
    if not bool(torch.isfinite(dp).all()) or bool(dp[..., 8:].any()):
        fail("fused_compositing adjoint not finite or columns 8-15 not zero")
    if fwd_err > COMP_TOL or bwd_err > COMP_TOL:
        fail("fused_compositing disagrees with its plain version")
    csrc = "nsff_pl_tpu_torch/csrc/fused_compositing.cu"
    for which, fn, ref, err in (
            ("fwd", lambda: fck.fused_compositing_fwd_cuda(*cargs),
             lambda: fck.fused_compositing_fwd_ref(*cargs), fwd_err),
            ("bwd", lambda: fck.fused_compositing_bwd_cuda(*cargs, cot, gmap),
             lambda: fck.fused_compositing_bwd_ref(*cargs, cot, gmap),
             bwd_abs)):
        ms = cuda_ms(torch, fn, iters=100, graph=True)
        plain_ms = cuda_ms(torch, ref, iters=10, graph=True)
        ops, nbytes = packed_comp_work(which, n, S)
        name = f"fused_compositing_{which}"
        records[name] = _record(
            name, csrc, "nsff_pl_tpu/ops/compositing_kernel.py:100", err, ms,
            plain_ms, ops, nbytes, PEAK_F32_FLOPS)
        if which == "bwd":
            records[name]["max_rel_err"] = bwd_err
        print(f"kernel {name} n={n}: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {records[name]['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.2f} MB) on {card}", flush=True)
    packed_comp_large(torch, fck, records, card)
    return records


def empty_launch(torch, n_rays: int):
    """A launch of an empty kernel (`csrc/launch_floor.cu`) on the packed
    compositor's grid for n_rays rays (two rays of 128 threads a CTA,
    `csrc/fused_compositing.cu`)."""
    import ctypes

    from nsff_pl_tpu_torch.ops import cuda_build

    fn = cuda_build.load("launch_floor").nsff_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rays_per_cta, threads = 2, 2 * 128

    def launch():
        if fn(-(-n_rays // rays_per_cta), threads,
              torch.cuda.current_stream().cuda_stream) != 0:
            fail("empty kernel launch failed")

    return launch


def empty_launch_ms(torch, n_rays: int) -> float:
    """The launch floor: `empty_launch` by the compositor's stopwatch."""
    return cuda_ms(torch, empty_launch(torch, n_rays), iters=100, graph=True)


def packed_comp_large(torch, fck, records, card, n=LARGE_BATCH):
    """The packed compositor at a large batch against its plain version,
    its times at `n` rays, and the launch floor at both batches."""
    S = 128
    gen = torch.Generator(device="cuda").manual_seed(8)
    packed = torch.randn((n, S, 16), generator=gen, device="cuda")
    packed[..., [0, 1, 2, 4, 5, 6]] = torch.rand((n, S, 6), generator=gen,
                                                 device="cuda")
    zs = torch.sort(torch.rand((n, S), generator=gen, device="cuda"),
                    1).values
    ns, nt = (torch.randn((n, S), generator=gen, device="cuda")
              for _ in range(2))
    cargs = (packed.contiguous(), zs.contiguous(), ns, nt)
    cot = {k: torch.randn((n, S), generator=gen, device="cuda")
           for k in fck.OUT_KEYS}
    gmap = torch.randn((n, 4), generator=gen, device="cuda")
    planes, maps = fck.fused_compositing_fwd_cuda(*cargs)
    dp = fck.fused_compositing_bwd_cuda(*cargs, cot, gmap)
    torch.cuda.synchronize()
    rplanes, rmaps = fck.fused_compositing_fwd_ref(*cargs)
    rdp = fck.fused_compositing_bwd_ref(*cargs, cot, gmap)
    fwd_err = max(float((planes - rplanes).abs().max()),
                  float((maps - rmaps).abs().max()))
    errs = [rel_errs(dp[..., c], rdp[..., c]) for c in range(8)]
    bwd_err, bwd_abs = max(e[0] for e in errs), max(e[2] for e in errs)
    print(f"kernel fused_compositing n={n}: forward max abs err "
          f"{fwd_err:.2e}, adjoint worst error/max per column {bwd_err:.2e} "
          f"(tol {COMP_TOL})", flush=True)
    if fwd_err > COMP_TOL or bwd_err > COMP_TOL:
        fail(f"fused_compositing disagrees with its plain version at {n}")
    for which, fn in (
            ("fwd", lambda: fck.fused_compositing_fwd_cuda(*cargs)),
            ("bwd", lambda: fck.fused_compositing_bwd_cuda(*cargs, cot,
                                                           gmap))):
        rec = records[f"fused_compositing_{which}"]
        rec[f"ms_{n}"] = cuda_ms(torch, fn, iters=100, graph=True)
        ops, nbytes = packed_comp_work(which, n, S)
        rec[f"bound_ms_{n}"] = bound(ops, nbytes, PEAK_F32_FLOPS)[0]
        if which == "fwd":
            rec["max_abs_err"] = max(rec["max_abs_err"], fwd_err)
        else:
            _fold_errs(rec, bwd_abs, bwd_err)
        print(f"kernel {rec['name']} n={n}: {rec[f'ms_{n}']:.4f} ms, bound "
              f"{rec[f'bound_ms_{n}']:.4f} ms ({nbytes / 1e6:.2f} MB), "
              f"{100 * rec[f'bound_ms_{n}'] / rec[f'ms_{n}']:.1f}% of the "
              f"bound on {card}", flush=True)
    del planes, maps, dp, rplanes, rmaps, rdp
    floor = {nr: empty_launch_ms(torch, nr) for nr in (BATCH, n)}
    for which in ("fwd", "bwd"):
        records[f"fused_compositing_{which}"]["floor_ms"] = floor[BATCH]
        records[f"fused_compositing_{which}"][f"floor_ms_{n}"] = floor[n]
    print(f"launch floor (an empty kernel on the compositor's grid, same "
          f"stopwatch): {floor[BATCH]:.4f} ms at {BATCH} rays, "
          f"{floor[n]:.4f} ms at {n} rays on {card}", flush=True)


def train_scene(torch, np, K, poses):
    """The synthetic ray table (N_FRAMES, H*W, 16) on the card, in the JAX
    package's channel layout (rays 0:6, rgb 6:9, t 9, disparity 10, mask
    11, flow targets 12:14 and 14:16), and the Ks / Ps of the flow loss."""
    from nsff_pl_tpu_torch.ops import rays as ray_ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    hw = H_IMG * W_IMG
    dirs, uv = ray_ops.get_ray_directions(H_IMG, W_IMG, K, return_uv=True,
                                          device="cuda")
    table = torch.empty((N_FRAMES, hw, 16), device="cuda")
    for i in range(N_FRAMES):
        ro, rd = ray_ops.get_rays(dirs, poses[i])
        shift_near = -min(-1.0, float(poses[i][2, 3]))
        ro, rd = ray_ops.get_ndc_rays(K, 1.0, shift_near, ro, rd)
        table[i, :, 0:3] = ro
        table[i, :, 3:6] = rd
    table[..., 6:9] = torch.rand((N_FRAMES, hw, 3), generator=gen,
                                 device="cuda")
    table[..., 9] = torch.arange(N_FRAMES, device="cuda",
                                 dtype=torch.float32)[:, None]
    table[..., 10] = torch.rand((N_FRAMES, hw), generator=gen, device="cuda")
    table[..., 11] = 1.0
    for c0 in (12, 14):
        table[..., c0:c0 + 2] = uv + 2.0 * torch.randn(
            (N_FRAMES, hw, 2), generator=gen, device="cuda")
    bottom = np.zeros((N_FRAMES, 1, 4))
    bottom[..., -1] = 1
    rt = np.linalg.inv(np.concatenate([poses, bottom], 1))[:, :3]
    rt[:, 1:] *= -1  # "right up back" -> "right down forward"
    Ps = (K @ rt)[None].astype(np.float32)
    Ks = K[None].astype(np.float32)
    return table, torch.from_numpy(Ks).cuda(), torch.from_numpy(Ps).cuda()


def launch_counts():
    """Every wrapper's launch count, by kernel name."""
    from nsff_pl_tpu_torch.ops import launches

    return launches.counts()


def reset_counts():
    from nsff_pl_tpu_torch.ops import launches

    launches.reset()


def check_counts(counts, expected, n, what):
    """Every kernel launched exactly `expected[name] * n` times; kernels
    `expected` does not name, not at all."""
    for k, v in counts.items():
        want = expected.get(k, 0) * n
        if v != want:
            fail(f"{what}: {k} launched {v} times, expected {want}")


def train_setup(torch, cfg, params, device, batch, scan_steps=1,
                hard_sampling=False):
    """Optimizer, state and train step of the recipe `cfg` on `device`
    (`scan_steps` > 1: the K-step dispatch)."""
    import dataclasses

    from nsff_pl_tpu_torch.config import loss_config, render_config
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

    spe = N_FRAMES * H_IMG * W_IMG // 1000  # the scene's steps per epoch
    tx = make_optimizer(cfg, spe)
    rc = render_config(cfg)
    if device == "cpu":  # the kernels' plain versions
        rc = dataclasses.replace(rc, train_backend="pallas")
    step = make_train_step(rc, loss_config(cfg), tx,
                           output_transient=cfg.output_transient,
                           output_transient_flow=tuple(
                               cfg.output_transient_flow),
                           steps_per_epoch=spe, batch_size=batch,
                           hard_sampling=hard_sampling,
                           scan_steps=scan_steps, device=device)
    return TrainState(params, tx.init(params), 0), step


def step_rows(torch, cfg, sched, gen, steps):
    """The frames and draws of `steps` steps, drawn up front on the card,
    so that the eager steps and the graphed dispatch read the same; a
    step's pixels are distinct (drawn without replacement)."""
    ts = [sched.next() for _ in range(steps)]
    idx = torch.argsort(torch.rand((steps, H_IMG * W_IMG), generator=gen,
                                   device="cuda"), 1)[:, :BATCH]
    draws = {k: (torch.rand if k == "u" else torch.randn)(
        (steps, BATCH, cfg.N_samples), generator=gen, device="cuda")
        for k in ("u", "ns", "nt", "nw1", "nw2")}
    return ts, idx, draws


def training_phase(torch, np, cfg, table, Ks, Ps, card, *, label, per_step,
                   planar, steps=TRAIN_STEPS, repeat=True, profile=False):
    """A main training path: warm-up, `steps` timed eager steps with the
    launch counts set to 0 just before and read just after them, then the
    same steps as one graphed dispatch (`graphed_phase`) from a copy of
    the state taken before them, on the same frames and draws; then
    (`repeat`) `steps` steps on one repeated batch, whose loss must fall.
    Returns the eager counts, the graphed counts and the device ms per
    step of both."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
    from nsff_pl_tpu_torch.training.optim import param_leaves
    from nsff_pl_tpu_torch.training.step import clone_state

    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    state, step = train_setup(torch, cfg, params, "cuda", BATCH)
    if step.use_planar != planar:
        fail(f"{label}: planar path taken: {step.use_planar}, expected "
             f"{planar}")
    batcher = RayBatcher(table, BATCH, device="cuda")
    sched = FrameScheduler(N_FRAMES, seed=cfg.seed)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    before = [p.detach().clone() for p in param_leaves(state.params)]
    args = (batcher.table, batcher.weights, Ks, Ps, gen)

    state, m, _ = step(state, *args, sched.next())  # warm-up
    ts, idx, draws = step_rows(torch, cfg, sched, gen, steps)
    start = clone_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    rows, auxs = [], []
    t0 = time.perf_counter()
    ev0.record()
    for i in range(steps):
        state, m, aux = step(state, *args, ts[i], idx=idx[i],
                             draws={k: v[i] for k, v in draws.items()})
        rows.append(m)
        auxs.append(aux)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev_ms = ev0.elapsed_time(ev1) / steps
    counts = launch_counts()
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {steps} eager steps at batch {BATCH}, {dev_ms:.3f} ms "
          f"per step (CUDA events), {host_ms:.3f} ms (host clock), "
          f"max_memory_allocated {mem:.3f} GiB on {card}", flush=True)
    print(f"{label}: launches over the eager steps "
          + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
    check_counts(counts, per_step, steps, label)
    for i, row in enumerate(rows):
        vals = {k: float(v) for k, v in row.items()}
        print(f"{label}: step {i + 1} " + json.dumps(vals), flush=True)
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{label}: loss terms not finite at step {i + 1}")
    if all(bool(torch.equal(a, b)) for a, b in
           zip(before, param_leaves(state.params))):
        fail(f"{label}: params did not change")
    eager = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    eager_tmp = torch.zeros((N_FRAMES, H_IMG * W_IMG, 3), device="cuda")
    for t, aux in zip(ts, auxs):
        eager_tmp[t, aux["rand_idx"]] = aux["rgb_fine"]
    graph_counts, graph_ms = graphed_phase(
        torch, np, cfg, start, (batcher.table, batcher.weights, Ks, Ps, gen),
        ts, idx, draws, eager, eager_tmp, card, label=label,
        per_step=per_step, profile=profile)

    if repeat:  # one repeated batch and draws: the loss must fall
        t = sched.next()
        idx = torch.randint(0, H_IMG * W_IMG, (BATCH,), generator=gen,
                            device="cuda")
        draws = {k: (torch.rand if k == "u" else torch.randn)(
            (BATCH, cfg.N_samples), generator=gen, device="cuda")
            for k in ("u", "ns", "nt", "nw1", "nw2")}
        losses = []
        for _ in range(steps):
            state, m, _ = step(state, *args, t, idx=idx, draws=draws)
            losses.append(float(m["loss"]))
        print(f"{label}: loss on one repeated batch "
              + json.dumps([round(v, 6) for v in losses]), flush=True)
        if not losses[-1] < losses[0]:
            fail(f"{label}: loss on a repeated batch did not fall: {losses}")
    if profile:
        profile_steps(torch, step, state, args, sched, card, label)
    return counts, graph_counts, dev_ms, graph_ms


# the kernel (device function) each wrapper launches first, for the
# profiler's count of a replayed dispatch; a backward call launches five
# kernels, its chain kernel once
SYMBOLS = {"planar_nerf_train_fwd": "train_fwd_kernel",
           "planar_nerf_train_bwd_static": "train_bwd_chain_kernel",
           "planar_nerf_train_bwd_transient": "train_bwd_chain_kernel",
           "planar_compositor_fwd": "comp_fwd_kernel",
           "planar_compositor_bwd": "comp_bwd_kernel",
           "fused_nerf_eval": "fused_eval_kernel",
           "fused_nerf_train_bwd_static": "train_bwd_chain_kernel",
           "fused_nerf_train_bwd_transient": "train_bwd_chain_kernel",
           "fused_compositing_fwd": "fused_comp_fwd_kernel",
           "fused_compositing_bwd": "fused_comp_bwd_kernel"}


def _symbol_count(key, symbol):
    """Does profiler key `key` name the kernel `symbol` (and not one whose
    name holds it, such as fused_comp_fwd_kernel for comp_fwd_kernel)?"""
    import re

    return re.search(r"(^|[^A-Za-z0-9_])" + symbol + r"\b", key) is not None


def cdf_uniforms(torch, weights, ts, idx):
    """The hard-sampling uniforms that draw pixels `idx` (K, B) of frames
    `ts`: the middle of each pixel's step of its frame's weight CDF."""
    cw = torch.cumsum(weights[torch.tensor(ts, device=weights.device)], 1)
    lo = torch.where(idx > 0, cw.gather(1, (idx - 1).clamp(min=0)), 0.0)
    return (lo + cw.gather(1, idx)) / 2 / cw[:, -1:]


def graphed_phase(torch, np, cfg, state, args, ts, idx, draws, eager,
                  eager_tmp, card, *, label, per_step, profile):
    """The same steps as one K-step dispatch (`make_train_step(scan_steps=
    K)`, one CUDA graph) from `state`, with hard sampling on, so that the
    graph also holds the weighted draw and the `tmp_rgb[t, rand_idx] =
    rgb` write: its uniforms draw the eager steps' pixels (`cdf_uniforms`).
    The first dispatch captures (its seconds printed); its per-step loss
    terms must equal the eager steps' (`eager`, stacked) within
    GRAPH_RTOL, and its `tmp_rgb` the eager steps' rgb written at their
    ray ids (`eager_tmp`) within the same; a second dispatch is
    timed with the launch counts set to 0 just before it and read just
    after, counted as the capture's launches times the replays; with
    `profile`, torch.profiler over a third dispatch counts the kernels
    the replays ran against the same. Returns the counts and the device
    ms per step."""
    K = len(ts)
    multi = train_setup(torch, cfg, state.params, "cuda", BATCH,
                        scan_steps=K, hard_sampling=True)[1]
    table, weights, Ks, Ps, gen = args
    tmp = torch.zeros_like(eager_tmp)
    ts_dev = torch.tensor(ts, device="cuda")
    margs = (tmp, table, weights, Ks, Ps, gen, ts_dev)
    mkw = dict(batch_u=cdf_uniforms(torch, weights, ts, idx), draws=draws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _, m = multi(state, *margs, **mkw)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} [graphed]: capture of one {K}-step graph (warm-up "
          f"included): {multi.capture_seconds:.3f} s", flush=True)
    worst, where = 0.0, None
    for k, want in eager.items():
        got = m[k]
        rel = ((got - want).abs() / want.abs().clamp(min=1e-12)).cpu()
        rel[want.abs().cpu() <= 1e-9] = 0.0
        if float(rel.max()) > worst:
            worst, where = float(rel.max()), (k, int(rel.argmax()) + 1)
    print(f"{label} [graphed]: loss terms against the eager steps, worst "
          f"relative error {worst:.2e} ({where}) (tol {GRAPH_RTOL}); "
          f"max_memory_allocated {mem:.3f} GiB (capture and dispatch)",
          flush=True)
    if not worst <= GRAPH_RTOL:
        fail(f"{label}: the graphed steps disagree with the eager steps")
    written = int((tmp != 0).any(-1).sum())
    want = int((eager_tmp != 0).any(-1).sum())
    tmp_err = float((tmp - eager_tmp).abs().max())
    print(f"{label} [graphed]: tmp_rgb (hard sampling) against the eager "
          f"steps' rgb at their ray ids: {written} pixels written "
          f"({want} by the eager steps), worst abs error {tmp_err:.2e} (tol "
          f"{GRAPH_RTOL})", flush=True)
    if written != want or not tmp_err <= GRAPH_RTOL:
        fail(f"{label}: the graphed tmp_rgb writes disagree with the eager "
             "steps")
    for i in range(K):
        print(f"{label} [graphed]: step {i + 1} " + json.dumps(
            {k: float(v[i]) for k, v in m.items()}), flush=True)

    torch.cuda.synchronize()
    reset_counts()
    r0 = multi.replays
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    state, _, m = multi(state, *margs, **mkw)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / K
    dev_ms = ev0.elapsed_time(ev1) / K
    eager_counts = launch_counts()
    if any(eager_counts.values()):
        fail(f"{label}: a replayed dispatch called a kernel wrapper: "
             f"{eager_counts}")
    replays = multi.replays - r0
    counts = {k: multi.graph_launches[k] * replays for k in eager_counts}
    print(f"{label} [graphed]: {K} steps in one dispatch at batch {BATCH}, "
          f"{dev_ms:.3f} ms per step (CUDA events), {host_ms:.3f} ms (host "
          f"clock), {replays} replay(s) of a graph of {K} steps on "
          f"{card}", flush=True)
    print(f"{label} [graphed]: launches (capture x replays) "
          + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
    check_counts(counts, per_step, K, f"{label} [graphed]")
    if not all(bool(torch.isfinite(v).all()) for v in m.values()):
        fail(f"{label} [graphed]: loss terms not finite")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        torch.cuda.synchronize()
        r0 = multi.replays
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _, m = multi(state, *margs, **mkw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        replays = multi.replays - r0
        kernels = [e for e in prof.key_averages() if _dev_us(e) > 0 and
                   e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_dev_us(e) for e in kernels) / 1e3
        seen = {}
        for name, sym in SYMBOLS.items():
            want = multi.graph_launches[name] * replays
            seen.setdefault(sym, [0, sum(e.count for e in kernels
                                         if _symbol_count(e.key, sym))])
            seen[sym][0] += want
        print(f"profile ({label} [graphed]): one dispatch of {K} steps, wall "
              f"{wall / K:.3f} ms per step, device busy {busy / K:.3f} ms "
              f"per step ({100 * busy / wall:.1f}%) on {card}", flush=True)
        print(f"profile ({label} [graphed]): kernels by name, launched per "
              "capture x replays / counted by torch.profiler "
              + json.dumps({k: v for k, v in seen.items() if v[0] or v[1]}),
              flush=True)
        if any(a != b for a, b in seen.values()):
            fail(f"{label}: torch.profiler counts other kernel launches "
                 f"than capture x replays: {seen}")
    return counts, dev_ms


OUR_KERNELS = ("train_fwd_kernel", "train_bwd_chain_kernel", "dw_gemm_kernel",
               "dw_narrow_kernel", "dw_reduce_kernel", "db_reduce_kernel",
               "comp_fwd_kernel", "comp_bwd_kernel", "fused_eval_kernel")
# the three phases of a backward call (csrc/tower_bwd_wgmma.cuh), by kernel
BWD_PHASES = {"chain": ("train_bwd_chain_kernel",),
              "dW": ("dw_gemm_kernel", "dw_narrow_kernel"),
              "reductions": ("dw_reduce_kernel", "db_reduce_kernel")}


def _dev_us(e):
    return getattr(e, "self_device_time_total", 0.0) or 0.0


def phase_ms(torch, avgs, n):
    """Device ms per call (n calls) of each backward phase, from
    torch.profiler key averages."""
    kernels = [e for e in avgs if _dev_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    return {ph: sum(_dev_us(e) for e in kernels
                    if any(k in e.key for k in names)) / 1e3 / n
            for ph, names in BWD_PHASES.items()}


def bwd_phase_ms(torch, fn, n=5):
    """Profile n calls of a backward wrapper: device ms per call of its
    chain, dW and reduction phases."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return phase_ms(torch, prof.key_averages(), n)


def bwd_phases(torch, record, fn, n_rays, S, static, card):
    """Print a backward's chain / dW / reduction device ms per call and the
    cuBLAS yardstick of its dW products; keep both in its record."""
    ph = bwd_phase_ms(torch, fn)
    print(f"kernel {record['name']} [main] phases per call "
          + json.dumps({k: round(v, 4) for k, v in ph.items()})
          + f" ms on {card}", flush=True)
    record["phase_ms"] = ph
    record["cublas_dw_ms"] = cublas_dw_ms(torch, n_rays, S, static, card,
                                          record["name"])


def cublas_dw_ms(torch, n_rays: int, S: int, static: bool, card: str,
                 label: str):
    """Yardstick for the dW phase: cuBLAS (`torch.matmul(A.T, dz)`, bf16)
    on operands of the shapes of the backward's wide dW products (A (R, ka)
    activations, dz (R, 256) cotangents, R = n_rays * S; the per-ray
    static_dir rows over n_rays rows), timed here only; the port never
    calls it."""
    R = n_rays * S
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn((R, 256), generator=gen, device="cuda").bfloat16()
    dz = torch.randn((R, 256), generator=gen, device="cuda").bfloat16()
    kas = [128, 256, 256, 256, 128, 256, 256, 256, 256, 256]
    rows = [R] * len(kas)
    if static:  # static_dir: the feature rows and the per-ray dir rows
        kas += [256, 128]
        rows += [R, n_rays]

    def run():
        for ka, r in zip(kas, rows):
            torch.matmul(a[:r, :ka].T, dz[:r])

    ms = cuda_ms(torch, run, iters=5, graph=True)
    print(f"yardstick {label}: cuBLAS bf16 dW products (torch.matmul(A.T, "
          f"dz), {len(kas)} products of the same shapes) {ms:.3f} ms on "
          f"{card}", flush=True)
    return ms


def profile_steps(torch, step, state, args, sched, card, label, n_steps=5):
    """torch.profiler over n_steps training steps: device time by kernel
    (the whole table to chip_smoke_out/profile_<label>_step.txt), the port's
    kernels against the rest, and the device's busy share of the wall
    time."""
    import os

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _, _ = step(state, *args, sched.next())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = _dev_us
    # device-side events only (kernels, copies): the CPU ops above them
    # carry their kernels' time too
    kernels = [e for e in avgs if dev_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    ours = sum(dev_us(e) for e in kernels
               if any(k in e.key for k in OUR_KERNELS)) / 1e3
    total = sum(dev_us(e) for e in kernels) / 1e3
    os.makedirs("chip_smoke_out", exist_ok=True)
    name = label.replace(" ", "_").replace("training", "train")
    with open(f"chip_smoke_out/profile_{name}_step.txt", "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=80))
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    print(f"profile ({label}): {n_steps} steps, wall {wall_ms / n_steps:.3f} ms per "
          f"step; device busy {total / n_steps:.3f} ms per step "
          f"({100 * total / wall_ms:.1f}%), of which the port's kernels "
          f"{ours / n_steps:.3f} ms; {len(kernels)} kernel names on {card}",
          flush=True)
    for e in top:
        print(f"profile ({label}): {dev_us(e) / 1e3 / n_steps:9.3f} ms/step "
              f"{e.count // n_steps:5d} calls/step  {e.key[:90]}", flush=True)
    print(f"profile ({label}): backward phases per step " + json.dumps(
        {k: round(v, 4) for k, v in phase_ms(torch, avgs, n_steps).items()})
        + f" ms; device busy {total / n_steps:.3f} ms per step on {card}",
        flush=True)


def train_agreement(torch, cfg, table, Ks, Ps, label):
    """One step of the recipe `cfg` at batch 64 on the card and on the CPU
    (plain versions) from the same state, batch and draws: loss terms
    within LOSS_RTOL, Adam's first moments (0.1 * the gradients) within
    GRAD_MAX/GRAD_FRO."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.training.checkpoint import to_device
    from nsff_pl_tpu_torch.training.optim import moments

    n = 64
    params = build_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    gen = torch.Generator().manual_seed(6)
    t = 11
    idx = torch.randint(0, H_IMG * W_IMG, (n,), generator=gen)
    draws = {k: (torch.rand if k == "u" else torch.randn)(
        (n, cfg.N_samples), generator=gen) for k in ("u", "ns", "nt", "nw1",
                                                     "nw2")}
    frame = table[t:t + 1].cpu()  # the frame of this step (channel 9 holds t)
    out = {}
    for dev in ("cuda", "cpu"):
        state, step = train_setup(torch, cfg, to_device(params, dev), dev, n)
        tab = frame.to(dev)
        _, m, _ = step(state, tab, torch.ones(tab.shape[:2], device=dev),
                       Ks.to(dev), Ps.to(dev), None, 0,
                       idx=idx.to(dev), draws={k: v.to(dev)
                                               for k, v in draws.items()})
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [v.cpu() for v in moments(state.opt_state)["mu"]])
    (mc, muc), (mp, mup) = out["cuda"], out["cpu"]
    loss_err = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp
                   if abs(mp[k]) > 1e-9)
    grad_errs = [rel_errs(a, b) for a, b in zip(muc, mup)]
    g_max = max(e[0] for e in grad_errs)
    g_fro = max(e[1] for e in grad_errs)
    print(f"agreement: one {label} step at batch {n}, card vs plain CPU: "
          f"loss terms worst relative error {loss_err:.2e} (tol "
          f"{LOSS_RTOL}); gradients worst error/max {g_max:.2e}, worst "
          f"Frobenius {g_fro:.2e} (tol {GRAD_MAX}, {GRAD_FRO})", flush=True)
    if loss_err > LOSS_RTOL or g_max > GRAD_MAX or g_fro > GRAD_FRO:
        fail(f"the card {label} step disagrees with the plain CPU step")


def packed_serving_phase(torch, np, cfg, params, K, poses, planar_maps,
                         card):
    """The packed serving path: one frame through a `RenderService` with
    `planar_eval="off"` in bfloat16 (the packed evaluator once per chunk,
    compositing outside it), held against the planar frame of the same
    weights, and one in float32 (the plain evaluators, no kernel), held
    against the bfloat16 frame. Returns the bfloat16 frame's counts."""
    from nsff_pl_tpu_torch.apps.serve import RenderService

    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    frames = {}
    for dtype, expected, other, tol in (
            ("bfloat16", {"fused_nerf_eval": n_chunks}, planar_maps,
             FRAME_TOL),
            ("float32", {}, None, F32_TOL)):
        svc = RenderService(params, K, poses, (W_IMG, H_IMG),
                            cfg.replace(planar_eval="off", dtype=dtype),
                            chunk=CHUNK, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rgb, depth = svc.render_pose(0)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        print(f"packed serving [{dtype}]: one {W_IMG}x{H_IMG} frame in "
              f"{secs:.6f} s, launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + f" on {card}", flush=True)
        check_counts(counts, expected, 1, f"packed serving [{dtype}]")
        if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG) \
                or not np.isfinite(depth).all():
            fail(f"packed serving [{dtype}]: bad frame")
        maps = svc.render_maps(0)  # the float maps, to compare
        if other is None:
            other = frames["bfloat16"][1]
        err = max(float((maps[k].float() - other[k].float()).abs().max())
                  for k in ("rgb_fine", "depth_fine"))
        against = "the planar frame" if dtype == "bfloat16" else \
            "the bfloat16 frame"
        print(f"packed serving [{dtype}]: rgb and depth against {against} "
              f"max abs err {err:.3e} (tol {tol})", flush=True)
        if not err <= tol:
            fail(f"packed serving [{dtype}] disagrees with {against}")
        frames[dtype] = (counts, maps)
    return frames["bfloat16"][0]


# ---------------- scene training (a main path) ----------------

SCENE_DIR = "chip_smoke_out/scene"
SCENE_RUN_DIR = "chip_smoke_out/scene_runs"
SCENE_WH = (1024, 576)  # native; the recipe trains at (W_IMG, H_IMG)
VAL_EVERY = 1000
# the first run stops at its time budget, mid-epoch
RUN1_BUDGET_S = 15.0
# the packed run: a few hundred steps
RUN3_BUDGET_S = 6.0
# the last validation's PSNR must beat a validation of the fresh system
# by this many dB (measured on an H100: +16.1 and +16.3 dB in two runs,
# 12.95 -> 29.04 / 29.28 dB at step 4000; the validations between read
# 16.9, 25.5-25.9 and 22.5-27.8 dB)
PSNR_GAIN_DB = 10.0


def scene_frame(np, H, W, N, i):
    """A structured, learnable frame (as `tests/helpers_scene.py::_frame`):
    sinusoids that shift with the camera and a bright disk moving across
    the frames; also the disk's mask."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    shift = 0.05 * i * 0.9 * W / 5.0
    img = np.stack([
        0.5 + 0.35 * np.sin(2 * np.pi * (x + shift) / W * 3.0),
        0.5 + 0.35 * np.sin(2 * np.pi * y / H * 2.0 + 1.0),
        0.5 + 0.25 * np.sin(2 * np.pi * ((x + shift) / W + y / H) * 2.0),
    ], -1)
    cx = (0.15 + 0.7 * i / max(N - 1, 1)) * W
    cy = H * (0.5 + 0.15 * np.sin(2 * np.pi * i / max(N, 1)))
    disk = np.exp(-((x - cx) ** 2 + (y - cy) ** 2)
                  / (0.08 * min(H, W)) ** 2)[..., None]
    img = img * (1 - disk) + disk * np.array([0.95, 0.3, 0.2])
    return ((np.clip(img, 0, 1) * 255).astype(np.uint8),
            ((disk[..., 0] > 0.5) * 255).astype(np.uint8))


def write_scene(np, root, N=N_FRAMES, seed=0):
    """A seeded scene of N frames at SCENE_WH, written with the port's own
    writers: RGB frames whose rows cycle through all five PNG filters,
    16-bit disparity PNGs, grey masks, `.flo` flows (the camera's shift)
    and a COLMAP binary model whose points every frame sees."""
    import os

    from nsff_pl_tpu_torch.scene import colmap, flowio, imageio
    from nsff_pl_tpu_torch.scene.poses import rotmat2qvec

    W, H = SCENE_WH
    rng = np.random.default_rng(seed)
    for sub in ("images", "disps", "masks", "flow_fw", "flow_bw",
                "sparse/0"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    cams = {1: colmap.Camera(1, "SIMPLE_RADIAL", W, H,
                             np.array([0.9 * W, W / 2, H / 2, 0.0]))}
    images = {i + 1: colmap.Image(i + 1, rotmat2qvec(np.eye(3)),
                                  np.array([0.05 * i, 0.0, 0.0]), 1,
                                  f"{i:05d}.png", np.zeros((0, 2)),
                                  np.zeros(0, np.int64)) for i in range(N)}
    pts = {j: colmap.Point3D(j, np.array([rng.uniform(-1, 1),
                                          rng.uniform(-1, 1),
                                          rng.uniform(3.0, 8.0)]),
                             np.array([128, 128, 128], np.uint8), 0.1,
                             np.arange(1, N + 1), np.zeros(N, np.int64))
           for j in range(1, 200)}
    colmap.write_model(cams, images, pts, os.path.join(root, "sparse/0"))
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    disp = (1000.0 / (5.0 + 2.0 * np.sin(2 * np.pi * x / W)
                      * np.cos(2 * np.pi * y / H))).astype(np.uint16)
    dx = 0.05 * 0.9 * W / 5.0  # the background's shift per frame, pixels
    flow = np.zeros((H, W, 2), np.float32)
    for i in range(N):
        img, mask = scene_frame(np, H, W, N, i)
        imageio.write_png(f"{root}/images/{i:05d}.png", img,
                          filters=[0, 1, 2, 3, 4])
        imageio.write_png(f"{root}/disps/{i:05d}.png", disp,
                          filters=[4, 1, 2])
        imageio.write_png(f"{root}/masks/{i:05d}.png", mask, filters=[2])
        if i < N - 1:
            flow[..., 0] = dx
            flowio.write_flow(flow, f"{root}/flow_fw/{i:05d}.flo")
        if i > 0:
            flow[..., 0] = -dx
            flowio.write_flow(flow, f"{root}/flow_bw/{i:05d}.flo")


def scene_argv(exp, extra=()):
    """The flagship recipe on the written scene, through the CLI."""
    return ["--root_dir", SCENE_DIR, "--img_wh", str(W_IMG), str(H_IMG),
            "--start_end", "0", str(N_FRAMES), "--encode_t", "--use_viewdir",
            "--N_samples", "128", "--batch_size", str(BATCH), "--lr", "5e-4",
            "--lr_scheduler", "cosine", "--dtype", "bfloat16",
            "--hard_sampling", "--scan_steps", str(TRAIN_STEPS),
            "--num_epochs", "1", "--val_every_steps", str(VAL_EVERY),
            "--cache_dir", f"{SCENE_RUN_DIR}/cache",
            "--log_dir", f"{SCENE_RUN_DIR}/logs",
            "--ckpt_dir", f"{SCENE_RUN_DIR}/ckpts", "--exp_name", exp,
            *extra]


def jsonl_rows(exp):
    """The per-step train rows of a run's JSONL, by step."""
    rows = {}
    with open(f"{SCENE_RUN_DIR}/logs/{exp}/metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if "train/loss" in r:
                rows[r["step"]] = r
    return rows


def run_counts(system, counts, per_step, label):
    """Check one CLI run's launches: the wrappers counted the capture's
    warm-up (`WARMUP` eager runs of the K steps on a copy of the state),
    the capture, the single steps and the validations' frames; the card
    ran capture x replays plus the single steps. Returns the launches the
    card ran."""
    multi = system.train_step
    K = multi.K
    if multi.captures != 1:
        fail(f"{label}: {multi.captures} captures of the {K}-step dispatch, "
             "expected 1")
    singles = system.single_steps
    n_val = len(system.val_seconds)
    n_chunks = -(-W_IMG * H_IMG // min(max(system.cfg.chunk // 4, 1024),
                                       W_IMG * H_IMG))
    want = {k: v * ((multi.WARMUP + 1) * K + singles)
            for k, v in per_step.items()}
    want["planar_eval_comp"] = n_val * n_chunks
    for k, v in counts.items():
        if v != want.get(k, 0):
            fail(f"{label}: {k} counted {v} times, expected {want.get(k, 0)}")
        if multi.graph_launches[k] != per_step.get(k, 0) * K:
            fail(f"{label}: the {K}-step graph holds "
                 f"{multi.graph_launches[k]} launches of {k}")
    ran = {k: multi.graph_launches[k] * multi.replays
           + per_step.get(k, 0) * singles for k in counts}
    ran["planar_eval_comp"] = counts["planar_eval_comp"]
    steps = multi.replays * K + singles
    if steps != system.steps_run:
        fail(f"{label}: {steps} steps dispatched, {system.steps_run} run")
    for k, v in per_step.items():
        if ran[k] != v * steps:
            fail(f"{label}: {k} ran {ran[k]} times over {steps} steps")
    print(f"{label}: {steps} steps ({multi.replays} replays of one "
          f"{K}-step graph, {singles} single steps), {n_val} validations of "
          f"{n_chunks} chunks; launches on the card "
          + json.dumps({k: v for k, v in ran.items() if v}), flush=True)
    return ran


def cli_step_ms(system):
    """Host ms per step of a CLI run: fit's wall time without its
    validations, checkpoints and the capture."""
    other = (sum(system.val_seconds) + sum(system.save_seconds)
             + system.train_step.capture_seconds)
    return (system.fit_seconds - other) * 1e3 / max(system.steps_run, 1)


def scene_training_phase(torch, np, card, graph_ms):
    """The train CLI from a scene on disk (`apps.train.cli`, in process):
    a run stopped by its time budget, its resume to the end of the epoch
    and a packed run (B4-B6); `graph_ms` holds the graphed step's ms of
    the training phases ("planar", "packed"), printed beside the CLI's.
    Returns the launches the card ran."""
    import os
    import shutil

    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.config import get_opts
    from nsff_pl_tpu_torch.scene import imageio
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.optim import param_leaves
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

    for d in (SCENE_DIR, SCENE_RUN_DIR):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    write_scene(np, SCENE_DIR)
    print(f"scene training: wrote {N_FRAMES} frames at {SCENE_WH[0]}x"
          f"{SCENE_WH[1]} in {time.perf_counter() - t0:.2f} s", flush=True)
    frames = sorted(os.listdir(f"{SCENE_DIR}/images"))
    t0 = time.perf_counter()
    decoded = [imageio.to_rgb(imageio.read_png(f"{SCENE_DIR}/images/{f}"))
               for f in frames]
    t1 = time.perf_counter()
    for img in decoded:
        imageio.resize_lanczos(img, (W_IMG, H_IMG))
    t2 = time.perf_counter()
    print(f"scene training: {len(frames)} RGB frames decoded in "
          f"{t1 - t0:.2f} s, resized (LANCZOS) in {t2 - t1:.2f} s "
          "(host, numpy)", flush=True)
    del decoded

    reset_counts()
    # a fresh system: the uncached scene load (decode, resize, table on
    # the card) and the validation before any step
    fresh = NSFFSystem(get_opts(scene_argv("fresh")))
    print(f"scene training: scene load (decode, resize, ray table "
          f"{tuple(fresh.train_scene.rays.shape)} on the card) "
          f"{fresh.load_seconds:.2f} s", flush=True)
    base = fresh.validate(0)
    fresh_counts = launch_counts()
    del fresh
    torch.cuda.empty_cache()

    runs = {}
    for label, exp, extra, per_step in (
            ("scene run 1", "planar", ("--time_budget_s",
                                       str(RUN1_BUDGET_S)), PER_STEP),
            ("scene run 2", "planar", None, PER_STEP),
            ("scene run 3", "packed", ("--fused_train", "off",
                                       "--fused_compositing",
                                       "--time_budget_s",
                                       str(RUN3_BUDGET_S)),
             PER_STEP_PACKED)):
        if extra is None:  # the resume of run 1
            ckpt1 = ckpt_lib.latest_checkpoint(f"{SCENE_RUN_DIR}/ckpts/{exp}")
            extra = ("--ckpt_path", ckpt1)
        torch.cuda.synchronize()
        reset_counts()
        system = cli(scene_argv(exp, extra))
        torch.cuda.synchronize()
        counts = launch_counts()
        runs[label] = (system, run_counts(system, counts, per_step, label))
        print(f"{label}: {system.steps_run} steps to step "
              f"{system.state.step} of {system.total_steps}, "
              f"{cli_step_ms(system):.3f} ms per step through the CLI "
              f"(host clock), against {graph_ms[exp]:.3f} "
              f"ms per graphed step in the training phase of this run; "
              f"capture {system.train_step.capture_seconds:.2f} s; scene "
              f"load {system.load_seconds:.2f} s (cached table); "
              "validations " + json.dumps([round(s, 3) for s in
                                           system.val_seconds])
              + " s; checkpoints " + json.dumps(
                  [round(s, 3) for s in system.save_seconds])
              + f" s on {card}", flush=True)
        for step, log in system.val_history:
            print(f"{label}: validation at step {step} " + json.dumps(
                {k: round(v, 4) for k, v in log.items()}), flush=True)
        rows = jsonl_rows(exp)
        bad = [s for s, r in rows.items()
               if not all(np.isfinite(v) for v in r.values())]
        if bad:
            fail(f"{label}: loss rows not finite at steps {bad[:5]}")
        del system
        torch.cuda.empty_cache()

    r1, r2 = runs["scene run 1"][0], runs["scene run 2"][0]
    stop = r1.state.step
    if not 0 < stop < r1.total_steps:
        fail(f"scene run 1 stopped at step {stop}, not mid-epoch")
    if r2.state.step != r2.total_steps or \
            r2.steps_run != r2.total_steps - stop:
        fail(f"scene run 2 resumed at {r2.total_steps - r2.steps_run}, "
             f"ended at {r2.state.step}; run 1 stopped at {stop}")
    rows = jsonl_rows("planar")
    if sorted(rows) != list(range(r2.total_steps)):
        fail("scene runs 1 and 2: the JSONL does not hold every step once")
    # the resume starts from the checkpoint's exact state
    tree = ckpt_lib.restore_checkpoint(ckpt1)
    again = NSFFSystem(get_opts(scene_argv("planar", ("--ckpt_path",
                                                      ckpt1))))
    opt = again.state.opt_state
    exact = (again.state.step == int(tree["step"]) == stop
             and int(opt.count) == int(tree["opt_state"]["count"])
             and all(torch.equal(a.cpu(), b) for a, b in zip(
                 param_leaves(again.state.params),
                 param_leaves(tree["params"])))
             and all(torch.equal(a.cpu(), b) for a, b in zip(
                 opt.mu + opt.nu, param_leaves(tree["opt_state"]["mu"])
                 + param_leaves(tree["opt_state"]["nu"]))))
    print(f"scene run 2: resumed at step {stop} from {ckpt1}, params and "
          f"Adam state equal to the file bit for bit: {exact}", flush=True)
    if not exact:
        fail("the resumed state differs from the checkpoint")
    del again, tree
    last_step, last = r2.val_history[-1]
    gain = last["psnr"] - base["psnr"]
    print(f"scene training: validation PSNR {base['psnr']:.3f} dB before "
          f"any step, {last['psnr']:.3f} dB at step {last_step}: +{gain:.3f} "
          f"dB (must exceed {PSNR_GAIN_DB} dB)", flush=True)
    if not gain > PSNR_GAIN_DB:
        fail(f"validation PSNR gained {gain:.3f} dB, not {PSNR_GAIN_DB}")
    ran = {k: fresh_counts[k] + sum(c[k] for _, c in runs.values())
           for k in fresh_counts}
    return ran


# ---------------- eval (a main path) ----------------

EVAL_DIR = "chip_smoke_out/eval"
# the frames also rendered in float32 on the plain evaluators (~1.8 s each)
F32_FRAMES = (0, 15, 29)
# the frames the untrained render is scored on (reading a frame's image
# takes ~0.4 s of the host)
UNTRAINED_FRAMES = tuple(range(0, N_FRAMES, 5))
# graphed frame vs host-loop frame: the same kernels on the same rays
GRAPH_TOL = 1e-6
# a trained frame's per-channel standard deviation must exceed this (the
# scene's frames: 0.1-0.25; a frame of seeded weights: ~1e-3)
FLAT_STD = 0.05
# the splat's two forms on the same planes: the same bilinear terms
# summed in another order (measured 4.2e-7 on random planes in [0, 1])
SPLAT_TOL = 1e-5
# evaluator kernels vs plain versions on the eval paths' inputs (trained
# weights): a bf16 rounding flip of one activation, where the two sum in
# another order, grows through trained layers to 4e-2-6e-2 on a raw
# sigma and 7e-3 on an rgb, past PLANE_TOL; both then stand as far from
# the unrounded model (the plain version in float64 without its bf16
# roundings; measured on the 64 worst rays: mean error per plane equal
# to 3 digits, largest 0.95x). So the kernel is held to that model: per
# plane, its mean error at most EXACT_MEAN and its largest at most
# EXACT_MAX times the plain version's, and at most PLANE_SHARE of the
# samples off the plain version by more than 1e-5
EXACT_MEAN, EXACT_MAX = 1.1, 1.5


def kept_calls(fn, wrappers):
    """Run fn() with each kernel wrapper `wrappers` names (module,
    attribute) replaced by one that calls it and keeps its arguments and
    result; returns {attribute: [(args, kwargs, result), ...]}: the
    inputs a main path gives each kernel. A wrapper adds to its launch
    count by its module-level name, so the stand-in carries the count
    while it is in place and hands it back after."""
    calls, real = {}, {}
    for mod, name in wrappers:
        fn_real = real[name] = getattr(mod, name)
        calls[name] = []

        def keep(*a, _fn=fn_real, _calls=calls[name], **kw):
            out = _fn(*a, **kw)
            _calls.append((a, kw, out))
            return out

        keep.launches = fn_real.launches
        setattr(mod, name, keep)
    try:
        fn()
    finally:
        for mod, name in wrappers:
            real[name].launches = getattr(mod, name).launches
            setattr(mod, name, real[name])
    return calls


def plane_errs(got, want):
    """(largest abs error, share of entries off by more than 1e-5)."""
    err = (got - want).abs()
    return float(err.max()), float((err > 1e-5).float().mean())


def unrounded(torch, fn, args, kw, ray_dim, rays=2048):
    """`fn(*args, **kw)`, a plain version in `ops/raymarch_kernel.py` or
    `ops/mlp_kernel.py`, without its bf16 roundings of activations and in
    float64 (the weights stay the bf16 values the kernel reads): the
    model that the kernel and its plain version both round. Their
    rounding helpers `_bf16` and `_mm` are swapped for the call, which
    runs `rays` rays at a time (the tensor arguments' first dimension),
    joined on the output's `ray_dim`."""
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    def mm(x, w, b=None):
        y = x.double() @ w.double()
        return y if b is None else y + b.double()

    saved = [(m, m._bf16, m._mm) for m in (rk, mk)]
    for m, _, _ in saved:
        m._bf16, m._mm = (lambda x: x.double()), mm
    n = next(x for x in args if torch.is_tensor(x)).shape[0]
    try:
        return torch.cat([fn(*(x[i:i + rays].double() if torch.is_tensor(x)
                               else x for x in args), **kw).float()
                          for i in range(0, n, rays)], ray_dim)
    finally:
        for m, bf16, mm_ in saved:
            m._bf16, m._mm = bf16, mm_


def reversed_rays(torch, fn, args, kw, ray_dim):
    """`fn(*args, **kw)` on the same rays in reverse order (the tensor
    arguments' first dimension), its output put back in order on
    `ray_dim`: a kernel gives each ray the same bits in any place of its
    grid."""
    n = next(x for x in args if torch.is_tensor(x)).shape[0]
    p = torch.arange(n - 1, -1, -1, device="cuda")
    return fn(*(x[p].contiguous() if torch.is_tensor(x) else x
                for x in args), **kw).flip(ray_dim)


def unrounded_ratios(got, want, exact, dims):
    """Per plane (reduced over `dims`): the kernel's mean and largest
    distance to the unrounded model over the plain version's; returns
    the worst (mean ratio, max ratio)."""
    ek, ep = (got - exact).abs(), (want - exact).abs()
    mean = (ek.mean(dims) + 1e-9) / (ep.mean(dims) + 1e-9)
    top = (ek.amax(dims) + 1e-9) / (ep.amax(dims) + 1e-9)
    return float(mean.max()), float(top.max())


def graph_ran(render):
    """What the card ran of the CUDA graphs `render_full_image` captured
    for `render`: each graph's warm-up launches plus its capture's
    launches times its replays; and what the wrappers counted (warm-up
    and capture)."""
    ran, counted = {}, {}
    for g in render.chunk_graphs.values():
        for k, v in g.graph_launches.items():
            ran[k] = ran.get(k, 0) + g.warmup_launches[k] + v * g.replays
            counted[k] = counted.get(k, 0) + g.warmup_launches[k] + v
    return ran, counted


def eval_split(torch, np, card, label, argv, expected, frames):
    """One eval CLI run (`apps.evaluate`, in process): the launches the
    wrappers counted around it against its graphs, one graph of 5 equal
    chunks replayed once a frame, `expected` launches per chunk. Returns
    (report, the launches the card ran, the graph)."""
    from nsff_pl_tpu_torch.apps import evaluate

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = evaluate.main(evaluate.get_opts(argv))
    secs = time.perf_counter() - t0
    counts = launch_counts()
    ran, counted = graph_ran(rep.render)
    if counts != counted:
        fail(f"eval {label}: the wrappers counted {counts}, the graphs "
             f"hold {counted}")
    (g,) = rep.render.chunk_graphs.values()
    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    want = {k: v * n_chunks for k, v in expected.items()}
    if {k: v for k, v in g.graph_launches.items() if v} != want:
        fail(f"eval {label}: one frame's graph holds {g.graph_launches}, "
             f"expected {want}")
    if g.replays != frames:
        fail(f"eval {label}: {g.replays} graph replays for {frames} frames")
    print(f"eval {label}: {rep.n_items} items in {secs:.3f} s, "
          f"{np.mean(rep.item_seconds):.4f} s per item, "
          f"{np.mean(rep.render_seconds):.4f} s per frame render "
          f"({g.n_chunks} chunks of {g.chunk} in one graph replay; "
          f"capture {g.capture_seconds:.3f} s); launches on the card "
          + json.dumps({k: v for k, v in ran.items() if v}) + f" on {card}",
          flush=True)
    return rep, ran, g


def eval_phase(torch, np, card):
    """The eval CLI (`apps.evaluate`, in process) on the scene and the
    trained checkpoint of the scene training phase: the test split (30
    frames, bfloat16, depth maps) with its frames held against the host
    loop, the untrained render, a flatness floor and float32 on the plain
    evaluators; the spiral (180 frames) and a few frames with
    --fix_view_dir; test_fixview0_interp4 (the planes route, the splat in
    both its forms); the test split with --planar_eval off (B5). Each
    kernel of these paths is held against its plain version on the
    inputs the path gives it on one chunk of frame 0, with the trained
    weights. Returns the launches the card ran in the CLI runs and each
    kernel's largest error there."""
    import os

    from nsff_pl_tpu_torch.config import (NSFFConfig, build_params,
                                          render_config)
    from nsff_pl_tpu_torch.models.rendering import _interp_pre, interpolate
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.ops import softsplat as ss
    from nsff_pl_tpu_torch.scene import imageio
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.step import (equal_chunks,
                                                 make_render_fn,
                                                 render_full_image)

    scene_dir = os.path.abspath(SCENE_DIR)
    ckpt = os.path.abspath(ckpt_lib.latest_checkpoint(
        f"{SCENE_RUN_DIR}/ckpts/planar"))
    base = ["--root_dir", scene_dir, "--img_wh", str(W_IMG), str(H_IMG),
            "--start_end", "0", str(N_FRAMES), "--encode_t", "--use_viewdir",
            "--N_samples", "128", "--dtype", "bfloat16", "--ckpt_path", ckpt]
    os.makedirs(EVAL_DIR, exist_ok=True)
    here = os.getcwd()
    os.chdir(EVAL_DIR)  # the CLI writes results/monocular/<scene_name>
    total, kernel_errs = {}, {}
    chunk_rows = slice(0, equal_chunks(W_IMG * H_IMG, CHUNK)[1])

    def add(ran):
        for k, v in ran.items():
            total[k] = total.get(k, 0) + v

    try:
        # ---- test split, both towers (the static tower alone of this
        # scene's dynamic frames scored 23.2-28.2 dB across runs, its gain
        # over the untrained render 10.3-15.1 dB: too near PSNR_GAIN_DB to
        # tell trained weights from a fault) ----
        rep, ran, g = eval_split(
            torch, np, card, "test", base + ["--split", "test", "--save_depth",
                                   "--output_transient", "--scene_name",
                                   "test"],
            {"planar_eval_comp": 1}, N_FRAMES)
        add(ran)
        if not np.isnan(rep.lpips).all():
            fail("eval test: LPIPS without a weights file")
        print(f"eval test: LPIPS n/a (no weights file); mean PSNR whole / "
              f"dynamic {np.nanmean(rep.psnr, 0).tolist()}, SSIM "
              f"{np.nanmean(rep.ssim, 0).tolist()}", flush=True)
        data, params = rep.dataset, rep.params
        cfg = NSFFConfig(img_wh=(W_IMG, H_IMG), start_end=(0, N_FRAMES),
                         use_viewdir=True, encode_t=True, N_samples=128,
                         dtype="bfloat16")
        fresh = build_params(cfg, torch.Generator().manual_seed(cfg.seed),
                             device="cuda")
        errs, exact, g_s, loop_s, fresh_psnr, stds = [], True, [], [], [], []

        def frame_vis(i):
            """The CLI's visibility culling of frame i's render."""
            return {"vis_poses": torch.as_tensor(
                data.poses[i:i + 1], dtype=torch.float32, device="cuda"),
                "vis_K": torch.as_tensor(data.K, device="cuda")}

        for i in range(N_FRAMES):
            item = data.test_item(
                i, targets=("rgbs",) if i in UNTRAINED_FRAMES else ())
            rays, ts = item["rays"], item["ts"]
            times = []
            outs = []
            for scan in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(render_full_image(rep.render, params, rays, ts,
                                              chunk=CHUNK, scan_chunks=scan,
                                              **frame_vis(i)))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            g_s.append(times[0])
            loop_s.append(times[1])
            for k in ("rgb_fine", "depth_fine"):
                errs.append(float((outs[0][k] - outs[1][k]).abs().max()))
                exact = exact and torch.equal(outs[0][k], outs[1][k])
            img = outs[0]["rgb_fine"].reshape(H_IMG, W_IMG, 3)
            stds.append(float(img.std((0, 1)).min()))
            if i in UNTRAINED_FRAMES:
                un = render_full_image(rep.render, fresh, rays, ts,
                                       chunk=CHUNK, **frame_vis(i))
                mse = ((torch.clamp(un["rgb_fine"], 0, 1) - item["rgbs"])
                       ** 2).mean()
                fresh_psnr.append(float(-10 * torch.log10(mse)))
        print(f"eval test: graphed frame against the host-loop frame max abs "
              f"err {max(errs):.3e} (tol {GRAPH_TOL}), bit for bit: {exact}; "
              f"{np.mean(g_s):.4f} s per graphed frame, {np.mean(loop_s):.4f} "
              f"s per host-loop frame (host clock, synchronized) on {card}",
              flush=True)
        if max(errs) > GRAPH_TOL:
            fail("eval test: the graphed frames differ from the host loop's")
        trained = float(np.mean(rep.psnr[list(UNTRAINED_FRAMES), 0]))
        gain = trained - float(np.mean(fresh_psnr))
        print(f"eval test: mean PSNR over frames {list(UNTRAINED_FRAMES)} "
              f"{trained:.3f} dB trained, {np.mean(fresh_psnr):.3f} dB "
              f"untrained: +{gain:.3f} dB (must exceed {PSNR_GAIN_DB}); "
              f"smallest per-channel std of a frame {min(stds):.4f} (floor "
              f"{FLAT_STD})", flush=True)
        if not gain > PSNR_GAIN_DB:
            fail(f"eval test: PSNR gained {gain:.3f} dB over the untrained "
                 "render")
        if not min(stds) > FLAT_STD:
            fail(f"eval test: a flat frame (std {min(stds):.4f})")
        # float32 against bfloat16 on the static tower's frames (both
        # towers' frames part by 1.4e-2 on trained weights: ROADMAP C)
        b16, f32 = (make_render_fn(render_config(cfg.replace(dtype=dt)),
                                   output_transient=False,
                                   keys=("rgb_fine", "depth_fine"))
                    for dt in ("bfloat16", "float32"))
        err32 = 0.0
        for i in F32_FRAMES:
            item = data.test_item(i, targets=())
            out, want = (render_full_image(fn, params, item["rays"],
                                           item["ts"], chunk=CHUNK)
                         for fn in (f32, b16))
            err32 = max(err32, *(float((out[k] - want[k]).abs().max())
                                 for k in ("rgb_fine", "depth_fine")))
        print(f"eval test: frames {list(F32_FRAMES)} of the static tower in "
              f"float32 on the plain evaluators against bfloat16 (B1) max abs "
              f"err {err32:.3e} (tol {F32_TOL})", flush=True)
        if not err32 <= F32_TOL:
            fail("eval test: float32 frames disagree with bfloat16")
        del fresh, b16, f32, rep
        torch.cuda.empty_cache()

        # ---- spiral, and a few frames with a fixed view direction ----
        _, ran, _ = eval_split(
            torch, np, card, "test_spiral", base + ["--split", "test_spiral",
                                          "--scene_name", "spiral"],
            {"planar_eval_comp": 1}, 6 * N_FRAMES)
        add(ran)
        _, ran, _ = eval_split(
            torch, np, card, "test_spiral --fix_view_dir",
            base + ["--split", "test_spiral", "--fix_view_dir",
                    "--scene_name", "spiral_fixed"],
            {"planar_eval_comp": 1}, 6 * N_FRAMES)
        add(ran)
        a = imageio.read_png("results/monocular/spiral/005.png")
        b = imageio.read_png("results/monocular/spiral_fixed/005.png")
        print(f"eval test_spiral --fix_view_dir: frame 5 against the "
              f"spiral's: {(a != b).mean():.4f} of the pixel channels "
              "differ", flush=True)

        # ---- space-time interpolation: the planes route ----
        rep, ran, g = eval_split(
            torch, np, card, "test_fixview0_interp4",
            base + ["--split", "test_fixview0_interp4", "--scene_name",
                    "interp"],
            {"planar_nerf_train_fwd": 1, "planar_compositor_fwd": 1},
            N_FRAMES)
        add(ran)
        data, params = rep.dataset, rep.params
        item = data.test_item(0, targets=())
        rays, ts = item["rays"], item["ts"]
        vis = {"vis_poses": torch.as_tensor(data.poses[0:1],
                                            dtype=torch.float32,
                                            device="cuda"),
               "vis_K": torch.as_tensor(data.K, device="cuda")}
        calls = kept_calls(
            lambda: rep.render(params, rays[chunk_rows], ts[chunk_rows],
                               vis["vis_poses"], vis["vis_K"]),
            ((rk, "planar_nerf_train_fwd_cuda"),
             (tck, "planar_compositor_fwd_cuda")))
        ((a, kw, got),) = calls["planar_nerf_train_fwd_cuda"]
        want = rk.planar_nerf_train_ref(*a, **kw)
        if not bool(torch.isfinite(got).all()):
            fail("eval interp: B2's forward output not finite")
        err, share = plane_errs(got, want)
        r_mean, r_max = unrounded_ratios(
            got, want, unrounded(torch, rk.planar_nerf_train_ref, a, kw, 1),
            (1, 2))
        same = torch.equal(reversed_rays(
            torch, rk.planar_nerf_train_fwd_cuda, a, kw, 1), got)
        kernel_errs["planar_nerf_train_fwd"] = err
        print(f"eval interp: kernel planar_nerf_train_fwd on the planes "
              f"route's inputs ({a[1].shape[0]} rays x {a[3].shape[1]} "
              f"samples, trained weights): max abs err {err:.3e}, share > "
              f"1e-5 {share:.4f} (tol {PLANE_SHARE}); its distance to the "
              f"unrounded model over the plain version's: mean {r_mean:.3f}"
              f", largest {r_max:.3f} per plane at worst (tol {EXACT_MEAN}, "
              f"{EXACT_MAX}); the same bits with the rays reversed: {same}",
              flush=True)
        if share > PLANE_SHARE or r_mean > EXACT_MEAN or r_max > EXACT_MAX:
            fail("eval interp: B2's forward disagrees with its plain version")
        if not same:
            fail("eval interp: B2's forward depends on a ray's place")
        ((a, kw, (w, maps)),) = calls["planar_compositor_fwd_cuda"]
        rw, rmaps = tck.planar_compositor_fwd_ref(*a, **kw)
        err = max(float((w - rw).abs().max()),
                  float((maps - rmaps).abs().max()))
        kernel_errs["planar_compositor_fwd"] = err
        print(f"eval interp: kernel planar_compositor_fwd on the planes "
              f"route's inputs: max abs err {err:.3e} (tol {COMP_TOL})",
              flush=True)
        if not err <= COMP_TOL:
            fail("eval interp: B3's forward disagrees with its plain version")
        del calls, a, kw, got, want, w, maps, rw, rmaps
        res_t = render_full_image(rep.render, params, rays, ts, chunk=CHUNK,
                                  scan_chunks=True, **vis)
        comp = make_render_fn(
            render_config(cfg), output_transient=True,
            output_transient_flow=("fw", "bw"), with_visibility=True,
            keys=("rgb_fine", "depth_fine"))
        reset_counts()
        b1 = render_full_image(comp, params, rays, ts, chunk=CHUNK,
                               scan_chunks=True, **vis)
        if launch_counts()["planar_eval_comp"] == 0:
            fail("eval interp: the composited route ran no B1")
        err = max(float((res_t[k] - b1[k]).abs().max())
                  for k in ("rgb_fine", "depth_fine"))
        print(f"eval interp: the planes route (B2's forward + B3) against "
              f"the composited route (B1) on frame 0's rays and weights: "
              f"rgb / depth max abs err {err:.3e} (tol {FRAME_TOL})",
              flush=True)
        if not err <= FRAME_TOL:
            fail("eval interp: the planes route disagrees with B1")
        png = imageio.read_png("results/monocular/interp/000_000.png")
        want = (255 * np.clip(res_t["rgb_fine"].reshape(
            H_IMG, W_IMG, 3).cpu().numpy(), 0, 1)).astype(np.uint8)
        if not np.array_equal(png, want):
            fail("eval interp: the dt = 0 frame is not the t render")
        vis["vis_poses"] = torch.as_tensor(data.poses[1:2],
                                           dtype=torch.float32,
                                           device="cuda")
        res_tp1 = render_full_image(rep.render, params, rays, ts + 1,
                                    chunk=CHUNK, scan_chunks=True, **vis)
        Kc, c2w = data.Ks[item["cam_ids"]], item["c2w"]
        frames = [interpolate(res_t, res_tp1, dt, Kc, c2w, (W_IMG, H_IMG))
                  for dt in (0.5, 0.5, 0.25, 0.75)]
        same = all(torch.equal(x, y) for x, y in zip(frames[0], frames[1]))
        lo = min(float(f[0].min()) for f in frames)
        hi = max(float(f[0].max()) for f in frames)
        finite = all(bool(torch.isfinite(t).all()) for f in frames
                     for t in f)
        print(f"eval interp: the splat gives the same bits in two runs: "
              f"{same}; interpolated rgb in [{lo:.6f}, {hi:.6f}], finite: "
              f"{finite}", flush=True)
        if not same:
            fail("eval interp: the splat is not deterministic")
        if not (finite and lo >= 0 and hi <= 1):
            fail("eval interp: an interpolated frame outside [0, 1]")
        pre = _interp_pre(
            res_t["xyzs_fine"], res_t["transient_flows_fw"],
            res_tp1["transient_flows_bw"],
            torch.cat([res_t["transient_rgbs_fine"],
                       res_t["transient_alphas_fine"][..., None]], -1),
            torch.cat([res_tp1["transient_rgbs_fine"],
                       res_tp1["transient_alphas_fine"][..., None]], -1),
            0.5, Kc, c2w, w=W_IMG, h=H_IMG)
        def splat():
            return ss.softsplat_batched_planar(*pre, "average")

        splat_ms = cuda_ms(torch, splat, iters=3)
        shifts = splat()
        max_terms = ss.MAX_SHIFT_TERMS
        ss.MAX_SHIFT_TERMS = 0  # the sort-based scatter on these planes
        try:
            scatter = [splat() for _ in range(2)]
            scatter_ms = cuda_ms(torch, splat, iters=3)
        finally:
            ss.MAX_SHIFT_TERMS = max_terms
        same = torch.equal(scatter[0], scatter[1])
        err = float((scatter[0] - shifts).abs().max())
        print(f"eval interp: the splat's scatter form on the interpolation's "
              f"planes gives the same bits in two runs: {same}; against the "
              f"shift form max abs err {err:.3e} (tol {SPLAT_TOL}); "
              f"{scatter_ms:.3f} ms per scatter call on {card}", flush=True)
        if not same:
            fail("eval interp: the scatter splat is not deterministic")
        if not err <= SPLAT_TOL:
            fail("eval interp: the splat's two forms disagree")
        del shifts, scatter
        interp_ms = cuda_ms(torch, lambda: interpolate(
            res_t, res_tp1, 0.5, Kc, c2w, (W_IMG, H_IMG)), iters=3)
        flow_px = max(float(pre[1].abs().max()), float(pre[2].abs().max()))
        print(f"eval interp: {splat_ms:.3f} ms per splat call "
              f"({pre[0].shape[0]} planes of 4 channels at {W_IMG}x{H_IMG}, "
              f"largest flow {flow_px:.1f} px), {interp_ms:.3f} ms per "
              f"interpolated frame on {card}", flush=True)
        del pre, rep, res_t, res_tp1, b1, frames, comp
        torch.cuda.empty_cache()

        # ---- the test split on the packed evaluator (B5) ----
        rep, ran, g = eval_split(
            torch, np, card, "test --planar_eval off",
            base + ["--split", "test", "--planar_eval", "off",
                    "--scene_name", "packed"],
            {"fused_nerf_eval": 1}, N_FRAMES)
        add(ran)
        print(f"eval test --planar_eval off: mean PSNR whole / dynamic "
              f"{np.nanmean(rep.psnr, 0).tolist()} (the static tower)",
              flush=True)
        item = rep.dataset.test_item(0, targets=())
        calls = kept_calls(
            lambda: rep.render(rep.params, item["rays"][chunk_rows],
                               item["ts"][chunk_rows]),
            ((mk, "fused_nerf_eval_cuda"),))
        ((a, kw, got),) = calls["fused_nerf_eval_cuda"]
        want = mk.fused_nerf_eval_ref(*a, **kw)
        if not bool(torch.isfinite(got).all()):
            fail("eval: B5's output not finite")
        err = (got - want).abs()
        worst = float(err.max())
        share = float((err.amax(-1) > 1e-5).float().mean())
        r_mean, r_max = unrounded_ratios(
            got, want, unrounded(torch, mk.fused_nerf_eval_ref, a, kw, 0),
            (0, 1))
        same = torch.equal(reversed_rays(
            torch, mk.fused_nerf_eval_cuda, a, kw, 0), got)
        kernel_errs["fused_nerf_eval"] = worst
        print(f"eval test --planar_eval off: kernel fused_nerf_eval on the "
              f"packed route's inputs ({a[1].shape[0]} rays x "
              f"{a[1].shape[1]} samples, trained weights): max abs err "
              f"{worst:.3e}, rows off by > 1e-5 {share:.4f} (tol "
              f"{PACKED_SHARE}); its distance to the unrounded model over "
              f"the plain version's: mean {r_mean:.3f}, largest "
              f"{r_max:.3f} per column at worst (tol {EXACT_MEAN}, "
              f"{EXACT_MAX}); the same bits with the rays reversed: {same}",
              flush=True)
        if share > PACKED_SHARE or r_mean > EXACT_MEAN or r_max > EXACT_MAX:
            fail("eval: B5 disagrees with its plain version")
        if not same:
            fail("eval: B5 depends on a ray's place")
        del calls, a, kw, got, want, err
        b5 = render_full_image(rep.render, rep.params, item["rays"],
                               item["ts"], chunk=CHUNK, scan_chunks=True)
        planar = make_render_fn(render_config(cfg), output_transient=False,
                                keys=("rgb_fine", "depth_fine"))
        b1 = render_full_image(planar, rep.params, item["rays"], item["ts"],
                               chunk=CHUNK)
        err = max(float((b5[k] - b1[k]).abs().max())
                  for k in ("rgb_fine", "depth_fine"))
        print(f"eval test --planar_eval off: the B5 frame against the B1 "
              f"frame max abs err {err:.3e} (tol {FRAME_TOL})", flush=True)
        if not err <= FRAME_TOL:
            fail("eval: the packed frame disagrees with the planar frame")
    finally:
        os.chdir(here)
    return total, kernel_errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from nsff_pl_tpu_torch.apps.serve import RenderService, make_handler
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.models.raymarch import _visibility_planes
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import cuda_build
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.training.checkpoint import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)

    phase_s = {}
    t0 = time.perf_counter()
    cuda_build.build(["planar_eval_comp", "planar_nerf_train",
                      "planar_compositor", "fused_nerf_eval",
                      "fused_nerf_train", "fused_compositing",
                      "launch_floor"])
    phase_s["build"] = time.perf_counter() - t0
    print(f"build: {phase_s['build']:.1f} s", flush=True)
    t_phase = time.perf_counter()

    K, poses = scene(np)
    cfg = NSFFConfig(img_wh=(W_IMG, H_IMG), start_end=(0, N_FRAMES),
                     use_viewdir=True, encode_t=True, N_samples=128,
                     dtype="bfloat16")
    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    service = RenderService(params, K, poses, (W_IMG, H_IMG), cfg,
                            chunk=CHUNK, device="cuda")

    # ---------------- kernel phase ----------------
    S = cfg.N_samples
    rays = service.frame_rays(poses[0])
    gen = torch.Generator().manual_seed(1)
    ts_all = torch.randint(0, N_FRAMES, (rays.shape[0],), generator=gen)
    record = None
    cases = [("serving: encode_t, viewdir", CHUNK, (), False, True),
             ("encode_t + vis + flow maps", 4096, ("fw", "bw"), True, True),
             ("static only", 4096, (), False, False),
             ("serving, ragged", RAGGED, (), False, True)]
    for label, n, flow, vis_in, encode_t in cases:
        r = rays[:n]
        o, d = r[:, :3].contiguous(), r[:, 3:].contiguous()
        zs = torch.linspace(0, 1, S, device="cuda").expand(n, S).contiguous()
        vis = (_visibility_planes(o, d, zs, K, (W_IMG, H_IMG), poses[:1])
               if vis_in else None)
        de = posenc(d, cfg.S_emb_dir, cfg.N_emb_dir).contiguous()
        te = (params["embedding_t"][ts_all[:n].cuda()].contiguous()
              if encode_t else None)
        fn = rk.make_planar_nerf_eval_comp(
            S, use_viewdir=True, encode_t=encode_t, output_flow=flow,
            vis_in=vis_in)
        pw = fn.pack(params["nerf_fine"])
        args = (pw, o, d, zs, vis, de, None, te)
        got = rk.planar_eval_comp_cuda(*args, **fn.kernel_kw)
        torch.cuda.synchronize()
        want = rk.planar_eval_comp_ref(*args, **fn.kernel_kw)
        if not bool(torch.isfinite(got).all()):
            fail(f"kernel output not finite ({label})")
        err = (got - want).abs().max(0).values.cpu().numpy()
        print(f"kernel planar_eval_comp [{label}] n={n} S={S}: max abs err "
              f"per column {np.array2string(err, precision=2)} "
              f"(tol {TOL})", flush=True)
        if float(err.max()) > TOL:
            fail(f"planar_eval_comp disagrees with its plain version "
                 f"({label}): {float(err.max())} > {TOL}")
        err = float(err.max())
        if record is None:  # the serving shape
            ms = cuda_ms(torch, lambda: rk.planar_eval_comp_cuda(
                *args, **fn.kernel_kw), iters=5)
            plain_ms = cuda_ms(torch, lambda: rk.planar_eval_comp_ref(
                *args, **fn.kernel_kw), iters=2)
            flops, nbytes = eval_comp_work(params["nerf_fine"], fn.kernel_kw,
                                           n, S, pw)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            record = {
                "name": "planar_eval_comp", "route": "cuda",
                "source": "nsff_pl_tpu_torch/csrc/planar_eval_comp.cu",
                "replaces": "nsff_pl_tpu/ops/raymarch_kernel.py:728",
                "launches": None, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None}
            print(f"kernel planar_eval_comp n={n}: {ms:.3f} ms "
                  f"({rate_line(flops, ms, record['bound_ms'])}), "
                  f"plain {plain_ms:.3f} ms, bound {record['bound_ms']:.3f} "
                  f"ms ({flops / 1e12:.2f} TFLOP) on {card}", flush=True)
        else:
            record["max_abs_err"] = max(record["max_abs_err"], err)
        del want, got

    train_records = train_kernel_phase(torch, np, rk, tck, params, rays,
                                       card)
    packed_records = packed_kernel_phase(torch, np, params, rays, card)
    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- serving phase (a main path) ----------------
    from http.server import HTTPServer

    server = HTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/render"
    c2w = poses[7].copy()
    c2w[:, 3] += np.array([0.02, -0.01, 0.03], np.float32)
    frame_s = []
    try:
        torch.cuda.synchronize()
        reset_counts()
        outs = []
        for t, pose in ((0, None), (17, None), (5, c2w.tolist())):
            t0 = time.perf_counter()
            outs.append(service.render_pose(t, pose))
            frame_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        req = urllib.request.Request(url, data=json.dumps({"t": 3}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, png = resp.status, resp.read()
        frame_s.append(time.perf_counter() - t0)
        serve_counts = launch_counts()
        launches = serve_counts["planar_eval_comp"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    record["launches"] = launches
    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    print(f"serving: 4 requests at {W_IMG}x{H_IMG}, planar_eval_comp "
          f"launches {launches} (expected {4 * n_chunks})", flush=True)
    if launches != 4 * n_chunks:
        fail("the serving path did not run on the planar_eval_comp kernel "
             f"once per chunk ({launches} launches)")
    if status != 200 or png[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"POST /render answered {status} without a PNG")
    for rgb, depth in outs:
        if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG):
            fail(f"render_pose shapes {rgb.shape} {depth.shape}")
        if not np.isfinite(depth).all():
            fail("render_pose depth not finite")
    maps = service.render_maps(0)
    rgbf = maps["rgb_fine"]
    if not bool(torch.isfinite(rgbf).all()) or float(rgbf.min()) < 0 \
            or float(rgbf.max()) > 1:
        fail("rgb_fine not finite or outside [0, 1]")
    print("serving: per-request seconds (3 render_pose + POST /render) "
          + json.dumps([round(s, 6) for s in frame_s])
          + f" on {card}", flush=True)

    phase_s["serving"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- training phase (a main path) ----------------
    tcfg = NSFFConfig(img_wh=(W_IMG, H_IMG), start_end=(0, N_FRAMES),
                      use_viewdir=True, encode_t=True, N_samples=128,
                      batch_size=BATCH, num_epochs=50, lr=5e-4,
                      lr_scheduler="cosine", dtype="bfloat16")
    table, Ks, Ps = train_scene(torch, np, K, poses)
    print(f"training: ray table {tuple(table.shape)} float32 on the card "
          f"({table.numel() * 4 / 1e6:.1f} MB)", flush=True)
    train_counts, train_graph_counts, planar_ms, planar_graph_ms = \
        training_phase(torch, np, tcfg, table, Ks, Ps, card,
                       label="training", per_step=PER_STEP, planar=True,
                       profile=True)
    for name, rec in train_records.items():
        # the eager steps' launches and the graphed dispatch's
        rec["launches"] = train_counts[name] + train_graph_counts[name]
    phase_s["training"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- packed serving phase (a main path) ----------------
    packed_serve_counts = packed_serving_phase(torch, np, cfg, params, K,
                                               poses, maps, card)
    phase_s["packed serving"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- packed training phase (a main path) ----------------
    pcfg = tcfg.replace(fused_train="off", fused_compositing=True)
    packed_counts, packed_graph_counts, packed_ms, packed_graph_ms = \
        training_phase(torch, np, pcfg, table, Ks, Ps, card,
                       label="packed training", per_step=PER_STEP_PACKED,
                       planar=False, profile=True)
    print(f"packed training: {packed_ms:.3f} ms per step eager, "
          f"{packed_graph_ms:.3f} ms graphed, against {planar_ms:.3f} / "
          f"{planar_graph_ms:.3f} ms on the planar path in this run",
          flush=True)
    for name, rec in packed_records.items():
        # the eager steps', the graphed dispatch's and (the evaluator also
        # serves) the packed frame's
        rec["launches"] = (packed_counts[name] + packed_graph_counts[name]
                           + packed_serve_counts[name])
    training_phase(torch, np, pcfg.replace(encode_t=False), table, Ks, Ps,
                   card, label="static-only training",
                   per_step=PER_STEP_STATIC, planar=False,
                   steps=STATIC_STEPS, repeat=False)
    phase_s["packed training"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- scene training (a main path) ----------------
    scene_ran = scene_training_phase(
        torch, np, card, {"planar": planar_graph_ms,
                          "packed": packed_graph_ms})
    record["launches"] += scene_ran["planar_eval_comp"]
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += scene_ran[name]
    phase_s["scene training"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- eval (a main path) ----------------
    eval_ran, eval_errs = eval_phase(torch, np, card)
    record["launches"] += eval_ran.get("planar_eval_comp", 0)
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += eval_ran.get(name, 0)
        # the worst error also covers the eval paths' inputs
        rec["max_abs_err"] = max(rec["max_abs_err"], eval_errs.get(name, 0))
    phase_s["eval"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- agreement ----------------
    small_wh = (32, 18)
    small = {}
    for dev in ("cuda", "cpu"):
        svc = RenderService(to_device(params, dev), K * np.array([[small_wh[0] / W_IMG], [
            small_wh[1] / H_IMG], [1]], np.float32), poses, small_wh,
            cfg.replace(planar_eval="on"), chunk=256, device=dev)
        small[dev] = {k: v.float().cpu() for k, v in
                      svc.render_maps(9, c2w).items()}
    err = max(float((small["cuda"][k] - small["cpu"][k]).abs().max())
              for k in small["cpu"])
    print(f"agreement: {small_wh[0]}x{small_wh[1]} frame, card vs plain "
          f"CPU render max abs err {err:.3e} (tol {TOL})", flush=True)
    if err > TOL:
        fail(f"card render disagrees with the plain CPU render: {err}")
    train_agreement(torch, tcfg, table, Ks, Ps, "planar training")
    train_agreement(torch, pcfg, table, Ks, Ps, "packed training")
    phase_s["agreement"] = time.perf_counter() - t_phase
    print("phase seconds " + json.dumps(
        {k: round(v, 3) for k, v in phase_s.items()}), flush=True)

    print(json.dumps({"kernels": [record] + list(train_records.values())
                      + list(packed_records.values())}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
