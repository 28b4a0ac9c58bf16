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
   plain evaluators against bfloat16 (F32_TOL); the spiral (180 frames)
   with `--fix_view_dir`, its frame 5 against the same pose without it;
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
   capture, one graph, one replay a frame. A measurement for ROADMAP C:
   three test frames of both towers in bfloat16 (B1) and float32 against
   the float64 render (`against_f64`: per-pixel errors, visibility counts
   at the worst pixels);
8. coarse-to-fine (main paths, `--N_importance 64`: the fine pass at
   S = 256 in training and for both towers, 192 for the static tower):
   B1 at 256 and 192 (on depths spaced as the fine pass spaces them),
   B2's forward and both backward branches and B3's forward and adjoint
   at 256 and 192, each against its plain version with the S = 128
   tolerances (the warps' flow-plane cotangents, at every S, also no
   farther from the unrounded model than the plain version: EXACT_MEAN /
   EXACT_MAX), timed, with its bound; the training
   recipe at N_importance 64 (eager, graphed equal bit for bit, launch
   counts PER_STEP_C2F, a repeated batch, one step at batch 64 against
   the CPU); a 512x288 `render_pose` frame of both towers; a train CLI
   run at N_importance 64 on the scene's first 4 frames and the eval CLI
   on its checkpoint: the test split of the static tower and with
   `--output_transient`, and `test_fixview0_interp4`, every frame one
   graph replay equal to the host loop within GRAPH_TOL, and B1 held
   against its plain version on the inputs each test split gives it
   (the unrounded model, as in 7). Launches are counted by sample count
   (`ops/launches.py`: `<name>` at 128 samples, `<name>@256` at 256).
   The packed path's coarse-to-fine (`fused_train="off"` /
   `planar_eval="off"`, the coarse pass on the bf16 plain evaluators):
   B4, B5 and B6 at 256 and 192 against their plain versions with the
   S = 128 tolerances on sorted fine-pass depths (B5's plain version 4096
   rays at a time), the training recipe with the fused compositor
   (eager; graphed equal to it bit for bit; launches PER_STEP_PACKED_C2F;
   a repeated batch; one step at batch 64 against the CPU), three steps
   of the static-only model (B4 / B5 at 192) and of float32 (no kernel),
   a 512x288 `render_pose` frame of each of the three, and the eval CLI's
   two c2f test splits again with `--planar_eval off` (B5 at 192 / 256 on
   their inputs against the unrounded model; each split's mean PSNR
   within PSNR_C2F_TOL of the planar route's);
9. reproducibility (ROADMAP C1): the train CLI at the flagship recipe
   with hard sampling on the scene's first 4 frames (one epoch, 589
   steps, a validation and hard-sampling refresh every 200 steps), from
   one seed and once stopped by its time budget and resumed: the params,
   Adam's moments, `tmp_rgb` and the sampling weights at the end the
   same bits in both (the second run from the seed is phase 13's
   `--num_gpus 2` run);
10. agreement: a small frame rendered on the card equals the plain CPU
   render of the same weights within `TOL`; one training step at batch
   64 on the card equals the plain CPU step from the same state, batch
   and draws (loss terms and Adam's first moments), on the planar and on
   the packed path;
11. the train-path variants (main paths; after the training phase and,
   through the CLI, after the scene training phase): B2's stacked warp
   call (the transient tower with both flow heads and flow in) forward
   and backward against its plain version at 512 rows and S = 128 / 256,
   and B3 at the 256 gathered rows of `warp_importance 0.5`; the
   flagship recipe with `warp_subsample 2`, with `warp_importance 0.5`
   and with `planar_compositing off` (10 eager steps and the same 10
   graphed, equal bit for bit, launch counts PER_STEP_WS2 / _WI /
   _OFF; wi also twice graphed from one seed with the same bits, a
   torch.profiler breakdown and one step at batch 64 against the CPU);
   `warp_subsample 2` under coarse-to-fine (5 steps, graphed equal to
   eager); sgd, radam and ranger (graphed equal to eager) and the
   'stub' train backend (no kernel); through the train CLI with
   `--warp_importance 0.5`: ranger on 4 frames, uninterrupted and
   stopped by its time budget and resumed (the resumed state equal to
   the checkpoint file, the ends the same bits), and Adam on all frames
   for WI_RUN_BUDGET_S, its validation PSNR up by PSNR_GAIN_DB;
12. profiling and the serving tools (main paths; after the eval phase,
   on the scene training checkpoint), a JSON line per part: (a) the
   train CLI with `--profile_dir` on the scene's first 3 frames at
   128x72 (27 steps): its torch.profiler trace holds the ranges of steps
   10-14 and, in them, B2's and B3's kernels at PER_STEP a step, and the
   run ends with the bits of the same run with `--scan_steps 1` and no
   profiling; ms a step inside the window and unprofiled; (b)
   `tools/profile_step.py` at 8192 rays, auto (B2 + B3) then off (B4 +
   B5): ms a step, launches per step, its trace; (c)
   `tools/save_weights_only.py` on the checkpoint: a served frame and an
   eval frame from the stripped file equal those from the full one bit
   for bit; (d) `tools/export_render.py` at 512x288, chunk 32768,
   `--use_viewdir --N_samples 128 --check`: the kernel route in bfloat16
   with `--encode_t --output_transient` (B1), with `--encode_t
   --N_importance 64` (the planar coarse-to-fine route on seeded
   weights: B2's forward at 128 samples, then B1 at 192) and without
   `encode_t` (B5), and the plain route in float32, each reloaded in a
   fresh process that imports torch and, for the kernel routes,
   `nsff_pl_tpu_torch.ops.library` alone: one launch of each kernel a
   call, its output within the tool's check tolerance of the live
   renderer (the coarse-to-fine route: equal to it), ms per exported
   chunk beside the live chunk;
13. data-parallel training (main paths; after the C1 phase): a world of
   one rank over NCCL (`parallel.distributed.initialize`) runs
   DP_STEPS eager flagship steps and DP_STEPS as one graphed dispatch
   (then DP_TIMED timed dispatches in turns with the undistributed
   graph), on the planar and the packed path, each against the
   undistributed run from the same seed: loss terms, params, the
   optimizer's state and `tmp_rgb` the same bits; the collectives the
   capture called (one all-reduce a step) and, by torch.profiler over a
   replay, the copies NCCL left in the graph for them; the graphed ms a
   step of both. Served 512x288 frames over the mesh (`RenderService(
   mesh=)`) on B1 and, with `planar_eval="off"`, on B5 against the
   undistributed service: the same bits, one launch and one all-gather a
   chunk, seconds a request in turns. Then the train CLI with the C1
   phase's flags and `--num_gpus 2` (one GPU: the fewer-GPUs note, a
   world of one) against C1's first run (`--num_gpus 1`): the same bits
   at the end, the same loss rows and the same validation rows (its
   validations render over the mesh). Then the eval CLI with
   `--num_gpus 2` on the eval phase's `test_spiral --fix_view_dir`:
   one graph replay a frame (the graph holds the chunks' all-gathers),
   every file the eval phase's run wrote the same bytes;
14. from video frames to a trained scene (a main path; after the C1
   phase, on its frame count and flags): C1's frames at 1536x864
   written as JPEG by the port's encoder, the preprocess CLI's resize
   stage to 1024x576 (the float INTER_AREA path, JPEG frames written
   back; a second run skips; the masks stage raises detectron2's
   RuntimeError, the colmap stage exits with the JAX package's text),
   `trivial_masks`, write_scene's priors and model; a fresh system's
   validation (the uncached JPEG scene load), the train CLI for one
   epoch (the cached load equal to the uncached table, launches
   PER_STEP, one capture, finite loss rows, the last validation's PSNR
   up by PSNR_GAIN_DB, C1's PNG run's validations printed beside) and
   the eval CLI's test split on its checkpoint (B1); the codec's and
   the resize's host seconds a frame, the scene loads, the CLI's ms a
   step and the decoded frames against `resize_area_cv2` of the source
   (FRAMES_PSNR_DB). Two of the resized frames have their quantised
   coefficients rewritten progressive, arithmetic-coded and progressive
   arithmetic-coded (`tests/torch_jpeg_writer.py`, numpy alone: the card's
   machine has neither PIL nor OpenCV), each decoding to the baseline
   decode's bytes, with the host seconds a frame of each decode.

15. any sample count (ROADMAP A17; the sweep after the c2f kernels, the
   paths after the packed coarse-to-fine phase): every kernel of the
   paths below against its plain version at 96 and 320 samples a ray (B2
   and B3 also at 64) at the main paths' shapes (B1 and B5 at the serving
   chunk, the rest at batch 512) with the S = 128 tolerances (B2's
   stacked warp call and both backward branches among them, the warps'
   flow-plane cotangents by the unrounded-model rule, B6 with rays opaque
   at their far sample; the other counts and the few-ray shapes are
   tests/test_torch_cuda.py's), each timed there beside its plain version
   and its bound at the call's real samples, and its time at 96 and 320
   against 128 and 256 (`tail_tile_line`, ROADMAP B-d); then the main
   paths at those counts: the recipe at `--N_samples 96` (planar:
   TRAIN_STEPS eager steps and the same steps graphed, equal bit for bit,
   one step at batch 64 against the CPU; packed with the fused
   compositor: STATIC_STEPS steps, eager and graphed) and the NeRF
   paper's coarse-to-fine counts `--N_samples 64 --N_importance 128` (the
   coarse pass at 64, the fine pass at 320; planar: TRAIN_STEPS steps
   graphed against eager; packed: STATIC_STEPS steps), a 512x288
   `render_pose` frame of each recipe on B1 and on B5, and the eval CLI's
   test split at `--N_samples 96` on the scene training checkpoint (B1 at
   96, one graph replay a frame, frame 0 equal to the host loop), each with
   its launch counts by sample count (PER_STEP_96, PER_STEP_PACKED_96,
   PER_STEP_C2F2, PER_STEP_PACKED_C2F2).
16. input widths (ROADMAP A18, A19 and the 16-frequency cap of C; after
   the any-S phase): the packed evaluator's wide instance (two 128-lane
   input segments) at `--N_tau 80` and at `--N_emb_xyz 22`, and its
   streamed instance (three and more) at `--N_tau 200`, `--N_emb_xyz 43`,
   both (four segments) and `--N_tau 321`, and the wide direction and
   appearance embeddings (`--N_tau 80 --N_emb_dir 22 --encode_a --N_a
   160`; static only refused, its tower input one segment) against its
   plain version at the serving chunk (full, static only, transient only,
   37 rays; PACKED_TOL / PACKED_SHARE), timed with its bound, the
   one-segment B5 timed before and after; at `--N_emb_xyz 17 --N_tau 8`
   (17 frequencies) B1 at the serving chunk, B2, B3, B4, B5 and B6 as in
   the kernel phase, with its tolerances (B2's flow-plane cotangents by
   the unrounded-model rule), each timed; then the paths: at each wide
   width a 512x288 `render_pose` frame with `planar_eval="off"` in
   bfloat16 (5 launches of B5) against the float32 frame of the plain
   evaluators (F32_TOL), and at `--N_tau 80`, `--N_emb_xyz 22` and
   `--N_tau 200` WIDE_STEPS steps of `--train_backend xla` (the plain
   evaluators, no launch; the JAX package's gradient kernels refuse these
   widths); at 17 frequencies
   the planar recipe (WIDE_STEPS eager steps and the same graphed, equal
   bit for bit, PER_STEP) and the packed one (the same, PER_STEP_PACKED), and a
   served frame on B1 against the one on B5 (FRAME_TOL). The records are
   named with their widths, e.g. `fused_nerf_eval[N_emb_xyz 10, N_tau 80]`.

The training phases end with a torch.profiler trace of 5 more steps
(device time by kernel, the device's busy share and the backward's
phases per step; the full tables go to chip_smoke_out/).

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the script exits non-zero and prints no result line.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
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


def _in_widths(params):
    """(xyz_w, n_tau) of a model's tower inputs: posenc lanes, time latent."""
    xyz_w = params["static_xyz_0"]["w"].shape[0]
    t0 = params.get("transient_xyz_0")
    return xyz_w, (t0["w"].shape[0] - xyz_w) if t0 is not None else 0


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
    nbytes += n * _in_widths(params)[1] * 4 if encode_t else 0
    # the direction [and appearance] embeddings, once a ray
    nbytes += n * (params["static_dir"]["w"].shape[0] - 256) * 4 \
        if static_branch else 0
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
    xyz_w, n_tau = _in_widths(params)
    if branch == "static":
        names = [f"static_xyz_{i}" for i in range(8)] + [
            "static_xyz_final", "static_sigma", "static_rgb"]
        per_sample = 3 * sum(_mac(params, k) for k in names)
        if not need_dxyz:
            # no data gradient into the encoding: layer 0 and the skip input
            per_sample -= 2 * xyz_w * 256
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
        extra_in = n * n_tau * 4 + (3 * n * S * 4 if flow_in else 0)
        out = sum(_mac(params, k) + params[k]["b"].numel() for k in names)
        out_bytes = (out + 257 * (4 + 3 * n_flow_out)) * 4 + n * n_tau * 4 + (
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


def at_samples(name, S):
    """A kernel record's name: the kernel's, and its sample count where it
    is not 128."""
    return name if S == 128 else f"{name}@{S}"


def train_kernel_phase(torch, np, rk, tck, params, rays, card, S=128,
                       widths=None):
    """The four training kernels against their plain versions at batch
    512 on the main variant and both warps, at S samples a ray; returns
    their kernel records (launches filled in by the training phases). At
    S = 128 it also times the weight packing and each backward's phases.
    `widths`: the model's input widths (n_emb_xyz, n_tau) where they are
    not the flagship's, its records' names tagged with them (`wtag`)."""
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs

    wkw = widths or {}
    extras = S == 128 and widths is None

    def nm(base):
        return at_samples(base, S) + wtag(widths)

    n = BATCH
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
                                        output_flow=("fw", "bw"), **wkw)
    pw = main_op.pack(fine)
    if extras:
        # the weight packing runs once per step, for the three evaluations
        pack_ms = cuda_ms(torch, lambda: main_op.pack(fine), iters=10)
        print(f"weight packing (once per training step): {pack_ms:.3f} ms "
              f"on {card}", flush=True)
    records, planes = {}, {}
    src = "nsff_pl_tpu_torch/csrc/planar_nerf_train.cu"
    for label, static_branch, flow_in, flow in (
            ("main", True, False, ("fw", "bw")),
            ("fw warp", False, True, ("bw",)),
            ("bw warp", False, True, ("fw",))):
        op = rk.make_planar_nerf_train(S, static_branch=static_branch,
                                       flow_in=flow_in, use_viewdir=True,
                                       output_flow=flow, **wkw)
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
        print(f"kernel {nm('planar_nerf_train_fwd')} [{label}] n={n} S={S}: max abs "
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
        fwd_name = nm("planar_nerf_train_fwd")
        if label == "main":
            plain_ms = cuda_ms(torch, lambda: rk.planar_nerf_train_ref(
                *args, **kw), iters=3)
            records["planar_nerf_train_fwd"] = {
                "name": fwd_name, "route": "cuda",
                "source": src,
                "replaces": "nsff_pl_tpu/ops/raymarch_kernel.py:64",
                "launches": None, "max_abs_err": float(worst.max()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                "bound_by": bby, "library_ms": None, "host_us": host_us,
                "warp_ms_each": []}
            print(f"kernel {fwd_name} [main] n={n}: {ms:.3f} ms, "
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
            print(f"kernel {fwd_name} [{label}] n={n}: {ms:.3f} "
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
            # the flow-plane cotangents are per-sample point cotangents: a
            # ReLU turned by a rounding flip shows whole in one sample
            # (0.114 of the largest entry at 256 samples). At every S each
            # plane stands no farther from the unrounded model than the
            # plain version does (EXACT_MEAN on average, EXACT_MAX at its
            # largest), within GRAD_FRO in Frobenius norm, and at 128
            # samples also within GRAD_MAX as the summed leaves (at the
            # flagship's widths, where that was measured; at other widths
            # the per-sample rule, as off 128: at 17 frequencies one
            # sample's dflow0 parts by 0.135 of its largest entry, both
            # sides equally far from the unrounded model)
            per_sample = [k for k in errs if (S != 128 or widths) and
                          k.startswith("dflow")]
            summed = [k for k in errs if k not in per_sample]
            w_max = max(summed, key=lambda k: errs[k][0])
            w_fro = max(errs, key=lambda k: errs[k][1])
            dx = max((errs[k][0] for k in per_sample), default=0.0)
            abs_err = max(e[2] for e in errs.values())
            r_mean = r_max = p_far = 0.0
            if "dflows" in want_b:
                exact = unrounded_dflows(torch, args, kw, cot, op.out_keys)
                for c in range(3):
                    want_c = want_b["dflows"][c]
                    rm, rx = unrounded_ratios(got_b["dflows"][c], want_c,
                                              exact[c], (0, 1))
                    r_mean, r_max = max(r_mean, rm), max(r_max, rx)
                    p_far = max(p_far, rel_errs(want_c, exact[c])[0])
            print(f"kernel {nm('planar_nerf_train_bwd_' + branch)} "
                  f"[{label}]: "
                  f"{len(errs)} outputs, worst error/max {errs[w_max][0]:.2e} "
                  f"({w_max}), worst Frobenius {errs[w_fro][1]:.2e} "
                  f"({w_fro}) (tol {GRAD_MAX}, {GRAD_FRO})"
                  + (f"; dflow error/max {dx:.2e}" if per_sample else "")
                  + (f"; dflow distance to the unrounded model over the "
                     f"plain version's: mean {r_mean:.3f}, largest "
                     f"{r_max:.3f} (tol {EXACT_MEAN}, {EXACT_MAX}); the "
                     f"plain version's own largest distance to it "
                     f"{p_far:.3f} of the plane's largest entry"
                     if "dflows" in want_b else ""), flush=True)
            if errs[w_max][0] > GRAD_MAX or errs[w_fro][1] > GRAD_FRO \
                    or r_mean > EXACT_MEAN or r_max > EXACT_MAX:
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
                    "name": nm(name), "route": "cuda",
                    "source": src,
                    "replaces": "nsff_pl_tpu/ops/raymarch_kernel.py:64",
                    "launches": None, "max_abs_err": abs_err,
                    "max_rel_err": errs[w_max][0], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                    "library_ms": None}
                print(f"kernel {nm(name)} [main] n={n}: {ms:.3f} "
                      f"ms, plain {plain_ms:.3f} ms, bound {bms:.3f} ms "
                      f"({flops / 1e12:.3f} TFLOP) on {card}", flush=True)
                if extras:
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
    print(f"kernel {nm('planar_compositor')}: forward max abs err "
          f"{fwd_err:.2e}, "
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
            "name": nm(name), "route": "cuda", "source": csrc,
            "replaces": "nsff_pl_tpu/ops/compositing_planar_kernel.py:110",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None}
        if which == "bwd":
            records[name]["max_rel_err"] = bwd_err
        print(f"kernel {nm(name)} n={n}: {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({nbytes / 1e6:.2f} "
              f"MB) on {card}", flush=True)
    return records


def wtag(widths):
    """The suffix of a kernel record's name at input widths other than the
    flagship's: "[N_emb_xyz 17, N_tau 8]" (with the direction and
    appearance embeddings' where `widths` has them), or "" for None."""
    if widths is None:
        return ""
    extra = "".join(f", {k} {widths[w]}" for w, k in (
        ("n_emb_dir", "N_emb_dir"), ("n_a", "N_a")) if w in widths)
    return f"[N_emb_xyz {widths['n_emb_xyz']}, N_tau {widths['n_tau']}{extra}]"


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


def plain_by_rays(torch, fn, args, kw, rays=4096):
    """A kernel's plain version `fn(*args, **kw)`, `rays` rays at a time
    (the tensor arguments whose first dimension is the ray count; each
    ray's output is its own): a whole chunk's activations at 192 or 256
    samples would take tens of GB."""
    n = next(x for x in args if torch.is_tensor(x)).shape[0]
    return torch.cat([fn(*(
        x[i:i + rays] if torch.is_tensor(x) and x.shape[0] == n else x
        for x in args), **kw) for i in range(0, n, rays)])


def packed_plain_eval(torch, mk, args, kw, S):
    """B5's plain version, off 128 samples or past two input segments by
    `plain_by_rays`."""
    if S == 128 and mk.packed_in_rows(args[0]) <= 256:
        return mk.fused_nerf_eval_ref(*args, **kw)
    return plain_by_rays(torch, mk.fused_nerf_eval_ref, args, kw)


def packed_kernel_phase(torch, np, params, rays, card, S=128,
                        main_case="full", widths=None):
    """The packed-boundary kernels against their plain versions at S
    samples a ray: the evaluator at the serving chunk (full, static only,
    transient only) and at a ragged count, its backward at batch 512
    (static; transient with and without the xyz cotangent) and the
    compositor at batch 512 (at 128 samples also at 8192 rays, beside the
    launch floor, and the backward's phases). Off 128 samples the depths
    are spaced as the c2f fine pass spaces them: the 128 stratified ones
    and S - 128 random ones, sorted. The evaluator's record is timed on
    `main_case`, the variant the main paths run at S (its error covers
    every variant). Returns the kernel records, named by `at_samples`
    (launches filled in by the packed phases). `widths`: the model's
    input widths (n_emb_xyz, n_tau) where they are not the flagship's, the
    records' names tagged with them (`wtag`); past one input segment
    (B5's wide and streamed instances) only the evaluator runs (B4 takes
    one segment, B6 no width). `widths` may hold the direction and
    appearance embeddings' (n_emb_dir, n_a: with appearance); where the
    variant's tower input fits one segment, B5 must refuse them wider than
    one segment (as JAX's padded layout raises or is wrong there)."""
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs

    fine = params["nerf_fine"]
    wkw = widths or {}
    n_dir = wkw.get("n_emb_dir", 4)
    encode_a = "n_a" in wkw
    extras = S == 128 and widths is None
    wide = sum(_in_widths(fine)) > 128
    gen = torch.Generator(device="cuda").manual_seed(4 + S)

    def inputs(n):
        o, d = rays[:n, :3], rays[:n, 3:]
        zs = stratified_zs(n, 128, 1.0, torch.rand((n, 128), generator=gen,
                                                   device="cuda"),
                           device="cuda")[0]
        if S != 128:
            zs = torch.sort(torch.cat([zs, torch.rand(
                (n, S - 128), generator=gen, device="cuda")], 1), 1).values
        zs = zs.contiguous()
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        ts = torch.randint(0, N_FRAMES, (n,), generator=gen, device="cuda")
        t_emb = params["embedding_t"][ts].contiguous()
        a_emb = params["embedding_a"][ts].contiguous() if encode_a else None
        return xyz, zs, posenc(d, 3.0, n_dir).contiguous(), t_emb, a_emb

    records = {}
    ename = at_samples("fused_nerf_eval", S) + wtag(widths)
    eval_err = 0.0
    # ---- the evaluator at the serving chunk
    n = CHUNK
    xyz, _, de, te, ae = inputs(n)
    src = "nsff_pl_tpu_torch/csrc/fused_nerf_eval.cu"
    for label, static_branch, encode_t, flow, n in (
            ("full", True, True, ("fw", "bw"), CHUNK),
            ("static only", True, False, (), CHUNK),
            ("transient only", False, True, ("bw",), CHUNK),
            ("full, ragged", True, True, ("fw", "bw"), RAGGED)):
        ekw = dict(use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
                   output_flow=flow, static_branch=static_branch, **wkw)
        lanes = _in_widths(fine)[0] + (_in_widths(fine)[1] if encode_t else 0)
        if static_branch and lanes <= 128 and (3 + 6 * n_dir > 128 or
                                               wkw.get("n_a", 0) > 128):
            try:
                mk.make_fused_nerf_eval(S, **ekw)
            except ValueError as e:
                print(f"kernel {ename} [{label}]: {lanes} tower input lanes "
                      f"(one segment) with the wide embeddings refused: "
                      f"{str(e)[:80]}...", flush=True)
                continue
            fail(f"{ename} took wide embeddings at one segment ({label})")
        fn = mk.make_fused_nerf_eval(S, **ekw)
        pw = fn.pack(fine)
        args = (pw, xyz[:n], de[:n] if static_branch else None,
                ae[:n] if static_branch and encode_a else None,
                te[:n] if encode_t else None)
        kw = fn.kernel_kw
        got = mk.fused_nerf_eval_cuda(*args, **kw)
        torch.cuda.synchronize()
        want = packed_plain_eval(torch, mk, args, kw, S)
        if not bool(torch.isfinite(got).all()):
            fail(f"packed evaluator output not finite ({label})")
        err = (got - want).abs()
        worst = err.amax((0, 1)).cpu().numpy()
        share = float((err.amax(-1) > 1e-5).float().mean())
        del err, want
        print(f"kernel {ename} [{label}] n={n} S={S}: max abs err "
              f"per column {np.array2string(worst, precision=2)}, rows off "
              f"by > 1e-5 {share:.4f} (tol {PACKED_TOL}, {PACKED_SHARE})",
              flush=True)
        if float(worst.max()) > PACKED_TOL or share > PACKED_SHARE:
            fail(f"{ename} disagrees with its plain version ({label})")
        zero_cols = ([] if static_branch else [0, 1, 2, 3]) + list(
            range(8 + 3 * len(flow) if encode_t else 4, 16))
        if bool(got[..., zero_cols].any()):
            fail(f"{ename} wrote unused columns ({label})")
        del got
        err = float(worst.max())
        eval_err = max(eval_err, err)
        if label == "full, ragged":
            continue
        flops, nbytes = train_fwd_work(fine, static_branch, len(flow), n, S,
                                       pw, 16, False, encode_t=encode_t,
                                       packed=True)
        ms = cuda_ms(torch, lambda: mk.fused_nerf_eval_cuda(*args, **kw),
                     iters=3)
        plain_ms = cuda_ms(torch, lambda: packed_plain_eval(
            torch, mk, args, kw, S), iters=1, warmup=0)
        bms = bound(flops, nbytes)[0]
        if label == main_case:
            records[ename] = _record(
                ename, src, "nsff_pl_tpu/ops/mlp_kernel.py:121", err, ms,
                plain_ms, flops, nbytes)
        print(f"kernel {ename} [{label}] n={n}: {ms:.3f} ms "
              f"({rate_line(flops, ms, bms)}), plain "
              f"{plain_ms:.3f} ms, bound {bms:.3f} ms "
              f"({flops / 1e12:.2f} TFLOP) on {card}", flush=True)
    records[ename]["max_abs_err"] = eval_err
    del xyz, de, te, ae
    if wide:
        return records

    # ---- the backward at the training batch
    n = BATCH
    xyz, zs, de, te, _ = inputs(n)
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
                                       need_dxyz=need_dxyz, **wkw)
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
        line = (f"kernel {at_samples(f'fused_nerf_train_bwd_{branch}', S)}"
                f"{wtag(widths)} [{label}]: "
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
            fail(f"fused_nerf_train backward ({branch}, {label}, S={S}) "
                 "disagrees with its plain version")
        ms = cuda_ms(torch, lambda: mtk.fused_nerf_train_bwd_cuda(
            *args, need_dxyz=need_dxyz, **bkw), iters=5, graph=True)
        flops, nbytes = train_bwd_work(fine, branch, len(flow), n, S, pw,
                                       False, packed=True,
                                       need_dxyz=need_dxyz)
        name = at_samples(f"fused_nerf_train_bwd_{branch}", S) + wtag(widths)
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
            if extras:
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
    print(f"kernel {at_samples('fused_compositing', S)}{wtag(widths)}: "
          f"forward max abs "
          f"err {fwd_err:.2e}, adjoint worst error/max per column "
          f"{bwd_err:.2e} (tol {COMP_TOL})", flush=True)
    if not bool(torch.isfinite(dp).all()) or bool(dp[..., 8:].any()):
        fail(f"fused_compositing adjoint not finite or columns 8-15 not "
             f"zero (S={S})")
    if fwd_err > COMP_TOL or bwd_err > COMP_TOL:
        fail(f"fused_compositing disagrees with its plain version (S={S})")
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
        name = at_samples(f"fused_compositing_{which}", S) + wtag(widths)
        records[name] = _record(
            name, csrc, "nsff_pl_tpu/ops/compositing_kernel.py:100", err, ms,
            plain_ms, ops, nbytes, PEAK_F32_FLOPS)
        if which == "bwd":
            records[name]["max_rel_err"] = bwd_err
        print(f"kernel {name} n={n}: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {records[name]['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.2f} MB) on {card}", flush=True)
    if extras:
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
    for k in sorted(set(counts) | set(expected)):
        v, want = counts.get(k, 0), expected.get(k, 0) * n
        if v != want:
            fail(f"{what}: {k} launched {v} times, expected {want}")


def train_setup(torch, cfg, params, device, batch, scan_steps=1,
                hard_sampling=False, render_kw=None, mesh=None):
    """Optimizer, state and train step of the recipe `cfg` on `device`
    (`scan_steps` > 1: the K-step dispatch; `mesh`: data-parallel);
    `render_kw` overrides fields of its render config that the CLI has
    no flag for (`planar_compositing`)."""
    import dataclasses

    from nsff_pl_tpu_torch.config import loss_config, render_config
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

    spe = N_FRAMES * H_IMG * W_IMG // 1000  # the scene's steps per epoch
    tx = make_optimizer(cfg, spe)
    rc = dataclasses.replace(render_config(cfg), **(render_kw or {}))
    if device == "cpu":  # the kernels' plain versions
        rc = dataclasses.replace(rc, train_backend="pallas")
    step = make_train_step(rc, loss_config(cfg), tx,
                           output_transient=cfg.output_transient,
                           output_transient_flow=tuple(
                               cfg.output_transient_flow),
                           steps_per_epoch=spe, batch_size=batch,
                           hard_sampling=hard_sampling,
                           scan_steps=scan_steps, device=device, mesh=mesh)
    return TrainState(params, tx.init(params), 0), step


def make_draws(torch, cfg, n, gen, lead=(), device="cuda"):
    """The renderer's draws for n rays (`models/rendering.py::draw_shapes`,
    coarse-to-fine's too; on the planar path the same keys and shapes),
    with leading dimensions `lead`."""
    from nsff_pl_tpu_torch.config import render_config
    from nsff_pl_tpu_torch.models import raymarch
    from nsff_pl_tpu_torch.models.rendering import draw_shapes

    rc = render_config(cfg)
    if rc.warp_subsample > 1 or rc.warp_importance:
        # K-row warp noises and the selection's uniform (planar path only)
        shapes = raymarch.draw_shapes(rc, n)
    else:
        shapes = draw_shapes(rc, n, output_transient=cfg.encode_t)
    return {k: (torch.rand if k.startswith("u") else torch.randn)(
        tuple(lead) + shape, generator=gen, device=device)
        for k, shape in shapes.items()}


def step_rows(torch, cfg, sched, gen, steps):
    """The frames and draws of `steps` steps, drawn up front on the card,
    so that the eager steps and the graphed dispatch read the same; a
    step's pixels are distinct (drawn without replacement)."""
    ts = [sched.next() for _ in range(steps)]
    idx = torch.argsort(torch.rand((steps, H_IMG * W_IMG), generator=gen,
                                   device="cuda"), 1)[:, :BATCH]
    return ts, idx, make_draws(torch, cfg, BATCH, gen, (steps,))


def training_phase(torch, np, cfg, table, Ks, Ps, card, *, label, per_step,
                   planar, steps=TRAIN_STEPS, repeat=True, profile=False,
                   exact=False, render_kw=None):
    """A main training path: warm-up, `steps` timed eager steps with the
    launch counts set to 0 just before and read just after them, then the
    same steps as one graphed dispatch (`graphed_phase`) from a copy of
    the state taken before them, on the same frames and draws; then
    (`repeat`) `steps` steps on one repeated batch, whose loss must fall.
    With `exact` the graphed steps must equal the eager ones bit for bit.
    `render_kw`: as `train_setup`'s. Returns the eager counts, the
    graphed counts and the device ms per step of both."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
    from nsff_pl_tpu_torch.training.optim import param_leaves
    from nsff_pl_tpu_torch.training.step import clone_state, write_tmp_rgb

    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    state, step = train_setup(torch, cfg, params, "cuda", BATCH,
                              render_kw=render_kw)
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
        write_tmp_rgb(eager_tmp, t, aux["rand_idx"], aux["rgb_fine"])
    graph_counts, graph_ms = graphed_phase(
        torch, np, cfg, start, (batcher.table, batcher.weights, Ks, Ps, gen),
        ts, idx, draws, eager, eager_tmp, card, label=label,
        per_step=per_step, profile=profile, exact=exact, render_kw=render_kw)

    if repeat:  # one repeated batch and draws: the loss must fall
        t = sched.next()
        idx = torch.randint(0, H_IMG * W_IMG, (BATCH,), generator=gen,
                            device="cuda")
        draws = make_draws(torch, cfg, BATCH, gen)
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
                  eager_tmp, card, *, label, per_step, profile, exact=False,
                  render_kw=None):
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
    `exact`, the loss terms and `tmp_rgb` must be the eager bits; with
    `profile`, torch.profiler over a third dispatch counts the kernels
    the replays ran against the same. Returns the counts and the device
    ms per step."""
    K = len(ts)
    multi = train_setup(torch, cfg, state.params, "cuda", BATCH,
                        scan_steps=K, hard_sampling=True,
                        render_kw=render_kw)[1]
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
    same = all(bool(torch.equal(m[k], v)) for k, v in eager.items())
    written = int((tmp != 0).any(-1).sum())
    want = int((eager_tmp != 0).any(-1).sum())
    tmp_err = float((tmp - eager_tmp).abs().max())
    print(f"{label} [graphed]: tmp_rgb (hard sampling) against the eager "
          f"steps' rgb at their ray ids: {written} pixels written "
          f"({want} by the eager steps), worst abs error {tmp_err:.2e} (tol "
          f"{GRAPH_RTOL}); loss terms and tmp_rgb the eager bits: "
          f"{same and tmp_err == 0}", flush=True)
    if written != want or not tmp_err <= GRAPH_RTOL:
        fail(f"{label}: the graphed tmp_rgb writes disagree with the eager "
             "steps")
    if exact and not (same and tmp_err == 0):
        fail(f"{label}: the graphed steps are not the eager steps' bits")
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
    counts = {k: multi.graph_launches.get(k, 0) * replays
              for k in set(eager_counts) | set(multi.graph_launches)}
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
            want = replays * sum(v for k, v in multi.graph_launches.items()
                                 if k.split("@")[0] == name)
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
    # autograd's gathers and scatters (the sort-based `index_put` of an
    # indexing backward, sorts, scatter / gather kernels)
    index_ms = sum(dev_us(e) for e in kernels if any(
        k in e.key.lower() for k in ("index", "sort", "scatter", "gather")))
    print(f"profile ({label}): indexing, sort, scatter and gather kernels "
          f"{index_ms / 1e3 / n_steps:.3f} ms per step on {card}", flush=True)
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
    draws = make_draws(torch, cfg, n, gen, device="cpu")
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


def write_scene(np, root, N=N_FRAMES, seed=0, frames=True):
    """A seeded scene of N frames at SCENE_WH, written with the port's own
    writers: RGB frames whose rows cycle through all five PNG filters,
    16-bit disparity PNGs, grey masks, `.flo` flows (the camera's shift)
    and a COLMAP binary model whose points every frame sees. With
    `frames=False`, no images and masks (the frames phase makes its
    own)."""
    import os

    from nsff_pl_tpu_torch.scene import colmap, flowio, imageio
    from nsff_pl_tpu_torch.scene.poses import rotmat2qvec

    W, H = SCENE_WH
    rng = np.random.default_rng(seed)
    for sub in (("images", "masks") if frames else ()) + (
            "disps", "flow_fw", "flow_bw", "sparse/0"):
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
        if frames:
            img, mask = scene_frame(np, H, W, N, i)
            imageio.write_png(f"{root}/images/{i:05d}.png", img,
                              filters=[0, 1, 2, 3, 4])
            imageio.write_png(f"{root}/masks/{i:05d}.png", mask, filters=[2])
        imageio.write_png(f"{root}/disps/{i:05d}.png", disp,
                          filters=[4, 1, 2])
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


def run_counts(system, counts, per_step, label, val=None):
    """Check one CLI run's launches: the wrappers counted the capture's
    warm-up (`WARMUP` eager runs of the K steps on a copy of the state),
    the capture, the single steps and the validations' frames (`val`
    launches a chunk, B1 once by default); the card ran capture x replays
    plus the single steps and the validations. Returns the launches the
    card ran."""
    val = val or {"planar_eval_comp": 1}
    multi = system.train_step
    K = multi.K
    if multi.captures != 1:
        fail(f"{label}: {multi.captures} captures of the {K}-step dispatch, "
             "expected 1")
    singles = system.single_steps
    n_val = len(system.val_seconds)
    n_chunks = -(-W_IMG * H_IMG // min(max(system.cfg.chunk // 4, 1024),
                                       W_IMG * H_IMG))
    vals = {k: v * n_val * n_chunks for k, v in val.items()}
    want = {k: v * ((multi.WARMUP + 1) * K + singles)
            for k, v in per_step.items()}
    for k, v in vals.items():
        want[k] = want.get(k, 0) + v
    for k, v in counts.items():
        if v != want.get(k, 0):
            fail(f"{label}: {k} counted {v} times, expected {want.get(k, 0)}")
        if multi.graph_launches.get(k, 0) != per_step.get(k, 0) * K:
            fail(f"{label}: the {K}-step graph holds "
                 f"{multi.graph_launches.get(k, 0)} launches of {k}")
    ran = {k: multi.graph_launches.get(k, 0) * multi.replays
           + per_step.get(k, 0) * singles + vals.get(k, 0) for k in counts}
    steps = multi.replays * K + singles
    if steps != system.steps_run:
        fail(f"{label}: {steps} steps dispatched, {system.steps_run} run")
    for k, v in per_step.items():
        if ran[k] - vals.get(k, 0) != v * steps:
            fail(f"{label}: {k} ran {ran[k]} times over {steps} steps")
    print(f"{label}: {steps} steps ({multi.replays} replays of one "
          f"{K}-step graph, {singles} single steps), {n_val} validations of "
          f"{n_chunks} chunks; launches on the card "
          + json.dumps({k: v for k, v in ran.items() if v}), flush=True)
    return ran


def cli_step_ms(system):
    """Host ms per step of a CLI run: fit's wall time without its
    validations, checkpoints and the capture (an eager run has none)."""
    other = (sum(system.val_seconds) + sum(system.save_seconds)
             + getattr(system.train_step, "capture_seconds", 0.0))
    return (system.fit_seconds - other) * 1e3 / max(system.steps_run, 1)


def scene_training_phase(torch, np, card, graph_ms):
    """The train CLI from a scene on disk (`apps.train.cli`, in process):
    a run stopped by its time budget, its resume to the end of the epoch
    and a packed run (B4-B6); `graph_ms` holds the graphed step's ms of
    the training phases ("planar", "packed"), printed beside the CLI's.
    Returns the launches the card ran and the fresh system's validation
    PSNR."""
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
    ran = {k: fresh_counts[k] + sum(c.get(k, 0) for _, c in runs.values())
           for k in fresh_counts}
    return ran, base["psnr"]


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


@contextlib.contextmanager
def no_rounding():
    """The plain versions in `ops/raymarch_kernel.py` and
    `ops/mlp_kernel.py` without their bf16 roundings of activations and
    in float64 (the weights stay the bf16 values the kernel reads): their
    rounding helpers `_bf16` and `_mm` are swapped while it is open."""
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    def mm(x, w, b=None):
        y = x.double() @ w.double()
        return y if b is None else y + b.double()

    saved = [(m, m._bf16, m._mm) for m in (rk, mk)]
    for m, _, _ in saved:
        m._bf16, m._mm = (lambda x: x.double()), mm
    try:
        yield
    finally:
        for m, bf16, mm_ in saved:
            m._bf16, m._mm = bf16, mm_


def unrounded(torch, fn, args, kw, ray_dim, rays=2048):
    """`fn(*args, **kw)`, a plain version, under `no_rounding`: the model
    that the kernel and its plain version both round. It runs `rays` rays
    at a time (the tensor arguments' first dimension), joined on the
    output's `ray_dim`."""
    n = next(x for x in args if torch.is_tensor(x)).shape[0]
    with no_rounding():
        return torch.cat([fn(*(x[i:i + rays].double() if torch.is_tensor(x)
                               else x for x in args), **kw).float()
                          for i in range(0, n, rays)], ray_dim)


def unrounded_dflows(torch, args, kw, cot, out_keys):
    """The flow-plane cotangents of the unrounded model: B2's plain
    forward `planar_nerf_train_ref(*args, **kw)` under `no_rounding`,
    differentiated by autograd in float64 against the cotangent planes
    `cot` (keyed by `out_keys`)."""
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    a = [x.double() if torch.is_tensor(x) else x for x in args]
    a[4] = flows = tuple(f.double().requires_grad_() for f in a[4])
    with no_rounding(), torch.enable_grad():
        planes = rk.planar_nerf_train_ref(*a, **kw)
        loss = sum((planes[i] * cot[k].double()).sum()
                   for i, k in enumerate(out_keys))
        return [g.float() for g in torch.autograd.grad(loss, flows)]


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
            w = g.warmup_launches.get(k, 0)
            ran[k] = ran.get(k, 0) + w + v * g.replays
            counted[k] = counted.get(k, 0) + w + v
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


def against_f64(torch, np, card, data, params, cfg):
    """ROADMAP C's item, on the trained checkpoint: frames F32_FRAMES of
    both towers as the eval CLI's `--output_transient` renders them
    (visibility culling against the frame's own camera) in bfloat16 (B1)
    and in float32 (the plain evaluators), each against the same render
    in float64 (the plain evaluators on float64 rays: no bf16 rounding
    and no float32 one). Per frame: the largest per-pixel error of each
    on the frame's first row and column, where the frustum test of a
    sample against the frame's own camera is decided by the last bits
    of its projection, and inside them; the samples whose visibility
    differs from float64's, by B1's planes (`_visibility_planes`, float32)
    and by the float32 points of the packed path, on the border and
    inside. Holds the inside of the bfloat16 frame to float32 within
    F32_TOL."""
    from nsff_pl_tpu_torch.config import render_config
    from nsff_pl_tpu_torch.models.raymarch import _visibility_planes
    from nsff_pl_tpu_torch.models.rendering import render_rays
    from nsff_pl_tpu_torch.ops import rays as ray_ops
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs
    from nsff_pl_tpu_torch.training.step import (make_render_fn,
                                                 render_full_image)

    keys = ("rgb_fine", "depth_fine")
    b16, f32 = (make_render_fn(render_config(cfg.replace(dtype=dt)),
                               output_transient=True, with_visibility=True,
                               keys=keys) for dt in ("bfloat16", "float32"))
    rc32 = render_config(cfg.replace(dtype="float32"))
    models = {"fine": params["nerf_fine"]}
    emb64 = {"t": params["embedding_t"].double()}
    K = torch.as_tensor(data.K, dtype=torch.float32, device="cuda")
    S = cfg.N_samples
    yy, xx = torch.meshgrid(torch.arange(H_IMG, device="cuda"),
                            torch.arange(W_IMG, device="cuda"),
                            indexing="ij")
    border = ((yy == 0) | (xx == 0)).reshape(-1)
    rows = []
    for i in F32_FRAMES:
        item = data.test_item(i, targets=())
        rays, ts = item["rays"], item["ts"]
        pose = torch.as_tensor(data.poses[i:i + 1], dtype=torch.float32,
                               device="cuda")
        vis = {"vis_poses": pose, "vis_K": K}
        out = {name: render_full_image(fn, params, rays, ts, chunk=CHUNK,
                                       **vis)["rgb_fine"]
               for name, fn in (("bfloat16", b16), ("float32", f32))}
        with torch.inference_mode():
            out["float64"] = torch.cat([render_rays(
                models, emb64, rays[j:j + 4096].double(), ts[j:j + 4096],
                rc32, output_transient=True, vis_poses=pose.double(),
                vis_K=K.double(), keys=("rgb_fine",))["rgb_fine"]
                for j in range(0, rays.shape[0], 4096)])
        if not bool(torch.isfinite(out["float64"]).all()):
            fail(f"against float64: frame {i}'s float64 render not finite")
        px = {name: (out[name].double() - out["float64"]).abs().amax(-1)
              for name in ("bfloat16", "float32")}
        inside = (out["bfloat16"] - out["float32"]).abs().amax(-1)[~border]
        o, d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
        zs = stratified_zs(rays.shape[0], S, 0.0, device="cuda")[0]
        seen = {"B1 planes": _visibility_planes(o, d, zs.contiguous(), K,
                                                (W_IMG, H_IMG), pose) > 0}
        for name, dt in (("float32", torch.float32),
                         ("float64", torch.float64)):
            xyz = (o.to(dt)[:, None] + d.to(dt)[:, None]
                   * zs.to(dt)[..., None]).reshape(-1, 3)
            seen[name] = ray_ops.compute_world_visibility(
                ray_ops.ndc2world(xyz, K.to(dt)), K.to(dt), H_IMG, W_IMG,
                pose.to(dt)).reshape(-1, S) > 0
        flips = {name: {"border": int((seen[name] != seen["float64"])
                                      [border].sum()),
                        "inside": int((seen[name] != seen["float64"])
                                      [~border].sum())}
                 for name in ("B1 planes", "float32")}
        row = {"frame": i}
        for name in ("bfloat16", "float32"):
            row[name] = {"border_max": float(px[name][border].max()),
                         "inside_max": float(px[name][~border].max()),
                         "mean": float(px[name].mean())}
        row.update(bf16_vs_f32_inside=float(inside.max()),
                   bf16_vs_f32_border=float(
                       (out["bfloat16"] - out["float32"]).abs().amax(-1)
                       [border].max()),
                   visibility_flips_vs_f64=flips,
                   visible_samples={k: int(v.sum()) for k, v in seen.items()})
        rows.append(row)
        print("against float64: " + json.dumps(row) + f" on {card}",
              flush=True)
        if not float(inside.max()) <= F32_TOL:
            fail(f"against float64: frame {i} of both towers, inside the "
                 "border, in bfloat16 disagrees with float32")
    return rows


def eval_base():
    """The eval CLI's flags on the scene and the scene training phase's
    checkpoint (trained weights), in bfloat16."""
    import os

    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    ckpt = os.path.abspath(ckpt_lib.latest_checkpoint(
        f"{SCENE_RUN_DIR}/ckpts/planar"))
    return ["--root_dir", os.path.abspath(SCENE_DIR), "--img_wh", str(W_IMG),
            str(H_IMG), "--start_end", "0", str(N_FRAMES), "--encode_t",
            "--use_viewdir", "--N_samples", "128", "--dtype", "bfloat16",
            "--ckpt_path", ckpt]


def eval_phase(torch, np, card):
    """The eval CLI (`apps.evaluate`, in process) on the scene and the
    trained checkpoint of the scene training phase: the test split (30
    frames, bfloat16, depth maps) with its frames held against the host
    loop, the untrained render, a flatness floor and float32 on the plain
    evaluators; the spiral (180 frames) with --fix_view_dir, its frame 5
    against the same pose without it; test_fixview0_interp4 (the planes
    route, the splat in both its forms); the test split with
    --planar_eval off (B5). Each kernel of these paths is held against
    its plain version on the inputs the path gives it on one chunk of
    frame 0, with the trained weights. Returns the launches the card ran in the CLI runs, each
    kernel's largest error there and the spiral's seconds a frame
    render."""
    import os

    from nsff_pl_tpu_torch.config import (NSFFConfig, build_params,
                                          render_config)
    from nsff_pl_tpu_torch.models.rendering import _interp_pre, interpolate
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.ops import softsplat as ss
    from nsff_pl_tpu_torch.scene import imageio
    from nsff_pl_tpu_torch.training.step import (equal_chunks,
                                                 make_render_fn,
                                                 render_full_image)

    base = eval_base()
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
        del fresh, b16, f32
        against_f64(torch, np, card, data, params, cfg)
        del rep
        torch.cuda.empty_cache()

        # ---- the spiral with a fixed view direction (the data-parallel
        # phase renders it again over a mesh), and its frame 5 without ----
        rep, ran, _ = eval_split(
            torch, np, card, "test_spiral --fix_view_dir",
            base + ["--split", "test_spiral", "--fix_view_dir",
                    "--scene_name", "spiral_fixed"],
            {"planar_eval_comp": 1}, 6 * N_FRAMES)
        add(ran)
        spiral_s = float(np.mean(rep.render_seconds))
        item = rep.dataset.test_item(5, targets=())
        rgb = render_full_image(rep.render, rep.params, item["rays"],
                                item["ts"], chunk=CHUNK,
                                scan_chunks=True)["rgb_fine"]
        add(graph_ran(rep.render)[0])
        add({k: -v for k, v in ran.items()})
        a = (255 * np.clip(rgb.float().cpu().numpy(), 0, 1)).astype(
            np.uint8).reshape(H_IMG, W_IMG, 3)
        b = imageio.read_png("results/monocular/spiral_fixed/005.png")
        print(f"eval test_spiral --fix_view_dir: frame 5 against the same "
              f"pose without it: {(a != b).mean():.4f} of the pixel "
              "channels differ", flush=True)
        del rep

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
        kernel_errs["fused_nerf_eval"] = b5_on_eval_path(
            torch, rep, "test --planar_eval off", False)
        item = rep.dataset.test_item(0, targets=())
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
    return total, kernel_errs, spiral_s


# ---------------- coarse-to-fine (main paths) ----------------

# the JAX package's coarse-to-fine recipe: --N_samples 128 --N_importance
# 64; the fine pass runs 128 + 2 x 64 = 256 samples in training and in a
# render of both towers, 128 + 64 = 192 for the static tower alone
C2F_NI = 64
C2F_FINE = 256
# launches per coarse-to-fine training step: the coarse evaluation (S =
# 128: a forward, both backward branches) and the fine pass (S = 256: the
# main evaluation and two warps, the compositor); a kernel's name alone
# counts its launches at 128 samples, name@256 those at 256
PER_STEP_C2F = {"planar_nerf_train_fwd": 1, "planar_nerf_train_fwd@256": 3,
                "planar_nerf_train_bwd_static": 1,
                "planar_nerf_train_bwd_static@256": 1,
                "planar_nerf_train_bwd_transient": 1,
                "planar_nerf_train_bwd_transient@256": 3,
                "planar_compositor_fwd@256": 1,
                "planar_compositor_bwd@256": 1}
# the packed path's coarse-to-fine (`fused_train="off"`,
# `fused_compositing`): the coarse pass on the bf16 plain evaluators (no
# kernel), the fine pass at 256: three evaluator forwards, the backward's
# static branch once and transient branch three times, the compositor;
# the static-only model: the fine pass at 192, one forward, one backward
PER_STEP_PACKED_C2F = {f"fused_nerf_eval@{C2F_FINE}": 3,
                       f"fused_nerf_train_bwd_static@{C2F_FINE}": 1,
                       f"fused_nerf_train_bwd_transient@{C2F_FINE}": 3,
                       f"fused_compositing_fwd@{C2F_FINE}": 1,
                       f"fused_compositing_bwd@{C2F_FINE}": 1}
PER_STEP_STATIC_C2F = {f"fused_nerf_eval@{128 + C2F_NI}": 1,
                       f"fused_nerf_train_bwd_static@{128 + C2F_NI}": 1}
# the packed kernels the packed c2f paths run at each sample count
PACKED_C2F_KERNELS = {
    C2F_FINE: ("fused_nerf_eval", "fused_nerf_train_bwd_static",
               "fused_nerf_train_bwd_transient", "fused_compositing_fwd",
               "fused_compositing_bwd"),
    128 + C2F_NI: ("fused_nerf_eval", "fused_nerf_train_bwd_static")}
# the eval CLI's mean test PSNR with `--planar_eval off` against the
# planar route's, on the c2f checkpoint: the two coarse passes (the bf16
# plain evaluators, B2's forward) part by bf16 roundings, which move
# importance draws, but the frames must score alike
PSNR_C2F_TOL = 0.2
# the reproducibility runs and the coarse-to-fine scene run train on the
# scene's first frames: an epoch of 4 x 147456 / 1000 = 589 steps
C1_FRAMES = 4
# a validation, and with it a hard-sampling refresh, every so many steps
C1_VAL_EVERY = 200
# the interrupted run stops mid-epoch (~7.4 ms a step, ~1 s of capture
# and ~1.5 s a validation: the epoch takes ~7 s)
C1_BUDGET_S = 3.0
# the coarse-to-fine scene run, whose checkpoint the c2f eval reads
C2F_RUN_BUDGET_S = 12.0


def c2f_eval_comp_phase(torch, np, rk, params, rays, ts_all, K, poses,
                        card):
    """B1 at the fine pass's sample counts against its plain version: 256
    (both towers: the serving chunk, 4096 rays with visibility and flow
    maps, a ragged count) and 192 (the static tower: the serving chunk, a
    ragged count); a record per sample count (launches filled in by the
    main paths). The depths are spaced as the fine pass spaces them: the
    128 coarse depths and S - 128 random ones, sorted, so that no two
    deltas are alike, across a tile border least of all."""
    from nsff_pl_tpu_torch.models.raymarch import _visibility_planes
    from nsff_pl_tpu_torch.ops.posenc import posenc

    records = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for S, encode_t in ((C2F_FINE, True), (128 + C2F_NI, False)):
        name = at_samples("planar_eval_comp", S)
        cases = [("serving", CHUNK, (), False)]
        if encode_t:
            cases.append(("vis + flow maps", 4096, ("fw", "bw"), True))
        cases.append(("ragged", RAGGED, (), False))
        for label, n, flow, vis_in in cases:
            r = rays[:n]
            o, d = r[:, :3].contiguous(), r[:, 3:].contiguous()
            zs = torch.sort(torch.cat([
                torch.linspace(0, 1, 128, device="cuda").expand(n, 128),
                torch.rand((n, S - 128), generator=gen, device="cuda")], 1),
                1).values.contiguous()
            vis = (_visibility_planes(o, d, zs, K, (W_IMG, H_IMG), poses[:1])
                   if vis_in else None)
            de = posenc(d, 3.0, 4).contiguous()
            te = (params["embedding_t"][ts_all[:n].cuda()].contiguous()
                  if encode_t else None)
            fn = rk.make_planar_nerf_eval_comp(
                S, use_viewdir=True, encode_t=encode_t, output_flow=flow,
                vis_in=vis_in)
            pw = fn.pack(params["nerf_fine"])
            args = (pw, o, d, zs, vis, de, None, te)

            def plain(args=args, kw=fn.kernel_kw):
                return plain_by_rays(torch, rk.planar_eval_comp_ref, args,
                                     kw)

            got = rk.planar_eval_comp_cuda(*args, **fn.kernel_kw)
            torch.cuda.synchronize()
            want = plain()
            if not bool(torch.isfinite(got).all()):
                fail(f"{name} output not finite ({label})")
            err = float((got - want).abs().max())
            print(f"kernel {name} [{label}] n={n}: max abs err {err:.2e} "
                  f"(tol {TOL})", flush=True)
            if err > TOL:
                fail(f"{name} disagrees with its plain version ({label})")
            if name in records:
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
                continue
            ms = cuda_ms(torch, lambda: rk.planar_eval_comp_cuda(
                *args, **fn.kernel_kw), iters=3)
            plain_ms = cuda_ms(torch, plain, iters=1, warmup=0)
            flops, nbytes = eval_comp_work(params["nerf_fine"], fn.kernel_kw,
                                           n, S, pw)
            records[name] = _record(
                name, "nsff_pl_tpu_torch/csrc/planar_eval_comp.cu",
                "nsff_pl_tpu/ops/raymarch_kernel.py:728", err, ms, plain_ms,
                flops, nbytes)
            print(f"kernel {name} n={n}: {ms:.3f} ms "
                  f"({rate_line(flops, ms, records[name]['bound_ms'])}), "
                  f"plain {plain_ms:.3f} ms, bound "
                  f"{records[name]['bound_ms']:.3f} ms ({flops / 1e12:.2f} "
                  f"TFLOP) on {card}", flush=True)
            del want, got
        torch.cuda.empty_cache()
    return records


def c2f_serving_phase(torch, np, cfg, K, poses, card):
    """One request's frame at the coarse-to-fine recipe through a
    `RenderService` (both towers: per chunk the coarse evaluation, B2's
    forward at S = 128, then B1 at 256), after a first request that
    builds nothing new. Returns the launches of both requests."""
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import build_params

    ccfg = cfg.replace(N_importance=C2F_NI)
    params = build_params(ccfg, torch.Generator().manual_seed(0),
                          device="cuda")
    svc = RenderService(params, K, poses, (W_IMG, H_IMG), ccfg, chunk=CHUNK,
                        device="cuda")
    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    torch.cuda.synchronize()
    reset_counts()
    svc.render_pose(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = svc.render_pose(3)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    print(f"c2f serving: one {W_IMG}x{H_IMG} frame (N_importance "
          f"{C2F_NI}, both towers) in {secs:.6f} s; launches over two "
          "requests " + json.dumps({k: v for k, v in counts.items() if v})
          + f" on {card}", flush=True)
    check_counts(counts, {"planar_nerf_train_fwd": 1,
                          f"planar_eval_comp@{C2F_FINE}": 1},
                 2 * n_chunks, "c2f serving")
    if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG) \
            or not np.isfinite(depth).all():
        fail("c2f serving: bad frame")
    maps = svc.render_maps(3)
    rgbf = maps["rgb_fine"]
    if not bool(torch.isfinite(rgbf).all()) or float(rgbf.min()) < 0 \
            or float(rgbf.max()) > 1:
        fail("c2f serving: rgb_fine not finite or outside [0, 1]")
    return counts


def packed_c2f_phase(torch, np, tcfg, cfg, table, Ks, Ps, K, poses, card):
    """The packed path's coarse-to-fine (main paths, `--N_importance 64`
    with `fused_train="off"` / `planar_eval="off"`, the coarse pass on the
    bf16 plain evaluators): the training recipe with the fused compositor
    (the fine pass on B4, B5 and B6 at 256), TRAIN_STEPS eager steps and
    the same steps as one graphed dispatch with hard sampling, equal bit
    for bit, a repeated batch, one step at batch 64 against the CPU;
    STATIC_STEPS steps of the static-only model (B4 and B5 at 192) and in
    float32 (the plain evaluators, no kernel); a 512x288 `render_pose`
    frame of both towers (B5 at 256), of the static-only model (B5 at
    192) and in float32. Returns the launches of its runs and the ms per
    step (eager, graphed)."""
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import build_params

    ran = {}

    def add(counts):
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v

    pcfg = tcfg.replace(N_importance=C2F_NI, fused_train="off",
                        fused_compositing=True)
    counts, graph_counts, ms, graph_ms = training_phase(
        torch, np, pcfg, table, Ks, Ps, card, label="packed c2f training",
        per_step=PER_STEP_PACKED_C2F, planar=False, exact=True)
    add(counts)
    add(graph_counts)
    train_agreement(torch, pcfg, table, Ks, Ps, "packed c2f training")
    for label, scfg, per_step in (
            ("static-only c2f training", pcfg.replace(encode_t=False),
             PER_STEP_STATIC_C2F),
            ("float32 c2f training", pcfg.replace(dtype="float32"), {})):
        counts, graph_counts, _, _ = training_phase(
            torch, np, scfg, table, Ks, Ps, card, label=label,
            per_step=per_step, planar=False, steps=STATIC_STEPS,
            repeat=False)
        add(counts)
        add(graph_counts)

    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    ccfg = cfg.replace(N_importance=C2F_NI, planar_eval="off")
    frames = {}
    for label, scfg, expected in (
            ("both towers", ccfg, {f"fused_nerf_eval@{C2F_FINE}": 1}),
            ("static-only", ccfg.replace(encode_t=False),
             {f"fused_nerf_eval@{128 + C2F_NI}": 1}),
            ("float32", ccfg.replace(dtype="float32"), {})):
        params = build_params(scfg, torch.Generator().manual_seed(0),
                              device="cuda")
        svc = RenderService(params, K, poses, (W_IMG, H_IMG), scfg,
                            chunk=CHUNK, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rgb, depth = svc.render_pose(3)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        add(counts)
        print(f"packed c2f serving [{label}]: one {W_IMG}x{H_IMG} frame "
              f"(N_importance {C2F_NI}) in {secs:.6f} s, launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + f" on {card}", flush=True)
        check_counts(counts, expected, n_chunks, f"packed c2f serving "
                     f"[{label}]")
        if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG) \
                or not np.isfinite(depth).all():
            fail(f"packed c2f serving [{label}]: bad frame")
        maps = svc.render_maps(3)
        rgbf = maps["rgb_fine"]
        if not bool(torch.isfinite(rgbf).all()) or float(rgbf.min()) < 0 \
                or float(rgbf.max()) > 1:
            fail(f"packed c2f serving [{label}]: rgb_fine not finite or "
                 "outside [0, 1]")
        frames[label] = maps
        del svc, params
    err = max(float((frames["float32"][k] - frames["both towers"][k])
                    .abs().max()) for k in ("rgb_fine", "depth_fine"))
    print(f"packed c2f serving: the float32 frame against the bfloat16 "
          f"frame of the same seeded weights: rgb / depth max abs err "
          f"{err:.3e} (tol {F32_TOL})", flush=True)
    if not err <= F32_TOL:
        fail("packed c2f serving: float32 disagrees with bfloat16")
    torch.cuda.empty_cache()
    return ran, ms, graph_ms


def b5_on_eval_path(torch, rep, label, vis):
    """B5 on the inputs an eval path gives it (the first chunk of frame 0,
    trained weights; `vis`: with the frame's visibility culling) against
    its plain version, held as B2's forward: at most PACKED_SHARE of the
    rows off by more than 1e-5, per column its distance to the unrounded
    model at most EXACT_MEAN times the plain version's on average and
    EXACT_MAX times at its largest, the same bits with the rays reversed.
    Returns its largest abs error."""
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.training.step import equal_chunks

    data, params = rep.dataset, rep.params
    item = data.test_item(0, targets=())
    rows = slice(0, equal_chunks(W_IMG * H_IMG, CHUNK)[1])
    extra = ((torch.as_tensor(data.poses[0:1], dtype=torch.float32,
                              device="cuda"),
              torch.as_tensor(data.K, device="cuda")) if vis else ())
    calls = kept_calls(
        lambda: rep.render(params, item["rays"][rows], item["ts"][rows],
                           *extra), ((mk, "fused_nerf_eval_cuda"),))
    ((a, kw, got),) = calls["fused_nerf_eval_cuda"]
    S = a[1].shape[1]
    want = packed_plain_eval(torch, mk, a, kw, S)
    if not bool(torch.isfinite(got).all()):
        fail(f"eval {label}: B5's output not finite")
    err = (got - want).abs()
    worst = float(err.max())
    share = float((err.amax(-1) > 1e-5).float().mean())
    del err
    r_mean, r_max = unrounded_ratios(
        got, want, unrounded(torch, mk.fused_nerf_eval_ref, a, kw, 0),
        (0, 1))
    same = torch.equal(reversed_rays(torch, mk.fused_nerf_eval_cuda, a, kw,
                                     0), got)
    print(f"eval {label}: kernel fused_nerf_eval on the packed route's "
          f"inputs ({a[1].shape[0]} rays x {S} samples, trained weights): "
          f"max abs err {worst:.3e}, rows off by > 1e-5 {share:.4f} (tol "
          f"{PACKED_SHARE}); its distance to the unrounded model over the "
          f"plain version's: mean {r_mean:.3f}, largest {r_max:.3f} per "
          f"column at worst (tol {EXACT_MEAN}, {EXACT_MAX}); the same bits "
          f"with the rays reversed: {same}", flush=True)
    if share > PACKED_SHARE or r_mean > EXACT_MEAN or r_max > EXACT_MAX:
        fail(f"eval {label}: B5 disagrees with its plain version")
    if not same:
        fail(f"eval {label}: B5 depends on a ray's place")
    return worst


def _train_state(torch, system):
    """Copies of a system's params, optimizer state (counts, moments, and
    ranger's slow weights), hard-sampling buffer and weights, on the
    card."""
    from nsff_pl_tpu_torch.training.optim import param_leaves

    opt = system.state.opt_state
    return {"params": [p.detach().clone()
                       for p in param_leaves(system.state.params)],
            "optimizer state": [t.clone() for t in opt.tensors()],
            "tmp_rgb": [system.tmp_rgb.clone()],
            "weights": [system.batcher.weights.clone()]}


def _same_bits(torch, a, b):
    """{group: (tensors that differ, largest abs difference)}."""
    out = {}
    for k in a:
        diff = [float((x - y).abs().max()) for x, y in zip(a[k], b[k])
                if not torch.equal(x, y)]
        out[k] = (len(diff), max(diff, default=0.0))
    return out


def c1_phase(torch, np, card):
    """Card training reproduces itself (ROADMAP C1): the train CLI at the
    flagship recipe with hard sampling on the scene's first C1_FRAMES
    frames, a validation and hard-sampling refresh every C1_VAL_EVERY
    steps, one epoch, from the seed, and again stopped mid-epoch by its
    time budget and resumed from its checkpoint: the params, Adam's
    moments, `tmp_rgb` and the sampling weights at the end must be the
    same bits in both. The second run from the same seed is the data-
    parallel phase's (`--num_gpus 2` on one GPU, a world of one), held
    to the same bits and loss and validation rows."""
    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    extra = ["--start_end", "0", str(C1_FRAMES), "--val_every_steps",
             str(C1_VAL_EVERY), "--cache_dir", f"{SCENE_RUN_DIR}/cache_c1"]
    ends, ran = {}, {}

    def run(exp, more):
        torch.cuda.synchronize()
        reset_counts()
        system = cli(scene_argv(exp, extra + more))
        torch.cuda.synchronize()
        for k, v in run_counts(system, launch_counts(), PER_STEP,
                               f"C1 run {exp}").items():
            ran[k] = ran.get(k, 0) + v
        return system

    system = run("c1a", [])
    ends["c1a"] = _train_state(torch, system)
    print(f"C1 run c1a: {system.steps_run} steps, "
          f"{len(system.val_seconds)} validations and refreshes, "
          f"{cli_step_ms(system):.3f} ms per step through the CLI on "
          f"{card}", flush=True)
    del system
    system = run("c1c", ["--time_budget_s", str(C1_BUDGET_S)])
    stop, total = system.state.step, system.total_steps
    del system
    if not 0 < stop < total:
        fail(f"C1: the interrupted run stopped at step {stop} of {total}")
    ckpt = ckpt_lib.latest_checkpoint(f"{SCENE_RUN_DIR}/ckpts/c1c")
    system = run("c1c", ["--ckpt_path", ckpt])
    ends["c1c"] = _train_state(torch, system)
    del system
    torch.cuda.empty_cache()
    what = f"a run stopped at step {stop} and resumed"
    diff = _same_bits(torch, ends["c1a"], ends["c1c"])
    print(f"C1: {what}, against the first run after {total} steps "
          f"(tensors that differ, largest difference): "
          + json.dumps(diff), flush=True)
    if any(n for n, _ in diff.values()):
        fail(f"C1: {what} ends elsewhere than the first run")
    return ran, ends["c1a"]


# ---------------- from video frames to a trained scene ----------------

FRAMES_DIR = "chip_smoke_out/frames_scene"
FRAMES_EVAL_DIR = "chip_smoke_out/frames_eval"
# a video's frames as a phone or ffmpeg gives them, 1.5 x the scene's
# native size: the preprocess driver shrinks them to SCENE_WH, a ratio of
# 1.5 (OpenCV's float INTER_AREA path)
FRAMES_SRC_WH = (1536, 864)
# the decoded frames_resized against `resize_area_cv2` of the source
# frames: one q95 round trip of smooth content; a wrong IDCT or
# upsampler gives noise, not a 1-LSB error
FRAMES_PSNR_DB = 30.0


def _psnr8(np, a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse else float("inf")


# the other codings libjpeg-turbo reads, each rewriting a baseline
# frame's quantised coefficients (`tests/torch_jpeg_writer.py::write_dct`)
FRAME_CODINGS = {"progressive Huffman": dict(progressive=True),
                 "sequential arithmetic": dict(arithmetic=True),
                 "progressive arithmetic": dict(progressive=True,
                                                arithmetic=True)}


def jpeg_writer():
    """`tests/torch_jpeg_writer.py` (numpy and the port's `scene/jpeg.py`
    alone), loaded from this checkout by its path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_jpeg_writer.py")
    spec = importlib.util.spec_from_file_location("torch_jpeg_writer", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


def frame_codings(np, folder, names, baseline_s, card):
    """The preprocess's q95 frames `names` (baseline, as OpenCV writes
    them) with their quantised coefficients rewritten progressive
    (libjpeg's scan script, PIL's and OpenCV's), sequential arithmetic and
    progressive arithmetic: each decodes to the baseline decode's bytes
    (complete scans: no block smoothing). Prints the host seconds a frame
    of each coding's decode beside the baseline's."""
    from nsff_pl_tpu_torch.scene import jpeg

    jw = jpeg_writer()
    secs = {k: {"write": [], "decode": [], "kb": []} for k in FRAME_CODINGS}
    for name in names:
        with open(f"{folder}/{name}", "rb") as f:
            data = f.read()
        want = jpeg.decode_jpeg(data)
        frame, coefs = jw.coefficients_of(data)
        for coding, kw in FRAME_CODINGS.items():
            t0 = time.perf_counter()
            other = jw.write_dct(frame, coefs, **kw)
            secs[coding]["write"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got = jpeg.decode_jpeg(other)
            secs[coding]["decode"].append(time.perf_counter() - t0)
            secs[coding]["kb"].append(len(other) / 1e3)
            if not np.array_equal(got, want):
                fail(f"frames: {name} rewritten {coding} decodes "
                     f"{int(np.abs(got.astype(int) - want).max())} off the "
                     "baseline decode")
    h, w = want.shape[:2]
    print(f"frames codings: {len(names)} of the {w}x{h} q95 frames "
          "rewritten, each equal to the baseline decode; host seconds a "
          f"frame (host times): baseline decode {baseline_s:.4f}, "
          + json.dumps({k: {m: round(float(np.mean(v)), 4)
                            for m, v in d.items()}
                        for k, d in secs.items()})
          + f" (write: the numpy writer of tests/) on {card}", flush=True)


def frames_phase(torch, np, card):
    """From video frames to a trained scene, on numpy and the port alone:
    C1's seeded frames (`scene_frame`) at FRAMES_SRC_WH written as
    JPEG (`scene/jpeg.py::encode_jpeg`) into frames/; the preprocess CLI
    in process (`apps/preprocess.py --stages resize --max_w 1024 --max_h
    576`: the float INTER_AREA path, the frames written back as JPEG),
    its masks stage (detectron2's RuntimeError), its colmap stage (the
    JAX package's exit text) and a second resize (it skips);
    frames_resized/ in as images/ (as COLMAP's undistorter puts them),
    `trivial_masks`, and write_scene's disparities, flows and COLMAP
    model at that size. Then a fresh system's validation (the uncached
    JPEG scene load), the train CLI at C1's flags for one epoch (the
    cached load, bit-equal to the uncached table; launches PER_STEP, one
    capture, finite loss rows, the last validation's PSNR above the fresh
    one's by PSNR_GAIN_DB) and the eval CLI's test split on its
    checkpoint (B1). Prints the codec's and the resize's host seconds a
    frame, the scene loads, the CLI's ms a step and the PSNR of the
    decoded frames_resized against `resize_area_cv2` of the source
    frames (at least FRAMES_PSNR_DB). Returns the launches the card
    ran."""
    import contextlib
    import io
    import os
    import shutil

    from nsff_pl_tpu_torch.apps import preprocess
    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.config import get_opts
    from nsff_pl_tpu_torch.scene import imageio, jpeg, masks
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

    root = FRAMES_DIR
    for d in (root, FRAMES_EVAL_DIR, f"{SCENE_RUN_DIR}/cache_frames",
              f"{SCENE_RUN_DIR}/ckpts/frames", f"{SCENE_RUN_DIR}/logs/frames"):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(f"{root}/frames")
    (W0, H0), (W, H) = FRAMES_SRC_WH, SCENE_WH
    secs = {"encode": [], "decode_src": [], "resize": [], "decode": []}
    srcs = []
    for i in range(C1_FRAMES):
        # C1's frames (the first of N_FRAMES) at 1.5 x the size
        img, _ = scene_frame(np, H0, W0, N_FRAMES, i)
        t0 = time.perf_counter()
        data = jpeg.encode_jpeg(img)
        secs["encode"].append(time.perf_counter() - t0)
        with open(f"{root}/frames/{i:05d}.jpg", "wb") as f:
            f.write(data)
        srcs.append(img)
    argv = ["--root_dir", root, "--stages", "resize", "--max_w", str(W),
            "--max_h", str(H)]
    t0 = time.perf_counter()
    preprocess.cli(argv)
    preprocess_s = time.perf_counter() - t0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        preprocess.cli(argv)
    if "frames_resized exists, skipping" not in out.getvalue():
        fail(f"frames: a second resize did not skip: {out.getvalue()!r}")
    try:
        preprocess.cli(["--root_dir", root, "--stages", "masks"])
        fail("frames: the masks stage ran without detectron2")
    except RuntimeError as e:
        if "detectron2" not in str(e):
            raise
    try:
        preprocess.cli(["--root_dir", root, "--stages", "colmap",
                        "--colmap_bin", "chip-smoke-no-colmap"])
        fail("frames: the colmap stage ran without COLMAP")
    except SystemExit as e:
        if not ("COLMAP binary" in str(e.code)
                and "not found" in str(e.code)):
            fail(f"frames: the colmap stage exited with {e.code!r}")
    names = sorted(os.listdir(f"{root}/frames_resized"))
    if names != [f"{i:05d}.jpg" for i in range(C1_FRAMES)]:
        fail(f"frames: frames_resized holds {names}")
    psnrs = []
    for i, name in enumerate(names):
        with open(f"{root}/frames/{name}", "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        src = jpeg.decode_jpeg(data)
        secs["decode_src"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        imageio.resize_area_cv2(src, (W, H))
        secs["resize"].append(time.perf_counter() - t0)
        with open(f"{root}/frames_resized/{name}", "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        got = jpeg.decode_jpeg(data)
        secs["decode"].append(time.perf_counter() - t0)
        if got.shape != (H, W, 3):
            fail(f"frames: {name} resized to {got.shape}")
        psnrs.append(_psnr8(np, got, imageio.resize_area_cv2(srcs[i],
                                                             (W, H))))
    print(f"frames: {C1_FRAMES} frames, host seconds a frame: JPEG encode "
          f"at {W0}x{H0} {np.mean(secs['encode']):.4f}, decode at {W0}x{H0} "
          f"{np.mean(secs['decode_src']):.4f}, INTER_AREA to {W}x{H} "
          f"{np.mean(secs['resize']):.4f}, decode at {W}x{H} "
          f"{np.mean(secs['decode']):.4f}; the preprocess resize stage "
          f"{preprocess_s:.3f} s in all; decoded frames_resized against "
          f"resize_area_cv2 of the source PSNR "
          + json.dumps([round(p, 3) for p in psnrs])
          + f" dB (at least {FRAMES_PSNR_DB}) on {card}", flush=True)
    if min(psnrs) < FRAMES_PSNR_DB:
        fail(f"frames: the JPEG round trip scores {min(psnrs):.3f} dB")
    frame_codings(np, f"{root}/frames_resized", names[:2],
                  np.mean(secs["decode"]), card)

    # the undistorter's images/, all-static masks, the priors and model
    shutil.copytree(f"{root}/frames_resized", f"{root}/images")
    if masks.trivial_masks(root) != C1_FRAMES:
        fail("frames: trivial_masks wrote no mask a frame")
    write_scene(np, root, N=C1_FRAMES, frames=False)

    extra = ["--root_dir", root, "--start_end", "0", str(C1_FRAMES),
             "--val_every_steps", str(C1_VAL_EVERY), "--cache_dir",
             f"{SCENE_RUN_DIR}/cache_frames"]
    reset_counts()
    fresh = NSFFSystem(get_opts(scene_argv("frames", extra)))
    uncached_s = fresh.load_seconds
    table = fresh.train_scene.rays.clone()
    base = fresh.validate(0)
    ran = launch_counts()
    del fresh
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    system = cli(scene_argv("frames", extra))
    torch.cuda.synchronize()
    for k, v in run_counts(system, launch_counts(), PER_STEP,
                           "frames run").items():
        ran[k] = ran.get(k, 0) + v
    if not torch.equal(system.train_scene.rays, table):
        fail("frames: the cached ray table differs from the uncached one")
    del table
    rows = jsonl_rows("frames")
    if sorted(rows) != list(range(system.total_steps)) or not all(
            np.isfinite(v) for r in rows.values() for v in r.values()):
        fail("frames run: the loss rows are not every step's, finite")
    last_step, last = system.val_history[-1]
    gain = last["psnr"] - base["psnr"]
    c1 = {s: round(r["val/psnr"], 3) for s, r in val_rows("c1a").items()}
    print(f"frames run: {system.steps_run} steps, scene load "
          f"{uncached_s:.3f} s uncached (JPEG decode, LANCZOS, ray table "
          f"on the card), {system.load_seconds:.3f} s cached; "
          f"{cli_step_ms(system):.3f} ms per step through the CLI; "
          f"validation PSNR {base['psnr']:.3f} dB fresh, "
          + json.dumps({s: round(v["psnr"], 3) for s, v in
                        system.val_history})
          + f" dB by step (C1's first run on the PNG frames: "
          + json.dumps(c1) + f"): +{gain:.3f} dB (must exceed "
          f"{PSNR_GAIN_DB}) on {card}", flush=True)
    if not gain > PSNR_GAIN_DB:
        fail(f"frames run: validation PSNR gained {gain:.3f} dB")
    ckpt = os.path.abspath(ckpt_lib.latest_checkpoint(
        f"{SCENE_RUN_DIR}/ckpts/frames"))
    del system
    torch.cuda.empty_cache()

    argv = ["--root_dir", os.path.abspath(root), "--img_wh", str(W_IMG),
            str(H_IMG), "--start_end", "0", str(C1_FRAMES), "--encode_t",
            "--use_viewdir", "--N_samples", "128", "--dtype", "bfloat16",
            "--ckpt_path", ckpt, "--split", "test", "--scene_name", "frames"]
    os.makedirs(FRAMES_EVAL_DIR, exist_ok=True)
    here = os.getcwd()
    os.chdir(FRAMES_EVAL_DIR)
    try:
        rep, eval_ran, _ = eval_split(torch, np, card, "frames test", argv,
                                      {"planar_eval_comp": 1}, C1_FRAMES)
    finally:
        os.chdir(here)
    if not np.isfinite(rep.psnr).all() or not (rep.psnr[:, 0] > 0).all():
        fail(f"frames: the eval CLI's test PSNR {rep.psnr.tolist()}")
    print(f"frames test: PSNR {rep.psnr[:, 0].tolist()} on the "
          f"JPEG scene's {C1_FRAMES} frames", flush=True)
    for k, v in eval_ran.items():
        ran[k] = ran.get(k, 0) + v
    return ran


def graphed_equals_loop(torch, np, render, params, data, frames, vis):
    """Each frame rendered as one graph replay and by the host loop at
    the graph's equal chunk size: the largest difference over rgb and
    depth. (The packed route's coarse pass runs cuBLAS GEMMs, whose bits
    depend on their row count: the host loop's default 32768-ray chunks
    give other bits than the graph's 29696-ray ones.)"""
    from nsff_pl_tpu_torch.training.step import (equal_chunks,
                                                 render_full_image)

    chunk = equal_chunks(W_IMG * H_IMG, CHUNK)[1]

    errs = []
    for i in frames:
        item = data.test_item(i, targets=())
        kw = ({"vis_poses": torch.as_tensor(data.poses[i:i + 1],
                                            dtype=torch.float32,
                                            device="cuda"),
               "vis_K": torch.as_tensor(data.K, device="cuda")}
              if vis else {})
        outs = [render_full_image(render, params, item["rays"], item["ts"],
                                  chunk=CHUNK if scan else chunk,
                                  scan_chunks=scan, **kw)
                for scan in (True, False)]
        for k in ("rgb_fine", "depth_fine"):
            if not bool(torch.isfinite(outs[0][k]).all()):
                fail(f"a coarse-to-fine frame's {k} is not finite")
            errs.append(float((outs[0][k] - outs[1][k]).abs().max()))
    return max(errs)


def b1_on_eval_path(torch, rep, label):
    """B1 on the inputs a coarse-to-fine eval path gives it (the first
    chunk of frame 0: the fine depths `sample_pdf` drew from the coarse
    weights, trained weights) against its plain version, held as the eval
    phase holds B2's forward on trained weights: per map, its distance to
    the unrounded model at most EXACT_MEAN times the plain version's on
    average and EXACT_MAX times at its largest, and the same bits with
    the rays reversed. Returns its largest abs error."""
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.training.step import equal_chunks

    data, params = rep.dataset, rep.params
    item = data.test_item(0, targets=())
    rows = slice(0, equal_chunks(W_IMG * H_IMG, CHUNK)[1])
    calls = kept_calls(
        lambda: rep.render(params, item["rays"][rows], item["ts"][rows],
                           torch.as_tensor(data.poses[0:1],
                                           dtype=torch.float32,
                                           device="cuda"),
                           torch.as_tensor(data.K, device="cuda")),
        ((rk, "planar_eval_comp_cuda"),))
    ((a, kw, got),) = calls["planar_eval_comp_cuda"]
    want = plain_by_rays(torch, rk.planar_eval_comp_ref, a, kw)
    if not bool(torch.isfinite(got).all()):
        fail(f"eval {label}: B1's output not finite")
    err = float((got - want).abs().max())
    r_mean, r_max = unrounded_ratios(
        got, want, unrounded(torch, rk.planar_eval_comp_ref, a, kw, 0), 0)
    same = torch.equal(reversed_rays(torch, rk.planar_eval_comp_cuda, a, kw,
                                     0), got)
    zs = a[3]
    print(f"eval {label}: kernel planar_eval_comp on the path's inputs "
          f"({zs.shape[0]} rays x {zs.shape[1]} samples, trained weights, "
          f"depth steps from {float(zs.diff(dim=1).min()):.3e} to "
          f"{float(zs.diff(dim=1).max()):.3e}): max abs err {err:.3e}; its "
          f"distance to the unrounded model over the plain version's: mean "
          f"{r_mean:.3f}, largest {r_max:.3f} per map at worst (tol "
          f"{EXACT_MEAN}, {EXACT_MAX}); the same bits with the rays "
          f"reversed: {same}", flush=True)
    if r_mean > EXACT_MEAN or r_max > EXACT_MAX:
        fail(f"eval {label}: B1 disagrees with its plain version")
    if not same:
        fail(f"eval {label}: B1 depends on a ray's place")
    return err


def c2f_scene_phase(torch, np, card):
    """A coarse-to-fine run of the train CLI (`--N_importance 64`, the
    scene's first C1_FRAMES frames, stopped by its time budget), then the
    eval CLI on its checkpoint: the test split on the static tower (B1
    at 192), with `--output_transient` (B1 at 256) and
    test_fixview0_interp4 (the planes route: B2's forward and B3 at 256),
    each after the coarse evaluation at 128; the two test splits again
    with `--planar_eval off` (the coarse pass on the bf16 plain
    evaluators, B5 at 192 and 256), each split's mean PSNR within
    PSNR_C2F_TOL of the planar route's; every frame of the test
    splits, and frame 0 of the interpolation, rendered as one graph
    replay equal to the host loop within GRAPH_TOL; B1 and B5 on each
    test split's inputs against their plain versions (`b1_on_eval_path`,
    `b5_on_eval_path`). Returns the launches the card ran and each
    kernel's largest error by record name."""
    import os

    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    total, errs = {}, {}

    def add(ran):
        for k, v in ran.items():
            total[k] = total.get(k, 0) + v

    frames = ["--start_end", "0", str(C1_FRAMES), "--N_importance",
              str(C2F_NI)]
    torch.cuda.synchronize()
    reset_counts()
    system = cli(scene_argv("c2f", frames + [
        "--val_every_steps", str(C1_VAL_EVERY), "--time_budget_s",
        str(C2F_RUN_BUDGET_S), "--cache_dir", f"{SCENE_RUN_DIR}/cache_c1"]))
    torch.cuda.synchronize()
    add(run_counts(system, launch_counts(), PER_STEP_C2F, "c2f scene run",
                   {f"planar_eval_comp@{C2F_FINE}": 1,
                    "planar_nerf_train_fwd": 1}))
    for step, log in system.val_history:
        print(f"c2f scene run: validation at step {step} " + json.dumps(
            {k: round(v, 4) for k, v in log.items()}), flush=True)
    del system
    torch.cuda.empty_cache()

    ckpt = os.path.abspath(ckpt_lib.latest_checkpoint(
        f"{SCENE_RUN_DIR}/ckpts/c2f"))
    base = ["--root_dir", os.path.abspath(SCENE_DIR), "--img_wh", str(W_IMG),
            str(H_IMG), "--encode_t", "--use_viewdir", "--N_samples", "128",
            "--dtype", "bfloat16", "--ckpt_path", ckpt] + frames
    os.makedirs(EVAL_DIR, exist_ok=True)
    here = os.getcwd()
    os.chdir(EVAL_DIR)
    psnr = {}
    try:
        for label, more, expected, vis in (
                ("c2f test (static tower)", ["--scene_name", "c2f_static"],
                 {f"planar_eval_comp@{128 + C2F_NI}": 1,
                  "planar_nerf_train_fwd": 1}, False),
                ("c2f test --output_transient",
                 ["--output_transient", "--scene_name", "c2f_both"],
                 {f"planar_eval_comp@{C2F_FINE}": 1,
                  "planar_nerf_train_fwd": 1}, True),
                ("c2f test --planar_eval off (static tower)",
                 ["--planar_eval", "off", "--scene_name", "c2f_static_packed"],
                 {f"fused_nerf_eval@{128 + C2F_NI}": 1}, False),
                ("c2f test --planar_eval off --output_transient",
                 ["--planar_eval", "off", "--output_transient",
                  "--scene_name", "c2f_both_packed"],
                 {f"fused_nerf_eval@{C2F_FINE}": 1}, True)):
            rep, ran, g = eval_split(
                torch, np, card, label, base + ["--split", "test"] + more,
                expected, C1_FRAMES)
            add(ran)
            err = graphed_equals_loop(torch, np, rep.render, rep.params,
                                      rep.dataset, range(C1_FRAMES), vis)
            print(f"eval {label}: mean PSNR whole / dynamic "
                  f"{np.nanmean(rep.psnr, 0).tolist()}; graphed frames "
                  f"against the host loop's max abs err {err:.3e} (tol "
                  f"{GRAPH_TOL})", flush=True)
            if err > GRAPH_TOL:
                fail(f"eval {label}: graphed frames differ from the host "
                     "loop's")
            S = C2F_FINE if vis else 128 + C2F_NI
            psnr[label] = float(np.nanmean(rep.psnr[:, 0]))
            if "--planar_eval off" in label:
                errs[at_samples("fused_nerf_eval", S)] = b5_on_eval_path(
                    torch, rep, label, vis)
                planar = label.replace(" --planar_eval off", "")
                gap = psnr[label] - psnr[planar]
                print(f"eval {label}: mean PSNR {psnr[label]:.4f} dB "
                      f"against the planar route's {psnr[planar]:.4f} dB: "
                      f"{gap:+.4f} dB (tol {PSNR_C2F_TOL})", flush=True)
                if not abs(gap) <= PSNR_C2F_TOL:
                    fail(f"eval {label}: the packed route's PSNR parts from "
                         "the planar route's")
            else:
                errs[at_samples("planar_eval_comp", S)] = b1_on_eval_path(
                    torch, rep, label)
            del rep
        rep, ran, g = eval_split(
            torch, np, card, "c2f test_fixview0_interp4",
            base + ["--split", "test_fixview0_interp4", "--scene_name",
                    "c2f_interp"],
            {"planar_nerf_train_fwd": 1,
             f"planar_nerf_train_fwd@{C2F_FINE}": 1,
             f"planar_compositor_fwd@{C2F_FINE}": 1}, C1_FRAMES)
        add(ran)
        err = graphed_equals_loop(torch, np, rep.render, rep.params,
                                  rep.dataset, (0,), True)
        print(f"eval c2f test_fixview0_interp4: frame 0 graphed against the "
              f"host loop max abs err {err:.3e} (tol {GRAPH_TOL})",
              flush=True)
        if err > GRAPH_TOL:
            fail("eval c2f interp: the graphed frame differs from the host "
                 "loop's")
        del rep
    finally:
        os.chdir(here)
    torch.cuda.empty_cache()
    return total, errs


# ---------------- the train-path variants (ROADMAP A8) ----------------

# kernel launches per step of the warp variants at the flagship recipe:
# warp_subsample 2 and warp_importance run the main evaluation and one
# stacked warp call carrying both flow heads (backward: the static branch
# once, the transient branch twice); warp_importance composites a second
# time, on the K gathered rays; the plain composite runs no compositor
PER_STEP_WS2 = {"planar_nerf_train_fwd": 2, "planar_nerf_train_bwd_static": 1,
                "planar_nerf_train_bwd_transient": 2,
                "planar_compositor_fwd": 1, "planar_compositor_bwd": 1}
PER_STEP_WI = {**PER_STEP_WS2, "planar_compositor_fwd": 2,
               "planar_compositor_bwd": 2}
PER_STEP_OFF = {"planar_nerf_train_fwd": 3, "planar_nerf_train_bwd_static": 1,
                "planar_nerf_train_bwd_transient": 3}
# warp_subsample 2 under coarse-to-fine: the coarse pass at 128, the
# main and the stacked call at 256
PER_STEP_WS2_C2F = {**PER_STEP_C2F, f"planar_nerf_train_fwd@{C2F_FINE}": 2,
                    f"planar_nerf_train_bwd_transient@{C2F_FINE}": 2}
# (label, CLI fields, render config fields the CLI has no flag for,
# launches a step)
WARP_VARIANTS = (("ws2", dict(warp_subsample=2), None, PER_STEP_WS2),
                 ("wi", dict(warp_importance=0.5), None, PER_STEP_WI),
                 ("off", {}, dict(planar_compositing="off"), PER_STEP_OFF))
# the rays warp_importance 0.5 keeps of a batch
K_GATHER = BATCH // 2
# the wi + ranger CLI run stops mid-epoch on the scene's first C1_FRAMES
# frames; the wi + Adam run trains on all frames for WI_RUN_BUDGET_S
# (the exact run's validations read +16 dB by step 4000, ~7 ms a step)
WI_RANGER_BUDGET_S = 3.0
WI_RUN_BUDGET_S = 40.0


def stacked_warp_kernels(torch, np, rk, tck, params, rays, card, S):
    """B2's stacked warp call (`static_branch=False, flow_in=True`, both
    flow heads) against its plain version at batch 512 and S samples:
    forward planes (PLANE_TOL / PLANE_SHARE) and the transient backward
    with cotangents on both heads and on the flow planes (the summed
    leaves GRAD_MAX / GRAD_FRO, the flow-plane cotangents by the
    unrounded-model rule EXACT_MEAN / EXACT_MAX); at S = 128 also B3 at
    the K_GATHER rows warp_importance composites a second time. Returns
    their records (launches filled in by the main paths), each with a
    bound from the shapes."""
    from nsff_pl_tpu_torch.ops.posenc import posenc
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs

    n = BATCH
    gen = torch.Generator(device="cuda").manual_seed(3)
    o, d = rays[:n, :3].contiguous(), rays[:n, 3:].contiguous()
    zs = stratified_zs(n, 128, 1.0, torch.rand((n, 128), generator=gen,
                                               device="cuda"),
                       device="cuda")[0]
    if S != 128:  # spaced as the fine pass spaces them
        zs = torch.sort(torch.cat([zs, torch.rand((n, S - 128), generator=gen,
                                                  device="cuda")], 1),
                        1).values
    zs = zs.contiguous()
    t_emb = params["embedding_t"][torch.randint(
        0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
    fine = params["nerf_fine"]
    op = rk.make_planar_nerf_train(S, static_branch=False, flow_in=True,
                                   output_flow=("fw", "bw"))
    pw = op.pack(fine)
    flows = tuple((0.05 * torch.randn((n, S), generator=gen,
                                      device="cuda")).contiguous()
                  for _ in range(3))
    args = (pw, o, d, zs, flows, None, None, t_emb)
    kw = op.kernel_kw
    got = rk.planar_nerf_train_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = rk.planar_nerf_train_ref(*args, **kw)
    if not bool(torch.isfinite(got).all()):
        fail("stacked warp forward output not finite")
    err = (got - want).abs()
    worst = err.amax((1, 2)).cpu().numpy()
    share = float((err > 1e-5).float().mean())
    heads = {k: float(got[i].abs().max()) for i, k in enumerate(op.out_keys)
             if k.startswith("f")}
    src = "nsff_pl_tpu_torch/csrc/planar_nerf_train.cu"
    print(f"kernel planar_nerf_train_fwd [stacked warp, both heads] n={n} "
          f"S={S}: planes {list(op.out_keys)}, max abs err per plane "
          f"{np.array2string(worst, precision=2)}, share > 1e-5 "
          f"{share:.3f} (tol {PLANE_TOL}, {PLANE_SHARE}); largest flow "
          "entry per head " + json.dumps({k: round(v, 4)
                                           for k, v in heads.items()}),
          flush=True)
    if float(worst.max()) > PLANE_TOL or share > PLANE_SHARE \
            or min(heads.values()) == 0.0:
        fail(f"the stacked warp forward disagrees at S = {S}")
    ms = cuda_ms(torch, lambda: rk.planar_nerf_train_fwd_cuda(*args, **kw),
                 iters=10, graph=True)
    plain_ms = cuda_ms(torch, lambda: rk.planar_nerf_train_ref(*args, **kw),
                       iters=3)
    flops, nbytes = train_fwd_work(fine, False, 2, n, S, pw,
                                   len(op.out_keys), True)
    records = {"planar_nerf_train_fwd_both": _record(
        at_samples("planar_nerf_train_fwd_both", S), src,
        "nsff_pl_tpu/ops/raymarch_kernel.py:64", float(worst.max()), ms,
        plain_ms, flops, nbytes)}
    print(f"kernel {records['planar_nerf_train_fwd_both']['name']} n={n}: "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{records['planar_nerf_train_fwd_both']['bound_ms']:.3f} ms "
          f"({flops / 1e12:.3f} TFLOP) on {card}", flush=True)

    cot = {k: torch.randn((n, S), generator=gen, device="cuda")
           for k in op.out_keys}
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale", "D", "skips")}
    got_b = rk.planar_nerf_train_bwd_cuda("transient", *args, cot, **bkw)
    torch.cuda.synchronize()
    want_b = rk.planar_nerf_train_bwd_ref("transient", *args, cot, **bkw)
    errs = {f"{k}.{p}": rel_errs(got_b["dws"][k][p], want_b["dws"][k][p])
            for k in want_b["dws"] for p in ("w", "b")}
    errs["dt"] = rel_errs(got_b["dt"], want_b["dt"])
    outs = [t for g in got_b["dws"].values() for t in g.values()]
    if not all(bool(torch.isfinite(t).all())
               for t in outs + [got_b["dt"], *got_b["dflows"]]):
        fail(f"stacked warp backward not finite at S = {S}")
    # both heads' weight gradients must be there (each head's cotangent
    # reaches its own rows of the packed head weight)
    dh = got_b["dws"]["transient_heads"]["w"]
    exact = unrounded_dflows(torch, args, kw, cot, op.out_keys)
    r_mean = r_max = 0.0
    for c in range(3):
        errs[f"dflow{c}"] = rel_errs(got_b["dflows"][c], want_b["dflows"][c])
        rm, rx = unrounded_ratios(got_b["dflows"][c], want_b["dflows"][c],
                                  exact[c], (0, 1))
        r_mean, r_max = max(r_mean, rm), max(r_max, rx)
    summed = [k for k in errs if not k.startswith("dflow") or S == 128]
    w_max = max(summed, key=lambda k: errs[k][0])
    w_fro = max(errs, key=lambda k: errs[k][1])
    abs_err = max(e[2] for e in errs.values())
    print(f"kernel planar_nerf_train_bwd_transient [stacked warp, both "
          f"heads] S={S}: {len(errs)} outputs, worst error/max "
          f"{errs[w_max][0]:.2e} ({w_max}), worst Frobenius "
          f"{errs[w_fro][1]:.2e} ({w_fro}) (tol {GRAD_MAX}, {GRAD_FRO}); "
          f"dflow distance to the unrounded model over the plain "
          f"version's: mean {r_mean:.3f}, largest {r_max:.3f} (tol "
          f"{EXACT_MEAN}, {EXACT_MAX}); head weight gradient norm "
          f"{float(dh.norm()):.3e}", flush=True)
    if errs[w_max][0] > GRAD_MAX or errs[w_fro][1] > GRAD_FRO \
            or r_mean > EXACT_MEAN or r_max > EXACT_MAX \
            or not float(dh.norm()) > 0:
        fail(f"the stacked warp backward disagrees at S = {S}")
    ms = cuda_ms(torch, lambda: rk.planar_nerf_train_bwd_cuda(
        "transient", *args, cot, **bkw), iters=5, graph=True)
    plain_ms = cuda_ms(torch, lambda: rk.planar_nerf_train_bwd_ref(
        "transient", *args, cot, **bkw), iters=2)
    flops, nbytes = train_bwd_work(fine, "transient", 2, n, S, pw, True)
    rec = _record(at_samples("planar_nerf_train_bwd_transient_both", S), src,
                  "nsff_pl_tpu/ops/raymarch_kernel.py:64", abs_err, ms,
                  plain_ms, flops, nbytes)
    rec["max_rel_err"] = errs[w_max][0]
    records["planar_nerf_train_bwd_transient_both"] = rec
    print(f"kernel {rec['name']} n={n}: {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {rec['bound_ms']:.3f} ms ({flops / 1e12:.3f} TFLOP) "
          f"on {card}", flush=True)
    if S != 128:
        return records

    # B3 on the K gathered rows of warp_importance: the main planes of
    # the first K rays, the stacked call's fw rows and bw rows
    k = K_GATHER
    main_op = rk.make_planar_nerf_train(S, use_viewdir=True,
                                        output_flow=("fw", "bw"))
    de = posenc(d, 3.0, 4).contiguous()
    main = dict(zip(main_op.out_keys, rk.planar_nerf_train_fwd_cuda(
        main_op.pack(fine), o[:k].contiguous(), d[:k].contiguous(),
        zs[:k].contiguous(), None, de[:k].contiguous(), None,
        t_emb[:k].contiguous(), **main_op.kernel_kw)))
    wplanes = dict(zip(op.out_keys, got))
    ins = {"zs": zs[:k], "ssig": main["ssig"], "tsig": main["tsig"],
           "tsig_w1": wplanes["tsig"][:k], "tsig_w2": wplanes["tsig"][k:]}
    for key in ("ns", "nt", "nw1", "nw2"):
        ins[key] = torch.randn((k, S), generator=gen, device="cuda")
    for c in "rgb":
        ins[f"srgb_{c}"] = main[f"srgb_{c}"]
        ins[f"trgb_{c}"] = main[f"trgb_{c}"]
        ins[f"trgb_w1_{c}"] = wplanes[f"trgb_{c}"][:k]
        ins[f"trgb_w2_{c}"] = wplanes[f"trgb_{c}"][k:]
    ins = {key: v.contiguous() for key, v in ins.items()}
    ccot = {key: torch.randn((k, S), generator=gen, device="cuda")
            for key in tck.OUT_KEYS}
    gmap = torch.randn((k, tck.N_MAP), generator=gen, device="cuda")
    w, maps = tck.planar_compositor_fwd_cuda(ins)
    dg = tck.planar_compositor_bwd_cuda(ins, ccot, gmap)
    torch.cuda.synchronize()
    rw, rmaps = tck.planar_compositor_fwd_ref(ins)
    rdg = tck.planar_compositor_bwd_ref(ins, ccot, gmap)
    fwd_err = max(float((w - rw).abs().max()),
                  float((maps - rmaps).abs().max()))
    bwd_errs = [rel_errs(dg[i], rdg[i]) for i in range(len(dg))]
    bwd_err = max(e[0] for e in bwd_errs)
    print(f"kernel planar_compositor at the {k} gathered rows: forward max "
          f"abs err {fwd_err:.2e}, adjoint worst error/max {bwd_err:.2e} "
          f"(tol {COMP_TOL})", flush=True)
    if fwd_err > COMP_TOL or bwd_err > COMP_TOL:
        fail("planar_compositor disagrees with its plain version at the "
             "gathered rows")
    csrc = "nsff_pl_tpu_torch/csrc/planar_compositor.cu"
    for which, fn, ref, err in (
            ("fwd", lambda: tck.planar_compositor_fwd_cuda(ins),
             lambda: tck.planar_compositor_fwd_ref(ins), fwd_err),
            ("bwd", lambda: tck.planar_compositor_bwd_cuda(ins, ccot, gmap),
             lambda: tck.planar_compositor_bwd_ref(ins, ccot, gmap),
             max(e[2] for e in bwd_errs))):
        ms = cuda_ms(torch, fn, iters=100, graph=True)
        plain_ms = cuda_ms(torch, ref, iters=10, graph=True)
        ops, nbytes = comp_work(which, k, S)
        name = f"planar_compositor_{which}_gathered"
        records[name] = _record(
            f"{name}[K={k}]", csrc,
            "nsff_pl_tpu/ops/compositing_planar_kernel.py:110", err, ms,
            plain_ms, ops, nbytes, PEAK_F32_FLOPS)
        print(f"kernel {records[name]['name']} n={k}: {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {records[name]['bound_ms']:.4f} ms "
              f"on {card}", flush=True)
    return records


def repeat_graphed(torch, np, cfg, table, Ks, Ps, label):
    """Two graphed dispatches of TRAIN_STEPS steps from one seed (the same
    params, the generator drawing every draw inside the graph, hard
    sampling on): the params, the optimizer's state, `tmp_rgb` and the
    loss terms must be the same bits. Returns the launches the card
    ran."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
    from nsff_pl_tpu_torch.training.optim import param_leaves

    ends, ran = [], {}
    for _ in range(2):
        params = build_params(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        state, multi = train_setup(torch, cfg, params, "cuda", BATCH,
                                   scan_steps=TRAIN_STEPS, hard_sampling=True)
        batcher = RayBatcher(table, BATCH, hard_sampling=True, device="cuda")
        sched = FrameScheduler(N_FRAMES, seed=cfg.seed)
        gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        tmp = torch.zeros((N_FRAMES, H_IMG * W_IMG, 3), device="cuda")
        ts = torch.tensor([sched.next() for _ in range(TRAIN_STEPS)],
                          device="cuda")
        reset_counts()
        state, tmp, m = multi(state, tmp, batcher.table, batcher.weights, Ks,
                              Ps, gen, ts)
        torch.cuda.synchronize()
        for key, v in multi.graph_launches.items():
            ran[key] = ran.get(key, 0) + v * multi.replays
        ends.append([p.detach().clone() for p in param_leaves(state.params)]
                    + [t.clone() for t in state.opt_state.tensors()]
                    + [tmp, torch.stack(list(m.values()))])
        del multi, state, batcher
    same = sum(bool(torch.equal(a, b)) for a, b in zip(*ends))
    print(f"{label} [graphed, twice from one seed]: {same} of "
          f"{len(ends[0])} tensors (params, optimizer state, tmp_rgb, loss "
          f"terms) the same bits after {TRAIN_STEPS} steps", flush=True)
    if same != len(ends[0]):
        fail(f"{label}: two graphed runs from one seed part")
    torch.cuda.empty_cache()
    return ran


def variants_phase(torch, np, tcfg, table, Ks, Ps, card, exact_ms):
    """The train-path variants at the flagship recipe, each a main path:
    warp_subsample 2, warp_importance 0.5 and the plain composite
    (`training_phase`: 10 eager steps, the same 10 as one graphed
    dispatch equal to them bit for bit, launch counts; wi with the
    profile), two graphed wi runs from one seed (`repeat_graphed`), the
    wi step at batch 64 against the CPU, warp_subsample 2 under
    coarse-to-fine; sgd, radam and ranger (graphed equal to eager bit
    for bit) and the stub train backend (no kernel). `exact_ms` holds the
    exact step's (eager, graphed) ms of this run, printed beside each.
    Returns the launches the card ran, the steps that ran the stacked
    warp call by its sample count and the steps that composited K_GATHER
    gathered rays, and the ms per step by label."""
    ran, stacked, ms = {}, {128: 0, C2F_FINE: 0}, {}
    gathered = 0

    def add(counts, S=128):
        """Sum the launches; the steps at S samples (one static backward
        a step)."""
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v
        return counts.get(at_samples("planar_nerf_train_bwd_static", S), 0)

    for name, extra, render_kw, per_step in WARP_VARIANTS:
        cfg = tcfg.replace(**extra)
        eager, graph, e_ms, g_ms = training_phase(
            torch, np, cfg, table, Ks, Ps, card, label=f"{name} training",
            per_step=per_step, planar=True, repeat=False,
            profile=name == "wi", exact=True, render_kw=render_kw)
        ms[name] = (e_ms, g_ms)
        steps = add(eager) + add(graph)
        if name == "wi":
            steps += add(repeat_graphed(torch, np, cfg, table, Ks, Ps,
                                        f"{name} training"))
            gathered += steps
            train_agreement(torch, cfg, table, Ks, Ps, "wi training")
        if name != "off":
            stacked[128] += steps
        print(f"{name} training: {e_ms:.3f} ms per step eager, {g_ms:.3f} "
              f"ms graphed, against the exact step's {exact_ms[0]:.3f} / "
              f"{exact_ms[1]:.3f} ms in this run on {card}", flush=True)
        torch.cuda.empty_cache()

    ccfg = tcfg.replace(N_importance=C2F_NI, warp_subsample=2)
    eager, graph, e_ms, g_ms = training_phase(
        torch, np, ccfg, table, Ks, Ps, card, label="ws2 c2f training",
        per_step=PER_STEP_WS2_C2F, planar=True, steps=5, repeat=False,
        exact=True)
    ms["ws2 c2f"] = (e_ms, g_ms)
    stacked[C2F_FINE] += add(eager, C2F_FINE) + add(graph, C2F_FINE)
    print(f"ws2 c2f training: {e_ms:.3f} ms per step eager, {g_ms:.3f} ms "
          f"graphed on {card}", flush=True)
    torch.cuda.empty_cache()

    for opt in ("sgd", "radam", "ranger"):
        eager, graph, e_ms, g_ms = training_phase(
            torch, np, tcfg.replace(optimizer=opt), table, Ks, Ps, card,
            label=f"{opt} training", per_step=PER_STEP, planar=True,
            repeat=opt == "ranger", exact=True)
        ms[opt] = (e_ms, g_ms)
        add(eager)
        add(graph)
        print(f"{opt} training: {e_ms:.3f} ms per step eager, {g_ms:.3f} ms "
              f"graphed, against Adam's {exact_ms[0]:.3f} / "
              f"{exact_ms[1]:.3f} ms in this run on {card}", flush=True)
    torch.cuda.empty_cache()

    _, _, e_ms, g_ms = training_phase(
        torch, np, tcfg.replace(train_backend="stub"), table, Ks, Ps, card,
        label="stub training", per_step={}, planar=False, steps=5,
        repeat=False, profile=True, exact=True)
    ms["stub"] = (e_ms, g_ms)
    print(f"stub training (the field replaced, no kernel): {e_ms:.3f} ms "
          f"per step eager, {g_ms:.3f} ms graphed: the step's glue, against "
          f"the exact step's {exact_ms[0]:.3f} / {exact_ms[1]:.3f} ms on "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    return ran, stacked, gathered, ms


def variants_cli_phase(torch, np, card, base_psnr):
    """The train CLI with the variants, on the scene the scene phase
    wrote: warp_importance 0.5 with ranger on the first C1_FRAMES frames,
    once through the epoch and once stopped by its time budget and
    resumed (the resumed state equal to the checkpoint file, slow weights
    and lookahead count included, and both runs' ends the same bits);
    warp_importance 0.5 with Adam on all frames for WI_RUN_BUDGET_S, its
    last validation's PSNR above the fresh system's (`base_psnr`) by
    PSNR_GAIN_DB, as the exact run must. Returns the launches the card
    ran, the stacked-call runs' launches (all of them here) alike."""
    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.config import get_opts
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.optim import param_leaves
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

    wi = ["--warp_importance", "0.5"]
    c1 = ["--start_end", "0", str(C1_FRAMES), "--val_every_steps",
          str(C1_VAL_EVERY), "--cache_dir", f"{SCENE_RUN_DIR}/cache_c1"]
    ran, ends = {}, {}

    def run(label, exp, more):
        torch.cuda.synchronize()
        reset_counts()
        system = cli(scene_argv(exp, wi + more))
        torch.cuda.synchronize()
        for k, v in run_counts(system, launch_counts(), PER_STEP_WI,
                               label).items():
            ran[k] = ran.get(k, 0) + v
        bad = [s for s, r in jsonl_rows(exp).items()
               if not all(np.isfinite(v) for v in r.values())]
        if bad:
            fail(f"{label}: loss rows not finite at steps {bad[:5]}")
        return system

    ranger = c1 + ["--optimizer", "ranger"]
    system = run("wi ranger run", "wi_ranger_a", ranger)
    ends["a"] = _train_state(torch, system)
    print(f"wi ranger run: {system.steps_run} steps, "
          f"{cli_step_ms(system):.3f} ms per step through the CLI on {card}",
          flush=True)
    del system
    system = run("wi ranger run (cut)", "wi_ranger_c",
                 ranger + ["--time_budget_s", str(WI_RANGER_BUDGET_S)])
    stop, total = system.state.step, system.total_steps
    del system
    if not 0 < stop < total:
        fail(f"wi ranger run: the cut run stopped at step {stop} of {total}")
    ckpt = ckpt_lib.latest_checkpoint(f"{SCENE_RUN_DIR}/ckpts/wi_ranger_c")
    tree = ckpt_lib.restore_checkpoint(ckpt)
    again = NSFFSystem(get_opts(scene_argv("wi_ranger_c", wi + ranger + [
        "--ckpt_path", ckpt])))
    opt = again.state.opt_state
    saved = tree["opt_state"]
    exact = (again.state.step == int(tree["step"]) == stop
             and set(saved) == set(opt.fields())
             and all(int(getattr(opt, k)) == int(saved[k])
                     for k in opt.COUNTS)
             and all(torch.equal(a.cpu(), b) for a, b in zip(
                 param_leaves(again.state.params),
                 param_leaves(tree["params"])))
             and all(torch.equal(a.cpu(), b) for k in opt.LISTS
                     for a, b in zip(getattr(opt, k),
                                     param_leaves(saved[k]))))
    print(f"wi ranger run: resumed at step {stop} of {total}, params and "
          f"the ranger state ({sorted(opt.fields())}, lookahead count "
          f"{int(opt.lookahead_count)}) equal to the file bit for bit: "
          f"{exact}", flush=True)
    if not exact:
        fail("wi ranger run: the resumed state differs from the checkpoint")
    del again, tree
    system = run("wi ranger run (resumed)", "wi_ranger_c",
                 ranger + ["--ckpt_path", ckpt])
    ends["c"] = _train_state(torch, system)
    del system
    diff = _same_bits(torch, ends["a"], ends["c"])
    print(f"wi ranger run: stopped at step {stop} and resumed, against the "
          f"uninterrupted run after {total} steps (tensors that differ, "
          f"largest difference): " + json.dumps(diff), flush=True)
    if any(n for n, _ in diff.values()):
        fail("wi ranger run: the resumed run ends elsewhere")
    torch.cuda.empty_cache()

    system = run("wi run", "wi_adam",
                 ["--time_budget_s", str(WI_RUN_BUDGET_S)])
    for step, log in system.val_history:
        print(f"wi run: validation at step {step} " + json.dumps(
            {k: round(v, 4) for k, v in log.items()}), flush=True)
    last_step, last = system.val_history[-1]
    gain = last["psnr"] - base_psnr
    print(f"wi run: {system.steps_run} steps, {cli_step_ms(system):.3f} ms "
          f"per step through the CLI; validation PSNR {base_psnr:.3f} dB "
          f"before any step, {last['psnr']:.3f} dB at step {last_step}: "
          f"+{gain:.3f} dB (must exceed {PSNR_GAIN_DB} dB) on {card}",
          flush=True)
    if not gain > PSNR_GAIN_DB:
        fail(f"wi run: validation PSNR gained {gain:.3f} dB, not "
             f"{PSNR_GAIN_DB}")
    del system
    torch.cuda.empty_cache()
    return ran



# ---------------- profiling and the serving tools (main paths) ----------

# the train CLI's profiled run: 3 frames at 128x72, 27 steps an epoch, so
# that the trace window (steps 10-15) lies inside one epoch
PROFILE_WH, PROFILE_FRAMES = (128, 72), 3
PROFILE_DIR = "chip_smoke_out/profile_cli"
PROFILE_WINDOW = (10, 15)
# profile_step: 1 warm-up, 30 timed and 4 traced steps at 8192 rays (the
# JAX repo's bench recipe: the packed path without the fused compositor)
PROFILE_STEP_STEPS, PROFILE_STEP_TRACED = 1 + 30 + 4, 4
PER_STEP_PROFILE_OFF = {k: v for k, v in PER_STEP_PACKED.items()
                        if not k.startswith("fused_compositing")}
EXPORT_DIR = "chip_smoke_out/export"
# an exported program's timing: warm-up calls (the card's clocks settle
# after the fresh process's idle start), then timed calls
EXPORT_WARMUP, EXPORT_REPS = 10, 20
# the fresh process that loads the exported kernel artifacts: it imports
# torch and nsff_pl_tpu_torch.ops.library, nothing else; per artifact
# (path, inputs, where to save the first call's outputs) one JSON line
EXPORT_LOADER = r"""
import json, sys, torch
import nsff_pl_tpu_torch.ops.library as library
counts = {"planar_eval_comp": library.rk.planar_eval_comp_cuda.launches,
          "fused_nerf_eval": library.mk.fused_nerf_eval_cuda.launches,
          "planar_nerf_train_fwd":
              library.rk.planar_nerf_train_fwd_cuda.launches}
warmup, reps = int(sys.argv[1]), int(sys.argv[2])
for path, inputs, out in zip(*[iter(sys.argv[3:])] * 3):
    for c in counts.values():
        c.clear()
    prog = torch.export.load(path).module()
    rays, ts = (t.cuda() for t in torch.load(inputs))
    with torch.no_grad():
        torch.save([g.cpu() for g in prog(rays, ts)], out)
        for _ in range(warmup):
            prog(rays, ts)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            prog(rays, ts)
        end.record()
        torch.cuda.synchronize()
    print(json.dumps({
        "path": path, "ms": start.elapsed_time(end) / reps,
        "calls": 1 + warmup + reps,
        "launches": {f"{k}@{S}": n for k, c in counts.items()
                     for S, n in sorted(c.items()) if n},
        "modules": sorted(m for m in sys.modules if m.startswith("nsff"))}))
"""


def trace_kernels(logdir, per_step):
    """(the `step <n>` ranges, {symbol: kernel events}, all kernel events)
    of the one torch.profiler trace under `logdir`, for the kernels of
    `per_step` (their first kernel, SYMBOLS)."""
    import glob

    files = glob.glob(f"{logdir}/*.pt.trace.json")
    if len(files) != 1:
        fail(f"{logdir}: {len(files)} trace files, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    steps = sorted(int(e["name"].split()[1]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("step "))
    syms = {SYMBOLS[k] for k in per_step}
    return steps, {s: sum(_symbol_count(n, s) for n in names)
                   for s in syms}, len(names)


def expected_symbols(per_step, steps):
    out = {}
    for k, v in per_step.items():
        out[SYMBOLS[k]] = out.get(SYMBOLS[k], 0) + v * steps
    return out


def profile_cli_part(torch, card):
    """(a) The train CLI with --profile_dir on the scene's first frames:
    the trace of steps 10-15 holds B2's and B3's kernels at PER_STEP per
    step, and the run ends with the bits of the same run with
    --scan_steps 1 and no profiling. Returns the launches the card ran."""
    import shutil

    from nsff_pl_tpu_torch.apps.train import cli

    extra = ["--img_wh", str(PROFILE_WH[0]), str(PROFILE_WH[1]),
             "--start_end", "0", str(PROFILE_FRAMES),
             "--cache_dir", f"{SCENE_RUN_DIR}/cache_prof"]
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    ran, systems = {}, {}
    for label, more in (("prof", ["--profile_dir", PROFILE_DIR]),
                        ("prof_ref", ["--scan_steps", "1"])):
        torch.cuda.synchronize()
        reset_counts()
        system = cli(scene_argv(label, extra + more))
        torch.cuda.synchronize()
        counts = launch_counts()
        n = system.steps_run
        if system.scan_steps != 1 or n != system.total_steps or n < 20:
            fail(f"profile CLI {label}: K {system.scan_steps}, {n} steps of "
                 f"{system.total_steps}")
        for k, v in counts.items():
            want = PER_STEP.get(k, 0) * n
            if k != "planar_eval_comp" and v != want:  # B1: validations
                fail(f"profile CLI {label}: {k} launched {v} times, "
                     f"expected {want}")
            ran[k] = ran.get(k, 0) + v
        systems[label] = system
    prof, ref = systems["prof"], systems["prof_ref"]
    window = list(range(*PROFILE_WINDOW))
    steps, kernels, n_kernels = trace_kernels(PROFILE_DIR, PER_STEP)
    want = expected_symbols(PER_STEP, len(window))
    diff = _same_bits(torch, _train_state(torch, prof),
                      _train_state(torch, ref))
    out = {"steps": prof.steps_run, "traced_steps": prof.trace_steps,
           "trace_step_ranges": steps, "trace_kernels": kernels,
           "expected": want, "kernel_events": n_kernels,
           "ms_per_step_in_window": prof.trace_seconds * 1e3 / len(window),
           "ms_per_step_unprofiled_run": cli_step_ms(ref),
           "ms_per_step_profiled_run": cli_step_ms(prof),
           "differ_from_unprofiled": diff, "card": card}
    print("tools (a) train CLI --profile_dir: " + json.dumps(out),
          flush=True)
    if prof.trace_steps != window or steps != window:
        fail(f"profile CLI: traced steps {prof.trace_steps}, ranges {steps}")
    if kernels != want:
        fail(f"profile CLI: the trace holds {kernels}, expected {want}")
    if any(n for n, _ in diff.values()):
        fail("profile CLI: profiling changed the run's bits")
    del prof, ref, systems
    torch.cuda.empty_cache()
    return ran


def profile_step_part(torch, card):
    """(b) `tools/profile_step.py` at 8192 rays on the planar path (auto)
    and the packed path (off): ms per step, launch counts per step, and
    the trace of its 4 traced steps. Returns the launches."""
    import math
    import shutil

    from nsff_pl_tpu_torch.tools import profile_step

    ran, out = {}, {"batch": LARGE_BATCH, "card": card}
    for mode, per_step in (("auto", PER_STEP), ("off", PER_STEP_PROFILE_OFF)):
        logdir = f"chip_smoke_out/profile_step_{mode}"
        shutil.rmtree(logdir, ignore_errors=True)
        torch.cuda.synchronize()
        reset_counts()
        res = profile_step.main([mode, logdir, str(LARGE_BATCH)])
        torch.cuda.synchronize()
        counts = launch_counts()
        check_counts(counts, per_step, PROFILE_STEP_STEPS,
                     f"profile_step {mode}")
        _, kernels, n_kernels = trace_kernels(logdir, per_step)
        want = expected_symbols(per_step, PROFILE_STEP_TRACED)
        out[mode] = {"ms_per_step": res["ms_per_step"], "loss": res["loss"],
                     "trace_kernels": kernels, "kernel_events": n_kernels}
        if kernels != want or not math.isfinite(res["loss"]):
            fail(f"profile_step {mode}: trace {kernels}, expected {want}, "
                 f"loss {res['loss']}")
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v
        del res
        torch.cuda.empty_cache()
    print("tools (b) profile_step: " + json.dumps(out), flush=True)
    return ran


def stripped_weights_part(torch, np, card, ckpt):
    """(c) `tools/save_weights_only.py` on the scene training checkpoint:
    a served frame (`RenderService` on `checkpoint.load`) and an eval
    frame (the eval CLI's `load_params` and renderer, test item 0 with
    visibility, one graph of equal chunks) equal those of the full
    checkpoint bit for bit. Returns the launches the card ran."""
    import os
    from types import SimpleNamespace

    from nsff_pl_tpu_torch.apps.evaluate import load_params
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import NSFFConfig, render_config
    from nsff_pl_tpu_torch.scene import scene_dict
    from nsff_pl_tpu_torch.tools import save_weights_only
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.step import (make_render_fn,
                                                 render_full_image)

    out_dir = "chip_smoke_out/weights_planar"
    n_params = save_weights_only.main(["--ckpt_path", ckpt, "--out",
                                       out_dir])
    cfg = NSFFConfig(img_wh=(W_IMG, H_IMG), start_end=(0, N_FRAMES),
                     use_viewdir=True, encode_t=True, N_samples=128,
                     dtype="bfloat16")
    K, poses = scene(np)
    data = scene_dict["monocular"](
        root_dir=SCENE_DIR, split="test", img_wh=(W_IMG, H_IMG),
        start_end=(0, N_FRAMES), device="cuda")
    item = data.test_item(0, targets=())
    vis_poses = torch.as_tensor(data.poses[0:1], dtype=torch.float32,
                                device="cuda")
    vis_K = torch.as_tensor(data.K, device="cuda")
    frames, ran = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    for label, path in (("full", ckpt), ("stripped", out_dir)):
        svc = RenderService(ckpt_lib.load(path), K, poses, (W_IMG, H_IMG),
                            cfg, chunk=CHUNK)
        served = svc.render_maps(3)
        params = load_params(SimpleNamespace(ckpt_path=path), cfg, "cuda")
        render = make_render_fn(render_config(cfg), output_transient=True,
                                with_visibility=True,
                                keys=("rgb_fine", "depth_fine"))
        ev = render_full_image(render, params, item["rays"], item["ts"],
                               chunk=CHUNK, vis_poses=vis_poses, vis_K=vis_K,
                               scan_chunks=True)
        frames[label] = [served[k] for k in ("rgb_fine", "depth_fine")] + [
            ev[k] for k in ("rgb_fine", "depth_fine")]
        g_ran, g_counted = graph_ran(render)
        for k, v in g_ran.items():
            ran[k] = ran.get(k, 0) + v - g_counted[k]
    torch.cuda.synchronize()
    for k, v in launch_counts().items():
        ran[k] = ran.get(k, 0) + v
    same = [bool(torch.equal(a, b))
            for a, b in zip(frames["full"], frames["stripped"])]
    sizes = {k: os.path.getsize(os.path.join(p, ckpt_lib.STATE_FILE))
             for k, p in (("full", ckpt), ("stripped", out_dir))}
    print("tools (c) save_weights_only: " + json.dumps(
        {"params": n_params, "bytes": sizes,
         "equal (served rgb, depth; eval rgb, depth)": same,
         "launches": {k: v for k, v in ran.items() if v}, "card": card}),
        flush=True)
    if not all(same):
        fail("frames from the stripped checkpoint differ from the full one")
    return ran


def export_part(torch, np, card, ckpt):
    """(d) `tools/export_render.py` at the flagship serving configuration
    (512x288, chunk 32768, use_viewdir, N_samples 128): the kernel route
    in bfloat16 with encode_t (B1), with encode_t and `--N_importance
    C2F_NI` on seeded weights (the planar coarse-to-fine route: B2's
    forward at 128 samples, sample_pdf and the sort, B1 at 192) and
    without encode_t (B5), and the plain route in float32, each with
    --check. The three kernel artifacts reload in one fresh process that
    imports torch and nsff_pl_tpu_torch.ops.library alone: one launch of
    each kernel a call at its sample count, the output against the live
    renderer's (the coarse-to-fine route: the same bits), ms per exported
    chunk beside the live one (the plain artifact: timed here, after the
    tool's reload). Returns the launches the card ran (`name@S` at S other
    than 128)."""
    import os
    import shutil

    from nsff_pl_tpu_torch.apps.evaluate import load_params
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.tools import export_render as er
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from nsff_pl_tpu_torch.training.step import make_render_fn

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    static = build_params(NSFFConfig(use_viewdir=True,
                                     start_end=(0, N_FRAMES)),
                          torch.Generator().manual_seed(5), device="cuda")
    static_ckpt = ckpt_lib.save_checkpoint(f"{EXPORT_DIR}/static", 0,
                                           {"params": static})
    c2f = build_params(NSFFConfig(use_viewdir=True, encode_t=True,
                                  N_importance=C2F_NI,
                                  start_end=(0, N_FRAMES)),
                       torch.Generator().manual_seed(6), device="cuda")
    c2f_ckpt = ckpt_lib.save_checkpoint(f"{EXPORT_DIR}/c2f", 0,
                                        {"params": c2f})
    del static, c2f
    base = ["--img_wh", str(W_IMG), str(H_IMG), "--chunk", str(CHUNK),
            "--use_viewdir", "--N_samples", "128", "--N_frames",
            str(N_FRAMES)]
    kernel_route = ["--dtype", "bfloat16", "--mlp_backend", "pallas"]
    dev = torch.device("cuda")
    ran, lines, loads, live = {}, {}, [], {}
    # (label, checkpoint, flags, launches of each kernel a call)
    routes = [
        ("B1", ckpt, ["--encode_t", "--output_transient"] + kernel_route,
         {"planar_eval_comp": 1}),
        ("B2+B1 c2f", c2f_ckpt, ["--encode_t", "--N_importance",
                                 str(C2F_NI)] + kernel_route,
         {"planar_nerf_train_fwd": 1, f"planar_eval_comp@{128 + C2F_NI}": 1}),
        ("B5", static_ckpt, kernel_route, {"fused_nerf_eval": 1}),
        ("plain", ckpt, ["--encode_t", "--output_transient",
                         "--dtype", "float32"], None)]
    for label, path, flags, kernel in routes:
        out = f"{EXPORT_DIR}/{label.split()[0]}.pt2"
        args = er.get_opts(["--ckpt_path", path, "--out", out, *base,
                            *flags, "--check"])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        meta = er.main(args)
        export_s = time.perf_counter() - t0
        counts = launch_counts()
        # --check: one call of the reloaded program, one live
        check_counts(counts, kernel or {}, 2, f"export {label} --check")
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v
        cfg = NSFFConfig(img_wh=(W_IMG, H_IMG), start_end=(0, N_FRAMES),
                         use_viewdir=True, encode_t=args.encode_t,
                         N_samples=128, N_importance=args.N_importance)
        params = load_params(args, cfg, dev)
        render = make_render_fn(
            er.render_config(args, dev),
            output_transient=args.output_transient and args.encode_t,
            keys=er.OUTPUT_KEYS)
        rays, ts = er.check_rays(CHUNK, dev)
        live[label] = [render(params, rays, ts)[k] for k in er.OUTPUT_KEYS]
        reps = EXPORT_REPS if kernel else 3
        warm = EXPORT_WARMUP if kernel else 1
        live_ms = cuda_ms(torch, lambda: render(params, rays, ts),
                          iters=reps, warmup=warm)
        lines[label] = {"route": label, "export_s": export_s,
                        "mb": os.path.getsize(out) / 1e6,
                        "check": meta["check"], "live_chunk_ms": live_ms,
                        "card": card}
        if kernel:
            inputs = f"{EXPORT_DIR}/{label.split()[0]}.inputs.pt"
            torch.save((rays.cpu(), ts.cpu()), inputs)
            loads += [out, inputs, f"{out}.got.pt"]
        else:  # the plain artifact, timed here
            with torch.no_grad():
                prog = torch.export.load(out).module()
                lines[label]["exported_chunk_ms"] = cuda_ms(
                    torch, lambda: prog(rays, ts), iters=reps, warmup=warm)
            del prog
        del params, render
        torch.cuda.empty_cache()
    reset_counts()
    r = subprocess.run([sys.executable, "-c", EXPORT_LOADER,
                        str(EXPORT_WARMUP), str(EXPORT_REPS), *loads],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"export: the fresh process failed:\n{r.stdout[-3000:]}"
             f"{r.stderr[-3000:]}")
    results = [json.loads(x) for x in r.stdout.splitlines()
               if x.startswith("{")]
    kernel_routes = [(label, kernel) for label, _, _, kernel in routes
                     if kernel]
    if len(results) != len(kernel_routes):
        fail(f"export: the fresh process printed {r.stdout[-3000:]}")
    for (label, kernel), res in zip(kernel_routes, results):
        got = torch.load(f"{EXPORT_DIR}/{label.split()[0]}.pt2.got.pt")
        errs = [float((g.cuda() - w).abs().max())
                for g, w in zip(got, live[label])]
        extra = [m for m in res["modules"]
                 if m not in ("nsff_pl_tpu_torch", "nsff_pl_tpu_torch.ops")
                 and not m.startswith("nsff_pl_tpu_torch.ops.")]
        lines[label].update(
            exported_chunk_ms=res["ms"], fresh_process_max_abs_err=errs,
            fresh_process_launches=res["launches"], calls=res["calls"],
            modules=res["modules"])
        if extra:
            fail(f"export {label}: the fresh process imported {extra}")
        want = {(k if "@" in k else f"{k}@128"): n * res["calls"]
                for k, n in kernel.items()}
        if res["launches"] != want:
            fail(f"export {label}: launches {res['launches']} for "
                 f"{res['calls']} calls, expected {want}")
        if max(errs) > (0.0 if "c2f" in label else er.CHECK_TOL):
            fail(f"export {label}: the fresh process's output differs from "
                 f"the live renderer's by {max(errs)}")
        for k, n in kernel.items():
            ran[k] = ran.get(k, 0) + n * res["calls"]
    for line in lines.values():
        print("tools (d) export_render: " + json.dumps(line), flush=True)
    return ran


def tools_phase(torch, np, card):
    """Profiling and the serving tools: (a) the train CLI with
    --profile_dir, (b) profile_step at 8192 rays on both paths, (c)
    save_weights_only on the scene training checkpoint, (d) export_render
    of both kernel routes and the plain one. Returns the launches the
    card ran, by kernel."""
    import os

    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    ckpt = os.path.abspath(ckpt_lib.latest_checkpoint(
        f"{SCENE_RUN_DIR}/ckpts/planar"))
    ran = {}
    for part in (profile_cli_part(torch, card),
                 profile_step_part(torch, card),
                 stripped_weights_part(torch, np, card, ckpt),
                 export_part(torch, np, card, ckpt)):
        for k, v in part.items():
            ran[k] = ran.get(k, 0) + v
    return ran


# the data-parallel phase: eager steps and the K of its graphed dispatch,
# and the timed dispatches of each graph (in turns)
DP_STEPS = 10
DP_TIMED = 3
# served frames a route and a service (over the world of one, and
# undistributed), timed in turns
DP_FRAMES = 3


def _dp_state(torch, state, tmp, rows):
    """Copies of a run's params, optimizer state, `tmp_rgb` and stacked
    loss terms, for `_same_bits`."""
    from nsff_pl_tpu_torch.training.optim import param_leaves

    return {"params": [p.detach().clone() for p in param_leaves(
                state.params)],
            "optimizer state": [t.clone() for t in
                                state.opt_state.tensors()],
            "tmp_rgb": [tmp.clone()], "loss terms": [torch.stack(rows)]}


def _dp_eager(torch, cfg, table, Ks, Ps, mesh):
    """DP_STEPS eager steps from the seeded weights, every draw from the
    seeded generator: (state copies, the launches they made)."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
    from nsff_pl_tpu_torch.training.step import write_tmp_rgb

    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    state, step = train_setup(torch, cfg, params, "cuda", BATCH, mesh=mesh)
    batcher = RayBatcher(table, BATCH, device="cuda")
    sched = FrameScheduler(N_FRAMES, seed=cfg.seed)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    tmp = torch.zeros((N_FRAMES, H_IMG * W_IMG, 3), device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    rows = []
    for _ in range(DP_STEPS):
        t = sched.next()
        state, m, aux = step(state, batcher.table, batcher.weights, Ks, Ps,
                             gen, t)
        write_tmp_rgb(tmp, t, aux["rand_idx"], aux["rgb_fine"])
        rows.append(torch.stack(list(m.values())))
    torch.cuda.synchronize()
    return _dp_state(torch, state, tmp, rows), launch_counts()


class _DpGraphed:
    """One graphed run (`scan_steps=DP_STEPS`, hard sampling) of `cfg`
    from the seeded weights, on `mesh` or undistributed, dispatched a
    K-step group at a time."""

    def __init__(self, torch, cfg, table, Ks, Ps, mesh):
        from nsff_pl_tpu_torch.config import build_params
        from nsff_pl_tpu_torch.data.pipeline import (FrameScheduler,
                                                     RayBatcher)

        self.torch = torch
        params = build_params(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        self.state, self.multi = train_setup(
            torch, cfg, params, "cuda", BATCH, scan_steps=DP_STEPS,
            hard_sampling=True, mesh=mesh)
        self.batcher = RayBatcher(table, BATCH, hard_sampling=True,
                                  device="cuda")
        self.sched = FrameScheduler(N_FRAMES, seed=cfg.seed)
        self.gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
        self.tmp = torch.zeros((N_FRAMES, H_IMG * W_IMG, 3), device="cuda")
        self.Ks, self.Ps = Ks, Ps
        self.rows, self.ms = [], []

    def dispatch(self, timed=False):
        torch = self.torch
        ts = torch.tensor([self.sched.next() for _ in range(DP_STEPS)],
                          device="cuda")
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        self.state, self.tmp, m = self.multi(
            self.state, self.tmp, self.batcher.table, self.batcher.weights,
            self.Ks, self.Ps, self.gen, ts)
        ev1.record()
        torch.cuda.synchronize()
        if timed:
            self.ms.append(ev0.elapsed_time(ev1) / DP_STEPS)
        self.rows += [torch.stack([m[k][i] for k in m])
                      for i in range(DP_STEPS)]

    def ran(self):
        """The launches the card ran: the capture's times the replays."""
        return {k: v * self.multi.replays
                for k, v in self.multi.graph_launches.items()}


def _replay_profile(torch, run):
    """torch.profiler over one more dispatch of `run`: the device time of
    each kernel and copy its replay ran (us, by name), their count and
    the device-to-device copies and NCCL kernels among them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run.dispatch()
    ran = {e.key: (e.count, _dev_us(e)) for e in prof.key_averages()
           if _dev_us(e) > 0}
    return ran, {
        "device events": sum(c for c, _ in ran.values()),
        "device ms": sum(us for _, us in ran.values()) / 1e3,
        "Memcpy DtoD": sum(c for k, (c, _) in ran.items()
                           if "Memcpy DtoD" in k),
        "nccl kernels": sum(c for k, (c, _) in ran.items()
                            if "nccl" in k.lower())}


def dp_serving(torch, np, cfg, params, K, poses, mesh, card):
    """Served 512x288 frames over the world of one `mesh` (docstring item
    13): a `RenderService` over the mesh against the undistributed one on
    B1 and, with `planar_eval="off"`, on B5: the same request gives the
    same bits, one launch and one all-gather a chunk; then DP_FRAMES
    requests of each service in turns, timed on the host's clock.
    Returns the launches the card ran."""
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.parallel import mesh as mesh_lib

    ran = {}

    def add(counts):
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v

    c2w = poses[7].copy()
    c2w[:, 3] += np.array([0.02, -0.01, 0.03], np.float32)
    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    for label, kernel, c in (("B1", "planar_eval_comp", cfg),
                             ("B5", "fused_nerf_eval",
                              cfg.replace(planar_eval="off"))):
        svc = {alone: RenderService(params, K, poses, (W_IMG, H_IMG), c,
                                    chunk=CHUNK, device="cuda",
                                    mesh=None if alone else mesh)
               for alone in (False, True)}
        maps = {}
        for alone in (False, True):
            torch.cuda.synchronize()
            reset_counts()
            gathers = mesh_lib.CALLED["all_gather"]
            maps[alone] = svc[alone].render_maps(5, c2w.tolist())
            torch.cuda.synchronize()
            counts = launch_counts()
            check_counts(counts, {kernel: n_chunks}, 1,
                         f"dp serving {label} (mesh {not alone})")
            add(counts)
            gathers = mesh_lib.CALLED["all_gather"] - gathers
            if gathers != (0 if alone else n_chunks):
                fail(f"dp serving {label}: {gathers} all-gathers a frame")
        diff = _same_bits(torch, {k: [v] for k, v in maps[False].items()},
                          {k: [v] for k, v in maps[True].items()})
        secs = {False: [], True: []}
        for alone in (False, True, True, False, False, True)[:2 * DP_FRAMES]:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            svc[alone].render_pose(5, c2w.tolist())  # ends with a copy out
            secs[alone].append(time.perf_counter() - t0)
            counts = launch_counts()
            check_counts(counts, {kernel: n_chunks}, 1,
                         f"dp serving {label} (timed)")
            add(counts)
        print(f"dp serving {label}: a {W_IMG}x{H_IMG} frame over a world of "
              f"one against the undistributed service (tensors that differ, "
              f"largest difference): {json.dumps(diff)}; {n_chunks} "
              f"launches and {n_chunks} all-gathers a frame; seconds a "
              f"request {[round(v, 6) for v in secs[False]]} / "
              f"{[round(v, 6) for v in secs[True]]}, mean "
              f"{np.mean(secs[False]):.6f} / {np.mean(secs[True]):.6f} "
              f"on {card}", flush=True)
        if any(n for n, _ in diff.values()):
            fail(f"dp serving {label}: the world of one parts from the "
                 "undistributed service")
        del svc, maps
    return ran


def dp_eval(torch, np, card, spiral_s):
    """The eval CLI with `--num_gpus 2` on one GPU (a world of one) on the
    eval phase's split `test_spiral --fix_view_dir` (docstring item 13):
    the fewer-GPUs note, each frame one replay of a graph that captured
    the chunks' all-gathers, and every file the eval phase's run wrote
    the same bytes. Returns the launches the card ran."""
    import io
    import os

    from nsff_pl_tpu_torch.parallel import mesh as mesh_lib

    argv = eval_base() + ["--split", "test_spiral", "--fix_view_dir",
                          "--scene_name", "spiral_fixed_dp", "--num_gpus",
                          "2"]
    here = os.getcwd()
    os.chdir(EVAL_DIR)
    try:
        gathers = mesh_lib.CALLED["all_gather"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rep, ran, g = eval_split(
                torch, np, card, "test_spiral --fix_view_dir --num_gpus 2",
                argv, {"planar_eval_comp": 1}, 6 * N_FRAMES)
        printed = out.getvalue()
        print(printed, end="", flush=True)
        gathers = mesh_lib.CALLED["all_gather"] - gathers
        if (rep.mesh is None or rep.mesh.size != 1
                or "1 GPUs are attached; using all 1" not in printed):
            fail("dp eval: no fewer-GPUs note, or not a world of one")
        if gathers != 2 * g.n_chunks:  # the warm-up's and the capture's
            fail(f"dp eval: {gathers} all-gathers called for one graph of "
                 f"{g.n_chunks} chunks")
        mine, theirs = ("results/monocular/spiral_fixed" + x
                        for x in ("_dp", ""))
        names = sorted(os.listdir(theirs))
        if sorted(n.replace("spiral_fixed", "spiral_fixed_dp")
                  for n in names) != sorted(os.listdir(mine)):
            fail("dp eval: other files than the eval phase's run")

        def read(path):
            with open(path, "rb") as f:
                return f.read()

        differ = [n for n in names if read(os.path.join(theirs, n)) != read(
            os.path.join(mine, n.replace("spiral_fixed", "spiral_fixed_dp")))]
        print(f"dp eval: {len(names)} files against the eval phase's run "
              f"of the split, {len(differ)} differ {differ[:5]}; "
              f"{np.mean(rep.render_seconds):.4f} s a frame render over a "
              f"world of one, {spiral_s:.4f} s in the eval phase's run, "
              f"on {card}", flush=True)
        if differ:
            fail("dp eval: the world of one writes other bytes than one "
                 "process")
        return ran
    finally:
        os.chdir(here)


def val_rows(exp):
    """A run's validation metrics, {step: {tag: value}} (the JSONL holds
    one row a metric)."""
    rows = {}
    with open(f"{SCENE_RUN_DIR}/logs/{exp}/metrics.jsonl") as f:
        for r in map(json.loads, f):
            for k, v in r.items():
                if k.startswith("val/"):
                    rows.setdefault(r["step"], {})[k] = v
    return rows


def dp_phase(torch, np, tcfg, pcfg, table, Ks, Ps, card, c1_end, scfg,
             params, K, poses, spiral_s):
    """Data parallelism on the one card (docstring item 13): training, the
    served frames of the serving configuration `scfg` (`dp_serving`),
    then the train CLI with `--num_gpus 2` against the C1 phase's first
    run (`c1_end`, the same flags with `--num_gpus 1`; its validations
    over the mesh too) and the eval CLI with `--num_gpus 2`
    (`dp_eval`). Returns the launches the card ran, by kernel."""
    import io
    import os
    import shutil
    import tempfile

    from nsff_pl_tpu_torch.apps.train import cli
    from nsff_pl_tpu_torch.parallel import distributed as dist_lib
    from nsff_pl_tpu_torch.parallel import mesh as mesh_lib

    ran = {}

    def add(counts):
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v

    rdv = tempfile.mkdtemp(dir="chip_smoke_out")
    mesh = dist_lib.initialize(tcfg, torch.device("cuda", 0),
                               init_method="file://" + os.path.abspath(
                                   os.path.join(rdv, "store")))
    try:
        if (mesh.size, torch.distributed.get_backend()) != (1, "nccl"):
            fail(f"dp: a world of {mesh.size} on "
                 f"{torch.distributed.get_backend()}")
        for label, cfg, per_step in (("planar", tcfg, PER_STEP),
                                     ("packed", pcfg, PER_STEP_PACKED)):
            eager = {}
            for m in (None, mesh):
                eager[m is None], counts = _dp_eager(torch, cfg, table, Ks,
                                                     Ps, m)
                check_counts(counts, per_step, DP_STEPS,
                             f"dp {label} eager (mesh {m is not None})")
                add(counts)
            runs = {}
            for m in (mesh, None):
                run = runs[m is None] = _DpGraphed(torch, cfg, table, Ks, Ps,
                                                   m)
                before = dict(mesh_lib.CALLED)
                run.dispatch()  # warm-up runs, capture, one replay
                called = {k: v - before.get(k, 0)
                          for k, v in mesh_lib.CALLED.items()}
                if m is not None:
                    k_cap = (run.multi.WARMUP + 1) * DP_STEPS
                    print(f"dp {label}: the dispatch's warm-up and capture "
                          f"called {json.dumps(called)} collectives over "
                          f"{k_cap} steps ({DP_STEPS} of them captured), "
                          f"capture {run.multi.capture_seconds:.2f} s",
                          flush=True)
                    if called.get("all_reduce") != k_cap:
                        fail(f"dp {label}: {called.get('all_reduce')} "
                             f"all-reduces called over {k_cap} steps")
            for turn in (True, False, False, True, True, False)[:2 * DP_TIMED]:
                runs[turn].dispatch(timed=True)
            prof = {k: _replay_profile(torch, r) for k, r in runs.items()}
            print(f"dp {label}: one replay of the {DP_STEPS}-step graph ran "
                  f"{json.dumps(prof[False][1])} on the mesh, "
                  f"{json.dumps(prof[True][1])} undistributed (one rank: "
                  "NCCL turns each all-gather into a device copy and leaves "
                  "the in-place all-reduce out)", flush=True)
            mine, other = prof[False][0], prof[True][0]
            diff = sorted(((mine.get(k, (0, 0))[1] - other.get(k, (0, 0))[1],
                            k) for k in set(mine) | set(other)),
                          key=lambda d: -abs(d[0]))
            print(f"dp {label}: device us a replay, mesh minus "
                  "undistributed, the 8 largest (count mesh / undistributed):"
                  + "".join(f"\n  {d:+.1f} {k[:90]} ({mine.get(k, (0,))[0]} / "
                            f"{other.get(k, (0,))[0]})" for d, k in diff[:8]),
                  flush=True)
            for what, a, b in (
                    ("eager", eager[False], eager[True]),
                    ("graphed", *(_dp_state(torch, runs[k].state,
                                            runs[k].tmp, runs[k].rows)
                                  for k in (False, True)))):
                diff = _same_bits(torch, a, b)
                print(f"dp {label} {what}: a world of one against the "
                      f"undistributed run (tensors that differ, largest "
                      f"difference): " + json.dumps(diff), flush=True)
                if any(n for n, _ in diff.values()):
                    fail(f"dp {label} {what}: the world of one parts from "
                         "the undistributed run")
            for k, run in runs.items():
                check_counts(run.multi.graph_launches, per_step, DP_STEPS,
                             f"dp {label} graph")
                add(run.ran())
            dp_ms, one_ms = (float(np.mean(runs[k].ms)) for k in (False,
                                                                  True))
            print(f"dp {label}: graphed {dp_ms:.4f} ms a step on a world of "
                  f"one, {one_ms:.4f} undistributed (ms a step of each "
                  f"timed dispatch: {[round(v, 4) for v in runs[False].ms]} "
                  f"/ {[round(v, 4) for v in runs[True].ms]}) on {card}",
                  flush=True)
            del runs, eager
            torch.cuda.empty_cache()
        add(dp_serving(torch, np, scfg, params, K, poses, mesh, card))
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)

    # the train CLI: --num_gpus 2 on one GPU is a world of one, against
    # the C1 phase's first run (the same flags, --num_gpus 1)
    c1 = ["--start_end", "0", str(C1_FRAMES), "--val_every_steps",
          str(C1_VAL_EVERY), "--cache_dir", f"{SCENE_RUN_DIR}/cache_c1"]
    torch.cuda.synchronize()
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        system = cli(scene_argv("dp2", c1 + ["--num_gpus", "2"]))
    torch.cuda.synchronize()
    printed = out.getvalue()
    print(printed, end="", flush=True)
    add(run_counts(system, launch_counts(), PER_STEP, "dp CLI --num_gpus 2"))
    note = ("note: --num_gpus x --num_nodes = 2 but 1 GPUs are attached; "
            "using all 1")
    if note not in printed or system.mesh is None or system.mesh.size != 1:
        fail("dp CLI --num_gpus 2: no fewer-GPUs note, or not a world of "
             "one")
    print(f"dp CLI --num_gpus 2: {system.steps_run} steps, "
          f"{cli_step_ms(system):.3f} ms per step through the CLI on "
          f"{card}", flush=True)
    diff = _same_bits(torch, c1_end, _train_state(torch, system))
    del system
    same_rows = jsonl_rows("c1a") == jsonl_rows("dp2")
    vals = val_rows("dp2")
    same_vals = bool(vals) and vals == val_rows("c1a")
    print("dp CLI: --num_gpus 2 (a world of one) against --num_gpus 1 (C1's "
          "first run; tensors that differ, largest difference): "
          + json.dumps(diff) + f"; loss rows equal: {same_rows}; validation "
          f"rows (over the mesh) equal: {same_vals}, steps {sorted(vals)}",
          flush=True)
    if any(n for n, _ in diff.values()) or not same_rows or not same_vals:
        fail("dp CLI: --num_gpus 2 on one GPU ends elsewhere than "
             "--num_gpus 1")
    torch.cuda.empty_cache()
    add(dp_eval(torch, np, card, spiral_s))
    torch.cuda.empty_cache()
    return ran


# ---------------- any sample count (ROADMAP A17) ----------------

# The recipe at --N_samples 96 (one tile of 128 rows, 96 of them used)
# and the NeRF paper's coarse-to-fine counts --N_samples 64
# --N_importance 128: the coarse pass at 64, the fine pass at 64 + 2 x
# 128 = 320 in training and for both towers (three tiles, the last with
# 64 rows). Every kernel of those paths is held against its plain
# version and timed at the sample counts they run (TIMED_S; at 64 the
# coarse pass runs B2 alone), at the main paths' shapes; the other counts
# (a sample, 33, 100, 512: a tile's tail of 1 to 128 rows, four tiles, a
# lane's tail, rows that keep no 16-byte alignment) and the few-ray
# shapes are tests/test_torch_cuda.py's.
S96 = 96
C2F2_S, C2F2_NI = 64, 128
C2F2_FINE = C2F2_S + 2 * C2F2_NI
B2_NAMES = ("planar_nerf_train_fwd", "planar_nerf_train_bwd_static",
            "planar_nerf_train_bwd_transient")
TIMED_S = {C2F2_S: B2_NAMES, S96: None, C2F2_FINE: None}  # None: every kernel
# launches per step of the main paths at these counts
PER_STEP_96 = {f"{k}@{S96}": v for k, v in PER_STEP.items()}
PER_STEP_PACKED_96 = {f"{k}@{S96}": v for k, v in PER_STEP_PACKED.items()}
PER_STEP_C2F2 = {**{f"{k}@{C2F2_S}": 1 for k in B2_NAMES},
                 **{f"{k}@{C2F2_FINE}": v for k, v in PER_STEP.items()}}
PER_STEP_PACKED_C2F2 = {f"{k}@{C2F2_FINE}": v
                        for k, v in PER_STEP_PACKED.items()}
SWEEP_SRC = {
    "planar_eval_comp": ("nsff_pl_tpu_torch/csrc/planar_eval_comp.cu",
                         "nsff_pl_tpu/ops/raymarch_kernel.py:728"),
    "planar_nerf_train": ("nsff_pl_tpu_torch/csrc/planar_nerf_train.cu",
                          "nsff_pl_tpu/ops/raymarch_kernel.py:64"),
    "planar_compositor": ("nsff_pl_tpu_torch/csrc/planar_compositor.cu",
                          "nsff_pl_tpu/ops/compositing_planar_kernel.py:110"),
    "fused_nerf_eval": ("nsff_pl_tpu_torch/csrc/fused_nerf_eval.cu",
                        "nsff_pl_tpu/ops/mlp_kernel.py:121"),
    "fused_nerf_train": ("nsff_pl_tpu_torch/csrc/fused_nerf_train.cu",
                         "nsff_pl_tpu/ops/mlp_train_kernel.py:141"),
    "fused_compositing": ("nsff_pl_tpu_torch/csrc/fused_compositing.cu",
                          "nsff_pl_tpu/ops/compositing_kernel.py:100")}


def _src_of(name):
    return SWEEP_SRC[next(k for k in SWEEP_SRC if name.startswith(k))]


def grad_verdict(errs, per_sample):
    """Of a backward's outputs' `rel_errs`: (worst error over max among the
    summed leaves, its key, worst Frobenius ratio, its key, largest abs
    error); the per-sample cotangents `per_sample` are held by other
    rules than GRAD_MAX."""
    summed = [k for k in errs if k not in per_sample]
    w_max = max(summed, key=lambda k: errs[k][0])
    w_fro = max(errs, key=lambda k: errs[k][1])
    return (errs[w_max][0], w_max, errs[w_fro][1], w_fro,
            max(e[2] for e in errs.values()))


def sample_sweep(torch, params, rays, K, poses, card):
    """Every kernel of the main paths at each sample count of TIMED_S
    against its plain version at the main paths' shapes (B1 and B5 at the
    serving chunk, the rest at batch 512; at 64 B2 and B3 alone), with
    the S = 128 tolerances: B1 (both towers with visibility and flow
    maps; the static tower) TOL; B2's forward (the main call, a warp, the
    stacked warp call with both flow heads) PLANE_TOL / PLANE_SHARE and
    both backward branches GRAD_MAX / GRAD_FRO, the flow-plane cotangents
    of the warp calls also by the unrounded-model rule (EXACT_MEAN /
    EXACT_MAX); B3 COMP_TOL; B5 (full; the static tower) PACKED_TOL /
    PACKED_SHARE and its unused columns zero; B4's static and transient
    branches GRAD_MAX / GRAD_FRO, the xyz cotangent DX_MAX; B6 COMP_TOL,
    its cotangent's columns 8-15 zero, with rays whose far sample is
    opaque (1 - alpha underflows there, where the adjoint's trailing sum
    must be an exact 0). Then each kernel is timed at the same shapes
    beside its plain version and its bound at the call's real samples
    (`sweep_records`). Returns the kernel records by S of TIMED_S
    (launches filled in by the main paths)."""
    from nsff_pl_tpu_torch.models.raymarch import _visibility_planes
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.ops.posenc import posenc

    fine = params["nerf_fine"]
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = {}  # (kernel, S) -> largest abs error
    rel = {}  # (kernel, S) -> largest error over a leaf's largest entry

    def note(name, S, err, r=None):
        worst[name, S] = max(worst.get((name, S), 0.0), err)
        if r is not None:
            rel[name, S] = max(rel.get((name, S), 0.0), r)

    def inputs(n, S):
        o, d = rays[:n, :3].contiguous(), rays[:n, 3:].contiguous()
        zs = torch.sort(torch.rand((n, S), generator=gen, device="cuda"),
                        1).values.contiguous()
        flows = tuple((0.05 * torch.randn((n, S), generator=gen,
                                          device="cuda")).contiguous()
                      for _ in range(3))
        te = params["embedding_t"][torch.randint(
            0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
        return o, d, zs, flows, posenc(d, 3.0, 4).contiguous(), te

    def check_b1(n, S):
        o, d, zs, _, de, te = inputs(n, S)
        for encode_t, flow, vis_in in ((True, ("fw", "bw"), True),
                                       (False, (), False)):
            vis = (_visibility_planes(o, d, zs, K, (W_IMG, H_IMG), poses[:1])
                   if vis_in else None)
            fn = rk.make_planar_nerf_eval_comp(
                S, use_viewdir=True, encode_t=encode_t, output_flow=flow,
                vis_in=vis_in)
            args = (fn.pack(fine), o, d, zs, vis, de, None,
                    te if encode_t else None)
            got = rk.planar_eval_comp_cuda(*args, **fn.kernel_kw)
            torch.cuda.synchronize()
            want = plain_by_rays(torch, rk.planar_eval_comp_ref, args,
                                 fn.kernel_kw)
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()) or err > TOL:
                fail(f"planar_eval_comp at S={S} n={n} (encode_t "
                     f"{encode_t}): max abs err {err} (tol {TOL})")
            note("planar_eval_comp", S, err)

    def check_b2_b3(n, S):
        o, d, zs, flows, de, te = inputs(n, S)
        main_op = rk.make_planar_nerf_train(S, use_viewdir=True,
                                            output_flow=("fw", "bw"))
        pw = main_op.pack(fine)
        planes = {}
        for label, static_branch, flow_in, flow in (
                ("main", True, False, ("fw", "bw")),
                ("fw warp", False, True, ("bw",)),
                ("bw warp", False, True, ("fw",)),
                ("stacked warp", False, True, ("fw", "bw"))):
            op = rk.make_planar_nerf_train(S, static_branch=static_branch,
                                           flow_in=flow_in, use_viewdir=True,
                                           output_flow=flow)
            args = (pw, o, d, zs, flows if flow_in else None,
                    de if static_branch else None, None, te)
            kw = op.kernel_kw
            got = rk.planar_nerf_train_fwd_cuda(*args, **kw)
            torch.cuda.synchronize()
            want = rk.planar_nerf_train_ref(*args, **kw)
            err = (got - want).abs()
            share = float((err > 1e-5).float().mean())
            err = float(err.max())
            if not bool(torch.isfinite(got).all()) or err > PLANE_TOL \
                    or share > PLANE_SHARE:
                fail(f"planar_nerf_train forward [{label}] at S={S} n={n}: "
                     f"max abs err {err} (tol {PLANE_TOL}), share off by "
                     f"more than 1e-5 {share} (tol {PLANE_SHARE})")
            note("planar_nerf_train_fwd", S, err)
            planes[label] = dict(zip(op.out_keys, got))
            if label == "bw warp":
                continue  # its backward is the fw warp's, other heads
            cot = {k: torch.randn((n, S), generator=gen, device="cuda")
                   for k in op.out_keys}
            bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                      "flow_scale", "D", "skips")}
            for branch in (["static"] if static_branch else []) + [
                    "transient"]:
                got_b = rk.planar_nerf_train_bwd_cuda(branch, *args, cot,
                                                      **bkw)
                torch.cuda.synchronize()
                want_b = rk.planar_nerf_train_bwd_ref(branch, *args, cot,
                                                      **bkw)
                pairs = [(f"{k}.{p}", got_b["dws"][k][p], want_b["dws"][k][p])
                         for k in want_b["dws"] for p in ("w", "b")]
                pairs += [(k, got_b[k], want_b[k]) for k in ("ddir", "dt")
                          if k in want_b]
                pairs += [(f"dflow{c}", got_b["dflows"][c],
                           want_b["dflows"][c])
                          for c in range(3) if "dflows" in want_b]
                if not all(bool(torch.isfinite(a).all()) for _, a, _ in pairs):
                    fail(f"planar_nerf_train backward ({branch}, {label}) "
                         f"not finite at S={S} n={n}")
                errs = {k: rel_errs(a, b) for k, a, b in pairs}
                per_sample = [k for k in errs if k.startswith("dflow")]
                g_max, k_max, g_fro, k_fro, abs_err = grad_verdict(
                    errs, per_sample)
                r_mean = r_max = 0.0
                if "dflows" in want_b:
                    exact = unrounded_dflows(torch, args, kw, cot,
                                             op.out_keys)
                    for c in range(3):
                        rm, rx = unrounded_ratios(
                            got_b["dflows"][c], want_b["dflows"][c],
                            exact[c], (0, 1))
                        r_mean, r_max = max(r_mean, rm), max(r_max, rx)
                held = g_max <= GRAD_MAX and g_fro <= GRAD_FRO
                if not held or r_mean > EXACT_MEAN or r_max > EXACT_MAX:
                    fail(f"planar_nerf_train backward ({branch}, {label}) at "
                         f"S={S} n={n}: worst error/max {g_max:.3e} "
                         f"({k_max}), Frobenius {g_fro:.3e} ({k_fro}) (tol "
                         f"{GRAD_MAX}, {GRAD_FRO}); dflow distance to the "
                         f"unrounded model over the plain version's: mean "
                         f"{r_mean:.3f}, largest {r_max:.3f} (tol "
                         f"{EXACT_MEAN}, {EXACT_MAX})")
                note(f"planar_nerf_train_bwd_{branch}", S, abs_err, g_max)
        # B3 on the three evaluations' planes
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
        bwd = [rel_errs(dg[i], rdg[i]) for i in range(len(dg))]
        bwd_err = max(e[0] for e in bwd)
        if not (bool(torch.isfinite(dg).all()) and fwd_err <= COMP_TOL
                and bwd_err <= COMP_TOL):
            fail(f"planar_compositor at S={S} n={n}: forward max abs err "
                 f"{fwd_err}, adjoint worst error/max {bwd_err} (tol "
                 f"{COMP_TOL})")
        note("planar_compositor_fwd", S, fwd_err)
        note("planar_compositor_bwd", S, max(e[2] for e in bwd), bwd_err)

    def check_b5(n, S):
        o, d, zs, _, de, te = inputs(n, S)
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        for static_branch, encode_t, flow in ((True, True, ("fw", "bw")),
                                              (True, False, ())):
            fn = mk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                         encode_t=encode_t, output_flow=flow,
                                         static_branch=static_branch)
            args = (fn.pack(fine), xyz, de, None, te if encode_t else None)
            got = mk.fused_nerf_eval_cuda(*args, **fn.kernel_kw)
            torch.cuda.synchronize()
            want = plain_by_rays(torch, mk.fused_nerf_eval_ref, args,
                                 fn.kernel_kw)
            err = (got - want).abs()
            worst_e = float(err.max())
            share = float((err.amax(-1) > 1e-5).float().mean())
            unused = list(range(8 + 3 * len(flow) if encode_t else 4, 16))
            if not bool(torch.isfinite(got).all()) or worst_e > PACKED_TOL \
                    or share > PACKED_SHARE or bool(got[..., unused].any()):
                fail(f"fused_nerf_eval at S={S} n={n} (encode_t {encode_t}): "
                     f"max abs err {worst_e} (tol {PACKED_TOL}), rows off by "
                     f"more than 1e-5 {share} (tol {PACKED_SHARE}), unused "
                     f"columns zero: {not bool(got[..., unused].any())}")
            note("fused_nerf_eval", S, worst_e)

    def check_b4_b6(n, S):
        o, d, zs, _, de, te = inputs(n, S)
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        g = torch.randn((n, S, 16), generator=gen, device="cuda")
        packed = None
        for label, static_branch, flow, branch, need_dxyz in (
                ("main", True, ("fw", "bw"), "static", False),
                ("main", True, ("fw", "bw"), "transient", False),
                ("fw warp", False, ("bw",), "transient", True)):
            op = mtk.make_fused_nerf_train(S, use_viewdir=True, encode_a=False,
                                           encode_t=True, output_flow=flow,
                                           static_branch=static_branch,
                                           need_dxyz=need_dxyz)
            pw, kw = op.pack(fine), op.kernel_kw
            if packed is None:
                packed = mk.fused_nerf_eval_cuda(pw, xyz, de, None, te, **kw)
            bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                      "output_flow", "flow_scale", "D",
                                      "skips")}
            args = (branch, pw, xyz, de if static_branch else None, None, te,
                    g)
            got = mtk.fused_nerf_train_bwd_cuda(*args, need_dxyz=need_dxyz,
                                                **bkw)
            torch.cuda.synchronize()
            want = mtk.fused_nerf_train_bwd_ref(*args, need_dxyz=need_dxyz,
                                                **bkw)
            pairs = [(f"{k}.{p}", got["dws"][k][p], want["dws"][k][p])
                     for k in want["dws"] for p in ("w", "b")]
            pairs += [(k, got[k], want[k]) for k in ("ddir", "dt", "dxyz")
                      if k in want]
            if not all(bool(torch.isfinite(a).all()) for _, a, _ in pairs):
                fail(f"fused_nerf_train backward ({branch}, {label}) not "
                     f"finite at S={S} n={n}")
            errs = {k: rel_errs(a, b) for k, a, b in pairs}
            g_max, k_max, g_fro, k_fro, abs_err = grad_verdict(errs,
                                                               ["dxyz"])
            dx = errs["dxyz"][0] if need_dxyz else 0.0
            if not (g_max <= GRAD_MAX and g_fro <= GRAD_FRO and dx <= DX_MAX):
                fail(f"fused_nerf_train backward ({branch}, {label}) at "
                     f"S={S} n={n}: worst error/max {g_max:.3e} ({k_max}), "
                     f"Frobenius {g_fro:.3e} ({k_fro}), dxyz error/max "
                     f"{dx:.3e} (tol {GRAD_MAX}, {GRAD_FRO}, {DX_MAX})")
            note(f"fused_nerf_train_bwd_{branch}", S, abs_err, max(g_max, dx))
        # B6 on the main evaluation's packed output; a third of the rays
        # opaque at their far sample
        packed = packed.clone()
        packed[::3, -1, 3] = 2000.0
        ns, nt = (torch.randn((n, S), generator=gen, device="cuda")
                  for _ in range(2))
        cot = {k: torch.randn((n, S), generator=gen, device="cuda")
               for k in fck.OUT_KEYS}
        gmap = torch.randn((n, 4), generator=gen, device="cuda")
        cargs = (packed, zs, ns, nt)
        planes, maps = fck.fused_compositing_fwd_cuda(*cargs)
        dp = fck.fused_compositing_bwd_cuda(*cargs, cot, gmap)
        torch.cuda.synchronize()
        rplanes, rmaps = fck.fused_compositing_fwd_ref(*cargs)
        rdp = fck.fused_compositing_bwd_ref(*cargs, cot, gmap)
        fwd_err = max(float((planes - rplanes).abs().max()),
                      float((maps - rmaps).abs().max()))
        bwd = [rel_errs(dp[..., c], rdp[..., c]) for c in range(8)]
        bwd_err = max(e[0] for e in bwd)
        if not bool(torch.isfinite(dp).all()) or bool(dp[..., 8:].any()) \
                or fwd_err > COMP_TOL or bwd_err > COMP_TOL:
            fail(f"fused_compositing at S={S} n={n}: forward max abs err "
                 f"{fwd_err}, adjoint worst error/max {bwd_err} (tol "
                 f"{COMP_TOL}), finite {bool(torch.isfinite(dp).all())}, "
                 f"columns 8-15 zero {not bool(dp[..., 8:].any())}")
        note("fused_compositing_fwd", S, fwd_err)
        note("fused_compositing_bwd", S, max(e[2] for e in bwd), bwd_err)

    t0 = time.perf_counter()
    for S, only in TIMED_S.items():
        if only is None:
            check_b1(CHUNK, S)
            check_b5(CHUNK, S)
            check_b4_b6(BATCH, S)
        check_b2_b3(BATCH, S)
        torch.cuda.empty_cache()
    names = sorted({k for k, _ in worst})
    print("sample sweep: largest abs error by kernel and S (B1 and B5 at "
          f"{CHUNK} rays, the rest at {BATCH}; every check within the S = "
          "128 tolerances) " + json.dumps(
              {k: {str(S): v for (n, S), v in worst.items() if n == k}
               for k in names})
          + "; largest error over a leaf's largest entry of the backward "
          "calls " + json.dumps({f"{k}@{S}": v for (k, S), v in rel.items()})
          + f" ({time.perf_counter() - t0:.1f} s) on {card}", flush=True)
    return {S: sweep_records(torch, params, rays, S, only, worst, rel, card)
            for S, only in TIMED_S.items()}


def sweep_records(torch, params, rays, S, only, worst, rel, card):
    """The kernel records at S samples (`only`: these kernels; None: all
    eleven), timed at the main paths' shapes: B1 (both towers, the serving
    configuration) and B5 (full) at the serving chunk, the rest at batch
    512; each with the sweep's largest error at S, its plain version's ms
    and its bound at the call's real samples."""
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
    from nsff_pl_tpu_torch.ops.posenc import posenc

    fine = params["nerf_fine"]
    gen = torch.Generator(device="cuda").manual_seed(20 + S)
    records = {}

    def want(name):
        return only is None or name in only

    def add(name, fn, plain, flops, nbytes, peak=PEAK_BF16_FLOPS, graph=True,
            iters=5, n=BATCH):
        ms = cuda_ms(torch, fn, iters=iters, graph=graph)
        plain_ms = cuda_ms(torch, plain, iters=1, warmup=0 if not graph
                           else 1)
        rec = _record(at_samples(name, S), *_src_of(name), worst[name, S],
                      ms, plain_ms, flops, nbytes, peak)
        if (name, S) in rel:
            rec["max_rel_err"] = rel[name, S]
        records[name] = rec
        print(f"kernel {rec['name']} n={n}: {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) on {card}", flush=True)

    def rays_of(n):
        o, d = rays[:n, :3].contiguous(), rays[:n, 3:].contiguous()
        zs = torch.sort(torch.rand((n, S), generator=gen, device="cuda"),
                        1).values.contiguous()
        te = params["embedding_t"][torch.randint(
            0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
        return o, d, zs, posenc(d, 3.0, 4).contiguous(), te

    if want("planar_eval_comp"):
        o, d, zs, de, te = rays_of(CHUNK)
        fn = rk.make_planar_nerf_eval_comp(S, use_viewdir=True, encode_t=True)
        pw = fn.pack(fine)
        args, kw = (pw, o, d, zs, None, de, None, te), fn.kernel_kw
        add("planar_eval_comp", lambda: rk.planar_eval_comp_cuda(*args, **kw),
            lambda: plain_by_rays(torch, rk.planar_eval_comp_ref, args, kw),
            *eval_comp_work(fine, kw, CHUNK, S, pw), graph=False, iters=3,
            n=CHUNK)
    if want("fused_nerf_eval"):
        o, d, zs, de, te = rays_of(CHUNK)
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        fn = mk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                     encode_t=True, output_flow=("fw", "bw"))
        pw = fn.pack(fine)
        args, kw = (pw, xyz, de, None, te), fn.kernel_kw
        add("fused_nerf_eval", lambda: mk.fused_nerf_eval_cuda(*args, **kw),
            lambda: plain_by_rays(torch, mk.fused_nerf_eval_ref, args, kw),
            *train_fwd_work(fine, True, 2, CHUNK, S, pw, 16, False,
                            packed=True), graph=False, iters=3, n=CHUNK)
        del xyz
    torch.cuda.empty_cache()
    n = BATCH
    o, d, zs, de, te = rays_of(n)
    op = rk.make_planar_nerf_train(S, use_viewdir=True,
                                   output_flow=("fw", "bw"))
    pw, kw = op.pack(fine), op.kernel_kw
    args = (pw, o, d, zs, None, de, None, te)
    add("planar_nerf_train_fwd",
        lambda: rk.planar_nerf_train_fwd_cuda(*args, **kw),
        lambda: rk.planar_nerf_train_ref(*args, **kw),
        *train_fwd_work(fine, True, 2, n, S, pw, len(op.out_keys), False))
    planes = dict(zip(op.out_keys, rk.planar_nerf_train_fwd_cuda(*args,
                                                                 **kw)))
    cot = {k: torch.randn((n, S), generator=gen, device="cuda")
           for k in op.out_keys}
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale", "D", "skips")}
    for branch in ("static", "transient"):
        add(f"planar_nerf_train_bwd_{branch}",
            lambda b=branch: rk.planar_nerf_train_bwd_cuda(b, *args, cot,
                                                           **bkw),
            lambda b=branch: rk.planar_nerf_train_bwd_ref(b, *args, cot,
                                                          **bkw),
            *train_bwd_work(fine, branch, 2, n, S, pw, False))
    if want("planar_compositor_fwd"):
        ins = {"zs": zs, "ssig": planes["ssig"]}
        for k in ("tsig", "tsig_w1", "tsig_w2"):
            ins[k] = planes["tsig"]
        for k in ("ns", "nt", "nw1", "nw2"):
            ins[k] = torch.randn((n, S), generator=gen, device="cuda")
        for c in "rgb":
            ins[f"srgb_{c}"] = planes[f"srgb_{c}"]
            for k in ("trgb", "trgb_w1", "trgb_w2"):
                ins[f"{k}_{c}"] = planes[f"trgb_{c}"]
        ins = {k: v.contiguous() for k, v in ins.items()}
        ccot = {k: torch.randn((n, S), generator=gen, device="cuda")
                for k in tck.OUT_KEYS}
        gmap = torch.randn((n, tck.N_MAP), generator=gen, device="cuda")
        for which, fn, ref in (
                ("fwd", lambda: tck.planar_compositor_fwd_cuda(ins),
                 lambda: tck.planar_compositor_fwd_ref(ins)),
                ("bwd", lambda: tck.planar_compositor_bwd_cuda(ins, ccot,
                                                               gmap),
                 lambda: tck.planar_compositor_bwd_ref(ins, ccot, gmap))):
            add(f"planar_compositor_{which}", fn, ref,
                *comp_work(which, n, S), peak=PEAK_F32_FLOPS, iters=100)
    if want("fused_nerf_train_bwd_static"):
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        pop = mtk.make_fused_nerf_train(S, use_viewdir=True, encode_a=False,
                                        encode_t=True,
                                        output_flow=("fw", "bw"),
                                        need_dxyz=False)
        ppw, pkw = pop.pack(fine), pop.kernel_kw
        pbkw = {k: pkw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                    "output_flow", "flow_scale", "D",
                                    "skips")}
        g = torch.randn((n, S, 16), generator=gen, device="cuda")
        for branch in ("static", "transient"):
            pargs = (branch, ppw, xyz, de, None, te, g)
            add(f"fused_nerf_train_bwd_{branch}",
                lambda a=pargs: mtk.fused_nerf_train_bwd_cuda(
                    *a, need_dxyz=False, **pbkw),
                lambda a=pargs: mtk.fused_nerf_train_bwd_ref(
                    *a, need_dxyz=False, **pbkw),
                *train_bwd_work(fine, branch, 2, n, S, ppw, False,
                                packed=True))
        packed = mk.fused_nerf_eval_cuda(ppw, xyz, de, None, te, **pkw)
        ns, nt = (torch.randn((n, S), generator=gen, device="cuda")
                  for _ in range(2))
        fcot = {k: torch.randn((n, S), generator=gen, device="cuda")
                for k in fck.OUT_KEYS}
        fgmap = torch.randn((n, 4), generator=gen, device="cuda")
        cargs = (packed, zs, ns, nt)
        for which, fn, ref in (
                ("fwd", lambda: fck.fused_compositing_fwd_cuda(*cargs),
                 lambda: fck.fused_compositing_fwd_ref(*cargs)),
                ("bwd", lambda: fck.fused_compositing_bwd_cuda(*cargs, fcot,
                                                               fgmap),
                 lambda: fck.fused_compositing_bwd_ref(*cargs, fcot,
                                                       fgmap))):
            add(f"fused_compositing_{which}", fn, ref,
                *packed_comp_work(which, n, S), peak=PEAK_F32_FLOPS,
                iters=100)
    torch.cuda.empty_cache()
    return records


def tail_tile_line(records_128, sweep_records_, records_256, card):
    """ROADMAP B-d's starting figure: each tower kernel's time at 96
    samples (one tile, 96 of its 128 rows used) and at 320 (three tiles,
    64 rows of the last used) against its time at 128 and 256 in this run,
    beside the ratio of real samples."""
    out = {}
    for name, rec in sweep_records_[S96].items():
        base = records_128.get(name)
        big = sweep_records_[C2F2_FINE].get(name)
        two = records_256.get(name)
        if base is None or big is None:
            continue
        out[name] = {"ms@96 / ms@128": rec["ms"] / base["ms"],
                     "ms@320 / ms@128": big["ms"] / base["ms"]}
        if two is not None:
            out[name]["ms@320 / ms@256"] = big["ms"] / two["ms"]
    print("tail tiles: " + json.dumps(out) + " (samples 96 / 128 = 0.75, "
          "320 / 128 = 2.5, 320 / 256 = 1.25; tiles 1, 3 / 1, 3 / 2) on "
          f"{card}", flush=True)


def samples_paths_phase(torch, np, tcfg, cfg, table, Ks, Ps, K, poses, card):
    """The main paths at sample counts outside the old {64, 128, 192, 256}:
    the recipe at --N_samples 96 on the planar path (TRAIN_STEPS eager
    steps and the same steps graphed; launches PER_STEP_96; one step at
    batch 64 against the CPU) and on the packed path with the fused
    compositor (STATIC_STEPS steps, PER_STEP_PACKED_96); the
    coarse-to-fine recipe --N_samples 64 --N_importance 128 on the planar
    path (TRAIN_STEPS steps, PER_STEP_C2F2) and the packed one
    (STATIC_STEPS steps, PER_STEP_PACKED_C2F2); each run's graphed steps
    equal to its eager steps bit for bit; a 512x288 `render_pose`
    frame of both towers at each recipe on B1 and, with
    `planar_eval="off"`, on B5 (the c2f coarse pass on B2's forward at 64
    and the bf16 plain evaluators). Returns the launches of its runs."""
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import build_params

    ran = {}

    def add(counts):
        for k, v in counts.items():
            ran[k] = ran.get(k, 0) + v

    runs = (
        ("S96 training", tcfg.replace(N_samples=S96), PER_STEP_96, True,
         TRAIN_STEPS),
        ("S96 packed training", tcfg.replace(
            N_samples=S96, fused_train="off", fused_compositing=True),
         PER_STEP_PACKED_96, False, STATIC_STEPS),
        ("c2f 64+128 training", tcfg.replace(N_samples=C2F2_S,
                                             N_importance=C2F2_NI),
         PER_STEP_C2F2, True, TRAIN_STEPS),
        ("c2f 64+128 packed training", tcfg.replace(
            N_samples=C2F2_S, N_importance=C2F2_NI, fused_train="off",
            fused_compositing=True), PER_STEP_PACKED_C2F2, False,
         STATIC_STEPS))
    for label, rcfg, per_step, planar, steps in runs:
        counts, graph_counts, ms, graph_ms = training_phase(
            torch, np, rcfg, table, Ks, Ps, card, label=label,
            per_step=per_step, planar=planar, steps=steps, repeat=False,
            exact=True)
        add(counts)
        add(graph_counts)
        print(f"{label}: {ms:.3f} ms per step eager, {graph_ms:.3f} ms "
              f"graphed on {card}", flush=True)
        if label == "S96 training":
            train_agreement(torch, rcfg, table, Ks, Ps, label)
        torch.cuda.empty_cache()

    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    for label, scfg, expected in (
            ("S96 serving", cfg.replace(N_samples=S96),
             {f"planar_eval_comp@{S96}": 1}),
            ("S96 packed serving", cfg.replace(N_samples=S96,
                                               planar_eval="off"),
             {f"fused_nerf_eval@{S96}": 1}),
            ("c2f 64+128 serving", cfg.replace(N_samples=C2F2_S,
                                               N_importance=C2F2_NI),
             {f"planar_nerf_train_fwd@{C2F2_S}": 1,
              f"planar_eval_comp@{C2F2_FINE}": 1}),
            ("c2f 64+128 packed serving", cfg.replace(
                N_samples=C2F2_S, N_importance=C2F2_NI, planar_eval="off"),
             {f"fused_nerf_eval@{C2F2_FINE}": 1})):
        params = build_params(scfg, torch.Generator().manual_seed(0),
                              device="cuda")
        svc = RenderService(params, K, poses, (W_IMG, H_IMG), scfg,
                            chunk=CHUNK, device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rgb, depth = svc.render_pose(3)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        add(counts)
        print(f"{label}: one {W_IMG}x{H_IMG} frame of both towers in "
              f"{secs:.6f} s, launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + f" on {card}", flush=True)
        check_counts(counts, expected, n_chunks, label)
        if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG) \
                or not np.isfinite(depth).all():
            fail(f"{label}: bad frame")
        rgbf = svc.render_maps(3)["rgb_fine"]
        if not bool(torch.isfinite(rgbf).all()) or float(rgbf.min()) < 0 \
                or float(rgbf.max()) > 1:
            fail(f"{label}: rgb_fine not finite or outside [0, 1]")
        del svc, params
        torch.cuda.empty_cache()
    return ran


def samples_eval_phase(torch, np, card):
    """The eval CLI's test split at --N_samples 96 with
    --output_transient on the scene training phase's checkpoint (trained
    at 128: the weights take any S): one graph replay a frame, B1 at 96
    once a chunk, frame 0 equal to the host loop's within GRAPH_TOL,
    finite PSNR. Returns the launches the card ran."""
    import os

    base = eval_base()
    here = os.getcwd()
    os.makedirs(EVAL_DIR, exist_ok=True)
    os.chdir(EVAL_DIR)
    try:
        rep, ran, _ = eval_split(
            torch, np, card, "test --N_samples 96",
            base + ["--N_samples", str(S96), "--split", "test",
                    "--output_transient", "--scene_name", "test_s96"],
            {f"planar_eval_comp@{S96}": 1}, N_FRAMES)
        err = graphed_equals_loop(torch, np, rep.render, rep.params,
                                  rep.dataset, (0,), True)
        psnr = np.nanmean(rep.psnr, 0)
        print(f"eval test --N_samples 96: mean PSNR whole / dynamic "
              f"{psnr.tolist()}; frame 0 graphed against the host loop's "
              f"max abs err {err:.3e} (tol {GRAPH_TOL})", flush=True)
        if err > GRAPH_TOL or not np.isfinite(psnr).all():
            fail("eval --N_samples 96: the graphed frame differs from the "
                 "host loop's or the PSNR is not finite")
    finally:
        os.chdir(here)
    return ran


# ---------------- input widths past the flagship's (main paths) ----------------

# the packed evaluator past one 128-lane input segment: two resident
# segments (B5's wide instance), the time latent at 80 (143 lanes) and 22
# posenc frequencies (135 lanes); three and more (its streamed instance),
# the time latent at 200 (263 lanes), 43 frequencies (309), both (461,
# four segments), the time latent at 321 (384, three segments exactly);
# the direction and appearance embeddings past one segment at 143 lanes;
# and 17 frequencies (113 lanes with N_tau 8) on every tower kernel, once
# refused by a 16-frequency cap
WIDE = ({"N_tau": 80}, {"N_emb_xyz": 22})
WIDER = ({"N_tau": 200}, {"N_emb_xyz": 43}, {"N_emb_xyz": 43, "N_tau": 200},
         {"N_tau": 321},
         {"N_tau": 80, "N_emb_dir": 22, "encode_a": True, "N_a": 160})
# the widths also trained on the plain evaluators (`plain_steps`)
XLA_WIDTHS = WIDE + ({"N_tau": 200},)
FREQ17 = {"N_emb_xyz": 17, "N_tau": 8}
WIDE_STEPS = 3


def widths_of(cfg):
    """The model's input widths as the kernel builders' keywords; the
    direction and appearance embeddings' where they are not the
    flagship's."""
    w = {"n_emb_xyz": cfg.N_emb_xyz, "n_tau": cfg.N_tau}
    if cfg.N_emb_dir != 4 or cfg.encode_a:
        w["n_emb_dir"] = cfg.N_emb_dir
    if cfg.encode_a:
        w["n_a"] = cfg.N_a
    return w


def b1_at_widths(torch, np, rk, params, rays, widths, card):
    """B1 at the serving chunk on a model of the given input widths against
    its plain version (TOL), timed; its kernel record."""
    from nsff_pl_tpu_torch.ops.posenc import posenc

    n, S = CHUNK, 128
    gen = torch.Generator(device="cuda").manual_seed(9)
    o, d = rays[:n, :3].contiguous(), rays[:n, 3:].contiguous()
    zs = torch.linspace(0, 1, S, device="cuda").expand(n, S).contiguous()
    de = posenc(d, 3.0, 4).contiguous()
    te = params["embedding_t"][torch.randint(
        0, N_FRAMES, (n,), generator=gen, device="cuda")].contiguous()
    fn = rk.make_planar_nerf_eval_comp(S, use_viewdir=True, encode_t=True,
                                       **widths)
    pw = fn.pack(params["nerf_fine"])
    args = (pw, o, d, zs, None, de, None, te)
    got = rk.planar_eval_comp_cuda(*args, **fn.kernel_kw)
    torch.cuda.synchronize()
    want = rk.planar_eval_comp_ref(*args, **fn.kernel_kw)
    name = "planar_eval_comp" + wtag(widths)
    err = float((got - want).abs().max())
    print(f"kernel {name} n={n} S={S}: max abs err {err:.2e} (tol {TOL})",
          flush=True)
    if not bool(torch.isfinite(got).all()) or err > TOL:
        fail(f"{name} disagrees with its plain version")
    del got, want
    ms = cuda_ms(torch, lambda: rk.planar_eval_comp_cuda(
        *args, **fn.kernel_kw), iters=5)
    plain_ms = cuda_ms(torch, lambda: rk.planar_eval_comp_ref(
        *args, **fn.kernel_kw), iters=2)
    flops, nbytes = eval_comp_work(params["nerf_fine"], fn.kernel_kw, n, S,
                                   pw)
    rec = _record(name, "nsff_pl_tpu_torch/csrc/planar_eval_comp.cu",
                  "nsff_pl_tpu/ops/raymarch_kernel.py:728", err, ms, plain_ms,
                  flops, nbytes)
    print(f"kernel {name} n={n}: {ms:.3f} ms "
          f"({rate_line(flops, ms, rec['bound_ms'])}), plain {plain_ms:.3f} "
          f"ms, bound {rec['bound_ms']:.3f} ms on {card}", flush=True)
    return rec


def narrow_b5_ms(torch, params, rays):
    """B5's one-segment instance at the serving chunk (full), device ms."""
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops.posenc import posenc

    n = CHUNK
    o, d = rays[:n, :3], rays[:n, 3:]
    z = torch.linspace(0, 1, 128, device="cuda")
    xyz = (o[:, None] + d[:, None] * z[:, None]).contiguous()
    fn = mk.make_fused_nerf_eval(128, use_viewdir=True, encode_a=False,
                                 encode_t=True, output_flow=("fw", "bw"))
    te = params["embedding_t"][torch.arange(n, device="cuda") % N_FRAMES]
    args = (fn.pack(params["nerf_fine"]), xyz, posenc(d, 3.0, 4).contiguous(),
            None, te.contiguous())
    return cuda_ms(torch, lambda: mk.fused_nerf_eval_cuda(
        *args, **fn.kernel_kw), iters=5)


def wide_kernel_phase(torch, np, cfg, params, rays, card):
    """The kernels at the slice's widths against their plain versions: B5's
    wide instance at both WIDE widths and its streamed instance at the
    WIDER ones (the wide embeddings on the wide instance), at the serving
    chunk (full, static only, transient only, a ragged count;
    `packed_kernel_phase`); at FREQ17, B1 at the serving chunk, B2's
    forward and backward and B3 at batch 512 (`train_kernel_phase`), B5 at
    the serving chunk, B4 and B6 at batch 512 (`packed_kernel_phase`),
    with the flagship's tolerances, each timed beside its plain version
    and its bound. The one-segment B5 (the flagship `params`) is timed
    before and after, and the two-segment instance in the same call.
    Returns the records by name (launches filled in by
    `wide_paths_phase`)."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
    from nsff_pl_tpu_torch.ops import raymarch_kernel as rk

    before = narrow_b5_ms(torch, params, rays)
    records = []
    for over in WIDE + WIDER:
        wcfg = cfg.replace(**over)
        wp = build_params(wcfg, torch.Generator().manual_seed(0),
                          device="cuda")
        records += packed_kernel_phase(torch, np, wp, rays, card,
                                       widths=widths_of(wcfg)).values()
        del wp
        torch.cuda.empty_cache()
    after = narrow_b5_ms(torch, params, rays)
    print(f"kernel fused_nerf_eval (one segment) n={CHUNK}: {before:.3f} ms "
          f"before the wide instance's runs, {after:.3f} ms after, on "
          f"{card}", flush=True)
    fcfg = cfg.replace(**FREQ17)
    fp = build_params(fcfg, torch.Generator().manual_seed(0), device="cuda")
    w = widths_of(fcfg)
    records.append(b1_at_widths(torch, np, rk, fp, rays, w, card))
    records += train_kernel_phase(torch, np, rk, tck, fp, rays, card,
                                  widths=w).values()
    records += packed_kernel_phase(torch, np, fp, rays, card,
                                   widths=w).values()
    torch.cuda.empty_cache()
    return {r["name"]: r for r in records}


def plain_steps(torch, np, cfg, table, Ks, Ps, card, label,
                steps=WIDE_STEPS):
    """`steps` eager steps of the recipe `cfg` on the plain evaluators
    (`train_backend='xla'`, as the JAX package trains widths its kernels'
    gradients refuse): no kernel launch, finite loss terms, the params
    changed; returns the device ms a step."""
    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
    from nsff_pl_tpu_torch.training.optim import param_leaves

    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    state, step = train_setup(torch, cfg, params, "cuda", BATCH)
    if step.use_planar:
        fail(f"{label}: took the planar path")
    batcher = RayBatcher(table, BATCH, device="cuda")
    sched = FrameScheduler(N_FRAMES, seed=cfg.seed)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    before = [p.detach().clone() for p in param_leaves(state.params)]
    args = (batcher.table, batcher.weights, Ks, Ps, gen)
    state, m, _ = step(state, *args, sched.next())  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    rows = []
    ev0.record()
    for _ in range(steps):
        state, m, _ = step(state, *args, sched.next())
        rows.append({k: float(v) for k, v in m.items()})
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / steps
    check_counts(launch_counts(), {}, steps, label)
    print(f"{label}: {steps} eager steps at batch {BATCH} on the plain "
          f"evaluators, {ms:.3f} ms per step (CUDA events), loss "
          + json.dumps([round(r["loss"], 6) for r in rows])
          + f", no kernel launch, on {card}", flush=True)
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        fail(f"{label}: loss terms not finite")
    if all(bool(torch.equal(a, b)) for a, b in
           zip(before, param_leaves(state.params))):
        fail(f"{label}: params did not change")
    return ms


def served_frame(torch, np, params, K, poses, cfg, expected, card, label):
    """One 512x288 `render_pose` frame at chunk CHUNK with the launch counts
    read around it (`expected` per frame); returns its float maps."""
    from nsff_pl_tpu_torch.apps.serve import RenderService

    svc = RenderService(params, K, poses, (W_IMG, H_IMG), cfg, chunk=CHUNK,
                        device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rgb, depth = svc.render_pose(0)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    print(f"{label}: one {W_IMG}x{H_IMG} frame in {secs:.6f} s, launches "
          + json.dumps({k: v for k, v in counts.items() if v})
          + f" on {card}", flush=True)
    check_counts(counts, expected, 1, label)
    if rgb.shape != (H_IMG, W_IMG, 3) or depth.shape != (H_IMG, W_IMG) \
            or not np.isfinite(depth).all():
        fail(f"{label}: bad frame")
    maps = svc.render_maps(0)
    rgbf = maps["rgb_fine"]
    if not bool(torch.isfinite(rgbf).all()) or float(rgbf.min()) < 0 \
            or float(rgbf.max()) > 1:
        fail(f"{label}: rgb_fine not finite or outside [0, 1]")
    return maps


def _frame_err(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in ("rgb_fine", "depth_fine"))


def wide_paths_phase(torch, np, tcfg, cfg, table, Ks, Ps, K, poses, card):
    """The slice's main paths. At each WIDE and WIDER width: a 512x288
    frame served with `planar_eval="off"` in bfloat16 (B5's wide or
    streamed instance once a chunk) against the float32 frame of the
    plain evaluators (F32_TOL); at the XLA_WIDTHS, WIDE_STEPS steps of
    `--train_backend xla` (`plain_steps`). At FREQ17:
    the planar recipe (WIDE_STEPS eager steps, the same graphed, equal bit
    for bit; PER_STEP) and the packed one (PER_STEP_PACKED; the same), and a served frame on B1 against the one on B5
    (FRAME_TOL). Returns the launches of each record of
    `wide_kernel_phase` on these paths."""
    from nsff_pl_tpu_torch.config import build_params

    n_chunks = -(-W_IMG * H_IMG // CHUNK)
    ran = {}
    for over in WIDE + WIDER:
        scfg = cfg.replace(**over)
        tag = wtag(widths_of(scfg))
        params = build_params(scfg, torch.Generator().manual_seed(0),
                              device="cuda")
        bf = served_frame(torch, np, params, K, poses,
                          scfg.replace(planar_eval="off"),
                          {"fused_nerf_eval": n_chunks}, card,
                          f"wide serving{tag} [bfloat16, B5]")
        ran["fused_nerf_eval" + tag] = n_chunks
        f32 = served_frame(torch, np, params, K, poses,
                           scfg.replace(planar_eval="off", dtype="float32"),
                           {}, card, f"wide serving{tag} [float32]")
        err = _frame_err(bf, f32)
        print(f"wide serving{tag}: the bfloat16 frame against the float32 "
              f"one, max abs err {err:.3e} (tol {F32_TOL})", flush=True)
        if not err <= F32_TOL:
            fail(f"wide serving{tag}: B5's frame disagrees with float32")
        del params, bf, f32
        if over in XLA_WIDTHS:
            plain_steps(torch, np, tcfg.replace(train_backend="xla", **over),
                        table, Ks, Ps, card, f"wide training{tag} [xla]")
        torch.cuda.empty_cache()

    fcfg = tcfg.replace(**FREQ17)
    tag = wtag(widths_of(fcfg))
    for pcfg, per_step, planar in (
            (fcfg, PER_STEP, True),
            (fcfg.replace(fused_train="off", fused_compositing=True),
             PER_STEP_PACKED, False)):
        counts, gcounts, ms, gms = training_phase(
            torch, np, pcfg, table, Ks, Ps, card,
            label=f"training{tag} [{'planar' if planar else 'packed'}]",
            per_step=per_step, planar=planar, steps=WIDE_STEPS, repeat=False,
            exact=True)
        for name in per_step:
            ran[name + tag] = ran.get(name + tag, 0) + counts[name] + \
                gcounts[name]
    scfg = cfg.replace(**FREQ17)
    params = build_params(scfg, torch.Generator().manual_seed(0),
                          device="cuda")
    frames = {}
    for pe, name in (("auto", "planar_eval_comp"), ("off", "fused_nerf_eval")):
        frames[name] = served_frame(torch, np, params, K, poses,
                                    scfg.replace(planar_eval=pe),
                                    {name: n_chunks}, card,
                                    f"serving{tag} [{name}]")
        ran[name + tag] = ran.get(name + tag, 0) + n_chunks
    err = _frame_err(frames["planar_eval_comp"], frames["fused_nerf_eval"])
    print(f"serving{tag}: B1's frame against B5's, max abs err {err:.3e} "
          f"(tol {FRAME_TOL})", flush=True)
    if not err <= FRAME_TOL:
        fail(f"serving{tag}: B1's frame disagrees with B5's")
    torch.cuda.empty_cache()
    return ran


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
    # B2's stacked warp call and B3 at the gathered rows (the variants)
    stacked_records = {128: stacked_warp_kernels(torch, np, rk, tck, params,
                                                 rays, card, 128)}
    packed_records = packed_kernel_phase(torch, np, params, rays, card)
    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # B1, B2 and B3 at the coarse-to-fine fine pass's sample counts
    c2f_records = c2f_eval_comp_phase(torch, np, rk, params, rays, ts_all,
                                      K, poses, card)
    c2f_train_records = {S: train_kernel_phase(torch, np, rk, tck, params,
                                               rays, card, S=S)
                         for S in (C2F_FINE, 128 + C2F_NI)}
    stacked_records[C2F_FINE] = stacked_warp_kernels(
        torch, np, rk, tck, params, rays, card, C2F_FINE)
    torch.cuda.empty_cache()
    # B4, B5 and B6 at the packed c2f fine pass's sample counts
    # (at 192 the main paths run the static tower alone)
    packed_c2f_records = {S: packed_kernel_phase(
        torch, np, params, rays, card, S=S,
        main_case="full" if S == C2F_FINE else "static only")
        for S in (C2F_FINE, 128 + C2F_NI)}
    torch.cuda.empty_cache()
    phase_s["c2f kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # every kernel at any sample count, timed at the counts of the
    # --N_samples 96 and 64 + 128 paths
    sweep_recs = sample_sweep(torch, params, rays, K, poses, card)
    tail_tile_line(
        {"planar_eval_comp": record, **train_records, **packed_records},
        sweep_recs,
        {"planar_eval_comp": c2f_records[at_samples("planar_eval_comp",
                                                    C2F_FINE)],
         **c2f_train_records[C2F_FINE],
         **{k.split("@")[0]: v
            for k, v in packed_c2f_records[C2F_FINE].items()}}, card)
    torch.cuda.empty_cache()
    phase_s["sample sweep"] = time.perf_counter() - t_phase
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

    # ---------------- the train-path variants (main paths) ----------------
    var_ran, stacked_steps, gathered_steps, var_ms = variants_phase(
        torch, np, tcfg, table, Ks, Ps, card, (planar_ms, planar_graph_ms))
    print("variants: ms per step (eager, graphed) " + json.dumps(
        {k: [round(v, 4) for v in t] for k, t in var_ms.items()})
        + f", the exact Adam step {planar_ms:.4f} / {planar_graph_ms:.4f} "
        f"ms, on {card}", flush=True)
    phase_s["variants"] = time.perf_counter() - t_phase
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
    scene_ran, base_psnr = scene_training_phase(
        torch, np, card, {"planar": planar_graph_ms,
                          "packed": packed_graph_ms})
    record["launches"] += scene_ran["planar_eval_comp"]
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += scene_ran[name]
    phase_s["scene training"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- the variants through the train CLI ----------------
    cli_ran = variants_cli_phase(torch, np, card, base_psnr)
    phase_s["variants CLI"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- eval (a main path) ----------------
    eval_ran, eval_errs, spiral_s = eval_phase(torch, np, card)
    record["launches"] += eval_ran.get("planar_eval_comp", 0)
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += eval_ran.get(name, 0)
        # the worst error also covers the eval paths' inputs
        rec["max_abs_err"] = max(rec["max_abs_err"], eval_errs.get(name, 0))
    phase_s["eval"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- profiling and the serving tools (main paths) -------
    tools_ran = tools_phase(torch, np, card)
    record["launches"] += tools_ran.get("planar_eval_comp", 0)
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += tools_ran.get(name, 0)
    phase_s["tools"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- coarse-to-fine (main paths) ----------------
    # the training, serving, scene training and eval paths at
    # N_importance 64 (the kernels at their sample counts: above)
    c2f_ran = {}

    def add_c2f(ran):
        for k, v in ran.items():
            c2f_ran[k] = c2f_ran.get(k, 0) + v

    ccfg = tcfg.replace(N_importance=C2F_NI)
    c2f_counts, c2f_graph_counts, c2f_ms, c2f_graph_ms = training_phase(
        torch, np, ccfg, table, Ks, Ps, card, label="c2f training",
        per_step=PER_STEP_C2F, planar=True, exact=True)
    add_c2f(c2f_counts)
    add_c2f(c2f_graph_counts)
    print(f"c2f training: {c2f_ms:.3f} ms per step eager, "
          f"{c2f_graph_ms:.3f} ms graphed, against {planar_ms:.3f} / "
          f"{planar_graph_ms:.3f} ms at N_importance 0 in this run",
          flush=True)
    train_agreement(torch, ccfg, table, Ks, Ps, "c2f training")
    add_c2f(c2f_serving_phase(torch, np, cfg, K, poses, card))
    phase_s["c2f training and serving"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    scene_c2f_ran, path_errs = c2f_scene_phase(torch, np, card)
    add_c2f(scene_c2f_ran)
    for name, err in path_errs.items():  # B1 / B5 on the c2f eval inputs
        rec = (c2f_records.get(name) or packed_c2f_records[
            int(name.split("@")[1])][name])
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    phase_s["c2f scene and eval"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- packed coarse-to-fine (main paths) ----------------
    packed_c2f_ran, pc2f_ms, pc2f_graph_ms = packed_c2f_phase(
        torch, np, tcfg, cfg, table, Ks, Ps, K, poses, card)
    add_c2f(packed_c2f_ran)
    print(f"packed c2f training: {pc2f_ms:.3f} ms per step eager, "
          f"{pc2f_graph_ms:.3f} ms graphed, against {c2f_ms:.3f} / "
          f"{c2f_graph_ms:.3f} ms on the planar c2f path in this run",
          flush=True)
    # the packed c2f paths' records: the kernels those paths run at each
    # sample count, each launched by them
    packed_c2f_line = []
    for S, names in PACKED_C2F_KERNELS.items():
        for name in names:
            rec = packed_c2f_records[S][at_samples(name, S)]
            rec["launches"] = c2f_ran.get(rec["name"], 0)
            if rec["launches"] == 0:
                fail(f"{rec['name']}: no launch on the packed c2f paths")
            packed_c2f_line.append(rec)
    for name, rec in packed_records.items():
        rec["launches"] += c2f_ran.get(name, 0)
    phase_s["packed c2f"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- any sample count (main paths) ----------------
    samples_ran = samples_paths_phase(torch, np, tcfg, cfg, table, Ks, Ps, K,
                                      poses, card)
    for k, v in samples_eval_phase(torch, np, card).items():
        samples_ran[k] = samples_ran.get(k, 0) + v
    sweep_line = []
    for S, recs in sweep_recs.items():
        for name, rec in recs.items():
            rec["launches"] = samples_ran.get(f"{name}@{S}", 0)
            if rec["launches"] == 0:
                fail(f"{rec['name']}: no launch on the paths at {S} samples")
            sweep_line.append(rec)
    phase_s["any sample count"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- input widths past the flagship's (main paths) -------
    wide_recs = wide_kernel_phase(torch, np, cfg, params, rays, card)
    wide_ran = wide_paths_phase(torch, np, tcfg, cfg, table, Ks, Ps, K,
                                poses, card)
    wide_line = []
    for name, rec in wide_recs.items():
        rec["launches"] = wide_ran.get(name, 0)
        if rec["launches"] == 0:
            fail(f"{name}: no launch on the paths at its widths")
        wide_line.append(rec)
    phase_s["input widths"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    # each record's launches: at its sample count; the coarse passes (S =
    # 128) go to the S = 128 records
    by_s = {128 + C2F_NI: {}, C2F_FINE: {}}
    for S in by_s:
        by_s[S] = {**c2f_train_records[S]}
    by_s[C2F_FINE]["planar_eval_comp"] = c2f_records[
        at_samples("planar_eval_comp", C2F_FINE)]
    by_s[128 + C2F_NI]["planar_eval_comp"] = c2f_records[
        at_samples("planar_eval_comp", 128 + C2F_NI)]
    for name, rec in [("planar_eval_comp", record)] + list(
            train_records.items()):
        rec["launches"] += c2f_ran.get(name, 0)
        for S in by_s:
            # the export route's fine pass (tools (d)) runs B1 at 192 too
            by_s[S][name]["launches"] = (c2f_ran.get(f"{name}@{S}", 0)
                                         + tools_ran.get(f"{name}@{S}", 0))

    # ---------------- reproducibility across refreshes (C1) -------------
    c1_ran, c1_end = c1_phase(torch, np, card)
    record["launches"] += c1_ran["planar_eval_comp"]
    for name, rec in train_records.items():
        rec["launches"] += c1_ran[name]
    phase_s["C1"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- from video frames to a trained scene -------------
    frames_ran = frames_phase(torch, np, card)
    record["launches"] += frames_ran.get("planar_eval_comp", 0)
    for name, rec in train_records.items():
        rec["launches"] += frames_ran.get(name, 0)
    phase_s["frames"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---------------- data parallelism (main paths) -------------
    dp_ran = dp_phase(torch, np, tcfg, pcfg, table, Ks, Ps, card, c1_end,
                      cfg, params, K, poses, spiral_s)
    record["launches"] += dp_ran.get("planar_eval_comp", 0)
    for name, rec in list(train_records.items()) + list(
            packed_records.items()):
        rec["launches"] += dp_ran.get(name, 0)
    phase_s["data-parallel"] = time.perf_counter() - t_phase
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
    # the variants' launches: the stacked warp calls and the gathered
    # composites to their records, the rest to each kernel's record at its
    # sample count (the wi CLI runs: one stacked call and one gathered
    # composite a step)
    cli_steps = cli_ran.get("planar_nerf_train_bwd_static", 0)
    stacked_steps[128] += cli_steps
    gathered_steps += cli_steps
    stacked_line = []
    for S, recs in stacked_records.items():
        for name, rec in recs.items():
            rec["launches"] = (gathered_steps if "gathered" in name
                               else stacked_steps[S])
            if rec["launches"] == 0:
                fail(f"{rec['name']}: no launch on the variants' paths")
            stacked_line.append(rec)
    for S in (128, C2F_FINE):
        recs = train_records if S == 128 else by_s[S]
        for name, rec in recs.items():
            extra = (var_ran.get(at_samples(name, S), 0)
                     + (cli_ran.get(name, 0) if S == 128 else 0))
            if name in ("planar_nerf_train_fwd",
                        "planar_nerf_train_bwd_transient"):
                extra -= stacked_steps[S]
            elif name.startswith("planar_compositor") and S == 128:
                extra -= gathered_steps
            rec["launches"] += extra

    print("phase seconds " + json.dumps(
        {k: round(v, 3) for k, v in phase_s.items()}), flush=True)

    print(json.dumps({"kernels": [record] + list(train_records.values())
                      + list(packed_records.values())
                      + [r for S in (C2F_FINE, 128 + C2F_NI)
                         for r in by_s[S].values()]
                      + packed_c2f_line + stacked_line + sweep_line
                      + wide_line}),
          flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
