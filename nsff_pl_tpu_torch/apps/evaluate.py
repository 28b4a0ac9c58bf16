#!/usr/bin/env python
"""Evaluate / render a trained NSFF model on the card (port of
`nsff_pl_tpu/apps/evaluate.py`, the same flags plus `--device`):

    python -m nsff_pl_tpu_torch.apps.evaluate --root_dir <scene> \
        --img_wh 512 288 --start_end 0 30 --encode_t --use_viewdir \
        --dtype bfloat16 --ckpt_path ckpts/exp/step_4423 --split test

Splits:
    test                   render the training poses and times, with
                           PSNR / SSIM / LPIPS tables
    test_spiral            a spiral over the whole trajectory, time
                           advancing
    test_spiralX           a wander path around training pose X (time X)
    test_fixviewX_interpY  the view fixed at pose X, Y frames interpolated
                           between each pair of times (softmax splatting)

Writes per-frame PNGs (and depth PNGs with `--save_depth`), a GIF video
(mp4 needs ffmpeg, which the port does not use: the CLI says so and
writes the GIF) and, on the test split, the per-frame and mean tables
`psnr.npy`, `ssim.npy` and `lpips.npy` (whole image, dynamic region)
under `results/<dataset_name>/<scene_name>`. LPIPS needs `--lpips_weights`
(a state dict of `lpips.LPIPS(net='alex')`; none ships with the repo);
without it the table reads "n/a".

Every frame renders through `render_full_image(..., scan_chunks=True)`:
equal chunks, on the card one CUDA graph replay a frame. The checkpoint
is the port's own (`step_<n>` of the train CLI) or a reference Lightning
`.ckpt`; a JAX orbax checkpoint converts with
`scripts/jax_ckpt_to_torch.py`. `main(args, device="cpu")` and
`cli(argv, device="cpu")` run on the CPU (the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace

import numpy as np


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, default="monocular",
                        choices=["monocular"])
    parser.add_argument("--scene_name", type=str, default="test",
                        help="scene name, used as output folder name")
    parser.add_argument("--split", type=str, default="test",
                        help="test / test_spiral / test_spiralX / "
                             "test_fixviewX_interpY")
    parser.add_argument("--img_wh", nargs="+", type=int, default=[512, 288])
    parser.add_argument("--start_end", nargs="+", type=int, default=[0, 100])

    parser.add_argument("--use_viewdir", default=False, action="store_true")
    parser.add_argument("--N_samples", type=int, default=128)
    parser.add_argument("--N_importance", type=int, default=0)
    parser.add_argument("--chunk", type=int, default=32 * 1024)
    parser.add_argument("--num_gpus", type=int, default=1,
                        help="GPUs to render over (more than one is not "
                             "ported: 'multi-GPU')")

    parser.add_argument("--encode_a", default=False, action="store_true")
    parser.add_argument("--N_a", type=int, default=48)
    parser.add_argument("--encode_t", default=False, action="store_true")
    parser.add_argument("--N_tau", type=int, default=48)
    parser.add_argument("--flow_scale", type=float, default=0.2)
    parser.add_argument("--output_transient", default=False,
                        action="store_true")

    parser.add_argument("--ckpt_path", type=str, required=True)

    parser.add_argument(
        "--fix_view_dir", default=False, action="store_true",
        help="on test_spiral* splits, evaluate the view-dependence "
             "embedding with the FIRST pose's ray directions for every "
             "frame, so novel spiral views don't extrapolate view-dependent "
             "color")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="render compute dtype; bfloat16 takes the CUDA "
                             "kernels on the card (float32: the plain "
                             "evaluators)")
    parser.add_argument("--planar_eval", type=str, default="auto",
                        choices=["auto", "on", "off"],
                        help="planar no-grad eval path. 'auto': taken with "
                             "--dtype bfloat16 on the card; 'on': force it; "
                             "'off': packed eval path")
    parser.add_argument("--video_format", type=str, default="mp4",
                        choices=["mp4", "gif"])
    parser.add_argument("--fps", type=int, default=10)
    parser.add_argument("--save_depth", default=False, action="store_true")
    parser.add_argument("--depth_format", type=str, default="png")
    parser.add_argument("--jax_cache_dir", type=str, default="",
                        help="the JAX package's compilation cache "
                             "directory; parsed and unused by the port")
    parser.add_argument(
        "--lpips_weights", type=str, default=None,
        help="path to a torch state dict of the lpips package's "
             "LPIPS(net='alex') module; without it LPIPS prints n/a")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                             "versions)")
    return parser.parse_args(argv)


def load_params(args, cfg, device):
    """Model params of `args.ckpt_path` on `device`: a reference Lightning
    `.ckpt` (merged into a fresh init, non-strict), or the port's own
    checkpoint (`step_<n>` directory or its `state.pt`, a full trainer
    state or bare params)."""
    import torch

    from nsff_pl_tpu_torch.config import build_params
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    init = build_params(cfg, torch.Generator().manual_seed(0), device=device)
    path = args.ckpt_path
    if path.endswith(".ckpt"):
        loaded = ckpt_lib.import_pl_checkpoint(path)
        return ckpt_lib.merge_params(init, ckpt_lib.to_device(loaded, device))
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, ckpt_lib.STATE_FILE)):
        raise ValueError(
            f"{path} holds no {ckpt_lib.STATE_FILE}: a JAX orbax checkpoint "
            "converts with scripts/jax_ckpt_to_torch.py")
    params = ckpt_lib.restore_checkpoint(path)["params"]
    want = {k: tuple(v.shape) for k, v in _leaves(init)}
    got = {k: tuple(v.shape) for k, v in _leaves(params)}
    if want != got:
        raise SystemExit(
            "the checkpoint's parameters do not match this model: eval must "
            "be invoked with the same model flags as training (--use_viewdir "
            "--encode_a --encode_t --N_tau ... — compare "
            f"{path.rstrip('/').rsplit('/', 1)[0]}/config.json)")
    return ckpt_lib.to_device(params, device)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def save_depth_img(depth, h, w, dir_name, filename):
    """A depth map as a colour PNG; returns the image."""
    from nsff_pl_tpu_torch.scene.imageio import write_png
    from nsff_pl_tpu_torch.utils import visualization as viz

    depth_pred = np.nan_to_num(np.asarray(depth.cpu()).reshape(h, w))
    img = (viz.visualize_depth(depth_pred) * 255).astype(np.uint8)
    write_png(os.path.join(dir_name, filename), img)
    return img


def _write_video(path, frames, fmt, fps):
    """`frames` as a GIF at `path` with the extension `fmt`; an mp4 is
    written as a GIF beside it (mp4 needs ffmpeg)."""
    from nsff_pl_tpu_torch.scene.imageio import write_gif

    if fmt != "gif":
        alt = os.path.splitext(path)[0] + ".gif"
        print(f"video save failed ({fmt} needs ffmpeg, which the port does "
              f"not use); writing {alt}", flush=True)
        path = alt
    write_gif(path, frames, fps)


def main(args, device=None):
    """Render the split; returns a report (output directory, seconds per
    item and per render, the metric tables, and the renderer, scene and
    params it used)."""
    import torch

    from nsff_pl_tpu_torch import resolve_device
    from nsff_pl_tpu_torch.config import NSFFConfig, render_config
    from nsff_pl_tpu_torch.models.rendering import (interpolate,
                                                    planar_eval_decision)
    from nsff_pl_tpu_torch.scene import scene_dict
    from nsff_pl_tpu_torch.scene.imageio import write_png
    from nsff_pl_tpu_torch.training import metrics as metrics_lib
    from nsff_pl_tpu_torch.training.step import (make_render_fn,
                                                 render_full_image)

    dev = resolve_device(device or args.device)
    if args.num_gpus > 1:
        raise NotImplementedError(
            f"--num_gpus {args.num_gpus}: rendering over more than one GPU "
            "is not ported (ROADMAP.md queue A, 'multi-GPU')")
    w, h = args.img_wh
    dataset = scene_dict[args.dataset_name](
        root_dir=args.root_dir, split=args.split, img_wh=(w, h),
        start_end=tuple(args.start_end), device=dev)
    n_frames = dataset.N_frames

    cfg = NSFFConfig(
        root_dir=args.root_dir, img_wh=(w, h),
        start_end=(args.start_end[0], args.start_end[0] + n_frames),
        use_viewdir=args.use_viewdir, N_samples=args.N_samples,
        N_importance=args.N_importance, encode_a=args.encode_a, N_a=args.N_a,
        encode_t=args.encode_t, N_tau=args.N_tau, flow_scale=args.flow_scale,
        dtype=args.dtype, planar_eval=args.planar_eval)
    params = load_params(args, cfg, dev)
    rcfg = render_config(cfg)

    dir_name = f"results/{args.dataset_name}/{args.scene_name}"
    os.makedirs(dir_name, exist_ok=True)

    # interpolation needs the per-sample planes of both frames
    is_interp = (args.split.startswith("test_fixview")
                 and int(args.split.split("_")[-1][6:]) > 0)
    if is_interp:
        output_transient = True
        flow = ("fw", "bw")
        keys = ("rgb_fine", "depth_fine", "xyzs_fine", "zs_fine",
                "static_rgbs_fine", "static_alphas_fine",
                "transient_rgbs_fine", "transient_alphas_fine",
                "transient_flows_fw", "transient_flows_bw")
    else:
        output_transient = args.output_transient
        flow = ()
        keys = ("rgb_fine", "depth_fine")
    render = make_render_fn(
        rcfg, test_time=True, output_transient=output_transient,
        output_transient_flow=flow, with_visibility=output_transient,
        keys=keys, device=dev)
    engaged, why = planar_eval_decision(rcfg, dev)
    print(f"render path: {'planar fused kernel' if engaged else 'packed'}"
          + ("" if engaged else f" ({'; '.join(why)})"), flush=True)
    vis_K = torch.as_tensor(dataset.K, device=dev)

    fixed_view_dir = None
    if args.fix_view_dir and args.split.startswith("test_spiral"):
        fixed_view_dir = dataset.test_item(0, targets=())["rays"][:, 3:6]
        print("fix_view_dir: view-dependence embedded with pose-0 ray "
              "directions for all frames", flush=True)

    render_seconds = []

    def f(rays, ts, t_for_vis):
        """The chunked full-image render, with the test-time visibility
        culling against the training camera at time t."""
        vis_poses = (torch.as_tensor(dataset.poses[t_for_vis:t_for_vis + 1],
                                     dtype=torch.float32, device=dev)
                     if output_transient else None)
        t0 = time.perf_counter()
        out = render_full_image(render, params, rays, ts, chunk=args.chunk,
                                vis_poses=vis_poses, vis_K=vis_K,
                                view_dir=fixed_view_dir, scan_chunks=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        render_seconds.append(time.perf_counter() - t0)
        return out

    n_items = len(dataset)
    psnrs = ssims = lpipss = None
    if args.split == "test":
        psnrs = np.zeros((n_items, 2))
        ssims = np.zeros((n_items, 2))
        lpipss = np.full((n_items, 2), np.nan)
        lpips_model = metrics_lib.get_lpips_model(args.lpips_weights, dev)
        if lpips_model is None:
            print("LPIPS unavailable (no --lpips_weights file given); "
                  "reporting n/a — PSNR/SSIM are unaffected", flush=True)
    targets = ("rgbs", "mask") if args.split == "test" else ()

    def host_u8(img):
        img = np.clip(img.float().cpu().numpy(), 0, 1)
        return img, (255 * img).astype(np.uint8)

    imgs, depths, item_seconds = [], [], []
    last_results = None
    for i in range(n_items):
        t_item = time.perf_counter()
        sample = dataset.test_item(i, targets=targets)
        if args.split.startswith("test_fixview") and i == n_items - 1:
            # final frame: reuse the last t+1 render
            img_pred, img_pred_ = host_u8(
                last_results["rgb_fine"].reshape(h, w, 3))
            imgs.append(img_pred_)
            write_png(os.path.join(dir_name, f"{i:03d}_000.png"), img_pred_)
            if args.save_depth:
                depths.append(save_depth_img(
                    last_results["depth_fine"], h, w, dir_name,
                    f"depth_{i:03d}_000.png"))
        else:
            rays, ts = sample["rays"], sample["ts"]
            t = int(ts[0])
            results = last_results if last_results is not None \
                else f(rays, ts, t)
            if args.split.startswith("test_fixview"):
                interp = int(args.split.split("_")[-1][6:])
                results_tp1 = f(rays, torch.clamp(ts + 1, 0, n_frames - 1),
                                min(t + 1, n_frames - 1))
                for dt in np.linspace(0, 1, interp + 1)[:-1]:
                    if dt == 0:
                        img_pred = results["rgb_fine"].reshape(h, w, 3)
                        depth_pred = results["depth_fine"]
                    else:
                        img_pred, depth_pred = interpolate(
                            results, results_tp1, float(dt),
                            dataset.Ks[sample["cam_ids"]], sample["c2w"],
                            (w, h))
                    img_pred, img_pred_ = host_u8(img_pred)
                    imgs.append(img_pred_)
                    write_png(os.path.join(
                        dir_name, f"{i:03d}_{int(dt * 100):03d}.png"),
                        img_pred_)
                    if args.save_depth:
                        depths.append(save_depth_img(
                            depth_pred, h, w, dir_name,
                            f"depth_{i:03d}_{int(dt * 100):03d}.png"))
                last_results = results_tp1
            else:
                img_pred, img_pred_ = host_u8(
                    results["rgb_fine"].reshape(h, w, 3))
                imgs.append(img_pred_)
                write_png(os.path.join(dir_name, f"{i:03d}.png"), img_pred_)
                if args.save_depth:
                    depths.append(save_depth_img(
                        results["depth_fine"], h, w, dir_name,
                        f"depth_{i:03d}.png"))

        if args.split == "test" and "rgbs" in sample:
            img_gt = sample["rgbs"].reshape(h, w, 3)
            pr = torch.as_tensor(img_pred, device=dev)
            psnrs[i, 0] = float(metrics_lib.psnr(img_gt, pr))
            ssims[i, 0] = float(metrics_lib.ssim(img_gt, pr))
            v = metrics_lib.lpips(lpips_model, img_gt, pr)
            lpipss[i, 0] = np.nan if v is None else v
            mask = sample["mask"].reshape(h, w) == 0
            if bool(mask.any()):
                psnrs[i, 1] = float(metrics_lib.psnr(img_gt, pr, mask))
                sm = metrics_lib.ssim(img_gt, pr, reduction="none")
                ssims[i, 1] = float(sm[mask].mean())
                v = metrics_lib.lpips(lpips_model, img_gt, pr, mask)
                lpipss[i, 1] = np.nan if v is None else v
        item_seconds.append(time.perf_counter() - t_item)
        print(f"[{i+1}/{n_items}] rendered", flush=True)

    if args.split == "test":
        mean_psnr = np.nanmean(psnrs, 0)
        mean_ssim = np.nanmean(ssims, 0)
        mean_lpips = np.array([np.nan if np.isnan(c).all()
                               else np.nanmean(c) for c in lpipss.T])
        np.save(os.path.join(dir_name, "psnr.npy"), psnrs)
        np.save(os.path.join(dir_name, "ssim.npy"), ssims)
        np.save(os.path.join(dir_name, "lpips.npy"), lpipss)
        print("Score \t Whole image \t Dynamic only")
        print("-------------------------------------")
        print(f"PSNR  \t {mean_psnr[0]:.4f} \t {mean_psnr[1]:.4f}")
        print(f"SSIM  \t {mean_ssim[0]:.4f} \t {mean_ssim[1]:.4f}")

        def _fmt(v):
            return "n/a" if np.isnan(v) else f"{v:.4f}"

        print(f"LPIPS \t {_fmt(mean_lpips[0])} \t {_fmt(mean_lpips[1])}",
              flush=True)

    _write_video(os.path.join(dir_name,
                              f"{args.scene_name}.{args.video_format}"),
                 imgs, args.video_format, args.fps)
    if args.save_depth and depths:
        _write_video(os.path.join(
            dir_name, f"depth_{args.scene_name}.{args.video_format}"),
            depths, args.video_format, args.fps)
    return SimpleNamespace(
        dir_name=dir_name, n_items=n_items, item_seconds=item_seconds,
        render_seconds=render_seconds, psnr=psnrs, ssim=ssims, lpips=lpipss,
        render=render, dataset=dataset, params=params, engaged=engaged)


def cli(argv=None, device=None):
    """Console entry point (`nsff-eval-torch`); `device` overrides
    `--device`."""
    return main(get_opts(argv), device=device)


if __name__ == "__main__":
    cli()
