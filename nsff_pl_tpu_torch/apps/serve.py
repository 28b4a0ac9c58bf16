#!/usr/bin/env python
"""Minimal HTTP render server (port of `tools/serve_render.py`).

Keeps one renderer warm on the card and serves novel-view/novel-time
renders with the stdlib server, one request at a time. The service takes
the scene metadata directly: intrinsics K (3, 3), the model-frame poses
(N_frames, 3, 4) and the image size. From the command line they come
from an `.npz` holding `K` and `poses`, and the parameters from a file
written by `training/checkpoint.py::save`:

    python -m nsff_pl_tpu_torch.apps.serve --ckpt_path params.pt \
        --scene_meta scene.npz --img_wh 512 288 --encode_t \
        --use_viewdir --N_samples 128 --port 8765

`--dtype bfloat16` (the default here) renders on the CUDA kernels: the
planar composited evaluator, or with `--planar_eval off` the packed
evaluator and compositing outside it. `--dtype float32` renders on the
plain f32 evaluators. `--N_importance` > 0 (coarse-to-fine: the
parameters hold `nerf_coarse`) renders on either path, its coarse pass on
the planar evaluator's forward or, on the packed path, on the plain
evaluators in the compute dtype.

Endpoints:
    GET  /health  -> {"status": "ok"}
    GET  /meta    -> n_frames, img_wh, K and the poses
    POST /render  -> body {"t": int, "c2w": optional 3x4 nested list
                     (defaults to training pose t)}; returns image/png.
                     `?format=json` returns {"rgb": ..., "depth": ...}.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.config import NSFFConfig, render_config
from nsff_pl_tpu_torch.ops import rays as ray_ops
from nsff_pl_tpu_torch.scene.imageio import png_bytes
from nsff_pl_tpu_torch.training.step import make_render_fn, render_full_image

RENDER_KEYS = ("rgb_fine", "depth_fine")


def get_opts(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="parameters written by training.checkpoint.save")
    parser.add_argument("--scene_meta", type=str, required=True,
                        help=".npz with K (3, 3) and poses (N_frames, 3, 4)")
    parser.add_argument("--img_wh", nargs="+", type=int, default=[512, 288])
    parser.add_argument("--use_viewdir", default=False, action="store_true")
    parser.add_argument("--N_samples", type=int, default=128)
    parser.add_argument("--N_importance", type=int, default=0)
    parser.add_argument("--encode_a", default=False, action="store_true")
    parser.add_argument("--N_a", type=int, default=48)
    parser.add_argument("--encode_t", default=False, action="store_true")
    parser.add_argument("--N_tau", type=int, default=48)
    parser.add_argument("--flow_scale", type=float, default=0.2)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--planar_eval", type=str, default="auto",
                        choices=["auto", "on", "off"])
    parser.add_argument("--chunk", type=int, default=32 * 1024)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--no_warmup", default=False, action="store_true",
                        help="skip the startup render that builds the "
                             "kernel before the first request")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


class RenderService:
    """Parameters + scene metadata + one renderer (the serving route:
    static + transient composite, keys rgb_fine/depth_fine)."""

    def __init__(self, params, K, poses, img_wh, cfg: NSFFConfig, *,
                 chunk: int = 32 * 1024, device="cuda"):
        self.device = resolve_device(device)
        self.w, self.h = int(img_wh[0]), int(img_wh[1])
        self.K = np.asarray(K, np.float32).reshape(3, 3)
        self.poses = np.asarray(poses, np.float32).reshape(-1, 3, 4)
        self.n_frames = self.poses.shape[0]
        self.cfg = cfg.replace(img_wh=(self.w, self.h),
                               start_end=(0, self.n_frames))
        self.chunk = chunk
        self.params = params
        self.render = make_render_fn(
            render_config(self.cfg), output_transient=self.cfg.encode_t,
            keys=RENDER_KEYS, device=self.device)

    def meta(self):
        return {"n_frames": self.n_frames, "img_wh": [self.w, self.h],
                "K": self.K.tolist(), "poses": self.poses.tolist()}

    def frame_rays(self, c2w) -> torch.Tensor:
        """(h*w, 6) NDC rays of one camera pose, near plane 1."""
        c2w = torch.as_tensor(np.asarray(c2w, np.float32).reshape(3, 4),
                              device=self.device)
        directions = ray_ops.get_ray_directions(self.h, self.w, self.K,
                                                device=self.device)
        rays_o, rays_d = ray_ops.get_rays(directions, c2w)
        shift_near = -min(-1.0, float(c2w[2, 3]))
        rays_o, rays_d = ray_ops.get_ndc_rays(self.K, 1.0, shift_near,
                                              rays_o, rays_d)
        return torch.cat([rays_o, rays_d], 1)

    def render_maps(self, t: int, c2w=None):
        """Float maps of frame time `t` from `c2w` (defaults to pose t):
        rgb (h*w, 3) and depth (h*w,) on the service's device."""
        if not 0 <= t < self.n_frames:
            raise ValueError(f"t must be in [0, {self.n_frames})")
        rays = self.frame_rays(self.poses[t] if c2w is None else c2w)
        ts = torch.full((rays.shape[0],), t, dtype=torch.long,
                        device=self.device)
        return render_full_image(self.render, self.params, rays, ts,
                                 chunk=self.chunk)

    def render_pose(self, t: int, c2w=None):
        """Returns (rgb (h, w, 3) uint8, depth (h, w) float32)."""
        out = self.render_maps(t, c2w)
        rgb = out["rgb_fine"].clamp(0, 1).cpu().numpy()
        rgb = (rgb.reshape(self.h, self.w, 3) * 255).astype(np.uint8)
        depth = out["depth_fine"].float().cpu().numpy().reshape(self.h,
                                                                self.w)
        return rgb, depth


def make_handler(service):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, obj):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path == "/health":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/meta":
                self._send_json(200, service.meta())
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/render":
                self._send_json(404, {"error": f"unknown path {path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                rgb, depth = service.render_pose(int(req.get("t", 0)),
                                                 req.get("c2w"))
            except (ValueError, TypeError, KeyError) as e:
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if "format=json" in query:
                self._send_json(200, {"rgb": rgb.tolist(),
                                      "depth": depth.tolist()})
            else:
                self._send(200, png_bytes(rgb), "image/png")

        def log_message(self, fmt, *a):  # concise one-line access log
            print(f"[serve] {self.address_string()} {fmt % a}", flush=True)

    return Handler


def main(args):
    from http.server import HTTPServer

    from nsff_pl_tpu_torch.training import checkpoint

    meta = np.load(args.scene_meta)
    w, h = args.img_wh
    cfg = NSFFConfig(
        img_wh=(w, h), use_viewdir=args.use_viewdir,
        N_samples=args.N_samples, N_importance=args.N_importance,
        encode_a=args.encode_a, N_a=args.N_a, encode_t=args.encode_t,
        N_tau=args.N_tau, flow_scale=args.flow_scale, dtype=args.dtype,
        planar_eval=args.planar_eval)
    service = RenderService(checkpoint.load(args.ckpt_path, args.device),
                            meta["K"], meta["poses"], (w, h), cfg,
                            chunk=args.chunk, device=args.device)
    if not args.no_warmup:
        print("[serve] warmup render (builds the kernel)...", flush=True)
        service.render_pose(0)
    server = HTTPServer((args.host, args.port), make_handler(service))
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"({service.n_frames} frames at {service.w}x{service.h})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main(get_opts())
