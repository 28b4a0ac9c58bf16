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

`--num_gpus N` (N > 1) renders each frame data-parallel over N ranks,
one a GPU (`parallel.distributed.launch`; fewer GPUs than asked for
print a note and serve on those present; on the CPU N gloo ranks). Rank
0 runs the HTTP server: it checks each request (`t` in range, a 3x4
`c2w`) and answers a bad one 400 before anything is sent, then
broadcasts the request (`parallel.distributed.send_request`); the other
ranks wait for it in `RenderService.follow` and render their rows of
each chunk with it. The warm-up render is one such request. When the
server stops, rank 0 broadcasts STOP; while it is idle, a keep-alive
every `KEEP_ALIVE_S`. A render that fails after its broadcast ends the
server with the error (the ranks are then out of step), and the
launcher ends the other ranks.
"""
from __future__ import annotations

import argparse
import json
import time
from http.server import HTTPServer

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.config import NSFFConfig, render_config
from nsff_pl_tpu_torch.ops import rays as ray_ops
from nsff_pl_tpu_torch.parallel import distributed
from nsff_pl_tpu_torch.parallel.distributed import KEEP_ALIVE, RENDER, STOP
from nsff_pl_tpu_torch.parallel.mesh import round_chunk
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
    parser.add_argument("--num_gpus", type=int, default=1,
                        help="GPUs to render data-parallel over, one rank "
                             "a GPU (rank 0 serves HTTP)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--no_warmup", default=False, action="store_true",
                        help="skip the startup render that builds the "
                             "kernel before the first request")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


class RenderService:
    """Parameters + scene metadata + one renderer (the serving route:
    static + transient composite, keys rgb_fine/depth_fine). Over a
    `mesh` (this rank's) each frame renders data-parallel: rank 0 takes
    the requests (`render_maps`, `render_pose`) and broadcasts them, the
    other ranks `follow`."""

    def __init__(self, params, K, poses, img_wh, cfg: NSFFConfig, *,
                 chunk: int = 32 * 1024, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        # a render failed after its broadcast: the ranks are out of step
        self.broken = False
        self.renders = 0
        self._last_sent = time.monotonic()
        self.w, self.h = int(img_wh[0]), int(img_wh[1])
        self.K = np.asarray(K, np.float32).reshape(3, 3)
        self.poses = np.asarray(poses, np.float32).reshape(-1, 3, 4)
        self.n_frames = self.poses.shape[0]
        self.cfg = cfg.replace(img_wh=(self.w, self.h),
                               start_end=(0, self.n_frames))
        self.chunk = round_chunk(chunk, mesh)
        self.params = params
        self.render = make_render_fn(
            render_config(self.cfg), output_transient=self.cfg.encode_t,
            keys=RENDER_KEYS, device=self.device, mesh=mesh)

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

    def check_request(self, t, c2w=None):
        """A request's frame time and pose, checked: (t, None or c2w as a
        (3, 4) float32 array). Raises ValueError / TypeError for a bad
        one, before anything is rendered or sent."""
        if not 0 <= t < self.n_frames:
            raise ValueError(f"t must be in [0, {self.n_frames})")
        if c2w is not None:
            c2w = np.asarray(c2w, np.float32).reshape(3, 4)
        return t, c2w

    def render_maps(self, t: int, c2w=None):
        """Float maps of frame time `t` from `c2w` (defaults to pose t):
        rgb (h*w, 3) and depth (h*w,) on the service's device. Over a mesh
        (rank 0) the checked request goes to the other ranks first."""
        t, c2w = self.check_request(t, c2w)
        if self.mesh is None:
            return self._render(t, c2w)
        if not self.primary:
            raise RuntimeError("only rank 0 takes requests; the other "
                               "ranks follow it (RenderService.follow)")
        if self.broken:
            raise RuntimeError("a render over the mesh failed earlier; "
                               "the ranks are out of step")
        self._send(RENDER, t, c2w)
        try:
            return self._render(t, c2w)
        except BaseException:
            self.broken = True
            raise

    def _send(self, kind, t=0, c2w=None):
        distributed.send_request(self.mesh, kind, t, c2w)
        self._last_sent = time.monotonic()

    def keep_alive(self):
        """Rank 0, idle: a KEEP_ALIVE to the other ranks when nothing was
        sent for `KEEP_ALIVE_S`, so that no follower's wait outlasts the
        group's timeout."""
        if (self.mesh is not None and self.primary and not self.broken
                and time.monotonic() - self._last_sent
                >= distributed.KEEP_ALIVE_S):
            self._send(KEEP_ALIVE)

    def stop_followers(self):
        """Rank 0: release the other ranks' `follow` (a STOP). Not after
        a failed render: the ranks are out of step, the failure goes up
        and the launcher ends the other ranks."""
        if self.mesh is not None and self.primary and not self.broken:
            self._send(STOP)

    def follow(self) -> int:
        """A rank other than 0: render each request rank 0 broadcasts
        (its rows of each chunk) until it broadcasts STOP; returns the
        frames rendered."""
        if self.mesh is None or self.primary:
            raise RuntimeError("follow() is for the ranks other than 0 of "
                               "a mesh")
        while True:
            kind, t, c2w = distributed.receive_request(self.mesh)
            if kind == STOP:
                return self.renders
            if kind == RENDER:
                self._render(t, c2w)

    def _render(self, t, c2w):
        rays = self.frame_rays(self.poses[t] if c2w is None else c2w)
        ts = torch.full((rays.shape[0],), t, dtype=torch.long,
                        device=self.device)
        out = render_full_image(self.render, self.params, rays, ts,
                                chunk=self.chunk)
        self.renders += 1
        return out

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
                if service.broken:  # failed after its broadcast: no 400
                    raise
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


class Server(HTTPServer):
    """The stdlib server over a `RenderService`, one request at a time.
    Between requests it sends the service's keep-alives (`serve_forever`
    calls `service_actions` every poll); a request whose render failed
    after its broadcast ends `serve_forever` with its error, where a
    lone server would log it and go on."""

    def __init__(self, service, host, port):
        super().__init__((host, port), make_handler(service))
        self.service = service

    def service_actions(self):
        self.service.keep_alive()

    def handle_error(self, request, client_address):
        if self.service.broken:
            self.shutdown_request(request)  # the client sees it end
            raise  # the request's error, still being handled
        super().handle_error(request, client_address)


def run(service, server):
    """Serve until `server.shutdown()` or an interrupt, then release the
    other ranks (`RenderService.stop_followers`)."""
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop_followers()


def main(args, device=None):
    """Serve the checkpoint; with `--num_gpus` > 1 over that many ranks,
    this process rank 0. `device` overrides `--device`."""
    dev = resolve_device(device or args.device)
    if args.num_gpus > 1:
        return distributed.launch(_serve_rank, args, dev, (args,))
    return serve(args, dev)


def _serve_rank(mesh, args):
    return serve(args, mesh.device, mesh)


def serve(args, dev, mesh=None):
    """Build the service on `dev` (one rank of `mesh`); rank 0 warms it
    up and serves HTTP, the other ranks follow it. Returns the service."""
    from nsff_pl_tpu_torch.training import checkpoint

    meta = np.load(args.scene_meta)
    w, h = args.img_wh
    cfg = NSFFConfig(
        img_wh=(w, h), use_viewdir=args.use_viewdir,
        N_samples=args.N_samples, N_importance=args.N_importance,
        encode_a=args.encode_a, N_a=args.N_a, encode_t=args.encode_t,
        N_tau=args.N_tau, flow_scale=args.flow_scale, dtype=args.dtype,
        planar_eval=args.planar_eval)
    service = RenderService(checkpoint.load(args.ckpt_path, dev),
                            meta["K"], meta["poses"], (w, h), cfg,
                            chunk=args.chunk, device=dev, mesh=mesh)
    if not service.primary:
        service.follow()
        return service
    try:
        if not args.no_warmup:
            print("[serve] warmup render (builds the kernel)...", flush=True)
            service.render_pose(0)
        server = Server(service, args.host, args.port)
    except BaseException:
        service.stop_followers()
        raise
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"({service.n_frames} frames at {service.w}x{service.h})",
          flush=True)
    try:
        run(service, server)
    except KeyboardInterrupt:
        if service.broken:  # mid-render: the ranks are out of step
            raise
        print("[serve] stopped", flush=True)  # the other ranks released
    return service


if __name__ == "__main__":
    main(get_opts())
