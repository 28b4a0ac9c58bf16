"""The ranks' side of tests/test_torch_parallel_render.py. It imports
torch and the port only: the spawned gloo ranks import this module, and
nothing of JAX need load there.

A 32x24 frame of rays on a dyadic grid (o, d multiples of 1/64, as
tests/test_torch_planes_route.py builds them), rendered in chunks of
CHUNK rays (the last one padded), through the port's `make_render_fn` +
`render_full_image` on each render route of `CASES`."""
import os

import numpy as np
import torch

from nsff_pl_tpu_torch.models import nerf as tn
from nsff_pl_tpu_torch.models.raymarch import comp_eval_keys
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training.step import make_render_fn, render_full_image

W, H, FRAMES, NTAU = 32, 24, 4, 16
CHUNK = 320  # 768 rays: 320 + 320 + 128 padded to 320; each divides by 2
FLOW = ("fw", "bw")
K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
# the eval CLI's keys on an interpolation split
INTERP_KEYS = ("rgb_fine", "depth_fine", "xyzs_fine", "zs_fine",
               "static_rgbs_fine", "static_alphas_fine",
               "transient_rgbs_fine", "transient_alphas_fine",
               "transient_flows_fw", "transient_flows_bw")
PLANAR = dict(use_viewdir=True, encode_t=True, N_tau=NTAU, max_t=FRAMES - 1,
              img_wh=(W, H), compute_dtype="bfloat16", mlp_backend="pallas",
              planar_eval="on")
# {case: (render config, make_render_fn flags, render_full_image flags)}
CASES = {
    # B1 with its visibility planes: S = 17 samples at z = k/16
    "composited": (dict(PLANAR, N_samples=17),
                   dict(output_transient=True, output_transient_flow=FLOW,
                        with_visibility=True,
                        keys=tuple(sorted(comp_eval_keys(True, FLOW))))),
    # B2's forward + B3 (its plain version; JAX: the plain composite), the
    # interpolation keys and a view direction override
    "planes": (dict(PLANAR, N_samples=17, planar_compositing="on"),
               dict(output_transient=True, output_transient_flow=FLOW,
                    with_visibility=True, keys=INTERP_KEYS),
               dict(view_dir=True)),
    # the coarse pass on B2's forward, then B1 at S_fine = 32
    "c2f": (dict(PLANAR, N_samples=16, N_importance=8),
            dict(output_transient=True, with_visibility=True,
                 keys=("rgb_fine", "depth_fine"))),
    # B5 on the packed path
    "packed": (dict(PLANAR, N_samples=16, planar_eval="off"),
               dict(output_transient=True, with_visibility=True,
                    keys=("rgb_fine", "depth_fine"))),
    # the plain float32 evaluators, in equal chunks (the eval CLI's
    # default), with a view direction override
    "scan": (dict(PLANAR, N_samples=16, compute_dtype="float32",
                  mlp_backend="xla", planar_eval="off"),
             dict(output_transient=True, with_visibility=True,
                  keys=("rgb_fine", "depth_fine", "transient_alpha_fine")),
             dict(view_dir=True, scan_chunks=True)),
}


def case(name):
    """(render config kwargs, make_render_fn flags, render_full_image
    flags) of a case."""
    cfg, fn_kw, *frame_kw = CASES[name]
    return cfg, fn_kw, (frame_kw[0] if frame_kw else {})


def params():
    """The fine model (view direction, transient tower, both flow heads),
    a coarse model and the t embedding: the port's initializer from a
    seeded CPU generator (numpy arrays go to the JAX side)."""
    g = torch.Generator().manual_seed(3)
    return {"nerf_fine": tn.init_nerf_params(
                g, "fine", use_viewdir=True, encode_transient=True,
                in_channels_t=NTAU, output_flow=True, device="cpu"),
            "nerf_coarse": tn.init_nerf_params(
                g, "coarse", use_viewdir=True, encode_transient=True,
                in_channels_t=NTAU, device="cpu"),
            "embedding_t": tn.init_embedding(g, FRAMES, NTAU, device="cpu")}


def frame():
    """{rays, ts, view_dir, vis_poses, vis_K} of the frame, numpy."""
    rng = np.random.RandomState(0)
    n = W * H
    rays = np.zeros((n, 6), np.float32)
    rays[:, 0:2] = rng.randint(-48, 48, (n, 2)) / 64
    rays[:, 2] = -1.0
    rays[:, 3:5] = rng.randint(-12, 12, (n, 2)) / 64
    rays[:, 5] = 2.0
    view_dir = np.zeros((n, 3), np.float32)
    view_dir[:, 0:2] = rng.randint(-12, 12, (n, 2)) / 64
    view_dir[:, 2] = 1.0
    poses = np.zeros((1, 3, 4), np.float32)
    poses[0, :, :3] = np.eye(3)
    poses[0, :, 3] = [0.05, -0.02, 0.0]
    return {"rays": rays,
            "ts": rng.randint(0, FRAMES, n).astype(np.int32),
            "view_dir": view_dir, "vis_poses": poses, "vis_K": K}


def render(name, mesh):
    """The frame of case `name` over `mesh` (None: one process)."""
    cfg, fn_kw, frame_kw = case(name)
    f = frame()
    render_fn = make_render_fn(RenderConfig(**cfg), test_time=True,
                               device="cpu", mesh=mesh, **fn_kw)
    out = render_full_image(
        render_fn, params(), torch.from_numpy(f["rays"]),
        torch.from_numpy(f["ts"]).long(), chunk=CHUNK,
        vis_poses=torch.from_numpy(f["vis_poses"]),
        vis_K=torch.from_numpy(f["vis_K"]),
        view_dir=(torch.from_numpy(f["view_dir"])
                  if frame_kw.get("view_dir") else None),
        scan_chunks=frame_kw.get("scan_chunks", False))
    return {k: v.float() for k, v in out.items()}


def rank_main(mesh, out_dir):
    """Every case on the two-rank mesh, then this rank's share of the
    one-process references; written to out_dir/rank<r>.pt."""
    from nsff_pl_tpu_torch.parallel import mesh as mesh_lib

    before = dict(mesh_lib.CALLED)
    res = {f"dp_{c}": render(c, mesh) for c in CASES}
    res["gathers"] = mesh_lib.CALLED["all_gather"] - before.get(
        "all_gather", 0)
    for i, c in enumerate(CASES):
        if i % mesh.size == mesh.rank:
            res[f"one_{c}"] = render(c, None)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def launch_ranks(_, out_dir):
    """In a process of its own: the two gloo ranks of `rank_main`,
    started by the port's launcher (this process is rank 0), one torch
    thread each."""
    from nsff_pl_tpu_torch.config import NSFFConfig
    from nsff_pl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.launch(rank_main, NSFFConfig(num_gpus=2), "cpu", (out_dir,))


def numpy_params():
    return tckpt.params_to_numpy(params())


# ---------------------------------------------------------------------------
# the eval CLI and the server over two ranks

EVAL_SPLITS = {"test": ("test", "--save_depth"),
               "interp": ("test_fixview1_interp2",)}
EVAL_FRAMES, EVAL_S = 3, 8


def eval_argv(scene, ckpt, name, split_args, *extra):
    """The eval CLI's flags on the test module's scene (32x24, 3 frames,
    S = 8, float32: the plain evaluators; chunk 512: two equal chunks a
    frame)."""
    return ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh", str(W),
            str(H), "--start_end", "0", str(EVAL_FRAMES), "--N_samples",
            str(EVAL_S), "--encode_t", "--N_tau", "8", "--split",
            split_args[0], *split_args[1:], "--scene_name", name,
            "--video_format", "gif", "--chunk", "512", *extra]


def serve_argv(ckpt, meta, port):
    """The server's flags: bfloat16 on B1's plain version (`--planar_eval
    on`), the frame in two chunks."""
    return ["--ckpt_path", ckpt, "--scene_meta", meta, "--img_wh", str(W),
            str(H), "--encode_t", "--N_tau", "8", "--N_samples",
            str(EVAL_S), "--planar_eval", "on", "--chunk", "384", "--host",
            "127.0.0.1", "--port", str(port), "--device", "cpu"]


def _post(url, body):
    """(status, decoded JSON) of a POST /render?format=json."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/render?format=json",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _client(url, requests, answers):
    """Wait for the server's /health, send `requests` in turn, then stop
    the server as Ctrl-C would."""
    import _thread
    import time
    import urllib.request

    try:
        for _ in range(600):
            try:
                with urllib.request.urlopen(url + "/health", timeout=5):
                    break
            except OSError:
                time.sleep(0.1)
        time.sleep(1.2)  # two idle polls: keep-alives go out
        for body in requests:
            answers.append(_post(url, body))
    finally:
        _thread.interrupt_main()


def serve_requests(poses):
    """Two good requests around two bad ones (t out of range, a c2w of
    the wrong shape): the bad ones must get a 400 before anything is
    broadcast."""
    c2w = poses[2].copy()
    c2w[:, 3] += [0.02, -0.01, 0.03]
    return [{"t": 1}, {"t": 99}, {"t": 1, "c2w": [[1.0, 0.0], [0.0, 1.0]]},
            {"t": 2, "c2w": c2w.tolist()}]


def cli_runs(_, out_dir, scene, ckpt, meta, port):
    """In a process of its own, one torch thread a rank, in `out_dir`:
    the eval CLI on each split of EVAL_SPLITS in this process alone and
    with `--num_gpus 2` (this process rank 0), both ranks' standard
    output going to out_dir/stdout.txt; then the server with `--num_gpus
    2` (a keep-alive at every idle poll), the requests of
    `serve_requests` sent from a thread here, the answers and the
    one-process renders of the good ones to out_dir/serve.pt."""
    import sys
    import threading

    from nsff_pl_tpu_torch.apps import evaluate, serve
    from nsff_pl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.TIMEOUT_S = 120  # a rank out of step fails in 2 minutes
    distributed.KEEP_ALIVE_S = 0.0
    os.chdir(out_dir)
    with open("stdout.txt", "w") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)  # the spawned rank inherits it
        try:
            for name, split in EVAL_SPLITS.items():
                evaluate.cli(eval_argv(scene, ckpt, f"one_{name}", split),
                             device="cpu")
                evaluate.cli(eval_argv(scene, ckpt, f"dp_{name}", split,
                                       "--num_gpus", "2"), device="cpu")
            poses = np.load(meta)["poses"]
            requests = serve_requests(poses)
            answers = []
            client = threading.Thread(target=_client, args=(
                f"http://127.0.0.1:{port}", requests, answers))
            client.start()
            args = serve.get_opts(serve_argv(ckpt, meta, port) + [
                "--num_gpus", "2"])
            service = serve.main(args, device="cpu")
            client.join(timeout=60)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
    # the good requests again, in this process alone
    one = serve.RenderService(
        service.params, np.load(meta)["K"], poses, (W, H), service.cfg,
        chunk=384, device="cpu")
    alone = [one.render_pose(r["t"], r.get("c2w"))
             for r in (requests[0], requests[3])]
    torch.save({"answers": answers, "alone": alone,
                "renders": service.renders,
                "chunk": service.chunk}, "serve.pt")
