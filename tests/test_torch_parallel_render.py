"""Rendering over a mesh of ranks at test time (the port's
`make_render_fn(mesh=)` + `render_full_image`, the eval CLI's and the
server's `--num_gpus`) on the CPU over gloo: two ranks started once for
the module through the port's launcher (`parallel.distributed.launch`,
called in a spawned process; the ranks' code is
tests/torch_parallel_render_helpers.py, one torch thread each), while
the eval CLI and the server run over two ranks of their own from another
spawned process and the JAX references run here.

- A 32x24 frame in chunks of 320 rays (the last padded; each chunk
  divides over the two ranks) on five routes: the planar composited
  route (B1, with its visibility planes), the planes route (B2's
  forward + B3) with the interpolation keys and a view direction
  override, the planar coarse-to-fine, the packed path (B5), and the
  plain float32 evaluators in equal chunks (`scan_chunks`) with a view
  direction override. Both ranks hold the same bits, and the same bits
  as the port's one-process render (every row renders alone, and the
  gather only moves rows). Against the JAX package's
  `make_render_fn(mesh=make_mesh(2))` + `render_full_image` on the
  conftest's virtual CPU devices (its Pallas kernels in interpret mode),
  at the tolerances of the one-device render tests: the composited and
  planes routes those of tests/test_torch_planes_route.py (the
  evaluator's per-sample planes, the alphas among them, 1e-4 abs with at
  most a tenth of the samples off by more than 1e-6; the per-ray maps
  1e-5, here on all but 1% of their entries and within the planes' 1e-4
  on the rest: at 768 rays a bf16 rounding flip of one activation, which
  that file's docstring explains, now and then reaches a map, and a map,
  a weighted sum of its samples with weights summing to at most 1, is
  never farther off than its samples; measured 1.7e-5 on 0.35% of one
  map's entries), the coarse-to-fine maps tests/test_torch_c2f.py's
  2e-4, the packed path tests/test_torch_packed_render.py's 2e-4 with at
  most a twentieth off by more than 1e-5, the float32 equal chunks
  tests/test_torch_render_chunks.py's 3e-6.
- The equal chunks over a mesh (`equal_chunks(n, chunk, world)`) divide
  by the world; only a world of 3, 5, 6 or 7 changes the plan.
- The eval CLI with `--num_gpus 2` on tests/helpers_scene.py's scene
  (float32, the plain evaluators), on the test split and on
  `test_fixview1_interp2`, against the one-process run: the same files,
  each the same bytes; rank 0 alone prints.
- The server with `--num_gpus 2` (`apps/serve.py::main`, B1's plain
  version): two good requests around a `t` out of range and a `c2w` of
  the wrong shape, each bad one answered 400 before anything is sent to
  the other rank; the good ones equal to the one-process service's
  frames; keep-alives between requests; Ctrl-C releases the other rank
  and the launcher returns. A render that fails after its request was
  broadcast is no 400: it ends the server with its error and sends no
  STOP (the ranks are then out of step; the launcher ends the others).

The module takes ~40 s of pytest's count alone.
"""
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.parallel import make_mesh as jax_make_mesh
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu_torch.training.step import equal_chunks
from tests import torch_parallel_render_helpers as h
from tests.helpers_scene import make_synthetic_scene

TOL, MAP_SHARE = 1e-5, 0.01
PLANE_TOL, PLANE_EXACT, PLANE_SHARE = 1e-4, 1e-6, 0.1
C2F_TOL = 2e-4
KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE = 2e-4, 1e-5, 0.05
F32_TOL = 3e-6
PLANE_KEYS = ("static_rgbs_fine", "transient_rgbs_fine",
              "static_alphas_fine", "transient_alphas_fine",
              "transient_flows_fw", "transient_flows_bw")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_renders():
    """Each case's frame by the JAX package over a two-device mesh."""
    f = h.frame()
    params = jax.tree.map(jnp.asarray, h.numpy_params())
    mesh = jax_make_mesh(2)
    out = {}
    for name in h.CASES:
        cfg, fn_kw, frame_kw = h.case(name)
        render = jstep.make_render_fn(JRenderConfig(**cfg), test_time=True,
                                      mesh=mesh, **fn_kw)
        res = jstep.render_full_image(
            render, params, jnp.asarray(f["rays"]), jnp.asarray(f["ts"]),
            jax.random.PRNGKey(0), chunk=h.CHUNK,
            vis_poses=jnp.asarray(f["vis_poses"]),
            vis_K=jnp.asarray(f["vis_K"]),
            view_dir=(jnp.asarray(f["view_dir"])
                      if frame_kw.get("view_dir") else None),
            scan_chunks=frame_kw.get("scan_chunks", False))
        out[name] = {k: np.asarray(v, np.float32) for k, v in res.items()}
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' renders ({rank: {run: ...}}), the JAX renders, and the
    directory of the eval CLI and server runs: the ranks and those runs
    each in a process of their own (h.launch_ranks, h.cli_runs) while
    the JAX renders run here."""
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.scene import MonocularScene
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib

    out = str(tmp_path_factory.mktemp("ranks"))
    cli = tmp_path_factory.mktemp("cli")
    scene = make_synthetic_scene(str(cli / "scene"), W=h.W, H=h.H,
                                 N=h.EVAL_FRAMES, learnable=True)
    cfg = NSFFConfig(root_dir=scene, img_wh=(h.W, h.H),
                     start_end=(0, h.EVAL_FRAMES), N_samples=h.EVAL_S,
                     encode_t=True, N_tau=8)
    ckpt = ckpt_lib.save_checkpoint(
        str(cli / "ckpt"), 0, {"params": build_params(
            cfg, torch.Generator().manual_seed(5), device="cpu")})
    data = MonocularScene(scene, split="test", img_wh=(h.W, h.H),
                          start_end=(0, h.EVAL_FRAMES), device="cpu")
    meta = str(cli / "meta.npz")
    np.savez(meta, K=data.K, poses=data.poses)
    procs = [torch.multiprocessing.start_processes(
        fn, args=args, nprocs=1, join=False, start_method="spawn")
        for fn, args in ((h.launch_ranks, (out,)),
                         (h.cli_runs, (str(cli), scene, ckpt, meta,
                                       _free_port())))]
    jax_out = _jax_renders()
    for p in procs:
        while not p.join(timeout=600):
            pass
    res = {r: torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
           for r in (0, 1)}
    return res, jax_out, cli


@pytest.mark.parametrize("name", list(h.CASES))
def test_two_ranks_match_one_rank_and_jax(runs, name):
    res, jax_out, _ = runs
    dp = res[0][f"dp_{name}"]
    one = res[list(h.CASES).index(name) % 2][f"one_{name}"]
    want = jax_out[name]
    assert set(dp) == set(one) == set(want)
    for k in want:
        assert torch.equal(dp[k], res[1][f"dp_{name}"][k]), f"ranks: {k}"
        assert torch.equal(dp[k], one[k]), f"one rank: {k}"
    off = total = 0
    for k, w in want.items():
        got = dp[k].numpy()
        assert got.shape == w.shape, k
        err = np.abs(got - w)
        if name == "c2f":
            assert err.max() <= C2F_TOL, (k, err.max())
        elif name == "scan":
            assert err.max() <= F32_TOL, (k, err.max())
        elif name == "packed":
            assert err.max() <= KERNEL_TOL, (k, err.max())
            off += int((err > KERNEL_EXACT).sum())
            total += err.size
        elif k in PLANE_KEYS:
            assert err.max() <= PLANE_TOL, (k, err.max())
            assert (err > PLANE_EXACT).mean() <= PLANE_SHARE, k
        else:  # a per-ray map
            assert err.max() <= PLANE_TOL, (k, err.max())
            assert (err > TOL).mean() <= MAP_SHARE, (k, (err > TOL).mean())
    assert off <= KERNEL_SHARE * max(total, 1)


def test_collectives_per_frame(runs):
    """One all-gather a field evaluation: 3 chunks on the composited,
    packed and float32 routes, 2 a chunk on the planes route (B2, B3)
    and the coarse-to-fine (its coarse pass, B1): 21 in all."""
    res = runs[0]
    assert res[0]["gathers"] == res[1]["gathers"] == 21


@pytest.mark.parametrize("n,chunk,world,plan", [
    (512 * 288, 32768, 1, (5, 29696)), (512 * 288, 32768, 2, (5, 29696)),
    (512 * 288, 32768, 8, (5, 29696)), (512 * 288, 32766, 3, (5, 30720)),
    (768, 320, 2, (3, 320)), (5000, 2046, 6, (3, 2046))])
def test_equal_chunks_divide_over_the_mesh(n, chunk, world, plan):
    assert equal_chunks(n, chunk, world) == plan
    assert plan[1] % world == 0 and plan[0] * plan[1] >= n


def test_eval_cli_two_ranks(runs):
    """The eval CLI with `--num_gpus 2` writes what the one-process run
    writes, byte for byte (the video named after the scene), and rank 0
    alone prints."""
    cli = runs[2]
    base = cli / "results" / "monocular"
    for split in h.EVAL_SPLITS:
        one = sorted(os.listdir(base / f"one_{split}"))
        dp = sorted(os.listdir(base / f"dp_{split}"))
        assert dp == sorted(f.replace("one_", "dp_") for f in one)
        for f in one:
            a = (base / f"one_{split}" / f).read_bytes()
            b = (base / f"dp_{split}" / f.replace("one_", "dp_")).read_bytes()
            assert a == b, f"{split}: {f}"
    lines = (cli / "stdout.txt").read_text().splitlines()
    assert lines.count("mesh: 2 cpu ranks over 1 node(s), data-parallel "
                       "over rays") == 3  # two eval runs, the server
    # four eval runs, rank 0 printing: 3 items each
    assert lines.count(f"[1/{h.EVAL_FRAMES}] rendered") == 4
    assert sum(x.startswith("PSNR") for x in lines) == 2


def test_server_two_ranks(runs):
    """`apps.serve` with `--num_gpus 2`: the bad requests get a 400 and
    the ranks stay in step (the next request renders the one-process
    frame); three renders (the warm-up and two requests); the chunk
    rounded to the ranks; a clean stop."""
    cli = runs[2]
    res = torch.load(cli / "serve.pt", weights_only=False)
    assert [code for code, _ in res["answers"]] == [200, 400, 400, 200]
    assert "t must be in [0, 3)" in res["answers"][1][1]["error"]
    assert "reshape" in res["answers"][2][1]["error"]
    for (_, body), (rgb, depth) in zip(
            (res["answers"][0], res["answers"][3]), res["alone"]):
        np.testing.assert_array_equal(np.asarray(body["rgb"], np.uint8), rgb)
        np.testing.assert_array_equal(np.asarray(body["depth"], np.float32),
                                      depth)
    assert res["renders"] == 3 and res["chunk"] == 384
    lines = (cli / "stdout.txt").read_text().splitlines()
    assert lines[-1] == "[serve] stopped"
    assert sum("POST /render" in x for x in lines) == 4


def test_server_failure_after_broadcast_ends_it(monkeypatch):
    """Rank 0 of a two-rank service whose render fails after the request
    went out (a ValueError, which a bad request would turn into a 400):
    the client gets no answer, `run` ends with the error, and nothing
    more is broadcast. A bad request before it still gets its 400 and
    sends nothing."""
    from nsff_pl_tpu_torch.apps import serve
    from nsff_pl_tpu_torch.config import NSFFConfig
    from nsff_pl_tpu_torch.parallel import Mesh, distributed

    sent = []
    monkeypatch.setattr(serve.distributed, "send_request",
                        lambda mesh, kind, t=0, c2w=None: sent.append(kind))
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (3, 1, 1))
    svc = serve.RenderService({}, h.K, poses, (h.W, h.H),
                              NSFFConfig(encode_t=True), device="cpu",
                              mesh=Mesh(None, 0, 2, torch.device("cpu")))

    def failing(*a, **kw):
        raise ValueError("a kernel failed")

    failing.device = svc.device
    svc.render = failing
    server = serve.Server(svc, "127.0.0.1", 0)
    errors = []

    def serve_it():
        try:
            serve.run(svc, server)
        except ValueError as e:
            errors.append(e)

    thread = threading.Thread(target=serve_it)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert h._post(url, {"t": 7})[0] == 400
        assert sent == []
        with pytest.raises(OSError):
            h._post(url, {"t": 1})
    finally:
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert sent == [distributed.RENDER] and svc.broken
    assert [str(e) for e in errors] == ["a kernel failed"]
