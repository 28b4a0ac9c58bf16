"""The serving slice as a whole: the port's `make_render_fn` +
`render_full_image` and `RenderService` against the JAX package's
`make_render_fn` + `render_full_image` on the same rays, frame indices and
weights (JAX initializer, `params_from_jax`). The JAX side runs the
composited Pallas kernel in interpret mode (`mlp_backend="pallas",
planar_eval="on"`, as tests/test_planar_comp_eval.py does); the port runs
its plain version on CPU tensors. Tolerance 1e-5 abs (same rounding
points on both sides; see tests/test_torch_raymarch_kernel.py)."""
import json
import threading
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.ops import rays as jrays
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu_torch.apps import serve
from nsff_pl_tpu_torch.config import NSFFConfig
from nsff_pl_tpu_torch.models.raymarch import comp_eval_keys
from nsff_pl_tpu_torch.models.rendering import (RenderConfig,
                                                planar_eval_decision)
from nsff_pl_tpu_torch.training import step as tstep
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax

S = 16
N_TAU = 16
N_FRAMES = 4
TOL = 1e-5
K = np.array([[10.0, 0, 4.0], [0, 10.0, 3.0], [0, 0, 1]], np.float32)
SERVE_KEYS = ("rgb_fine", "depth_fine")
VAL_KEYS = ("rgb_fine", "depth_fine", "transient_alpha_fine",
            "_static_rgb_fine", "_static_depth_fine")
FLOW_KEYS = tuple(sorted(comp_eval_keys(True, ("fw", "bw"))))


def _jax_params():
    return {"nerf_fine": jn.init_nerf_params(
        jax.random.PRNGKey(1), "fine", use_viewdir=True,
        encode_transient=True, in_channels_t=N_TAU, output_flow=True),
        "embedding_t": jn.init_embedding(jax.random.PRNGKey(2), N_FRAMES,
                                         N_TAU)}


def _rays(n=10):
    rng = np.random.RandomState(0)
    rays = np.zeros((n, 6), np.float32)
    rays[:, 0:2] = rng.rand(n, 2) * 2 - 1
    rays[:, 2] = -1.0
    rays[:, 3:5] = (rng.rand(n, 2) - 0.5) * 0.4
    rays[:, 5] = 2.0
    ts = rng.randint(0, N_FRAMES, n).astype(np.int32)
    return rays, ts


def _cfg_kw():
    return dict(N_samples=S, use_viewdir=True, encode_t=True, N_tau=N_TAU,
                img_wh=(8, 6), planar_eval="on")


def _poses():
    poses = np.zeros((N_FRAMES, 3, 4), np.float32)
    for i in range(N_FRAMES):
        poses[i, :, :3] = np.eye(3)
        poses[i, :, 3] = [0.05 * i, -0.02 * i, 0.0]
    return poses


@pytest.mark.parametrize("case", ["serving", "validation_view_dir",
                                  "flow_vis", "static_only"])
def test_render_full_image_matches_jax(case):
    keys, flow, vis, output_transient = {
        "serving": (SERVE_KEYS, (), False, True),
        "validation_view_dir": (VAL_KEYS, (), False, True),
        "flow_vis": (FLOW_KEYS, ("fw", "bw"), True, True),
        "static_only": (SERVE_KEYS, (), False, False),
    }[case]
    params_j = _jax_params()
    rays, ts = _rays(10)  # chunk 4: the last chunk is padded
    vis_kw = {}
    if vis:
        vis_kw = dict(vis_poses=_poses()[1:2], vis_K=K)
    if case == "validation_view_dir":  # a fixed view embedding direction
        vis_kw = dict(view_dir=np.tile(rays[:1, 3:6], (10, 1)))
    rfn_j = jstep.make_render_fn(
        JRenderConfig(mlp_backend="pallas", **_cfg_kw()),
        output_transient=output_transient, output_transient_flow=flow,
        with_visibility=vis, keys=keys)
    want = jstep.render_full_image(
        rfn_j, params_j, jnp.asarray(rays), jnp.asarray(ts),
        jax.random.PRNGKey(0), chunk=4,
        **{k: jnp.asarray(v) for k, v in vis_kw.items()})
    rfn_t = tstep.make_render_fn(
        RenderConfig(**_cfg_kw()), output_transient=output_transient,
        output_transient_flow=flow, with_visibility=vis, keys=keys,
        device="cpu")
    got = tstep.render_full_image(
        rfn_t, params_from_jax(jax.tree.map(np.asarray, params_j), "cpu"),
        torch.from_numpy(rays), torch.from_numpy(ts), chunk=4,
        **{k: torch.from_numpy(v) for k, v in vis_kw.items()})
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)


def _service(params_t, device="cpu", chunk=32):
    cfg = NSFFConfig(N_samples=S, use_viewdir=True, encode_t=True,
                     N_tau=N_TAU, planar_eval="on")
    return serve.RenderService(params_t, K, _poses(), (8, 6), cfg,
                               chunk=chunk, device=device)


@pytest.mark.parametrize("t,custom", [(2, False), (1, True)])
def test_render_service_matches_jax(t, custom):
    params_j = _jax_params()
    svc = _service(params_from_jax(jax.tree.map(np.asarray, params_j),
                                   "cpu"))
    c2w = _poses()[t].copy()
    if custom:
        c2w[:, 3] += [0.03, 0.01, -0.05]
    # the JAX scene's ray construction (scene/monocular.py::_frame_rays)
    dirs = jrays.get_ray_directions(6, 8, K)
    ro, rd = jrays.get_rays(dirs, c2w)
    ro, rd = jrays.get_ndc_rays(K, 1.0, -min(-1.0, float(c2w[2, 3])), ro, rd)
    rays = jnp.concatenate([ro, rd], 1)
    rfn_j = jstep.make_render_fn(
        JRenderConfig(mlp_backend="pallas", compute_dtype="bfloat16",
                      **_cfg_kw()),
        output_transient=True, keys=SERVE_KEYS)
    want = jstep.render_full_image(
        rfn_j, params_j, rays, jnp.full((48,), t, jnp.int32),
        jax.random.PRNGKey(42), chunk=32)
    np.testing.assert_allclose(svc.frame_rays(c2w).numpy(),
                               np.asarray(rays), atol=1e-5)
    got = svc.render_maps(t, c2w if custom else None)
    for k in SERVE_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)
    rgb, depth = svc.render_pose(t, c2w.tolist() if custom else None)
    assert rgb.dtype == np.uint8 and rgb.shape == (6, 8, 3)
    ref_rgb = (np.clip(np.asarray(want["rgb_fine"]), 0, 1).reshape(6, 8, 3)
               * 255).astype(np.uint8)
    assert np.abs(rgb.astype(int) - ref_rgb.astype(int)).max() <= 1
    np.testing.assert_allclose(depth, np.asarray(want["depth_fine"]).reshape(
        6, 8), atol=TOL)


def test_decision_reads_cuda_and_bfloat16():
    bf16 = RenderConfig(compute_dtype="bfloat16")
    assert planar_eval_decision(bf16, "cuda") == (True, [])
    assert not planar_eval_decision(RenderConfig(), "cuda")[0]
    assert not planar_eval_decision(bf16, "cpu")[0]
    assert planar_eval_decision(RenderConfig(planar_eval="on"), "cpu")[0]
    off = RenderConfig(planar_eval="off", compute_dtype="bfloat16")
    assert planar_eval_decision(off, "cuda") == (False, ["planar_eval='off'"])
    assert planar_eval_decision(
        RenderConfig(mlp_backend="pallas"), "cpu") == (True, [])
    assert not planar_eval_decision(
        RenderConfig(mlp_backend="xla", compute_dtype="bfloat16"), "cuda")[0]
    with pytest.raises(ValueError, match="planar_eval"):
        planar_eval_decision(RenderConfig(planar_eval="maybe"), "cuda")


@pytest.mark.parametrize("route", ["planes", "coarse_to_fine", "packed"])
def test_unported_routes_raise(route):
    """Coarse-to-fine renders on the planar path (on both routes, held
    against JAX in tests/test_torch_c2f.py) and on the packed path
    (`planar_eval='off'`, held against JAX in
    tests/test_torch_packed_c2f.py), and without the coarse model raises
    a ValueError; the plain evaluators render in bfloat16 too; the planes
    route itself (`planes`: per-sample keys, held
    against JAX in tests/test_torch_planes_route.py) and the packed path
    (`packed`: planar_eval='auto' on the CPU, see
    tests/test_torch_packed_render.py) render."""
    params = params_from_jax(jax.tree.map(np.asarray, _jax_params()), "cpu")
    rays, ts = _rays(4)

    def render(keys=SERVE_KEYS, **over):
        rfn = tstep.make_render_fn(RenderConfig(**{**_cfg_kw(), **over}),
                                   output_transient=True, keys=keys,
                                   device="cpu")
        return tstep.render_full_image(rfn, params, torch.from_numpy(rays),
                                       torch.from_numpy(ts), chunk=4)

    if route == "planes":
        out = render(keys=("rgb_fine", "weights_fine"))
        assert out["weights_fine"].shape == (4, S)
        assert bool(torch.isfinite(out["rgb_fine"]).all())
        with pytest.raises(ValueError, match="params_coarse"):
            render(keys=("rgb_fine", "weights_fine"), N_importance=4)
    elif route == "coarse_to_fine":
        with pytest.raises(ValueError, match="coarse model"):
            render(N_importance=4, planar_eval="off")
        params["nerf_coarse"] = params_from_jax(jax.tree.map(
            np.asarray, jn.init_nerf_params(
                jax.random.PRNGKey(3), "coarse", use_viewdir=True,
                encode_transient=True, in_channels_t=N_TAU)), "cpu")
        for keys in (SERVE_KEYS, ("rgb_fine", "weights_fine")):
            for over in ({}, {"planar_eval": "off"}):
                out = render(keys=keys, N_importance=4, **over)
                assert set(out) == set(keys)
                assert bool(torch.isfinite(out["rgb_fine"]).all())
    else:
        out = render(planar_eval="auto")
        assert set(out) == set(SERVE_KEYS)
        assert bool(torch.isfinite(out["rgb_fine"]).all())
        out = render(planar_eval="auto", compute_dtype="bfloat16")
        assert set(out) == set(SERVE_KEYS)
        assert bool(torch.isfinite(out["rgb_fine"]).all())


def _http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get_content_type(), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get_content_type(), e.read()


def test_http_endpoints():
    from http.server import HTTPServer

    params = params_from_jax(jax.tree.map(np.asarray, _jax_params()), "cpu")
    svc = _service(params, chunk=16)
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _http(base + "/health")[2] == b'{"status": "ok"}'
        meta = json.loads(_http(base + "/meta")[2])
        assert meta["n_frames"] == N_FRAMES and meta["img_wh"] == [8, 6]
        code, ctype, png = _http(base + "/render", {"t": 1})
        assert (code, ctype) == (200, "image/png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        code, _, body = _http(base + "/render?format=json",
                              {"t": 1, "c2w": _poses()[2].tolist()})
        out = json.loads(body)
        assert code == 200 and np.asarray(out["rgb"]).shape == (6, 8, 3)
        assert _http(base + "/render", {"t": N_FRAMES})[0] == 400
        assert _http(base + "/nope")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    # the PNG holds the rendered frame
    rgb, _ = svc.render_pose(1)
    idat = png[png.index(b"IDAT") + 4:png.index(b"IEND") - 8]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(6, 25)
    np.testing.assert_array_equal(raw[:, 1:].reshape(6, 8, 3), rgb)


def test_serve_cli_options():
    args = serve.get_opts(["--ckpt_path", "p.pt", "--scene_meta", "s.npz",
                           "--encode_t", "--use_viewdir"])
    assert args.device == "cuda" and args.N_samples == 128
    assert args.img_wh == [512, 288] and args.chunk == 32768
