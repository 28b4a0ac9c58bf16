"""The port's serving export (`nsff_pl_tpu_torch/tools/export_render.py`,
`ops/library.py`) on the CPU, against the JAX package's
`tools/export_render.py` and renderer, on JAX-initialised weights
(`params_from_jax`, written as a port checkpoint) and rays made from a
numpy seed.

- The `xla` route (float32, the plain evaluators) reloaded with
  `torch.export.load` equals the JAX tool's `build_serve_fn` within
  F32_TOL = 2e-6 (both compute the same f32 formulas), and reloads in a
  subprocess that imports no module of the port.
- The `pallas` route (bfloat16): with `encode_t` the planar route, whose
  graph holds the `nsff_torch::planar_eval_comp` node (B1), held against
  the JAX tool's `build_serve_fn` with `mlp_backend='pallas'` (B1 in
  Pallas interpret mode) within PLANAR_TOL = 1e-5
  (tests/test_torch_render.py); without `encode_t` the packed route,
  whose graph holds `nsff_torch::fused_nerf_eval` (B5), held against the
  JAX renderer with `mlp_backend='pallas', planar_eval='off'` (B5
  interpreted) within KERNEL_TOL = 2e-4
  (tests/test_torch_packed_render.py). On CPU tensors the ops run their
  plain versions. Coarse-to-fine on both kernel routes (sample_pdf and
  the sort traced; the planar route's coarse pass as one
  `nsff_torch::planar_nerf_train_fwd` node, B2's forward) reloads equal
  to the live renderer within CHECK_TOL (`--check`).
- The sidecar's keys, `--platforms` (one device), and
  `torch.library.opcheck` on the three ops.
S = 64 on the planar route. Torch runs on one thread.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.config import NSFFConfig as JConfig
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import build_params as j_build_params
from nsff_pl_tpu_torch.ops import library
from nsff_pl_tpu_torch.ops import mlp_kernel as mk
from nsff_pl_tpu_torch.ops import raymarch_kernel as rk
from nsff_pl_tpu_torch.tools import export_render as ter
from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
from tools import export_render as jer

S, NTAU, FRAMES, CHUNK = 64, 16, 4, 32
F32_TOL, PLANAR_TOL, KERNEL_TOL = 2e-6, 1e-5, 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(encode_t, backend, dtype, n_importance=0):
    return (["--chunk", str(CHUNK), "--img_wh", "16", "12", "--use_viewdir",
             "--N_samples", str(S), "--N_importance", str(n_importance),
             "--N_tau", str(NTAU), "--N_frames", str(FRAMES),
             "--output_transient", "--mlp_backend", backend, "--dtype", dtype]
            + (["--encode_t"] if encode_t else []))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{(encode_t, n_importance): (port checkpoint dir, JAX params)}."""
    tmp = tmp_path_factory.mktemp("export")
    out = {}
    for encode_t, ni in ((True, 0), (False, 0), (False, 16), (True, 16)):
        jparams = j_build_params(
            JConfig(use_viewdir=True, encode_t=encode_t, N_tau=NTAU,
                    N_importance=ni, start_end=(0, FRAMES)),
            jax.random.PRNGKey(3))
        params = ckpt_lib.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          "cpu")
        path = ckpt_lib.save_checkpoint(str(tmp / f"t{int(encode_t)}_{ni}"),
                                        0, {"params": params})
        out[(encode_t, ni)] = (path, jparams)
    return out


def _rays(seed=0):
    rng = np.random.RandomState(seed)
    rays = np.zeros((CHUNK, 6), np.float32)
    rays[:, 0:2] = rng.rand(CHUNK, 2) * 2 - 1
    rays[:, 2] = -1.0
    rays[:, 3:5] = (rng.rand(CHUNK, 2) - 0.5) * 0.4
    rays[:, 5] = 2.0
    return rays, rng.randint(0, FRAMES, CHUNK)


def _export(tmp_path, ckpt, flags, name="render.pt2", check=False):
    out = str(tmp_path / name)
    argv = ["--ckpt_path", ckpt, "--out", out, "--platforms", "cpu", *flags]
    meta = ter.main(ter.get_opts(argv + (["--check"] if check else [])))
    return out, meta


def _run(path, rays, ts):
    prog = torch.export.load(path).module()
    with torch.no_grad():
        rgb, depth = prog(torch.from_numpy(rays), torch.from_numpy(ts))
    return rgb.numpy(), depth.numpy()


def _ops(path):
    return {str(n.target) for n in torch.export.load(path).graph.nodes
            if str(n.target).startswith(library.NAMESPACE)}


@pytest.fixture(scope="module")
def xla_artifact(ckpts, tmp_path_factory):
    """The `xla` route's artifact of the encode_t model, with --check."""
    tmp = tmp_path_factory.mktemp("xla")
    return _export(tmp, ckpts[(True, 0)][0], _flags(True, "xla", "float32"),
                   check=True)


def test_xla_route_matches_jax_export(ckpts, xla_artifact):
    _, jparams = ckpts[(True, 0)]
    flags = _flags(True, "xla", "float32")
    path, meta = xla_artifact
    assert meta["imports"] == ["torch"] and not _ops(path)
    assert max(meta["check"].values()) <= ter.CHECK_TOL
    rays, ts = _rays()
    serve = jer.build_serve_fn(jer.get_opts(
        ["--ckpt_path", "unused", "--out", "unused", *flags]), jparams)
    want = serve(jnp.asarray(rays), jnp.asarray(ts, jnp.int32))
    for g, w in zip(_run(path, rays, ts), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=F32_TOL)


def test_planar_kernel_route_matches_jax(ckpts, tmp_path):
    ckpt, jparams = ckpts[(True, 0)]
    flags = _flags(True, "pallas", "bfloat16")
    path, meta = _export(tmp_path, ckpt, flags)
    assert _ops(path) == {"nsff_torch.planar_eval_comp.default"}
    assert meta["imports"] == ["torch", ter.OPS_MODULE]
    rays, ts = _rays()
    serve = jer.build_serve_fn(jer.get_opts(
        ["--ckpt_path", "unused", "--out", "unused", *flags]), jparams)
    want = serve(jnp.asarray(rays), jnp.asarray(ts, jnp.int32))
    for g, w in zip(_run(path, rays, ts), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PLANAR_TOL)


def test_packed_kernel_route_matches_jax(ckpts, tmp_path):
    ckpt, jparams = ckpts[(False, 0)]
    path, _ = _export(tmp_path, ckpt, _flags(False, "pallas", "bfloat16"))
    assert _ops(path) == {"nsff_torch.fused_nerf_eval.default"}
    rays, ts = _rays()
    render = jstep.make_render_fn(
        JRenderConfig(N_samples=S, use_viewdir=True, N_tau=NTAU,
                      max_t=FRAMES - 1, compute_dtype="bfloat16",
                      mlp_backend="pallas", planar_eval="off",
                      fused_train="off"),
        test_time=True, output_transient=False, keys=ter.OUTPUT_KEYS)
    want = render(jparams, jnp.asarray(rays), jnp.asarray(ts, jnp.int32),
                  jax.random.PRNGKey(42))
    for g, k in zip(_run(path, rays, ts), ter.OUTPUT_KEYS):
        np.testing.assert_allclose(g, np.asarray(want[k]), rtol=0,
                                   atol=KERNEL_TOL)


def test_coarse_to_fine_export(ckpts, tmp_path):
    """Both kernel routes with N_importance: the coarse pass, sample_pdf
    and the sort trace, and the reloaded program equals the live renderer
    (--check). The packed route's coarse pass runs the plain evaluators
    (its graph holds B5 alone); the planar route's runs B2's forward, one
    `planar_nerf_train_fwd` node beside B1's, with no backward."""
    ckpt, _ = ckpts[(False, 16)]
    path, meta = _export(tmp_path, ckpt, _flags(False, "pallas", "bfloat16",
                                                16), check=True)
    assert _ops(path) == {"nsff_torch.fused_nerf_eval.default"}
    assert max(meta["check"].values()) <= ter.CHECK_TOL
    ckpt, _ = ckpts[(True, 16)]
    path, meta = _export(tmp_path, ckpt, _flags(True, "pallas", "bfloat16",
                                                16), name="planar.pt2",
                         check=True)
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if str(n.target).startswith(library.NAMESPACE)]
    assert sorted(targets) == ["nsff_torch.planar_eval_comp.default",
                               "nsff_torch.planar_nerf_train_fwd.default"]
    assert meta["imports"] == ["torch", ter.OPS_MODULE]
    assert max(meta["check"].values()) <= ter.CHECK_TOL


def test_sidecar_and_platforms(ckpts, tmp_path):
    ckpt, _ = ckpts[(False, 0)]
    path, _ = _export(tmp_path, ckpt, _flags(False, "xla", "float32"))
    meta = json.load(open(path + ".json"))
    assert meta["inputs"]["rays"] == [CHUNK, 6]
    assert meta["inputs"]["ts"] == [CHUNK]
    assert meta["outputs"] == ["rgb_fine", "depth_fine"]
    assert meta["platforms"] == ["cpu"]
    assert "ckpt_path" not in meta["flags"] and meta["flags"]["chunk"] == CHUNK
    for platforms in (["cpu", "cuda"], ["tpu"]):
        with pytest.raises(ValueError, match="one device"):
            ter.export_device(ter.get_opts(
                ["--ckpt_path", ckpt, "--out", path, "--platforms",
                 *platforms]))


def test_xla_artifact_loads_with_torch_alone(xla_artifact, tmp_path):
    path, _ = xla_artifact
    rays, ts = _rays(1)
    np.save(tmp_path / "rays.npy", rays)
    np.save(tmp_path / "ts.npy", ts)
    code = (
        "import sys, numpy as np, torch\n"
        f"prog = torch.export.load({path!r}).module()\n"
        "rgb, depth = prog(torch.from_numpy(np.load('rays.npy')), "
        "torch.from_numpy(np.load('ts.npy')))\n"
        "np.save('rgb.npy', rgb.detach().numpy())\n"
        "bad = [m for m in sys.modules if m.startswith('nsff')]\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "rgb.npy"),
                                  _run(path, rays, ts)[0])


def _op_inputs(encode_t):
    """Small inputs of the two ops (weights of a seeded port model)."""
    from nsff_pl_tpu_torch.models import nerf as tn

    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=encode_t, in_channels_t=NTAU,
                                 output_flow=encode_t, device="cpu")
    n = 3
    rays = torch.from_numpy(_rays()[0][:n])
    o, d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    de = torch.rand((n, 27), generator=g)
    te = torch.rand((n, NTAU), generator=g) if encode_t else None
    return params, o, d, de, te


@pytest.mark.parametrize("op", ["planar_eval_comp", "fused_nerf_eval",
                                "planar_nerf_train_fwd"])
def test_opcheck(op):
    if op == "planar_nerf_train_fwd":
        params, o, d, de, te = _op_inputs(True)
        fn = rk.make_planar_nerf_train(S, use_viewdir=True, encode_t=True,
                                       output_flow=("fw", "bw"), n_tau=NTAU)
        zs = torch.linspace(0, 1, S).expand(o.shape[0], S).contiguous()
        w, b, slots = library.slot_lists(fn.pack(params))
        kk = fn.kernel_kw
        kw = dict(freqs=list(kk["freqs"]), static_branch=True,
                  use_viewdir=True, encode_a=False, encode_t=True,
                  flow_fw=True, flow_bw=True, flow_scale=kk["flow_scale"],
                  D=8, skips=list(kk["skips"]))
        args = (w, b, slots, o, d, zs, [], de, None, te)
        want = rk.planar_nerf_train_ref(fn.pack(params), o, d, zs, None, de,
                                        None, te, **kk)
    elif op == "planar_eval_comp":
        params, o, d, de, te = _op_inputs(True)
        fn = rk.make_planar_nerf_eval_comp(S, use_viewdir=True, encode_t=True,
                                           n_tau=NTAU)
        zs = torch.linspace(0, 1, S).expand(o.shape[0], S).contiguous()
        w, b, slots = library.slot_lists(fn.pack(params))
        kw = dict(fn.kernel_kw, freqs=list(fn.kernel_kw["freqs"]),
                  skips=list(fn.kernel_kw["skips"]))
        args = (w, b, slots, o, d, zs, None, de, None, te)
        want = rk.planar_eval_comp_ref(fn.pack(params), o, d, zs, None, de,
                                       None, te, **fn.kernel_kw)
    else:
        params, o, d, de, _ = _op_inputs(False)
        fn = mk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                     encode_t=False, output_flow=())
        xyz = o[:, None] + d[:, None] * torch.linspace(0, 1, S)[:, None]
        w, b, slots = library.slot_lists(fn.pack(params))
        kk = fn.kernel_kw
        kw = dict(freqs=list(kk["freqs"]), static_branch=True,
                  use_viewdir=True, encode_a=False, encode_t=False,
                  flow_fw=False, flow_bw=False, flow_scale=kk["flow_scale"],
                  D=8, skips=list(kk["skips"]))
        args = (w, b, slots, xyz.contiguous(), de, None, None)
        want = mk.fused_nerf_eval_ref(fn.pack(params), xyz.contiguous(), de,
                                      None, None, **kk)
    fn_op = getattr(library, op)
    torch.library.opcheck(fn_op, args, kw)
    assert torch.equal(fn_op(*args, **kw), want)
