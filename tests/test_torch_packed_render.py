"""The port's reference-shaped renderer
(`nsff_pl_tpu_torch/models/rendering.py::render_rays`, the packed-boundary
path) against the JAX package's `render_rays` on the CPU, key for key:
same JAX-initialised weights, same rays, and in train mode the same random
draws (the JAX key splits rebuilt by `tests/torch_train_helpers.jax_draws`).

On the kernel backend (`train_backend='pallas'` / `mlp_backend='pallas'`,
`planar_eval='off'`) the JAX side runs its Pallas kernels in interpret
mode and the port their plain versions. Both round at the same points;
f32 sums run in another order, which now and then flips the bf16 rounding
of one activation, and a per-sample value shows that flip whole. So every
key is held to KERNEL_TOL = 2e-4 abs (measured: at most 7.5e-5, on
`static_sigmas_fine`), and all keys together have at most a twentieth of
their entries off by more than 1e-5 (measured: at most 2.5%); the
disocclusion weights and the maps are sums of such values and stay inside
the same bound. On the plain f32 backend both sides compute the same f32
formulas: 2e-6 abs (measured: at most 2.9e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.models.rendering import render_rays as j_render_rays
from nsff_pl_tpu_torch.models.rendering import RenderConfig, render_rays
from nsff_pl_tpu_torch.training import step as tstep
from tests.torch_train_helpers import (COMMON, FRAMES, NTAU, S, cams,
                                       jax_draws, jax_params, make_rays,
                                       to_torch)

N = 12
KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE = 2e-4, 1e-5, 0.05
F32_TOL = 2e-6
FLOW = ("fw", "bw", "disocc")
PACKED = {k: v for k, v in COMMON.items()
          if k not in ("fused_train", "planar_compositing")}
PACKED.update(train_backend="pallas", mlp_backend="pallas", planar_eval="off",
              img_wh=(16, 16))


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    return make_rays(rng, N), rng.randint(0, FRAMES, N).astype(np.int32)


def _static_params():
    return {"nerf_fine": jn.init_nerf_params(
        jax.random.PRNGKey(3), "fine", use_viewdir=True,
        encode_transient=False)}


def _both(jparams, cfg_kw, *, test_time, flow=(), vis=False, key=None,
          output_transient=True):
    """(JAX results, port results) as dicts of numpy arrays."""
    rays, ts = _scene()
    key = jax.random.PRNGKey(7) if key is None else key
    kw = dict(test_time=test_time, output_transient=output_transient,
              output_transient_flow=flow)
    vis_kw = {}
    if vis:
        Ks, _ = cams()
        poses = np.tile(np.eye(3, 4, dtype=np.float32), (2, 1, 1))
        poses[1, 0, 3] = 0.4  # a second camera, shifted sideways
        vis_kw = dict(vis_poses=poses, vis_K=Ks[0])
    jemb = ({"t": jparams["embedding_t"]} if "embedding_t" in jparams else {})
    jout = j_render_rays(
        {"fine": jparams["nerf_fine"]}, jemb, jnp.asarray(rays),
        jnp.asarray(ts), key, JRenderConfig(**cfg_kw), **kw,
        **{k: jnp.asarray(v) for k, v in vis_kw.items()})
    tparams = to_torch(jparams)
    temb = ({"t": tparams["embedding_t"]} if "embedding_t" in tparams else {})
    with torch.no_grad():
        tout = render_rays(
            {"fine": tparams["nerf_fine"]}, temb, torch.from_numpy(rays),
            torch.from_numpy(ts).long(), RenderConfig(**cfg_kw), **kw,
            draws=None if test_time else jax_draws(key, N), **vis_kw)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def _hold(jout, tout, tol, exact=None, share=None):
    assert set(tout) == set(jout)
    off = total = 0
    for k, want in jout.items():
        got = tout[k]
        assert got.shape == want.shape, k
        err = np.abs(got - want)
        assert err.max() <= tol, (k, err.max())
        if exact is not None:
            off += int((err > exact).sum())
            total += err.size
    if exact is not None:
        assert off <= share * total, off / total


@pytest.mark.parametrize("fused_compositing", [False, True])
def test_train_render_matches_jax(fused_compositing):
    cfg = {**PACKED, "fused_compositing": fused_compositing}
    jout, tout = _both(jax_params(), cfg, test_time=False, flow=FLOW)
    assert {"rgb_fw", "disoccs_bw", "xyzs_fw_bw", "xyz_bw",
            "_static_rgb_fine"} <= set(tout)
    _hold(jout, tout, KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE)


@pytest.mark.parametrize("vis", [False, True])
def test_test_time_render_matches_jax(vis):
    jout, tout = _both(jax_params(), PACKED, test_time=True,
                       flow=("fw", "bw"), vis=vis)
    assert {"static_alphas_fine", "transient_flow_fw"} <= set(tout)
    assert "rgb_fw" not in tout
    _hold(jout, tout, KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE)
    if vis:  # the culling bites: some samples lie outside both frustums
        culled = tout["transient_sigmas_fine"] < 1e-4
        assert 0 < culled.mean() < 1


@pytest.mark.parametrize("test_time", [False, True])
def test_static_only_render_matches_jax(test_time):
    """A model without `encode_t` (no transient branch, no flows)."""
    cfg = {**PACKED, "encode_t": False}
    jout, tout = _both(_static_params(), cfg, test_time=test_time,
                       output_transient=False)
    assert set(tout) == {"zs_fine", "xyzs_fine", "static_rgbs_fine",
                         "static_sigmas_fine", "static_weights_fine",
                         "depth_fine", "rgb_fine"}
    _hold(jout, tout, KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE)


@pytest.mark.parametrize("case", ["train", "test_vis", "static_only"])
def test_float32_plain_backend_matches_jax(case):
    """`compute_dtype='float32'`: the plain evaluators on both sides, with
    the backends on 'auto' (the CPU default) and compositing outside a
    kernel."""
    cfg = {**PACKED, "compute_dtype": "float32", "train_backend": "auto",
           "mlp_backend": "auto", "planar_eval": "auto"}
    if case == "train":
        jout, tout = _both(jax_params(), cfg, test_time=False, flow=FLOW)
    elif case == "test_vis":
        jout, tout = _both(jax_params(), cfg, test_time=True,
                           flow=("fw", "bw"), vis=True)
    else:
        jout, tout = _both(_static_params(), {**cfg, "encode_t": False},
                           test_time=False, output_transient=False)
    _hold(jout, tout, F32_TOL)


def test_draws_from_a_generator_and_key_filter():
    """Without injected draws the renderer draws from the generator, in
    the documented order; `keys` filters the result; make_render_fn passes
    `test_time` through."""
    tparams = to_torch(jax_params())
    rays, ts = _scene()
    rays, ts = torch.from_numpy(rays), torch.from_numpy(ts).long()
    cfg = RenderConfig(**PACKED)
    gen = torch.Generator().manual_seed(4)
    draws = {k: (torch.rand if k == "u" else torch.randn)((N, S), generator=gen)
             for k in ("u", "ns", "nt", "nw1", "nw2")}
    models, emb = {"fine": tparams["nerf_fine"]}, {"t": tparams["embedding_t"]}
    kw = dict(test_time=False, output_transient_flow=FLOW)
    with torch.no_grad():
        a = render_rays(models, emb, rays, ts, cfg, draws=draws, **kw)
        b = render_rays(models, emb, rays, ts, cfg,
                        generator=torch.Generator().manual_seed(4),
                        keys=("rgb_fine", "disocc_fw"), **kw)
    assert set(b) == {"rgb_fine", "disocc_fw"}
    for k in b:
        assert torch.equal(a[k], b[k])
    rfn = tstep.make_render_fn(cfg, test_time=False, output_transient=True,
                               output_transient_flow=FLOW,
                               keys=("rgb_fine", "rgb_fw"), device="cpu")
    c = rfn(tparams, rays, ts, draws=draws)
    assert torch.equal(c["rgb_fw"], a["rgb_fw"])


@pytest.mark.parametrize("bad,match", [
    (dict(train_backend="stub"), "stub"),
    (dict(mesh="a world of one"), "multi-GPU")])
def test_unported_options_name_their_roadmap_items(bad, match, tmp_path):
    """Both options once raised naming their ROADMAP items, and both now
    render. A device mesh at test time ('multi-GPU eval and serving'):
    over a world of one gloo rank in this process the test-time render
    (B5's plain version, both flow heads, visibility culling) gives the
    bits of the render without a mesh, the rays cut to the rank's block
    and gathered back (two ranks: tests/test_torch_parallel_render.py;
    in training: tests/test_torch_parallel.py). The 'stub' train
    backend: the profiling stand-in of the field (tanh(xyz @
    static_xyz_0.w[:3, :16]) for the main evaluation and both warps)
    against the JAX package's, key for key; no bf16 rounding on either
    side, so F32_TOL."""
    if "mesh" not in bad:
        jout, tout = _both(jax_params(), {**PACKED, **bad}, test_time=False,
                           flow=FLOW)
        assert {"rgb_fw", "xyzs_bw_fw", "disoccs_fw", "transient_flows_bw",
                "_static_rgb_fine"} <= set(tout)
        assert match in RenderConfig(**{**PACKED, **bad}).train_backend
        _hold(jout, tout, F32_TOL)
        return
    import torch.distributed as dist

    from nsff_pl_tpu_torch.parallel import mesh as mesh_lib

    tparams = to_torch(jax_params())
    rays, ts = _scene()
    Ks, _ = cams()
    pose = np.eye(3, 4, dtype=np.float32)[None]
    vis = dict(vis_poses=torch.from_numpy(pose), vis_K=torch.from_numpy(Ks[0]))
    kw = dict(test_time=True, output_transient_flow=("fw", "bw"), **vis)
    args = ({"fine": tparams["nerf_fine"]}, {"t": tparams["embedding_t"]},
            torch.from_numpy(rays), torch.from_numpy(ts).long(),
            RenderConfig(**PACKED))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_mesh("cpu")
        gathers = mesh_lib.CALLED["all_gather"]
        with torch.inference_mode():
            got = render_rays(*args, mesh=mesh, **kw)
            want = render_rays(*args, **kw)
        assert mesh_lib.CALLED["all_gather"] == gathers + 1
    finally:
        dist.destroy_process_group()
    assert set(got) == set(want) and "transient_flow_fw" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
