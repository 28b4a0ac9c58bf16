"""Coarse-to-fine (`N_importance > 0`) on the port's planar path against
the JAX package on the CPU: `ops/sampling.py::sample_pdf` (deterministic
and on injected uniforms), `ops/rays.py::world2ndc`, the test-time
render `render_test_planar` on both routes with and without
`output_transient` (the transient case with a visibility set), and the
training render `render_train_planar` + `compute_losses_planar` with the
gradients of the fine model, the coarse model and the time embedding.
Weights are JAX-initialised (`params_from_jax`, with `nerf_coarse`), the
inputs seeded numpy, the draws rebuilt from the JAX key
(`jax_c2f_draws`); the JAX side runs its Pallas kernels in interpret mode
and each JAX result is computed once per module.

Tolerances. `sample_pdf`: 5e-6 abs (the same f32 formulas, but the
CDF's sums run in another order and a draw divides by its bin's CDF
step: measured 1.0e-6 on depths in [0, 1]); `world2ndc` 1e-6 relative.
The test render: per-ray keys and composite planes 2e-4 abs, the
per-sample keys of the evaluator 2e-3 abs with at most a tenth of the
samples off by more than 1e-5, and the fine depths (the importance
draws) 1e-5 abs. The
fine depths are no longer on a dyadic grid, so XLA's fused multiply-add
in o + d*z and torch's separate product and sum part in the last bit of
a posenc argument and now and then flip one bf16 rounding, shown whole
in that sample (tests/test_torch_train_kernel.py); the coarse weights
that place the draws carry such flips too. The training render: loss
terms 1e-3 relative and gradients 5e-2 in Frobenius norm and 0.1 of each
leaf's largest entry, the bounds and reasons of
tests/test_torch_train_step.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models import raymarch as jraymarch
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.ops import rays as jrays
from nsff_pl_tpu.ops import sampling as jsampling
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu_torch.models import raymarch as traymarch
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.ops import rays as trays
from nsff_pl_tpu_torch.ops import sampling as tsampling
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from tests.torch_train_helpers import (FRAMES, LOSS_RTOL, N, NTAU, S, cams,
                                       grads_close, make_batch, to_torch)

NI = 8
MAP_TOL = 2e-4
PLANE_TOL, PLANE_SHARE = 2e-3, 0.1
ZS_TOL = 1e-5
PLANE_KEYS = ("static_rgbs_fine", "transient_rgbs_fine",
              "static_sigmas_fine", "transient_sigmas_fine",
              "transient_flows_fw", "transient_flows_bw",
              "static_alphas_fine", "transient_alphas_fine")
ZS_KEYS = ("zs_fine", "static_zs_fine", "transient_zs_fine", "xyzs_fine")
FLOW = ("fw", "bw")
K = np.array([[10.0, 0, 4.0], [0, 10.0, 3.0], [0, 0, 1]], np.float32)
COMMON = dict(N_samples=S, N_importance=NI, use_viewdir=True, encode_t=True,
              N_tau=NTAU, max_t=FRAMES - 1, img_wh=(8, 6),
              compute_dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops; the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_c2f_params(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"nerf_fine": jn.init_nerf_params(
                ks[0], "fine", use_viewdir=True, in_channels_t=NTAU,
                encode_transient=True, output_flow=True),
            "nerf_coarse": jn.init_nerf_params(
                ks[1], "coarse", use_viewdir=True, in_channels_t=NTAU,
                encode_transient=True),
            "embedding_t": jn.init_embedding(ks[2], FRAMES, NTAU)}


def jax_c2f_draws(key, n, s=S, ni=NI):
    """The JAX training render's draws from its key, under the port's
    names (models/raymarch.py::render_train_planar lists the splits)."""
    k_perturb, k_pdf_s, k_pdf_t, k_rest = jax.random.split(key, 4)
    k_coarse, k_fine = jax.random.split(k_rest)
    kc = jax.random.split(k_coarse, 4)
    kf = jax.random.split(k_fine, 4)
    sf = s + 2 * ni
    out = {"u": jax.random.uniform(k_perturb, (n, s)),
           "u_pdf_s": jax.random.uniform(k_pdf_s, (n, ni)),
           "u_pdf_t": jax.random.uniform(k_pdf_t, (n, ni)),
           "ncs": jax.random.normal(kc[0], (n, s)),
           "nct": jax.random.normal(kc[1], (n, s))}
    out.update({k: jax.random.normal(kk, (n, sf))
                for k, kk in zip(("ns", "nt", "nw1", "nw2"), kf)})
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    """Deterministic draws (XLA's linspace bits) and draws on injected
    uniforms, over weights with empty bins (the 1e-5 floor)."""
    rng = np.random.RandomState(7)
    m, n = 30, 24
    bins = np.sort(rng.rand(n, m + 1), 1).astype(np.float32)
    w = rng.rand(n, m).astype(np.float32)
    w[:, ::4] = 0.0
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (n, 13)))
    want = np.asarray(jsampling.sample_pdf(key, jnp.asarray(bins),
                                           jnp.asarray(w), 13, det=det))
    got = tsampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w),
                               13, det=det,
                               u=None if det else torch.from_numpy(u.copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=0)
    if det:
        lin = np.asarray(jnp.linspace(0.0, 1.0, 13))
        np.testing.assert_array_equal(tsampling.linspace01(13).numpy(), lin)


def test_world2ndc_matches_jax():
    rng = np.random.RandomState(2)
    xyz = rng.randn(5, 7, 3).astype(np.float32)
    xyz[..., 2] = -1.5 - rng.rand(5, 7)
    want = np.asarray(jrays.world2ndc(jnp.asarray(xyz), jnp.asarray(K)))
    got = trays.world2ndc(torch.from_numpy(xyz), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    back = trays.ndc2world(torch.from_numpy(got), K, eps=0.0).numpy()
    np.testing.assert_allclose(back, xyz, rtol=1e-4)


def _test_inputs():
    rng = np.random.RandomState(0)
    rays = np.zeros((N, 6), np.float32)
    rays[:, 0:2] = rng.randint(-48, 48, (N, 2)) / 64
    rays[:, 2] = -1.0
    rays[:, 3:5] = rng.randint(-12, 12, (N, 2)) / 64
    rays[:, 5] = 2.0
    ts = rng.randint(0, FRAMES, N).astype(np.int32)
    poses = np.zeros((1, 3, 4), np.float32)
    poses[0, :, :3] = np.eye(3)
    poses[0, :, 3] = [0.05, -0.02, 0.0]
    return rays, ts, poses


def _keys(route, output_transient):
    if route == "planes":
        return None
    return tuple(sorted(traymarch.comp_eval_keys(
        output_transient, FLOW if output_transient else ())))


@pytest.fixture(scope="module")
def jax_test_renders():
    """The JAX test render by (route, output_transient), each under one
    jax.jit (an eager call traces its evaluator's kernel anew each
    time)."""
    jp = jax_c2f_params()
    rays, ts, poses = _test_inputs()
    out = {}
    for route in ("composited", "planes"):
        for ot in (True, False):
            def render(p, r, t, vp, vk, ot=ot, route=route):
                vis = {"vis_poses": vp, "vis_K": vk} if ot else {}
                return jraymarch.render_test_planar(
                    p["nerf_fine"], {"t": p["embedding_t"]}, r, t,
                    jax.random.PRNGKey(0),
                    JRenderConfig(mlp_backend="pallas", **COMMON),
                    params_coarse=p["nerf_coarse"], output_transient=ot,
                    output_transient_flow=FLOW if ot else (),
                    keys=_keys(route, ot), **vis)

            out[route, ot] = jax.jit(render)(
                jp, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(poses),
                jnp.asarray(K))
    return jp, out


@pytest.mark.parametrize("route", ["composited", "planes"])
@pytest.mark.parametrize("output_transient", [True, False])
def test_render_test_c2f_matches_jax(jax_test_renders, route,
                                     output_transient):
    """Both routes, both towers (visibility culling against one camera) and
    the static tower alone: S_fine = 32 and 24. The composited route's
    result holds the coarse keys beside the maps, as the JAX one."""
    jp, renders = jax_test_renders
    want = renders[route, output_transient]
    pt = to_torch(jp)
    rays, ts, poses = _test_inputs()
    vis = (dict(vis_poses=torch.from_numpy(poses), vis_K=torch.from_numpy(K))
           if output_transient else {})
    cfg = RenderConfig(planar_eval="on", planar_compositing="on", **COMMON)
    with torch.inference_mode():
        got = traymarch.render_test_planar(
            pt["nerf_fine"], {"t": pt["embedding_t"]},
            torch.from_numpy(rays), torch.from_numpy(ts).long(), cfg,
            params_coarse=pt["nerf_coarse"],
            output_transient=output_transient,
            output_transient_flow=FLOW if output_transient else (),
            keys=_keys(route, output_transient), **vis)
    assert set(got) == set(want)
    sf = S + (2 if output_transient else 1) * NI
    assert got["static_zs_fine"].shape == (N, NI)
    if route == "planes":
        assert got["zs_fine"].shape == (N, sf)
    for k in want:
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        if k in PLANE_KEYS:
            assert err.max() <= PLANE_TOL, (k, err.max())
            assert (err > 1e-5).mean() <= PLANE_SHARE, (k, (err > 1e-5).mean())
        elif k in ZS_KEYS:
            assert err.max() <= ZS_TOL, (k, err.max())
        else:
            assert err.max() <= MAP_TOL, (k, err.max())


def test_render_test_c2f_needs_the_coarse_model():
    rays, ts, _ = _test_inputs()
    pt = to_torch(jax_c2f_params())
    with pytest.raises(ValueError, match="params_coarse"):
        traymarch.render_test_planar(
            pt["nerf_fine"], {"t": pt["embedding_t"]},
            torch.from_numpy(rays), torch.from_numpy(ts).long(),
            RenderConfig(planar_eval="on", **COMMON))


@pytest.fixture(scope="module")
def jax_train_render():
    """The JAX training render + loss: its terms and gradients."""
    jp = jax_c2f_params(1)
    b = make_batch()
    Ks, Ps = cams()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(5)
    jcfg = JRenderConfig(perturb=1.0, noise_std=1.0, train_backend="pallas",
                         fused_train="on", planar_compositing="on", **COMMON)

    def loss_fn(p):
        res = jraymarch.render_train_planar(
            p["nerf_fine"], {"t": p["embedding_t"]}, jb["rays"], jb["ts"],
            key, jcfg, params_coarse=p["nerf_coarse"])
        ld = jloss.compute_losses_planar(
            res, jb, jloss.LossConfig(max_t=FRAMES - 1), epoch=2,
            Ks=jnp.asarray(Ks), Ps=jnp.asarray(Ps))
        return jloss.total_loss(ld), (ld, res["zs"], res["rgb_coarse"])

    (_, (ld, zs, rgb_c)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    return jp, key, ld, np.asarray(zs), np.asarray(rgb_c), g


def test_render_train_c2f_matches_jax(jax_train_render):
    """The coarse-to-fine training render (S_fine = 32, the coarse terms
    in `col_l` and `disp_l`) on the JAX draws: every loss term, the fine
    depths, the coarse rgb and the gradients of all three leaves' trees."""
    jp, key, jld, jzs, jrgb_c, jg = jax_train_render
    params = to_torch(jp)
    for leaf in toptim.param_leaves(params):
        leaf.requires_grad_(True)
    b = make_batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"], tb["cam_ids"] = tb["ts"].long(), tb["cam_ids"].long()
    Ks, Ps = cams()
    cfg = RenderConfig(perturb=1.0, noise_std=1.0, train_backend="pallas",
                       fused_train="on", planar_compositing="on", **COMMON)
    draws = jax_c2f_draws(key, N)
    assert {k: tuple(v.shape) for k, v in draws.items()} == \
        traymarch.draw_shapes(cfg, N)
    res = traymarch.render_train_planar(
        params["nerf_fine"], {"t": params["embedding_t"]}, tb["rays"],
        tb["ts"], cfg, params_coarse=params["nerf_coarse"], draws=draws)
    ld = tloss.compute_losses_planar(res, tb,
                                     tloss.LossConfig(max_t=FRAMES - 1),
                                     epoch=2, Ks=torch.from_numpy(Ks),
                                     Ps=torch.from_numpy(Ps))
    tloss.total_loss(ld).backward()
    np.testing.assert_allclose(res["zs"].detach().numpy(), jzs, atol=ZS_TOL)
    np.testing.assert_allclose(res["rgb_coarse"].detach().numpy(), jrgb_c,
                               atol=MAP_TOL)
    assert set(ld) == set(jld) and len(ld) == 11
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    grads_close(jax.tree.map(
        lambda t: (t.grad if t.grad is not None else torch.zeros_like(t))
        .numpy(), params, is_leaf=lambda x: isinstance(x, torch.Tensor)), jg)
