"""The planar train path's warp variants and the 'stub' train backend of
the port against the JAX package on the CPU, at the sizes of
tests/torch_train_helpers.py (N = 48, S = 16).

- `render_train_planar` + `compute_losses_planar` + `total_loss` and
  their gradients for `warp_subsample=2`, `warp_importance=0.5` (both on
  the fused compositor's plain version against JAX's Pallas compositor in
  interpret mode) and `planar_compositing='off'` (plain composites on both
  sides), from the same weights, batch
  and draws: the JAX key splits rebuilt, the K-row warp noises and the
  selection's uniform `uniform(fold_in(k_rest, 7), ())` included. The
  selected rays and their weights equal JAX's; loss terms are held to
  LOSS_RTOL and gradients to GRAD_FRO / GRAD_MAX, for the reasons given
  in tests/test_torch_train_step.py.
- `_importance_select` alone: `idx` equal to JAX's and `v` within 1e-6
  relative on the same scores and uniform, from 48 rays to 4096 (the
  blocked cumulative sum crosses its 1024-wide rows), but for a slot on a
  tie, shown to be one.
- `warp_importance=1.0` keeps every ray once with weight 1 and gives the
  exact branch's results and loss terms (the JAX package's
  tests/test_warp_importance.py::test_warp_importance_full_matches_exact).
- The stub step (`train_backend='stub'` on the packed path) against the
  JAX package's stub step: loss terms and Adam's moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.models.raymarch import _importance_select as j_select
from nsff_pl_tpu.models.raymarch import render_train_planar as j_render
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.models.raymarch import (_importance_select,
                                               render_train_planar)
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.test_torch_train_step import _step_inputs, _table
from tests.torch_train_helpers import (COMMON, FRAMES, LOSS_RTOL, N, NTAU, S,
                                       cams, grads_close, jax_draws,
                                       jax_params, make_batch, to_torch)

VARIANTS = {"ws2": dict(warp_subsample=2),
            "wi": dict(warp_importance=0.5),
            "off": dict(planar_compositing="off")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's render is thousands of small ops; with the test workers'
    threads already on every core, torch's own pool only waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant_draws(key, n, K=0):
    """The JAX renderer's draws from its key: `jax_draws`, and under
    warp_importance the K-row warp noises and the selection's uniform."""
    draws = jax_draws(key, n)
    if K:
        _, _, _, k_rest = jax.random.split(key, 4)
        _, k_fine = jax.random.split(k_rest)
        ks = jax.random.split(k_fine, 4)
        draws["nw1"] = torch.from_numpy(np.asarray(
            jax.random.normal(ks[2], (K, S))))
        draws["nw2"] = torch.from_numpy(np.asarray(
            jax.random.normal(ks[3], (K, S))))
        if K < n:
            draws["u_sel"] = torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.fold_in(k_rest, 7), ())))
    return draws


def _torch_batch(b):
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"] = tb["ts"].long()
    tb["cam_ids"] = tb["cam_ids"].long()
    return tb


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_render_loss_and_grads_match_jax(variant):
    rkw = {**COMMON, **VARIANTS[variant]}
    jcfg, tcfg = JRenderConfig(**rkw), RenderConfig(**rkw)
    lcfg = dict(max_t=FRAMES - 1)
    b = make_batch()
    Ks, Ps = cams()
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    epoch = 2

    def jloss_fn(p):
        res = j_render(p["nerf_fine"], {"t": p["embedding_t"]}, jb["rays"],
                       jb["ts"], key, jcfg)
        ld = jloss.compute_losses_planar(
            res, jb, jloss.LossConfig(**lcfg), epoch=epoch,
            Ks=jnp.asarray(Ks), Ps=jnp.asarray(Ps))
        sel = (res["warp_idx"], res["warp_v"]) if "warp_idx" in res else ()
        return jloss.total_loss(ld), (ld, sel)

    jparams = jax_params()
    # under one jit: an eager call runs the interpreted kernels op by op
    (_, (jld, jsel)), jg = jax.jit(jax.value_and_grad(jloss_fn,
                                                      has_aux=True))(jparams)

    params = to_torch(jparams)
    for leaf in toptim.param_leaves(params):
        leaf.requires_grad_(True)
    tb = _torch_batch(b)
    K = max(int(round(tcfg.warp_importance * N)), 1) \
        if tcfg.warp_importance else 0
    res = render_train_planar(params["nerf_fine"],
                              {"t": params["embedding_t"]}, tb["rays"],
                              tb["ts"], tcfg, draws=variant_draws(key, N, K))
    ld = tloss.compute_losses_planar(res, tb, tloss.LossConfig(**lcfg),
                                     epoch=epoch, Ks=torch.from_numpy(Ks),
                                     Ps=torch.from_numpy(Ps))
    tloss.total_loss(ld).backward()

    if K:
        assert res["warp_idx"].shape == (K,) and K == N // 2
        np.testing.assert_array_equal(res["warp_idx"].numpy(),
                                      np.asarray(jsel[0]))
        # the scores are the composited transient weights, which carry
        # the kernels' rounding differences (~1e-6) into v
        np.testing.assert_allclose(res["warp_v"].detach().numpy(),
                                   np.asarray(jsel[1]), rtol=1e-4)
    else:
        assert not jsel
    assert ("rgb_w" in res) == (tcfg.warp_subsample == 2)
    assert ("rgb_fw_g" in res) == bool(K)
    assert set(ld) == set(jld) and len(ld) == 11
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    grads_close(jax.tree.map(
        lambda t: (t.grad if t.grad is not None else torch.zeros_like(t))
        .numpy(), params, is_leaf=lambda x: isinstance(x, torch.Tensor)), jg)


def _scores(kind, n, rng):
    if kind == "skewed":  # a few transient-heavy rays on the floor
        return np.where(rng.rand(n) < 0.15, 1.0, 0.05).astype(np.float32)
    return (rng.rand(n) ** 3 + 0.05).astype(np.float32)


def _boundaries64(scores, K):
    """The selection's cumulative intensities and scale in float64 (the
    same redistribution), to tell a tie from a disagreement."""
    s = np.maximum(scores.astype(np.float64), 1e-12)
    n = s.shape[0]
    pi = K * s / s.sum()
    for _ in range(4):
        capped = pi >= 1.0
        pi = np.where(capped, 1.0, s * (K - capped.sum())
                      / max((s * ~capped).sum(), 1e-12))
    cum = np.cumsum(np.maximum(pi, 0.5 / n))
    return cum, cum[-1] / K


@pytest.mark.parametrize("kind,n,K", [("smooth", 48, 24),
                                      ("skewed", 64, 16),
                                      ("skewed", 48, 40),
                                      ("smooth", 4096, 2048),
                                      ("smooth", 48, 48)])
def test_importance_select_matches_jax(kind, n, K):
    """`idx` equal to JAX's, `v` within 1e-6 relative, except at a tie:
    the two packages' f32 cumulative sums part by a few ulps (a 1-D sum
    in another order), so a slot whose position lies on a boundary
    between two rays can pick either. Every parting slot must be such a
    tie: its picks adjacent rays, its position within 8 f32 ulps of their
    boundary in float64, and at most one slot in 1024 (4096 rays, seed 1:
    slot 889 sits on the boundary of rays 1765 and 1766 to the ulp)."""
    rng = np.random.RandomState(n + K)
    scores = _scores(kind, n, rng)
    cum64, scale64 = _boundaries64(scores, K)
    sel = jax.jit(lambda s, k: j_select(s, K, k))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jidx, jv = sel(jnp.asarray(scores), key)
        jidx, jv = np.asarray(jidx), np.asarray(jv)
        u = np.asarray(jax.random.uniform(key, ()))
        idx, v = _importance_select(torch.from_numpy(scores), K,
                                    torch.from_numpy(u))
        idx, v = idx.numpy(), v.numpy()
        assert idx.shape == (min(K, n),)
        part = np.nonzero(idx != jidx)[0]
        assert len(part) <= max(1, len(idx) // 1024), part
        for k in part:
            b = min(idx[k], jidx[k])
            assert abs(int(idx[k]) - int(jidx[k])) == 1, k
            pos = (k + float(u)) * scale64
            assert abs(pos - cum64[b]) <= 8 * np.spacing(
                np.float32(cum64[b])), (k, pos, cum64[b])
        same = idx == jidx
        np.testing.assert_allclose(v[same], jv[same], rtol=1e-6)


@pytest.mark.parametrize("compositing", ["on", "off"])
def test_warp_importance_full_equals_exact(compositing):
    """Deterministic depths, no noise: warp_importance=1.0 evaluates both
    directions on every ray once with weight 1, on the fused compositor
    ('on') and on the plain composite ('off')."""
    cfg = RenderConfig(**{**COMMON, "perturb": 0.0, "noise_std": 0.0,
                          "planar_compositing": compositing})
    cfg1 = dataclasses.replace(cfg, warp_importance=1.0)
    params = to_torch(jax_params())
    tb = _torch_batch(make_batch())
    Ks, Ps = (torch.from_numpy(a) for a in cams())
    emb = {"t": params["embedding_t"]}
    lcfg = tloss.LossConfig(max_t=FRAMES - 1)
    with torch.no_grad():
        res = render_train_planar(params["nerf_fine"], emb, tb["rays"],
                                  tb["ts"], cfg)
        res1 = render_train_planar(params["nerf_fine"], emb, tb["rays"],
                                   tb["ts"], cfg1)
        ld = tloss.compute_losses_planar(res, tb, lcfg,
                                         epoch=2, Ks=Ks, Ps=Ps)
        ld1 = tloss.compute_losses_planar(res1, tb, lcfg,
                                          epoch=2, Ks=Ks, Ps=Ps)

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)

    assert torch.equal(res1["warp_idx"], torch.arange(N))
    assert torch.equal(res1["warp_v"], torch.ones(N))
    for k in ("rgb_fw", "rgb_bw", "disocc_fw", "disocc_bw", "disoccs_fw",
              "disoccs_bw"):
        close(res1[f"{k}_g"], res[k])
    for c in range(3):
        close(res1["xyzs_fw_bw_g"][c], res["xyzs_fw_bw"][c])
        close(res1["xyzs_bw_fw_g"][c], res["xyzs_bw_fw"][c])
    for k in ("rgb_fine", "depth_fine", "weights", "xyz_fw", "xyz_bw"):
        close(res1[k], res[k])
    assert set(ld) == set(ld1)
    for k in ld:
        np.testing.assert_allclose(float(ld1[k]), float(ld[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_stub_step_matches_jax():
    """One packed step with `train_backend='stub'` (the field replaced by
    tanh(xyz @ static_xyz_0.w[:3, :16])) from the same state, batch and
    draws: loss terms within LOSS_RTOL, Adam's moments like gradients.
    Under `fused_train='on'` the planar path takes the stub configuration
    and runs the real evaluator, as in the JAX package."""
    B = 32
    cfg_kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
                  encode_t=True, N_samples=S, N_tau=NTAU, optimizer="adam",
                  lr=1e-3, lr_scheduler="cosine", num_epochs=2,
                  batch_size=B, dtype="bfloat16", train_backend="stub")
    jcfg = jconfig.NSFFConfig(**cfg_kw)
    tcfg = tconfig.NSFFConfig(**cfg_kw)
    flow = tuple(jcfg.output_transient_flow)
    kw = dict(output_transient=True, output_transient_flow=flow,
              steps_per_epoch=10, batch_size=B)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    jtrain = jstep.make_train_step(j_render_config(jcfg),
                                   jloss.LossConfig(max_t=FRAMES - 1), jtx,
                                   donate=False, **kw)
    trc = tconfig.render_config(tcfg)
    ttrain = tstep.make_train_step(trc, tconfig.loss_config(tcfg), ttx,
                                   device="cpu", **kw)
    assert not ttrain.use_planar
    assert tstep.make_train_step(dataclasses.replace(trc, fused_train="on"),
                                 tconfig.loss_config(tcfg), ttx,
                                 device="cpu", **kw).use_planar
    table = _table()
    weights = np.ones(table.shape[:2], np.float32)
    Ks, Ps = cams()
    jparams = jax_params()
    jstate = jstep.TrainState(jparams, jtx.init(jparams),
                              jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(21)
    jnew, jm, _ = jtrain(jstate, *(jnp.asarray(a) for a in
                                   (table, weights, Ks, Ps)), key,
                         jnp.asarray(1))
    params = to_torch(jparams)
    idx, draws = _step_inputs(key, table, B)
    tnew, tm, _ = ttrain(tstep.TrainState(params, ttx.init(params), 0),
                         *(torch.from_numpy(a) for a in
                           (table, weights, Ks, Ps)), None, 1, idx=idx,
                         draws=draws)
    assert set(tm) == set(jm) and len(tm) == 13
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
    grads_close(tmom["mu"], jnew.opt_state[0].mu)
    grads_close(tmom["nu"], jnew.opt_state[0].nu)
