"""The port's training step against the JAX package on the CPU: whole
`make_train_step` calls from the same weights, batch and random draws
(the JAX key splits rebuilt in tests/torch_train_helpers.py; the JAX
side runs its Pallas kernels in interpret mode with `fused_train='on'`
and `planar_compositing='on'`, as `tests/test_planar_path.py` does), the
loss's top-k and median, and the train step's decisions. The render and
loss with gradients: tests/test_torch_train_render.py.

Tolerances, for both files: loss terms 1e-3 relative, ten times the 1e-4
the sums' order alone would need: the per-sample planes of the two sides
differ by bf16 rounding flips in a few percent of the samples (see
tests/test_torch_train_kernel.py), and the depth loss normalizes by the
batch median and mean absolute deviation, which carries such a flip to
every ray (measured: at most 3.2e-4, on `disp_l`). Gradients per leaf
5e-2 in Frobenius norm relative to the leaf and every entry within 0.1
of the leaf's largest (a ReLU mask turned by such a flip changes one
sample's cotangent whole, as in that file), and Adam's moments held
like the gradients. The update itself is held to Adam's formula on the
port's own moments with the JAX schedule's lr (1e-3 of the lr: f32
rounding of params near 2.4 is 2.4e-7), not to the JAX update:
lr * m / (sqrt(v) + eps) is about +-lr * sign(g) at Adam's first steps,
so an entry near zero whose gradient differs in sign moves by 2 lr.
Top-k mining is held on identical per-ray terms, since a rank swap
between two near-equal rays moves the gradient of the embedding rows
they read."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.torch_train_helpers import (COMMON, FRAMES, LOSS_RTOL, NTAU, S,
                                       UPD_TOL, cams, jax_draws, grads_close,
                                       jax_params, make_rays, to_torch)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps are thousands of small ops; with the test workers'
    threads already on every core, torch's own pool only waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("topk,weighted", [(0.5, False), (0.3, True),
                                            (1.0, True)])
def test_finalize_terms_match_jax(topk, weighted):
    """Top-k hard mining, priority weights and masked means on the same
    per-ray terms: values and gradients."""
    rng = np.random.RandomState(2)
    ret = {k: rng.rand(40).astype(np.float32) for k in ("a", "b", "c")}
    masks = {"b": (rng.rand(40) > 0.4).astype(np.float32),
             "c": np.zeros(40, np.float32)}
    w = rng.rand(40).astype(np.float32) if weighted else None
    jcfg = jloss.LossConfig(topk=topk)

    def jf(r):
        return jloss._finalize_terms(
            r, {k: jnp.asarray(v) for k, v in masks.items()},
            None if w is None else jnp.asarray(w), jcfg)

    jout, vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in ret.items()})
    (jg,) = vjp({k: jnp.ones(()) for k in jout})
    tr = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ret.items()}
    out = tloss._finalize_terms(
        tr, {k: torch.from_numpy(v) for k, v in masks.items()},
        None if w is None else torch.from_numpy(w), tloss.LossConfig(topk=topk))
    sum(out.values()).backward()
    for k in ret:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-6)
        np.testing.assert_allclose(tr[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-9)


def test_median_averages_the_middle_pair():
    """jnp.median of an even count averages the two middle values and
    splits the gradient between them; torch.median takes the lower."""
    x = np.random.RandomState(0).randn(512).astype(np.float32)
    for arr in (x, x[:511]):
        t = torch.from_numpy(arr.copy()).requires_grad_(True)
        m = tloss.median(t)
        m.backward()
        jm, jgrad = jax.value_and_grad(jnp.median)(jnp.asarray(arr))
        assert float(m) == float(jm)
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jgrad))
    assert float(tloss.median(torch.from_numpy(x))) != float(
        torch.median(torch.from_numpy(x)))


def _table():
    rng = np.random.RandomState(1)
    table = rng.rand(FRAMES, 256, 16).astype(np.float32)
    rays = make_rays(rng, FRAMES * 256).reshape(FRAMES, 256, 6)
    table[..., 0:6] = rays
    table[..., 9] = np.arange(FRAMES, dtype=np.float32)[:, None]
    return table


def _step_inputs(key, table, batch_size):
    k_sample, k_render = jax.random.split(key)
    idx = torch.from_numpy(np.asarray(
        jax.random.randint(k_sample, (batch_size,), 0, table.shape[1])))
    return idx, jax_draws(k_render, batch_size)


def test_train_step_matches_jax():
    """Two whole steps: the first from the initial state on both sides
    (losses, and Adam's first moments 0.1 * g in place of the gradients),
    the second from the JAX state after the first, carried over with
    params_from_jax / opt_state_from_jax (losses and Adam updates)."""
    B = 32
    cfg_kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
                  encode_t=True, N_samples=S, N_tau=NTAU, optimizer="adam",
                  lr=1e-3, lr_scheduler="cosine", num_epochs=2,
                  batch_size=B, dtype="bfloat16", fused_train="on")
    jcfg = jconfig.NSFFConfig(**cfg_kw)
    tcfg = tconfig.NSFFConfig(**cfg_kw)
    from nsff_pl_tpu.training.trainer import render_config as j_render_config

    jrc = dataclasses.replace(j_render_config(jcfg), planar_compositing="on")
    trc = tconfig.render_config(tcfg)
    flow = tuple(jcfg.output_transient_flow)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    jtrain = jstep.make_train_step(
        jrc, jloss.LossConfig(max_t=FRAMES - 1), jtx, output_transient=True,
        output_transient_flow=flow, steps_per_epoch=10, batch_size=B,
        donate=False)
    ttrain = tstep.make_train_step(
        trc, tconfig.loss_config(tcfg), ttx, output_transient=True,
        output_transient_flow=flow, steps_per_epoch=10, batch_size=B,
        device="cpu")
    table = _table()
    weights = np.ones(table.shape[:2], np.float32)
    Ks, Ps = cams()
    jargs = (jnp.asarray(table), jnp.asarray(weights), jnp.asarray(Ks),
             jnp.asarray(Ps))
    targs = tuple(torch.from_numpy(a) for a in (table, weights, Ks, Ps))

    jparams = jax_params()
    jstate = jstep.TrainState(jparams, jtx.init(jparams),
                              jnp.zeros((), jnp.int32))
    for i, key in enumerate((jax.random.PRNGKey(11), jax.random.PRNGKey(12))):
        if i == 0:
            params = to_torch(jstate.params)
            tstate = tstep.TrainState(params, ttx.init(params), 0)
        else:  # start the port from the JAX state after step 1
            params = to_torch(jstate.params)
            opt = ttx.init(params)
            tckpt.opt_state_from_jax(jax.tree.map(np.asarray,
                                                  jstate.opt_state), opt,
                                     params)
            tstate = tstep.TrainState(params, opt, int(jstate.step))
        before = jax.tree.map(np.asarray, jstate.params)
        jnew, jm, _ = jtrain(jstate, *jargs, key, jnp.asarray(1 + i))
        idx, draws = _step_inputs(key, table, B)
        tnew, tm, aux = ttrain(tstate, *targs, None, 1 + i, idx=idx,
                               draws=draws)
        assert set(tm) == set(jm) and "psnr" in tm
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg=f"step {i + 1}: {k}")
        assert tnew.step == int(jnew.step) == i + 1
        assert aux["rgb_fine"].shape == (B, 3)
        tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
        jadam = jnew.opt_state[0]
        grads_close(tmom["mu"], jadam.mu)  # 0.1 g after the first step
        grads_close(tmom["nu"], jadam.nu)
        # the port's update is Adam's on its own moments, at the JAX lr
        lr = float(joptim.make_lr_schedule(jcfg, 10)(i))
        t = tmom["count"]
        assert t == i + 1
        for a, p0, m, v in zip(
                jax.tree.leaves(tckpt.params_to_numpy(tnew.params)),
                jax.tree.leaves(before), jax.tree.leaves(tmom["mu"]),
                jax.tree.leaves(tmom["nu"])):
            want = -lr * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
            assert np.abs((a - p0) - want).max() <= UPD_TOL * lr
        jstate = jnew


def test_make_train_step_decisions():
    lcfg = tloss.LossConfig()
    tx = toptim.make_optimizer(tconfig.NSFFConfig(), 1)
    kw = dict(output_transient=True, output_transient_flow=("fw", "bw"),
              steps_per_epoch=1, batch_size=4, device="cpu")
    on = RenderConfig(**{**COMMON, "N_samples": 16})
    assert tstep.make_train_step(on, lcfg, tx, **kw).use_planar
    with pytest.raises(ValueError, match="fused_train='on'"):
        tstep.make_train_step(on, lcfg, tx, **{
            **kw, "output_transient_flow": ("fw",)})
    # outside the planar decision the step renders on the packed path
    for packed in (dataclasses.replace(on, fused_train="auto"),
                   dataclasses.replace(on, fused_train="off")):
        assert not tstep.make_train_step(packed, lcfg, tx, **kw).use_planar
    assert not tstep.make_train_step(
        dataclasses.replace(on, fused_train="auto", train_backend="pallas"),
        lcfg, tx, **{**kw, "output_transient": False,
                     "output_transient_flow": ()}).use_planar
    for bad in (dict(warp_subsample=2), dict(warp_importance=0.5)):
        with pytest.raises(ValueError, match="only implemented on the planar"):
            tstep.make_train_step(
                dataclasses.replace(on, fused_train="off", **bad), lcfg, tx,
                **kw)
    # coarse-to-fine on the packed path (tests/test_torch_packed_c2f.py)
    assert not tstep.make_train_step(
        dataclasses.replace(on, fused_train="off", N_importance=8), lcfg,
        tx, **kw).use_planar
    assert tstep.make_train_step(dataclasses.replace(on, N_importance=8),
                                 lcfg, tx, **kw).use_planar
    # the warp variants and the plain composite build a planar step
    for variant in (dict(warp_subsample=2), dict(warp_importance=0.5),
                    dict(planar_compositing="off")):
        assert tstep.make_train_step(dataclasses.replace(on, **variant),
                                     lcfg, tx, **kw).use_planar
    # and the JAX renderer's refusals raise with its wording
    for bad, batch, match in (
            (dict(warp_subsample=2), 5, "needs an even ray batch"),
            (dict(warp_subsample=2, warp_importance=0.5), 4,
             "mutually exclusive"),
            (dict(warp_importance=1.5), 4, r"must be in \[0, 1\]"),
            (dict(warp_importance=-0.5), 4, r"must be in \[0, 1\]"),
            (dict(warp_subsample=3), 4, "must be 1 or 2")):
        with pytest.raises(ValueError, match=match):
            tstep.make_train_step(dataclasses.replace(on, **bad), lcfg, tx,
                                  **{**kw, "batch_size": batch})
    # scan_steps > 1: the K-step dispatch
    multi = tstep.make_train_step(on, lcfg, tx, scan_steps=4, **kw)
    assert multi.use_planar and multi.K == 4
