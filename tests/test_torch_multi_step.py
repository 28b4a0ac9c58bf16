"""The port's K-step dispatch (`make_train_step(scan_steps=K)`,
`nsff_pl_tpu_torch/training/step.py::_MultiStep`) and its device-side
state on the CPU, where the same function runs the steps eagerly:

- against the JAX package's `make_train_step(scan_steps=3)` (lax.scan of
  three steps, its Pallas kernels in interpret mode) on the planar and
  the packed path, with hard sampling: the per-step draws are rebuilt
  from `jax.random.split(root, 3)` as tests/torch_train_helpers.py does
  for one step. Per-step loss terms at the single-step tolerance of
  tests/test_torch_train_step.py (1e-3 relative; its docstring has the
  reasons), Adam's moments after the three steps as that file holds them
  (5e-2 Frobenius, 0.1 of each leaf's largest entry) and the
  hard-sampling buffer written at the same pixels, within 1e-3 of JAX's
  values. The lr is 0 (const) here: unlike the three-step tests of
  tests/test_torch_packed_step.py, a dispatch cannot restart the port
  from the JAX state after each step, and with any lr the sides' weights
  part where a tiny gradient differs in sign (Adam moves such an entry
  by about lr the other way), which the next steps' gradients amplify
  (measured after three steps: 0.41 of a static leaf's largest first
  moment entry at lr 1e-3, 0.14 of its second moment at lr 1e-5, past the
  single-step bounds). At lr 0 every step starts from the same weights on
  both sides, as each step of those tests does, and the weights must stay
  exactly as they were; the update itself is held by the next test
  against the single step, which tests/test_torch_train_step.py holds to
  Adam's formula at the JAX lr;
- against three sequential calls of the port's single step on the same
  draws: the same function, so loss terms, params, moments and the
  buffer agree to 1e-6 (the device counter's f32 schedules against the
  single step's Python floats differ in the last bit);
- across an epoch boundary inside one dispatch (steps_per_epoch 2, steps
  19-21 of a cosine schedule over 12 epochs, epochs 9, 10, 10): the lr
  and lambda_geo follow the step counter on the device, as the single
  steps' host epochs do (1e-6);
- the device Adam and its f32 schedule against optax over warm-up and
  cosine (params 1e-5 relative + 1e-7, as tests/test_torch_pipeline.py
  holds the update; lr 1e-6)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training.loss import _epoch_weights
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.test_torch_train_step import _table
from tests.torch_train_helpers import (FRAMES, LOSS_RTOL, NTAU, S, cams,
                                       grads_close, jax_draws, jax_params,
                                       to_torch)

K = 3
B = 24
JAX_LR = 0.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps here are thousands of tiny ops; with the test
    workers' threads already on every core, torch's own thread pool only
    waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SEQ_TOL = 1e-6
BUF_TOL = 1e-3
DRAW_KEYS = ("u", "ns", "nt", "nw1", "nw2")


def _cfg_kw(path, **extra):
    kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
              encode_t=True, N_samples=S, N_tau=NTAU, optimizer="adam",
              lr=1e-3, lr_scheduler="cosine", num_epochs=2, batch_size=B,
              dtype="bfloat16")
    kw.update(dict(fused_train="on") if path == "planar" else
              dict(fused_train="off", train_backend="pallas"))
    kw.update(extra)
    return kw


def _port_step(path, scan_steps, spe=10, hard=True, **cfg_extra):
    tcfg = tconfig.NSFFConfig(
        **_cfg_kw(path, **cfg_extra),
        **({} if path == "planar" else {"fused_compositing": True}))
    tx = toptim.make_optimizer(tcfg, spe)
    step = tstep.make_train_step(
        tconfig.render_config(tcfg), tconfig.loss_config(tcfg), tx,
        output_transient=True,
        output_transient_flow=tuple(tcfg.output_transient_flow),
        steps_per_epoch=spe, batch_size=B, hard_sampling=hard,
        scan_steps=scan_steps, device="cpu")
    assert step.use_planar == (path == "planar")
    return tx, step


def _inputs(seed):
    table = _table()
    weights = np.random.RandomState(seed).rand(*table.shape[:2]).astype(
        np.float32)
    Ks, Ps = cams()
    return table, weights, Ks, Ps


def _jax_rows(root, n=K):
    """The draws of the JAX scan's steps, rebuilt from its keys."""
    u, draws = [], []
    for k in jax.random.split(root, n):
        k_sample, k_render = jax.random.split(k)
        u.append(torch.from_numpy(np.asarray(
            jax.random.uniform(k_sample, (B,)))))
        draws.append(jax_draws(k_render, B))
    return torch.stack(u), {k: torch.stack([d[k] for d in draws])
                            for k in DRAW_KEYS}


def _state(tx, params):
    return tstep.TrainState(params, tx.init(params), 0)


def _leaves(params):
    return [p.detach().numpy().copy() for p in toptim.param_leaves(params)]


@pytest.fixture(scope="module", params=["planar", "packed"])
def jax_dispatch(request):
    """The JAX package's three-step dispatch from the initial weights:
    (path, inputs, ts, root key, initial params, state and buffer after)."""
    path = request.param
    jcfg = jconfig.NSFFConfig(**_cfg_kw(path, lr=JAX_LR,
                                        lr_scheduler="const"))
    jrc = j_render_config(jcfg)
    jrc = (dataclasses.replace(jrc, planar_compositing="on")
           if path == "planar" else
           dataclasses.replace(jrc, fused_compositing=True))
    jtx = joptim.make_optimizer(jcfg, 10)
    multi = jstep.make_train_step(
        jrc, jloss.LossConfig(max_t=FRAMES - 1), jtx, output_transient=True,
        output_transient_flow=tuple(jcfg.output_transient_flow),
        steps_per_epoch=10, batch_size=B, hard_sampling=True, donate=False,
        scan_steps=K)
    table, weights, Ks, Ps = _inputs(3)
    ts = np.array([1, 3, 0], np.int32)
    root = jax.random.PRNGKey(31)
    jparams = jax_params()
    jstate = jstep.TrainState(jparams, jtx.init(jparams),
                              jnp.zeros((), jnp.int32))
    tmp = jnp.zeros(table.shape[:2] + (3,), jnp.float32)
    jnew, jtmp, jm = multi(jstate, tmp, *(jnp.asarray(a) for a in (
        table, weights, Ks, Ps)), root, jnp.asarray(ts))
    return (path, (table, weights, Ks, Ps), ts, root,
            jax.tree.map(np.asarray, jparams), jnew, np.asarray(jtmp),
            {k: np.asarray(v) for k, v in jm.items()})


def test_multi_step_matches_jax_scan_steps(jax_dispatch):
    path, ins, ts, root, jparams0, jnew, jtmp, jm = jax_dispatch
    tx, multi = _port_step(path, K, lr=JAX_LR, lr_scheduler="const")
    params = tckpt.params_from_jax(jparams0, "cpu")
    u, draws = _jax_rows(root)
    tmp = torch.zeros(ins[0].shape[:2] + (3,))
    new, tmp, m = multi(_state(tx, params), tmp,
                        *(torch.from_numpy(a) for a in ins), None,
                        torch.from_numpy(ts).long(), batch_u=u, draws=draws)
    assert new.step == K == int(jnew.step)
    assert set(m) == set(jm)
    for k in jm:
        assert m[k].shape == (K,)
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=LOSS_RTOL,
                                   atol=1e-9, err_msg=k)
    tmom = tckpt.opt_state_to_numpy(new.opt_state, new.params)
    assert tmom["count"] == K
    grads_close(tmom["mu"], jnew.opt_state[0].mu)
    grads_close(tmom["nu"], jnew.opt_state[0].nu)
    for got, want, p0 in zip(_leaves(new.params), jax.tree.leaves(
            jax.tree.map(np.asarray, jnew.params)), jax.tree.leaves(jparams0)):
        assert np.array_equal(got, p0) and np.array_equal(want, p0)
    # the buffer: written where JAX wrote
    written = np.abs(jtmp).sum(-1) > 0
    assert np.array_equal(tmp.abs().sum(-1).numpy() > 0, written)
    assert written.sum() > B
    np.testing.assert_allclose(tmp.numpy()[written], jtmp[written],
                               atol=BUF_TOL, rtol=0)


def _rows(seed, n=K):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, B), generator=g),
            {k: (torch.rand if k == "u" else torch.randn)((n, B, S),
                                                         generator=g)
             for k in DRAW_KEYS})


def _clone(params):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in params.items()}


def _sequential(path, params, ins, ts, u, draws, step0=0, spe=10,
                **cfg_extra):
    """K single steps of the port from `step0` (Adam's count too) on the
    given draws, the buffer written after each: (state, buffer, metrics
    stacked)."""
    tx, single = _port_step(path, 1, spe=spe, **cfg_extra)
    state = _state(tx, params)
    state.opt_state.count.fill_(step0)
    state = state._replace(step=step0)
    tmp = torch.zeros(ins[0].shape[:2] + (3,))
    rows = []
    for i in range(K):
        state, m, aux = single(
            state, *ins, None, int(ts[i]), batch_u=u[i],
            draws={k: v[i] for k, v in draws.items()})
        tmp[aux["t"], aux["rand_idx"]] = aux["rgb_fine"]
        rows.append(m)
    return state, tmp, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _assert_same(a, b):
    (sa, ta, ma), (sb, tb, mb) = a, b
    assert sa.step == sb.step and int(sa.opt_state.count) == int(
        sb.opt_state.count)
    for k in mb:
        np.testing.assert_allclose(ma[k].numpy(), mb[k].numpy(),
                                   rtol=SEQ_TOL, atol=1e-12, err_msg=k)
    for x, y in zip(_leaves(sa.params) + [m.numpy() for m in sa.opt_state.mu],
                    _leaves(sb.params) + [m.numpy() for m in sb.opt_state.mu]):
        np.testing.assert_allclose(x, y, rtol=SEQ_TOL, atol=1e-9)
    np.testing.assert_allclose(ta.numpy(), tb.numpy(), rtol=SEQ_TOL,
                               atol=1e-9)


@pytest.mark.parametrize("path", ["planar", "packed"])
def test_multi_step_is_three_single_steps(path):
    ins = tuple(torch.from_numpy(a) for a in _inputs(4))
    ts = torch.tensor([2, 0, 2])
    u, draws = _rows(5)
    params = to_torch(jax_params())
    want = _sequential(path, _clone(params), ins, ts, u, draws)
    tx, multi = _port_step(path, K)
    tmp = torch.zeros(ins[0].shape[:2] + (3,))
    new, tmp, m = multi(_state(tx, params), tmp, *ins, None, ts, batch_u=u,
                        draws=draws)
    _assert_same((new, tmp, m), want)
    # a second dispatch continues from the device counter it left
    u2, d2 = _rows(6)
    new2, _, m2 = multi(new, tmp, *ins, None, ts, batch_u=u2, draws=d2)
    assert new2.step == 2 * K and int(new2.opt_state.count) == 2 * K
    assert all(bool(torch.isfinite(v).all()) for v in m2.values())


def test_epoch_boundary_inside_one_dispatch():
    spe, step0 = 2, 19
    assert [(step0 + i) // spe for i in range(K)] == [9, 10, 10]
    extra = dict(num_epochs=12)
    ins = tuple(torch.from_numpy(a) for a in _inputs(6))
    ts = torch.tensor([1, 1, 3])
    u, draws = _rows(7)
    params = to_torch(jax_params())
    want = _sequential("planar", _clone(params), ins, ts, u, draws,
                       step0=step0, spe=spe, **extra)
    tx, multi = _port_step("planar", K, spe=spe, **extra)
    state = _state(tx, params)
    state.opt_state.count.fill_(step0)
    got = multi(state._replace(step=step0), torch.zeros(
        ins[0].shape[:2] + (3,)), *ins, None, ts, batch_u=u, draws=draws)
    _assert_same((got[0], got[1], got[2]), want)
    # lambda_geo fell tenfold and the lr moved where the epoch turned
    lcfg = tconfig.loss_config(tconfig.NSFFConfig(**_cfg_kw("planar")))
    (g9, _), (g10, _) = (_epoch_weights(torch.tensor(e), lcfg)
                         for e in (9, 10))
    assert float(g9) == pytest.approx(_epoch_weights(9, lcfg)[0]) \
        == pytest.approx(10 * float(g10))
    assert float(tx.schedule(torch.tensor(step0))) != float(
        tx.schedule(torch.tensor(step0 + 1)))


SCHEDULES = [dict(lr_scheduler=s, warmup_epochs=w, warmup_multiplier=m)
             for s in ("const", "steplr", "cosine", "poly")
             for w, m in ((0, 1.0), (2, 3.0))]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda k: f"{k['lr_scheduler']}-w{k['warmup_epochs']}")
def test_device_lr_schedule_matches_jax(kw):
    common = dict(lr=5e-4, num_epochs=16, decay_step=[3, 9], decay_gamma=0.5,
                  poly_exp=0.9, **kw)
    want = joptim.make_lr_schedule(jconfig.NSFFConfig(**common), 7)
    got = toptim.make_lr_schedule(tconfig.NSFFConfig(**common), 7)
    for step in list(range(0, 40)) + [55, 69, 70, 77, 111]:
        lr = got(torch.tensor(step))
        assert lr.dtype == torch.float32 and lr.shape == ()
        np.testing.assert_allclose(float(lr), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(step))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_device_adam_matches_optax_over_warmup_and_cosine(weight_decay):
    kw = dict(optimizer="adam", lr=1e-2, lr_scheduler="cosine", num_epochs=6,
              warmup_epochs=2, warmup_multiplier=3.0,
              weight_decay=weight_decay)
    spe = 2
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(**kw), spe)
    ttx = toptim.make_optimizer(tconfig.NSFFConfig(**kw), spe)
    jsched = joptim.make_lr_schedule(jconfig.NSFFConfig(**kw), spe)
    rng = np.random.RandomState(0)
    p_np = {"b": {"w": rng.randn(4, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "a": rng.randn(5, 2).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jtx.init(jp)
    tp = jax.tree.map(lambda v: torch.from_numpy(v.copy()), p_np)
    opt = ttx.init(tp)
    for step in range(16):  # epochs 0-7: the ramp, then the cosine
        g = jax.tree.map(lambda v: rng.randn(*v.shape).astype(np.float32),
                         p_np)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(float(ttx.schedule(opt.count)),
                                   float(jsched(step)), rtol=1e-6)
        for leaf, gl in zip(toptim.param_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        ttx.step(opt)
        assert int(opt.count) == step + 1
        for a, b in zip(toptim.param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)
