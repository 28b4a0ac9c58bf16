"""The port's data pipeline, schedules and optimizer against the JAX
package: `FrameScheduler` (identical frame sequences), `_sample_batch`
(identical batches from the same pixel indices or uniforms),
`make_lr_schedule` (every schedule, with and without warmup, rtol 1e-6
and atol 1e-9, i.e. 2e-6 of the base lr: the JAX schedule runs in f32,
the port's in f64, and near the end of the cosine 1 + cos cancels in
f32), the Adam update against
optax (rtol 1e-5, f32 rounding of the same formula in another order),
sgd, radam and ranger built and stepped from a fresh state, and the Adam
state carried across with `opt_state_from_jax`."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.data import pipeline as jpipe
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.data import pipeline as tpipe
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import optim as toptim


@pytest.mark.parametrize("n_frames,seed,streams", [
    (30, 42, 4), (30, 7, 1), (8, 3, 4), (4, 0, 2)])
def test_frame_scheduler_sequence_matches_jax(n_frames, seed, streams):
    js = jpipe.FrameScheduler(n_frames, seed=seed, num_streams=streams)
    ts = tpipe.FrameScheduler(n_frames, seed=seed, num_streams=streams)
    assert [js.next() for _ in range(200)] == [ts.next() for _ in range(200)]


def _table(seed=0, frames=3, pixels=97):
    rng = np.random.RandomState(seed)
    table = rng.rand(frames, pixels, 16).astype(np.float32)
    table[..., 9] = np.arange(frames, dtype=np.float32)[:, None]
    return table


@pytest.mark.parametrize("hard", [False, True])
def test_sample_batch_matches_jax(hard):
    table = _table()
    rng = np.random.RandomState(1)
    weights = rng.rand(*table.shape[:2]).astype(np.float32) ** 3
    weights[1, :40] = 0.0
    key = jax.random.PRNGKey(3)
    B, t = 64, 1
    want = jpipe._sample_batch(jnp.asarray(table), jnp.asarray(weights), key,
                               jnp.asarray(t), B, hard)
    inject = (dict(u=torch.from_numpy(np.asarray(
        jax.random.uniform(key, (B,))))) if hard else
        dict(idx=torch.from_numpy(np.asarray(
            jax.random.randint(key, (B,), 0, table.shape[1])))))
    got = tpipe._sample_batch(torch.from_numpy(table),
                              torch.from_numpy(weights), t, B, hard, **inject)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_ray_batcher_draws_on_its_device():
    b = tpipe.RayBatcher(_table(), 16, device="cpu")
    out = b.sample(torch.Generator().manual_seed(0), 2)
    assert out["rays"].shape == (16, 6) and bool((out["ts"] == 2).all())
    b.update_weights(2, np.zeros(b.n_pixels))
    assert float(b.weights[2].sum()) == 0.0


SCHEDULES = [dict(lr_scheduler=s, warmup_epochs=w, warmup_multiplier=m)
             for s in ("const", "steplr", "cosine", "poly")
             for w, m in ((0, 1.0), (2, 3.0))]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=lambda k: f"{k['lr_scheduler']}-w{k['warmup_epochs']}")
def test_lr_schedule_matches_jax(kw):
    common = dict(lr=5e-4, num_epochs=16, decay_step=[3, 9], decay_gamma=0.5,
                  poly_exp=0.9, **kw)
    want = joptim.make_lr_schedule(jconfig.NSFFConfig(**common), 7)
    got = toptim.make_lr_schedule(tconfig.NSFFConfig(**common), 7)
    for step in list(range(0, 40)) + [55, 69, 70, 77, 111]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=str(step))


def _toy_params(seed):
    rng = np.random.RandomState(seed)
    return {"b": {"w": rng.randn(4, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "a": rng.randn(5, 2).astype(np.float32)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_optax(weight_decay):
    kw = dict(optimizer="adam", lr=1e-2, lr_scheduler="cosine",
              num_epochs=4, weight_decay=weight_decay)
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(**kw), 2)
    ttx = toptim.make_optimizer(tconfig.NSFFConfig(**kw), 2)
    p_np = _toy_params(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jtx.init(jp)
    tp = {"b": {k: torch.from_numpy(v.copy()) for k, v in p_np["b"].items()},
          "a": torch.from_numpy(p_np["a"].copy())}
    opt = ttx.init(tp)
    for step in range(5):
        g = _toy_params(10 + step)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for leaf, gl in zip(toptim.param_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        ttx.step(opt)
        for a, b in zip(toptim.param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "radam", "ranger"])
def test_unported_optimizers_raise(name):
    """Once unported, now built: each optimizer's class and fresh state
    (zero counts and moments, ranger's slow weights at the params), and
    its first three updates from that state against optax at the Adam
    test's tolerance (tests/test_torch_optimizers.py runs them longer,
    from a state carried over from JAX)."""
    kw = dict(optimizer=name, lr=1e-2, lr_scheduler="cosine", num_epochs=4)
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(**kw), 2)
    ttx = toptim.make_optimizer(tconfig.NSFFConfig(**kw), 2)
    assert type(ttx) is {"sgd": toptim.Sgd, "radam": toptim.RAdam,
                         "ranger": toptim.Ranger}[name]
    p_np = _toy_params(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jtx.init(jp)
    tp = {"b": {k: torch.from_numpy(v.copy()) for k, v in p_np["b"].items()},
          "a": torch.from_numpy(p_np["a"].copy())}
    opt = ttx.init(tp)
    for k, v in opt.fields().items():
        if k == "slow":
            for a, b in zip(v, toptim.param_leaves(tp)):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        elif isinstance(v, list):
            assert all(not bool(t.any()) for t in v), k
        else:
            assert int(v) == 0, k
    for step in range(3):
        g = _toy_params(10 + step)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for leaf, gl in zip(toptim.param_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(gl)
        ttx.step(opt)
    for a, b in zip(toptim.param_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_opt_state_round_trip_from_jax():
    p_np = _toy_params(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    tx = optax.adam(1e-3)
    state = tx.init(jp)
    for i in range(3):
        _, state = tx.update(jax.tree.map(jnp.asarray, _toy_params(20 + i)),
                             state, jp)
    tp = {"b": {k: torch.from_numpy(v.copy()) for k, v in p_np["b"].items()},
          "a": torch.from_numpy(p_np["a"].copy())}
    opt = toptim.Adam(lambda s: 1e-3).init(tp)
    tckpt.opt_state_from_jax(jax.tree.map(np.asarray, state), opt, tp)
    back = tckpt.opt_state_to_numpy(opt, tp)
    adam = state[0]
    assert back["count"] == int(adam.count) == 3
    for part in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(back[part]),
                        jax.tree.leaves(getattr(adam, part))):
            np.testing.assert_array_equal(a, np.asarray(b))
