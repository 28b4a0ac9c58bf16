"""The port's sgd, radam and ranger (`nsff_pl_tpu_torch/training/optim.py`)
against the JAX package's `make_optimizer` (optax) on the CPU.

- Each optimizer from a state carried over from JAX by
  `opt_state_from_jax` after two JAX updates, then over more updates on
  the same gradients: sgd with momentum and coupled decay (8 updates),
  radam with decoupled decay across the rectification switch (rho reaches
  5 at the 6th update; 10 updates), ranger across two lookahead syncs (13
  updates). Params after every update and the state at the end are held
  to the Adam test's rtol 1e-5 (f32 rounding of the same formulas in
  another order), the counts exactly.
- The checkpoint bridge: `jax_opt_fields` finds every optimizer's fields
  in its optax state, as NamedTuples and as the dicts and lists of an
  orbax checkpoint, and `scripts/jax_ckpt_to_torch.py::port_tree` carries
  them into a checkpoint the trainer restores.
- Ranger through `NSFFSystem`: a run of 4 epochs (12 updates, syncs at 6
  and 12) resumed from its epoch-3 checkpoint ends with the same bits as
  the uninterrupted run, the slow weights and the lookahead count
  included; without the slow weights the sync at 12 would start from
  another point.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training.trainer import NSFFSystem
from tests.helpers_scene import make_synthetic_scene

RTOL, ATOL = 1e-5, 1e-7
CASES = {"sgd": (dict(momentum=0.9, weight_decay=0.01), 8),
         "radam": (dict(weight_decay=0.01), 10),
         "ranger": (dict(weight_decay=0.01), 13)}


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"b": {"w": rng.randn(4, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "a": rng.randn(5, 2).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax_run(tx, jp, jstate, seeds):
    for s in seeds:
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, _params(s)),
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
    return jp, jstate


def _fields_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("count"):
            assert int(got[k]) == int(np.asarray(w)), k
            continue
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(w)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_optax_from_a_jax_state(name):
    extra, n_updates = CASES[name]
    kw = dict(optimizer=name, lr=1e-2, lr_scheduler="cosine", num_epochs=8,
              **extra)
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(**kw), 2)
    ttx = toptim.make_optimizer(tconfig.NSFFConfig(**kw), 2)
    jp = jax.tree.map(jnp.asarray, _params(0))
    jp, jstate = _jax_run(jtx, jp, jtx.init(jp), (1, 2))
    tp = _to_torch(jp)
    opt = ttx.init(tp)
    tckpt.opt_state_from_jax(jax.tree.map(np.asarray, jstate), opt, tp)
    for i in range(n_updates):
        jp, jstate = _jax_run(jtx, jp, jstate, (10 + i,))
        for leaf, g in zip(toptim.param_leaves(tp),
                           jax.tree.leaves(_params(10 + i))):
            leaf.grad = torch.from_numpy(g)
        ttx.step(opt)
        for a, b in zip(toptim.param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"update {i + 1}")
    want = tckpt.jax_opt_fields(jax.tree.map(np.asarray, jstate))
    _fields_close(tckpt.opt_state_to_numpy(opt, tp), want)
    assert int(opt.count) == 2 + n_updates


def _as_orbax(tree):
    """An optax state as an orbax checkpoint restores it without a target:
    NamedTuples as dicts of their fields, tuples as lists."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _as_orbax(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, (tuple, list)):
        return [_as_orbax(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _as_orbax(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("name", ["adam", "sgd", "radam", "ranger"])
def test_checkpoint_bridge_carries_every_state(name):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "scripts"))
    from jax_ckpt_to_torch import port_tree

    kw = dict(optimizer=name, lr=1e-2, weight_decay=0.01)
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(**kw), 2)
    jp = jax.tree.map(jnp.asarray, _params(0))
    jp, jstate = _jax_run(jtx, jp, jtx.init(jp), range(1, 8))
    np_state = jax.tree.map(np.asarray, jstate)
    want = tckpt.jax_opt_fields(np_state)
    assert set(want) == set(toptim.make_optimizer(
        tconfig.NSFFConfig(**kw), 2).init(_to_torch(jp)).fields())
    _fields_close(tckpt.jax_opt_fields(_as_orbax(jstate)), want)
    tree = port_tree({"state": {"params": _as_orbax(jp),
                                "opt_state": _as_orbax(jstate),
                                "step": np.asarray(7)},
                      "sampling_weights": np.ones((2, 3), np.float32)})
    assert tree["step"] == 7
    _fields_close(tree["opt_state"], want)
    tp = _to_torch(jp)
    opt = toptim.make_optimizer(tconfig.NSFFConfig(**kw), 2).init(tp)
    tckpt.load_opt_fields(opt, tree["opt_state"], tp)
    _fields_close(tckpt.opt_state_to_numpy(opt, tp), want)


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(system):
    opt = system.state.opt_state
    return {"params": [p.detach().clone()
                       for p in toptim.param_leaves(system.state.params)],
            "fields": {k: ([t.clone() for t in v] if isinstance(v, list)
                           else int(v)) for k, v in opt.fields().items()},
            "step": system.state.step, "tmp": system.tmp_rgb.clone(),
            "weights": system.batcher.weights.clone()}


def test_ranger_resume_has_the_same_bits(one_torch_thread, tmp_path):
    W, H, N = 32, 24, 5
    root = make_synthetic_scene(str(tmp_path / "scene"), W=W, H=H, N=N,
                                learnable=True)
    kw = dict(root_dir=root, img_wh=(W, H), start_end=(0, N),
              encode_t=True, use_viewdir=True, N_samples=16, batch_size=32,
              num_epochs=4, lr_scheduler="cosine", optimizer="ranger",
              hard_sampling=True, scan_steps=2,
              log_dir=str(tmp_path / "logs"),
              ckpt_dir=str(tmp_path / "ckpts"), exp_name="ranger")
    full = NSFFSystem(tconfig.NSFFConfig(**kw), device="cpu")
    assert full.total_steps == 12
    full.fit(progress=False)
    want = _state(full)
    assert want["fields"]["lookahead_count"] == 12
    ckpt = tmp_path / "ckpts" / "ranger" / "step_9"
    resumed = NSFFSystem(tconfig.NSFFConfig(**dict(
        kw, ckpt_path=str(ckpt), exp_name="resumed")), device="cpu")
    assert resumed.state.step == 9
    # the slow weights saved at step 9 are the sync at update 6's
    slow = tckpt.restore_checkpoint(str(ckpt))["opt_state"]["slow"]
    assert not all(torch.equal(a, b) for a, b in zip(
        toptim.param_leaves(slow), resumed.state.opt_state.params))
    resumed.fit(progress=False)
    got = _state(resumed)
    assert got["step"] == want["step"] == 12
    assert got["fields"]["lookahead_count"] == 12
    for a, b in zip(got["params"], want["params"]):
        assert torch.equal(a, b)
    for k, v in want["fields"].items():
        if isinstance(v, list):
            assert all(torch.equal(a, b)
                       for a, b in zip(got["fields"][k], v)), k
        else:
            assert got["fields"][k] == v, k
    assert torch.equal(got["tmp"], want["tmp"])
    assert torch.equal(got["weights"], want["weights"])
