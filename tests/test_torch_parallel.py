"""Data-parallel training of the port (`nsff_pl_tpu_torch/parallel/`) on
the CPU over gloo, two ranks started once for the module through the
port's launcher (`parallel.distributed.launch`, called in a spawned
process; the ranks' code is tests/torch_parallel_helpers.py, one torch
thread each), at the sizes
of tests/torch_train_helpers.py (48 rays, S = 16, 4 frames, N_tau 16).

- The five train paths (the planar exact step, `warp_subsample 2`,
  `warp_importance 0.5`, planar coarse-to-fine, the packed path with
  the fused compositor), two steps each from seeded weights with every
  draw from one seeded generator, against the port's one-rank run:
  loss terms to 1e-4 relative, every parameter leaf to 1e-4 absolute
  (the kernel-path tolerances of tests/test_sharding.py: the shards'
  partial weight gradients add in another order, and Adam's first
  steps move an entry by about lr whatever its gradient's size), and
  every parameter leaf and optimizer tensor the same bits on both
  ranks (the ranks run the same replicated code on the same gathered
  values, and the all-reduce hands both the same sums).
- The planar step as one K = 2 dispatch (`_MultiStep`, eager on the
  CPU) against two single steps over gloo, to the 1e-6 of
  tests/test_torch_multi_step.py (the device counter's f32 schedules
  against the single step's Python floats).
- The two-rank planar step against the JAX package's
  `make_train_step(..., mesh=make_mesh(2))` on the conftest's virtual
  CPU devices, from JAX-initialised weights on the JAX key's pixels and
  draws, held as tests/test_torch_train_step.py holds the one-device
  step (loss terms LOSS_RTOL, Adam's moments like gradients, the update
  to Adam's formula at the JAX lr within UPD_TOL); run while the ranks
  run.
- Refusals: a batch, or wi's K, that does not divide over the ranks;
  a CUDA device on a gloo group.
- The train CLI with `--num_gpus 2` on tests/helpers_scene.py's scene
  (float32, the plain evaluators on the packed path, hard sampling,
  K = 2 and a validation every 2 steps), run in a spawned process of
  its own after a one-process run of two epochs: resumed from that
  run's first checkpoint it gives its second epoch's per-step losses
  (1e-4) and params (1e-4), rank 0 alone printing, logging and
  checkpointing; its checkpoint restores in one process. Its
  validations, each chunk sharded over the two ranks, give the
  one-process run's metrics at the same steps to 1e-4 relative.

The ranks, the CLI runs and the JAX step run at once: the module takes
~38 s of pytest's count alone.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.parallel import make_mesh as jax_make_mesh
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch.config import NSFFConfig, build_params
from nsff_pl_tpu_torch.parallel import Mesh, distributed, rows_of
from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
from nsff_pl_tpu_torch.training.optim import param_leaves
from nsff_pl_tpu_torch.training.trainer import NSFFSystem
from tests import torch_parallel_helpers as h
from tests import torch_train_helpers as th
from tests.helpers_scene import make_synthetic_scene

LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
VAL_RTOL = 1e-4
SPE = 3  # the CLI scene's steps an epoch: 5 frames of 32 x 24, batch 32
SEQ_TOL = 1e-6
KEY = 21


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread here and in each rank (the launcher hands its
    CPU ranks the caller's threads, shared)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jsonl_logs_only():
    """The trainer's logger without its TensorBoard writer here (the
    import alone takes seconds; tests/test_torch_trainer.py holds the
    writer): the JSONL rows are what these tests read."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@jax.jit
def _key_draws(key):
    k_sample, k_render = jax.random.split(key)
    return jax.random.randint(k_sample, (h.N,), 0, 256), k_render


def _jax_inputs():
    """Seeded weights (numpy; tests/torch_train_helpers.py::seeded_params
    draws them without an eager JAX op) and the JAX key's pixel ids and
    renderer draws (as tests/test_torch_train_step.py rebuilds them)."""
    idx, k_render = _key_draws(jax.random.PRNGKey(KEY))
    jparams, _ = th.seeded_params(KEY, h.FRAMES, h.NTAU)
    return (jax.tree.map(np.asarray, jparams),
            torch.from_numpy(np.asarray(idx)), th.jax_draws(k_render, h.N))


def _jax_mesh_step(jparams):
    """One JAX planar step over a two-device mesh: (state, metrics)."""
    jcfg = jconfig.NSFFConfig(**h.CFG_KW)
    jtx = joptim.make_optimizer(jcfg, h.SPE)
    jrc = dataclasses.replace(j_render_config(jcfg), planar_compositing="on")
    train = jstep.make_train_step(
        jrc, jloss.LossConfig(max_t=h.FRAMES - 1), jtx,
        output_transient=True,
        output_transient_flow=tuple(jcfg.output_transient_flow),
        steps_per_epoch=h.SPE, batch_size=h.N, donate=False,
        mesh=jax_make_mesh(2))
    state = jstep.TrainState(jparams, jtx.init(jparams),
                             jnp.zeros((), jnp.int32))
    args = tuple(jnp.asarray(a.numpy()) for a in h.table_args())
    new, m, _ = train(state, *args, jax.random.PRNGKey(KEY), jnp.asarray(1))
    return jcfg, state, new, m


def test_ranks_know_their_roles(runs):
    """Each rank its own index in a world of two; rank 0 alone is the
    primary; both run in a multi-process group."""
    res = runs[0]
    assert [res[r]["roles"] for r in (0, 1)] == [(0, 2, True, True),
                                                  (1, 2, False, True)]
    assert distributed.is_primary() and not distributed.multiprocess()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    return make_synthetic_scene(root, W=32, H=24, N=5, learnable=True)


def _argv(scene, out, exp, **extra):
    kw = dict(root_dir=scene, img_wh="32 24", start_end="0 5",
              N_samples=16, batch_size=32, num_epochs=2,
              lr_scheduler="cosine", scan_steps=2, val_every_steps=2,
              log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpts"),
              exp_name=exp)
    kw.update(extra)
    argv = ["--encode_t", "--use_viewdir", "--hard_sampling"]
    for k, v in kw.items():
        argv += [f"--{k}", *str(v).split()]
    return argv


@pytest.fixture(scope="module")
def runs(tmp_path_factory, scene):
    """Both ranks' results ({rank: {run: ...}}), the JAX mesh step's, and
    the output directories of the CLI runs (a one-process run of two
    epochs, then its second epoch again by two ranks from its first
    epoch's checkpoint) and of the ranks: the ranks and the CLI runs each
    run in a process of their own (h.launch_ranks, h.cli_runs) while the
    JAX step runs here."""
    out = str(tmp_path_factory.mktemp("ranks"))
    cli_out = tmp_path_factory.mktemp("cli")
    jparams_np, idx, draws = _jax_inputs()
    ckpt = str(cli_out / "ckpts" / "one" / f"step_{SPE}")
    procs = [torch.multiprocessing.start_processes(
        fn, args=args, nprocs=1, join=False, start_method="spawn")
        for fn, args in (
            (h.launch_ranks, (out, (jparams_np, idx, draws))),
            (h.cli_runs, (out, _argv(scene, cli_out, "one"),
                          _argv(scene, cli_out, "dp", ckpt_path=ckpt,
                                num_gpus=2))))]
    jax_run = _jax_mesh_step(jax.tree.map(jnp.asarray, jparams_np))
    for p in procs:
        while not p.join(timeout=600):
            pass
    res = {r: torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
           for r in (0, 1)}
    return res, jax_run, (cli_out, out)


def test_sizes_are_the_train_helpers():
    assert (h.N, h.S, h.FRAMES, h.NTAU) == (th.N, th.S, th.FRAMES, th.NTAU)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a["params"] + a["moments"], b["params"] + b["moments"]))


@pytest.mark.parametrize("case", list(h.CASES))
def test_two_ranks_match_one_rank(runs, case):
    res = runs[0]
    dp = res[0][f"dp_{case}"]
    one = res[list(h.CASES).index(case) % 2][f"one_{case}"]
    assert _same_bits(dp, res[1][f"dp_{case}"]), "the ranks part"
    assert len(dp["losses"]) == len(one["losses"]) == h.STEPS
    for i, (got, want) in enumerate(zip(dp["losses"], one["losses"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       atol=1e-9, err_msg=f"step {i}: {k}")
    for a, b in zip(dp["params"], one["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)
    init = param_leaves(build_params(h.config(case), torch.Generator()
                                     .manual_seed(0), device="cpu"))
    assert all(not torch.equal(a, b.detach())
               for a, b in zip(dp["params"], init)), "a leaf did not move"


def test_k_step_dispatch_over_gloo(runs):
    res = runs[0]
    multi, single = res[0]["dp_planar_k2"], res[0]["dp_planar"]
    assert _same_bits(multi, res[1]["dp_planar_k2"])
    for got, want in zip(multi["losses"], single["losses"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=SEQ_TOL,
                                       atol=1e-9)
    for a, b in zip(multi["params"] + multi["moments"],
                    single["params"] + single["moments"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SEQ_TOL,
                                   atol=1e-9)


def test_two_rank_step_matches_jax_mesh_step(runs):
    res, (jcfg, jstate, jnew, jm), _ = runs
    dp = res[0]["dp_given"]
    assert _same_bits(dp, res[1]["dp_given"])
    (got,) = dp["losses"]
    assert set(got) == set(jm)
    for k in jm:
        np.testing.assert_allclose(got[k], float(jm[k]), rtol=th.LOSS_RTOL,
                                   atol=1e-9, err_msg=k)
    treedef = jax.tree.structure(jstate.params)
    n = len(dp["params"])
    count = int(dp["moments"][0])
    mu = [t.numpy() for t in dp["moments"][1:1 + n]]
    nu = [t.numpy() for t in dp["moments"][1 + n:]]
    jadam = jnew.opt_state[0]
    th.grads_close(jax.tree.unflatten(treedef, mu), jadam.mu)
    th.grads_close(jax.tree.unflatten(treedef, nu), jadam.nu)
    # the update is Adam's on the port's own moments, at the JAX lr
    lr = float(joptim.make_lr_schedule(jcfg, h.SPE)(0))
    assert count == 1
    for a, p0, m, v in zip(dp["params"], jax.tree.leaves(jstate.params),
                           mu, nu):
        want = -lr * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
        assert np.abs((a.numpy() - np.asarray(p0)) - want).max() \
            <= th.UPD_TOL * lr


def test_refusals(runs):
    """A batch, or wi's K, that does not divide over the ranks raises
    (the JAX package's ValueError for K); a row cut of a ragged tensor
    too; a gloo group refuses a CUDA device (read in a rank)."""
    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="K = 25 selected rays must divide"):
        h.train_step("wi", mesh, batch=50)
    for case in ("planar", "packed"):
        with pytest.raises(ValueError, match="47 rays does not divide"):
            h.train_step(case, mesh, batch=47)
    with pytest.raises(ValueError, match="5 rows do not divide"):
        rows_of(torch.zeros(5, 3), mesh)
    res = runs[0]
    for r in (0, 1):
        assert "cuda ranks run on 'nccl'" in res[r]["cuda_on_gloo"]


def _rows(out, exp):
    with open(out / "logs" / exp / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r for r in rows if "train/loss" in r}, rows


def test_cli_two_ranks(runs, scene):
    """The one-process CLI run's second epoch again by two gloo ranks
    (`--num_gpus 2`), resumed from its first epoch's checkpoint: the same
    per-step losses and the same end; rank 0 alone logs, prints and
    checkpoints. Then the two ranks' checkpoint restores in one
    process."""
    out, ranks_out = runs[2]
    spe = SPE
    with open(os.path.join(ranks_out, "dp_stdout.txt")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(ranks_out, "dp_system.json")) as f:
        assert json.load(f) == {"rank": 0, "size": 2, "step": 2 * spe,
                                "steps_per_epoch": spe}

    one_rows, _ = _rows(out, "one")
    dp_rows, dp_all = _rows(out, "dp")
    assert sorted(dp_rows) == list(range(spe, 2 * spe))
    for s in dp_rows:
        for k, v in one_rows[s].items():
            np.testing.assert_allclose(dp_rows[s][k], v, rtol=LOSS_RTOL,
                                       atol=1e-9, err_msg=f"step {s}: {k}")
    # rank 0 alone: one JSONL row a step, one printed line a validation
    vals = [r for r in dp_all if "val/psnr" in r]
    assert len(dp_all) == len({json.dumps(r) for r in dp_all})
    assert sum(x.startswith("epoch ") for x in lines) == len(vals) >= 1
    assert sum(x.startswith(f"step {2 * spe}/") for x in lines) == 1
    assert "mesh: 2 cpu ranks over 1 node(s), data-parallel over rays" \
        in lines
    assert sorted(os.listdir(out / "ckpts" / "dp")) == [
        "config.json", f"step_{2 * spe}"]
    dp_ckpt = str(out / "ckpts" / "dp" / f"step_{2 * spe}")
    tree = ckpt_lib.restore_checkpoint(dp_ckpt)
    end = ckpt_lib.restore_checkpoint(str(out / "ckpts" / "one"
                                          / f"step_{2 * spe}"))
    for a, b in zip(param_leaves(tree["params"]),
                    param_leaves(end["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)

    # the two ranks' checkpoint restores in one process
    one = NSFFSystem(NSFFConfig(
        root_dir=scene, img_wh=(32, 24), start_end=(0, 5), encode_t=True,
        use_viewdir=True, hard_sampling=True, N_samples=16, batch_size=32,
        log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpts"),
        exp_name="back", ckpt_path=dp_ckpt), device="cpu")
    assert one.steps_per_epoch == spe
    assert one.state.step == 2 * spe
    for a, b in zip(param_leaves(one.state.params),
                    param_leaves(tree["params"])):
        assert torch.equal(a.detach(), b)
    opt = one.state.opt_state
    for a, b in zip(opt.mu + opt.nu, param_leaves(tree["opt_state"]["mu"])
                    + param_leaves(tree["opt_state"]["nu"])):
        assert torch.equal(a, b)
    assert torch.equal(one.tmp_rgb, tree["tmp_rgb"])
    assert torch.equal(one.batcher.weights, tree["sampling_weights"])


def test_cli_two_ranks_validation(runs):
    """The two ranks' validations (the middle frame, each chunk's rays
    sharded over the ranks and gathered back to both) at the steps the
    one-process run validated: the same metrics to VAL_RTOL (the params
    they render agree to PARAM_ATOL, test_cli_two_ranks; a render over
    the ranks gives the one-process bits on the same params,
    tests/test_torch_parallel_render.py)."""
    out, _ = runs[2]

    def vals(exp):
        """{step: {val/<metric>: value}} (one JSONL row a metric)."""
        by_step = {}
        with open(out / "logs" / exp / "metrics.jsonl") as f:
            for r in map(json.loads, f):
                for k, v in r.items():
                    if k.startswith("val/"):
                        by_step.setdefault(r["step"], {})[k] = v
        return by_step

    one, dp = vals("one"), vals("dp")
    assert dp and set(dp) <= set(one)
    for s, row in dp.items():
        assert set(row) == set(one[s]) and "val/ssim" in row
        for k, v in one[s].items():
            np.testing.assert_allclose(row[k], v, rtol=VAL_RTOL, atol=1e-9,
                                       err_msg=f"step {s}: {k}")
