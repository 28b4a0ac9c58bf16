"""The port's trainer and train CLI (`nsff_pl_tpu_torch/training/trainer.py`,
`apps/train.py`, `training/checkpoint.py`) on the CPU, on one synthetic
scene (`tests/helpers_scene.py::make_synthetic_scene`, 32x24, 5 frames: 3
steps an epoch), float32 on the plain evaluators (N_samples 16, batch 32,
full width), with hard sampling, `scan_steps=2` and a validation every 2
steps. Torch runs on one thread (many tiny ops).

- Against the JAX package's `NSFFSystem` on the same scene and config:
  steps_per_epoch and total_steps equal; the frame schedule equal; the lr
  at several steps to 1e-6 relative; `validate()`'s psnr, ssim, psnr_mask
  and ssim_mask within 1e-4 on JAX-initialised params (`params_from_jax`),
  and the hard-sampling weights it refreshes from the same `tmp_rgb`
  within 1e-5.
- Against itself, bit for bit: `fit` over 2 epochs (one K=2 dispatch, two
  single steps clipped by the epoch end and the validation cadence,
  another dispatch) equals a hand loop of `make_train_step` (scan_steps 2
  and 1) on the same generator, frames and weight refreshes (params,
  Adam, `tmp_rgb`, the weights and every JSONL row); a `time_budget_s`
  exit through `cli(..., device="cpu")` (which writes the JSONL,
  `step_<n>` and `config.json`) plus a resume by `ckpt_path` equals the
  uninterrupted run.
- Checkpoint import: `import_pl_checkpoint` equals the JAX package's on
  `tests/test_golden_cross.py::make_torch_ckpt` (equal); a JAX orbax
  checkpoint (`ckpts/smoke_full/step_15`) converted by
  `scripts/jax_ckpt_to_torch.py` resumes an `NSFFSystem` with the JAX
  params, Adam state, step and sampling weights (equal), and warm-starts
  one by `weight_path` (params only).
- Options not ported (more than one GPU, other datasets) raise
  `NotImplementedError` naming their ROADMAP item (`profile_dir`:
  tests/test_torch_profiling.py).
"""
import json
import os

import numpy as np
import pytest
import torch

from nsff_pl_tpu_torch.apps.train import cli
from nsff_pl_tpu_torch.config import (NSFFConfig, build_params, loss_config,
                                      render_config)
from nsff_pl_tpu_torch.data.pipeline import FrameScheduler
from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
from nsff_pl_tpu_torch.training import metrics as metrics_lib
from nsff_pl_tpu_torch.training.optim import make_optimizer, param_leaves
from nsff_pl_tpu_torch.training.step import TrainState, make_train_step
from nsff_pl_tpu_torch.training.trainer import NSFFSystem
from tests.helpers_scene import make_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 32, 24, 5
VAL_TOL, WEIGHT_TOL, LR_RTOL = 1e-4, 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    return make_synthetic_scene(root, W=W, H=H, N=N, learnable=True)


def _kw(scene, out, exp, **extra):
    kw = dict(root_dir=scene, img_wh=(W, H), start_end=(0, N),
              encode_t=True, use_viewdir=True, N_samples=16, batch_size=32,
              num_epochs=2, lr_scheduler="cosine", hard_sampling=True,
              scan_steps=2, val_every_steps=2, log_dir=str(out / "logs"),
              ckpt_dir=str(out / "ckpts"), exp_name=exp)
    kw.update(extra)
    return kw


def _argv(kw):
    argv = []
    for k, v in kw.items():
        if v is True:
            argv.append(f"--{k}")
        elif isinstance(v, tuple):
            argv += [f"--{k}", *map(str, v)]
        else:
            argv += [f"--{k}", str(v)]
    return argv


def _rows(out, exp):
    rows = {}
    with open(out / "logs" / exp / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if "train/loss" in r:
                rows[r["step"]] = r
    return rows


def _snapshot(system):
    opt = system.state.opt_state
    return {"params": [p.detach().clone() for p in
                       param_leaves(system.state.params)],
            "mu": [m.clone() for m in opt.mu],
            "nu": [v.clone() for v in opt.nu], "count": int(opt.count),
            "step": system.state.step, "tmp": system.tmp_rgb.clone(),
            "weights": system.batcher.weights.clone()}


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["count"] == b["count"]
    for k in ("params", "mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
    assert torch.equal(a["tmp"], b["tmp"])
    assert torch.equal(a["weights"], b["weights"])


@pytest.fixture(scope="module")
def fitted(scene, tmp_path_factory):
    """An uninterrupted fit: its final state and its JSONL rows."""
    out = tmp_path_factory.mktemp("fit")
    system = NSFFSystem(NSFFConfig(**_kw(scene, out, "full")), device="cpu")
    assert (system.steps_per_epoch, system.total_steps) == (3, 6)
    system.fit(progress=False)
    assert system.train_step.captures == 0  # the CPU runs eagerly
    return system, _snapshot(system), _rows(out, "full")


def test_fit_equals_a_hand_loop(fitted):
    system, want, rows = fitted
    cfg = system.cfg
    params = build_params(cfg, torch.Generator().manual_seed(cfg.seed),
                          device="cpu")
    tx = make_optimizer(cfg, 3)
    state = TrainState(params, tx.init(params), 0)
    kw = dict(output_transient=True,
              output_transient_flow=tuple(cfg.output_transient_flow),
              steps_per_epoch=3, batch_size=cfg.batch_size,
              hard_sampling=True, device="cpu")
    multi = make_train_step(render_config(cfg), loss_config(cfg), tx,
                            scan_steps=2, **kw)
    single = make_train_step(render_config(cfg), loss_config(cfg), tx, **kw)
    table = system.batcher.table
    weights = torch.ones_like(system.batcher.weights)
    tmp = torch.zeros_like(system.tmp_rgb)
    Ks, Ps = system.Ks, system.Ps
    sched = FrameScheduler(N, seed=cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    got = {}

    def refresh():  # the validation's hard-sampling weights
        for i in range(N):
            sm = metrics_lib.ssim(
                table[i, :, 6:9].reshape(H, W, 3),
                torch.clamp(tmp[i].reshape(H, W, 3), 0, 1),
                reduction="none").mean(-1)
            weights[i] = (1 - sm).reshape(-1)

    # groups: a dispatch, two steps clipped by the epoch end (3) and the
    # validations (2, 4), a dispatch
    for kind, s in (("multi", 0), ("single", 2), ("single", 3),
                    ("multi", 4)):
        if kind == "multi":
            ts = torch.tensor([sched.next(), sched.next()])
            state, tmp, m = multi(state, tmp, table, weights, Ks, Ps, gen,
                                  ts)
            for i in range(2):
                got[s + i] = {k: float(v[i]) for k, v in m.items()}
            end = s + 2
        else:
            t = sched.next()
            state, m, aux = single(state, table, weights, Ks, Ps, gen, t)
            with torch.no_grad():
                tmp[t, aux["rand_idx"]] = aux["rgb_fine"]
            got[s] = {k: float(v) for k, v in m.items()}
            end = s + 1
        if end % 2 == 0:
            refresh()
    opt = state.opt_state
    _assert_same(want, {"params": param_leaves(state.params), "mu": opt.mu,
                        "nu": opt.nu, "count": int(opt.count),
                        "step": state.step, "tmp": tmp, "weights": weights})
    assert sorted(rows) == list(range(6))
    for s, row in got.items():
        assert {f"train/{k}": v for k, v in row.items()} == {
            k: v for k, v in rows[s].items() if k != "step"}


def test_budget_exit_and_resume_equal_the_uninterrupted_run(
        scene, fitted, tmp_path):
    _, want, want_rows = fitted
    kw = _kw(scene, tmp_path, "cut")
    first = cli(_argv(dict(kw, time_budget_s=1e-9)), device="cpu")
    assert first.state.step == 2 and first.steps_run == 2
    ckpt = tmp_path / "ckpts" / "cut" / "step_2"
    assert (ckpt / "state.pt").exists()
    assert (tmp_path / "ckpts" / "cut" / "config.json").exists()
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts" / "cut")) \
        == str(ckpt)
    cfg = json.loads((tmp_path / "ckpts" / "cut" / "config.json").read_text())
    assert cfg["time_budget_s"] == 1e-9 and cfg["scan_steps"] == 2
    assert sorted(_rows(tmp_path, "cut")) == [0, 1]
    second = NSFFSystem(NSFFConfig(**dict(kw, ckpt_path=str(ckpt))),
                        device="cpu")
    assert second.state.step == 2
    second.fit(progress=False)
    _assert_same(_snapshot(second), want)
    rows = _rows(tmp_path, "cut")
    assert sorted(rows) == list(range(6))
    assert rows == want_rows
    assert sorted(os.listdir(tmp_path / "ckpts" / "cut")) == [
        "config.json", "step_2", "step_3", "step_6"]


def test_validate_and_schedule_match_jax(scene, tmp_path):
    import jax
    import jax.numpy as jnp

    from nsff_pl_tpu import config as jconfig
    from nsff_pl_tpu.training.trainer import NSFFSystem as JSystem

    kw = _kw(scene, tmp_path, "jax")
    jsys = JSystem(jconfig.NSFFConfig(**kw))
    tsys = NSFFSystem(NSFFConfig(**dict(kw, exp_name="port")), device="cpu")
    assert (tsys.steps_per_epoch, tsys.total_steps) == (
        jsys.steps_per_epoch, jsys.total_steps)
    assert [tsys.scheduler.next() for _ in range(20)] == [
        jsys.scheduler.next() for _ in range(20)]
    for s in (0, 1, 3, 4, 5, 6):
        np.testing.assert_allclose(tsys.lr_schedule(s),
                                   float(jsys.lr_schedule(s)), rtol=LR_RTOL)
    jparams = jax.tree.map(np.asarray, jsys.state.params)
    with torch.no_grad():
        for dst, src in zip(param_leaves(tsys.state.params),
                            param_leaves(ckpt_lib.params_from_jax(
                                jparams, device="cpu"))):
            dst.copy_(src)
    tmp = np.random.default_rng(0).uniform(
        -0.1, 1.1, tuple(tsys.tmp_rgb.shape)).astype(np.float32)
    jsys.tmp_rgb = jnp.asarray(tmp)
    tsys.tmp_rgb.copy_(torch.from_numpy(tmp))
    jlog, tlog = jsys.validate(0), tsys.validate(0)
    assert set(jlog) == set(tlog) == {"psnr", "ssim", "psnr_mask",
                                      "ssim_mask"}
    for k in jlog:
        assert abs(tlog[k] - jlog[k]) <= VAL_TOL, (k, tlog[k], jlog[k])
    np.testing.assert_allclose(tsys.batcher.weights.numpy(),
                               np.asarray(jsys.batcher.weights),
                               atol=WEIGHT_TOL)


def test_pl_checkpoint_import_matches_jax(tmp_path):
    from nsff_pl_tpu.training import checkpoint as jckpt
    from tests.test_golden_cross import make_torch_ckpt

    path = str(tmp_path / "ref.ckpt")
    make_torch_ckpt(path, np.random.RandomState(0))
    want = jckpt.import_pl_checkpoint(path, ["loss"])
    got = ckpt_lib.import_pl_checkpoint(path)
    assert set(got) == set(want) == {"nerf_fine", "embedding_t"}
    assert set(got["nerf_fine"]) == set(want["nerf_fine"])
    for a, b in zip(param_leaves(got), param_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    merged = ckpt_lib.merge_params(
        {"nerf_fine": {"static_rgb": {"w": 0, "b": 1}, "extra": 2},
         "embedding_a": 3}, got)
    assert merged["embedding_a"] == 3 and merged["nerf_fine"]["extra"] == 2
    assert merged["nerf_fine"]["static_rgb"]["w"] is \
        got["nerf_fine"]["static_rgb"]["w"]


def test_orbax_checkpoint_converts_and_resumes(tmp_path):
    from scripts.jax_ckpt_to_torch import convert, read_orbax

    src = os.path.join(REPO, "ckpts", "smoke_full", "step_15")
    raw = read_orbax(src)
    path = convert(src, str(tmp_path / "converted"))
    assert os.path.basename(path) == "step_15"
    scene = make_synthetic_scene(str(tmp_path / "scene"), W=64, H=48, N=5)
    kw = dict(root_dir=scene, img_wh=(64, 48), start_end=(0, 5),
              encode_t=True, use_viewdir=True, N_samples=16, batch_size=32,
              log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "c"))
    system = NSFFSystem(NSFFConfig(**dict(kw, ckpt_path=path)), device="cpu")
    state = raw["state"]
    adam = state["opt_state"][0]
    opt = system.state.opt_state
    assert system.state.step == int(state["step"]) == 15
    assert int(opt.count) == int(adam["count"])
    for got, want in ((param_leaves(system.state.params),
                       param_leaves(state["params"])),
                      (opt.mu, param_leaves(adam["mu"])),
                      (opt.nu, param_leaves(adam["nu"]))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    np.testing.assert_array_equal(system.batcher.weights.numpy(),
                                  np.asarray(raw["sampling_weights"]))
    warm = NSFFSystem(NSFFConfig(**dict(kw, weight_path=path)), device="cpu")
    assert warm.state.step == 0 and int(warm.state.opt_state.count) == 0
    for a, b in zip(param_leaves(warm.state.params),
                    param_leaves(state["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("extra,label", [
    (dict(num_gpus=2), "multi-GPU"), (dict(num_nodes=2), "multi-GPU"),
    (dict(coordinator_address="localhost:1234"), "multi-GPU"),
    (dict(dataset_name="blender"), "monocular")])
def test_unported_options_raise(scene, tmp_path, extra, label):
    """Options whose features are not ported name their ROADMAP item
    before anything is loaded. The multi-GPU options are ported
    (tests/test_torch_parallel.py) and raise here, before anything is
    loaded, only where no rank stands behind them: more than one rank
    asked for without the launcher's mesh, several nodes without a
    coordinator, and the JAX package's `--coordinator_address requires
    --node_rank`."""
    cfg = NSFFConfig(**_kw(scene, tmp_path, "x", **extra))
    if label == "multi-GPU":
        why = {"num_gpus": "no mesh: multi-GPU training",
               "num_nodes": "needs --coordinator_address",
               "coordinator_address": "requires --node_rank"}[next(
                   iter(extra))]
        with pytest.raises(ValueError, match=why):
            NSFFSystem(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=label):
        NSFFSystem(cfg, device="cpu")
