"""Coarse-to-fine (`N_importance > 0`) training and evaluation of the port
against the JAX package on the CPU: one whole `make_train_step` step, a
K=2 `scan_steps` dispatch with hard sampling (its `tmp_rgb` buffer
against the JAX dispatch's), the buffer write on a batch with duplicate
pixels (`training/step.py::write_tmp_rgb` against the JAX step's scatter),
the eval CLI on `tests/helpers_scene.py`'s scene at `--N_importance`, and
`scripts/jax_ckpt_to_torch.py` on a JAX checkpoint with `nerf_coarse`.
The JAX side runs its Pallas kernels in interpret mode; torch runs on one
thread; each JAX result is computed once per module.

Tolerances. The steps: loss terms 1e-3 relative, Adam's moments 5e-2 in
Frobenius norm and 0.1 of each leaf's largest entry, the bounds and
reasons of tests/test_torch_train_step.py (the fine pass's depths are
importance draws, off the dyadic grid: tests/test_torch_c2f.py); after
the K=2 dispatch, whose moments sum two steps' gradients, every entry
within 0.2 of its leaf's largest (measured: 0.124 on the bias of the
coarse model's skip layer, a sum over 1024 samples in which a ReLU
turned by such a flip shows whole; 0.089 at most on the fine model, 2%
at most without coarse-to-fine) and 5e-2 in Frobenius norm (measured
3.6e-2); the buffer where both wrote 1e-3 abs, as
tests/test_torch_multi_step.py.
The duplicate-pixel write: exact (a copy of the winners' values). The
eval CLI: the frame PNGs decoded equal but for at most 0.5% of a split's
pixel channels one level off (bf16 towers on both sides, whose roundings
part now and then as in the renders), the ssim table within 1e-3. With
`--output_transient` the pixels of the frame's first row and column are
held to 8 levels and the psnr table to 5e-3 dB: there the render's own
camera sees a sample point at u or v within an ulp of 0, and the frustum
test `u >= 0` that culls its transient sigma is decided by the last bit
of o + d*z, which XLA forms in one fused multiply-add and torch in two
roundings; the importance draws put the fine samples off the grid where
both agree (measured: up to 4 levels on those pixels, 1.6e-3 dB, and
inside them at most one level on 0.09% of the channels)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.helpers_scene import make_synthetic_scene
from tests.test_torch_c2f import NI, jax_c2f_draws, jax_c2f_params
from tests.test_torch_train_step import _table
from tests.torch_train_helpers import (FRAMES, GRAD_MAX, LOSS_RTOL, NTAU,
                                       S, cams, grads_close, to_torch)

B = 32
BUF_TOL = 1e-3
PNG_SHARE = 5e-3
TABLE_TOL = 1e-3
BORDER_LEVELS, BORDER_PSNR_TOL = 8, 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(**extra):
    kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
              encode_t=True, N_samples=S, N_importance=NI, N_tau=NTAU,
              optimizer="adam", lr=1e-3, lr_scheduler="cosine",
              num_epochs=2, batch_size=B, dtype="bfloat16", fused_train="on")
    kw.update(extra)
    return kw


def _steps(scan_steps, hard, **extra):
    """(JAX step, port step, port tx) of one configuration."""
    jcfg = jconfig.NSFFConfig(**_cfg_kw(**extra))
    tcfg = tconfig.NSFFConfig(**_cfg_kw(**extra))
    flow = tuple(jcfg.output_transient_flow)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    kw = dict(output_transient=True, output_transient_flow=flow,
              steps_per_epoch=10, batch_size=B, hard_sampling=hard,
              scan_steps=scan_steps)
    jtrain = jstep.make_train_step(
        dataclasses.replace(j_render_config(jcfg), planar_compositing="on"),
        jloss.LossConfig(max_t=FRAMES - 1), jtx, donate=False, **kw)
    ttrain = tstep.make_train_step(
        tconfig.render_config(tcfg), tconfig.loss_config(tcfg), ttx,
        device="cpu", **kw)
    assert ttrain.use_planar
    return jtx, jtrain, ttx, ttrain


def _args(seed=None):
    table = _table()
    weights = (np.ones(table.shape[:2], np.float32) if seed is None else
               np.random.RandomState(seed).rand(*table.shape[:2])
               .astype(np.float32))
    Ks, Ps = cams()
    return table, weights, Ks, Ps


DISPATCH_MAX = 0.2


def _moments_close(tnew, jnew, max_rel=GRAD_MAX):
    tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
    assert set(tmom["mu"]) == {"nerf_fine", "nerf_coarse", "embedding_t"}
    grads_close(tmom["mu"], jnew.opt_state[0].mu, max_rel)
    grads_close(tmom["nu"], jnew.opt_state[0].nu, max_rel)
    return tmom


def test_train_step_c2f_matches_jax():
    """One step from the same JAX-initialised fine and coarse models:
    every loss term (the coarse ones inside `col_l` and `disp_l`) and
    Adam's moments of all three trees (0.1 g after one step)."""
    jtx, jtrain, ttx, ttrain = _steps(1, False)
    ins = _args()
    jp = jax_c2f_params(2)
    jstate = jstep.TrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(11)
    jnew, jm, _ = jtrain(jstate, *(jnp.asarray(a) for a in ins), key,
                         jnp.asarray(1))
    params = to_torch(jp)
    k_sample, k_render = jax.random.split(key)
    idx = torch.from_numpy(np.asarray(jax.random.randint(
        k_sample, (B,), 0, ins[0].shape[1])))
    tnew, tm, aux = ttrain(tstep.TrainState(params, ttx.init(params), 0),
                           *(torch.from_numpy(a) for a in ins), None, 1,
                           idx=idx, draws=jax_c2f_draws(k_render, B))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    assert aux["rgb_fine"].shape == (B, 3) and tnew.step == 1
    assert _moments_close(tnew, jnew)["count"] == 1


@pytest.fixture(scope="module")
def jax_dispatch():
    """The JAX package's K=2 dispatch with hard sampling at lr 0."""
    jtx, jtrain, _, _ = _steps(2, True, lr=0.0, lr_scheduler="const")
    ins = _args(3)
    ts = np.array([2, 0], np.int32)
    root = jax.random.PRNGKey(31)
    jp = jax_c2f_params(3)
    jstate = jstep.TrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    tmp = jnp.zeros(ins[0].shape[:2] + (3,), jnp.float32)
    jnew, jtmp, jm = jtrain(jstate, tmp, *(jnp.asarray(a) for a in ins),
                            root, jnp.asarray(ts))
    return ins, ts, root, jp, jnew, np.asarray(jtmp), {
        k: np.asarray(v) for k, v in jm.items()}


def test_multi_step_c2f_matches_jax_scan_steps(jax_dispatch):
    """The K-step dispatch carries draws of three trailing shapes ((K, B,
    S), (K, B, S_fine), (K, B, N_importance)) through its static buffers:
    per-step loss terms, the moments, and the hard-sampling buffer where
    the JAX dispatch wrote it (32 draws of 256 pixels a frame: a batch
    with duplicate pixels is likely, and the wrong duplicate's rgb would
    miss by far more than the tolerance)."""
    ins, ts, root, jp, jnew, jtmp, jm = jax_dispatch
    _, _, ttx, multi = _steps(2, True, lr=0.0, lr_scheduler="const")
    params = to_torch(jp)
    u, rows = [], []
    for k in jax.random.split(root, 2):
        k_sample, k_render = jax.random.split(k)
        u.append(torch.from_numpy(np.asarray(
            jax.random.uniform(k_sample, (B,)))))
        rows.append(jax_c2f_draws(k_render, B))
    draws = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    tmp = torch.zeros(ins[0].shape[:2] + (3,))
    new, tmp, m = multi(tstep.TrainState(params, ttx.init(params), 0), tmp,
                        *(torch.from_numpy(a) for a in ins), None,
                        torch.from_numpy(ts).long(), batch_u=torch.stack(u),
                        draws=draws)
    assert new.step == 2 == int(jnew.step)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=LOSS_RTOL,
                                   atol=1e-9, err_msg=k)
    assert _moments_close(new, jnew, DISPATCH_MAX)["count"] == 2
    written = np.abs(jtmp).sum(-1) > 0
    assert np.array_equal(tmp.abs().sum(-1).numpy() > 0, written)
    np.testing.assert_allclose(tmp.numpy()[written], jtmp[written],
                               atol=BUF_TOL, rtol=0)


def test_tmp_rgb_write_keeps_the_last_draw():
    """A batch that draws pixels 3 and 7 three times and pixel 5 twice:
    the port's write leaves the JAX step's scatter result
    (`tmp_rgb.at[t, rand_idx].set(rgb)`, the last draw in batch order),
    bit for bit, at every t it is given as (int and 0-d tensor)."""
    rng = np.random.RandomState(0)
    idx = np.array([3, 7, 5, 3, 0, 7, 5, 3, 9, 7], np.int64)
    rgb = rng.rand(len(idx), 3).astype(np.float32)
    tmp0 = rng.rand(2, 12, 3).astype(np.float32)
    for t in (1, torch.tensor(1)):
        want = np.asarray(jnp.asarray(tmp0).at[1, jnp.asarray(idx)].set(
            jnp.asarray(rgb)))
        got = torch.from_numpy(tmp0.copy())
        tstep.write_tmp_rgb(got, t, torch.from_numpy(idx),
                            torch.from_numpy(rgb))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got[1, 3].numpy(), rgb[7])


W, H, NF = 32, 24, 3


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    from nsff_pl_tpu.config import NSFFConfig
    from nsff_pl_tpu.training import checkpoint as jckpt
    from nsff_pl_tpu.training.trainer import build_params

    tmp = tmp_path_factory.mktemp("evalc2f")
    scene = make_synthetic_scene(str(tmp / "scene"), W=W, H=H, N=NF,
                                 learnable=True)
    cfg = NSFFConfig(root_dir=scene, img_wh=(W, H), start_end=(0, NF),
                     N_samples=8, N_importance=4, encode_t=True, N_tau=8)
    params = jax.tree.map(np.asarray,
                          build_params(cfg, jax.random.PRNGKey(5)))
    assert "nerf_coarse" in params
    for name, scale in (("static_rgb", 6.0), ("transient_rgb", 6.0)):
        for model in ("nerf_fine", "nerf_coarse"):
            p = params[model]
            p[name] = {k: v * scale for k, v in p[name].items()}
    jax_ckpt = jckpt.save_checkpoint(str(tmp / "jax_ckpt"), 0,
                                     {"params": params})
    torch_ckpt = tckpt.save_checkpoint(
        str(tmp / "torch_ckpt"), 0,
        {"params": tckpt.params_from_jax(params, "cpu")})
    return str(tmp), scene, jax_ckpt, torch_ckpt


def _run_in(cwd, fn):
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        fn()
    finally:
        os.chdir(here)


@pytest.mark.parametrize("output_transient", [False, True])
def test_eval_cli_c2f_matches_jax(eval_setup, output_transient, capsys):
    """The test split at `--N_importance 4` (S = 8, so S_fine = 12 for the
    static tower, 16 with `--output_transient`), bfloat16 on the planar
    path (`--planar_eval on`), in both CLIs: the same files, the frames
    and the metric tables."""
    from nsff_pl_tpu.apps import evaluate as jeval
    from nsff_pl_tpu_torch.apps import evaluate as teval

    tmp, scene, jax_ckpt, torch_ckpt = eval_setup
    name = f"c2f_{int(output_transient)}"

    def argv(ckpt):
        return ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh",
                str(W), str(H), "--start_end", "0", str(NF), "--N_samples",
                "8", "--N_importance", "4", "--encode_t", "--N_tau", "8",
                "--split", "test", "--scene_name", name, "--video_format",
                "gif", "--chunk", "512", "--dtype", "bfloat16",
                "--planar_eval", "on"] + (
                    ["--output_transient"] if output_transient else [])

    jdir, tdir = os.path.join(tmp, "jax"), os.path.join(tmp, "torch")
    _run_in(jdir, lambda: jeval.main(jeval.get_opts(argv(jax_ckpt))))
    _run_in(tdir, lambda: teval.cli(argv(torch_ckpt), device="cpu"))
    capsys.readouterr()
    jout = os.path.join(jdir, "results", "monocular", name)
    tout = os.path.join(tdir, "results", "monocular", name)
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    pngs = [f for f in names if f.endswith(".png")]
    assert len(pngs) == NF
    off = total = 0
    border = 1 if output_transient else 0
    for f in pngs:
        a, b = (np.asarray(Image.open(os.path.join(d, f)), np.int16)
                for d in (jout, tout))
        err = np.abs(a - b)
        assert err.max() <= (BORDER_LEVELS if border else 1), f
        inner = err[border:, border:]
        assert inner.max() <= 1, f
        off += int((inner > 0).sum())
        total += inner.size
    assert off <= PNG_SHARE * total, (off, total)
    for table, tol in (("psnr.npy", BORDER_PSNR_TOL if border else
                        TABLE_TOL), ("ssim.npy", TABLE_TOL)):
        np.testing.assert_allclose(np.load(os.path.join(tout, table)),
                                   np.load(os.path.join(jout, table)),
                                   atol=tol, rtol=0)


def test_jax_c2f_checkpoint_converts(tmp_path):
    """`scripts/jax_ckpt_to_torch.py` on an orbax checkpoint of a
    coarse-to-fine training state: the port's system restores it with
    `nerf_coarse` and its Adam moments, leaf for leaf."""
    from nsff_pl_tpu.training import checkpoint as jckpt
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem
    from scripts.jax_ckpt_to_torch import convert

    jp = jax_c2f_params(4)
    jtx = joptim.make_optimizer(jconfig.NSFFConfig(), 10)
    opt = jtx.init(jp)
    opt = jax.tree.map(lambda x: x + 0.5 if x.dtype == jnp.float32 else x,
                       opt)
    scene = make_synthetic_scene(str(tmp_path / "scene"), W=W, H=H,
                                 N=FRAMES)
    src = jckpt.save_checkpoint(str(tmp_path / "jax"), 7, {
        "state": {"params": jp, "opt_state": opt, "step": jnp.asarray(7)},
        "sampling_weights": jnp.ones((FRAMES, W * H), jnp.float32)})
    path = convert(src, str(tmp_path / "converted"))
    cfg = tconfig.NSFFConfig(
        root_dir=scene, img_wh=(W, H), start_end=(0, FRAMES), encode_t=True,
        use_viewdir=True, N_samples=S, N_importance=NI, N_tau=NTAU,
        batch_size=B, dtype="bfloat16", fused_train="on",
        train_backend="pallas", ckpt_path=path,
        log_dir=str(tmp_path / "logs"),
        ckpt_dir=str(tmp_path / "c"))
    system = NSFFSystem(cfg, device="cpu")
    assert system.state.step == 7
    assert "nerf_coarse" in system.state.params
    adam = opt[0]
    for got, want in ((toptim.param_leaves(system.state.params),
                       toptim.param_leaves(jp)),
                      (system.state.opt_state.mu, toptim.param_leaves(
                          adam.mu)),
                      (system.state.opt_state.nu, toptim.param_leaves(
                          adam.nu))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [5, 1024, 147456, 150001])
def test_blocked_weight_cdf(n):
    """`data/pipeline.py::blocked_cumsum`, the hard-sampling CDF on the
    card (rows of 1024 and their offsets, no single-pass scan whose
    order depends on timing), on the CPU: within 1e-6 of the float64
    cumulative sum relative to the total, and the same bits twice."""
    from nsff_pl_tpu_torch.data.pipeline import blocked_cumsum

    w = torch.rand(n, generator=torch.Generator().manual_seed(n))
    got = blocked_cumsum(w)
    want = torch.cumsum(w.double(), 0)
    assert got.shape == (n,)
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want[-1])
    assert torch.equal(blocked_cumsum(w), got)

