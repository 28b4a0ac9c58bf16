"""Coarse-to-fine (`N_importance > 0`) on the port's packed path
(`models/rendering.py::render_rays` with `planar_eval='off'` /
`fused_train='off'`, float32, the static-only model) against the JAX
package's `render_rays` on the CPU: the training render with its loss
terms (with and without the fused compositor) and the gradients of the
fine model, the coarse model and the time embedding, the test render
(both towers with a visibility set, and the static tower alone), the
float32 plain evaluators, the bfloat16 plain evaluators, a K=2 dispatch
of the static-only model's step against JAX `scan_steps`, and the eval
CLI with `--planar_eval off`. Weights are JAX-initialised
(`params_from_jax`, with `nerf_coarse`), inputs seeded numpy, the draws
rebuilt from the JAX key (`c2f_draws`); the JAX side runs its Pallas
kernels in interpret mode, each JAX result computed once per module
under one `jax.jit`; torch runs on one thread.

Tolerances, those of tests/test_torch_packed_render.py and
tests/test_torch_train_step.py for their reasons: on the kernel backend
every key 2e-4 abs with at most 5% of all entries off by more than 1e-5;
float32 2e-6 abs; the fine depths (the importance draws) and the points
on them 1e-5 abs; loss terms 1e-3 relative; gradients 5e-2 in Frobenius
norm and 0.1 of a leaf's largest entry.

The coarse pass runs on the plain evaluators in the compute dtype on
both sides, in bfloat16 the "bf16 plain evaluators": on the same inputs
they agree with XLA's to 6e-8 (`models/nerf.py::_linear`: the products
accumulated in f32 and rounded once, the transient feature's bias added
in f32 as XLA folds it). But the points o + d*z take one fused multiply-
add in XLA and two roundings in torch; now and then that last bit flips
a bf16 rounding of a posenc lane, shown whole in the sample, and the
coarse weights so moved move the importance draws (the flip model of
tests/test_torch_c2f.py; measured 3.3e-6 on the fine depths in bfloat16,
1.4e-6 in float32), which in turn flip roundings and ReLU masks of the
fine pass. So in bfloat16 training the gradients are held to
BF16_GRAD_MAX = 0.2 of a leaf's largest entry (measured 0.158, on the
fine model's static_xyz_2; with the JAX package's fine depths put in
place of the port's, every fine leaf agrees within 0.02 and 1e-2
Frobenius) and 5e-2 in Frobenius norm (measured 3.8e-2; the static-only
model's K=2 dispatch, whose moments sum two steps' gradients: 0.102 of
the largest entry, 3.4e-2 Frobenius). The coarse model's bias gradients
are JAX's reduce of a bf16 cotangent, which XLA's CPU backend
accumulates in bf16 (`test_jax_bf16_bias_gradient_reduces_in_bf16`),
where torch sums in f32: they are held to BIAS_MAX = 0.5 and BIAS_FRO =
0.25 (measured 0.40 and 0.21 on transient_xyz_final, whose sum cancels
most; 0.075 / 0.081 at most on the other layers; the dispatch 0.044 /
0.059). The bf16 plain evaluators of the fine pass too
(`train_backend='xla'`, `mlp_backend='xla'`), at test time, against
XLA's bf16 evaluators: the kernel backend's bounds (measured 5.2e-5 abs,
0.43% of the entries off by more than 1e-5; the kernel backend 5.0e-5
and 1.4%). The test renders use N_samples = 17 and dyadic rays: the
stratified depths i / 16 make o + d*z exact on both sides, so the coarse
pass's visibility culling, a frustum test decided by the last bit of o +
d*z (tests/test_torch_c2f_step.py), agrees. The eval CLI (float32): the
frame PNGs equal but for at most 0.1% of the channels one level off, the
tables within 1e-4 (measured: equal PNGs, 2.9e-6 dB)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.models.rendering import render_rays as j_render_rays
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.models.rendering import (RenderConfig, draw_shapes,
                                                render_rays)
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.helpers_scene import make_synthetic_scene
from tests.test_torch_c2f import K as TEST_K
from tests.test_torch_c2f import NI, _test_inputs, jax_c2f_params
from tests.test_torch_train_step import _table
from tests.torch_train_helpers import (FRAMES, GRAD_FRO, GRAD_MAX, LOSS_RTOL,
                                       N, NTAU, S, cams, make_batch,
                                       to_torch)

KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE = 2e-4, 1e-5, 0.05
F32_TOL = 2e-6
ZS_TOL = 1e-5
BF16_GRAD_MAX = 0.2
BIAS_MAX, BIAS_FRO = 0.5, 0.25
FLOW = ("fw", "bw", "disocc")
# the fine depths, and the points on them (held to the larger of ZS_TOL
# and the key's tolerance: the warped points add per-sample flows)
ZS_KEYS = ("zs_fine", "static_zs_fine", "transient_zs_fine")
POS_KEYS = ("xyzs_fine", "xyzs_fw", "xyzs_bw", "xyzs_fw_bw", "xyzs_bw_fw")
PACKED = dict(N_samples=S, N_importance=NI, perturb=1.0, noise_std=1.0,
              use_viewdir=True, encode_t=True, N_tau=NTAU,
              max_t=FRAMES - 1, compute_dtype="bfloat16",
              train_backend="pallas", mlp_backend="pallas",
              planar_eval="off", fused_train="off", img_wh=(16, 16))
PLAIN = dict(train_backend="xla", mlp_backend="xla")
B = 16
S_TEST = 17  # dyadic stratified depths i / 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops; the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def c2f_draws(key, n, output_transient=True):
    """The JAX packed render's draws from its key, under the port's names
    (`models/rendering.py::render_rays` lists the splits)."""
    k_perturb, k_pdf_s, k_pdf_t, k_rest = jax.random.split(key, 4)
    k_coarse, k_fine = jax.random.split(k_rest)
    kc = jax.random.split(k_coarse, 4)
    kf = jax.random.split(k_fine, 4)
    sf = S + (2 if output_transient else 1) * NI
    out = {"u": jax.random.uniform(k_perturb, (n, S)),
           "u_pdf_s": jax.random.uniform(k_pdf_s, (n, NI)),
           "ncs": jax.random.normal(kc[0], (n, S)),
           "nct": jax.random.normal(kc[1], (n, S))}
    if output_transient:
        out["u_pdf_t"] = jax.random.uniform(k_pdf_t, (n, NI))
    out.update({k: jax.random.normal(kk, (n, sf))
                for k, kk in zip(("ns", "nt", "nw1", "nw2"), kf)})
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def static_c2f_params(seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    return {"nerf_fine": jn.init_nerf_params(ks[0], "fine", use_viewdir=True,
                                             encode_transient=False),
            "nerf_coarse": jn.init_nerf_params(ks[1], "coarse",
                                               use_viewdir=True,
                                               encode_transient=False)}


def _models(p):
    return ({"fine": p["nerf_fine"], "coarse": p["nerf_coarse"]},
            {"t": p["embedding_t"]} if "embedding_t" in p else {})


def _c2f_grads_close(got, want, max_rel=GRAD_MAX):
    """`grads_close`'s rule leaf by leaf in bfloat16 (the coarse pass on
    the bf16 plain evaluators): BF16_GRAD_MAX (or a wider `max_rel`) of a
    leaf's largest entry and GRAD_FRO in Frobenius norm, the coarse
    model's bias gradients BIAS_MAX / BIAS_FRO (see the docstring)."""
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        keys = [getattr(k, "key", None) for k in path]
        bias = keys[0] == "nerf_coarse" and keys[-1] == "b"
        mx, fro = ((BIAS_MAX, BIAS_FRO) if bias
                   else (max(max_rel, BF16_GRAD_MAX), GRAD_FRO))
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert np.abs(g - w).max() <= mx * max(np.abs(w).max(), 1e-12), name
        assert np.linalg.norm(g - w) <= fro * np.linalg.norm(w) + 1e-12, name


def _hold(jout, tout, tol, exact=None, share=None):
    """Key for key: the depths to ZS_TOL, the rest to `tol`, and with
    `exact` at most `share` of all entries off by more than it."""
    assert set(tout) == set(jout)
    off = total = 0
    for k, want in jout.items():
        got = tout[k]
        assert got.shape == want.shape, k
        err = np.abs(got - want)
        bound = (ZS_TOL if k in ZS_KEYS else max(tol, ZS_TOL)
                 if k in POS_KEYS else tol)
        assert err.max() <= bound, (k, err.max())
        if exact is not None:
            off += int((err > exact).sum())
            total += err.size
    if exact is not None:
        assert off <= share * total, off / total


# the cases' render options. The unfused kernel case is held against the
# JAX render with the fused compositor: the two compositings are one
# function (B6 against its plain version: tests/test_torch_compositing_
# kernel.py), and one JAX compile fewer keeps the module's time in bounds.
# Gradients are compared on the fused case: B4's backward, and the plain
# evaluators' and the plain compositing's autograd in its coarse pass,
# which the unfused case and float32 run too
TRAIN_CASES = {"kernels": dict(fused_compositing=False),
               "fused_compositing": dict(fused_compositing=True),
               "float32": dict(compute_dtype="float32", **PLAIN)}
JAX_CASE = {"kernels": "fused_compositing"}
GRAD_CASES = ("fused_compositing",)
TEST_CASES = {"kernels_vis": ({}, True), "kernels_static": ({}, False),
              "float32_vis": (dict(compute_dtype="float32", **PLAIN), True),
              "bf16_plain_vis": (dict(PLAIN), True)}


@pytest.fixture(scope="module")
def jax_train():
    """The JAX training render + compute_losses, its results, loss terms
    and (GRAD_CASES) gradients, of every TRAIN_CASES entry JAX_CASE does
    not map to another."""
    jp = jax_c2f_params(1)
    b = make_batch()
    Ks, Ps = cams()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(5)
    out = {}
    for case, over in TRAIN_CASES.items():
        if case in JAX_CASE:
            continue
        jcfg = JRenderConfig(**{**PACKED, **over})

        def loss_fn(p, jcfg=jcfg):
            models, emb = _models(p)
            res = j_render_rays(models, emb, jb["rays"], jb["ts"], key, jcfg,
                                test_time=False, output_transient_flow=FLOW)
            ld = jloss.compute_losses(
                res, jb, jloss.LossConfig(max_t=FRAMES - 1), epoch=2,
                output_transient_flow=FLOW, Ks=jnp.asarray(Ks),
                Ps=jnp.asarray(Ps))
            return jloss.total_loss(ld), (ld, res)

        if case in GRAD_CASES:
            (_, (ld, res)), g = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(jp)
        else:
            (ld, res), g = jax.jit(loss_fn)(jp)[1], None
        out[case] = (jax.tree.map(np.asarray, (ld, res)), g)
    return jp, key, out


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_render_c2f_matches_jax(jax_train, case):
    """The training render at S_fine = 32 on the JAX draws: every result
    key (the coarse ones included), every loss term (the coarse colour
    and depth terms inside `col_l` and `disp_l`) and, in GRAD_CASES, the
    gradients of the fine model, the coarse model and the time
    embedding."""
    jp, key, out = jax_train
    (jld, jres), jg = out[JAX_CASE.get(case, case)]
    cfg = RenderConfig(**{**PACKED, **TRAIN_CASES[case]})
    params = to_torch(jp)
    for leaf in toptim.param_leaves(params):
        leaf.requires_grad_(True)
    b = make_batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"], tb["cam_ids"] = tb["ts"].long(), tb["cam_ids"].long()
    Ks, Ps = cams()
    draws = c2f_draws(key, N)
    assert {k: tuple(v.shape) for k, v in draws.items()} == draw_shapes(cfg, N)
    models, emb = _models(params)
    res = render_rays(models, emb, tb["rays"], tb["ts"], cfg, test_time=False,
                      output_transient_flow=FLOW, draws=draws)
    ld = tloss.compute_losses(res, tb, tloss.LossConfig(max_t=FRAMES - 1),
                              epoch=2, output_transient_flow=FLOW,
                              Ks=torch.from_numpy(Ks),
                              Ps=torch.from_numpy(Ps))
    tloss.total_loss(ld).backward()
    assert res["zs_fine"].shape == (N, S + 2 * NI)
    assert {"rgb_coarse", "depth_coarse", "static_weights_coarse",
            "transient_weights_coarse"} <= set(res)
    tres = {k: v.detach().numpy() for k, v in res.items()}
    if case == "float32":
        _hold(jres, tres, F32_TOL)
    else:
        _hold(jres, tres, KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE)
    assert set(ld) == set(jld) and len(ld) == 11
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    if case not in GRAD_CASES:
        return
    _c2f_grads_close(jax.tree.map(
        lambda t: (t.grad if t.grad is not None else torch.zeros_like(t))
        .numpy(), params, is_leaf=lambda x: isinstance(x, torch.Tensor)), jg)


def _test_cfg(over, both):
    return {**PACKED, **over, "encode_t": both, "N_samples": S_TEST,
            "img_wh": (8, 6)}


def _test_vis(poses):
    """The culling camera of tests/test_torch_c2f.py, moved sideways so
    that part of the samples lie outside its frustum."""
    poses = poses.copy()
    poses[0, 0, 3] = 0.4
    return dict(vis_poses=poses, vis_K=TEST_K)


@pytest.fixture(scope="module")
def jax_test():
    """The JAX test render of every TEST_CASES entry."""
    jp, sp = jax_c2f_params(2), static_c2f_params(2)
    rays, ts, poses = _test_inputs()
    out = {}
    for case, (over, both) in TEST_CASES.items():
        jcfg = JRenderConfig(**_test_cfg(over, both))
        vis = ({k: jnp.asarray(v) for k, v in _test_vis(poses).items()}
               if both else {})

        def render(p, r, t, jcfg=jcfg, vis=vis, both=both):
            models, emb = _models(p)
            return j_render_rays(models, emb, r, t, jax.random.PRNGKey(0),
                                 jcfg, test_time=True,
                                 output_transient=both,
                                 output_transient_flow=("fw", "bw")
                                 if both else (), **vis)

        out[case] = jax.tree.map(np.asarray, jax.jit(render)(
            jp if both else sp, jnp.asarray(rays), jnp.asarray(ts)))
    return jp, sp, rays, ts, poses, out


@pytest.mark.parametrize("case", sorted(TEST_CASES))
def test_test_render_c2f_matches_jax(jax_test, case):
    """The test render: the coarse pass sigma only, deterministic
    importance draws, the fine pass at S_fine = 33 (both towers, with the
    visibility culling against one camera) or 25 (the static tower
    alone), on tests/test_torch_c2f.py's dyadic rays."""
    jp, sp, rays, ts, poses, out = jax_test
    over, both = TEST_CASES[case]
    want = out[case]
    cfg = RenderConfig(**_test_cfg(over, both))
    models, emb = _models(to_torch(jp if both else sp))
    vis = ({k: torch.from_numpy(v) for k, v in _test_vis(poses).items()}
           if both else {})
    with torch.inference_mode():
        got = render_rays(models, emb, torch.from_numpy(rays),
                          torch.from_numpy(ts).long(), cfg, test_time=True,
                          output_transient=both,
                          output_transient_flow=("fw", "bw") if both else (),
                          **vis)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["zs_fine"].shape == (N, S_TEST + (2 if both else 1) * NI)
    assert "static_zs_fine" in got and "rgb_coarse" not in got
    if case.startswith("float32"):
        _hold(want, got, F32_TOL)
    else:
        _hold(want, got, KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE)
    if both:  # the culling bites: some samples lie outside the frustum
        culled = got["transient_sigmas_fine"] < 1e-4
        assert 0 < culled.mean() < 1


def _steps(scan_steps, hard, static_only, **extra):
    """(JAX tx, JAX step, port tx, port step) of one packed c2f
    configuration (`fused_train='off'`)."""
    kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
              encode_t=not static_only, N_samples=S, N_importance=NI,
              N_tau=NTAU, optimizer="adam", lr=1e-3, lr_scheduler="cosine",
              num_epochs=2, batch_size=B, dtype="bfloat16",
              fused_train="off", train_backend="pallas")
    kw.update(extra)
    jcfg, tcfg = jconfig.NSFFConfig(**kw), tconfig.NSFFConfig(**kw)
    flow = tuple(jcfg.output_transient_flow)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    skw = dict(output_transient=not static_only, output_transient_flow=flow,
               steps_per_epoch=10, batch_size=B, hard_sampling=hard,
               scan_steps=scan_steps)
    jtrain = jstep.make_train_step(j_render_config(jcfg),
                                   jloss.LossConfig(max_t=FRAMES - 1), jtx,
                                   donate=False, **skw)
    ttrain = tstep.make_train_step(
        tconfig.render_config(tcfg), tconfig.loss_config(tcfg), ttx,
        device="cpu", **skw)
    assert not ttrain.use_planar
    return jtx, jtrain, ttx, ttrain


def _args(seed=None):
    table = _table()
    weights = (np.ones(table.shape[:2], np.float32) if seed is None else
               np.random.RandomState(seed).rand(*table.shape[:2])
               .astype(np.float32))
    Ks, Ps = cams()
    return table, weights, Ks, Ps


def _moments_close(tnew, jnew, names, max_rel=GRAD_MAX):
    """Adam's moments of every tree, by `_c2f_grads_close`."""
    tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
    assert set(tmom["mu"]) == names
    for m in ("mu", "nu"):
        _c2f_grads_close(tmom[m], getattr(jnew.opt_state[0], m), max_rel)
    return tmom


def test_static_only_c2f_dispatch_matches_jax_scan_steps():
    """A K=2 dispatch of the static-only model's packed c2f step (no
    transient branch, S_fine = 24, hard sampling) at lr 0 against the JAX
    package's `scan_steps=2` from the same JAX-initialised fine and coarse
    models: each step's four loss terms (the coarse ones inside `col_l`
    and `disp_l`), Adam's moments (a sum of two steps' gradients: 0.2 of a
    leaf's largest entry, as tests/test_torch_c2f_step.py) and the
    hard-sampling buffer where the JAX dispatch wrote it."""
    jtx, jtrain, ttx, multi = _steps(2, True, True, lr=0.0,
                                     lr_scheduler="const")
    ins = _args(3)
    ts = np.array([2, 0], np.int32)
    root = jax.random.PRNGKey(51)
    jp = static_c2f_params(3)
    jstate = jstep.TrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    tmp0 = jnp.zeros(ins[0].shape[:2] + (3,), jnp.float32)
    jnew, jtmp, jm = jtrain(jstate, tmp0, *(jnp.asarray(a) for a in ins),
                            root, jnp.asarray(ts))
    jtmp = np.asarray(jtmp)
    params = to_torch(jp)
    u, rows = [], []
    for k in jax.random.split(root, 2):
        k_sample, k_render = jax.random.split(k)
        u.append(torch.from_numpy(np.asarray(
            jax.random.uniform(k_sample, (B,)))))
        rows.append(c2f_draws(k_render, B, False))
    draws = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    tmp = torch.zeros(ins[0].shape[:2] + (3,))
    new, tmp, m = multi(tstep.TrainState(params, ttx.init(params), 0), tmp,
                        *(torch.from_numpy(a) for a in ins), None,
                        torch.from_numpy(ts).long(), batch_u=torch.stack(u),
                        draws=draws)
    assert new.step == 2 == int(jnew.step)
    assert set(m) == set(jm) and len(m) == 4
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    _moments_close(new, jnew, {"nerf_fine", "nerf_coarse"}, 0.2)
    written = np.abs(jtmp).sum(-1) > 0
    assert np.array_equal(tmp.abs().sum(-1).numpy() > 0, written)
    np.testing.assert_allclose(tmp.numpy()[written], jtmp[written],
                               atol=1e-3, rtol=0)


W, H, NF = 32, 24, 3


def test_eval_cli_packed_c2f_matches_jax(tmp_path, capsys):
    """The test split of both eval CLIs with `--planar_eval off
    --N_importance 8` (S = 8, S_fine = 16, the static tower) at the CLIs'
    default dtype, float32 (the plain evaluators): the same files, the
    frames and the tables."""
    from nsff_pl_tpu.apps import evaluate as jeval
    from nsff_pl_tpu.config import NSFFConfig
    from nsff_pl_tpu.training import checkpoint as jckpt
    from nsff_pl_tpu.training.trainer import build_params
    from nsff_pl_tpu_torch.apps import evaluate as teval

    scene = make_synthetic_scene(str(tmp_path / "scene"), W=W, H=H, N=NF,
                                 learnable=True)
    cfg = NSFFConfig(root_dir=scene, img_wh=(W, H), start_end=(0, NF),
                     N_samples=8, N_importance=8, encode_t=True, N_tau=8)
    params = jax.tree.map(np.asarray, build_params(cfg, jax.random.PRNGKey(5)))
    for model in ("nerf_fine", "nerf_coarse"):
        p = params[model]
        p["static_rgb"] = {k: v * 6.0 for k, v in p["static_rgb"].items()}
    jax_ckpt = jckpt.save_checkpoint(str(tmp_path / "jax_ckpt"), 0,
                                     {"params": params})
    torch_ckpt = tckpt.save_checkpoint(
        str(tmp_path / "torch_ckpt"), 0,
        {"params": tckpt.params_from_jax(params, "cpu")})

    def argv(ckpt):
        return ["--root_dir", scene, "--ckpt_path", ckpt, "--img_wh",
                str(W), str(H), "--start_end", "0", str(NF), "--N_samples",
                "8", "--N_importance", "8", "--encode_t", "--N_tau", "8",
                "--split", "test", "--scene_name", "packed_c2f",
                "--video_format", "gif", "--chunk", "512", "--planar_eval",
                "off"]

    here = os.getcwd()
    dirs = {}
    try:
        for side, run in (("jax", lambda: jeval.main(jeval.get_opts(
                argv(jax_ckpt)))), ("torch", lambda: teval.cli(
                    argv(torch_ckpt), device="cpu"))):
            dirs[side] = tmp_path / side
            dirs[side].mkdir()
            os.chdir(dirs[side])
            run()
    finally:
        os.chdir(here)
    capsys.readouterr()
    jout, tout = (str(dirs[s] / "results" / "monocular" / "packed_c2f")
                  for s in ("jax", "torch"))
    names = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == names
    pngs = [f for f in names if f.endswith(".png")]
    assert len(pngs) == NF
    off = total = 0
    for f in pngs:
        a, b = (np.asarray(Image.open(os.path.join(d, f)), np.int16)
                for d in (jout, tout))
        err = np.abs(a - b)
        assert err.max() <= 1, f
        off += int((err > 0).sum())
        total += err.size
    assert off <= 1e-3 * total, (off, total)
    for table in ("psnr.npy", "ssim.npy"):
        np.testing.assert_allclose(np.load(os.path.join(tout, table)),
                                   np.load(os.path.join(jout, table)),
                                   atol=1e-4, rtol=0)


def test_jax_bf16_bias_gradient_reduces_in_bf16():
    """Why the coarse model's bias gradients part: the JAX package's
    gradient of the bias of a bf16 layer `x @ w + b` is a reduce of the
    bf16 cotangent over the rows in bf16, which XLA's CPU backend
    accumulates in bf16; torch sums it in f32. Over 768 rows of one
    cotangent the JAX sum stands more than 1% (Frobenius) from the exact
    sum of the same bf16 values, torch's within 0.3% (measured 2.1% and
    0.17%)."""
    rng = np.random.RandomState(0)
    g = jnp.asarray(rng.randn(48, 16, 256).astype(np.float32)
                    * 1e-3).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.zeros((48, 16, 256), jnp.bfloat16) + b,
                     jnp.zeros(256, jnp.bfloat16))
    jsum = np.asarray(jax.jit(vjp)(g)[0].astype(jnp.float32), np.float64)
    gt = torch.from_numpy(np.asarray(g.astype(jnp.float32))).bfloat16()
    b = torch.zeros(256, dtype=torch.bfloat16, requires_grad=True)
    (torch.zeros((48, 16, 256), dtype=torch.bfloat16) + b).backward(gt)
    tsum = b.grad.double().numpy()
    exact = np.asarray(g.astype(jnp.float32), np.float64).sum((0, 1))

    def fro(v):
        return np.linalg.norm(v - exact) / np.linalg.norm(exact)

    assert fro(jsum) > 1e-2 and fro(tsum) < 3e-3, (fro(jsum), fro(tsum))
