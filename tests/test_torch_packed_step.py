"""The port's packed-boundary training path against the JAX package on
the CPU: `compute_losses` term by term on the same result dict, whole
`make_train_step` calls with `fused_train='off'` (render_rays +
compute_losses; the JAX side runs its Pallas kernels in interpret mode
with `train_backend='pallas'`) for the flagship flags and for the
static-only model, and the port's packed path against its own planar path
on the same draws.

Tolerances. `compute_losses` on identical inputs: 2e-6 relative on every
term and 2e-6 of the largest magnitude on every gradient (the same f32
formulas; measured 2.4e-7, and under 1e-6). The steps: those of
tests/test_torch_train_step.py, for its reasons (loss terms 1e-3 relative,
Adam's moments 5e-2 in Frobenius norm and 0.1 of each leaf's largest
entry, the update held to Adam's formula on the port's own moments;
measured on this path: loss terms at most 4.9e-6, moments at most 1.3e-2
of the largest entry on the flagship model, 4.3e-2 on the static-only
one, whose key KEY0 explains). Packed against planar:
the bounds `tests/test_planar_path.py` holds the JAX package's two paths
to (loss terms 2e-2 relative + 2e-4, rgb 6e-3, gradients 0.3 of the
leaf's largest): the planar kernel forms the posenc argument as
o*f + (d*f)*z and the packed one as (o + d*z)*f, which differ in the last
bits before the sine, and the planar compositor sums optical depths where
the packed one multiplies 1 - alpha."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.models.raymarch import render_train_planar
from nsff_pl_tpu_torch.models.rendering import RenderConfig, render_rays
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests import torch_static_step_scan as scan
from tests.test_torch_train_step import _step_inputs, _table
from tests.torch_train_helpers import (COMMON, FRAMES, LOSS_RTOL, N, NTAU, S,
                                       UPD_TOL, cams, grads_close, jax_draws,
                                       jax_params, make_batch, make_rays,
                                       to_torch)

FLOW = ("fw", "bw", "disocc")
TERM_TOL = 2e-6
# first step's key of each three-step case. The static-only model has the
# color and depth terms only, and its 384 samples carry the whole gradient,
# so on most keys one of two events moves a leaf's largest moment entry
# past the bound (tests/torch_static_step_scan.py shows both, sample by
# sample; measured over keys 21..101, three steps each: 0.04 to 0.26, once
# 0.75 to 1.07): a bf16 rounding that differs between the sides turns the
# sign of a pre-activation next to zero, and that unit's ReLU mask with it
# (test_static_only_difference_is_relu_mask_toggles), or two depths at the
# batch median lie within an ulp and the median's cotangent goes to another
# ray (test_depth_cotangent_jumps_at_a_median_tie). Key 51 has neither on
# any of its three steps (measured 0.043)
KEY0 = {"flagship": 21, "fused_compositing": 21, "static_only": 51}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps are thousands of small ops; with the test workers'
    threads already on every core, torch's own pool only waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _results(rng, static_only):
    """A synthetic train-mode result dict with the renderer's shapes."""
    rays = make_rays(rng, N)
    zs = np.sort(rng.rand(N, S), 1).astype(np.float32) * 0.9
    xyzs = rays[:, None, :3] + rays[:, None, 3:] * zs[..., None]
    res = {"rgb_fine": rng.rand(N, 3), "depth_fine": rng.rand(N)}
    if not static_only:
        jit = lambda *s: 0.02 * rng.randn(*s)  # noqa: E731
        res.update(
            transient_weights_fine=rng.rand(N, S) / S,
            static_weights_fine=rng.rand(N, S) / S,
            xyzs_fine=xyzs, xyzs_fw=xyzs + jit(N, S, 3),
            xyzs_bw=xyzs + jit(N, S, 3), xyzs_fw_bw=xyzs + jit(N, S, 3),
            xyzs_bw_fw=xyzs + jit(N, S, 3),
            xyz_fw=xyzs[:, S // 2] + jit(N, 3),
            xyz_bw=xyzs[:, S // 2] + jit(N, 3),
            rgb_fw=rng.rand(N, 3), rgb_bw=rng.rand(N, 3),
            disocc_fw=rng.rand(N, 1), disocc_bw=rng.rand(N, 1),
            disoccs_fw=rng.rand(N, S, 1), disoccs_bw=rng.rand(N, S, 1))
    return {k: v.astype(np.float32) for k, v in res.items()}


@pytest.mark.parametrize("case", ["flagship", "late_epoch_topk", "weighted",
                                  "static_only"])
def test_compute_losses_match_jax(case):
    """Every term and its gradient with respect to every result, on the
    same synthetic result dict."""
    static_only = case == "static_only"
    flow = () if static_only else FLOW
    lkw, epoch = dict(max_t=FRAMES - 1), 2
    if case == "late_epoch_topk":
        lkw.update(thickness=3, topk=0.5)
        epoch = 11
    rng = np.random.RandomState(3)
    res = _results(rng, static_only)
    b = make_batch()
    w = rng.rand(N).astype(np.float32) if case == "weighted" else None
    Ks, Ps = cams()

    def jf(r):
        return jloss.compute_losses(
            r, {k: jnp.asarray(v) for k, v in b.items()},
            jloss.LossConfig(**lkw), epoch=epoch, output_transient_flow=flow,
            Ks=jnp.asarray(Ks), Ps=jnp.asarray(Ps),
            weights=None if w is None else jnp.asarray(w))

    jout, vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in res.items()})
    (jg,) = vjp({k: jnp.ones(()) for k in jout})

    tres = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in res.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"], tb["cam_ids"] = tb["ts"].long(), tb["cam_ids"].long()
    out = tloss.compute_losses(
        tres, tb, tloss.LossConfig(**lkw), epoch=epoch,
        output_transient_flow=flow, Ks=torch.from_numpy(Ks),
        Ps=torch.from_numpy(Ps),
        weights=None if w is None else torch.from_numpy(w))
    assert set(out) == set(jout)
    assert len(out) == (2 if static_only else 11)
    tloss.total_loss(out).backward()
    for k in jout:
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=TERM_TOL, atol=1e-10, err_msg=k)
    for k, want in jg.items():
        want = np.asarray(want)
        got = (tres[k].grad.numpy() if tres[k].grad is not None
               else np.zeros_like(want))
        assert np.abs(got - want).max() <= TERM_TOL * max(
            np.abs(want).max(), 1e-12), k


def _static_jax_params():
    return {"nerf_fine": jn.init_nerf_params(
        jax.random.PRNGKey(0), "fine", use_viewdir=True,
        encode_transient=False)}


@pytest.mark.parametrize("case", ["flagship", "fused_compositing",
                                  "static_only"])
def test_three_packed_train_steps_match_jax(case):
    """Three whole steps with `fused_train='off'`: the first from the
    initial state on both sides, each later one from the JAX state after
    the one before, carried over with params_from_jax /
    opt_state_from_jax. Loss terms, Adam's moments and the update."""
    B = 24
    static_only = case == "static_only"
    cfg_kw = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
                  encode_t=not static_only, N_samples=S, N_tau=NTAU,
                  optimizer="adam", lr=1e-3, lr_scheduler="cosine",
                  num_epochs=2, batch_size=B, dtype="bfloat16",
                  fused_train="off", train_backend="pallas")
    fused = case == "fused_compositing"
    jcfg = jconfig.NSFFConfig(**cfg_kw)
    tcfg = tconfig.NSFFConfig(fused_compositing=fused, **cfg_kw)
    flow = tuple(jcfg.output_transient_flow)
    assert flow == (() if static_only else FLOW)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    kw = dict(output_transient=not static_only, output_transient_flow=flow,
              steps_per_epoch=10, batch_size=B)
    jtrain = jstep.make_train_step(
        dataclasses.replace(j_render_config(jcfg), fused_compositing=fused),
        jloss.LossConfig(max_t=FRAMES - 1), jtx, donate=False, **kw)
    ttrain = tstep.make_train_step(
        tconfig.render_config(tcfg), tconfig.loss_config(tcfg), ttx,
        device="cpu", **kw)
    assert not ttrain.use_planar
    table = _table()
    weights = np.ones(table.shape[:2], np.float32)
    Ks, Ps = cams()
    jargs = tuple(jnp.asarray(a) for a in (table, weights, Ks, Ps))
    targs = tuple(torch.from_numpy(a) for a in (table, weights, Ks, Ps))

    jparams = _static_jax_params() if static_only else jax_params()
    jstate = jstep.TrainState(jparams, jtx.init(jparams),
                              jnp.zeros((), jnp.int32))
    for i in range(3):
        key = jax.random.PRNGKey(KEY0[case] + i)
        params = to_torch(jstate.params)
        opt = ttx.init(params)
        if i > 0:  # start the port from the JAX state after the last step
            tckpt.opt_state_from_jax(
                jax.tree.map(np.asarray, jstate.opt_state), opt, params)
        tstate = tstep.TrainState(params, opt, int(jstate.step))
        before = jax.tree.map(np.asarray, jstate.params)
        jnew, jm, _ = jtrain(jstate, *jargs, key, jnp.asarray(1 + i))
        idx, draws = _step_inputs(key, table, B)
        tnew, tm, aux = ttrain(tstate, *targs, None, 1 + i, idx=idx,
                               draws=draws)
        assert set(tm) == set(jm)
        assert len(tm) == (4 if static_only else 13)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, atol=1e-9,
                                       err_msg=f"step {i + 1}: {k}")
        assert tnew.step == int(jnew.step) == i + 1
        tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
        jadam = jnew.opt_state[0]
        grads_close(tmom["mu"], jadam.mu)
        grads_close(tmom["nu"], jadam.nu)
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


def test_static_only_difference_is_relu_mask_toggles():
    """On a key where the static-only step's gradients part by more than
    the three-step test's bound (key 31: 0.26 of a leaf's largest entry),
    the port's backward and the JAX kernel's, given the port's own points,
    directions and cotangent, differ in a few samples only; all but at
    most two of those have one tower unit with a pre-activation under 1e-3
    whose mask toggle makes the sample's point cotangent agree, and with
    those toggles every gradient agrees to 2e-2 of its leaf's largest
    entry and 5e-3 in Frobenius norm (measured: 7 samples of 384, all
    seven explained, then 3.8e-3 and 2.1e-3)."""
    jp = scan.static_jax_params()
    _, _, cap = scan.port_side(jp, jax.random.PRNGKey(31), 1)
    a = scan.toggle_analysis(jp, cap["xyz"], cap["dir"], cap["g"])
    assert len(a["rows"]) <= scan.B * S // 20, a
    unexplained = [r for r in a["rows"] if r[2] is None]
    assert len(unexplained) <= 2, a
    assert sorted(a["left"]) == sorted(r[0] for r in unexplained), a
    assert a["after"][0] <= 2e-2 and a["after"][2] <= 5e-3, a


def test_depth_cotangent_jumps_at_a_median_tie():
    """The depth term on the same depths gives the same cotangent in both
    packages (1e-5 of the largest entry); one ulp on a depth that ties
    with the batch median moves the median's share to another ray, by more
    than a tenth of the largest entry, in both packages alike."""
    rng = np.random.RandomState(4)
    n = 24
    depth = np.sort(rng.rand(n).astype(np.float32))
    disp = rng.rand(n).astype(np.float32)
    hi = n // 2  # the upper of the two middle depths, and its neighbour
    depth[hi + 1] = depth[hi]
    bumped = depth.copy()
    bumped[hi] = np.nextafter(depth[hi], np.float32(2))

    def port(d):
        d = torch.from_numpy(d.copy()).requires_grad_(True)
        tloss.shiftscale_invariant_depthloss(
            d, torch.from_numpy(disp)).mean().backward()
        return d.grad.numpy()

    jgrad = jax.grad(lambda d: jloss.shiftscale_invariant_depthloss(
        d, jnp.asarray(disp)).mean())
    for d in (depth, bumped):
        want = np.asarray(jgrad(jnp.asarray(d)))
        assert np.abs(port(d) - want).max() <= 1e-5 * np.abs(want).max()
    jump = np.abs(port(bumped) - port(depth))
    assert set(np.nonzero(jump > 1e-3 * jump.max())[0]) == {hi, hi + 1}
    assert jump.max() > 0.1 * np.abs(port(depth)).max()


def test_packed_and_planar_paths_of_the_port_agree():
    """The same weights, batch and draws through render_rays +
    compute_losses and through render_train_planar +
    compute_losses_planar."""
    b = make_batch()
    Ks, Ps = (torch.from_numpy(a) for a in cams())
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"], tb["cam_ids"] = tb["ts"].long(), tb["cam_ids"].long()
    draws = jax_draws(jax.random.PRNGKey(5), N)
    lcfg = tloss.LossConfig(max_t=FRAMES - 1)
    packed_cfg = RenderConfig(**{**COMMON, "fused_train": "off",
                                 "train_backend": "pallas"})
    out = {}
    for path in ("packed", "planar"):
        params = to_torch(jax_params())
        for leaf in toptim.param_leaves(params):
            leaf.requires_grad_(True)
        emb = {"t": params["embedding_t"]}
        if path == "packed":
            res = render_rays({"fine": params["nerf_fine"]}, emb, tb["rays"],
                              tb["ts"], packed_cfg, test_time=False,
                              output_transient_flow=FLOW, draws=draws)
            ld = tloss.compute_losses(res, tb, lcfg, epoch=2,
                                      output_transient_flow=FLOW, Ks=Ks,
                                      Ps=Ps)
        else:
            res = render_train_planar(params["nerf_fine"], emb, tb["rays"],
                                      tb["ts"], RenderConfig(**COMMON),
                                      draws=draws)
            ld = tloss.compute_losses_planar(res, tb, lcfg, epoch=2, Ks=Ks,
                                             Ps=Ps)
        tloss.total_loss(ld).backward()
        out[path] = ({k: float(v) for k, v in ld.items()},
                     res["rgb_fine"].detach().numpy(),
                     [(leaf.grad if leaf.grad is not None
                       else torch.zeros_like(leaf)).numpy()
                      for leaf in toptim.param_leaves(params)])
    (ld1, rgb1, g1), (ld2, rgb2, g2) = out["packed"], out["planar"]
    assert set(ld1) == set(ld2)
    for k in ld1:
        np.testing.assert_allclose(ld1[k], ld2[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(rgb1, rgb2, atol=6e-3)
    for a, c in zip(g1, g2):
        assert np.abs(a - c).max() <= 0.3 * max(np.abs(a).max(), 1e-4)


def test_checkpoint_bridges_cover_static_only_and_appearance():
    """params_from_jax / params_to_numpy / opt_state_from_jax on a model
    without transient branch and on one with `embedding_a`."""
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    trees = {
        "static_only": _static_jax_params(),
        "appearance": {
            "nerf_fine": jn.init_nerf_params(
                ks[0], "fine", use_viewdir=True, encode_appearance=True,
                in_channels_a=8, encode_transient=True, in_channels_t=NTAU,
                output_flow=True),
            "embedding_a": jn.init_embedding(ks[1], FRAMES, 8),
            "embedding_t": jn.init_embedding(ks[2], FRAMES, NTAU)}}
    for name, jp in trees.items():
        np_tree = jax.tree.map(np.asarray, jp)
        tp = tckpt.params_from_jax(np_tree, "cpu")
        back = tckpt.params_to_numpy(tp)
        assert jax.tree.structure(back) == jax.tree.structure(np_tree), name
        for a, c in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
            np.testing.assert_array_equal(a, c)
        cfg = tconfig.NSFFConfig(
            use_viewdir=True, encode_a=name == "appearance", N_a=8,
            encode_t=name == "appearance", N_tau=NTAU,
            start_end=(0, FRAMES))
        built = tconfig.build_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        assert jax.tree.structure(tckpt.params_to_numpy(built)) == \
            jax.tree.structure(np_tree), name
        tx = toptim.make_optimizer(cfg, 10)
        opt = tx.init(tp)
        jopt = joptim.make_optimizer(jconfig.NSFFConfig(), 10).init(jp)
        tckpt.opt_state_from_jax(jax.tree.map(np.asarray, jopt), opt, tp)
        mom = tckpt.opt_state_to_numpy(opt, tp)
        assert mom["count"] == 0
        assert jax.tree.structure(mom["mu"]) == jax.tree.structure(np_tree)
