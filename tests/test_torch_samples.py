"""The port at sample counts that no tile of 128 rows and no warp of 32
lanes divides, against the JAX package on the CPU, and the row rule its
CUDA kernels rely on. Every kernel takes any S >= 1: the tower kernels
run a ray in tiles of 128 rows, the last one partly used (its rows past
S repeat the ray's last sample and get zero cotangent); the compositors
mask the samples past S in their last warp or chunk.

- One whole planar `make_train_step` step at `N_samples 12,
  N_importance 5` (the coarse pass at S = 12, the fine pass at 22), and
  the test-time render `render_test_planar` at 12 + 5 (both towers:
  S = 22; the static tower alone: S = 17), against the JAX planar path
  (its Pallas kernels in interpret mode; on the CPU its planar path takes
  any S). Tracing and compiling each JAX function takes most of this
  file's time (the JAX planar step about 25 s on the CPU), so the planar
  step runs once, at the coarse-to-fine counts, which hold two sample
  counts that no tile or warp divides in one step.
- One packed step (`fused_train='off'`, `train_backend='pallas'`,
  `fused_compositing=True`) at S = 20 against the JAX packed kernels in
  interpret mode.
- The plain versions of the tower kernels (`planar_nerf_train_ref`, its
  backward, the packed evaluator and its backward) on rays padded to
  ceil(S / 128) 128 rows, the last sample repeated and zero cotangents
  past S: sliced back, the same outputs, and the same dW, db and
  per-ray embedding gradients.

Weights are JAX-initialised (`params_from_jax`), inputs seeded numpy, the
draws rebuilt from the JAX key; torch runs on one thread and each JAX
function under one `jax.jit`.

Tolerances, those of the S = 16 tests: the steps as
tests/test_torch_train_step.py, tests/test_torch_c2f_step.py and
tests/test_torch_packed_step.py (loss terms 1e-3 relative, Adam's first
moments 5e-2 in Frobenius norm and 0.1 of each leaf's largest entry);
the renders as tests/test_torch_c2f.py (maps 2e-4 abs, fine depths 1e-5
abs). The padded rows: every row is its own and the padded rows'
cotangents are exact zeros, but the CPU's matrix products block a longer
row count otherwise, so the sums run in another order: outputs within
1e-6 abs (measured 6e-8, one f32 ulp, at S = 130), gradients within
1e-6 of each leaf's largest entry; the per-sample point cotangents past
S exactly zero."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.models import raymarch as jraymarch
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.models import nerf as tn
from nsff_pl_tpu_torch.models import raymarch as traymarch
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.ops import mlp_kernel as tmk
from nsff_pl_tpu_torch.ops import mlp_train_kernel as tmtk
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training import optim as toptim
from nsff_pl_tpu_torch.training import step as tstep
from tests.test_torch_c2f import (K, MAP_TOL, ZS_KEYS, ZS_TOL, _test_inputs,
                                  jax_c2f_draws, jax_c2f_params)
from tests.test_torch_train_step import _table
from tests.torch_train_helpers import (FRAMES, LOSS_RTOL, NTAU, cams,
                                       grads_close, jax_params, to_torch)

B = 24
FLOW = ("fw", "bw")
PAD_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops; the test workers already hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draws_at(key, n, s):
    """The JAX training render's draws at S = s without coarse-to-fine
    (tests/torch_train_helpers.py::jax_draws at another S)."""
    k_perturb, _, _, k_rest = jax.random.split(key, 4)
    _, k_fine = jax.random.split(k_rest)
    ks = jax.random.split(k_fine, 4)
    out = {"u": jax.random.uniform(k_perturb, (n, s))}
    out.update({k: jax.random.normal(kk, (n, s))
                for k, kk in zip(("ns", "nt", "nw1", "nw2"), ks)})
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _one_step(cfg_kw, jparams, key, draws_fn, **render_kw):
    """One `make_train_step` step of both packages from `jparams` on the
    JAX key's batch and draws: loss terms and Adam's moments."""
    jcfg = jconfig.NSFFConfig(**cfg_kw)
    tcfg = tconfig.NSFFConfig(**cfg_kw, **render_kw)
    flow = tuple(jcfg.output_transient_flow)
    jtx = joptim.make_optimizer(jcfg, 10)
    ttx = toptim.make_optimizer(tcfg, 10)
    kw = dict(output_transient=True, output_transient_flow=flow,
              steps_per_epoch=10, batch_size=B)
    jrc = j_render_config(jcfg)
    jrc = dataclasses.replace(
        jrc, **({"fused_compositing": True} if render_kw
                else {"planar_compositing": "on"}))
    jtrain = jstep.make_train_step(jrc, jloss.LossConfig(max_t=FRAMES - 1),
                                   jtx, donate=False, **kw)
    ttrain = tstep.make_train_step(tconfig.render_config(tcfg),
                                   tconfig.loss_config(tcfg), ttx,
                                   device="cpu", **kw)
    assert ttrain.use_planar == (not render_kw)
    table = _table()
    ins = (table, np.ones(table.shape[:2], np.float32), *cams())
    jstate = jstep.TrainState(jparams, jtx.init(jparams),
                              jnp.zeros((), jnp.int32))
    jnew, jm, _ = jtrain(jstate, *(jnp.asarray(a) for a in ins), key,
                         jnp.asarray(1))
    params = to_torch(jparams)
    k_sample, k_render = jax.random.split(key)
    idx = torch.from_numpy(np.asarray(jax.random.randint(
        k_sample, (B,), 0, table.shape[1])))
    tnew, tm, aux = ttrain(tstep.TrainState(params, ttx.init(params), 0),
                           *(torch.from_numpy(a) for a in ins), None, 1,
                           idx=idx, draws=draws_fn(k_render))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    assert aux["rgb_fine"].shape == (B, 3) and tnew.step == 1
    tmom = tckpt.opt_state_to_numpy(tnew.opt_state, tnew.params)
    assert tmom["count"] == 1
    grads_close(tmom["mu"], jnew.opt_state[0].mu)  # 0.1 g after one step
    grads_close(tmom["nu"], jnew.opt_state[0].nu)


def _cfg_kw(s, ni, **extra):
    return dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
                encode_t=True, N_samples=s, N_importance=ni, N_tau=NTAU,
                optimizer="adam", lr=1e-3, lr_scheduler="cosine",
                num_epochs=2, batch_size=B, dtype="bfloat16", **extra)


def test_planar_c2f_train_step_matches_jax_at_12_and_22_samples():
    """One planar step at 12 + 5 (the coarse pass at 12, the fine at
    12 + 2 * 5 = 22: each one tile of 128 rows, partly used; no warp of
    32 divides either): loss terms and Adam's moments of every tree."""
    s, ni = 12, 5
    _one_step(_cfg_kw(s, ni, fused_train="on"), jax_c2f_params(2),
              jax.random.PRNGKey(11),
              lambda k: jax_c2f_draws(k, B, s=s, ni=ni))


def test_packed_kernel_step_matches_jax_at_20_samples():
    """One packed step with the kernel backends (the packed evaluator,
    its backward and the fused compositor's plain versions here) at
    S = 20 against the JAX packed kernels in interpret mode."""
    _one_step(_cfg_kw(20, 0, fused_train="off", train_backend="pallas"),
              jax_params(), jax.random.PRNGKey(21),
              lambda k: draws_at(k, B, 20), fused_compositing=True)


# (N_samples, N_importance, output_transient) of the test renders: the
# fine S is 22 and 17
RENDER_CASES = {"c2f_both": (12, 5, True), "c2f_static": (12, 5, False)}


def _render_cfg(s, ni):
    return dict(N_samples=s, N_importance=ni, use_viewdir=True, encode_t=True,
                N_tau=NTAU, max_t=FRAMES - 1, img_wh=(8, 6),
                compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX test render of each case, under one jax.jit each."""
    jp = jax_c2f_params()
    rays, ts, poses = _test_inputs()
    out = {}
    for case, (s, ni, ot) in RENDER_CASES.items():
        def render(p, r, t, vp, vk, s=s, ni=ni, ot=ot):
            vis = {"vis_poses": vp, "vis_K": vk} if ot else {}
            return jraymarch.render_test_planar(
                p["nerf_fine"], {"t": p["embedding_t"]}, r, t,
                jax.random.PRNGKey(0),
                JRenderConfig(mlp_backend="pallas", **_render_cfg(s, ni)),
                params_coarse=p["nerf_coarse"] if ni else None,
                output_transient=ot, output_transient_flow=FLOW if ot else (),
                keys=tuple(sorted(traymarch.comp_eval_keys(
                    ot, FLOW if ot else ()))), **vis)

        out[case] = jax.jit(render)(
            jp, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(poses),
            jnp.asarray(K))
    return jp, out


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_test_matches_jax_at_samples(jax_renders, case):
    """The composited test render (the serving evaluator's plain version)
    at fine S = 22 (both towers, visibility culling against one camera)
    and 17 (the static tower alone), the coarse pass at 12: every map and
    the fine depths."""
    s, ni, ot = RENDER_CASES[case]
    jp, renders = jax_renders
    want = renders[case]
    pt = to_torch(jp)
    rays, ts, poses = _test_inputs()
    vis = (dict(vis_poses=torch.from_numpy(poses), vis_K=torch.from_numpy(K))
           if ot else {})
    cfg = RenderConfig(planar_eval="on", planar_compositing="on",
                       **_render_cfg(s, ni))
    with torch.inference_mode():
        got = traymarch.render_test_planar(
            pt["nerf_fine"], {"t": pt["embedding_t"]},
            torch.from_numpy(rays), torch.from_numpy(ts).long(), cfg,
            params_coarse=pt["nerf_coarse"] if ni else None,
            output_transient=ot, output_transient_flow=FLOW if ot else (),
            keys=tuple(sorted(traymarch.comp_eval_keys(
                ot, FLOW if ot else ()))), **vis)
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert err.max() <= (ZS_TOL if k in ZS_KEYS else MAP_TOL), \
            (k, err.max())


def _pad_rows(x, s_pad):
    """(N, S, ...) -> (N, s_pad, ...): the rows past S repeat the last."""
    reps = x[:, -1:].expand(x.shape[0], s_pad - x.shape[1], *x.shape[2:])
    return torch.cat([x, reps], 1)


def _pad_zeros(x, s_pad):
    return torch.cat([x, x.new_zeros((x.shape[0], s_pad - x.shape[1],
                                      *x.shape[2:]))], 1)


def _grads_same(got, want):
    for name, p in [(k, p) for k in want["dws"] for p in ("w", "b")]:
        a, b = got["dws"][name][p], want["dws"][name][p]
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= PAD_TOL * scale, (name, p)
    for k in ("ddir", "da", "dt"):
        assert (k in got) == (k in want)
        if k in want:
            scale = max(float(want[k].abs().max()), 1e-12)
            assert float((got[k] - want[k]).abs().max()) <= PAD_TOL * scale


def _model():
    return tn.init_nerf_params(torch.Generator().manual_seed(3), "fine",
                               use_viewdir=True, encode_transient=True,
                               output_flow=True, device="cpu")


@pytest.mark.parametrize("s", [33, 130])
def test_planar_padded_rows_give_the_unpadded_results(s):
    """`planar_nerf_train_ref` and its backward (both branches, the warp
    call with flows in) at S = 33 (one tile, 33 rows used) and 130 (two
    tiles, 2 rows of the second used) against the same rays padded to
    ceil(S / 128) 128 rows as the CUDA tiles run them."""
    n, s_pad = 3, -(-s // 128) * 128
    rng = np.random.RandomState(s)
    o = torch.from_numpy((rng.rand(n, 3) * 2 - 1).astype(np.float32))
    d = torch.from_numpy(((rng.rand(n, 3) - 0.5) * 0.4).astype(np.float32))
    zs = torch.from_numpy(np.sort(rng.rand(n, s), 1).astype(np.float32))
    flows = tuple(torch.from_numpy(0.05 * rng.randn(n, s).astype(np.float32))
                  for _ in range(3))
    de = torch.from_numpy((rng.rand(n, 27) * 2 - 1).astype(np.float32))
    te = torch.from_numpy(rng.randn(n, 48).astype(np.float32))
    params = _model()
    for static_branch, fl in ((True, None), (False, flows)):
        op = trk.make_planar_nerf_train(
            s, static_branch=static_branch, flow_in=fl is not None,
            use_viewdir=True, output_flow=FLOW if static_branch else ("bw",))
        pw, kw = op.pack(params), op.kernel_kw
        args = (pw, o, d, zs, fl, de if static_branch else None, None, te)
        pargs = (pw, o, d, _pad_rows(zs, s_pad),
                 tuple(_pad_rows(f, s_pad) for f in fl) if fl else None,
                 *args[5:])
        want = trk.planar_nerf_train_ref(*args, **kw)
        got = trk.planar_nerf_train_ref(*pargs, **kw)
        assert float((got[:, :, :s] - want).abs().max()) <= PAD_TOL
        cot = {k: torch.from_numpy(rng.randn(n, s).astype(np.float32))
               for k in op.out_keys}
        pcot = {k: _pad_zeros(v, s_pad) for k, v in cot.items()}
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "flow_scale", "D", "skips")}
        for branch in (["static"] if static_branch else []) + ["transient"]:
            want_b = trk.planar_nerf_train_bwd_ref(branch, *args, cot, **bkw)
            got_b = trk.planar_nerf_train_bwd_ref(branch, *pargs, pcot, **bkw)
            _grads_same(got_b, want_b)
            if "dflows" in want_b:
                for c in range(3):
                    assert float((got_b["dflows"][c][:, :s]
                                  - want_b["dflows"][c]).abs().max()) \
                        <= PAD_TOL * float(want_b["dflows"][c].abs().max())
                    assert not got_b["dflows"][c][:, s:].any()


@pytest.mark.parametrize("s", [20, 200])
def test_packed_padded_rows_give_the_unpadded_results(s):
    """The packed evaluator's plain version and its backward (both
    branches, with the xyz cotangent) at S = 20 and 200 against the same
    points padded to ceil(S / 128) 128 rows."""
    n, s_pad = 3, -(-s // 128) * 128
    rng = np.random.RandomState(s)
    xyz = torch.from_numpy((rng.rand(n, s, 3) * 2 - 1).astype(np.float32))
    de = torch.from_numpy((rng.rand(n, 27) * 2 - 1).astype(np.float32))
    te = torch.from_numpy(rng.randn(n, 48).astype(np.float32))
    op = tmtk.make_fused_nerf_train(s, use_viewdir=True, encode_a=False,
                                    encode_t=True, output_flow=FLOW)
    pw, kw = op.pack(_model()), op.kernel_kw
    want = tmk.fused_nerf_eval_ref(pw, xyz, de, None, te, **kw)
    got = tmk.fused_nerf_eval_ref(pw, _pad_rows(xyz, s_pad), de, None, te,
                                  **kw)
    assert float((got[:, :s] - want).abs().max()) <= PAD_TOL
    g = torch.from_numpy(rng.randn(n, s, 16).astype(np.float32))
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "output_flow", "flow_scale", "D", "skips")}
    for branch in ("static", "transient"):
        want_b = tmtk.fused_nerf_train_bwd_ref(branch, pw, xyz, de, None, te,
                                               g, need_dxyz=True, **bkw)
        got_b = tmtk.fused_nerf_train_bwd_ref(
            branch, pw, _pad_rows(xyz, s_pad), de, None, te,
            _pad_zeros(g, s_pad), need_dxyz=True, **bkw)
        _grads_same(got_b, want_b)
        assert float((got_b["dxyz"][:, :s] - want_b["dxyz"]).abs().max()) \
            <= PAD_TOL * float(want_b["dxyz"].abs().max())
        assert not got_b["dxyz"][:, s:].any()


def test_one_sample_ray_takes_the_far_deltas():
    """At S = 1 the ray's only sample is its last and takes the far deltas
    (100 static, 1e-3 transient), as the JAX package's compositing kernels
    give it (`_deltas`: the far delta where the column is S - 1) and as the
    port's kernels and plain versions do: the port's two compositors at
    S = 1 against the JAX package's (Pallas, interpret mode), with the
    S = 16 tests' tolerances (tests/test_torch_compositing_kernel.py 2e-6,
    tests/test_torch_compositor.py 1e-5). The JAX package's plain
    `deltas_from_zs` sizes its far column by the differences, of which S =
    1 has none, so there it returns no delta at all: the one place where
    the port's plain composite parts from the JAX package's."""
    from nsff_pl_tpu.ops import compositing as jcomp
    from nsff_pl_tpu.ops import compositing_kernel as jfck
    from nsff_pl_tpu.ops import compositing_planar_kernel as jpck
    from nsff_pl_tpu_torch.ops import compositing as tcomp
    from nsff_pl_tpu_torch.ops import compositing_kernel as tfck
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tpck

    rng = np.random.RandomState(1)
    n = 9
    zs = rng.rand(n, 1).astype(np.float32)
    assert np.asarray(jcomp.deltas_from_zs(jnp.asarray(zs))[0]).shape == \
        (n, 0)
    d_s, d_t = tcomp.deltas_from_zs(torch.from_numpy(zs))
    assert d_s.tolist() == [[100.0]] * n
    assert np.allclose(d_t.numpy(), 1e-3)

    packed = (rng.randn(n, 1, 16) * 2).astype(np.float32)
    packed[..., 0:3] = rng.rand(n, 1, 3)
    packed[..., 4:7] = rng.rand(n, 1, 3)
    ns, nt = (rng.randn(n, 1).astype(np.float32) for _ in range(2))
    jout = jfck.make_fused_compositing(1, block_rays=8)(
        *(jnp.asarray(a) for a in (packed, zs, ns, nt)))
    tout = tfck.make_fused_compositing(1)(
        *(torch.from_numpy(a) for a in (packed, zs, ns, nt)))
    assert float(tout["weights"].abs().max()) > 0
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=2e-6, rtol=0, err_msg=k)

    ins = {"zs": zs}
    for k in tpck.IN_KEYS[1:9]:
        ins[k] = (rng.randn(n, 1) * 2).astype(np.float32)
    for k in tpck.IN_KEYS[9:]:
        ins[k] = rng.rand(n, 1).astype(np.float32)
    jout = jpck.make_planar_compositor(1)(
        {k: jnp.asarray(v) for k, v in ins.items()})
    tout = tpck.make_planar_compositor(1)(
        {k: torch.from_numpy(v) for k, v in ins.items()})
    assert float(tout["weights"].abs().max()) > 0
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
