"""The port's composited evaluator (`nsff_pl_tpu_torch/ops/raymarch_kernel.py`)
against the JAX package's `make_planar_nerf_eval_comp`, which runs here in
Pallas interpret mode as `tests/test_planar_comp_eval.py` runs it.

Same weights (JAX initializer, carried over by `params_from_jax`), same
numpy inputs, S=16 samples. Tolerance 1e-5 abs: both sides round at the
same points (bf16 matmul inputs, f32 accumulation, bf16 activations), so
what differs is f32 summation order and, rarely, a bf16 tie flipped by
it (measured <= 3e-6). Random-init outputs vary little from ray to ray,
so the bound is tight on purpose: dropping the bf16 rounding of the
matmul inputs moves the maps by ~4e-5 here.

The CUDA kernel itself runs only on the card: see tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.ops import mlp_kernel as jmlp
from nsff_pl_tpu.ops import mlp_train_kernel as jtrain
from nsff_pl_tpu.ops import raymarch_kernel as jrk
from nsff_pl_tpu_torch.ops import launches
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax

S = 16
N_TAU = 16
N_A = 8
TOL = 1e-5


def _params(encode_a=False):
    return jn.init_nerf_params(
        jax.random.PRNGKey(1), "fine", use_viewdir=True,
        encode_transient=True, in_channels_t=N_TAU, output_flow=True,
        encode_appearance=encode_a, in_channels_a=N_A)


def _inputs(n=6, seed=0):
    rng = np.random.RandomState(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 0:2] = rng.rand(n, 2) * 2 - 1
    o[:, 2] = -1.0
    d = np.zeros((n, 3), np.float32)
    d[:, 0:2] = (rng.rand(n, 2) - 0.5) * 0.4
    d[:, 2] = 2.0
    zs = np.sort(rng.rand(n, S), 1).astype(np.float32)
    vis = (rng.rand(n, S) > 0.3).astype(np.float32)
    dirs = rng.uniform(-1, 1, (n, 27)).astype(np.float32)
    a = rng.randn(n, N_A).astype(np.float32)
    t = rng.randn(n, N_TAU).astype(np.float32)
    return o, d, zs, vis, dirs, a, t


CASES = {
    # name: (encode_t, output_flow, vis_in, encode_a)
    "transient_flow_vis": (True, ("fw", "bw"), True, False),
    "validation_keys": (True, (), False, False),
    "static_only": (False, (), False, False),
    "vis_culling": (True, (), True, False),
    "appearance": (True, ("fw", "bw"), False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    encode_t, flow, vis_in, encode_a = CASES[case]
    params = _params(encode_a)
    o, d, zs, vis, dirs, a, t = _inputs()
    kw = dict(use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
              output_flow=flow, vis_in=vis_in, n_tau=N_TAU, n_a=N_A)
    J = jnp.asarray
    want = np.asarray(jrk.make_planar_nerf_eval_comp(S, **kw)(
        params, J(o), J(d), J(zs), J(vis) if vis_in else None, J(dirs),
        J(a) if encode_a else None, J(t) if encode_t else None))
    T = torch.from_numpy
    fn = trk.make_planar_nerf_eval_comp(S, **kw)
    got = fn(params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
             T(o), T(d), T(zs), T(vis) if vis_in else None, T(dirs),
             T(a) if encode_a else None, T(t) if encode_t else None)
    assert fn.n_map == want.shape[1] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if vis_in:  # the culling must change the result
        no_vis = trk.make_planar_nerf_eval_comp(S, **{**kw, "vis_in": False})(
            params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
            T(o), T(d), T(zs), None, T(dirs), None, T(t))
        assert not np.allclose(no_vis.numpy(), got.numpy())


@pytest.mark.parametrize("encode_t,flow", [(True, True), (True, False),
                                           (False, False)])
def test_comp_map_cols_match_jax(encode_t, flow):
    assert (trk.comp_map_cols(encode_t=encode_t, flow=flow)
            == jrk.comp_map_cols(encode_t=encode_t, flow=flow))


@pytest.mark.parametrize("encode_a,flow", [(False, ("fw", "bw")),
                                           (True, ())])
def test_pack_padded_weights_match_jax(encode_a, flow):
    params = _params(encode_a)
    kw = dict(D=8, skips=(4,), use_viewdir=True, static_branch=True,
              encode_t=True)
    js, jt = jtrain.branch_weight_names(**kw)
    ts_, tt = trk.branch_weight_names(**kw)
    assert (js, jt) == (ts_, tt)
    names = js + jt
    pack = dict(output_flow=flow, skips=(4,), xyz_w=63, n_tau=N_TAU,
                dir_w=27, n_a=N_A, encode_a=encode_a)
    want = jtrain.pack_padded_weights(params, names, encode_t=True, **pack)
    got = trk.pack_padded_weights(
        params_from_jax(jax.tree.map(np.asarray, params), "cpu"), names,
        **pack)
    for name in names:
        assert got[name]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[name]["w"].float().numpy(),
            np.asarray(want[name]["w"].astype(jnp.float32)), err_msg=name)
        np.testing.assert_array_equal(got[name]["b"].numpy(),
                                      np.asarray(want[name]["b"][0]))


def test_sin_poly_and_posenc_tables_match_jax():
    x = np.linspace(-1100, 1100, 20001).astype(np.float32)
    np.testing.assert_allclose(
        trk._sin_poly(torch.from_numpy(x)).numpy(),
        np.asarray(jmlp._sin_poly(jnp.asarray(x))), atol=1e-6)
    assert np.abs(trk._sin_poly(torch.from_numpy(x)).numpy()
                  - np.sin(x.astype(np.float64))).max() < 1e-4
    freqs = tuple(float(f) for f in 2.0 ** np.linspace(0, 9, 10))
    sel, is_id, phase, valid = jmlp._posenc_tables(freqs, 128)
    chan, freq, t_id, t_phase, t_valid = trk._posenc_tables(freqs, 128)
    sel_t = np.zeros_like(sel)
    sel_t[chan, np.arange(128)] = freq
    np.testing.assert_array_equal(sel_t * valid, sel)
    np.testing.assert_array_equal(t_id, is_id[0])
    np.testing.assert_array_equal(t_phase, phase[0])
    np.testing.assert_array_equal(t_valid, valid[0])


def test_posenc_adjoint_cosine_lanes_match_jax():
    """`_posenc_adjoint` against the JAX kernels' adjoint formula
    (`dxs = dpe * _sin_poly(xs + phase + pi/2)` on sine lanes, then the
    product with the selector) over xs up to +-1100 on every sine lane of
    the 10-frequency table. Each row carries one lane's cotangent, scaled
    by 1 / freq, so the selector product adds exact zeros and the result
    is ~1: what differs is a rounding of the same f32 operations (<= 2e-7),
    while a true cosine in place of the polynomial moves it by up to
    ~1e-4."""
    freqs = tuple(float(f) for f in 2.0 ** np.linspace(0, 9, 10))
    rng = np.random.default_rng(11)
    lanes = np.arange(3, 63)
    n = 40 * len(lanes)
    xs = rng.uniform(-1100, 1100, (n, 128)).astype(np.float32)
    lane = lanes[np.arange(n) % len(lanes)]
    freq = np.asarray(freqs, np.float32)[(lane - 3) // 6]
    dinp = np.zeros((n, 128), np.float32)
    dinp[np.arange(n), lane] = (rng.uniform(0.5, 1.0, n) * rng.choice(
        [-1.0, 1.0], n) / freq).astype(np.float32)
    sel, is_id, phase, valid = jmlp._posenc_tables(freqs, 128)
    dpe = jnp.asarray(dinp) * valid
    dxs = jnp.where(is_id > 0, dpe,
                    dpe * jmlp._sin_poly(jnp.asarray(xs) + phase
                                         + 1.5707963267948966))
    want = np.asarray(jnp.dot(dxs, jnp.asarray(sel).T,
                              preferred_element_type=jnp.float32))
    got = trk._posenc_adjoint(torch.from_numpy(dinp), torch.from_numpy(xs),
                              freqs).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    params = params_from_jax(jax.tree.map(np.asarray, _params()), "cpu")
    o, d, zs, _, dirs, _, t = _inputs(n=3)
    T = torch.from_numpy
    before = launches.counts()
    fn = trk.make_planar_nerf_eval_comp(S, use_viewdir=True, n_tau=N_TAU)
    out = fn(params, T(o), T(d), T(zs), None, T(dirs), None, T(t))
    assert launches.counts() == before
    ref = trk.planar_eval_comp_ref(fn.pack(params), T(o), T(d), T(zs), None,
                                   T(dirs), None, T(t), **fn.kernel_kw)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="vis_in"):
        fn(params, T(o), T(d), T(zs), T(zs), T(dirs), None, T(t))


def test_slot_ptrs_check_the_tensor_map_inputs():
    """The weights behind the evaluators' TMA tensor maps: (K_pad, 256)
    bf16, contiguous, 16-byte aligned; a view that starts one element in,
    a transposed copy or a wrong width raises before any launch."""
    params = params_from_jax(jax.tree.map(np.asarray, _params()), "cpu")
    fn = trk.make_planar_nerf_eval_comp(S, use_viewdir=True, n_tau=N_TAU)
    pw = fn.pack(params)
    names = [k for k in trk._SLOTS if k in pw]
    wp, _ = trk._slot_ptrs(pw, names, torch.device("cpu"), 4, False)
    assert all(wp[i] % 16 == 0 for i, k in enumerate(trk._SLOTS) if k in pw)
    w = pw["static_xyz_1"]["w"]
    bad = {"misaligned": torch.cat([w.new_zeros(1), w.flatten()])[1:].view(
               w.shape),
           "transposed": w.t(),
           "narrow": w[:, :128].contiguous()}
    for what, wb in bad.items():
        pw_bad = {**pw, "static_xyz_1": {**pw["static_xyz_1"], "w": wb}}
        with pytest.raises(ValueError, match="static_xyz_1"):
            trk._slot_ptrs(pw_bad, names, torch.device("cpu"), 4, False)
