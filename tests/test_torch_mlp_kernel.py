"""The port's packed evaluator (`nsff_pl_tpu_torch/ops/mlp_kernel.py`)
against the JAX package's `make_fused_nerf_eval`, whose Pallas kernel runs
here in interpret mode as `tests/test_mlp_kernel.py` runs it.

Same weights (JAX initializer, carried over by `params_from_jax`), same
numpy points and embeddings, S=16, N_tau=16, full-width towers. The points
are dyadic (multiples of 2^-6), so x * f is exact in f32 whatever the
compiler fuses. Tolerance: every entry within 1e-4 abs and at most a
tenth of the rows off by more than 1e-6: both sides round at the same
points, but the f32 sums run in another order, which now and then flips
the bf16 rounding of one activation, and a per-sample row shows that flip
whole (measured: at most 3.9e-5, in at most 5% of the rows). Dropping a
rounding point moves every row, which the second bound catches.

The CUDA kernel runs only on the card: see tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.ops import mlp_kernel as jmk
from nsff_pl_tpu_torch.ops import mlp_kernel as tmk
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax

S = 16
N_TAU = 16
N_A = 8
FWD_TOL = 1e-4
FWD_EXACT, FWD_EXACT_SHARE = 1e-6, 0.1

# name: (n_rays, static_branch, encode_t, output_flow, encode_a)
CASES = {
    "full": (8, True, True, ("fw", "bw"), False),
    "full_appearance_odd": (5, True, True, ("fw", "bw"), True),
    "static_only": (8, True, False, (), False),
    "static_only_odd": (3, True, False, (), False),
    "no_flow": (8, True, True, (), False),
    "transient_only": (8, False, True, (), False),
    "transient_only_fw": (8, False, True, ("fw",), False),
    "transient_only_bw_odd": (7, False, True, ("bw",), False),
    "transient_only_both": (8, False, True, ("fw", "bw"), False),
}


def jax_params(encode_a=False, flow=True):
    return jn.init_nerf_params(
        jax.random.PRNGKey(1), "fine", use_viewdir=True,
        encode_transient=True, in_channels_t=N_TAU, output_flow=flow,
        encode_appearance=encode_a, in_channels_a=N_A)


def inputs(n, seed=0):
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(-64, 65, (n, S, 3)) / 64.0).astype(np.float32)
    dirs = (rng.rand(n, 27) * 2 - 1).astype(np.float32)
    a = rng.randn(n, N_A).astype(np.float32)
    t = rng.randn(n, N_TAU).astype(np.float32)
    return xyz, dirs, a, t


def check_packed(got, want):
    err = np.abs(got - want)
    assert err.max() <= FWD_TOL, err.max()
    assert (err.max(-1) > FWD_EXACT).mean() <= FWD_EXACT_SHARE


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_eval_matches_jax(case):
    n, static_branch, encode_t, flow, encode_a = CASES[case]
    jp = jax_params(encode_a)
    xyz, dirs, a, t = inputs(n)
    kw = dict(use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
              output_flow=flow, n_tau=N_TAU, n_a=N_A,
              static_branch=static_branch)
    jfn = jmk.make_fused_nerf_eval(S, block_rows=8 * S, **kw)
    want = np.asarray(jfn(
        jp, jnp.asarray(xyz),
        dir_emb=jnp.asarray(dirs) if static_branch else None,
        a_emb=jnp.asarray(a) if encode_a else None,
        t_emb=jnp.asarray(t) if encode_t else None))
    tfn = tmk.make_fused_nerf_eval(S, **kw)
    got = tfn(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
              torch.from_numpy(xyz), torch.from_numpy(dirs),
              torch.from_numpy(a), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (n, S, 16)
    check_packed(got, want)
    if not static_branch:
        assert not got[..., 0:4].any()
    if not encode_t:
        assert not got[..., 4:].any()
    assert not got[..., 8 + 3 * len(flow):].any()
    un = tmk.unpack_fused(torch.from_numpy(got), encode_t=encode_t,
                          output_flow=flow)
    jun = jmk.unpack_fused(jnp.asarray(want), encode_t=encode_t,
                           output_flow=flow)
    assert set(un) == set(jun)
    for k in un:
        assert un[k].shape == jun[k].shape


def test_model_without_flow_heads():
    """A transient model without flow heads: the 10-wide heads matrix gets
    zero columns, the sigma and rgb columns are the JAX kernel's."""
    jp = jax_params(flow=False)
    assert "transient_flow_fw" not in jp
    xyz, dirs, a, t = inputs(4)
    kw = dict(use_viewdir=True, encode_a=False, encode_t=True,
              output_flow=(), n_tau=N_TAU)
    want = np.asarray(jmk.make_fused_nerf_eval(S, block_rows=8 * S, **kw)(
        jp, jnp.asarray(xyz), dir_emb=jnp.asarray(dirs),
        t_emb=jnp.asarray(t)))
    got = tmk.make_fused_nerf_eval(S, **kw)(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
        torch.from_numpy(xyz), torch.from_numpy(dirs), None,
        torch.from_numpy(t)).numpy()
    check_packed(got, want)


def test_wrapper_checks():
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params()), "cpu")
    xyz, dirs, a, t = (torch.from_numpy(v) for v in inputs(2))
    fn = tmk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                  encode_t=True, output_flow=(), n_tau=N_TAU)
    with pytest.raises(ValueError, match="samples"):
        fn(tp, xyz[:, :8], dirs, None, t)
    with pytest.raises(ValueError, match="n_tau"):
        fn(tp, xyz, dirs, None, t[:, :8])
    # the CUDA wrapper's checks run before anything touches the card: S =
    # 16 passes the sample check (any S >= 1), the shapes are read
    assert tmk.packed_checks(xyz, dirs, None, t, freqs=fn.kernel_kw["freqs"],
                             use_viewdir=True, encode_a=False,
                             encode_t=True) == (2, dirs.shape[1], 0,
                                                t.shape[1])
    with pytest.raises(ValueError, match="neither branch"):
        tmk.fused_nerf_eval_cuda(fn.pack(tp), xyz, None, None, None, **{
            **fn.kernel_kw, "static_branch": False, "encode_t": False})
