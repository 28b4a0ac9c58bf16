"""The port's trainable packed evaluator
(`nsff_pl_tpu_torch/ops/mlp_train_kernel.py`) against the JAX package's
`make_fused_nerf_train`, whose Pallas forward and custom-VJP backward run
here in interpret mode as `tests/test_mlp_train_kernel.py` runs them.

Same weights (JAX initializer, `params_from_jax`), same dyadic points,
embeddings and cotangent, S=16, N_tau=16, full-width towers. Tolerances,
as for the planar evaluator (tests/test_torch_train_kernel.py):
- forward: tests/test_torch_mlp_kernel.py's bounds (1e-4 abs, at most a
  tenth of the rows off by more than 1e-6);
- gradients of every weight, xyz and the per-ray embeddings. Both sides
  round every cotangent to bf16 before its products; what differs is f32
  summation order. On inputs where both sides take the same ReLU branch
  at every sample (seed 3) every entry is held to 1e-3 of the leaf's
  largest (measured: at most 6.1e-4, every variant). The f32 order also
  flips, now and then, the bf16 rounding of an activation next to zero
  and with it one sample's ReLU mask; that sample's cotangent then
  changes whole and the difference runs down the tower, and with only 80
  rows one sample weighs much. Seed 2 is held to 5e-2 in Frobenius norm
  relative to the leaf and 0.1 of its largest entry (measured: 2.9e-3,
  1.6e-2), seeds 0 and 1 to the same Frobenius bound and 0.2 of the
  largest entry (measured: 2.5e-2, 0.155);
- the hand-written backward against autograd of the plain forward at 0.2
  of the largest magnitude, the bound `tests/test_mlp_train_kernel.py`
  holds the TPU kernel to: autograd treats the bf16 casts as identities.

The CUDA kernels run only on the card: see tests/test_torch_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import mlp_train_kernel as jmt
from nsff_pl_tpu_torch.ops import mlp_kernel as tmk
from nsff_pl_tpu_torch.ops import mlp_train_kernel as tmt
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax
from tests.test_torch_mlp_kernel import (N_A, N_TAU, S, check_packed, inputs,
                                         jax_params)

N = 5
GRAD_TOL = 1e-3
GRAD_FRO, GRAD_MAX = 5e-2, 0.1
AUTOGRAD_TOL = 0.2

# name: (static_branch, encode_t, output_flow, encode_a, need_dxyz)
VARIANTS = {
    "main": (True, True, ("fw", "bw"), False, False),
    "main_dxyz": (True, True, ("fw", "bw"), False, True),
    "main_appearance": (True, True, ("fw", "bw"), True, False),
    "fw_warp": (False, True, ("bw",), False, True),
    "bw_warp": (False, True, ("fw",), False, True),
    "warp_no_dxyz": (False, True, ("fw",), False, False),
    "static_only": (True, False, (), False, True),
}


def _kernel_kw(variant):
    static_branch, encode_t, flow, encode_a, need_dxyz = VARIANTS[variant]
    return dict(use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
                output_flow=flow, n_tau=N_TAU, n_a=N_A,
                static_branch=static_branch, need_dxyz=need_dxyz)


@functools.lru_cache(maxsize=None)
def _jax_fn(variant):
    """One JAX evaluator per variant, so that its cases share the traced
    and compiled kernels."""
    fn = jmt.make_fused_nerf_train(S, block_rows=8 * S, bwd_block_rows=8 * S,
                                   **_kernel_kw(variant))

    def out_and_grads(g, *args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    return jax.jit(out_and_grads)


def _run_both(variant, seed=0):
    """(jax out, jax grads, torch out, torch grads) as numpy, the grads as
    dicts over params leaves + xyz, dir, a, t."""
    static_branch, encode_t, flow, encode_a, need_dxyz = VARIANTS[variant]
    jp = jax_params(encode_a)
    xyz, dirs, a, t = inputs(N, seed)
    g = np.random.RandomState(seed + 100).randn(N, S, 16).astype(np.float32)
    kw = _kernel_kw(variant)
    jfn = _jax_fn(variant)
    jargs = (jp, jnp.asarray(xyz),
             jnp.asarray(dirs) if static_branch else None,
             jnp.asarray(a) if encode_a else None,
             jnp.asarray(t) if encode_t else None)
    jout, jg = jfn(jnp.asarray(g), *jargs)

    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for layer in tp.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    tin = [torch.from_numpy(v).requires_grad_(True)
           for v in (xyz, dirs, a, t)]
    tfn = tmt.make_fused_nerf_train(S, **kw)
    out = tfn(tp, tin[0], tin[1] if static_branch else None,
              tin[2] if encode_a else None, tin[3] if encode_t else None)
    (out * torch.from_numpy(g)).sum().backward()

    def grad(x):
        return None if x.grad is None else x.grad.numpy()

    tg = {f"{k}.{p}": grad(v) for k, layer in tp.items()
          for p, v in layer.items()}
    jgd = {f"{k}.{p}": np.asarray(v) for k, layer in jg[0].items()
           for p, v in layer.items()}
    for i, name in enumerate(("xyz", "dir", "a", "t")):
        tg[name] = grad(tin[i])
        jgd[name] = None if jg[1 + i] is None else np.asarray(jg[1 + i])
    return np.asarray(jout), jgd, out.detach().numpy(), tg


def _compare_grads(tg, jgd, max_tol, fro_tol=None):
    worst = (0.0, 0.0)
    for name, want in jgd.items():
        got = tg[name]
        if want is None or not np.any(want):
            # no gradient on the JAX side, or exact zeros (a head the call
            # does not output, xyz without need_dxyz)
            assert got is None or not np.any(got), name
            continue
        assert got is not None, name
        scale = np.abs(want).max()
        e_max = np.abs(got - want).max() / scale
        e_fro = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert e_max <= max_tol, (name, e_max)
        if fro_tol is not None:
            assert e_fro <= fro_tol, (name, e_fro)
        worst = (max(worst[0], e_max), max(worst[1], e_fro))
    return worst


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_grads_match_jax(variant):
    jout, jgd, out, tg = _run_both(variant, seed=2)
    check_packed(out, jout)
    assert set(tg) == set(jgd)
    _compare_grads(tg, jgd, GRAD_MAX, GRAD_FRO)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_grads_without_mask_flip(variant):
    jout, jgd, out, tg = _run_both(variant, seed=3)
    check_packed(out, jout)
    _compare_grads(tg, jgd, GRAD_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_grads_with_a_mask_flip(seed):
    _, jgd, _, tg = _run_both("main_dxyz", seed)
    _compare_grads(tg, jgd, 2 * GRAD_MAX, GRAD_FRO)


@pytest.mark.parametrize("variant", ["main_dxyz", "fw_warp", "static_only"])
def test_handwritten_backward_matches_autograd(variant):
    """`fused_nerf_train_bwd_ref` against autograd of `fused_nerf_eval_ref`
    (which treats the bf16 round trips as identities)."""
    static_branch, encode_t, flow, encode_a, _ = VARIANTS[variant]
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params(encode_a)),
                         "cpu")
    xyz, dirs, a, t = (torch.from_numpy(v) for v in inputs(N))
    g = torch.from_numpy(
        np.random.RandomState(7).randn(N, S, 16).astype(np.float32))
    op = tmt.make_fused_nerf_train(
        S, use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
        output_flow=flow, n_tau=N_TAU, n_a=N_A, static_branch=static_branch)
    pw = op.pack(tp)
    kw = op.kernel_kw
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "output_flow", "flow_scale", "D", "skips")}
    args = (xyz, dirs if static_branch else None, None,
            t if encode_t else None)
    hand = {}
    dxyz = 0
    for branch in (["static"] if static_branch else []) + (
            ["transient"] if encode_t else []):
        r = tmt.fused_nerf_train_bwd_ref(branch, pw, *args, g,
                                         need_dxyz=True, **bkw)
        dxyz = dxyz + r["dxyz"]
        hand.update({k: v for k, v in r.items() if k in ("ddir", "dt")})
        hand.update({f"{k}.{p}": v for k, d in r["dws"].items()
                     for p, v in d.items()})
    hand["dxyz"] = dxyz

    # autograd through the plain forward on f32 copies of the packed weights
    pwf = {k: {"w": v["w"].float().requires_grad_(True),
               "b": v["b"].clone().requires_grad_(True)}
           for k, v in pw.items()}
    leaves = [x.clone().requires_grad_(True) if x is not None else None
              for x in args]
    from nsff_pl_tpu_torch.ops import raymarch_kernel as trk

    orig = trk._mm
    try:  # keep the weights f32 leaves: _mm casts its `w` with .float()
        out = tmk.fused_nerf_eval_ref(pwf, *leaves, **kw)
    finally:
        trk._mm = orig
    (out * g).sum().backward()
    auto = {"dxyz": leaves[0].grad}
    if static_branch:
        auto["ddir"] = leaves[1].grad
    if encode_t:
        auto["dt"] = leaves[3].grad
    for k, v in pwf.items():
        auto[f"{k}.w"], auto[f"{k}.b"] = v["w"].grad, v["b"].grad
    assert set(hand) == set(auto)
    for k, want in auto.items():
        scale = float(want.abs().max())
        if scale == 0:
            continue
        err = float((hand[k] - want).abs().max()) / scale
        assert err <= AUTOGRAD_TOL, (k, err)


def test_branch_g_cols_and_wrapper_checks():
    g = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 16)
    flat = g.reshape(-1, 16)
    assert torch.equal(tmt._branch_g_cols("static", g, ()), flat[:, 0:4])
    bw = tmt._branch_g_cols("transient", g, ("bw",))
    assert torch.equal(bw[:, 0:4], flat[:, 4:8])
    assert not bw[:, 4:7].any() and torch.equal(bw[:, 7:10], flat[:, 8:11])
    both = tmt._branch_g_cols("transient", g, ("fw", "bw"))
    assert torch.equal(both, flat[:, 4:14])
    with pytest.raises(ValueError, match="unknown branch"):
        tmt.fused_nerf_train_bwd_cuda(
            "both", {}, torch.zeros(1, 128, 3), None, None, None,
            torch.zeros(1, 128, 16), freqs=(1.0,), use_viewdir=False,
            encode_a=False, output_flow=(), flow_scale=0.2, need_dxyz=False)
