"""The port's trainable planar evaluator (`make_planar_nerf_train` in
`nsff_pl_tpu_torch/ops/raymarch_kernel.py`) against the JAX package's,
whose Pallas kernels run here in interpret mode as
`tests/test_raymarch_kernel.py` runs them.

Same weights (JAX initializer, carried over by `params_from_jax`), same
numpy inputs and cotangent planes, S=16, N_tau=16, full-width towers.
Tolerances:
- forward planes: at most 1e-4 abs, and at most a tenth of the samples
  off by more than 1e-6. Both sides round at the same points (bf16
  matmul inputs, f32 sums, bf16 activations), but the f32 sums run in
  another order, which now and then flips the bf16 rounding of one
  activation; a per-sample plane shows that flip whole (measured: at
  most 6.5e-5, in at most 5% of the samples), where the serving
  maps averaged it below 1e-5. Dropping a rounding point moves every
  sample, which the second bound catches;
- gradients, where both sides take the same ReLU branch at every
  sample: every entry within 1e-3 of the leaf's largest magnitude. The
  hand-written backward rounds every cotangent to bf16 before its
  products as the TPU kernel does, so what differs is f32 summation
  order (measured: at most 8.4e-4). The f32 order also flips, now and
  then, the bf16 rounding of an activation; where that turns a ReLU
  mask at an activation next to zero (3 of the 5 input seeds tried
  for the main variant), one sample's cotangent changes whole and the
  difference runs down the tower. So the test over every variant holds
  each leaf to 5e-2 in Frobenius norm relative to the leaf and every
  entry to 0.1 of its largest (measured: 2.7e-2, 8.6e-2), and a second
  test holds inputs without a mask flip (seed 3 for the main variant,
  seed 0 for the warps) to the 1e-3 bound;
- the hand-written backward against autograd of the plain forward at
  0.2 of the largest magnitude, the bound `tests/test_raymarch_kernel.py`
  holds the TPU kernel to: autograd differentiates through the bf16
  casts as identities, so the two differ by bf16 rounding of every
  cotangent; the bound catches a wrong adjoint, not rounding.

The CUDA kernels run only on the card: see tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.ops import mlp_train_kernel as jtrain
from nsff_pl_tpu.ops import raymarch_kernel as jrk
from nsff_pl_tpu_torch.ops import launches
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax

S = 16
N_TAU = 16
N_A = 8
N = 5
FWD_TOL = 1e-4
FWD_EXACT, FWD_EXACT_SHARE = 1e-6, 0.1
GRAD_TOL = 1e-3
GRAD_FRO, GRAD_MAX = 5e-2, 0.1
AUTOGRAD_TOL = 0.2

# name: (static_branch, flow_in, output_flow, encode_a)
VARIANTS = {
    "main": (True, False, ("fw", "bw"), False),
    "fw_warp": (False, True, ("bw",), False),
    "bw_warp": (False, True, ("fw",), False),
    "main_appearance": (True, False, ("fw", "bw"), True),
}


def _params(encode_a):
    return jn.init_nerf_params(
        jax.random.PRNGKey(1), "fine", use_viewdir=True,
        encode_transient=True, in_channels_t=N_TAU, output_flow=True,
        encode_appearance=encode_a, in_channels_a=N_A)


def _inputs(variant, seed=0):
    static_branch, flow_in, output_flow, encode_a = VARIANTS[variant]
    rng = np.random.RandomState(seed)
    # dyadic o, d, z and flow: xyz * freq is exact in f32, so a compiler
    # that fuses o + d*z into one multiply-add (XLA does, torch on the CPU
    # does not) computes the same encoding; off this grid the 1-ulp
    # difference at 2^9 |xyz| moves the sine by ~3e-5 and flips the bf16
    # rounding of a few percent of the encoding lanes
    o = (rng.randint(-32, 32, (N, 3)) / 64).astype(np.float32)
    d = (rng.randint(-32, 32, (N, 3)) / 64).astype(np.float32)
    zs = np.stack([np.sort(rng.choice(256, S, replace=False))
                   for _ in range(N)]).astype(np.float32) / 256
    flows = tuple((rng.randint(-16, 16, (N, S)) / 256).astype(np.float32)
                  for _ in range(3)) if flow_in else None
    dirs = rng.uniform(-1, 1, (N, 27)).astype(np.float32)
    a = rng.randn(N, N_A).astype(np.float32)
    t = rng.randn(N, N_TAU).astype(np.float32)
    keys = jrk.planar_out_keys(static_branch=static_branch, encode_t=True,
                               output_flow=output_flow)
    g = {k: rng.randn(N, S).astype(np.float32) for k in keys}
    return o, d, zs, flows, dirs, a, t, g


def _ops(variant):
    static_branch, flow_in, output_flow, encode_a = VARIANTS[variant]
    kw = dict(static_branch=static_branch, flow_in=flow_in,
              use_viewdir=static_branch, encode_a=encode_a, encode_t=True,
              output_flow=output_flow, n_tau=N_TAU, n_a=N_A)
    return (jrk.make_planar_nerf_train(S, block_rows=32, bwd_block_rows=32,
                                       **kw),
            trk.make_planar_nerf_train(S, **kw))


def _jax_vjp(variant, seed=0):
    """JAX planes and the VJP of the given cotangents: (planes, dparams,
    dflows, ddir, da, dt) as numpy."""
    static_branch, flow_in, _, encode_a = VARIANTS[variant]
    jop, _ = _ops(variant)
    params = _params(encode_a)
    o, d, zs, flows, dirs, a, t, g = _inputs(variant, seed)
    J = jnp.asarray

    def f(p, fl, de, ae, te):
        return jop(p, J(o), J(d), J(zs), fl, de, ae, te)

    fl = tuple(J(x) for x in flows) if flow_in else None
    out, vjp = jax.vjp(f, params, fl, J(dirs) if static_branch else None,
                       J(a) if encode_a else None, J(t))
    grads = vjp({k: J(v) for k, v in g.items()})
    to_np = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return to_np(out), *(to_np(x) for x in grads)


def _port(variant, params_np=None, seed=0):
    """Port planes and autograd (hand-written plain backward) grads."""
    static_branch, flow_in, _, encode_a = VARIANTS[variant]
    _, top = _ops(variant)
    if params_np is None:
        params_np = jax.tree.map(np.asarray, _params(encode_a))
    params = params_from_jax(params_np, "cpu")
    for leaf in (p for layer in params.values() for p in layer.values()):
        leaf.requires_grad_(True)
    o, d, zs, flows, dirs, a, t, g = _inputs(variant, seed)
    T = torch.from_numpy
    fl = tuple(T(x).requires_grad_(True) for x in flows) if flow_in else None
    ae = T(a).requires_grad_(True) if encode_a else None
    te = T(t).requires_grad_(True)
    de = T(dirs).requires_grad_(static_branch)
    out = top(params, T(o), T(d), T(zs), fl, de, ae, te)
    torch.autograd.backward([out[k] for k in g], [T(g[k]) for k in g])
    return out, params, fl, ae, te, de


def _rel_close(got, want, tol, name, fro=None):
    """Every |got - want| <= tol * max|want|; with `fro`, also
    ||got - want|| <= fro * ||want||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{name}: {err:.2e} of max |{scale:.3e}| > {tol}"
    if fro is not None:
        e = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert e <= fro, f"{name}: Frobenius {e:.2e} > {fro}"


@pytest.mark.parametrize("variant,seed,exact", [
    (v, 0, False) for v in sorted(VARIANTS)] + [
    ("main", 3, True), ("fw_warp", 0, True), ("bw_warp", 0, True)])
def test_forward_and_backward_match_jax(variant, seed, exact):
    static_branch, flow_in, output_flow, encode_a = VARIANTS[variant]
    jout, jdp, jdfl, jddir, jda, jdt = _jax_vjp(variant, seed)
    out, params, fl, ae, te, de = _port(variant, seed=seed)

    def _grad_close(got, want, name):
        if exact:
            _rel_close(got, want, GRAD_TOL, name)
        else:
            _rel_close(got, want, GRAD_MAX, name, GRAD_FRO)

    assert list(out) == trk.planar_out_keys(
        static_branch=static_branch, encode_t=True, output_flow=output_flow)
    assert set(out) == set(jout)
    for k in jout:
        err = np.abs(out[k].detach().numpy() - jout[k])
        assert err.max() <= FWD_TOL, (k, err.max())
        assert (err > FWD_EXACT).mean() <= FWD_EXACT_SHARE, (k, err)
    n_checked = 0
    for name, layer in jdp.items():
        for part, want in layer.items():
            grad = params[name][part].grad
            if not np.any(want):  # untouched by this evaluation
                assert grad is None or not grad.abs().max() > 0, name
                continue
            _grad_close(grad.numpy(), want, f"{name}.{part}")
            n_checked += 1
    assert n_checked >= (2 * 14 if static_branch else 2 * 12)
    _grad_close(te.grad.numpy(), jdt, "dt")
    if flow_in:
        for c in range(3):
            _grad_close(fl[c].grad.numpy(), jdfl[c], f"dflow{c}")
    if encode_a:
        _grad_close(ae.grad.numpy(), jda, "da")
    if static_branch:
        _grad_close(de.grad.numpy(), jddir, "ddir")


@pytest.mark.parametrize("variant", ["main", "fw_warp"])
def test_hand_written_backward_matches_autograd(variant):
    """The plain backward against torch.autograd of the plain forward
    (differentiated through the weight packing)."""
    static_branch, flow_in, output_flow, encode_a = VARIANTS[variant]
    params_np = jax.tree.map(np.asarray, _params(encode_a))
    out, params, fl, ae, te, _ = _port(variant, params_np)
    _, top = _ops(variant)
    ref_params = params_from_jax(params_np, "cpu")
    leaves = [p.requires_grad_(True) for layer in ref_params.values()
              for p in layer.values()]
    o, d, zs, flows, dirs, a, t, g = _inputs(variant)
    T = torch.from_numpy
    rfl = tuple(T(x).requires_grad_(True) for x in flows) if flow_in else None
    rte = T(t).requires_grad_(True)
    pw = trk.pack_padded_weights(ref_params, top.weight_names, **top.pack_kw)
    planes = trk.planar_nerf_train_ref(pw, T(o), T(d), T(zs), rfl, T(dirs),
                                       None, rte, **top.kernel_kw)
    loss = sum((planes[i] * T(g[k])).sum() for i, k in enumerate(g))
    loss.backward()
    del leaves
    for name, layer in ref_params.items():
        for part, ref in layer.items():
            if ref.grad is None or not ref.grad.abs().max() > 0:
                continue
            _rel_close(params[name][part].grad.numpy(), ref.grad.numpy(),
                       AUTOGRAD_TOL, f"{name}.{part}")
    _rel_close(te.grad.numpy(), rte.grad.numpy(), AUTOGRAD_TOL, "dt")
    if flow_in:
        for c in range(3):
            _rel_close(fl[c].grad.numpy(), rfl[c].grad.numpy(), AUTOGRAD_TOL,
                       f"dflow{c}")


def test_unpad_padded_grads_matches_jax():
    rng = np.random.RandomState(3)
    names = trk.branch_weight_names(D=8, skips=(4,), use_viewdir=True,
                                    static_branch=True, encode_t=True)
    names = names[0] + names[1]
    kw = dict(output_flow=("fw", "bw"), skips=(4,), xyz_w=63, n_tau=N_TAU,
              dir_w=27, n_a=N_A, encode_a=True)
    pw = trk.pack_padded_weights(
        params_from_jax(jax.tree.map(np.asarray, _params(True)), "cpu"),
        names, **kw)
    dws = {n: {"w": rng.randn(*pw[n]["w"].shape).astype(np.float32),
               "b": rng.randn(*pw[n]["b"].shape).astype(np.float32)}
           for n in names}
    want = jtrain.unpad_padded_grads(
        {n: {"w": jnp.asarray(v["w"]), "b": jnp.asarray(v["b"])[None]}
         for n, v in dws.items()}, names, **kw)
    got = trk.unpad_padded_grads(
        {n: {"w": torch.from_numpy(v["w"]), "b": torch.from_numpy(v["b"])}
         for n, v in dws.items()}, names, **kw)
    assert set(got) == set(want)
    for n in want:
        for part in ("w", "b"):
            np.testing.assert_array_equal(got[n][part].numpy(),
                                          np.asarray(want[n][part]))


def test_cpu_tensors_take_the_plain_versions():
    before = launches.counts()
    _port("fw_warp")
    assert launches.counts() == before
    _, top = _ops("fw_warp")
    with pytest.raises(ValueError, match="flow_in"):
        top({}, *[torch.zeros(1, 3)] * 2, torch.zeros(1, S), None)
