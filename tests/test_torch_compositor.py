"""The port's fused planar compositor
(`nsff_pl_tpu_torch/ops/compositing_planar_kernel.py`) against the JAX
package's `make_planar_compositor`, whose Pallas kernels run here in
interpret mode, on the same numpy planes and cotangents.

Tolerances: forward weights and maps 1e-5 abs, and each of the 16 input
cotangents within 1e-5 of its largest magnitude: both sides compute the
same f32 formulas, but JAX's exclusive cumsums are Hillis-Steele lane
scans and the port's are sequential, so sums differ in the last bits. The
hand-written adjoint against torch.autograd of the plain forward in f64:
1e-9 of the largest magnitude (the same function differentiated two
ways; f64 rounding only).

The CUDA kernels run only on the card: see tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import compositing_planar_kernel as jck
from nsff_pl_tpu_torch.ops import compositing as tcp
from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck
from nsff_pl_tpu_torch.ops import launches

N, S = 7, 16
TOL = 1e-5
F64_TOL = 1e-9


def _inputs(seed, opaque=False):
    rng = np.random.RandomState(seed)
    ins = {"zs": np.sort(rng.rand(N, S), 1)}
    for k in ("ssig", "tsig", "tsig_w1", "tsig_w2"):
        ins[k] = rng.randn(N, S) * 2 + (40.0 if opaque and k == "ssig" else 0)
    for k in ("ns", "nt", "nw1", "nw2"):
        ins[k] = rng.randn(N, S)
    for k in tck.IN_KEYS[9:]:
        ins[k] = rng.rand(N, S)
    g = {k: rng.randn(N, S) for k in tck.OUT_KEYS}
    g["maps"] = rng.randn(N, tck.N_MAP)
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return f32(ins), f32(g)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("seed,opaque", [(0, False), (1, False), (2, True)])
def test_forward_and_adjoint_match_jax(seed, opaque):
    ins, g = _inputs(seed, opaque)
    jfn = jck.make_planar_compositor(S)
    jout, vjp = jax.vjp(jfn, {k: jnp.asarray(v) for k, v in ins.items()})
    (jd,) = vjp({k: jnp.asarray(v) for k, v in g.items()})

    tins = {k: torch.from_numpy(v).requires_grad_(k in tck.GRAD_KEYS)
            for k, v in ins.items()}
    out = tck.make_planar_compositor(S)(tins)
    assert set(out) == set(jout) == set(tck.OUT_KEYS) | {"maps"}
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=TOL, rtol=0,
                                   err_msg=k)
    torch.autograd.backward([out[k] for k in g],
                            [torch.from_numpy(v) for v in g.values()])
    for k in tck.GRAD_KEYS:
        assert _rel(tins[k].grad.numpy(), jd[k]) <= TOL, k
    for k in set(tck.IN_KEYS) - set(tck.GRAD_KEYS):  # data: no gradient
        assert tins[k].grad is None
        assert not np.asarray(jd[k]).any()


@pytest.mark.parametrize("seed,opaque", [(3, False), (4, True)])
def test_adjoint_matches_autograd_in_f64(seed, opaque):
    ins, g = _inputs(seed, opaque)
    ins64 = {k: torch.from_numpy(v.astype(np.float64)).requires_grad_(
        k in tck.GRAD_KEYS) for k, v in ins.items()}
    g64 = {k: torch.from_numpy(v.astype(np.float64)) for k, v in g.items()}
    w, maps = tck.planar_compositor_fwd_ref(ins64)
    loss = (w * torch.stack([g64[k] for k in tck.OUT_KEYS])).sum() \
        + (maps * g64["maps"]).sum()
    loss.backward()
    with torch.no_grad():
        d = tck.planar_compositor_bwd_ref(
            {k: v.detach() for k, v in ins64.items()},
            {k: g64[k] for k in tck.OUT_KEYS}, g64["maps"])
    for i, k in enumerate(tck.GRAD_KEYS):
        assert _rel(d[i].numpy(), ins64[k].grad.numpy()) <= F64_TOL, k


def test_zero_cotangents_and_cpu_dispatch():
    ins, _ = _inputs(5)
    tins = {k: torch.from_numpy(v) for k, v in ins.items()}
    before = launches.counts()
    d = tck.planar_compositor_bwd(tins, {}, None)
    assert not d.any()
    out, maps = tck.planar_compositor_fwd(tins)
    assert out.shape == (5, N, S) and maps.shape == (N, tck.N_MAP)
    assert not maps[:, 10:].any()
    assert launches.counts() == before


def test_softplus_gradient_is_sigmoid():
    """JAX differentiates softplus to sigmoid everywhere, x = 0 included;
    the compositor's adjoint uses sigmoid, so the port's autograd must
    agree with it."""
    x = torch.tensor([0.0, -3.0, 2.5, 40.0, -40.0], requires_grad=True)
    tcp.softplus(x).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(),
                               torch.sigmoid(x.detach()).numpy(), atol=1e-7)
