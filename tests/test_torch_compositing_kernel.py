"""The port's fused compositor on the packed evaluator output
(`nsff_pl_tpu_torch/ops/compositing_kernel.py`) against the JAX package's
`make_fused_compositing`, whose Pallas kernels run here in interpret mode
as `tests/test_compositing_kernel.py` runs them, on the same numpy inputs.

Tolerances: forward planes and maps 2e-6 abs; the packed cotangent within
2e-6 of its largest magnitude: both sides compute the same f32 formulas,
but JAX's products and trailing sums are lane scans and the port's are
`cumprod` / `cumsum`, so they differ in the last bits (measured: forward
at most 1.8e-7, adjoint at most 8.5e-8). The hand-written adjoint against
torch.autograd of the plain forward in f64: 1e-9 of the largest magnitude
(one function differentiated two ways).

The far-sample case puts the static sigma near softplus(0) = 0.69 at every
sample, so 1 - alpha, about 1e-31 at the last one (delta 100), vanishes
in f32: the adjoint must stay finite and agree, which needs the 1e-37
floor under the division and trailing sums that are not formed as total
minus prefix.

The CUDA kernels run only on the card: see tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import compositing_kernel as jck
from nsff_pl_tpu_torch.ops import compositing as tcp
from nsff_pl_tpu_torch.ops import compositing_kernel as tck

N, S = 11, 16
TOL = 2e-6
F64_TOL = 1e-9


def _inputs(seed, far=False, zero=False):
    rng = np.random.RandomState(seed)
    packed = rng.randn(N, S, 16) * 2
    packed[..., 0:3] = rng.rand(N, S, 3)
    packed[..., 4:7] = rng.rand(N, S, 3)
    zs = np.sort(rng.rand(N, S), 1)
    ns, nt = rng.randn(N, S), rng.randn(N, S)
    if far:  # sigma + noise in [0, 0.06]: exp(-100 softplus) ~ 1e-31
        packed[..., 3] = 0.06 * rng.rand(N, S) - ns
    if zero:  # softplus at exactly x = 0
        packed[..., 3] = -ns
        packed[..., 7] = 0.0
        nt[:] = 0.0
    g = {k: rng.randn(N, S) for k in tck.OUT_KEYS}
    g["rgb"], g["depth"] = rng.randn(N, 3), rng.randn(N)
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return f32({"packed": packed, "zs": zs, "ns": ns, "nt": nt}), f32(g)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


CASES = {"random0": (0, False, False), "random1": (1, False, False),
         "far_sample": (2, True, False), "softplus_at_zero": (3, False, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_adjoint_match_jax(case):
    seed, far, zero = CASES[case]
    ins, g = _inputs(seed, far, zero)
    jfn = jck.make_fused_compositing(S, block_rays=8)
    jout, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(ins["zs"]),
                                      jnp.asarray(ins["ns"]),
                                      jnp.asarray(ins["nt"])),
                        jnp.asarray(ins["packed"]))
    (jd,) = vjp({k: jnp.asarray(v) for k, v in g.items()})
    jd = np.asarray(jd)

    packed = torch.from_numpy(ins["packed"]).requires_grad_(True)
    out = tck.make_fused_compositing(S)(
        packed, *(torch.from_numpy(ins[k]) for k in ("zs", "ns", "nt")))
    assert set(out) == set(jout) == set(tck.OUT_KEYS) | {"rgb", "depth"}
    for k in out:
        assert out[k].shape == jout[k].shape, k
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=TOL, rtol=0,
                                   err_msg=k)
    if far:  # the case is what it says: the last sample's 1 - alpha vanishes
        keep = ((1.0 - out["static_alphas"])
                * (1.0 - out["transient_alphas"])).detach()[:, -1]
        assert float(keep.max()) < 1e-30
    torch.autograd.backward([out[k] for k in g],
                            [torch.from_numpy(v) for v in g.values()])
    got = packed.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(jd).all()
    assert _rel(got, jd) <= TOL
    assert not got[..., 8:].any() and not jd[..., 8:].any()


@pytest.mark.parametrize("case", ["random0", "far_sample", "softplus_at_zero"])
def test_adjoint_matches_autograd_in_f64(case):
    seed, far, zero = CASES[case]
    ins, g = _inputs(seed + 10, far, zero)
    i64 = {k: torch.from_numpy(v.astype(np.float64)) for k, v in ins.items()}
    g64 = {k: torch.from_numpy(v.astype(np.float64)) for k, v in g.items()}
    packed = i64["packed"].clone().requires_grad_(True)
    planes, maps = tck.fused_compositing_fwd_ref(packed, i64["zs"], i64["ns"],
                                                 i64["nt"])
    gmap = torch.cat([g64["rgb"], g64["depth"][:, None]], 1)
    loss = (planes * torch.stack([g64[k] for k in tck.OUT_KEYS])).sum() \
        + (maps * gmap).sum()
    loss.backward()
    with torch.no_grad():
        d = tck.fused_compositing_bwd_ref(
            i64["packed"], i64["zs"], i64["ns"], i64["nt"],
            {k: g64[k] for k in tck.OUT_KEYS}, gmap)
    assert _rel(d.numpy(), packed.grad.numpy()) <= F64_TOL


def test_plain_forward_is_the_unfused_chain():
    """The plain forward equals the renderer's unfused compositing
    (`ops/compositing.py`) on the same packed tile."""
    ins, _ = _inputs(5)
    packed, zs, ns, nt = (torch.from_numpy(ins[k])
                          for k in ("packed", "zs", "ns", "nt"))
    d_s, d_t = tcp.deltas_from_zs(zs)
    a_s = tcp.sigma2alpha(packed[..., 3], d_s, ns)
    a_t = tcp.sigma2alpha(packed[..., 7], d_t, nt)
    w_s, w_t, w, trans = tcp.composite_two_fields(a_s, a_t)
    out = tck.make_fused_compositing(S)(packed, zs, ns, nt)
    for k, want in (("static_alphas", a_s), ("transient_alphas", a_t),
                    ("static_weights", w_s), ("transient_weights", w_t),
                    ("weights", w),
                    ("rgb", tcp.weighted_sum(w_s, packed[..., 0:3])
                     + tcp.weighted_sum(w_t, packed[..., 4:7])),
                    ("depth", tcp.weighted_sum(w, zs))):
        torch.testing.assert_close(out[k], want, atol=1e-6, rtol=0)
    torch.testing.assert_close(tcp.composite_one_field(a_s),
                               a_s * tcp.transmittance(a_s))
    assert torch.equal(trans[:, 0], torch.ones(N))


def test_zero_cotangents_cpu_dispatch_and_checks():
    ins, _ = _inputs(6)
    args = tuple(torch.from_numpy(ins[k]) for k in ("packed", "zs", "ns", "nt"))
    before = (dict(tck.fused_compositing_fwd_cuda.launches),
              dict(tck.fused_compositing_bwd_cuda.launches))
    assert not tck.fused_compositing_bwd(*args, {}, None).any()
    planes, maps = tck.fused_compositing_fwd(*args)
    assert planes.shape == (7, N, S) and maps.shape == (N, 4)
    assert (dict(tck.fused_compositing_fwd_cuda.launches),
            dict(tck.fused_compositing_bwd_cuda.launches)) == before
    with pytest.raises(ValueError, match="samples"):
        tck.make_fused_compositing(8)(*args)
    # the CUDA wrapper's checks run before anything touches the card: S =
    # 16 passes the sample check (any S >= 1), and the device check raises
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tck.fused_compositing_fwd_cuda(*args)
