"""The order of the packed compositor's scans (`nsff_pl_tpu_torch/ops/
compositing.py`'s block scans, which the plain version of
`csrc/fused_compositing.cu` and the renderer's transmittance take): the
samples in warps of 32, a Hillis-Steele scan inside each warp, the warps
joined in order. The blocked scans are
the sequential ones up to f64 rounding (1e-12 relative) at sample counts
that fill one warp, part of one, and the kernel's four, and the trailing
sum is an exact 0 at the last sample. At the kernel's S = 128, where the
blocked order differs from a sequential one, the plain version is held
against the JAX package's kernel (interpret mode) on the far-sample case,
where 1 - alpha vanishes in f32 at the last sample, at the tolerances of
tests/test_torch_compositing_kernel.py (2e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import compositing_kernel as jck
from nsff_pl_tpu_torch.ops import compositing as tcp
from nsff_pl_tpu_torch.ops import compositing_kernel as tck

F64_TOL = 1e-12
TOL = 2e-6


def _seq_excl_cumprod(v):
    return torch.cat([torch.ones_like(v[:, :1]), torch.cumprod(v, -1)[:, :-1]],
                     -1)


def _seq_rev_excl_cumsum(v):
    out = torch.zeros_like(v)
    for j in range(v.shape[1] - 2, -1, -1):
        out[:, j] = out[:, j + 1] + v[:, j + 1]
    return out


@pytest.mark.parametrize("S", [16, 50, 128])
def test_blocked_scans_are_the_sequential_ones(S):
    g = torch.Generator().manual_seed(S)
    v = torch.rand((5, S), generator=g, dtype=torch.float64) + 0.5
    for got, want in ((tcp.block_excl_cumprod(v), _seq_excl_cumprod(v)),
                      (tcp.block_rev_excl_cumsum(v), _seq_rev_excl_cumsum(v)),
                      (tcp.block_sum(v), v.sum(-1))):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= F64_TOL * float(
            want.abs().max())
    v32 = v.float() * 1e6
    assert not tcp.block_rev_excl_cumsum(v32)[:, -1].any()
    assert bool((tcp.block_excl_cumprod(v32)[:, 0] == 1).all())


def test_plain_version_matches_jax_at_the_far_sample_at_kernel_width():
    N, S = 8, 128
    rng = np.random.RandomState(7)
    packed = rng.randn(N, S, 16) * 2
    packed[..., 0:3] = rng.rand(N, S, 3)
    packed[..., 4:7] = rng.rand(N, S, 3)
    zs = np.sort(rng.rand(N, S), 1)
    ns, nt = rng.randn(N, S), rng.randn(N, S)
    packed[..., 3] = 0.06 * rng.rand(N, S) - ns  # softplus ~ 0.69 everywhere
    g = {k: rng.randn(N, S) for k in tck.OUT_KEYS}
    g["rgb"], g["depth"] = rng.randn(N, 3), rng.randn(N)
    ins = [x.astype(np.float32) for x in (packed, zs, ns, nt)]
    g = {k: v.astype(np.float32) for k, v in g.items()}

    jfn = jck.make_fused_compositing(S, block_rays=8)
    jout, vjp = jax.vjp(lambda p: jfn(p, *(jnp.asarray(x) for x in ins[1:])),
                        jnp.asarray(ins[0]))
    (jd,) = vjp({k: jnp.asarray(v) for k, v in g.items()})
    packed_t = torch.from_numpy(ins[0]).requires_grad_(True)
    out = tck.make_fused_compositing(S)(
        packed_t, *(torch.from_numpy(x) for x in ins[1:]))
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=TOL, rtol=0,
                                   err_msg=k)
    keep = ((1.0 - out["static_alphas"])
            * (1.0 - out["transient_alphas"])).detach()[:, -1]
    assert float(keep.max()) < 1e-30
    torch.autograd.backward([out[k] for k in g],
                            [torch.from_numpy(v) for v in g.values()])
    got, want = packed_t.grad.numpy(), np.asarray(jd)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
