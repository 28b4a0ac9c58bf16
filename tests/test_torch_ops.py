"""Port ops (`nsff_pl_tpu_torch/ops/`) against the JAX package's ops on the
same numpy inputs: posenc, ray geometry, stratified depths, compositing
primitives. f32 on the CPU, atol 1e-5 (both sides run the same f32
formulas; only summation order and transcendental ulps differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import compositing as jcp
from nsff_pl_tpu.ops import posenc as jpe
from nsff_pl_tpu.ops import rays as jrays
from nsff_pl_tpu.ops import sampling as jsamp
from nsff_pl_tpu_torch.ops import compositing as tcp
from nsff_pl_tpu_torch.ops import posenc as tpe
from nsff_pl_tpu_torch.ops import rays as trays
from nsff_pl_tpu_torch.ops import sampling as tsamp

ATOL = 1e-5
K = np.array([[40.0, 0, 16.0], [0, 38.0, 12.0], [0, 0, 1]], np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               atol=atol, rtol=1e-5)


def _c2w(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(3, 3)
    q, _ = np.linalg.qr(a)
    c2w = np.concatenate([q, rng.randn(3, 1) * 0.1], 1).astype(np.float32)
    c2w[2, 3] = -0.2
    return c2w


@pytest.mark.parametrize("max_log,n_freqs,logscale",
                         [(9.0, 10, True), (3.0, 4, True), (3.0, 4, False)])
def test_posenc_matches_jax(max_log, n_freqs, logscale):
    x = np.random.RandomState(0).uniform(-1, 1, (7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        jpe.posenc_freqs(max_log, n_freqs, logscale),
        tpe.posenc_freqs(max_log, n_freqs, logscale))
    _close(jpe.posenc(jnp.asarray(x), max_log, n_freqs, logscale),
           tpe.posenc(torch.from_numpy(x), max_log, n_freqs, logscale))
    assert tpe.posenc_dim(3, n_freqs) == jpe.posenc_dim(3, n_freqs)


def test_posenc_first_called_in_inference_mode_serves_autograd():
    """The per-device frequencies made by a first call inside a no-grad
    render (inference mode) must be usable by a later training step's
    autograd: a render before training (a trainer's validation, a
    service in the same process) once broke the next step."""
    x = torch.rand(4, 3)
    with torch.inference_mode():
        tpe.posenc(x, 5.5, 7)  # a scale no other test uses: a new cache key
    y = torch.rand(4, 3, requires_grad=True)
    tpe.posenc(y, 5.5, 7).sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()


@pytest.mark.parametrize("flatten", [True, False])
def test_ray_directions_match_jax(flatten):
    jd, juv = jrays.get_ray_directions(12, 16, K, flatten=flatten,
                                       return_uv=True)
    td, tuv = trays.get_ray_directions(12, 16, K, flatten=flatten,
                                       return_uv=True, device="cpu")
    _close(jd, td)
    _close(juv, tuv)


@pytest.mark.parametrize("seed", [0, 1])
def test_get_rays_and_ndc_match_jax(seed):
    c2w = _c2w(seed)
    dirs = np.array(jrays.get_ray_directions(12, 16, K))
    jo, jd = jrays.get_rays(jnp.asarray(dirs), c2w)
    to, td = trays.get_rays(torch.from_numpy(dirs), c2w)
    _close(jo, to)
    _close(jd, td)
    shift_near = -min(-1.0, float(c2w[2, 3]))
    jno, jnd = jrays.get_ndc_rays(K, 1.0, shift_near, jo, jd)
    tno, tnd = trays.get_ndc_rays(K, 1.0, shift_near, to, td)
    _close(jno, tno, atol=1e-4)
    _close(jnd, tnd, atol=1e-4)


def test_ndc2world_matches_jax():
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-0.9, 0.9, (6, 5, 3)).astype(np.float32)
    _close(jrays.ndc2world(jnp.asarray(xyz), K),
           trays.ndc2world(torch.from_numpy(xyz), K))
    Ks = np.stack([K * (1 + 0.1 * i) for i in range(6)]).astype(np.float32)
    Ks[:, 2, 2] = 1
    _close(jrays.ndc2world(jnp.asarray(xyz), Ks),
           trays.ndc2world(torch.from_numpy(xyz), Ks))


@pytest.mark.parametrize("perturb", [0.0, 1.0, 0.5])
def test_stratified_zs_matches_jax(perturb):
    key = jax.random.PRNGKey(7)
    jz, jmid = jsamp.stratified_zs(key, 5, 16, perturb)
    # the JAX function's uniforms, injected into the port
    u = torch.from_numpy(np.array(jax.random.uniform(key, (5, 16))))
    tz, tmid = tsamp.stratified_zs(5, 16, perturb, u=u)
    _close(jz, tz)
    _close(jmid, tmid)


def test_stratified_zs_generator_draws_in_interval():
    zs, _ = tsamp.stratified_zs(4, 8, 1.0,
                                generator=torch.Generator().manual_seed(0))
    lin = torch.linspace(0, 1, 8)
    mid = 0.5 * (lin[:-1] + lin[1:])
    lower = torch.cat([lin[:1], mid])
    upper = torch.cat([mid, lin[-1:]])
    assert bool(((zs >= lower) & (zs <= upper)).all())


def _planes(seed, n=5, s=16):
    rng = np.random.RandomState(seed)
    zs = np.sort(rng.uniform(0, 1, (n, s)), 1).astype(np.float32)
    sig = rng.randn(n, s).astype(np.float32) * 3
    return zs, sig


def test_deltas_and_softplus_match_jax():
    zs, sig = _planes(0)
    js, jt = jcp.deltas_from_zs(jnp.asarray(zs))
    ts_, tt = tcp.deltas_from_zs(torch.from_numpy(zs))
    _close(js, ts_)
    _close(jt, tt)
    _close(jcp.softplus(jnp.asarray(sig)), tcp.softplus(torch.from_numpy(sig)))


@pytest.mark.parametrize("seed", [1, 2])
def test_transmittance_from_taus_matches_jax(seed):
    zs, sig = _planes(seed)
    taus = np.abs(sig) * 0.3
    _close(jcp.transmittance_from_taus(jnp.asarray(taus)),
           tcp.transmittance_from_taus(torch.from_numpy(taus)))
    # and equals the cumprod form of the shared transmittance
    _close(jcp.transmittance(1.0 - jnp.exp(-jnp.asarray(taus))),
           tcp.transmittance_from_taus(torch.from_numpy(taus)))
