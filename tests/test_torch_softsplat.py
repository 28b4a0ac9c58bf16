"""The port's splat (`nsff_pl_tpu_torch/ops/softsplat.py`) against the JAX
package's (`nsff_pl_tpu/ops/softsplat.py`) on the same seeded numpy
images and flows: `softsplat_sum`, `softsplat` in its four modes and the
batched planar splat that `interpolate` calls (with flows from sub-pixel
to beyond the JAX package's largest shift bucket, so its scatter
fallback runs too). Each test runs both of the port's forms, the shifts
and the scatter (forced through `MAX_SHIFT_TERMS`). Tolerance 1e-5 abs:
the same bilinear weights, sums of the same terms in another order.
Also, exactly: corners outside the image are dropped, a pixel that
receives nothing keeps 0 (its normaliser is 1), and a second run gives
the same bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.ops import softsplat as jss
from nsff_pl_tpu_torch.ops import softsplat as tss

TOL = 1e-5
H, W, C = 9, 13, 3


@pytest.fixture(params=["shifts", "scatter"], autouse=True)
def form(request, monkeypatch):
    monkeypatch.setattr(tss, "MAX_SHIFT_TERMS",
                        10 ** 9 if request.param == "shifts" else 0)
    return request.param


def _case(seed, scale=2.0):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (H, W, C)).astype(np.float32)
    flow = (rng.uniform(-1, 1, (H, W, 2)) * scale).astype(np.float32)
    metric = rng.uniform(-1, 1, (H, W, 1)).astype(np.float32)
    return img, flow, metric


def test_softsplat_sum_matches_jax():
    img, flow, _ = _case(0)
    want = jss.softsplat_sum(jnp.asarray(img), jnp.asarray(flow))
    got = tss.softsplat_sum(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["summation", "average", "linear",
                                  "softmax"])
def test_softsplat_modes_match_jax(mode):
    img, flow, metric = _case(1)
    m = metric if mode in ("linear", "softmax") else None
    if mode == "linear":
        m = np.abs(m)  # a non-negative weight
    want = jss.softsplat(jnp.asarray(img), jnp.asarray(flow),
                         None if m is None else jnp.asarray(m), mode)
    got = tss.softsplat(torch.from_numpy(img), torch.from_numpy(flow),
                        None if m is None else torch.from_numpy(m), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["average", "summation"])
def test_batched_planar_matches_jax(mode):
    """(S, C, H, W) planes, each with its own flow: small flows, a plane
    at ~3 px, one at ~40 px (beyond the JAX package's buckets), and more
    planes than one scatter call takes."""
    rng = np.random.RandomState(2)
    S = tss.PLANES_PER_CALL + 5
    planes = rng.uniform(0, 1, (S, 4, H, W)).astype(np.float32)
    scale = np.full((S, 1, 1), 0.8, np.float32)
    scale[3], scale[S - 2] = 3.0, 40.0
    fx = (rng.uniform(-1, 1, (S, H, W)) * scale).astype(np.float32)
    fy = (rng.uniform(-1, 1, (S, H, W)) * scale).astype(np.float32)
    want = jss.softsplat_batched_planar(jnp.asarray(planes), jnp.asarray(fx),
                                        jnp.asarray(fy), mode)
    got = tss.softsplat_batched_planar(torch.from_numpy(planes),
                                       torch.from_numpy(fx),
                                       torch.from_numpy(fy), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    again = tss.softsplat_batched_planar(torch.from_numpy(planes),
                                         torch.from_numpy(fx),
                                         torch.from_numpy(fy), mode)
    assert torch.equal(got, again)


def test_out_of_range_corners_drop_and_zero_normaliser():
    """A pixel pushed off the image leaves nothing behind; a pixel half a
    step past the right edge keeps the half that lands inside; pixels
    nobody reaches stay 0 in average mode."""
    img = np.ones((H, W, 1), np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = 100.0  # everything leaves the image...
    flow[0, 0] = (W - 1.5, 0.0)  # ...but one pixel, half inside
    got = tss.softsplat_sum(torch.from_numpy(img), torch.from_numpy(flow))
    want = np.zeros((H, W, 1), np.float32)
    want[0, W - 2], want[0, W - 1] = 0.5, 0.5
    np.testing.assert_array_equal(got.numpy(), want)
    avg = tss.softsplat(torch.from_numpy(img * 3), torch.from_numpy(flow),
                        mode="average")
    want = np.zeros((H, W, 1), np.float32)
    want[0, W - 2], want[0, W - 1] = 3.0, 3.0
    np.testing.assert_array_equal(avg.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jss.softsplat(jnp.asarray(img * 3), jnp.asarray(flow),
                                 mode="average")), want)
