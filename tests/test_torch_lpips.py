"""The port's LPIPS (`nsff_pl_tpu_torch/training/metrics.py`) against the
JAX package's `JaxLPIPS` on one seeded random AlexNet-LPIPS state dict in
the `lpips` package's key layout (`tests/test_lpips.py::
_random_state_dict`), saved once and loaded by both: the spatial maps
within 1e-5 abs (the same convolutions, pools and bilinear upsampling,
summed in another order), the masked and whole-image means likewise,
and no model (hence None, "n/a" in the eval CLI) without a weights
file."""
import numpy as np
import pytest
import torch

from nsff_pl_tpu.training import metrics as jmetrics
from nsff_pl_tpu_torch.training import metrics as tmetrics
from tests.test_lpips import _random_state_dict

TOL = 1e-5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "alex_lpips.pth"
    torch.save(_random_state_dict(seed=3), path)
    return (jmetrics.get_lpips_model(str(path)),
            tmetrics.get_lpips_model(str(path)))


def test_lpips_maps_and_means_match_jax(models):
    jmodel, tmodel = models
    assert isinstance(tmodel, tmetrics.AlexLPIPS)
    rng = np.random.RandomState(0)
    H, W = 65, 97  # odd sizes: pool and upsample edges
    a = rng.rand(H, W, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(H, W, 3), 0, 1).astype(np.float32)
    mask = rng.rand(H, W) > 0.6
    want = jmodel(a, b)
    got = tmetrics.lpips(tmodel, torch.from_numpy(a), torch.from_numpy(b),
                         reduction="none")
    assert got.shape == (H, W)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for m in (None, mask):
        jv = jmetrics.lpips(jmodel, a, b, m)
        tv = tmetrics.lpips(tmodel, torch.from_numpy(a), torch.from_numpy(b),
                            None if m is None else torch.from_numpy(m))
        assert abs(tv - jv) <= TOL


def test_no_weights_file_means_no_model():
    assert tmetrics.get_lpips_model(None) is None
    assert tmetrics.lpips(None, np.zeros((4, 4, 3)), np.zeros((4, 4, 3))) \
        is None


def test_partial_state_dict_is_refused(tmp_path):
    sd = _random_state_dict()
    del sd["net.slice3.6.weight"]
    torch.save(sd, tmp_path / "part.pth")
    with pytest.raises(ValueError, match="slice3"):
        tmetrics.load_lpips_weights(str(tmp_path / "part.pth"))
