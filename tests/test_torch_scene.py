"""The port's `MonocularScene` (`nsff_pl_tpu_torch/scene/monocular.py`)
against the JAX package's on one synthetic scene
(`tests/helpers_scene.py::make_synthetic_scene`, 64x48, 5 frames,
structured content), read at its native size and resized to 40x30 (every
resize rule runs), the port on the CPU.

Tolerances:
- ray table: rgb, t, disparity and mask equal; rays 1e-5 abs (XLA fuses
  o + d*z into a multiply-add on the CPU and torch does not, ROADMAP C);
  uv + flow targets 1e-4 abs;
- `Ks`, `Ps`, `poses`, `nearest_depth`, `len()`: 1e-6 relative;
- `test_item` of the val, test, test_spiral, test_spiral1 and
  test_fixview0_interp1 splits: the same tolerances per key;
- the `cache_dir/rays.npy` cache: the cached table equals the built one.
"""
import numpy as np
import pytest

from nsff_pl_tpu.scene import MonocularScene as JScene
from nsff_pl_tpu_torch.scene import MonocularScene as TScene
from tests.helpers_scene import make_synthetic_scene

N = 5
SIZES = [(64, 48), (40, 30)]
SPLITS = ["val", "test", "test_spiral", "test_spiral1",
          "test_fixview0_interp1"]
RAYS_TOL, FLOW_TOL, RTOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene"))
    return make_synthetic_scene(path, W=64, H=48, N=N, learnable=True)


def _check_geometry(j, t):
    assert len(t) == len(j)
    assert t.N_frames == j.N_frames
    for name in ("Ks", "Ps", "poses", "K"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(t.nearest_depth, j.nearest_depth, rtol=RTOL)


@pytest.mark.parametrize("wh", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_table_matches_jax(root, wh, tmp_path):
    kw = dict(img_wh=wh, start_end=(0, N))
    j = JScene(root, "train", **kw)
    t = TScene(root, "train", device="cpu", **kw)
    _check_geometry(j, t)
    jr, tr = np.asarray(j.rays), t.rays.numpy()
    assert tr.shape == jr.shape == (N, wh[0] * wh[1], 16)
    np.testing.assert_array_equal(tr[..., 6:12], jr[..., 6:12])
    assert np.abs(tr[..., 0:6] - jr[..., 0:6]).max() <= RAYS_TOL
    assert np.abs(tr[..., 12:16] - jr[..., 12:16]).max() <= FLOW_TOL
    cached = TScene(root, "train", device="cpu", cache_dir=str(tmp_path),
                    **kw)
    again = TScene(root, "train", device="cpu", cache_dir=str(tmp_path),
                   **kw)
    np.testing.assert_array_equal(cached.rays.numpy(), tr)
    np.testing.assert_array_equal(again.rays.numpy(), tr)


@pytest.mark.parametrize("wh", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_test_items_match_jax(root, wh):
    kw = dict(img_wh=wh, start_end=(0, N))
    for split in SPLITS:
        j = JScene(root, split, **kw)
        t = TScene(root, split, device="cpu", **kw)
        _check_geometry(j, t)
        if split != "val":
            np.testing.assert_allclose(t.poses_test, j.poses_test,
                                       rtol=RTOL, atol=1e-7)
        for idx in sorted({0, len(j) // 2, len(j) - 1}):
            ji, ti = j.test_item(idx), t.test_item(idx)
            assert set(ji) == set(ti), split
            assert ti["cam_ids"] == ji["cam_ids"]
            np.testing.assert_array_equal(ti["ts"].numpy(), ji["ts"])
            assert np.abs(ti["rays"].numpy() - ji["rays"]).max() <= RAYS_TOL
            np.testing.assert_allclose(ti["c2w"].numpy(), ji["c2w"],
                                       rtol=RTOL, atol=1e-7)
            for k in ("rgbs", "disp", "mask"):
                if k in ji:
                    np.testing.assert_array_equal(ti[k].numpy(), ji[k])
            for k in ("flow_fw", "flow_bw"):
                if k in ji:
                    assert np.abs(ti[k].numpy() - ji[k]).max() <= FLOW_TOL
