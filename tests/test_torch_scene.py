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
- the `cache_dir/rays.npy` cache: the cached table equals the built one;
- the native host builder (`nsff_pl_tpu/scene/native.py::
  build_frame_rays`, `native/ray_table.cpp`), whose rows the JAX loader
  takes whenever g++ builds it: the port's `_build_ray_table` on the CPU
  gives a first frame's (no backward flow) and a last frame's (no forward
  flow) rows under random poses, at the tolerances above.
"""
import numpy as np
import pytest

from nsff_pl_tpu.scene import MonocularScene as JScene
from nsff_pl_tpu.scene import monocular as jmono
from nsff_pl_tpu.scene import native
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


def _random_poses(rng, n):
    """(n, 3, 4) camera-to-world poses: random rotations (unit
    quaternions) and translations, z in [-2, 0.5] (so the NDC near shift
    takes both of its branches)."""
    q = rng.normal(size=(n, 4))
    a, b, c, d = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    rot = np.stack([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a - b * b - c * c + d * d]]).transpose(2, 0, 1)
    trans = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(-2.0, 0.5, n)], -1)
    return np.concatenate([rot, trans[..., None]], -1).astype(np.float32)


@pytest.mark.skipif(not native.available(),
                    reason="native library unavailable (no g++)")
@pytest.mark.parametrize("frame", [0, N - 1], ids=["first", "last"])
def test_ray_table_matches_native_builder(root, frame):
    """The port's counterpart of `native.build_frame_rays` is the device
    builder `_build_ray_table` (and of `native.parse_flo`,
    `flowio.read_flow`): one frame's rows under random poses."""
    kw = dict(img_wh=(40, 30), start_end=(0, N))
    j = JScene(root, "train", **kw)
    t = TScene(root, "train", device="cpu", **kw)
    poses = _random_poses(np.random.default_rng(7 + frame), N)
    t.poses = poses
    got = t._build_ray_table()[frame].numpy()
    w, h = kw["img_wh"]
    fw, bw = j._read_flow_pair(frame)
    if frame == N - 1:
        fw = None
    if frame == 0:
        bw = None
    want = native.build_frame_rays(
        j.K, poses[frame], jmono._imread_rgb(j.image_paths[frame], (w, h)),
        jmono._imread_disp(j.disp_paths[frame], (w, h)),
        jmono._imread_gray(j.mask_paths[frame], (w, h)),
        None if fw is None else fw.reshape(h, w, 2),
        None if bw is None else bw.reshape(h, w, 2), frame, 1.0,
        -min(-1.0, float(poses[frame, 2, 3])))
    assert got.shape == want.shape == (w * h, 16)
    np.testing.assert_array_equal(got[:, 6:12], want[:, 6:12])
    assert np.abs(got[:, 0:6] - want[:, 0:6]).max() <= RAYS_TOL
    assert np.abs(got[:, 12:16] - want[:, 12:16]).max() <= FLOW_TOL
