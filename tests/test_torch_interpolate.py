"""Space-time interpolation and the render against independent float64
equations.

- `interpolate` (`nsff_pl_tpu_torch/models/rendering.py`) against the JAX
  package's on one seeded pair of render dicts with nonzero flows of mixed
  magnitude: within 1e-5 abs (the same f32 formulas; the splat and the
  over-composite sum in another order).
- The same against the float64 dense-scatter equations of
  `tests/test_golden_cross.py::_np_interpolate_f64` on that file's inputs
  (its `test_interpolate_matches_reference_equations`): within 2e-4 abs,
  that test's bound for the JAX package.
- The port's render on a synthetic Lightning checkpoint against
  `tests/test_golden_cross.py::ref_forward` (the reference forward in
  float64, sharing no code with either package): float32 on the plain
  evaluators within 5e-4 abs, the bound that file holds the JAX package
  to (measured 9.5e-8); the bfloat16 planar routes (the serving
  evaluator's plain version, and the planes route with its flow planes)
  within 2e-3 abs: bf16 rounding of every activation through nine layers
  (measured 3.4e-4 on the flows, 1.5e-4 on rgb).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models.rendering import interpolate as jinterpolate
from nsff_pl_tpu.ops import rays as jrays
from nsff_pl_tpu_torch.models.rendering import RenderConfig, interpolate
from nsff_pl_tpu_torch.training.checkpoint import import_pl_checkpoint
from nsff_pl_tpu_torch.training.step import make_render_fn
from tests.test_golden_cross import (N_FRAMES, N_TAU, _np_interpolate_f64,
                                     make_torch_ckpt, ref_forward)

TOL = 1e-5
GOLD_TOL = 2e-4
F32_TOL = 5e-4
BF16_TOL = 2e-3


def _golden_inputs():
    """The pair of render dicts of
    `test_golden_cross.py::test_interpolate_matches_reference_equations`:
    sample points on the pixel rays, sub-pixel flows and two faster
    planes."""
    w, h, S = 10, 8, 6
    n = w * h
    K = np.array([[12.0, 0, w / 2], [0, 12.0, h / 2], [0, 0, 1]])
    c2w = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    pix = np.stack([uu.ravel(), vv.ravel(), np.ones(n)], 0)
    dirs_c = (np.linalg.inv(K) @ pix).T
    flip = np.array([1.0, -1.0, -1.0])

    def make_res(seed):
        r = np.random.RandomState(seed)
        xyz = np.empty((n, S, 3))
        for si in range(S):
            zc = 2.0 + si + r.uniform(-0.2, 0.2)
            xyz[:, si] = np.asarray(jrays.world2ndc(
                jnp.asarray(dirs_c * zc * flip[None]), jnp.asarray(K)))
        flows = {}
        for key in ("flows_fw", "flows_bw"):
            f = r.uniform(-0.01, 0.01, (n, S, 3))
            f[:, 2] *= 150.0
            f[:, S // 2 + 1] *= 400.0
            flows[key] = f
        return {"xyzs": xyz, "zs": np.sort(r.uniform(0.05, 0.95, (n, S)), -1),
                "rgbs": r.uniform(0, 1, (n, S, 3)),
                "alphas": r.uniform(0, 0.6, (n, S)),
                "static_rgbs": r.uniform(0, 1, (n, S, 3)),
                "static_alphas": r.uniform(0, 0.6, (n, S)), **flows}

    return make_res(1), make_res(2), 0.3, K, c2w, w, h


NAMES = {"xyzs_fine": "xyzs", "zs_fine": "zs",
         "transient_rgbs_fine": "rgbs", "transient_alphas_fine": "alphas",
         "transient_flows_fw": "flows_fw", "transient_flows_bw": "flows_bw",
         "static_rgbs_fine": "static_rgbs",
         "static_alphas_fine": "static_alphas"}


def _as(res, to):
    return {k: to(np.asarray(res[v], np.float32)) for k, v in NAMES.items()}


def test_interpolate_matches_jax_and_f64_equations():
    res_t, res_tp1, dt, K, c2w, w, h = _golden_inputs()
    rgb, depth = interpolate(_as(res_t, torch.from_numpy),
                             _as(res_tp1, torch.from_numpy), dt,
                             K.astype(np.float32),
                             c2w.astype(np.float32), (w, h))
    assert rgb.shape == (h, w, 3) and depth.shape == (h, w)
    jrgb, jdepth = jinterpolate(_as(res_t, jnp.asarray),
                                _as(res_tp1, jnp.asarray), dt,
                                jnp.asarray(K, jnp.float32),
                                jnp.asarray(c2w, jnp.float32), (w, h))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=TOL,
                               rtol=0)
    gold_rgb, gold_depth = _np_interpolate_f64(res_t, res_tp1, dt, K, c2w,
                                               w, h)
    np.testing.assert_allclose(rgb.numpy(), gold_rgb, atol=GOLD_TOL)
    np.testing.assert_allclose(depth.numpy(), gold_depth, atol=GOLD_TOL)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A synthetic reference checkpoint, its rays and the f64 render."""
    rng = np.random.RandomState(7)
    ckpt = os.path.join(str(tmp_path_factory.mktemp("golden")), "g.ckpt")
    sd = make_torch_ckpt(ckpt, rng)
    n, s = 16, 16
    rays_o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rays_o[:, 2] = -1.0
    rays_d = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    rays_d[:, 2] = 2.0
    ts = rng.randint(0, N_FRAMES, (n,))
    zs = np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32), (n, s))
    xyz = rays_o[:, None] + rays_d[:, None] * zs[..., None]
    ref = ref_forward(sd, xyz.astype(np.float64), rays_d.astype(np.float64),
                      sd["embedding_t.weight"][ts], zs.astype(np.float64))
    rays = np.concatenate([rays_o, rays_d], -1)
    return import_pl_checkpoint(ckpt), rays, ts, s, ref


@pytest.mark.parametrize("route", ["float32", "bf16_composited",
                                   "bf16_planes"])
def test_render_matches_reference_equations(golden, route):
    params, rays, ts, s, ref = golden
    kw = dict(N_samples=s, use_viewdir=True, encode_t=True, N_tau=N_TAU,
              max_t=N_FRAMES - 1, img_wh=(16, 16))
    if route != "float32":
        kw.update(compute_dtype="bfloat16", planar_eval="on")
    keys = (("rgb_fine", "depth_fine") if route != "bf16_planes"
            else ("rgb_fine", "depth_fine", "transient_flows_fw"))
    render = make_render_fn(RenderConfig(**kw), output_transient=True,
                            output_transient_flow=("fw", "bw"), keys=keys,
                            device="cpu")
    out = render(params, torch.from_numpy(rays), torch.from_numpy(ts))
    tol = F32_TOL if route == "float32" else BF16_TOL
    np.testing.assert_allclose(out["rgb_fine"].numpy(), ref["rgb_fine"],
                               atol=tol)
    np.testing.assert_allclose(out["depth_fine"].numpy(), ref["depth_fine"],
                               atol=tol)
    if route == "bf16_planes":
        np.testing.assert_allclose(out["transient_flows_fw"].numpy(),
                                   ref["flows_fw"], atol=tol)
