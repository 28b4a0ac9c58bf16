"""The planes route of the port's test-time planar renderer
(`models/raymarch.py::render_test_planar` with per-sample keys) against
the JAX package's on the same rays, frame indices and weights (the port's
initializer, seeded: `tests/torch_train_helpers.py::seeded_params`): both values of `output_transient`,
the transient one with visibility culling and the port's
`planar_compositing` 'on' (the fused compositor's plain version) and
'auto' (the plain composite on the CPU), each against the JAX route on
the CPU (its evaluator in Pallas interpret mode, its plain composite;
tests/test_torch_compositor.py holds the port's compositor against the
JAX kernel). The JAX route runs once per `output_transient` value,
under one `jax.jit` (an eager call traces its evaluator's kernel anew
each time).

Tolerances, as tests/test_torch_train_kernel.py and
tests/test_torch_render.py hold the same evaluators: the evaluator's own
per-sample outputs (`PLANE_KEYS`) within 1e-4 abs with at most a tenth
of the samples off by more than 1e-6 (the f32 sums run in another order,
which now and then flips the bf16 rounding of one activation, shown whole
in that sample: measured 5.7e-5); every other key, per ray or a
composite plane, within 1e-5 abs (measured 3.7e-6).

The inputs lie on a dyadic grid (o, d multiples of 1/64, S = 17 samples
at z = k/16): o + d*z is then exact in f32, so XLA's fused multiply-add
and torch's separate product and sum give the same posenc argument and
the same bf16 roundings (tests/test_torch_train_kernel.py says why that
matters). Also: the visibility planes and `compute_world_visibility`,
whose camera inverse is now `torch.linalg.inv_ex` (no host check, so a
CUDA graph captures it), count exactly as the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import raymarch as jraymarch
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.ops import rays as jrays
from nsff_pl_tpu_torch.models import raymarch as traymarch
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.ops import rays as trays
from tests.torch_train_helpers import seeded_params

S, N, N_TAU, N_FRAMES = 17, 12, 16, 4
TOL = 1e-5
PLANE_TOL, PLANE_SHARE = 1e-4, 0.1
PLANE_KEYS = ("static_rgbs_fine", "transient_rgbs_fine",
              "static_sigmas_fine", "transient_sigmas_fine",
              "transient_flows_fw", "transient_flows_bw")
K = np.array([[10.0, 0, 4.0], [0, 10.0, 3.0], [0, 0, 1]], np.float32)
FLOW = ("fw", "bw")


@pytest.fixture(scope="module")
def params():
    return seeded_params(1, N_FRAMES, N_TAU)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    rays = np.zeros((N, 6), np.float32)
    rays[:, 0:2] = rng.randint(-48, 48, (N, 2)) / 64
    rays[:, 2] = -1.0
    rays[:, 3:5] = rng.randint(-12, 12, (N, 2)) / 64
    rays[:, 5] = 2.0
    ts = rng.randint(0, N_FRAMES, N).astype(np.int32)
    poses = np.zeros((1, 3, 4), np.float32)
    poses[0, :, :3] = np.eye(3)
    poses[0, :, 3] = [0.05, -0.02, 0.0]
    return rays, ts, poses


def _kw(compositing):
    return dict(N_samples=S, use_viewdir=True, encode_t=True, N_tau=N_TAU,
                img_wh=(8, 6), planar_eval="on",
                planar_compositing=compositing)


@pytest.fixture(scope="module")
def jax_route(params):
    """The JAX planes route's results, by `output_transient` (with
    visibility where it is on)."""
    pj, _ = params
    rays, ts, poses = _inputs()
    out = {}
    for output_transient in (True, False):
        def route(p, r, t, vis_poses, vis_K, ot=output_transient):
            vis_kw = {"vis_poses": vis_poses, "vis_K": vis_K} if ot else {}
            return jraymarch.render_test_planar(
                p["nerf_fine"], {"t": p["embedding_t"]}, r, t,
                jax.random.PRNGKey(0),
                JRenderConfig(mlp_backend="pallas", **_kw("auto")),
                output_transient=ot, output_transient_flow=FLOW if ot else (),
                **vis_kw)

        out[output_transient] = jax.jit(route)(
            pj, jnp.asarray(rays), jnp.asarray(ts), jnp.asarray(poses),
            jnp.asarray(K))
    return out


@pytest.mark.parametrize("output_transient,compositing,vis", [
    (True, "on", True), (True, "auto", True), (False, "auto", False)])
def test_planes_route_matches_jax(params, jax_route, output_transient,
                                  compositing, vis):
    _, pt = params
    rays, ts, poses = _inputs()
    kw = _kw(compositing)
    flow = FLOW if output_transient else ()
    vis_kw = dict(vis_poses=poses, vis_K=K) if vis else {}
    want = jax_route[output_transient]
    with torch.inference_mode():
        got = traymarch.render_test_planar(
            pt["nerf_fine"], {"t": pt["embedding_t"]},
            torch.from_numpy(rays), torch.from_numpy(ts).long(),
            RenderConfig(**kw), output_transient=output_transient,
            output_transient_flow=flow,
            **{k: torch.from_numpy(v) for k, v in vis_kw.items()})
    assert set(got) == set(want)
    for k in want:
        err = np.abs(got[k].numpy() - np.asarray(want[k]))
        if k in PLANE_KEYS:
            assert err.max() <= PLANE_TOL, (k, err.max())
            assert (err > 1e-6).mean() <= PLANE_SHARE, (k, (err > 1e-6).mean())
        else:
            assert err.max() <= TOL, (k, err.max())


def test_visibility_unchanged_by_inv_ex():
    """`_visibility_planes` and `compute_world_visibility` (both on
    `torch.linalg.inv_ex`) count the same as the JAX package's (on
    `jnp.linalg.inv`) for three cameras, on points inside, beside and
    behind them."""
    rng = np.random.RandomState(3)
    rays, _, _ = _inputs(1)
    zs = np.tile(np.linspace(0, 1, S, dtype=np.float32), (N, 1))
    c2ws = np.zeros((3, 3, 4), np.float32)
    for c in range(3):
        a = rng.uniform(-0.2, 0.2)
        c2ws[c, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        c2ws[c, :, 3] = rng.uniform(-0.1, 0.1, 3)
    o, d = rays[:, :3], rays[:, 3:]
    want = jraymarch._visibility_planes(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(zs), jnp.asarray(K),
                                        (8, 6), c2ws)
    got = traymarch._visibility_planes(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(zs), K, (8, 6), c2ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 3  # some points seen, not all by all
    pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    want = jrays.compute_world_visibility(jnp.asarray(pts), jnp.asarray(K),
                                          6, 8, jnp.asarray(c2ws))
    got = trays.compute_world_visibility(torch.from_numpy(pts), K, 6, 8,
                                         c2ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stratified_depths_equal_jax():
    """The unperturbed depths are the JAX package's bit for bit (XLA's
    linspace: i * (1 / (S - 1)), the last exactly 1), where
    torch.linspace differs by an ulp at some samples: enough to move a
    sample across a visibility border in the eval CLI's renders."""
    from nsff_pl_tpu.ops.sampling import stratified_zs as jzs
    from nsff_pl_tpu_torch.ops.sampling import stratified_zs as tzs

    for s in (8, 16, 128):
        want = np.asarray(jzs(jax.random.PRNGKey(0), 2, s, 0.0)[0])
        got = tzs(2, s, 0.0)[0].numpy()
        np.testing.assert_array_equal(got, want)
