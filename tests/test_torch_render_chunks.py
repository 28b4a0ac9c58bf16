"""Equal render chunks (`training/step.py::render_full_image(...,
scan_chunks=True)`) against the JAX package's scanned chunk loop and
against the port's own host loop, on the CPU (torch on one thread).

- The chunk plan: the count and size of the chunks each package renders,
  read from trivial renderers that record their chunk, for a 512x288
  frame at 32768 (5 x 29696) and two ragged frames; and the trimmed,
  padded outputs equal.
- A real render (float32, the plain evaluators; visibility culling, a
  fixed view direction and per-sample keys) against JAX's scanned loop
  on the same weights: every key within 3e-6 abs (XLA and torch sum the
  float32 products in another order; measured 1.8e-7).
- Equal chunks against the host loop at the equal chunk size (the same
  padded chunks through the same renderer): bit for bit, and the
  returned tensors are the caller's.

The CUDA graph of the chunks runs on the card only:
tests/test_torch_cuda.py::test_render_chunks_graph_matches_host_loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import step as tstep
from tests.torch_train_helpers import seeded_params

TOL = 3e-6
S, N_TAU, N_FRAMES = 8, 8, 4
K = np.array([[10.0, 0, 4.0], [0, 10.0, 3.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_plan(n, chunk):
    seen = []

    def render(params, r, t, rng, vis_poses, vis_K, vd):
        seen.append(r.shape[0])
        return {"x": r[:, :1] * 2 + t[:, None]}

    rays = jnp.arange(n * 6, dtype=jnp.float32).reshape(n, 6)
    out = jstep.render_full_image(render, None, rays,
                                  jnp.arange(n, dtype=jnp.float32), None,
                                  chunk=chunk, scan_chunks=True)
    return seen[0], np.asarray(out["x"])


def _torch_plan(n, chunk):
    seen = []

    def render(params, r, t, vis_poses, vis_K, vd):
        seen.append(r.shape[0])
        return {"x": r[:, :1] * 2 + t[:, None]}

    render.device = torch.device("cpu")
    rays = torch.arange(n * 6, dtype=torch.float32).reshape(n, 6)
    out = tstep.render_full_image(render, None, rays, torch.arange(n),
                                  chunk=chunk, scan_chunks=True)
    assert set(seen) == {seen[0]}
    return len(seen), seen[0], out["x"].numpy()


@pytest.mark.parametrize("n,chunk,plan", [
    (512 * 288, 32768, (5, 29696)), (70000, 32768, (3, 23552)),
    (5000, 2048, (3, 2048))])
def test_chunk_plan_matches_jax(n, chunk, plan):
    assert tstep.equal_chunks(n, chunk) == plan
    count, size, got = _torch_plan(n, chunk)
    assert (count, size) == plan
    jsize, want = _jax_plan(n, chunk)
    assert jsize == size
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def setup():
    pj, pt = seeded_params(1, N_FRAMES, N_TAU)
    rng = np.random.RandomState(0)
    n = 700  # chunk 256: three equal chunks of 256, the last one padded
    rays = np.zeros((n, 6), np.float32)
    rays[:, 0:2] = rng.rand(n, 2) * 2 - 1
    rays[:, 2] = -1.0
    rays[:, 3:5] = (rng.rand(n, 2) - 0.5) * 0.4
    rays[:, 5] = 2.0
    ts = rng.randint(0, N_FRAMES, n).astype(np.int32)
    poses = np.zeros((1, 3, 4), np.float32)
    poses[0, :, :3] = np.eye(3)
    poses[0, :, 3] = [0.05, -0.02, 0.0]
    view_dir = np.tile(rays[:1, 3:6], (n, 1))
    return pj, pt, rays, ts, poses, view_dir


KEYS = ("rgb_fine", "depth_fine", "transient_alphas_fine",
        "transient_flows_fw")
CFG = dict(N_samples=S, use_viewdir=True, encode_t=True, N_tau=N_TAU,
           img_wh=(8, 6))
RENDER_KW = dict(output_transient=True, output_transient_flow=("fw", "bw"),
                 with_visibility=True, keys=KEYS)


def test_scan_chunks_matches_jax(setup):
    pj, pt, rays, ts, poses, view_dir = setup
    rfn_j = jstep.make_render_fn(JRenderConfig(**CFG), **RENDER_KW)
    want = jstep.render_full_image(
        rfn_j, pj, jnp.asarray(rays), jnp.asarray(ts), jax.random.PRNGKey(0),
        chunk=256, vis_poses=jnp.asarray(poses), vis_K=jnp.asarray(K),
        view_dir=jnp.asarray(view_dir), scan_chunks=True)
    rfn_t = tstep.make_render_fn(RenderConfig(**CFG), device="cpu",
                                 **RENDER_KW)
    got = tstep.render_full_image(
        rfn_t, pt, torch.from_numpy(rays), torch.from_numpy(ts), chunk=256,
        vis_poses=torch.from_numpy(poses), vis_K=torch.from_numpy(K),
        view_dir=torch.from_numpy(view_dir), scan_chunks=True)
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].shape[0] == rays.shape[0]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, rtol=0, err_msg=k)


def test_equal_chunks_equal_host_loop(setup):
    _, pt, rays, ts, poses, view_dir = setup
    rfn = tstep.make_render_fn(RenderConfig(**CFG), device="cpu",
                               **RENDER_KW)
    n = rays.shape[0]
    kw = dict(vis_poses=torch.from_numpy(poses), vis_K=torch.from_numpy(K),
              view_dir=torch.from_numpy(view_dir))
    n_chunks, size = tstep.equal_chunks(n, 300)
    assert (n_chunks, size) == (3, 300)
    scan = tstep.render_full_image(rfn, pt, torch.from_numpy(rays),
                                   torch.from_numpy(ts), chunk=300,
                                   scan_chunks=True, **kw)
    loop = tstep.render_full_image(rfn, pt, torch.from_numpy(rays),
                                   torch.from_numpy(ts), chunk=size, **kw)
    for k in KEYS:
        assert torch.equal(scan[k], loop[k]), k
    before = {k: v.clone() for k, v in scan.items()}
    tstep.render_full_image(rfn, pt, torch.from_numpy(rays[::-1].copy()),
                            torch.from_numpy(ts), chunk=300,
                            scan_chunks=True, **kw)
    for k in KEYS:
        assert torch.equal(scan[k], before[k]), k
