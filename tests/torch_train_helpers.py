"""Shared set-up of the port's training-slice tests
(tests/test_torch_train_step.py, tests/test_torch_train_render.py): JAX
weights, a batch, cameras, the JAX renderer's draws rebuilt from its key,
and the gradient comparison. Tolerances and their reasons are in those
files' docstrings."""
import jax
import numpy as np
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu_torch.training import checkpoint as tckpt

N, S, FRAMES, NTAU = 48, 16, 4, 16
LOSS_RTOL = 1e-3
GRAD_FRO, GRAD_MAX = 5e-2, 0.1
UPD_TOL = 1e-3


def jax_params():
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    return {"nerf_fine": jn.init_nerf_params(
                ks[0], "fine", use_viewdir=True, in_channels_t=NTAU,
                encode_transient=True, output_flow=True),
            "embedding_t": jn.init_embedding(ks[1], FRAMES, NTAU)}


def make_rays(rng, n):
    rays = np.zeros((n, 6), np.float32)
    rays[:, 0:2] = rng.rand(n, 2) * 2 - 1
    rays[:, 2] = -1.0 + 0.1 * rng.rand(n)
    rays[:, 3:5] = (rng.rand(n, 2) - 0.5) * 0.4
    rays[:, 5] = 1.0 - rays[:, 2]
    return rays


def make_batch():
    rng = np.random.RandomState(0)
    return {"rays": make_rays(rng, N),
            "ts": rng.randint(0, FRAMES, N).astype(np.int32),
            "rgbs": rng.rand(N, 3).astype(np.float32),
            "disps": rng.rand(N).astype(np.float32),
            "cam_ids": np.zeros((N,), np.int32),
            "uv_fw": rng.rand(N, 2).astype(np.float32),
            "uv_bw": rng.rand(N, 2).astype(np.float32)}


def cams():
    f = 20.0
    Ks = np.array([[[f, 0, 8], [0, f, 8], [0, 0, 1]]], np.float32)
    Ps = np.tile(np.eye(3, 4, dtype=np.float32), (1, FRAMES, 1, 1))
    return Ks, Ps


COMMON = dict(N_samples=S, N_importance=0, perturb=1.0, noise_std=1.0,
              use_viewdir=True, encode_t=True, N_tau=NTAU, max_t=FRAMES - 1,
              compute_dtype="bfloat16", fused_train="on",
              planar_compositing="on")


def jax_draws(key, n):
    """The JAX renderer's draws from its key (see render_train_planar)."""
    k_perturb, _, _, k_rest = jax.random.split(key, 4)
    _, k_fine = jax.random.split(k_rest)
    ks = jax.random.split(k_fine, 4)
    out = {"u": jax.random.uniform(k_perturb, (n, S))}
    out.update({k: jax.random.normal(kk, (n, S))
                for k, kk in zip(("ns", "nt", "nw1", "nw2"), ks)})
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def to_torch(tree):
    return tckpt.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def grads_close(got, want):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= GRAD_MAX * scale, name
        assert (np.linalg.norm(g - w) <= GRAD_FRO * np.linalg.norm(w)
                + 1e-12), name


def seeded_params(seed, n_frames, n_tau):
    """(JAX tree, port dict) of one fine model with a view direction, the
    transient tower and both flow heads, and its t embedding: the port's
    initializer (the JAX package's distributions) drawn from a seeded CPU
    generator, so no eager JAX op has to compile."""
    from nsff_pl_tpu_torch.models import nerf as tn

    g = torch.Generator().manual_seed(seed)
    pt = {"nerf_fine": tn.init_nerf_params(
              g, "fine", use_viewdir=True, encode_transient=True,
              in_channels_t=n_tau, output_flow=True, device="cpu"),
          "embedding_t": tn.init_embedding(g, n_frames, n_tau, device="cpu")}
    return jax.tree.map(jax.numpy.asarray, tckpt.params_to_numpy(pt)), pt
