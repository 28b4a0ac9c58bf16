"""The port's training loss against the float64 reference equations of
`tools/golden_train_grads.py::ref_train_loss` (an independent numpy
implementation of the reference's three-evaluation warped render and its
eight loss terms), at that tool's --quick shapes (batch 64, S=16, 30
frames, N_tau 48, perturb and noise 0, epoch 2), on the planar path with
the kernels' plain versions in bfloat16, the step the flagship recipe
runs. Loss terms only (the tool's finite differences stay with the JAX
package's test). Tolerance: 1e-2 of max(|term|, 0.01), set from
readings: over the eight input seeds the test runs, the worst term is
4.5e-3 (reg_temp_sm_l, seed 3) and the median seed's worst ~2.3e-3
(bf16 products through eight layers against f64)."""
import os
import sys

import jax
import numpy as np
import torch

from nsff_pl_tpu.training.checkpoint import import_pl_checkpoint
from nsff_pl_tpu_torch.models.raymarch import render_train_planar
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import checkpoint as tckpt
from nsff_pl_tpu_torch.training.loss import (LossConfig,
                                             compute_losses_planar)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tests.test_golden_cross import make_torch_ckpt  # noqa: E402
from tools.golden_train_grads import (EPOCH, N_FRAMES, N_TAU,  # noqa: E402
                                      ref_train_loss)

N, S = 64, 16
TOL = 1e-2
SEEDS = (13, 0, 1, 2, 3, 4, 5, 6)


def term_errors(tmp_path, seed):
    """Each loss term's |port - f64| / max(|f64|, 0.01) on the inputs of
    `seed`."""
    rng = np.random.RandomState(seed)
    ckpt = str(tmp_path / f"golden_train_{seed}.ckpt")
    sd = {k: v.astype(np.float64) for k, v in
          make_torch_ckpt(ckpt, rng, n_tau=N_TAU, n_frames=N_FRAMES).items()}
    rays_o = rng.uniform(-0.5, 0.5, (N, 3))
    rays_o[:, 2] = -1.0
    rays_d = rng.uniform(-0.2, 0.2, (N, 3))
    rays_d[:, 2] = 2.0
    ts = rng.randint(0, N_FRAMES, (N,))
    gt, disps = rng.rand(N, 3), rng.rand(N)
    uv_fw, uv_bw = rng.uniform(-2, 2, (N, 2)), rng.uniform(-2, 2, (N, 2))
    w_img, h_img = 512, 288
    f = 500.0 * w_img / 960
    K = np.array([[f, 0, w_img / 2], [0, f, h_img / 2], [0, 0, 1]])
    Ps = np.tile(np.eye(3, 4), (N_FRAMES, 1, 1))
    Ps[:, 0, 3] = 0.01 * np.arange(N_FRAMES)
    Ps = K @ Ps
    want = ref_train_loss(sd, rays_o, rays_d, ts, gt, disps, uv_fw, uv_bw,
                          K, Ps, S)

    params = tckpt.params_from_jax(
        jax.tree.map(np.asarray, import_pl_checkpoint(ckpt)), "cpu")
    cfg = RenderConfig(N_samples=S, N_importance=0, perturb=0.0,
                       noise_std=0.0, use_viewdir=True, encode_t=True,
                       N_tau=N_TAU, max_t=N_FRAMES - 1, img_wh=(w_img, h_img),
                       compute_dtype="bfloat16", train_backend="pallas",
                       fused_train="on", planar_compositing="on")
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    batch = {"rays": f32(np.concatenate([rays_o, rays_d], -1)),
             "ts": torch.from_numpy(ts).long(), "rgbs": f32(gt),
             "disps": f32(disps), "cam_ids": torch.zeros(N, dtype=torch.long),
             "uv_fw": f32(uv_fw), "uv_bw": f32(uv_bw)}
    with torch.no_grad():
        res = render_train_planar(params["nerf_fine"],
                                  {"t": params["embedding_t"]},
                                  batch["rays"], batch["ts"], cfg,
                                  draws={k: torch.zeros(N, S) for k in
                                         ("u", "ns", "nt", "nw1", "nw2")})
        got = compute_losses_planar(res, batch,
                                    LossConfig(max_t=N_FRAMES - 1),
                                    epoch=EPOCH, Ks=f32(K[None]),
                                    Ps=f32(Ps[None]))
    assert set(got) == set(want) - {"total"}
    return {k: abs(float(v) - want[k]) / max(abs(want[k]), 0.01)
            for k, v in got.items()}


def test_planar_loss_terms_match_the_f64_golden(tmp_path):
    for seed in SEEDS:
        errs = term_errors(tmp_path, seed)
        assert max(errs.values()) <= TOL, (seed, errs)
