"""The work counts behind the bounds that `chip_smoke.py` and PERF.md divide
by: `train_fwd_work`, for the train evaluator's forward in the planar
step's three calls at the flagship configuration (D=8, W=256, 63 posenc
lanes, 27 direction lanes, N_tau=48, S=128, batch 512), held to a count
written out from the weight shapes. Runs on the CPU; no kernel runs."""
import importlib.util
from pathlib import Path

import pytest
import torch

from nsff_pl_tpu_torch.models import nerf as tn
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk

REPO = Path(__file__).resolve().parents[1]
N, S = 512, 128
XYZ, DIR, TAU, W = 63, 27, 48, 256


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tower_macs(k0):
    """MACs per sample of an 8-layer tower with input width k0 (skip at
    layer 4) and its 256-wide final layer."""
    return k0 * W + 6 * W * W + (k0 + W) * W + W * W


# padded bf16 weight bytes of a tower and its final layer: layer 0 and the
# skip layer read 128-lane input segments (128 and 128 + 256 rows)
TOWER_W_BYTES = 2 * W * (128 + 6 * W + (128 + W) + W)


@pytest.mark.parametrize("call", ["main", "warp"])
def test_train_fwd_work_counts_the_flagship_shapes(call):
    cs = _chip_smoke()
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=True, encode_transient=True,
                                 output_flow=True, device="cpu")
    op = trk.make_planar_nerf_train(S, use_viewdir=True,
                                    output_flow=("fw", "bw"))
    pw = op.pack(params)
    if call == "main":
        flops, nbytes = cs.train_fwd_work(params, True, 2, N, S, pw, 14,
                                          False)
        per_sample = (_tower_macs(XYZ) + W * W + W * 1 + W * 3
                      + _tower_macs(XYZ + TAU) + W * 10)
        per_ray = DIR * W  # the direction rows of static_dir, once a ray
        weights = (2 * TOWER_W_BYTES + 2 * (128 + W) * W + 2 * W * (1 + 3)
                   + 2 * W * 10 + 4 * (10 * W + 4) + 4 * (9 * W + 10))
        inputs = N * (3 + 3 + S + TAU + DIR) * 4
        outputs = 14 * N * S * 4
    else:  # a warp call: transient only, flows in, one flow head out
        flops, nbytes = cs.train_fwd_work(params, False, 1, N, S, pw, 7,
                                          True)
        per_sample = _tower_macs(XYZ + TAU) + W * 7
        per_ray = 0
        weights = TOWER_W_BYTES + 2 * W * 10 + 4 * (9 * W + 10)
        inputs = N * (3 + 3 + S + 3 * S + TAU) * 4
        outputs = 7 * N * S * 4
    assert flops == 2 * (per_sample * N * S + per_ray * N)
    assert nbytes == inputs + weights + outputs
    # operations, not bytes, bound both calls on the H100
    assert cs.bound(flops, nbytes)[1] == "operations"


WORK_KINDS = ("train_fwd", "train_fwd_packed", "train_bwd_static",
              "train_bwd_transient", "train_bwd_packed", "comp_fwd",
              "comp_bwd", "packed_comp_fwd", "packed_comp_bwd", "eval_comp")


@pytest.mark.parametrize("s", [96, 320])
@pytest.mark.parametrize("kind", WORK_KINDS)
def test_work_counts_the_real_samples(kind, s):
    """Every work count behind a bound counts a ray's real samples, not
    the rows of its padded tiles (a ray of 96 samples runs one tile of
    128 rows, one of 320 three): (flops, bytes) at S is the count at one
    sample plus S - 1 times the count of one more sample, and the train
    forward's main call is the flagship count above at S."""
    cs = _chip_smoke()
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=True, encode_transient=True,
                                 output_flow=True, device="cpu")
    pw = trk.make_planar_nerf_train(S, use_viewdir=True,
                                    output_flow=("fw", "bw")).pack(params)
    ev = trk.make_planar_nerf_eval_comp(S, use_viewdir=True, encode_t=True,
                                        output_flow=("fw", "bw"), vis_in=True)
    work = {
        "train_fwd": lambda n, k: cs.train_fwd_work(params, True, 2, n, k,
                                                    pw, 14, False),
        "train_fwd_packed": lambda n, k: cs.train_fwd_work(
            params, True, 2, n, k, pw, 16, False, packed=True),
        "train_bwd_static": lambda n, k: cs.train_bwd_work(
            params, "static", 2, n, k, pw, False),
        "train_bwd_transient": lambda n, k: cs.train_bwd_work(
            params, "transient", 1, n, k, pw, True),
        "train_bwd_packed": lambda n, k: cs.train_bwd_work(
            params, "transient", 1, n, k, pw, False, packed=True,
            need_dxyz=True),
        "comp_fwd": lambda n, k: cs.comp_work("fwd", n, k),
        "comp_bwd": lambda n, k: cs.comp_work("bwd", n, k),
        "packed_comp_fwd": lambda n, k: cs.packed_comp_work("fwd", n, k),
        "packed_comp_bwd": lambda n, k: cs.packed_comp_work("bwd", n, k),
        "eval_comp": lambda n, k: cs.eval_comp_work(
            params, ev.kernel_kw, n, k, ev.pack(params))}[kind]
    one, two, at_s = work(N, 1), work(N, 2), work(N, s)
    for i in range(2):
        assert at_s[i] == one[i] + (s - 1) * (two[i] - one[i]), (kind, i)
    # below the count of the whole tiles' rows (128 for 96, 384 for 320)
    assert at_s[0] < work(N, -(-s // 128) * 128)[0]
    if kind == "train_fwd":
        per_sample = (_tower_macs(XYZ) + W * W + W * 1 + W * 3
                      + _tower_macs(XYZ + TAU) + W * 10)
        assert at_s[0] == 2 * (per_sample * N * s + DIR * W * N)


# (N_emb_xyz, N_tau, N_emb_dir, N_a or None): the packed evaluator's
# widths past one input segment (three and four segments, the wide
# direction and appearance embeddings), beside the flagship
B5_WIDTHS = {"flagship": (10, 48, 4, None), "n_tau_200": (10, 200, 4, None),
             "n_emb_xyz_43": (43, 48, 4, None),
             "n_emb_xyz_43_n_tau_200": (43, 200, 4, None),
             "n_tau_321": (10, 321, 4, None),
             "dir_22_a_160": (10, 80, 22, 160)}


@pytest.mark.parametrize("width", sorted(B5_WIDTHS))
def test_packed_work_counts_the_unpadded_widths(width):
    """B5's bound at any input width: `train_fwd_work(packed=True)` counts
    model MACs at the unpadded widths (the towers' posenc [+ time latent]
    lanes, the direction and appearance rows of `static_dir` once a ray),
    the inputs read once (points, time latent, direction and appearance
    embeddings), the weights as packed in ceil(lanes / 128) input
    segments, and the (N, S, 16) rows written once."""
    from nsff_pl_tpu_torch.ops import mlp_kernel as tmk

    n_emb, n_tau, n_dir, n_a = B5_WIDTHS[width]
    cs = _chip_smoke()
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 in_channels_xyz=3 + 6 * n_emb,
                                 use_viewdir=True,
                                 in_channels_dir=3 + 6 * n_dir,
                                 encode_appearance=n_a is not None,
                                 in_channels_a=n_a or 48,
                                 encode_transient=True, in_channels_t=n_tau,
                                 output_flow=True, device="cpu")
    fn = tmk.make_fused_nerf_eval(S, use_viewdir=True,
                                  encode_a=n_a is not None, encode_t=True,
                                  output_flow=("fw", "bw"), n_emb_xyz=n_emb,
                                  n_tau=n_tau, n_emb_dir=n_dir, n_a=n_a or 48)
    pw = fn.pack(params)
    flops, nbytes = cs.train_fwd_work(params, True, 2, N, S, pw, 16, False,
                                      packed=True)
    xyz_w, dir_w, a_w = 3 + 6 * n_emb, 3 + 6 * n_dir, n_a or 0
    per_sample = (_tower_macs(xyz_w) + W * W + W * 1 + W * 3
                  + _tower_macs(xyz_w + n_tau) + W * 10)
    per_ray = (dir_w + a_w) * W
    assert flops == 2 * (per_sample * N * S + per_ray * N)
    segs = -(-(xyz_w + n_tau) // 128)
    rows = trk.static_dir_rows(dir_w, a_w, n_a is not None)[1]
    tower = 2 * W * (128 * segs + 6 * W + (128 * segs + W) + W)
    weights = (2 * tower + 2 * rows * W + 2 * W * (1 + 3) + 2 * W * 10
               + 4 * (10 * W + 4) + 4 * (9 * W + 10))
    inputs = N * S * 3 * 4 + N * (n_tau + dir_w + a_w) * 4
    assert nbytes == inputs + weights + 16 * N * S * 4
    assert cs.bound(flops, nbytes)[1] == "operations"
