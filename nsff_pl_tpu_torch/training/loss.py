"""The NSFF loss suite (port of `nsff_pl_tpu/training/loss.py`):
`compute_losses` on the reference-shaped result dict of
`models/rendering.py::render_rays`, `compute_losses_planar` on the planar
layout of `models/raymarch.py::render_train_planar`, with the warp terms
of each of its warp variants (exact, `warp_subsample=2`,
`warp_importance`).

Eight terms with epoch schedules: lambda_geo = lambda_geo_init *
0.1**(epoch // 10) for the depth and flow terms, lambda_reg = 0.1,
lambda_ent = 1e-3, and a cross-entropy weight ramping 0 -> lambda_ent / 5
over 10 epochs. Batch-global statistics (median and mean absolute
deviation of the depth loss, the disocclusion means, top-k) are taken
over the whole batch. `epoch` is a Python int, or a device tensor (the
step counter of a captured multi-step dispatch), in which case the
schedules are computed on the device and nothing is read on the host.
On the planar layout per-sample vectors arrive as
3-tuples of dense (N, S) component planes, on the reference-shaped one as
(N, S, 3) tensors. A model without transient branch has the color and
depth terms only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from nsff_pl_tpu_torch.ops import rays as ray_ops

Z_FAR = 0.95


@dataclass(frozen=True)
class LossConfig:
    lambda_geo_init: float = 0.04
    lambda_reg: float = 0.1
    lambda_ent: float = 1e-3
    thickness: int = 1
    topk: float = 1.0
    max_t: int = 29  # N_frames - 1


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor as `jnp.median` takes it: the mean of the
    two middle values for an even count (`torch.median` returns the lower
    one), with the gradient split between them."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def shiftscale_invariant_depthloss(depth, disp):
    """Median/MAD-normalized depth loss; depth (N,) NDC depth, disp (N,)
    image-space disparity, statistics over the whole batch."""
    t_pred = median(depth)
    s_pred = (depth - t_pred).abs().mean()
    t_gt = median(-disp)
    s_gt = (-disp - t_gt).abs().mean()
    pred_n = (depth - t_pred) / s_pred
    gt_n = (-disp - t_gt) / s_gt
    return (pred_n - gt_n) ** 2


def _dilate_along_samples(w, thickness: int):
    """Dilate (N, S) weights with a length-`thickness` ones window along
    the sample axis, zero padding: front (t-1)//2, rear t//2."""
    t = max(thickness, 1)
    if t == 1:
        return w
    pad_l = (t - 1) // 2
    wp = torch.nn.functional.pad(w, (pad_l, t - 1 - pad_l))
    return sum(wp[:, i:i + w.shape[1]] for i in range(t))


def _epoch_weights(epoch, cfg):
    """lambda_geo and the cross-entropy weight at `epoch`: floats for an
    int, f32 device tensors for a tensor."""
    if isinstance(epoch, torch.Tensor):
        e = epoch.to(torch.float32)
        return (cfg.lambda_geo_init * 0.1 ** torch.floor(e / 10.0),
                cfg.lambda_ent / 5 * torch.clamp(e / 10.0, max=1.0))
    return (cfg.lambda_geo_init * 0.1 ** (epoch // 10),
            cfg.lambda_ent / 5 * min(epoch / 10.0, 1.0))


def _masked_mean(x, mask, dim=None):
    """Mean of x over elements where mask, 0 if mask is empty."""
    if dim is None:
        return (x * mask).sum() / torch.clamp((mask).sum(), min=1.0)
    return (x * mask).sum(dim) / torch.clamp(mask.sum(dim), min=1.0)


def _flow_uv_terms(ret, masks, xyz_fw, xyz_bw, batch, cfg, lambda_geo,
                   Ks, Ps):
    """2D flow-consistency terms: project the composited flowed points
    with the t+-1 camera matrices and L1 against the flow targets, as
    masked means over the valid rays."""
    cam_ids = batch["cam_ids"]
    ts = batch["ts"]
    Ks_r = Ks[cam_ids]  # (N, 3, 3)
    xyz_fw_w = ray_ops.ndc2world(xyz_fw, Ks_r)
    xyz_bw_w = ray_ops.ndc2world(xyz_bw, Ks_r)

    def project(xyz_w, ts_p):
        P = Ps[cam_ids, ts_p]  # (N, 3, 4)
        uvd = (P[:, :, :3] * xyz_w[:, None, :]).sum(-1) + P[:, :, 3]
        return uvd, uvd[:, :2] / (uvd[:, 2:].abs() + 1e-8)

    uvd_fw, uv_fw = project(xyz_fw_w, torch.clamp(ts + 1, max=cfg.max_t))
    uvd_bw, uv_bw = project(xyz_bw_w, torch.clamp(ts - 1, min=0))
    valid_fw = ((uvd_fw[:, 2] > 0) & (ts < cfg.max_t)).float()
    valid_bw = ((uvd_bw[:, 2] > 0) & (ts > 0)).float()
    ret["flow_fw_l"] = (lambda_geo / 2) * (uv_fw - batch["uv_fw"]).abs().mean(-1)
    masks["flow_fw_l"] = valid_fw
    ret["flow_bw_l"] = (lambda_geo / 2) * (uv_bw - batch["uv_bw"]).abs().mean(-1)
    masks["flow_bw_l"] = valid_bw
    return Ks_r


def _finalize_terms(ret, masks, weights, cfg):
    """Optional per-ray priority weights, optional top-k hard mining,
    then the mean of each term."""
    out: Dict[str, torch.Tensor] = {}
    for k, per_ray in ret.items():
        if weights is not None:
            per_ray = per_ray * weights
        mask = masks.get(k)
        if cfg.topk < 1.0:
            num_hard = max(int(cfg.topk * per_ray.shape[0]), 1)
            if mask is not None:
                per_ray = torch.where(mask > 0, per_ray,
                                      torch.full_like(per_ray, -torch.inf))
            vals = torch.topk(per_ray, num_hard).values
            finite = torch.isfinite(vals)
            out[k] = _masked_mean(torch.where(finite, vals, 0.0),
                                  finite.float())
        elif mask is not None:
            out[k] = _masked_mean(per_ray, mask)
        else:
            out[k] = per_ray.mean()
    return out


def _colour_depth_terms(results, batch, lambda_geo):
    """The per-ray colour and depth terms; a coarse-to-fine render adds
    0.1 x its coarse colour error and its coarse depth term."""
    rgbs = batch["rgbs"]
    col_l = ((results["rgb_fine"] - rgbs) ** 2).mean(-1)
    if "rgb_coarse" in results:
        col_l = col_l + 0.1 * ((results["rgb_coarse"] - rgbs) ** 2).mean(-1)
    disp_l = lambda_geo * shiftscale_invariant_depthloss(
        results["depth_fine"], batch["disps"])
    if "depth_coarse" in results:
        disp_l = disp_l + lambda_geo * shiftscale_invariant_depthloss(
            results["depth_coarse"], batch["disps"])
    return col_l, disp_l


def compute_losses(
    results: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: LossConfig,
    *,
    epoch,
    output_transient_flow: Tuple[str, ...],
    Ks: Optional[torch.Tensor] = None,
    Ps: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All loss terms as scalars (sum them with `total_loss`), for the
    result dict of `models/rendering.py::render_rays` in train mode. Ks
    (N_cams, 3, 3) and Ps (N_cams, N_frames, 3, 4) serve the flow terms;
    `weights` are optional per-ray priorities."""
    lambda_geo, cross_entropy_w = _epoch_weights(epoch, cfg)

    ret: Dict[str, torch.Tensor] = {}
    masks: Dict[str, torch.Tensor] = {}
    rgbs = batch["rgbs"]
    ret["col_l"], ret["disp_l"] = _colour_depth_terms(results, batch,
                                                      lambda_geo)

    if output_transient_flow:
        tw = results["transient_weights_fine"]  # (N, S)
        ret["entropy_l"] = cfg.lambda_ent * (-tw * torch.log(tw + 1e-8)).sum(-1)
        tr_w = _dilate_along_samples(tw.detach(), cfg.thickness)
        ret["cross_entropy_l"] = cross_entropy_w * (
            tr_w * torch.log(results["static_weights_fine"] + 1e-8)).sum(-1)

        Ks_r = _flow_uv_terms(ret, masks, results["xyz_fw"],
                              results["xyz_bw"], batch, cfg, lambda_geo, Ks,
                              Ps)

        # photometric warping loss, normalized by the batch-mean disocclusion
        pho_l = (results["disocc_fw"] * (results["rgb_fw"] - rgbs) ** 2
                 / results["disocc_fw"].mean())
        pho_l = pho_l + (results["disocc_bw"] * (results["rgb_bw"] - rgbs) ** 2
                         / results["disocc_bw"].mean())
        ret["pho_l"] = pho_l.mean(-1)

        xyzs = results["xyzs_fine"]  # (N, S, 3)
        cyc_l = (results["disoccs_fw"] * (results["xyzs_fw_bw"] - xyzs).abs()
                 / results["disoccs_fw"].mean())
        cyc_l = cyc_l + (results["disoccs_bw"]
                         * (results["xyzs_bw_fw"] - xyzs).abs()
                         / results["disoccs_bw"].mean())
        ret["cyc_l"] = cyc_l.mean((-2, -1))

        n_near = int(xyzs.shape[1] * Z_FAR)  # the static slice
        xyzs_w = ray_ops.ndc2world(xyzs[:, :n_near], Ks_r)
        xyzs_fw_w = ray_ops.ndc2world(results["xyzs_fw"][:, :n_near], Ks_r)
        xyzs_bw_w = ray_ops.ndc2world(results["xyzs_bw"][:, :n_near], Ks_r)
        ret["reg_temp_sm_l"] = cfg.lambda_reg * (
            xyzs_fw_w + xyzs_bw_w - 2 * xyzs_w).abs().mean((-2, -1))
        ret["reg_min_l"] = cfg.lambda_reg * (
            (xyzs_fw_w - xyzs_w).abs()
            + (xyzs_bw_w - xyzs_w).abs()).mean((-2, -1))
        d = torch.linalg.norm(xyzs_w[:, 1:] - xyzs_w[:, :-1], dim=-1,
                              keepdim=True)
        sp_w = torch.exp(-2 * d)
        sf_fw = xyzs_fw_w - xyzs_w
        sf_bw = xyzs_bw_w - xyzs_w
        ret["reg_sp_sm_l"] = cfg.lambda_reg * (
            (sf_fw[:, 1:] - sf_fw[:, :-1]).abs() * sp_w
            + (sf_bw[:, 1:] - sf_bw[:, :-1]).abs() * sp_w).mean((-2, -1))
    return _finalize_terms(ret, masks, weights, cfg)


def _importance_warp_terms(results, rgbs, S: int):
    """pho_l and cyc_l per ray under warp_importance: both directions were
    evaluated on K Horvitz-Thompson-selected rays (`warp_idx`, weights
    `warp_v`); each selected ray's contribution goes back to its ray
    times v (`ht_scatter`), an unbiased estimate of the exact branch's
    per-ray terms, and each disocclusion normaliser is the matching
    estimate of the batch mean (a self-normalised ratio). With
    warp_importance=1.0 both are the exact branch's terms. The scatter
    adds a ray drawn twice in a fixed order (`index_put` with
    accumulate), so a step gives the same bits on every run."""
    idx, v = results["warp_idx"], results["warp_v"]
    n = rgbs.shape[0]
    rgbs_g = rgbs[idx]

    def ht_scatter(contrib):  # (K,) -> (N,)
        return contrib.new_zeros((n,)).index_put((idx,), v * contrib,
                                                 accumulate=True)

    d_fw = results["disocc_fw_g"][:, 0]
    d_bw = results["disocc_bw_g"][:, 0]
    r_fw = ((results["rgb_fw_g"] - rgbs_g) ** 2).mean(-1)
    r_bw = ((results["rgb_bw_g"] - rgbs_g) ** 2).mean(-1)
    den_fw = (v * d_fw).sum() / n
    den_bw = (v * d_bw).sum() / n
    pho = ht_scatter(d_fw * r_fw) / den_fw + ht_scatter(d_bw * r_bw) / den_bw

    cyc_abs_fw = sum((a - b).abs() for a, b in zip(results["xyzs_fw_bw_g"],
                                                   results["xyzs_g"]))
    cyc_abs_bw = sum((a - b).abs() for a, b in zip(results["xyzs_bw_fw_g"],
                                                   results["xyzs_g"]))
    dfs, dbs = results["disoccs_fw_g"], results["disoccs_bw_g"]
    den_fws = (v * dfs.mean(-1)).sum() / n
    den_bws = (v * dbs.mean(-1)).sum() / n
    cyc = (ht_scatter((dfs * cyc_abs_fw).sum(-1)) / den_fws
           + ht_scatter((dbs * cyc_abs_bw).sum(-1)) / den_bws) / (3 * S)
    return pho, cyc


def compute_losses_planar(
    results: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: LossConfig,
    *,
    epoch,
    Ks: torch.Tensor,
    Ps: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """All loss terms as scalars (sum them with `total_loss`), for the
    result dict of `models/raymarch.py::render_train_planar`; a
    coarse-to-fine render adds 0.1 x its coarse colour error to `col_l`
    and its coarse depth term to `disp_l`."""
    lambda_geo, cross_entropy_w = _epoch_weights(epoch, cfg)

    ret: Dict[str, torch.Tensor] = {}
    masks: Dict[str, torch.Tensor] = {}
    rgbs = batch["rgbs"]
    ret["col_l"], ret["disp_l"] = _colour_depth_terms(results, batch,
                                                      lambda_geo)

    tw = results["transient_weights"]  # (N, S)
    ret["entropy_l"] = cfg.lambda_ent * (-tw * torch.log(tw + 1e-8)).sum(-1)
    tr_w = _dilate_along_samples(tw.detach(), cfg.thickness)
    ret["cross_entropy_l"] = cross_entropy_w * (
        tr_w * torch.log(results["static_weights"] + 1e-8)).sum(-1)

    Ks_r = _flow_uv_terms(ret, masks, results["xyz_fw"], results["xyz_bw"],
                          batch, cfg, lambda_geo, Ks, Ps)

    S = tw.shape[1]
    if "rgb_fw_g" in results:
        ret["pho_l"], ret["cyc_l"] = _importance_warp_terms(results, rgbs, S)
    elif "rgb_w" in results:
        # warp_subsample=2: the first half of the rays warped forward, the
        # second backward; each direction's disocclusion normaliser is its
        # half's mean, and each term counts twice, so that the batch mean
        # is the exact fw + bw loss's expectation
        n2 = rgbs.shape[0] // 2
        dw = results["disocc_w"]  # (N, 1)
        pho = dw * (results["rgb_w"] - rgbs) ** 2
        pho = torch.cat([pho[:n2] / dw[:n2].mean(), pho[n2:] / dw[n2:].mean()])
        ret["pho_l"] = 2.0 * pho.mean(-1)
        cyc_abs = sum((a - b).abs() for a, b in zip(results["xyzs_wb"],
                                                    results["xyzs"]))
        dws = results["disoccs_w"]  # (N, S)
        cyc = dws * cyc_abs
        cyc = torch.cat([cyc[:n2] / dws[:n2].mean(),
                         cyc[n2:] / dws[n2:].mean()])
        ret["cyc_l"] = 2.0 * cyc.sum(-1) / (3 * S)
    else:
        # photometric warping loss, normalized by the batch-mean
        # disocclusion
        pho_l = (results["disocc_fw"] * (results["rgb_fw"] - rgbs) ** 2
                 / results["disocc_fw"].mean())
        pho_l = pho_l + (results["disocc_bw"] * (results["rgb_bw"] - rgbs)
                         ** 2 / results["disocc_bw"].mean())
        ret["pho_l"] = pho_l.mean(-1)
        # cycle consistency: mean over (S, 3) of disoccs * |xyz_fw_bw - xyz|
        cyc_abs_fw = sum((a - b).abs() for a, b in zip(results["xyzs_fw_bw"],
                                                       results["xyzs"]))
        cyc_abs_bw = sum((a - b).abs() for a, b in zip(results["xyzs_bw_fw"],
                                                       results["xyzs"]))
        cyc_l = (results["disoccs_fw"] * cyc_abs_fw
                 / results["disoccs_fw"].mean()
                 + results["disoccs_bw"] * cyc_abs_bw
                 / results["disoccs_bw"].mean())
        ret["cyc_l"] = cyc_l.sum(-1) / (3 * S)

    # the static slice: samples below z_far, as reduction masks
    n_near = int(S * Z_FAR)
    col = torch.arange(S, device=tw.device)
    m_near = (col < n_near).float()[None]
    m_diff = (col < n_near - 1).float()[None]

    def ndc2world_planes(planes):
        fx, fy = Ks_r[:, 0:1, 0], Ks_r[:, 1:2, 1]
        cx, cy = Ks_r[:, 0:1, 2], Ks_r[:, 1:2, 2]
        x, y, z = planes
        rz = 2.0 / (z - 1 - 1e-6)
        return (-rz * x * cx / fx, -rz * y * cy / fy, rz)

    xyzs_w = ndc2world_planes(results["xyzs"])
    xyzs_fw_w = ndc2world_planes(results["xyzs_fw"])
    xyzs_bw_w = ndc2world_planes(results["xyzs_bw"])

    ret["reg_temp_sm_l"] = cfg.lambda_reg * sum(
        ((f + b - 2 * x).abs() * m_near).sum(-1)
        for f, b, x in zip(xyzs_fw_w, xyzs_bw_w, xyzs_w)) / (3 * n_near)
    ret["reg_min_l"] = cfg.lambda_reg * sum(
        (((f - x).abs() + (b - x).abs()) * m_near).sum(-1)
        for f, b, x in zip(xyzs_fw_w, xyzs_bw_w, xyzs_w)) / (3 * n_near)

    def adiff(p):  # adiff(p)[:, s] = p[:, s+1] - p[:, s]; 0 at s = S-1
        return torch.cat([p[:, 1:] - p[:, :-1], torch.zeros_like(p[:, :1])],
                         -1)

    dist = torch.sqrt(sum(adiff(x) ** 2 for x in xyzs_w) + 1e-20)
    sp_w = torch.exp(-2 * dist) * m_diff
    ret["reg_sp_sm_l"] = cfg.lambda_reg * sum(
        (((adiff(f - x)).abs() + (adiff(b - x)).abs()) * sp_w).sum(-1)
        for f, b, x in zip(xyzs_fw_w, xyzs_bw_w, xyzs_w)) / (3 * (n_near - 1))
    return _finalize_terms(ret, masks, weights, cfg)


def total_loss(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of all terms."""
    return sum(loss_dict.values())
