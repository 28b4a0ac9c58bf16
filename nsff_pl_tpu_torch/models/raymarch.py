"""Planar renderers (port of `nsff_pl_tpu/models/raymarch.py`).

Test time (`render_test_planar`): one evaluation per sample at the
stratified, unperturbed depths. A key filter within `comp_eval_keys`
takes the composited route: the evaluator composites inside itself
(`ops/raymarch_kernel.py::make_planar_nerf_eval_comp`) and writes one
(N, M) maps row per ray. Any other request takes the planes route: the
trainable evaluator's forward (`make_planar_nerf_train`, no gradient)
writes dense (N, S) planes, the fused compositor
(`ops/compositing_planar_kernel.py`, with the main planes in its warp
slots and zero noises) or the plain composite weighs them, and the
per-sample result keys are assembled at the end.

Training (`render_train_planar`): the main dual-tower evaluation with
both flow heads and the transient-only evaluations at the flowed
positions and times t+-1 (`make_planar_nerf_train`), composited together
by the fused compositor (`ops/compositing_planar_kernel.py`), or in plain
PyTorch with `planar_compositing='off'`. The warps take one of three
forms (`warp_plan`): two calls, one per direction (the exact branch);
`warp_subsample=2`, one call of N rows carrying both flow heads, the
first half warped forward and the second backward; `warp_importance`,
K rays drawn by a Horvitz-Thompson selection (`_importance_select`)
from the composited transient weights, both directions evaluated on them
in one call of 2K rows and composited in a second compositor call on the
K gathered rows. Every per-sample quantity is a dense (N, S) plane;
sample positions never materialize.

Coarse-to-fine (`N_importance > 0`) on both: the coarse model's planar
evaluation at the stratified depths and its own composite, then the
static (and transient) importance draws of `ops/sampling.py::sample_pdf`
from its weights, sorted with the stratified depths into the fine pass's
(N, S_fine) plane: S_fine = N_samples + 2 N_importance in training and
in a test render of both towers, N_samples + N_importance for the static
tower alone. The kernels take S_fine in 64..256. Unlike the TPU package
there is no lane-width limit on `N_samples`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nsff_pl_tpu_torch.models import nerf as nerf_m
from nsff_pl_tpu_torch.models.rendering import Z_FAR, RenderConfig
from nsff_pl_tpu_torch.ops import compositing as cp
from nsff_pl_tpu_torch.ops.compositing_planar_kernel import \
    make_planar_compositor
from nsff_pl_tpu_torch.ops.posenc import posenc
from nsff_pl_tpu_torch.ops.raymarch_kernel import (make_planar_nerf_eval_comp,
                                                   make_planar_nerf_train)
from nsff_pl_tpu_torch.ops.sampling import sample_pdf, stratified_zs
from nsff_pl_tpu_torch.parallel.mesh import shard_rows


def comp_eval_keys(output_transient: bool, flow) -> frozenset:
    """Result keys the composited evaluator serves per ray. A key filter
    that is a subset of this set takes the composited route."""
    ks = {"rgb_fine", "depth_fine"}
    if output_transient:
        ks |= {"transient_rgb_fine", "transient_alpha_fine",
               "_static_rgb_fine", "_static_depth_fine"}
        if "fw" in flow and "bw" in flow:
            ks |= {"xyz_fine", "transient_flow_fw", "transient_flow_bw",
                   "xyz_fw", "xyz_bw"}
    return frozenset(ks)


def _visibility_planes(o, d, zs, K, img_wh, c2ws) -> torch.Tensor:
    """Visibility count of every sample point against the cameras `c2ws`
    ((C, 3, 4)), on (N, S) planes: ndc2world, then the in-frustum test of
    `ops.rays.compute_world_visibility` per camera."""
    w_img, h_img = img_wh
    K = torch.as_tensor(K, dtype=torch.float32, device=zs.device)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X = o[:, 0:1] + d[:, 0:1] * zs
    Y = o[:, 1:2] + d[:, 1:2] * zs
    Z = o[:, 2:3] + d[:, 2:3] * zs
    rz = 2.0 / (Z - 1 - 1e-6)
    wx, wy, wz = -rz * X * cx / fx, -rz * Y * cy / fy, rz

    c2ws = torch.as_tensor(c2ws, dtype=torch.float32, device=zs.device)
    C = c2ws.shape[0]
    c2w4 = torch.eye(4, device=zs.device).repeat(C, 1, 1)
    c2w4[:, :3] = c2ws
    w2c = torch.linalg.inv_ex(c2w4)[0]  # no host check: graph-capturable
    R, t = w2c[:, :3, :3], w2c[:, :3, 3]
    vis = torch.zeros_like(zs)
    for c in range(C):
        px = R[c, 0, 0] * wx + R[c, 0, 1] * wy + R[c, 0, 2] * wz + t[c, 0]
        py = R[c, 1, 0] * wx + R[c, 1, 1] * wy + R[c, 1, 2] * wz + t[c, 1]
        pz = R[c, 2, 0] * wx + R[c, 2, 1] * wy + R[c, 2, 2] * wz + t[c, 2]
        in_front = pz < 0
        # "right down front" projection: (px, -py, -pz)
        uu = fx * px + cx * -pz
        vv = fy * -py + cy * -pz
        dd = -pz
        denom = torch.where(dd.abs() < 1e-8, torch.sign(dd) * 1e-8 + 1e-12,
                            dd)
        u, v = uu / denom, vv / denom
        inside = (u >= 0) & (u < w_img) & (v >= 0) & (v < h_img) & in_front
        vis = vis + inside.float()
    return vis


def render_test_planar(
    params_fine: nerf_m.Params,
    embeddings: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    ts: torch.Tensor,
    cfg: RenderConfig,
    *,
    params_coarse: Optional[nerf_m.Params] = None,
    packed_fine=None,
    output_transient: bool = True,
    output_transient_flow=(),
    vis_poses=None,
    vis_K=None,
    view_dir=None,
    keys=None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Test-time (no-grad) render on the planar evaluators; the JAX
    function's result keys and values on both of its routes.
    `packed_fine` takes the fine model's weights already packed for the
    composited evaluator (its `fn.pack`).

    A key filter within `comp_eval_keys` (and `planar_compositing` not
    'off') takes the composited route. Otherwise the planes route
    evaluates dense (N, S) planes and composites them: with
    `output_transient=False` the single-field composite of the static
    tower; else both towers with the flow heads, the visibility culling
    of the transient sigma against `vis_poses` and the two-field
    composite, in the fused compositor where `planar_compositing` is
    'on', or 'auto' on a CUDA device (its warp slots carry the main
    planes, its noises are zero), else in plain PyTorch.

    With `N_importance > 0` the coarse model `params_coarse` is evaluated
    first (`_coarse_test`) and the fine pass runs at the sorted union of
    the stratified depths and its deterministic importance draws.

    Over a `mesh` (`parallel/mesh.py`) each evaluation (the coarse pass,
    the composited evaluator with its visibility planes, the planes
    route's evaluator) and the fused compositor run on the rank's block
    of rows, their outputs gathered back (`shard_rows`, the JAX
    package's `_shard_planar`); the rest stays global on every rank. The
    rays must divide over the mesh."""
    n = rays.shape[0]
    S = cfg.N_samples
    o, d = rays[:, 0:3], rays[:, 3:6]
    flow = (tuple(f for f in output_transient_flow if f in ("fw", "bw"))
            if output_transient else ())

    dir_src = view_dir if view_dir is not None else d
    dir_emb = (posenc(dir_src, cfg.S_emb_dir, cfg.N_emb_dir)
               if cfg.use_viewdir else None)
    zs, zs_mid = stratified_zs(n, S, 0.0, device=rays.device)  # perturb=0
    t_emb = (nerf_m.embedding_lookup(embeddings["t"], ts)
             if output_transient else None)
    encode_a = cfg.encode_a and "a" in embeddings and ts is not None
    a_emb = nerf_m.embedding_lookup(embeddings["a"], ts) if encode_a else None
    kker = dict(n_emb_xyz=cfg.N_emb_xyz, s_emb_xyz=cfg.S_emb_xyz,
                n_emb_dir=cfg.N_emb_dir, n_a=cfg.N_a, n_tau=cfg.N_tau,
                flow_scale=cfg.flow_scale)

    res: Dict[str, torch.Tensor] = {}
    if cfg.N_importance > 0:
        zs = _coarse_test(res, params_coarse, o, d, zs, zs_mid, dir_emb,
                          t_emb, cfg, kker, output_transient=output_transient,
                          vis_poses=vis_poses, vis_K=vis_K, mesh=mesh)
    Sf = zs.shape[1]  # the fine pass's sample count

    use_comp = (keys is not None and cfg.planar_compositing != "off"
                and set(keys) <= comp_eval_keys(output_transient, flow))
    if use_comp:
        res.update(_composited(params_fine, o, d, zs, dir_emb, a_emb, t_emb,
                               cfg, kker, output_transient=output_transient,
                               flow=flow, encode_a=encode_a,
                               vis_poses=vis_poses, vis_K=vis_K,
                               pw=packed_fine, mesh=mesh))
        return res

    op = make_planar_nerf_train(
        Sf, use_viewdir=cfg.use_viewdir, encode_a=encode_a,
        encode_t=output_transient, output_flow=flow, **kker)
    out = shard_rows(op, mesh)(params_fine, o, d, zs, None, dir_emb, a_emb,
                               t_emb)

    res["zs_fine"] = zs
    xyz = tuple(o[:, c:c + 1] + d[:, c:c + 1] * zs for c in range(3))
    srgb = (out["srgb_r"], out["srgb_g"], out["srgb_b"])

    if not output_transient:
        # single-field composite: static_weights_fine = weights
        d_s, _d_t = cp.deltas_from_zs(zs)
        tau_s = d_s * cp.softplus(out["ssig"])
        w = (1.0 - torch.exp(-tau_s)) * cp.transmittance_from_taus(tau_s)
        res["rgb_fine"] = torch.stack([(w * c).sum(-1) for c in srgb], -1)
        res["depth_fine"] = (w * zs).sum(-1)
        res["xyzs_fine"] = torch.stack(xyz, -1)
        res["static_rgbs_fine"] = torch.stack(srgb, -1)
        res["static_sigmas_fine"] = cp.softplus(out["ssig"])
        res["static_weights_fine"] = w
        return res

    tsig_raw = out["tsig"]
    if vis_poses is not None:
        vis = _visibility_planes(o, d, zs, vis_K, cfg.img_wh, vis_poses)
        tsig_raw = torch.where(vis == 0, -10.0, tsig_raw)

    d_s, d_t = cp.deltas_from_zs(zs)
    tau_s = d_s * cp.softplus(out["ssig"])
    tau_t = d_t * cp.softplus(tsig_raw)
    static_alphas = 1.0 - torch.exp(-tau_s)
    transient_alphas = 1.0 - torch.exp(-tau_t)

    trgb = (out["trgb_r"], out["trgb_g"], out["trgb_b"])
    use_ck = (cfg.planar_compositing == "on"
              or (cfg.planar_compositing == "auto" and rays.is_cuda))
    if use_ck:
        zero = torch.zeros_like(tsig_raw)
        comp_in = {"zs": zs.contiguous(), "ssig": out["ssig"],
                   "tsig": tsig_raw, "tsig_w1": tsig_raw,
                   "tsig_w2": tsig_raw,
                   "ns": zero, "nt": zero, "nw1": zero, "nw2": zero}
        for i, c in enumerate("rgb"):
            comp_in[f"srgb_{c}"] = srgb[i]
            comp_in[f"trgb_{c}"] = trgb[i]
            comp_in[f"trgb_w1_{c}"] = trgb[i]
            comp_in[f"trgb_w2_{c}"] = trgb[i]
        ck = shard_rows(make_planar_compositor(Sf), mesh, whole=0)(comp_in)
        sw, tw, w = (ck["static_weights"], ck["transient_weights"],
                     ck["weights"])
        res["rgb_fine"] = ck["maps"][:, 0:3]
        res["depth_fine"] = ck["maps"][:, 3]
    else:
        alphas = 1.0 - torch.exp(-(tau_s + tau_t))
        trans = cp.transmittance_from_taus(tau_s + tau_t)
        sw = static_alphas * trans
        tw = transient_alphas * trans
        w = alphas * trans
        res["rgb_fine"] = torch.stack(
            [(sw * sc + tw * tc).sum(-1) for sc, tc in zip(srgb, trgb)], -1)
        res["depth_fine"] = (w * zs).sum(-1)
    transient_rgb_map = torch.stack([(tw * c).sum(-1) for c in trgb], -1)
    transient_alpha = tw.sum(-1)
    res["transient_alpha_fine"] = transient_alpha
    # gray background for the transient-only view
    res["transient_rgb_fine"] = (transient_rgb_map
                                 + 0.8 * (1.0 - transient_alpha[:, None]))
    # static-only compositing with its own transmittance
    _sw = static_alphas * cp.transmittance_from_taus(tau_s)
    res["_static_rgb_fine"] = torch.stack([(_sw * c).sum(-1) for c in srgb],
                                          -1)
    res["_static_depth_fine"] = (_sw * zs).sum(-1)

    if flow:
        far = zs > Z_FAR  # flow is zeroed beyond z_far
        ffw = tuple(torch.where(far, 0.0, out[f"ffw_{c}"]) for c in "xyz")
        fbw = tuple(torch.where(far, 0.0, out[f"fbw_{c}"]) for c in "xyz")
        res["xyz_fine"] = torch.stack([(w * x).sum(-1) for x in xyz], -1)
        res["transient_flow_fw"] = torch.stack(
            [(w * f).sum(-1) for f in ffw], -1)
        res["xyz_fw"] = res["xyz_fine"] + res["transient_flow_fw"]
        res["transient_flow_bw"] = torch.stack(
            [(w * f).sum(-1) for f in fbw], -1)
        res["xyz_bw"] = res["xyz_fine"] + res["transient_flow_bw"]
        res["transient_flows_fw"] = torch.stack(ffw, -1)
        res["transient_flows_bw"] = torch.stack(fbw, -1)
    res["xyzs_fine"] = torch.stack(xyz, -1)
    res["static_rgbs_fine"] = torch.stack(srgb, -1)
    res["transient_rgbs_fine"] = torch.stack(trgb, -1)
    res["static_sigmas_fine"] = cp.softplus(out["ssig"])
    res["transient_sigmas_fine"] = cp.softplus(tsig_raw)
    res["static_alphas_fine"] = static_alphas
    res["transient_alphas_fine"] = transient_alphas
    res["static_weights_fine"] = sw
    res["transient_weights_fine"] = tw
    res["weights_fine"] = w
    return res


def _coarse_pass(params_coarse, o, d, zs, dir_emb, t_emb, cfg, kker, *,
                 encode_t, ns=None, nt=None, vis=None, mesh=None):
    """The coarse pass of coarse-to-fine: the coarse model (no appearance,
    no flow heads) on the stratified depths `zs` (sharded by rows over
    `mesh` when given), and its composite with
    the sigma noises `ns` / `nt` (none at test time): both towers, with
    the transient sigma culled where `vis` is 0, or without `encode_t`
    the static tower alone. Returns the model's planes and {"sig_s",
    "sig_t", "tau_s", "tau_t", "sw", "tw", "w"} (sigmas, optical depths,
    static, transient and joint weights; the static tower alone has
    sig_s, tau_s and sw = w)."""
    if params_coarse is None:
        raise ValueError(
            "N_importance > 0 needs params_coarse (the coarse model)")
    coarse_op = make_planar_nerf_train(
        zs.shape[1], use_viewdir=cfg.use_viewdir, encode_a=False,
        encode_t=encode_t, output_flow=(), **kker)
    cout = shard_rows(coarse_op, mesh)(params_coarse, o, d, zs, None, dir_emb,
                                       None, t_emb)
    d_s, d_t = cp.deltas_from_zs(zs)
    sig_s = cp.softplus(cout["ssig"] if ns is None else cout["ssig"] + ns)
    tau_s = d_s * sig_s
    if not encode_t:
        sw = (1.0 - torch.exp(-tau_s)) * cp.transmittance_from_taus(tau_s)
        return cout, {"sig_s": sig_s, "tau_s": tau_s, "sw": sw, "w": sw}
    tsig = cout["tsig"]
    if vis is not None:
        tsig = torch.where(vis == 0, -10.0, tsig)
    sig_t = cp.softplus(tsig if nt is None else tsig + nt)
    tau_t = d_t * sig_t
    trans = cp.transmittance_from_taus(tau_s + tau_t)
    return cout, {"sig_s": sig_s, "sig_t": sig_t, "tau_s": tau_s,
                  "tau_t": tau_t, "sw": (1.0 - torch.exp(-tau_s)) * trans,
                  "tw": (1.0 - torch.exp(-tau_t)) * trans,
                  "w": (1.0 - torch.exp(-(tau_s + tau_t))) * trans}


def _coarse_test(res, params_coarse, o, d, zs, zs_mid, dir_emb, t_emb, cfg,
                 kker, *, output_transient, vis_poses, vis_K, mesh=None):
    """The coarse pass of a coarse-to-fine test render (`_coarse_pass`,
    noise-free, with the visibility culling of the transient sigma when
    `vis_poses` is given; sharded over `mesh`), the coarse result keys
    into `res`, and the deterministic importance draws. Returns the fine
    pass's sorted (N, S_fine) depths."""
    vis = None
    if output_transient and vis_poses is not None:
        vis = _visibility_planes(o, d, zs, vis_K, cfg.img_wh, vis_poses)
    _, c = _coarse_pass(params_coarse, o, d, zs, dir_emb, t_emb, cfg, kker,
                        encode_t=output_transient, vis=vis, mesh=mesh)
    res["zs_coarse"] = zs
    res["xyzs_coarse"] = torch.stack(
        [o[:, i:i + 1] + d[:, i:i + 1] * zs for i in range(3)], -1)
    res["static_sigmas_coarse"] = c["sig_s"]
    # the static tower alone: static_weights_coarse are the weights
    res["static_weights_coarse"] = c["sw"]
    if output_transient:
        res["transient_sigmas_coarse"] = c["sig_t"]
        res["static_alphas_coarse"] = 1.0 - torch.exp(-c["tau_s"])
        res["transient_alphas_coarse"] = 1.0 - torch.exp(-c["tau_t"])
        res["transient_weights_coarse"] = c["tw"]
        res["weights_coarse"] = c["w"]
    zs_list = [zs]
    res["static_zs_fine"] = sample_pdf(zs_mid, c["sw"][:, 1:-1],
                                       cfg.N_importance, det=True)
    zs_list.append(res["static_zs_fine"])
    if output_transient:
        res["transient_zs_fine"] = sample_pdf(zs_mid, c["tw"][:, 1:-1],
                                              cfg.N_importance, det=True)
        zs_list.append(res["transient_zs_fine"])
    return torch.sort(torch.cat(zs_list, -1), -1).values.contiguous()


def _composited(params_fine, o, d, zs, dir_emb, a_emb, t_emb, cfg, kker, *,
                output_transient, flow, encode_a, vis_poses, vis_K,
                pw=None, mesh=None):
    """The composited route of `render_test_planar`: one (N, M) maps row
    per ray from the composited evaluator (on the packed weights `pw`
    when given), its rows and visibility planes sharded over `mesh`."""
    vis_pl = None
    if output_transient and vis_poses is not None:
        vis_pl = _visibility_planes(o, d, zs, vis_K, cfg.img_wh, vis_poses)
    comp_op = make_planar_nerf_eval_comp(
        zs.shape[1], use_viewdir=cfg.use_viewdir, encode_a=encode_a,
        encode_t=output_transient, output_flow=flow,
        vis_in=vis_pl is not None, z_far=Z_FAR, **kker)
    maps = shard_rows(comp_op, mesh)(params_fine, o, d, zs.contiguous(),
                                     vis_pl, dir_emb, a_emb, t_emb, pw=pw)
    cols = comp_op.cols_map

    def col(name):
        s, w_ = cols[name]
        return maps[:, s] if w_ == 1 else maps[:, s:s + w_]

    res = {"rgb_fine": col("rgb_fine"), "depth_fine": col("depth_fine")}
    if output_transient:
        t_alpha = col("transient_alpha")
        res["transient_alpha_fine"] = t_alpha
        # gray background for the transient-only view
        res["transient_rgb_fine"] = (col("transient_rgb_map")
                                     + 0.8 * (1.0 - t_alpha[:, None]))
        res["_static_rgb_fine"] = col("_static_rgb_fine")
        res["_static_depth_fine"] = col("_static_depth_fine")
        if "fw" in flow and "bw" in flow:
            res["xyz_fine"] = col("xyz_fine")
            res["transient_flow_fw"] = col("transient_flow_fw")
            res["transient_flow_bw"] = col("transient_flow_bw")
            res["xyz_fw"] = res["xyz_fine"] + res["transient_flow_fw"]
            res["xyz_bw"] = res["xyz_fine"] + res["transient_flow_bw"]
    return res


def planar_unapplicable_reasons(cfg: RenderConfig, output_transient: bool,
                                output_transient_flow) -> list:
    """Why the planar train path does not cover this configuration (empty
    = applicable). The TPU package's lane-width reasons do not apply."""
    flow = tuple(output_transient_flow)
    reasons = []
    if not (cfg.encode_t and output_transient):
        reasons.append("no transient branch")
    if not ("fw" in flow and "bw" in flow):
        reasons.append("fw+bw flows not both requested")
    return reasons




def warp_plan(cfg: RenderConfig, n: int,
              world: int = 1) -> Tuple[int, float, int]:
    """How a training batch of n rays evaluates its warps: (warp_subsample,
    warp_importance, K), K the rays the importance selection keeps (0
    without it). Raises the JAX package's ValueErrors for the
    combinations it refuses, and, over a mesh of `world` ranks, for a
    batch or a K that does not divide over it (every evaluation is
    sharded by rows)."""
    ws, wi = cfg.warp_subsample, float(cfg.warp_importance)
    if ws not in (1, 2):
        raise ValueError(f"warp_subsample must be 1 or 2, got {ws}")
    if ws == 2 and n % 2:
        raise ValueError("warp_subsample=2 needs an even ray batch")
    if wi and ws != 1:
        raise ValueError(
            "warp_importance and warp_subsample=2 are mutually exclusive")
    if not 0.0 <= wi <= 1.0:
        raise ValueError(f"warp_importance must be in [0, 1], got {wi}")
    if cfg.planar_compositing not in ("auto", "on", "off"):
        raise ValueError(
            f"unknown planar_compositing {cfg.planar_compositing!r}")
    K = max(int(round(wi * n)), 1) if wi else 0
    if n % world:
        raise ValueError(f"a batch of {n} rays does not divide over the "
                         f"{world}-rank mesh")
    if wi and K % world:
        raise ValueError(f"warp_importance={wi}: K = {K} selected rays must "
                         f"divide the {world}-device mesh")
    return ws, wi, K


def draw_shapes(cfg: RenderConfig, n: int) -> Dict[str, tuple]:
    """The random draws of one `render_train_planar` call, in the order
    it takes them from a generator: {key: shape}. The warp noises have
    one row per warped ray: n, or K under `warp_importance`; with
    `warp_subsample=2` one plane carries both directions."""
    S, ni = cfg.N_samples, cfg.N_importance
    sf = S + 2 * ni if ni > 0 else S
    shapes = {"u": (n, S)}
    if ni > 0:
        shapes.update(u_pdf_s=(n, ni), u_pdf_t=(n, ni), ncs=(n, S),
                      nct=(n, S))
    shapes.update(ns=(n, sf), nt=(n, sf))
    ws, wi, K = warp_plan(cfg, n)
    if wi:
        shapes.update(nw1=(K, sf), nw2=(K, sf))
        if K < n:
            shapes["u_sel"] = ()
    elif ws == 2:
        shapes["nw1"] = (n, sf)
    else:
        shapes.update(nw1=(n, sf), nw2=(n, sf))
    return shapes


def _importance_select(scores: torch.Tensor, K: int, u: torch.Tensor):
    """Horvitz-Thompson selection of K ray slots (`warp_importance`), the
    JAX function's: inclusion intensities pi_i ~ K * scores_i /
    sum(scores), four rounds of moving the capped mass onto the rays
    below 1, a support floor of 0.5 / n, then a systematic draw over the
    cumulative pi at offsets (k + u) * scale for the uniform `u` (0-d).
    Returns (idx, v), v = scale / pi[idx], so that sum_k v_k f(idx_k) is
    an unbiased estimate of sum_i f(i). A ray with pi > 1 is drawn more
    than once. K >= n gives the identity with unit weights.

    No gradient, and nothing read on the host; the cumulative sum is
    `data/pipeline.py::blocked_cumsum`, the same bits on every run."""
    from nsff_pl_tpu_torch.data.pipeline import blocked_cumsum

    n, dev = scores.shape[0], scores.device
    if K >= n:
        return (torch.arange(n, device=dev),
                torch.ones((n,), dtype=torch.float32, device=dev))
    s = scores.detach().clamp(min=1e-12)
    pi = K * s / s.sum()
    for _ in range(4):
        capped = (pi >= 1.0).float()
        free_K = K - capped.sum()
        denom = (s * (1.0 - capped)).sum().clamp(min=1e-12)
        pi = torch.where(capped > 0, 1.0, s * free_K / denom)
    pi = pi.clamp(min=0.5 / n)  # every ray stays reachable
    cum = blocked_cumsum(pi)
    scale = cum[-1] / K  # 1 up to the support floor
    pos = (torch.arange(K, dtype=torch.float32, device=dev) + u) * scale
    idx = torch.searchsorted(cum, pos, right=True).clamp(0, n - 1)
    return idx, scale / pi[idx]


def _plain_composite(zs, ssig, tsig, ns, nt, srgb, trgb):
    """The main evaluation's composite in plain PyTorch (the fused
    compositor's work without its warp slots): {"d_t", "tau_s",
    "static_alphas", "sw", "tw", "w", "rgb", "depth"}."""
    d_s, d_t = cp.deltas_from_zs(zs)
    tau_s = d_s * cp.softplus(ssig + ns)
    tau_t = d_t * cp.softplus(tsig + nt)
    static_alphas = 1.0 - torch.exp(-tau_s)
    transient_alphas = 1.0 - torch.exp(-tau_t)
    # alpha = 1 - (1 - a_s)(1 - a_t) = 1 - exp(-(tau_s + tau_t))
    alphas = 1.0 - torch.exp(-(tau_s + tau_t))
    trans = cp.transmittance_from_taus(tau_s + tau_t)
    sw, tw = static_alphas * trans, transient_alphas * trans
    w = alphas * trans
    return {"d_t": d_t, "tau_s": tau_s, "static_alphas": static_alphas,
            "sw": sw, "tw": tw, "w": w,
            "rgb": torch.stack([(sw * sc + tw * tc).sum(-1)
                                for sc, tc in zip(srgb, trgb)], -1),
            "depth": (w * zs).sum(-1)}


def _plain_warp_composite(c, tsig_w, trgb_w, nw, srgb):
    """A warped evaluation composited in plain PyTorch against the static
    field of the main composite `c` (`_plain_composite`): (rgb, its
    transient weights)."""
    tau_w = c["d_t"] * cp.softplus(tsig_w + nw)
    ta_w = 1.0 - torch.exp(-tau_w)
    trans_w = cp.transmittance_from_taus(c["tau_s"] + tau_w)
    sw_w, tw_w = c["static_alphas"] * trans_w, ta_w * trans_w
    return torch.stack([(sw_w * sc + tw_w * tc).sum(-1)
                        for sc, tc in zip(srgb, trgb_w)], -1), tw_w


def _comp_inputs(zs, main, ns, nt, w1, w2, nw1, nw2):
    """The fused compositor's 21 planes: the main evaluation `main` (a
    dict of planes) and the warp slots' (tsig, (r, g, b)) pairs."""
    ins = {"zs": zs, "ssig": main["ssig"], "tsig": main["tsig"],
           "tsig_w1": w1[0], "tsig_w2": w2[0], "ns": ns, "nt": nt,
           "nw1": nw1, "nw2": nw2}
    for i, c in enumerate("rgb"):
        ins[f"srgb_{c}"] = main[f"srgb_{c}"]
        ins[f"trgb_{c}"] = main[f"trgb_{c}"]
        ins[f"trgb_w1_{c}"] = w1[1][i]
        ins[f"trgb_w2_{c}"] = w2[1][i]
    return ins


def render_train_planar(
    params_fine: nerf_m.Params,
    embeddings: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    ts: torch.Tensor,
    cfg: RenderConfig,
    *,
    params_coarse: Optional[nerf_m.Params] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Render a training batch with planar layouts; the result dict has
    the JAX function's keys and values:

      - per-ray maps: rgb_fine (N,3), depth_fine (N,), xyz_fine/xyz_fw/
        xyz_bw (N,3) (+ rgb_coarse (N,3) / depth_coarse (N,) when
        N_importance > 0)
      - dense planes (N,S): zs, static_weights/transient_weights/weights
      - component-plane 3-tuples of (N,S): xyzs, xyzs_fw, xyzs_bw
      - the warp terms' inputs, by warp variant (`warp_plan`):
        exact: rgb_fw/rgb_bw (N,3), disocc_fw/disocc_bw (N,1),
        disoccs_fw/disoccs_bw (N,S), xyzs_fw_bw/xyzs_bw_fw;
        `warp_subsample=2` (rows [0, N/2) warp forward to t+1, rows
        [N/2, N) backward to t-1, in one evaluation carrying both flow
        heads): rgb_w (N,3), disocc_w (N,1), disoccs_w (N,S), xyzs_wb;
        `warp_importance` (K = round(wi N) rays drawn by
        `_importance_select` from the composited transient weights, both
        directions evaluated on them in one 2K-row evaluation):
        warp_idx / warp_v (K,), rgb_fw_g/rgb_bw_g (K,3),
        disocc_fw_g/disocc_bw_g (K,1), disoccs_fw_g/disoccs_bw_g (K,S),
        xyzs_g, xyzs_fw_bw_g, xyzs_bw_fw_g.

    S is N_samples, or S_fine = N_samples + 2 N_importance under
    coarse-to-fine: the coarse model `params_coarse` runs at the
    stratified depths, composites with its own noisy sigmas, and the
    static and transient importance draws from its weights (without
    gradient; deterministic when perturb is 0) join the stratified depths,
    sorted, as the fine pass's depths. The composite runs in the fused
    compositor (`planar_compositing` 'auto' or 'on'; its plain version on
    CPU tensors) or in plain PyTorch ('off').

    Random draws (`draw_shapes` gives their shapes): `draws` may hold "u"
    ((N, S) perturb uniforms), with coarse-to-fine "u_pdf_s", "u_pdf_t"
    ((N, N_importance) importance uniforms) and "ncs", "nct" ((N, S)
    coarse sigma noises), "ns", "nt" ((N, S_fine) static and transient
    sigma noises), "nw1", "nw2" (the fw-warp and bw-warp sigma noises:
    (N, S_fine), under `warp_importance` (K, S_fine), under
    `warp_subsample=2` "nw1" alone) and under `warp_importance` "u_sel"
    (the selection's 0-d uniform); noises are standard normals scaled by
    `noise_std` here. What it lacks is drawn from `generator` on the
    rays' device in `draw_shapes` order. The JAX function draws them
    from its key `rng` as

        k_perturb, k_pdf_s, k_pdf_t, k_rest = split(rng, 4)
        u = uniform(k_perturb, (N, S))
        u_pdf_s, u_pdf_t = (uniform(k, (N, NI)) for k in (k_pdf_s, k_pdf_t))
        k_coarse, k_fine = split(k_rest)
        kc_noise_s, kc_noise_t, _, _ = split(k_coarse, 4)
        ncs, nct = (normal(k, (N, S)) for k in (kc_noise_s, kc_noise_t))
        k_noise_s, k_noise_t, k_fw, k_bw = split(k_fine, 4)
        ns, nt, nw1, nw2 = (normal(k, (rows, S_fine)) for k in
                            (k_noise_s, k_noise_t, k_fw, k_bw))
        u_sel = uniform(fold_in(k_rest, 7), ())

    so a test can rebuild them and pass them in.

    Over a `mesh` (`parallel/mesh.py`) every field evaluation (the coarse
    one, the main one, the warps) and every compositor call runs on the
    rank's block of rows, its outputs gathered back to the global rows
    (`shard_rows`, the JAX package's `shard_map`s); the batch, the draws,
    the warp plan, the selection, `sample_pdf`, the sort and the masks
    stay global on every rank."""
    n = rays.shape[0]
    S = cfg.N_samples
    dev = rays.device
    ws, wi, K = warp_plan(cfg, n, mesh.size if mesh is not None else 1)
    draws = dict(draws or {})
    for k, shape in draw_shapes(cfg, n).items():
        if k not in draws:
            draws[k] = (torch.rand if k.startswith("u") else torch.randn)(
                shape, generator=generator, device=dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    use_viewdir = cfg.use_viewdir
    dir_emb = posenc(d, cfg.S_emb_dir, cfg.N_emb_dir) if use_viewdir else None
    zs, zs_mid = stratified_zs(n, S, cfg.perturb, draws["u"], device=dev)
    zs = zs.contiguous()
    t_emb = nerf_m.embedding_lookup(embeddings["t"], ts)
    encode_a = cfg.encode_a and "a" in embeddings
    a_emb = nerf_m.embedding_lookup(embeddings["a"], ts) if encode_a else None

    def noise(k):
        if cfg.noise_std <= 0:
            return torch.zeros(draws[k].shape, device=dev)
        return draws[k] * cfg.noise_std

    kker = dict(n_emb_xyz=cfg.N_emb_xyz, s_emb_xyz=cfg.S_emb_xyz,
                n_emb_dir=cfg.N_emb_dir, n_a=cfg.N_a, n_tau=cfg.N_tau,
                flow_scale=cfg.flow_scale)
    res: Dict[str, torch.Tensor] = {}
    if cfg.N_importance > 0:
        cout, co = _coarse_pass(params_coarse, o, d, zs, dir_emb, t_emb, cfg,
                                kker, encode_t=True, ns=noise("ncs"),
                                nt=noise("nct"), mesh=mesh)
        res["rgb_coarse"] = torch.stack(
            [(co["sw"] * cout[f"srgb_{c}"] + co["tw"] * cout[f"trgb_{c}"])
             .sum(-1) for c in "rgb"], -1)
        res["depth_coarse"] = (co["w"] * zs).sum(-1)
        det = cfg.perturb == 0
        zs_static = sample_pdf(zs_mid, co["sw"][:, 1:-1].detach(),
                               cfg.N_importance, det=det, u=draws["u_pdf_s"])
        zs_transient = sample_pdf(zs_mid, co["tw"][:, 1:-1].detach(),
                                  cfg.N_importance, det=det,
                                  u=draws["u_pdf_t"])
        zs = torch.sort(torch.cat([zs, zs_static, zs_transient], -1),
                        -1).values.contiguous()
    S = zs.shape[1]  # the fine pass's sample count
    main_op = make_planar_nerf_train(
        S, use_viewdir=use_viewdir, encode_a=encode_a, encode_t=True,
        output_flow=("fw", "bw"), **kker)
    warp_kw = dict(static_branch=False, flow_in=True, encode_t=True, **kker)
    if ws == 2 or wi:
        # one stacked warp evaluation with both flow heads, so that every
        # row reads the opposite direction for the cycle term
        warp_ops = {"both": make_planar_nerf_train(
            S, output_flow=("fw", "bw"), **warp_kw)}
    else:
        warp_ops = {w: make_planar_nerf_train(S, output_flow=(w,), **warp_kw)
                    for w in ("fw", "bw")}
    # one weight packing serves every evaluation of the step
    pw = main_op.pack(params_fine)
    main_op = shard_rows(main_op, mesh)
    warp_ops = {w: shard_rows(op, mesh) for w, op in warp_ops.items()}

    main = main_op(params_fine, o, d, zs, None, dir_emb, a_emb, t_emb, pw=pw)
    far = zs > Z_FAR  # flow is zeroed beyond z_far
    ffw = tuple(torch.where(far, 0.0, main[f"ffw_{c}"]) for c in "xyz")
    fbw = tuple(torch.where(far, 0.0, main[f"fbw_{c}"]) for c in "xyz")
    srgb = tuple(main[f"srgb_{c}"] for c in "rgb")
    trgb = tuple(main[f"trgb_{c}"] for c in "rgb")

    res["zs"] = zs
    xyz = tuple(o[:, c:c + 1] + d[:, c:c + 1] * zs for c in range(3))
    res["xyzs"] = xyz
    res["xyzs_fw"] = tuple(x + f for x, f in zip(xyz, ffw))
    res["xyzs_bw"] = tuple(x + f for x, f in zip(xyz, fbw))

    def t_emb_at(ts_w):
        return nerf_m.embedding_lookup(embeddings["t"],
                                       torch.clamp(ts_w, 0, cfg.max_t))

    n2 = n // 2
    if ws == 2:
        # rows [0, n/2): the fw warp (xyz + flow_fw at t+1); rows
        # [n/2, n): the bw warp (xyz + flow_bw at t-1)
        flows_w = tuple(torch.cat([f[:n2], b[n2:]]) for f, b in zip(ffw, fbw))
        out_w = warp_ops["both"](
            params_fine, o, d, zs, flows_w, None, None,
            t_emb_at(torch.cat([ts[:n2] + 1, ts[n2:] - 1])), pw=pw)
        # the cycle term reads the opposite direction's flow at the warped
        # point: bw on the fw-warped half, fw on the other
        flow_back = tuple(torch.where(far, 0.0, torch.cat(
            [out_w[f"fbw_{c}"][:n2], out_w[f"ffw_{c}"][n2:]]))
            for c in "xyz")
        w_slots = [(out_w["tsig"], tuple(out_w[f"trgb_{c}"] for c in "rgb"))]
    elif not wi:
        outs, flows_back = [], []
        for flows, shift, which in ((ffw, +1, "bw"), (fbw, -1, "fw")):
            out = warp_ops[which](params_fine, o, d, zs, flows, None, None,
                                  t_emb_at(ts + shift), pw=pw)
            outs.append(out)
            flows_back.append(tuple(torch.where(far, 0.0, out[f"f{which}_{c}"])
                                    for c in "xyz"))
        flowb_fw, flowb_bw = flows_back
        w_slots = [(out["tsig"], tuple(out[f"trgb_{c}"] for c in "rgb"))
                   for out in outs]
    else:
        # under warp_importance the warps are evaluated after the main
        # composite, whose transient weights score the rays; the warp
        # slots carry the main planes, their outputs discarded
        w_slots = [(main["tsig"], trgb)]

    ns, nt = noise("ns"), noise("nt")
    nws = [nt] if wi else [noise("nw1")] if ws == 2 else [noise("nw1"),
                                                          noise("nw2")]
    use_ck = cfg.planar_compositing != "off"
    if use_ck:
        compositor = shard_rows(make_planar_compositor(S), mesh, whole=0)
        # a single warp rides both slots; the second slot's outputs are
        # discarded, so their cotangents are zero and nothing is doubled
        comp = compositor(_comp_inputs(zs, main, ns, nt, w_slots[0],
                                       w_slots[-1], nws[0], nws[-1]))
        sw, tw, w = (comp["static_weights"], comp["transient_weights"],
                     comp["weights"])
        maps = comp["maps"]
        res["rgb_fine"] = maps[:, 0:3]
        res["depth_fine"] = maps[:, 3]
        tw_ws = [comp["tw_w1"], comp["tw_w2"]]
        rgb_ws = [maps[:, 4:7], maps[:, 7:10]]
    else:
        c = _plain_composite(zs, main["ssig"], main["tsig"], ns, nt, srgb,
                             trgb)
        sw, tw, w = c["sw"], c["tw"], c["w"]
        res["rgb_fine"], res["depth_fine"] = c["rgb"], c["depth"]
        rgb_ws, tw_ws = [], []
        if not wi:
            for (tsig_w, trgb_w), nw in zip(w_slots, nws):
                rgb_w, tw_w = _plain_warp_composite(c, tsig_w, trgb_w, nw,
                                                    srgb)
                rgb_ws.append(rgb_w)
                tw_ws.append(tw_w)
    res["static_weights"] = sw
    res["transient_weights"] = tw
    res["weights"] = w

    if wi:
        _importance_warps(res, params_fine, warp_ops["both"], pw, o, d, zs,
                          ts, main, ffw, fbw, srgb, xyz, ns, nt, tw, K,
                          draws.get("u_sel"), noise("nw1"), noise("nw2"),
                          compositor if use_ck else None, t_emb_at)
    elif ws == 2:
        res["rgb_w"] = rgb_ws[0]
        # the warped point is xyz + flow_fw on the first half, xyz +
        # flow_bw on the second
        xyz_warp = tuple(torch.cat([f[:n2], b[n2:]]) for f, b in
                         zip(res["xyzs_fw"], res["xyzs_bw"]))
        res["xyzs_wb"] = tuple(x + f for x, f in zip(xyz_warp, flow_back))
    else:
        res["rgb_fw"], res["rgb_bw"] = rgb_ws
        res["xyzs_fw_bw"] = tuple(x + f for x, f in zip(res["xyzs_fw"],
                                                        flowb_fw))
        res["xyzs_bw_fw"] = tuple(x + f for x, f in zip(res["xyzs_bw"],
                                                        flowb_bw))

    # composited flow expectations
    res["xyz_fine"] = torch.stack([(w * x).sum(-1) for x in xyz], -1)
    flow_fw_map = torch.stack([(w * f).sum(-1) for f in ffw], -1)
    flow_bw_map = torch.stack([(w * f).sum(-1) for f in fbw], -1)
    res["xyz_fw"] = res["xyz_fine"] + flow_fw_map
    res["xyz_bw"] = res["xyz_fine"] + flow_bw_map

    # disocclusion = 1 - |sum(warped_w - w)|, without gradient
    if ws == 2:
        _disocclusion(res, "w", tw_ws[0], tw)
    elif not wi:
        _disocclusion(res, "fw", tw_ws[0], tw)
        _disocclusion(res, "bw", tw_ws[1], tw)
    return res


def _disocclusion(res, name, tw_warp, tw, suffix=""):
    """disocc_<name> (N, 1) and disoccs_<name> (N, S) of a warp's
    transient weights against the main ones, without gradient."""
    occ = (tw_warp - tw).detach()
    res[f"disocc_{name}{suffix}"] = 1.0 - occ.sum(-1, keepdim=True).abs()
    res[f"disoccs_{name}{suffix}"] = 1.0 - occ.abs()


def _importance_warps(res, params_fine, warp_op, pw, o, d, zs, ts, main, ffw,
                      fbw, srgb, xyz, ns, nt, tw, K, u_sel, nw1, nw2,
                      compositor, t_emb_at):
    """The warp terms of `warp_importance` into `res`: score each ray by
    its composited transient weight (without gradient) plus 0.05, which
    keeps the static rays in the support, draw K rays
    (`_importance_select`), evaluate both warp directions on them in one
    2K-row evaluation (rows [0, K) fw at t+1, [K, 2K) bw at t-1) and
    composite them against the gathered rays' static field: in the fused
    compositor (a second call, on the K rows) or, with `compositor`
    None, in plain PyTorch."""
    idx, v = _importance_select(tw.detach().sum(-1) + 0.05, K, u_sel)
    res["warp_idx"], res["warp_v"] = idx, v

    zs_g = zs[idx].contiguous()
    ffw_g = tuple(f[idx] for f in ffw)
    fbw_g = tuple(f[idx] for f in fbw)
    far_g = zs_g > Z_FAR
    ts_g = ts[idx]
    o_g, d_g = o[idx], d[idx]

    def two(a):
        return torch.cat([a, a])

    out_w = warp_op(params_fine, two(o_g), two(d_g), two(zs_g),
                    tuple(torch.cat([f, b]) for f, b in zip(ffw_g, fbw_g)),
                    None, None, t_emb_at(torch.cat([ts_g + 1, ts_g - 1])),
                    pw=pw)
    # the cycle term reads the opposite direction's flow at the warped point
    flowb_fw_g = tuple(torch.where(far_g, 0.0, out_w[f"fbw_{c}"][:K])
                       for c in "xyz")
    flowb_bw_g = tuple(torch.where(far_g, 0.0, out_w[f"ffw_{c}"][K:])
                       for c in "xyz")
    w1 = (out_w["tsig"][:K], tuple(out_w[f"trgb_{c}"][:K] for c in "rgb"))
    w2 = (out_w["tsig"][K:], tuple(out_w[f"trgb_{c}"][K:] for c in "rgb"))
    main_g = {k: main[k][idx] for k in ("ssig", "tsig", "srgb_r", "srgb_g",
                                        "srgb_b", "trgb_r", "trgb_g",
                                        "trgb_b")}
    ns_g, nt_g = ns[idx], nt[idx]
    if compositor is not None:
        comp_g = compositor(_comp_inputs(zs_g, main_g, ns_g, nt_g, w1, w2,
                                         nw1, nw2))
        tw_g = comp_g["transient_weights"]
        tw_fw_g, tw_bw_g = comp_g["tw_w1"], comp_g["tw_w2"]
        res["rgb_fw_g"] = comp_g["maps"][:, 4:7]
        res["rgb_bw_g"] = comp_g["maps"][:, 7:10]
    else:
        srgb_g = tuple(main_g[f"srgb_{c}"] for c in "rgb")
        c = _plain_composite(zs_g, main_g["ssig"], main_g["tsig"], ns_g,
                             nt_g, srgb_g, tuple(main_g[f"trgb_{c}"]
                                                 for c in "rgb"))
        tw_g = c["tw"]
        res["rgb_fw_g"], tw_fw_g = _plain_warp_composite(c, *w1, nw1, srgb_g)
        res["rgb_bw_g"], tw_bw_g = _plain_warp_composite(c, *w2, nw2, srgb_g)
    _disocclusion(res, "fw", tw_fw_g, tw_g, "_g")
    _disocclusion(res, "bw", tw_bw_g, tw_g, "_g")
    xyzs_g = tuple(x[idx] for x in xyz)
    res["xyzs_g"] = xyzs_g
    res["xyzs_fw_bw_g"] = tuple(x + f + fb for x, f, fb
                                in zip(xyzs_g, ffw_g, flowb_fw_g))
    res["xyzs_bw_fw_g"] = tuple(x + b + fb for x, b, fb
                                in zip(xyzs_g, fbw_g, flowb_bw_g))
