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

Training (`render_train_planar`, the exact branch): the main dual-tower
evaluation with both flow heads and two transient-only evaluations at
the flowed positions and times t+-1 (`make_planar_nerf_train`, three
calls), composited together by the fused compositor
(`ops/compositing_planar_kernel.py`). Every per-sample quantity is a
dense (N, S) plane; sample positions never materialize.

Not ported on these paths, each raising `NotImplementedError` naming its
ROADMAP.md item: coarse-to-fine (`N_importance > 0`), `warp_subsample=2`
and `warp_importance > 0`. Unlike the TPU package there is no lane-width
limit on `N_samples`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from nsff_pl_tpu_torch.models import nerf as nerf_m
from nsff_pl_tpu_torch.models.rendering import Z_FAR, RenderConfig
from nsff_pl_tpu_torch.ops import compositing as cp
from nsff_pl_tpu_torch.ops.compositing_planar_kernel import \
    make_planar_compositor
from nsff_pl_tpu_torch.ops.posenc import posenc
from nsff_pl_tpu_torch.ops.raymarch_kernel import (make_planar_nerf_eval_comp,
                                                   make_planar_nerf_train)
from nsff_pl_tpu_torch.ops.sampling import stratified_zs


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
    output_transient: bool = True,
    output_transient_flow=(),
    vis_poses=None,
    vis_K=None,
    view_dir=None,
    keys=None,
) -> Dict[str, torch.Tensor]:
    """Test-time (no-grad) render on the planar evaluators; the JAX
    function's result keys and values on both of its routes.

    A key filter within `comp_eval_keys` (and `planar_compositing` not
    'off') takes the composited route. Otherwise the planes route
    evaluates dense (N, S) planes and composites them: with
    `output_transient=False` the single-field composite of the static
    tower; else both towers with the flow heads, the visibility culling
    of the transient sigma against `vis_poses` and the two-field
    composite, in the fused compositor where `planar_compositing` is
    'on', or 'auto' on a CUDA device (its warp slots carry the main
    planes, its noises are zero), else in plain PyTorch."""
    if cfg.N_importance > 0:
        raise NotImplementedError(
            "coarse-to-fine test rendering is not ported yet (ROADMAP.md "
            "queue A, 'coarse-to-fine'; needs sample_pdf and the "
            "make_planar_nerf_train forward for the coarse pass)")
    n = rays.shape[0]
    S = cfg.N_samples
    o, d = rays[:, 0:3], rays[:, 3:6]
    flow = (tuple(f for f in output_transient_flow if f in ("fw", "bw"))
            if output_transient else ())

    dir_src = view_dir if view_dir is not None else d
    dir_emb = (posenc(dir_src, cfg.S_emb_dir, cfg.N_emb_dir)
               if cfg.use_viewdir else None)
    zs, _ = stratified_zs(n, S, 0.0, device=rays.device)  # perturb=0
    t_emb = (nerf_m.embedding_lookup(embeddings["t"], ts)
             if output_transient else None)
    encode_a = cfg.encode_a and "a" in embeddings and ts is not None
    a_emb = nerf_m.embedding_lookup(embeddings["a"], ts) if encode_a else None
    kker = dict(n_emb_xyz=cfg.N_emb_xyz, s_emb_xyz=cfg.S_emb_xyz,
                n_emb_dir=cfg.N_emb_dir, n_a=cfg.N_a, n_tau=cfg.N_tau,
                flow_scale=cfg.flow_scale)

    use_comp = (keys is not None and cfg.planar_compositing != "off"
                and set(keys) <= comp_eval_keys(output_transient, flow))
    if use_comp:
        return _composited(params_fine, o, d, zs, dir_emb, a_emb, t_emb,
                           cfg, kker, output_transient=output_transient,
                           flow=flow, encode_a=encode_a,
                           vis_poses=vis_poses, vis_K=vis_K)

    op = make_planar_nerf_train(
        S, use_viewdir=cfg.use_viewdir, encode_a=encode_a,
        encode_t=output_transient, output_flow=flow, **kker)
    out = op(params_fine, o, d, zs, None, dir_emb, a_emb, t_emb)

    res: Dict[str, torch.Tensor] = {"zs_fine": zs}
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
        ck = make_planar_compositor(S)(comp_in)
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


def _composited(params_fine, o, d, zs, dir_emb, a_emb, t_emb, cfg, kker, *,
                output_transient, flow, encode_a, vis_poses, vis_K):
    """The composited route of `render_test_planar`: one (N, M) maps row
    per ray from the composited evaluator."""
    vis_pl = None
    if output_transient and vis_poses is not None:
        vis_pl = _visibility_planes(o, d, zs, vis_K, cfg.img_wh, vis_poses)
    comp_op = make_planar_nerf_eval_comp(
        zs.shape[1], use_viewdir=cfg.use_viewdir, encode_a=encode_a,
        encode_t=output_transient, output_flow=flow,
        vis_in=vis_pl is not None, z_far=Z_FAR, **kker)
    maps = comp_op(params_fine, o, d, zs.contiguous(), vis_pl, dir_emb,
                   a_emb, t_emb)
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


def check_train_envelope(cfg: RenderConfig) -> None:
    """Raise for the train-path variants the port does not have yet."""
    if cfg.N_importance > 0:
        raise NotImplementedError(
            "coarse-to-fine training (N_importance > 0) is not ported yet "
            "(ROADMAP.md queue A, 'coarse-to-fine')")
    if cfg.warp_subsample != 1:
        raise NotImplementedError(
            f"warp_subsample={cfg.warp_subsample} is not ported yet "
            "(ROADMAP.md queue A, 'warp_subsample 2')")
    if cfg.warp_importance:
        raise NotImplementedError(
            f"warp_importance={cfg.warp_importance} is not ported yet "
            "(ROADMAP.md queue A, 'warp_importance')")
    if cfg.planar_compositing not in ("auto", "on"):
        raise NotImplementedError(
            f"planar_compositing={cfg.planar_compositing!r}: the planar "
            "train path composites in its fused compositor only (ROADMAP.md "
            "queue A, 'planar_compositing off'); fused_train='off' "
            "composites outside a kernel")


DRAW_KEYS = ("u", "ns", "nt", "nw1", "nw2")


def render_train_planar(
    params_fine: nerf_m.Params,
    embeddings: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    ts: torch.Tensor,
    cfg: RenderConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Render a training batch with planar layouts; the result dict has
    the JAX function's keys and values on its exact branch:

      - per-ray maps: rgb_fine (N,3), depth_fine (N,), rgb_fw/rgb_bw
        (N,3), xyz_fine/xyz_fw/xyz_bw (N,3), disocc_fw/disocc_bw (N,1)
      - dense planes (N,S): zs, static_weights/transient_weights/weights,
        disoccs_fw/disoccs_bw
      - component-plane 3-tuples of (N,S): xyzs, xyzs_fw, xyzs_bw,
        xyzs_fw_bw, xyzs_bw_fw

    Random draws: `draws` may hold "u" ((N, S) perturb uniforms) and
    "ns", "nt", "nw1", "nw2" ((N, S) standard normals, scaled by
    `noise_std` here: the static, transient, fw-warp and bw-warp sigma
    noises); what it lacks is drawn from `generator` on the rays' device
    in that order. The JAX function draws them from its key `rng` as

        k_perturb, k_pdf_s, k_pdf_t, k_rest = split(rng, 4)
        u = uniform(k_perturb, (N, S))
        k_coarse, k_fine = split(k_rest)
        k_noise_s, k_noise_t, k_fw, k_bw = split(k_fine, 4)
        ns, nt, nw1, nw2 = (normal(k, (N, S)) for k in
                            (k_noise_s, k_noise_t, k_fw, k_bw))

    so a test can rebuild them and pass them in."""
    check_train_envelope(cfg)
    n = rays.shape[0]
    S = cfg.N_samples
    dev = rays.device
    draws = dict(draws or {})
    for k in DRAW_KEYS:
        if k not in draws:
            draws[k] = (torch.rand if k == "u" else torch.randn)(
                (n, S), generator=generator, device=dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    use_viewdir = cfg.use_viewdir
    dir_emb = posenc(d, cfg.S_emb_dir, cfg.N_emb_dir) if use_viewdir else None
    zs, _ = stratified_zs(n, S, cfg.perturb, draws["u"], device=dev)
    zs = zs.contiguous()
    t_emb = nerf_m.embedding_lookup(embeddings["t"], ts)
    encode_a = cfg.encode_a and "a" in embeddings
    a_emb = nerf_m.embedding_lookup(embeddings["a"], ts) if encode_a else None

    def noise(k):
        if cfg.noise_std <= 0:
            return torch.zeros((n, S), device=dev)
        return draws[k] * cfg.noise_std

    kker = dict(n_emb_xyz=cfg.N_emb_xyz, s_emb_xyz=cfg.S_emb_xyz,
                n_emb_dir=cfg.N_emb_dir, n_a=cfg.N_a, n_tau=cfg.N_tau,
                flow_scale=cfg.flow_scale)
    main_op = make_planar_nerf_train(
        S, use_viewdir=use_viewdir, encode_a=encode_a, encode_t=True,
        output_flow=("fw", "bw"), **kker)
    warp_kw = dict(static_branch=False, flow_in=True, encode_t=True, **kker)
    warp_ops = {w: make_planar_nerf_train(S, output_flow=(w,), **warp_kw)
                for w in ("fw", "bw")}
    # one weight packing serves the three evaluations of the step
    pw = main_op.pack(params_fine)

    main = main_op(params_fine, o, d, zs, None, dir_emb, a_emb, t_emb, pw=pw)
    far = zs > Z_FAR  # flow is zeroed beyond z_far
    ffw = tuple(torch.where(far, 0.0, main[k])
                for k in ("ffw_x", "ffw_y", "ffw_z"))
    fbw = tuple(torch.where(far, 0.0, main[k])
                for k in ("fbw_x", "fbw_y", "fbw_z"))

    res: Dict[str, torch.Tensor] = {"zs": zs}
    xyz = tuple(o[:, c:c + 1] + d[:, c:c + 1] * zs for c in range(3))
    res["xyzs"] = xyz
    res["xyzs_fw"] = tuple(x + f for x, f in zip(xyz, ffw))
    res["xyzs_bw"] = tuple(x + f for x, f in zip(xyz, fbw))

    def warp_eval(flows, t_shift, which):
        """The transient field at xyz + flow and time t + t_shift."""
        ts_shift = torch.clamp(ts + t_shift, 0, cfg.max_t)
        t_emb_w = nerf_m.embedding_lookup(embeddings["t"], ts_shift)
        out = warp_ops[which](params_fine, o, d, zs, flows, None, None,
                              t_emb_w, pw=pw)
        flow_back = tuple(torch.where(far, 0.0, out[f"f{which}_{c}"])
                          for c in ("x", "y", "z"))
        return out, flow_back

    out_w1, flowb_fw = warp_eval(ffw, +1, "bw")
    out_w2, flowb_bw = warp_eval(fbw, -1, "fw")

    comp_in = {"zs": zs, "ssig": main["ssig"], "tsig": main["tsig"],
               "tsig_w1": out_w1["tsig"], "tsig_w2": out_w2["tsig"],
               "ns": noise("ns"), "nt": noise("nt"),
               "nw1": noise("nw1"), "nw2": noise("nw2")}
    for c in "rgb":
        comp_in[f"srgb_{c}"] = main[f"srgb_{c}"]
        comp_in[f"trgb_{c}"] = main[f"trgb_{c}"]
        comp_in[f"trgb_w1_{c}"] = out_w1[f"trgb_{c}"]
        comp_in[f"trgb_w2_{c}"] = out_w2[f"trgb_{c}"]
    comp = make_planar_compositor(S)(comp_in)
    sw, tw, w = (comp["static_weights"], comp["transient_weights"],
                 comp["weights"])
    maps = comp["maps"]
    res["rgb_fine"] = maps[:, 0:3]
    res["depth_fine"] = maps[:, 3]
    res["rgb_fw"] = maps[:, 4:7]
    res["rgb_bw"] = maps[:, 7:10]
    res["static_weights"] = sw
    res["transient_weights"] = tw
    res["weights"] = w

    res["xyzs_fw_bw"] = tuple(x + f for x, f in zip(res["xyzs_fw"], flowb_fw))
    res["xyzs_bw_fw"] = tuple(x + f for x, f in zip(res["xyzs_bw"], flowb_bw))

    # composited flow expectations
    res["xyz_fine"] = torch.stack([(w * x).sum(-1) for x in xyz], -1)
    flow_fw_map = torch.stack([(w * f).sum(-1) for f in ffw], -1)
    flow_bw_map = torch.stack([(w * f).sum(-1) for f in fbw], -1)
    res["xyz_fw"] = res["xyz_fine"] + flow_fw_map
    res["xyz_bw"] = res["xyz_fine"] + flow_bw_map

    # disocclusion = 1 - |sum(warped_w - w)|, without gradient
    occ_fw = (comp["tw_w1"] - tw).detach()
    occ_bw = (comp["tw_w2"] - tw).detach()
    res["disocc_fw"] = 1.0 - occ_fw.sum(-1, keepdim=True).abs()
    res["disocc_bw"] = 1.0 - occ_bw.sum(-1, keepdim=True).abs()
    res["disoccs_fw"] = 1.0 - occ_fw.abs()
    res["disoccs_bw"] = 1.0 - occ_bw.abs()
    return res
