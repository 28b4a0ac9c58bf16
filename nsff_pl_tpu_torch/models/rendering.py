"""Volumetric renderer with 3-frame scene-flow warping and disocclusion
(port of `nsff_pl_tpu/models/rendering.py::render_rays`).

`render_rays` is the reference-shaped renderer: sample points
materialize as (N, S, 3), one field evaluation returns per-sample colors
and raw sigmas, and the NeRF-W compositing, the two warped transient
evaluations, the maps and the disocclusion weights follow. It serves
every configuration; the planar paths (`models/raymarch.py`) take over
the configurations in their envelope: at test time when
`planar_eval_decision` engages, in training when `make_train_step`
decides so.

The field evaluation has two backends, as in the JAX package: the
hand-written kernels (`ops/mlp_kernel.py` at test time,
`ops/mlp_train_kernel.py` in training, optionally with the fused
compositor `ops/compositing_kernel.py`) and the plain evaluators of
`models/nerf.py` in the compute dtype (float32 or bfloat16).
Coarse-to-fine (`N_importance > 0`) runs one `inference` pass of the
coarse model on the plain evaluators and one of the fine model at the
sorted union of the stratified depths and the importance draws (the
planar paths, `models/raymarch.py`, render it too: at test time
`render_rays` hands it the coarse model). The train backend 'stub' is
the JAX package's profiling stand-in: the fine model's evaluations
(the main one and both warps) become tanh(xyz @ static_xyz_0.w[:3, :16])
(the flows that map's columns 8:14 times 0.01), so that a step timed
with it measures everything but the field; it runs no kernel, by design,
and is no model to train. A `mesh` shards every field evaluation and
the fused compositors by rows (`parallel/mesh.py`), in training and at
test time.

`interpolate` (with `_interp_pre` / `_interp_post`) renders a time
between two rendered frames from their per-sample planes: the eval CLI's
space-time interpolation split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from nsff_pl_tpu_torch.models import nerf as nerf_m
from nsff_pl_tpu_torch.ops import compositing as cp
from nsff_pl_tpu_torch.ops import rays as ray_ops
from nsff_pl_tpu_torch.ops.posenc import posenc
from nsff_pl_tpu_torch.ops.sampling import sample_pdf, stratified_zs
from nsff_pl_tpu_torch.parallel.mesh import shard_rows

Z_FAR = 0.95  # flow is zeroed beyond this NDC depth
# sample rows of one plain evaluation in a test render (`_plain_fields`)
PLAIN_ROWS = 1 << 21


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (names and defaults as in the JAX
    package)."""
    N_samples: int = 128
    N_importance: int = 0
    perturb: float = 1.0
    noise_std: float = 1.0
    use_viewdir: bool = False
    encode_a: bool = False
    encode_t: bool = False
    flow_scale: float = 0.2
    max_t: int = 29  # N_frames - 1
    N_emb_xyz: int = 10
    S_emb_xyz: float = 9.0
    N_emb_dir: int = 4
    S_emb_dir: float = 3.0
    N_tau: int = 48
    N_a: int = 48
    img_wh: Tuple[int, int] = (512, 288)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # accepted for parity with the JAX package and ignored: PyTorch keeps
    # what autograd needs, and the kernels recompute their activations
    remat: bool = False
    # train backend: 'auto' = the hand-written kernels on a CUDA device
    # with bfloat16 compute (the JAX package's Pallas backend on a TPU),
    # the plain f32 evaluators otherwise; 'pallas' forces the kernels (the
    # plain versions on CPU tensors); 'xla' the plain evaluators; 'stub'
    # the profiling stand-in of the field (`stub_field`) on the packed path
    train_backend: str = "auto"
    # the main evaluation's compositing in the fused compositor
    # (ops/compositing_kernel.py) when the kernel train backend is active
    # on the packed path
    fused_compositing: bool = False
    # the fused three-way compositor of the planar paths: in training
    # 'auto' and 'on' use it (its plain version on CPU tensors), 'off'
    # composites in plain PyTorch; on the test-time planes route 'on', or
    # 'auto' on a CUDA device, composites in it, else in plain PyTorch,
    # and 'off' also turns the composited route off
    planar_compositing: str = "auto"
    # planar train path: 'auto' = whenever the kernel train backend is
    # active and the configuration is in its envelope; 'on' forces it;
    # 'off' keeps the packed-boundary path (`render_rays`)
    fused_train: str = "auto"
    # the planar train path's warp evaluation (models/raymarch.py::
    # warp_plan): warp_subsample 2 warps half the rays each way in one
    # evaluation; warp_importance f in (0, 1] evaluates both directions on
    # round(f N) rays drawn by transient weight, with Horvitz-Thompson
    # loss weights; (1, 0.0) is the exact branch
    warp_subsample: int = 1
    warp_importance: float = 0.0
    # planar test-time path: 'auto' = on a CUDA device with bfloat16
    # compute (the JAX package's "TPU + bfloat16"); 'on' forces it (the
    # plain version on CPU tensors); 'off' keeps `render_rays`' own path
    planar_eval: str = "auto"
    # evaluation backend of the test-time path: 'auto' | 'xla' | 'pallas',
    # read like `train_backend`
    mlp_backend: str = "auto"


def planar_eval_decision(cfg: RenderConfig, device) -> Tuple[bool, list]:
    """Whether the planar test path serves a render on `device`, and why
    not otherwise. Returns (engaged, reasons)."""
    if cfg.planar_eval == "off":
        return False, ["planar_eval='off'"]
    if cfg.planar_eval == "on":
        return True, []
    if cfg.planar_eval != "auto":
        raise ValueError(f"unknown planar_eval {cfg.planar_eval!r}")
    eff = _resolve_backend(cfg.mlp_backend, "mlp_backend", cfg, device)
    if eff == "pallas":
        return True, []
    return False, [f"planar_eval='auto' with the {eff} eval backend: the "
                   "kernel path is taken by itself only on a CUDA device "
                   "with bfloat16 compute (pass planar_eval='on' to force it)"]


def _resolve_backend(backend: str, name: str, cfg: RenderConfig,
                     device) -> str:
    """'auto' -> 'pallas' (the kernels) on a CUDA device with bfloat16
    compute, else 'xla' (the plain evaluators); the train backend also
    takes 'stub'."""
    if backend == "stub" and name == "train_backend":
        return backend
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown {name} {backend!r}")
    if backend == "auto":
        return ("pallas" if (torch.device(device).type == "cuda"
                             and cfg.compute_dtype == "bfloat16") else "xla")
    return backend


def _expand(v: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(N, C) per-ray vector -> (N, S, C) per-sample."""
    return v[:, None, :].expand(v.shape[0], n_samples, v.shape[1])


def draw_shapes(cfg: RenderConfig, n: int, *, test_time: bool = False,
                output_transient: bool = True) -> Dict[str, tuple]:
    """The random draws of one `render_rays` call, in the order it takes
    them from a generator: {key: shape}. `output_transient` is the
    effective one (the model's transient branch evaluated)."""
    S, ni = cfg.N_samples, cfg.N_importance
    perturb = 0.0 if test_time else cfg.perturb
    noise_std = 0.0 if test_time else cfg.noise_std
    sf = S + (2 if output_transient else 1) * ni if ni > 0 else S
    shapes = {}
    if perturb > 0:
        shapes["u"] = (n, S)
        if ni > 0:  # the importance draws; evenly spaced when perturb is 0
            shapes["u_pdf_s"] = (n, ni)
            if output_transient:
                shapes["u_pdf_t"] = (n, ni)
    if noise_std > 0:
        if ni > 0:
            shapes.update(ncs=(n, S), nct=(n, S))
        shapes.update({k: (n, sf) for k in ("ns", "nt", "nw1", "nw2")})
    return shapes


def _plain_block(model, xyz, dir_emb, a_emb, t_emb, cfg: RenderConfig,
                 flow, sigma_only: bool, dtype) -> Dict[str, torch.Tensor]:
    """The plain evaluators of `models/nerf.py` at the points xyz
    (N, S, 3) in the compute dtype: static_rgbs (unless `sigma_only`),
    static_sigmas_raw and, with `t_emb`, transient_rgbs (unless
    `sigma_only`), transient_sigmas_raw and flow_<f> for f in `flow`."""
    S = xyz.shape[1]
    xyz_emb = posenc(xyz, cfg.S_emb_xyz, cfg.N_emb_xyz)
    out = {}
    if sigma_only:
        out["static_sigmas_raw"] = nerf_m.static_forward(
            model, xyz_emb, sigma_only=True, use_viewdir=cfg.use_viewdir,
            compute_dtype=dtype)
    else:
        out["static_rgbs"], out["static_sigmas_raw"] = nerf_m.static_forward(
            model, xyz_emb, _expand(dir_emb, S),
            _expand(a_emb, S) if a_emb is not None else None,
            use_viewdir=cfg.use_viewdir, compute_dtype=dtype)
    if t_emb is not None:
        tr = nerf_m.transient_forward(
            model, xyz_emb, _expand(t_emb, S), output_flow=flow,
            sigma_only=sigma_only, flow_scale=cfg.flow_scale,
            compute_dtype=dtype)
        out["transient_sigmas_raw"] = tr["sigma"]
        if not sigma_only:
            out["transient_rgbs"] = tr["rgb"]
            for f in flow:
                out[f"flow_{f}"] = tr[f"flow_{f}"]
    return out


def _plain_fields(model, xyz, dir_emb, a_emb, t_emb, cfg, flow, sigma_only,
                  dtype) -> Dict[str, torch.Tensor]:
    """`_plain_block` over all rays. Without gradient (a test render) it
    runs PLAIN_ROWS sample rows at a time, so that a chunk's activations
    stay small: one (N S, 256) f32 activation of a 32768-ray chunk at
    S = 256 is 8.6 GB."""
    n, S = xyz.shape[0], xyz.shape[1]
    if torch.is_grad_enabled() or n * S <= PLAIN_ROWS:
        return _plain_block(model, xyz, dir_emb, a_emb, t_emb, cfg, flow,
                            sigma_only, dtype)
    step = max(1, PLAIN_ROWS // S)

    def part(v, i):
        return v[i:i + step] if v is not None else None

    parts = [_plain_block(model, xyz[i:i + step], part(dir_emb, i),
                          part(a_emb, i), part(t_emb, i), cfg, flow,
                          sigma_only, dtype) for i in range(0, n, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def stub_field(model, xyz: torch.Tensor) -> torch.Tensor:
    """The 'stub' train backend's stand-in of a field evaluation at the
    points xyz (N, S, 3): tanh(xyz @ static_xyz_0.w[:3, :16]), a map of
    the right width that depends on the params, so that the step's
    backward still runs."""
    return torch.tanh(xyz @ model["static_xyz_0"]["w"][:3, :16])


def render_rays(
    params: Dict[str, Dict],
    embeddings: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    ts: Optional[torch.Tensor],
    cfg: RenderConfig,
    *,
    test_time: bool = True,
    output_transient: bool = True,
    output_transient_flow: Tuple[str, ...] = (),
    vis_poses=None,
    vis_K=None,
    view_dir: Optional[torch.Tensor] = None,
    mesh=None,
    keys: Optional[Tuple[str, ...]] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of (N, 6) NDC rays at frame indices `ts`; the result
    dict has the JAX function's keys.

    params: {'fine': ..., 'coarse'?: ..., 'fine_packed'?: ...};
    embeddings: {'a'?, 't'?}; 'fine_packed' holds the fine model's
    weights already packed for the test-time kernel this configuration
    runs (its evaluator's `fn.pack`: B1's on the planar route, B5's on
    the packed one), which a caller that renders many batches with fixed
    weights packs once (`tools/export_render.py`);
    (N_frames, C) tables; vis_poses ((C, 3, 4)) / vis_K enable the
    test-time visibility culling of the transient sigma; `view_dir`
    overrides the (N, 3) directions of the view embedding; `keys` filters
    the result (and, on the planar test path, picks the composited
    route).

    With `N_importance > 0` the coarse model runs first at the stratified
    depths, always on the plain evaluators in the compute dtype (sigma
    only at test time), and composites; the static (and transient)
    importance draws of `sample_pdf` from its weights (without gradient;
    evenly spaced when the effective perturb is 0) join the stratified
    depths, sorted, as the fine pass's S_fine = N_samples + N_importance
    (static tower alone) or N_samples + 2 N_importance depths. The coarse
    keys (`*_coarse`, and at test time `static_zs_fine` /
    `transient_zs_fine`) join the result.

    Random draws (training only: perturb and sigma noise are 0 at test
    time): `draws` may hold the keys `draw_shapes` lists, "u" ((N, S)
    perturb uniforms), "u_pdf_s", "u_pdf_t" ((N, N_importance)
    importance uniforms), "ncs", "nct" ((N, S) coarse sigma noises) and
    "ns", "nt", "nw1", "nw2" ((N, S_fine) standard normals: the static,
    transient, fw-warp and bw-warp sigma noises), noises scaled by
    `noise_std` here; what it lacks is drawn from `generator` on the
    rays' device in `draw_shapes` order. The JAX function draws them from
    its key `rng` as

        k_perturb, k_pdf_s, k_pdf_t, k_rest = split(rng, 4)
        u = uniform(k_perturb, (N, S))
        u_pdf_s, u_pdf_t = (uniform(k, (N, NI)) for k in (k_pdf_s, k_pdf_t))
        k_coarse, k_fine = split(k_rest)
        kc_noise_s, kc_noise_t, _, _ = split(k_coarse, 4)
        ncs, nct = (normal(k, (N, S)) for k in (kc_noise_s, kc_noise_t))
        k_noise_s, k_noise_t, k_fw, k_bw = split(k_fine, 4)
        ns, nt, nw1, nw2 = (normal(k, (N, S_fine)) for k in
                            (k_noise_s, k_noise_t, k_fw, k_bw))

    so a test can rebuild them and pass them in.

    Over a `mesh` (`parallel/mesh.py`), in training and at test time,
    every field evaluation (the kernels', the plain evaluators', the
    stub's, the coarse pass's and the warps') and the fused compositors
    run on the rank's block of rows, their outputs gathered back to the
    global rows (`shard_rows`); the rest, a `view_dir` override's
    embedding included, stays global on every rank and is cut with the
    rays where an evaluation takes it. `vis_poses`, `vis_K` and
    `params["fine_packed"]` pass whole. The rays must divide over the
    mesh."""
    output_transient = output_transient and cfg.encode_t
    flow = tuple(output_transient_flow) if output_transient else ()
    dev = rays.device

    if test_time and planar_eval_decision(cfg, dev)[0]:
        from nsff_pl_tpu_torch.models import raymarch

        out = raymarch.render_test_planar(
            params["fine"], embeddings, rays, ts, cfg,
            params_coarse=params.get("coarse"),
            packed_fine=params.get("fine_packed"),
            output_transient=output_transient, output_transient_flow=flow,
            vis_poses=vis_poses, vis_K=vis_K, view_dir=view_dir, keys=keys,
            mesh=mesh)
        if keys is not None:
            out = {k: v for k, v in out.items() if k in keys}
        return out

    if cfg.N_importance > 0 and params.get("coarse") is None:
        raise ValueError(
            "N_importance > 0 needs params['coarse'] (the coarse model)")
    # the kernels compute in bf16; 'auto' selects them only when the caller
    # asked for bf16 compute, so a float32 render keeps its precision
    backend = _resolve_backend(cfg.mlp_backend, "mlp_backend", cfg, dev)
    tbackend = _resolve_backend(cfg.train_backend, "train_backend", cfg, dev)
    use_kernel_eval = backend == "pallas" and test_time
    use_kernel_train = tbackend == "pallas" and not test_time
    # float32 computes in the rays' dtype (float64 rays: a float64 render)
    cdtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              else rays.dtype)

    n_rays, S = rays.shape[0], cfg.N_samples
    perturb = 0.0 if test_time else cfg.perturb
    noise_std = 0.0 if test_time else cfg.noise_std
    draws = dict(draws or {})
    for k, shape in draw_shapes(cfg, n_rays, test_time=test_time,
                                output_transient=output_transient).items():
        if k not in draws:
            draws[k] = (torch.rand if k.startswith("u") else torch.randn)(
                shape, generator=generator, device=dev)

    def noise(k):
        return draws[k] * noise_std if noise_std > 0 else None

    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    dir_embedded = posenc(view_dir if view_dir is not None else rays_d,
                          cfg.S_emb_dir, cfg.N_emb_dir)
    zs, zs_mid = stratified_zs(n_rays, S, perturb, draws.get("u"), device=dev)
    t_embedded = (nerf_m.embedding_lookup(embeddings["t"], ts)
                  if output_transient else None)
    has_a = cfg.encode_a and ts is not None
    a_embedded = (nerf_m.embedding_lookup(embeddings["a"], ts)
                  if has_a else None)
    kker = dict(n_emb_xyz=cfg.N_emb_xyz, s_emb_xyz=cfg.S_emb_xyz,
                n_emb_dir=cfg.N_emb_dir, n_a=cfg.N_a, n_tau=cfg.N_tau,
                flow_scale=cfg.flow_scale)
    results: Dict[str, torch.Tensor] = {}

    def inference(model, typ, xyz, zs, flow, nkeys):
        """One field evaluation and compositing pass; its keys go into
        `results` with the suffix `typ`. The fine pass runs on the
        kernels where their backend is active, the coarse pass on the
        plain evaluators (sigma only at test time)."""
        Sx = xyz.shape[1]
        fine = typ == "fine"
        sigma_only = test_time and not fine
        this_flow = tuple(f for f in flow if f in ("fw", "bw"))
        kernel_train = use_kernel_train and fine
        # the profiling stand-in's map of the points (`stub_field`)
        stub = tbackend == "stub" and not test_time and fine
        has_a_ = has_a and fine
        results[f"zs_{typ}"] = zs
        results[f"xyzs_{typ}"] = xyz
        packed = pw = static_rgbs = transient_rgbs = None
        if stub:
            packed = shard_rows(stub_field, mesh)(model, xyz)
            static_rgbs = packed[..., 0:3]
            static_sigmas_raw = packed[..., 3]
            if output_transient:
                transient_rgbs = packed[..., 4:7]
                transient_sigmas_raw = packed[..., 7]
                raw_flows = {"fw": 0.01 * packed[..., 8:11],
                             "bw": 0.01 * packed[..., 11:14]}
        elif (use_kernel_eval and fine) or kernel_train:
            from nsff_pl_tpu_torch.ops import mlp_kernel as mk

            if kernel_train:
                from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

                # need_dxyz=False: the main evaluation's points are
                # ray-derived (no parameter dependence), so their
                # cotangent is dead
                field = mtk.make_fused_nerf_train(
                    Sx, use_viewdir=cfg.use_viewdir, encode_a=has_a_,
                    encode_t=output_transient, output_flow=this_flow,
                    need_dxyz=False, **kker)
            else:
                field = mk.make_fused_nerf_eval(
                    Sx, use_viewdir=cfg.use_viewdir, encode_a=has_a_,
                    encode_t=output_transient, output_flow=this_flow, **kker)
            # one weight packing serves the main and both warped evaluations
            pw = params.get("fine_packed") if use_kernel_eval else None
            if pw is None:
                pw = field.pack(model)
            packed = shard_rows(field, mesh)(
                model, xyz, dir_embedded if cfg.use_viewdir else None,
                a_embedded, t_embedded, pw=pw)
            un = mk.unpack_fused(packed, encode_t=output_transient,
                                 output_flow=this_flow)
            static_rgbs = un["static_rgbs"]
            static_sigmas_raw = un["static_sigmas_raw"]
            if output_transient:
                transient_rgbs = un["transient_rgbs"]
                transient_sigmas_raw = un["transient_sigmas_raw"]
                raw_flows = {f: un[f"transient_flows_{f}"]
                             for f in this_flow}
        else:
            pf = shard_rows(
                lambda m, x, de, ae, te: _plain_fields(
                    m, x, de, ae, te, cfg, this_flow, sigma_only, cdtype),
                mesh)(model, xyz, dir_embedded,
                      a_embedded if has_a_ else None, t_embedded)
            static_rgbs = pf.get("static_rgbs")
            static_sigmas_raw = pf["static_sigmas_raw"]
            if output_transient:
                transient_rgbs = pf.get("transient_rgbs")
                transient_sigmas_raw = pf["transient_sigmas_raw"]
                raw_flows = {f: pf[f"flow_{f}"] for f in this_flow}
        if static_rgbs is not None:
            results[f"static_rgbs_{typ}"] = static_rgbs
        if output_transient:
            if transient_rgbs is not None:
                results[f"transient_rgbs_{typ}"] = transient_rgbs
            if "fw" in this_flow:
                far_mask = (zs > Z_FAR)[..., None]
                transient_flows_fw = torch.where(far_mask, 0.0,
                                                 raw_flows["fw"])
                transient_flows_bw = torch.where(far_mask, 0.0,
                                                 raw_flows["bw"])
                results["transient_flows_fw"] = transient_flows_fw
                results["transient_flows_bw"] = transient_flows_bw

        # test-time visibility culling of the transient sigma
        if test_time and output_transient and vis_poses is not None:
            w_img, h_img = cfg.img_wh
            xyz_w = ray_ops.ndc2world(xyz.reshape(-1, 3), vis_K)
            vis = ray_ops.compute_world_visibility(xyz_w, vis_K, h_img,
                                                   w_img, vis_poses)
            transient_sigmas_raw = torch.where(
                vis.reshape(transient_sigmas_raw.shape) == 0, -10.0,
                transient_sigmas_raw)

        static_deltas, transient_deltas = cp.deltas_from_zs(zs)
        # fused compositing: the sigma -> alpha -> transmittance ->
        # weights -> maps chain in one kernel pair on the evaluator's
        # packed output
        comp = None
        if kernel_train and output_transient and cfg.fused_compositing:
            from nsff_pl_tpu_torch.ops.compositing_kernel import \
                make_fused_compositing

            zero = torch.zeros((n_rays, Sx), device=dev)
            comp = shard_rows(make_fused_compositing(Sx), mesh, whole=0)(
                packed, zs, zero if noise_std <= 0 else noise(nkeys[0]),
                zero if noise_std <= 0 else noise(nkeys[1]))
            static_sigmas = comp["static_sigmas"]
            transient_sigmas = comp["transient_sigmas"]
            static_alphas = comp["static_alphas"]
            transient_alphas = comp["transient_alphas"]
        else:
            ns = noise(nkeys[0])
            static_sigmas = cp.softplus(
                static_sigmas_raw + ns if ns is not None
                else static_sigmas_raw)
            static_alphas = 1.0 - torch.exp(-static_deltas * static_sigmas)
            if output_transient:
                nt = noise(nkeys[1])
                transient_sigmas = cp.softplus(
                    transient_sigmas_raw + nt if nt is not None
                    else transient_sigmas_raw)
                transient_alphas = 1.0 - torch.exp(
                    -transient_deltas * transient_sigmas)
        results[f"static_sigmas_{typ}"] = static_sigmas
        if output_transient:
            results[f"transient_sigmas_{typ}"] = transient_sigmas

        if output_transient and not test_time and "fw" in flow:
            def warp(xyz_w_pts, t_shift, which_flow, noise_key):
                """The transient field at the warped points and time,
                composited against the current static field."""
                ts_shift = torch.clamp(ts + t_shift, 0, cfg.max_t)
                t_emb_ray = nerf_m.embedding_lookup(embeddings["t"],
                                                    ts_shift)
                if stub:
                    pk = shard_rows(stub_field, mesh)(model, xyz_w_pts)
                    tr_w = {"rgb": pk[..., 4:7], "sigma": pk[..., 7],
                            f"flow_{which_flow}": 0.01 * pk[..., 8:11]}
                elif kernel_train:
                    ft_w = mtk.make_fused_nerf_train(
                        Sx, use_viewdir=cfg.use_viewdir, encode_a=False,
                        encode_t=True, output_flow=(which_flow,),
                        static_branch=False, **kker)
                    pk = shard_rows(ft_w, mesh)(model, xyz_w_pts, None, None,
                                                t_emb_ray, pw=pw)
                    tr_w = {"rgb": pk[..., 4:7], "sigma": pk[..., 7],
                            f"flow_{which_flow}": pk[..., 8:11]}
                else:
                    tr_w = shard_rows(
                        lambda m, x, te: nerf_m.transient_forward(
                            m, posenc(x, cfg.S_emb_xyz, cfg.N_emb_xyz),
                            _expand(te, Sx), output_flow=(which_flow,),
                            flow_scale=cfg.flow_scale, compute_dtype=cdtype),
                        mesh)(model, xyz_w_pts, t_emb_ray)
                flows_w = torch.where((zs > Z_FAR)[..., None], 0.0,
                                      tr_w[f"flow_{which_flow}"])
                tr_alphas_w = cp.sigma2alpha(tr_w["sigma"], transient_deltas,
                                             noise(noise_key))
                static_w_w, transient_w_w, _, _ = cp.composite_two_fields(
                    static_alphas, tr_alphas_w)
                rgb_map_w = (cp.weighted_sum(static_w_w, static_rgbs)
                             + cp.weighted_sum(transient_w_w, tr_w["rgb"]))
                return rgb_map_w, flows_w, transient_w_w

            xyz_fw = xyz + transient_flows_fw
            results["xyzs_fw"] = xyz_fw
            results["rgb_fw"], tr_flows_fw_bw, transient_weights_fw = warp(
                xyz_fw, +1, "bw", nkeys[2])
            xyz_bw = xyz + transient_flows_bw
            results["xyzs_bw"] = xyz_bw
            results["rgb_bw"], tr_flows_bw_fw, transient_weights_bw = warp(
                xyz_bw, -1, "fw", nkeys[3])
            results["xyzs_fw_bw"] = xyz_fw + tr_flows_fw_bw
            results["xyzs_bw_fw"] = xyz_bw + tr_flows_bw_fw

        if comp is not None:
            static_weights = comp["static_weights"]
            transient_weights = comp["transient_weights"]
            weights = comp["weights"]
        elif output_transient:
            static_weights, transient_weights, weights, _ = \
                cp.composite_two_fields(static_alphas, transient_alphas)
        else:
            static_weights = weights = cp.composite_one_field(static_alphas)
        results[f"static_weights_{typ}"] = static_weights
        if output_transient:
            results[f"transient_weights_{typ}"] = transient_weights
            results[f"weights_{typ}"] = weights
            if test_time:
                results[f"static_alphas_{typ}"] = static_alphas
                results[f"transient_alphas_{typ}"] = transient_alphas
        if sigma_only:
            return  # the coarse pass at test time ends with its weights

        results[f"depth_{typ}"] = (comp["depth"] if comp is not None
                                   else cp.weighted_sum(weights, zs))
        if not output_transient:
            results[f"rgb_{typ}"] = cp.weighted_sum(weights, static_rgbs)
            return
        transient_rgb_map = cp.weighted_sum(transient_weights,
                                            transient_rgbs)
        if comp is not None:
            results[f"rgb_{typ}"] = comp["rgb"]
        else:
            results[f"rgb_{typ}"] = cp.weighted_sum(
                static_weights, static_rgbs) + transient_rgb_map
        transient_alpha = transient_weights.sum(-1)
        results[f"transient_alpha_{typ}"] = transient_alpha
        # gray background for the transient-only view
        results[f"transient_rgb_{typ}"] = (
            transient_rgb_map + 0.8 * (1.0 - transient_alpha[:, None]))
        # static-only compositing with its own transmittance
        _static_weights = cp.composite_one_field(static_alphas)
        results[f"_static_rgb_{typ}"] = cp.weighted_sum(_static_weights,
                                                        static_rgbs)
        results[f"_static_depth_{typ}"] = cp.weighted_sum(_static_weights,
                                                          zs)
        if not flow:
            return
        results["xyz_fine"] = cp.weighted_sum(weights, xyz)
        results["transient_flow_fw"] = cp.weighted_sum(weights,
                                                       transient_flows_fw)
        results["xyz_fw"] = results["xyz_fine"] + results["transient_flow_fw"]
        results["transient_flow_bw"] = cp.weighted_sum(weights,
                                                       transient_flows_bw)
        results["xyz_bw"] = results["xyz_fine"] + results["transient_flow_bw"]
        if not test_time and "disocc" in flow:
            # disocclusion = 1 - |sum(warped_w - w)|, without gradient
            occ_fw = (transient_weights_fw - transient_weights).detach()
            occ_bw = (transient_weights_bw - transient_weights).detach()
            results["disocc_fw"] = 1.0 - occ_fw.sum(-1, keepdim=True).abs()
            results["disoccs_fw"] = 1.0 - occ_fw[..., None].abs()
            results["disocc_bw"] = 1.0 - occ_bw.sum(-1, keepdim=True).abs()
            results["disoccs_bw"] = 1.0 - occ_bw[..., None].abs()

    if cfg.N_importance > 0:
        xyz_coarse = rays_o[:, None] + rays_d[:, None] * zs[..., None]
        inference(params["coarse"], "coarse", xyz_coarse, zs, (),
                  ("ncs", "nct"))
        # the reference keys det off the effective perturb: 0 at test time
        det = perturb == 0
        zs_static = sample_pdf(
            zs_mid, results["static_weights_coarse"][:, 1:-1].detach(),
            cfg.N_importance, det=det, u=draws.get("u_pdf_s"))
        zs_list = [zs, zs_static]
        if test_time:
            results["static_zs_fine"] = zs_static
        if output_transient:
            zs_transient = sample_pdf(
                zs_mid, results["transient_weights_coarse"][:, 1:-1].detach(),
                cfg.N_importance, det=det, u=draws.get("u_pdf_t"))
            zs_list.append(zs_transient)
            if test_time:
                results["transient_zs_fine"] = zs_transient
        zs = torch.sort(torch.cat(zs_list, -1), -1).values
    xyz = rays_o[:, None] + rays_d[:, None] * zs[..., None]
    inference(params["fine"], "fine", xyz, zs, flow,
              ("ns", "nt", "nw1", "nw2"))
    if keys is not None:
        results = {k: v for k, v in results.items() if k in keys}
    return results


def _interp_pre(xyzs, flows_fw, flows_bw, rgba_t, rgba_tp1, dt: float, K,
                c2w, *, w: int, h: int):
    """Everything in `interpolate` upstream of the splat: the per-plane
    projected optical flows and the stacked transient planes of both warp
    directions, in planar layout: planes (2S, 4, h, w), flow components
    (2S, h, w)."""
    S = xyzs.shape[1]
    dev = xyzs.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    # projection matrix ("right up back" -> "right down forward")
    c2w4 = torch.eye(4, device=dev)
    c2w4[:3] = c2w
    w2c = torch.linalg.inv_ex(c2w4)[0][:3]
    w2c = w2c * torch.tensor([[1.0], [-1.0], [-1.0]], device=dev)
    P = K @ w2c  # (3, 4)

    def comps(a):  # (hw, S, C) -> C planar (S, h, w) components
        return tuple(a.permute(2, 1, 0).reshape(a.shape[2], -1, h, w))

    X, Y, Z = comps(xyzs)
    kfx, kfy, kcx, kcy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    eps = 1e-6

    def ndc2world_c(x, y, z):
        """Componentwise `ops.rays.ndc2world`."""
        rz = 2.0 / (z - 1 - eps)
        return -rz * x * kcx / kfx, -rz * y * kcy / kfy, rz

    def plane_flow(flows_3d, scale):
        """3D scene flow -> per-plane 2D optical flow by projection, as
        planar (S, h, w) components."""
        fx3, fy3, fz3 = comps(flows_3d)
        wx, wy, wz = ndc2world_c(X, Y, Z)
        dx, dy, dz = ndc2world_c(X + fx3, Y + fy3, Z + fz3)
        wx, wy, wz = (wx + scale * (dx - wx), wy + scale * (dy - wy),
                      wz + scale * (dz - wz))
        u = P[0, 0] * wx + P[0, 1] * wy + P[0, 2] * wz + P[0, 3]
        v = P[1, 0] * wx + P[1, 1] * wy + P[1, 2] * wz + P[1, 3]
        d = P[2, 0] * wx + P[2, 1] * wy + P[2, 2] * wz + P[2, 3]
        fx = u / d - torch.arange(w, dtype=torch.float32,
                                  device=dev)[None, None, :]
        fy = v / d - torch.arange(h, dtype=torch.float32,
                                  device=dev)[None, :, None]
        return fx, fy

    def planes(rgba):  # (hw, S, 4) -> (S, 4, h, w)
        return rgba.permute(1, 2, 0).reshape(S, 4, h, w)

    fx_t, fy_t = plane_flow(flows_fw, dt)
    fx_p, fy_p = plane_flow(flows_bw, 1.0 - dt)
    planes_cat = torch.cat([planes(rgba_t), planes(rgba_tp1)], 0)
    return (planes_cat, torch.cat([fx_t, fx_p], 0),
            torch.cat([fy_t, fy_p], 0))


def _interp_post(warped, static_rgb_flat, static_a_flat, zs_flat,
                 dt: float):
    """Blend and front-to-back over-composite downstream of the splat
    (planar layout, see `_interp_pre`): (rgb (h, w, 3), depth (h, w))."""
    S2, _, h, w = warped.shape
    S = S2 // 2
    warped_fw, warped_bw = warped[:S], warped[S:]  # (S, 4, h, w)
    static_rgb = static_rgb_flat.permute(1, 2, 0).reshape(S, 3, h, w)
    static_a = static_a_flat.T.reshape(S, h, w)[:, None]

    # per-plane blend
    composed_rgb = (warped_fw[:, :3] * warped_fw[:, 3:] * (1 - dt)
                    + warped_bw[:, :3] * warped_bw[:, 3:] * dt
                    + static_rgb * static_a)
    composed_a = 1.0 - (1.0 - (warped_fw[:, 3:] * (1 - dt)
                               + warped_bw[:, 3:] * dt)) * (1.0 - static_a)
    composed_a = composed_a[:, 0]  # (S, h, w)

    # front-to-back over-compositing: one exclusive product over planes,
    # by the device-side scan of the compositor (ops/compositing.py)
    trans = cp.transmittance(composed_a.reshape(S, h * w).T).T.reshape(
        S, h, w)
    rgb = (trans[:, None] * composed_rgb).sum(0)  # (3, h, w)
    zs = zs_flat.T.reshape(S, h, w)
    depth = (trans * composed_a * zs).sum(0)
    return rgb.permute(1, 2, 0), depth


def interpolate(results_t, results_tp1, dt: float, K, c2w, img_wh):
    """Space-time interpolation between two rendered frames t and t+1
    (port of the JAX package's `interpolate`): each depth sample forms a
    plane; frame t's transient planes are forward-warped by their
    dt-scaled, camera-projected scene flow, frame t+1's by (1 - dt), both
    in one average-mode splat (`ops/softsplat.py`); the blend is
    over-composited front to back with frame t's static planes.

    results_t / results_tp1: full-image render dicts (test time, both
    flows) with (h*w, S, .) per-sample entries; K (3, 3) intrinsics; c2w
    (3, 4) pose (the same for both frames); img_wh (w, h). Returns rgb
    (h, w, 3) and depth (h, w) in NDC."""
    from nsff_pl_tpu_torch.ops.softsplat import softsplat_batched_planar

    w, h = img_wh
    dt = float(torch.tensor(dt, dtype=torch.float32))  # as JAX's f32 dt

    def rgba(res):
        return torch.cat([res["transient_rgbs_fine"],
                          res["transient_alphas_fine"][..., None]], -1)

    planes_cat, fx_cat, fy_cat = _interp_pre(
        results_t["xyzs_fine"], results_t["transient_flows_fw"],
        results_tp1["transient_flows_bw"], rgba(results_t),
        rgba(results_tp1), dt, K, c2w, w=w, h=h)
    warped = softsplat_batched_planar(planes_cat, fx_cat, fy_cat, "average")
    return _interp_post(warped, results_t["static_rgbs_fine"],
                        results_t["static_alphas_fine"],
                        results_t["zs_fine"], dt)
