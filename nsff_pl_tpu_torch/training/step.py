"""The training step and chunked full-image rendering (port of
`nsff_pl_tpu/training/step.py`).

`make_train_step` builds one training step: device-side batch gather ->
render with scene-flow warping (the planar path where it applies, else
the reference-shaped `render_rays`) -> loss -> backward -> Adam update.
PyTorch runs eagerly, so the step is a plain function where the JAX
package returned a jitted one; its `scan_steps > 1` (several steps in one
dispatch) has no counterpart yet: a CUDA graph of the step is later work
(ROADMAP.md).

`make_render_fn` returns a plain function under `torch.inference_mode()`.
`render_full_image` is the host chunk loop; it pads the last chunk to the
full chunk size by repeating the last ray, as the JAX loop does, so every
chunk has one shape. The JAX package's `scan_chunks` has no counterpart
(a CUDA graph of the chunk loop is later work); in place of the render's
`rng` argument a `test_time=False` renderer takes a `generator`.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.models.rendering import RenderConfig, render_rays


class TrainState(NamedTuple):
    params: Any  # {'nerf_fine', 'embedding_a'?, 'embedding_t'?}
    opt_state: Any  # torch.optim.Adam over `optim.param_leaves(params)`
    step: int


def _split_params(params):
    """Model params dict -> (models dict, embeddings dict)."""
    models = {"fine": params["nerf_fine"]}
    if "nerf_coarse" in params:
        models["coarse"] = params["nerf_coarse"]
    embeddings = {}
    if "embedding_a" in params:
        embeddings["a"] = params["embedding_a"]
    if "embedding_t" in params:
        embeddings["t"] = params["embedding_t"]
    return models, embeddings


def make_train_step(
    render_cfg: RenderConfig,
    loss_cfg,
    tx,
    *,
    output_transient: bool,
    output_transient_flow: Tuple[str, ...],
    steps_per_epoch: int,
    batch_size: int,
    hard_sampling: bool = False,
    scan_steps: int = 1,
    device="cuda",
):
    """Build the train step on `device`:

        train_step(state, table, weights, Ks, Ps, generator, t, *,
                   idx=None, batch_u=None, draws=None)
            -> (state, metrics, aux)

    `table` is the device-resident ray table, `weights` the hard-sampling
    distribution, `t` the scheduler's frame; random draws come from the
    device `generator` unless given: `idx` (uniform pixel indices),
    `batch_u` (hard-sampling uniforms), `draws` (the renderer's, see
    `render_train_planar`; `render_rays` takes the same). The params are
    updated in place and returned in the new state; metrics hold the
    per-term losses, `loss` and `psnr` (device scalars), aux the rendered
    rgb, the ray ids and t.

    The planar path is taken as the JAX package decides: when the
    configuration is in its envelope and `fused_train` is 'on', or 'auto'
    with the kernel backend active (`train_backend` 'pallas', or 'auto'
    on a CUDA device with bfloat16 compute). 'on' outside the envelope
    raises. Every other case (no transient branch, not both flows,
    `fused_train='off'`, the plain evaluators) renders through the
    packed-boundary `render_rays` with `compute_losses`."""
    from nsff_pl_tpu_torch.data.pipeline import _sample_batch
    from nsff_pl_tpu_torch.models.raymarch import (
        check_train_envelope, planar_unapplicable_reasons,
        render_train_planar)
    from nsff_pl_tpu_torch.training.loss import (compute_losses,
                                                 compute_losses_planar,
                                                 total_loss)

    dev = resolve_device(device)
    if scan_steps != 1:
        raise NotImplementedError(
            "scan_steps > 1 has no counterpart yet (ROADMAP.md queue A, "
            "'CUDA graph of the train step')")
    if render_cfg.fused_train not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_train {render_cfg.fused_train!r}")
    tb = render_cfg.train_backend
    kernels_active = (tb == "pallas"
                      or (tb == "auto" and dev.type == "cuda"
                          and render_cfg.compute_dtype == "bfloat16"))
    reasons = planar_unapplicable_reasons(render_cfg, output_transient,
                                          output_transient_flow)
    if reasons and render_cfg.fused_train == "on":
        raise ValueError(f"fused_train='on' but the planar fused train path "
                         f"is unavailable ({'; '.join(reasons)})")
    use_planar = not reasons and (render_cfg.fused_train == "on" or (
        render_cfg.fused_train == "auto" and kernels_active))
    if ((render_cfg.warp_subsample > 1 or render_cfg.warp_importance > 0)
            and not use_planar):
        which = (f"warp_subsample={render_cfg.warp_subsample}"
                 if render_cfg.warp_subsample > 1
                 else f"warp_importance={render_cfg.warp_importance}")
        raise ValueError(
            f"{which} is only implemented on the planar fused train path"
            + (f" (unavailable here: {'; '.join(reasons)})" if reasons
               else " (enable it: fused_train='on'/'auto' with the kernel "
                    "train backend)"))
    if use_planar:
        check_train_envelope(render_cfg)
    elif render_cfg.N_importance > 0:
        raise NotImplementedError(
            "coarse-to-fine training (N_importance > 0) is not ported yet "
            "(ROADMAP.md queue A, 'coarse-to-fine')")
    flow = tuple(output_transient_flow)

    def train_step(state: TrainState, table, weights, Ks, Ps, generator, t,
                   *, idx=None, batch_u=None, draws=None):
        batch = _sample_batch(table, weights, t, batch_size, hard_sampling,
                              generator=generator, idx=idx, u=batch_u)
        epoch = state.step // steps_per_epoch
        models, embeddings = _split_params(state.params)
        if use_planar:
            results = render_train_planar(
                models["fine"], embeddings, batch["rays"], batch["ts"],
                render_cfg, generator=generator, draws=draws)
            loss_d = compute_losses_planar(results, batch, loss_cfg,
                                           epoch=epoch, Ks=Ks, Ps=Ps)
        else:
            results = render_rays(
                models, embeddings, batch["rays"],
                batch["ts"] if output_transient else None, render_cfg,
                test_time=False, output_transient=output_transient,
                output_transient_flow=flow, generator=generator, draws=draws)
            loss_d = compute_losses(results, batch, loss_cfg, epoch=epoch,
                                    output_transient_flow=flow, Ks=Ks, Ps=Ps)
        loss = total_loss(loss_d)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss.backward()
        tx.step(opt, state.step)

        with torch.no_grad():
            mse = ((results["rgb_fine"] - batch["rgbs"]) ** 2).mean()
            metrics = {k: v.detach() for k, v in loss_d.items()}
            metrics["loss"] = loss.detach()
            metrics["psnr"] = -10.0 * torch.log10(mse)
        aux = {"rgb_fine": results["rgb_fine"].detach(),
               "rand_idx": batch["rand_idx"], "t": t}
        return TrainState(state.params, opt, state.step + 1), metrics, aux

    train_step.device = dev
    train_step.use_planar = use_planar
    return train_step


def make_render_fn(
    render_cfg: RenderConfig,
    *,
    test_time: bool = True,
    output_transient: bool,
    output_transient_flow: Tuple[str, ...] = (),
    with_visibility: bool = False,
    keys: Optional[Tuple[str, ...]] = None,
    device="cuda",
):
    """Renderer (no gradient) for one ray batch on `device`:
    render(params, rays, ts, vis_poses=None, vis_K=None, view_dir=None,
    generator=None, draws=None) -> dict. Inputs are moved to `device`.
    `keys` restricts the returned dict and, on the planar test path when
    it lies within `comp_eval_keys`, selects the composited kernel route.
    With `test_time=False` the render perturbs the depths and adds sigma
    noise as in training, from `generator` or `draws`."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def render(params, rays, ts, vis_poses=None, vis_K=None, view_dir=None,
               generator=None, draws=None):
        models, embeddings = _split_params(params)
        rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
        if ts is not None:
            ts = torch.as_tensor(ts, dtype=torch.long, device=dev)
        if view_dir is not None:
            view_dir = torch.as_tensor(view_dir, dtype=torch.float32,
                                       device=dev)
        return render_rays(
            models, embeddings, rays, ts, render_cfg, test_time=test_time,
            generator=generator, draws=draws,
            output_transient=output_transient,
            output_transient_flow=output_transient_flow,
            vis_poses=vis_poses if with_visibility else None,
            vis_K=vis_K if with_visibility else None,
            view_dir=view_dir, keys=keys)

    render.device = dev
    return render


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` copies of the last row."""
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def render_full_image(render_fn, params, rays, ts, chunk: int = 32768,
                      vis_poses=None, vis_K=None,
                      view_dir=None) -> Dict[str, torch.Tensor]:
    """Render N rays in fixed-size chunks; the last chunk is padded to
    `chunk` rays (repeating its last ray) and trimmed after rendering."""
    dev = render_fn.device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
    if ts is not None:
        ts = torch.as_tensor(ts, dtype=torch.long, device=dev)
    if view_dir is not None:
        view_dir = torch.as_tensor(view_dir, dtype=torch.float32, device=dev)
    n = rays.shape[0]
    outs = []
    for i in range(0, n, chunk):
        r = rays[i:i + chunk]
        t = ts[i:i + chunk] if ts is not None else None
        vd = view_dir[i:i + chunk] if view_dir is not None else None
        pad = chunk - r.shape[0]
        if pad > 0:
            r = _pad_last(r, pad)
            t = _pad_last(t, pad) if t is not None else None
            vd = _pad_last(vd, pad) if vd is not None else None
        out = render_fn(params, r, t, vis_poses, vis_K, vd)
        if pad > 0:
            out = {k: v[:chunk - pad] for k, v in out.items()}
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}
