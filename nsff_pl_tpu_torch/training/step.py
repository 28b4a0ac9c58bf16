"""The training step and chunked full-image rendering (port of
`nsff_pl_tpu/training/step.py`).

`make_train_step` builds one training step: device-side batch gather ->
render with scene-flow warping (the planar path where it applies, else
the reference-shaped `render_rays`) -> loss -> backward -> Adam update.
PyTorch runs eagerly, so the step is a plain function where the JAX
package returned a jitted one. With `scan_steps=K > 1` it returns the
counterpart of the JAX package's K-step dispatch (`lax.scan` over K
steps): on a CUDA device the step is captured once in a CUDA graph and
replayed, so one dispatch issues no Python op per step (see
`_MultiStep`); on the CPU the same steps run eagerly.

`make_render_fn` returns a plain function under `torch.inference_mode()`.
`render_full_image` is the host chunk loop; it pads the last chunk to the
full chunk size by repeating the last ray, as the JAX loop does, so every
chunk has one shape. With `scan_chunks=True` it splits a frame into equal
chunks and, on a CUDA device, renders them all by one replay of a CUDA
graph (`_ChunkGraph`), the counterpart of the JAX package's chunk loop in
one `lax.scan` dispatch. In place of the render's `rng` argument a
`test_time=False` renderer takes a `generator`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.models.rendering import RenderConfig, render_rays
from nsff_pl_tpu_torch.training.optim import AdamState, param_leaves


class TrainState(NamedTuple):
    params: Any  # {'nerf_fine', 'embedding_a'?, 'embedding_t'?}
    opt_state: Any  # optim.AdamState over `optim.param_leaves(params)`
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
    packed-boundary `render_rays` with `compute_losses`.

    With `scan_steps=K > 1` it returns the K-step dispatch `_MultiStep`
    (its docstring has the signature), which on a CUDA device replays one
    CUDA graph of all K steps."""
    from nsff_pl_tpu_torch.data.pipeline import _sample_batch
    from nsff_pl_tpu_torch.models.raymarch import (
        check_train_envelope, planar_unapplicable_reasons,
        render_train_planar)
    from nsff_pl_tpu_torch.training.loss import (compute_losses,
                                                 compute_losses_planar,
                                                 total_loss)

    dev = resolve_device(device)
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
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

    def step_body(params, opt, step, table, weights, Ks, Ps, generator, t,
                  idx, batch_u, draws):
        """One step from `step` steps made (an int, or the device counter
        of a dispatch): (metrics, rendered rgb, ray ids)."""
        batch = _sample_batch(table, weights, t, batch_size, hard_sampling,
                              generator=generator, idx=idx, u=batch_u)
        epoch = step // steps_per_epoch
        models, embeddings = _split_params(params)
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
        opt.zero_grad()
        loss.backward()
        tx.step(opt)

        with torch.no_grad():
            mse = ((results["rgb_fine"] - batch["rgbs"]) ** 2).mean()
            metrics = {k: v.detach() for k, v in loss_d.items()}
            metrics["loss"] = loss.detach()
            metrics["psnr"] = -10.0 * torch.log10(mse)
        return metrics, results["rgb_fine"].detach(), batch["rand_idx"]

    def train_step(state: TrainState, table, weights, Ks, Ps, generator, t,
                   *, idx=None, batch_u=None, draws=None):
        metrics, rgb, rand_idx = step_body(
            state.params, state.opt_state, state.step, table, weights, Ks,
            Ps, generator, t, idx, batch_u, draws)
        aux = {"rgb_fine": rgb, "rand_idx": rand_idx, "t": t}
        return TrainState(state.params, state.opt_state, state.step + 1), \
            metrics, aux

    if scan_steps == 1:
        fn = train_step
    else:
        fn = _MultiStep(step_body, scan_steps, hard_sampling, dev)
    fn.device = dev
    fn.use_planar = use_planar
    return fn


def _clone_params(tree):
    if isinstance(tree, dict):
        return {k: _clone_params(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def clone_state(state: TrainState) -> TrainState:
    """A copy of a train state: its params, Adam's count and moments."""
    params = _clone_params(state.params)
    opt = AdamState(param_leaves(params))
    with torch.no_grad():
        opt.count.copy_(state.opt_state.count)
        torch._foreach_copy_(opt.mu + opt.nu,
                             state.opt_state.mu + state.opt_state.nu)
    return state._replace(params=params, opt_state=opt)


def _tensors(x):
    """The tensors of a nested dict / state, for the capture's key."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, AdamState):
        return [x.count] + x.params + x.mu + x.nu
    return [x] if isinstance(x, torch.Tensor) else []


class _Bound:
    """What one run of the steps reads and writes."""

    def __init__(self, params, opt, tmp_rgb, generator, step, rows, args):
        self.params, self.opt, self.tmp_rgb = params, opt, tmp_rgb
        self.generator, self.step, self.rows = generator, step, rows
        self.table, self.weights, self.Ks, self.Ps = args


class _MultiStep:
    """K training steps in one dispatch (the JAX package's
    `make_train_step(scan_steps=K)`):

        multi_step(state, tmp_rgb, table, weights, Ks, Ps, generator, ts, *,
                   idx=None, batch_u=None, draws=None)
            -> (state, tmp_rgb, metrics)

    `ts` is the (K,) frame schedule (a long tensor on the device), each
    metric comes stacked to (K,), and with `hard_sampling` each step
    writes `tmp_rgb[t, rand_idx] = rgb_fine`, in place (which of two draws
    of one pixel in a batch lands is unspecified, as in JAX's scatter); a
    dummy (1, 1, 3) passes through untouched otherwise. The optional
    draws carry a leading K axis: `idx` / `batch_u` (K, B), `draws` a
    dict of (K, B, S); what is not given is drawn from `generator`.
    Per step this is exactly the single step: the same function, the
    same device state. The step counter, the frame t, the epoch and the
    lr are device values that every step reads and advances.

    On a CUDA device the K steps are captured once in one CUDA graph,
    replayed once a dispatch (a graph of one step replayed K times
    measured no faster per step on an H100 and keeps the host issuing K
    replays, PERF.md). The capture is made at the first dispatch, after
    `WARMUP` eager runs of the K steps on a copy of the state (so the
    dispatch's own steps are all replays; they run under
    `torch.cuda.set_sync_debug_mode("error")`, so a step that waits on
    the host raises there), and again whenever the tensors it reads
    change (another state, table or buffer). The graph reads the
    parameters, the Adam state, the table and `tmp_rgb` at their
    addresses and updates them in place; everything else (the packed
    weights, the backward's scratch, the activations) comes from the
    graph's own pool. Around a replay only device-side work runs: a fill
    of the step counter, copies of the schedule's rows into the graph's
    static buffers, and the metrics out. A CUDA generator is registered with the graph, so each
    replay draws new numbers. A capture that fails raises with the
    operation that broke it; nothing falls back to the eager loop.
    `graph_launches` holds the kernel launches recorded by one capture
    (`ops/launches.py`), `replays` the replays since, `captures` the
    captures made, and `capture_seconds` the last warm-up and capture's
    host seconds.

    On the CPU the same function runs the steps eagerly, on the same
    static buffers."""

    WARMUP = 2

    def __init__(self, body, K: int, hard_sampling: bool, dev):
        self.body, self.K = body, K
        self.hard_sampling = hard_sampling
        self.dev = dev
        self._key = None
        self.graph_launches: Dict[str, int] = {}
        self.replays = 0
        self.captures = 0
        self.capture_seconds = 0.0

    def _run(self, b: _Bound) -> torch.Tensor:
        """`K` steps on `b`; the (K, n_metrics) metrics."""
        out = []
        for g in range(self.K):
            t = b.rows["ts"][g]
            draws = {k[5:]: v[g] for k, v in b.rows.items()
                     if k.startswith("draw_")}
            metrics, rgb, rand_idx = self.body(
                b.params, b.opt, b.step, b.table, b.weights, b.Ks, b.Ps,
                b.generator, t, b.rows["idx"][g] if "idx" in b.rows else None,
                b.rows["batch_u"][g] if "batch_u" in b.rows else None,
                draws or None)
            with torch.no_grad():
                b.step += 1
                if self.hard_sampling:
                    b.tmp_rgb.index_put_((t.expand_as(rand_idx), rand_idx),
                                         rgb)
                self.metric_keys = list(metrics)
                out.append(torch.stack([metrics[k] for k in metrics]))
        return torch.stack(out)

    def _build(self, state, tmp_rgb, generator, rows, args, key):
        """Static buffers, and on CUDA the warm-up and the capture."""
        self._key = self._graph = self._out = None
        self._step = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._rows = {k: torch.empty_like(v, device=self.dev)
                      for k, v in rows.items()}
        self._bound = _Bound(state.params, state.opt_state, tmp_rgb,
                             generator, self._step, self._rows, args)
        if self.dev.type == "cuda":
            t0 = time.perf_counter()
            self._capture(state, tmp_rgb, generator, rows, args)
            self.capture_seconds = time.perf_counter() - t0
        self._key = key

    def _capture(self, state, tmp_rgb, generator, rows, args):
        from nsff_pl_tpu_torch.ops import launches

        spare = clone_state(state)
        gen = None
        if generator is not None:
            gen = torch.Generator(device=self.dev).manual_seed(0)
        shadow = _Bound(spare.params, spare.opt_state,
                        tmp_rgb.clone() if self.hard_sampling else tmp_rgb,
                        gen, self._step.clone(), self._rows, args)
        for k, v in rows.items():
            self._rows[k].copy_(v)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(self.WARMUP):
                    self._run(shadow)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        del shadow, spare
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this PyTorch cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state); a graphed "
                    "dispatch needs it, or every draw given")
            graph.register_generator_state(generator)
        before = launches.counts()
        try:
            with torch.cuda.graph(graph):
                self._out = self._run(self._bound)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the train step failed: {e}") from e
        after = launches.counts()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self.replays = 0
        self.captures += 1
        self._graph = graph

    def __call__(self, state: TrainState, tmp_rgb, table, weights, Ks, Ps,
                 generator, ts, *, idx=None, batch_u=None, draws=None):
        K = self.K
        rows = {"ts": ts, "idx": idx, "batch_u": batch_u}
        rows.update({f"draw_{k}": v for k, v in (draws or {}).items()})
        rows = {k: v for k, v in rows.items() if v is not None}
        for k, v in rows.items():
            if v.device.type != self.dev.type or v.shape[0] != K:
                raise ValueError(f"{k}: need a ({K}, ...) tensor on "
                                 f"{self.dev}, got {tuple(v.shape)} on "
                                 f"{v.device}")
        if ts.dtype != torch.int64:
            raise ValueError(f"ts: need int64 frames, got {ts.dtype}")
        args = (table, weights, Ks, Ps)
        key = (tuple(t.data_ptr() for t in _tensors(state.params)
                     + _tensors(state.opt_state) + [tmp_rgb, *args]),
               id(generator),
               tuple((k, tuple(v.shape), v.dtype) for k, v in rows.items()))
        if key != self._key:
            self._build(state, tmp_rgb, generator, rows, args, key)
        self._step.fill_(state.step)
        for k, v in rows.items():
            self._rows[k].copy_(v)
        if self._graph is not None:
            self._graph.replay()
            self.replays += 1
            metrics = self._out.clone()
        else:
            metrics = self._run(self._bound)
        return (TrainState(state.params, state.opt_state, state.step + K),
                tmp_rgb, {k: metrics[:, i]
                          for i, k in enumerate(self.metric_keys)})


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
    render.chunk_graphs = {}  # render_full_image's CUDA graphs
    return render


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` copies of the last row."""
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def equal_chunks(n: int, chunk: int) -> Tuple[int, int]:
    """(count, size) of the equal chunks of an n-ray frame, as the JAX
    package's `scan_chunks` sizes them: K = ceil(n / chunk) chunks of
    ceil(n / K) rays rounded up to a multiple of 1024 (never above
    `chunk`), so a frame that is K.5 chunks long pads a few rays rather
    than half a chunk (512x288 at 32768: 5 x 29696, 1024 rays of
    padding)."""
    k = -(-n // chunk)
    size = min(chunk, ((-(-n // k) + 1023) // 1024) * 1024)
    return -(-n // size), size


class _ChunkGraph:
    """The equal chunks of one frame, rendered by one replay of a CUDA
    graph.

    The first call warms the chunk renders up once on a side stream
    under `torch.cuda.set_sync_debug_mode("error")` (an operation that
    waits on the host raises there), then captures all of them in one
    `torch.cuda.CUDAGraph`, with each chunk's outputs copied into frame
    buffers of the graph's pool. Every call copies the frame's inputs
    (rays, ts, view directions, visibility poses and intrinsics) into the
    graph's static buffers, replays it and returns copies of the frame
    buffers trimmed to the frame: the next replay overwrites the pool,
    the copies are the caller's. The graph reads the params at their
    addresses. A capture that fails raises with the operation that broke
    it; nothing falls back to the host loop. `graph_launches` holds the
    kernel launches one capture recorded (`ops/launches.py`), `replays`
    the replays since, `warmup_launches` what the warm-up launched and
    `capture_seconds` the warm-up and capture's host seconds."""

    def __init__(self, render_fn, params, inputs, n_chunks: int,
                 chunk: int):
        from nsff_pl_tpu_torch.ops import launches

        self.n_chunks, self.chunk = n_chunks, chunk
        dev = inputs["rays"].device
        t0 = time.perf_counter()
        self.bufs = {k: v.clone() for k, v in inputs.items()}
        before = launches.counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                _render_chunks(render_fn, params, self.bufs, n_chunks, chunk)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.current_stream(dev).wait_stream(side)
        mid = launches.counts()
        self.warmup_launches = {k: mid[k] - before[k] for k in mid}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = _render_chunks(render_fn, params, self.bufs,
                                          n_chunks, chunk)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the render chunks failed: {e}") from e
        after = launches.counts()
        self.graph_launches = {k: after[k] - mid[k] for k in after}
        self.replays = 0
        self.capture_seconds = time.perf_counter() - t0

    def __call__(self, inputs, n: int) -> Dict[str, torch.Tensor]:
        for k, v in inputs.items():
            self.bufs[k].copy_(v)
        self.graph.replay()
        self.replays += 1
        return {k: v[:n].clone() for k, v in self.out.items()}


def _render_chunks(render_fn, params, inputs, n_chunks: int,
                   chunk: int) -> Dict[str, torch.Tensor]:
    """Render the `n_chunks` chunks of the padded per-ray `inputs` (rays,
    and ts / view_dir where given; vis_poses and vis_K whole) into frame
    buffers, one chunk's outputs alive at a time."""
    b = inputs
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        o = render_fn(params, b["rays"][rows],
                      b["ts"][rows] if "ts" in b else None,
                      b.get("vis_poses"), b.get("vis_K"),
                      b["view_dir"][rows] if "view_dir" in b else None)
        with torch.inference_mode():
            for k, v in o.items():
                if k not in out:
                    out[k] = v.new_empty((n_chunks * chunk,)
                                         + tuple(v.shape[1:]))
                out[k][rows].copy_(v)
        del o
    return out


def render_full_image(render_fn, params, rays, ts, chunk: int = 32768,
                      vis_poses=None, vis_K=None, view_dir=None,
                      scan_chunks: bool = False) -> Dict[str, torch.Tensor]:
    """Render N rays in fixed-size chunks; the last chunk is padded to
    `chunk` rays (repeating its last ray) and trimmed after rendering.

    `scan_chunks=True` (with N > chunk) renders equal chunks instead
    (`equal_chunks`), padded by repeating the last ray, ts and view
    direction. On a CUDA device they run as one replay of a CUDA graph
    (`_ChunkGraph`), captured once per frame size, chunk, input set and
    params, and kept on `render_fn.chunk_graphs`; on the CPU the same
    chunks run eagerly. The returned tensors are the caller's either
    way."""
    dev = render_fn.device
    rays = torch.as_tensor(rays, dtype=torch.float32, device=dev)
    if ts is not None:
        ts = torch.as_tensor(ts, dtype=torch.long, device=dev)
    if view_dir is not None:
        view_dir = torch.as_tensor(view_dir, dtype=torch.float32, device=dev)
    n = rays.shape[0]
    if scan_chunks and n > chunk:
        n_chunks, chunk = equal_chunks(n, chunk)
        pad = n_chunks * chunk - n
        inputs = {"rays": rays, "ts": ts, "view_dir": view_dir}
        inputs = {k: _pad_last(v, pad) if pad else v
                  for k, v in inputs.items() if v is not None}
        for k, v in (("vis_poses", vis_poses), ("vis_K", vis_K)):
            if v is not None:
                inputs[k] = torch.as_tensor(v, dtype=torch.float32,
                                            device=dev)
        if dev.type == "cuda":
            graphs = render_fn.__dict__.setdefault("chunk_graphs", {})
            key = (n, chunk, tuple(sorted(inputs)),
                   tuple(tuple(v.shape) for _, v in sorted(inputs.items())),
                   tuple(t.data_ptr() for t in _tensors(params)))
            if key not in graphs:
                graphs[key] = _ChunkGraph(render_fn, params, inputs,
                                          n_chunks, chunk)
            return graphs[key](inputs, n)
        out = _render_chunks(render_fn, params, inputs, n_chunks, chunk)
        return {k: v[:n].clone() for k, v in out.items()}
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
