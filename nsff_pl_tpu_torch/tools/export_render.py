"""Export a trained NSFF renderer as one serving artifact (port of
`tools/export_render.py`).

`torch.export` traces the test-time render (`models/rendering.py::
render_rays`, no gradient) of a module that holds the checkpoint's
weights as buffers, and `torch.export.save` writes the program. It runs
fixed-shape batches, `rays` (chunk, 6) float32 and `ts` (chunk,) int64,
and returns (rgb (chunk, 3), depth (chunk,)):

    python -m nsff_pl_tpu_torch.tools.export_render \
        --ckpt_path ckpts/kid/step_221150 --encode_t --use_viewdir \
        --N_samples 128 --chunk 32768 --out kid_render.pt2 --check

    # serving side
    import torch
    prog = torch.export.load("kid_render.pt2").module()
    rgb, depth = prog(rays, ts)

Every route of the JAX tool exports:
- `--mlp_backend xla` (the default): the plain evaluators in `--dtype`
  (float32 by default). The program is aten ops only and loads with
  nothing but `torch`.
- `--mlp_backend pallas` (`auto`: on a CUDA device in bfloat16): the
  kernels, as the custom ops of `ops/library.py`, with the fine model's
  weights packed once here (its evaluator's `fn.pack`). A model with
  `--encode_t` takes the planar route and B1
  (`nsff_torch::planar_eval_comp`, one call a batch); one without takes
  the packed route and B5 (`nsff_torch::fused_nerf_eval`). With
  `--N_importance` the planar route's coarse pass is B2's forward
  (`nsff_torch::planar_nerf_train_fwd` at `--N_samples`), then
  `sample_pdf` and the sort, then B1 at `N_samples + N_importance`
  (`+ 2 * N_importance` with `--output_transient`); the packed route's
  coarse pass runs the plain evaluators. The program loads after
  `import nsff_pl_tpu_torch.ops.library`, which registers the ops (CUDA
  tensors launch the kernels, CPU tensors run their plain versions), as
  the JAX Pallas export ties its artifact to the Mosaic runtime.

`--platforms` names the one device the program is exported for, `cpu`
or `cuda` (default `cuda`). A `<out>.json` sidecar records the shapes,
the outputs, the platform, the flags and the modules the loader must
import. `--check` reloads the artifact and compares one batch with the
live renderer (`training/step.py::make_render_fn`).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

OUTPUT_KEYS = ("rgb_fine", "depth_fine")
OPS_MODULE = "nsff_pl_tpu_torch.ops.library"
CHECK_TOL = 2e-5  # atol and rtol of --check (the JAX tool's)


def get_opts(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_path", type=str, required=True,
                   help="port checkpoint (step_<n> or its state.pt, full "
                        "or params-only) or reference PL .ckpt")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact path (sidecar: <out>.json)")
    p.add_argument("--chunk", type=int, default=32 * 1024,
                   help="rays per call (the artifact's fixed batch shape)")
    p.add_argument("--img_wh", nargs="+", type=int, default=[512, 288])
    p.add_argument("--use_viewdir", default=False, action="store_true")
    p.add_argument("--N_samples", type=int, default=128)
    p.add_argument("--N_importance", type=int, default=0)
    p.add_argument("--encode_a", default=False, action="store_true")
    p.add_argument("--N_a", type=int, default=48)
    p.add_argument("--encode_t", default=False, action="store_true")
    p.add_argument("--N_tau", type=int, default=48)
    p.add_argument("--N_frames", type=int, default=30,
                   help="number of training frames (t-embedding rows)")
    p.add_argument("--flow_scale", type=float, default=0.2)
    p.add_argument("--output_transient", default=False, action="store_true",
                   help="also bake the transient branch maps")
    p.add_argument("--mlp_backend", type=str, default="xla",
                   choices=["xla", "auto", "pallas"],
                   help="xla (default) exports the plain evaluators (the "
                        "program needs only torch); pallas the kernels as "
                        f"custom ops (the program needs {OPS_MODULE})")
    p.add_argument("--platforms", nargs="+", type=str, default=None,
                   help="the one device the program is exported for: cpu "
                        "or cuda (default cuda)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--check", default=False, action="store_true",
                   help="after export: reload and compare one batch "
                        "against the live renderer")
    return p.parse_args(argv)


def export_device(args) -> torch.device:
    """The device `--platforms` names (one of cpu, cuda)."""
    from nsff_pl_tpu_torch import resolve_device

    platforms = args.platforms or ["cuda"]
    if len(platforms) != 1 or platforms[0] not in ("cpu", "cuda"):
        raise ValueError(
            f"--platforms {' '.join(platforms)}: a PyTorch program is "
            "exported for one device; name one of cpu, cuda")
    return resolve_device(platforms[0])


def render_config(args, dev: torch.device):
    """The render config of the export: the route (see the module
    docstring) fixed here, with the eval backend resolved."""
    from nsff_pl_tpu_torch.models.rendering import RenderConfig

    backend = args.mlp_backend
    if backend == "auto":
        backend = ("pallas" if dev.type == "cuda"
                   and args.dtype == "bfloat16" else "xla")
    planar = backend == "pallas" and args.encode_t
    return RenderConfig(
        N_samples=args.N_samples, N_importance=args.N_importance,
        use_viewdir=args.use_viewdir, encode_a=args.encode_a,
        encode_t=args.encode_t, max_t=args.N_frames - 1, N_tau=args.N_tau,
        N_a=args.N_a, img_wh=tuple(args.img_wh), flow_scale=args.flow_scale,
        compute_dtype=args.dtype, mlp_backend=backend, fused_train="off",
        planar_eval="on" if planar else "off")


def pack_fine(rcfg, params, output_transient: bool):
    """The fine model's weights packed for the kernel this route runs:
    B1's composited evaluator (planar) or B5 (packed)."""
    from nsff_pl_tpu_torch.ops.mlp_kernel import make_fused_nerf_eval
    from nsff_pl_tpu_torch.ops.raymarch_kernel import \
        make_planar_nerf_eval_comp

    kker = dict(n_emb_xyz=rcfg.N_emb_xyz, s_emb_xyz=rcfg.S_emb_xyz,
                n_emb_dir=rcfg.N_emb_dir, n_a=rcfg.N_a, n_tau=rcfg.N_tau,
                flow_scale=rcfg.flow_scale)
    encode_a = rcfg.encode_a and "embedding_a" in params
    if rcfg.planar_eval == "on":
        fn = make_planar_nerf_eval_comp(
            rcfg.N_samples, use_viewdir=rcfg.use_viewdir, encode_a=encode_a,
            encode_t=output_transient, **kker)
    else:
        fn = make_fused_nerf_eval(
            rcfg.N_samples, use_viewdir=rcfg.use_viewdir,
            encode_a=encode_a, encode_t=output_transient, output_flow=(),
            **kker)
    with torch.no_grad():
        return fn.pack(params["nerf_fine"])


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


class RenderProgram(torch.nn.Module):
    """(rays (chunk, 6), ts (chunk,)) -> (rgb_fine, depth_fine) of the
    test-time render, the weights as buffers: the params tree, and on the
    kernel route the fine model's packed weights in place of its own."""

    def __init__(self, rcfg, params, output_transient: bool,
                 packed_fine=None):
        super().__init__()
        self.rcfg = rcfg
        self.output_transient = output_transient
        tree = dict(params)
        if packed_fine is not None:
            del tree["nerf_fine"]
            tree["fine_packed"] = packed_fine
        self._paths = []
        for path, t in _flatten(tree):
            name = "__".join(path)
            self.register_buffer(name, t.detach())
            self._paths.append((path, name))

    def _tree(self):
        out = {}
        for path, name in self._paths:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, name)
        return out

    def forward(self, rays, ts):
        from nsff_pl_tpu_torch.models.rendering import render_rays

        tree = self._tree()
        models = {"fine": tree.get("nerf_fine", {})}
        for ours, key in (("coarse", "nerf_coarse"),
                          ("fine_packed", "fine_packed")):
            if key in tree:
                models[ours] = tree[key]
        embeddings = {k: tree[f"embedding_{k}"] for k in ("a", "t")
                      if f"embedding_{k}" in tree}
        out = render_rays(models, embeddings, rays, ts, self.rcfg,
                          test_time=True,
                          output_transient=self.output_transient,
                          keys=OUTPUT_KEYS)
        return tuple(out[k] for k in OUTPUT_KEYS)


def check_rays(chunk: int, dev: torch.device):
    """The --check batch, built as the JAX tool builds it: origins in
    [-0.5, 0.5)^2 at z = -1, directions in [0, 0.1)^2 with d_z = 2, t 0."""
    g0 = torch.Generator().manual_seed(0)
    g1 = torch.Generator().manual_seed(1)
    o = torch.rand((chunk, 3), generator=g0) - 0.5
    o[:, 2] = -1.0
    d = torch.rand((chunk, 3), generator=g1) * 0.1
    d[:, 2] = 2.0
    return (torch.cat([o, d], -1).to(dev),
            torch.zeros((chunk,), dtype=torch.long, device=dev))


def main(args):
    """Export (and with --check, verify) the artifact; returns the
    sidecar's dict, with the check's max abs errors under "check"."""
    from nsff_pl_tpu_torch.apps.evaluate import load_params
    from nsff_pl_tpu_torch.config import NSFFConfig
    from nsff_pl_tpu_torch.training.step import make_render_fn

    dev = export_device(args)
    rcfg = render_config(args, dev)
    cfg = NSFFConfig(
        img_wh=tuple(args.img_wh), start_end=(0, args.N_frames),
        use_viewdir=args.use_viewdir, N_samples=args.N_samples,
        N_importance=args.N_importance, encode_a=args.encode_a,
        N_a=args.N_a, encode_t=args.encode_t, N_tau=args.N_tau,
        flow_scale=args.flow_scale)
    params = load_params(args, cfg, dev)
    output_transient = args.output_transient and args.encode_t
    kernels = rcfg.mlp_backend == "pallas"
    packed = pack_fine(rcfg, params, output_transient) if kernels else None
    prog = RenderProgram(rcfg, params, output_transient, packed)
    example = (torch.zeros((args.chunk, 6), device=dev),
               torch.zeros((args.chunk,), dtype=torch.long, device=dev))
    with torch.no_grad():
        exported = torch.export.export(prog, example)
    torch.export.save(exported, args.out)
    meta = {
        "inputs": {"rays": [args.chunk, 6], "ts": [args.chunk]},
        "outputs": list(OUTPUT_KEYS),
        "platforms": [dev.type],
        "imports": ["torch"] + ([OPS_MODULE] if kernels else []),
        "flags": {k: v for k, v in vars(args).items()
                  if k not in ("out", "check", "ckpt_path")},
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported {os.path.getsize(args.out) / 1e6:.1f} MB -> {args.out} "
          f"(platform {dev.type}, {'kernel' if kernels else 'plain'} "
          "route)", flush=True)

    if args.check:
        got = torch.export.load(args.out).module()(*check_rays(args.chunk,
                                                               dev))
        render = make_render_fn(rcfg, output_transient=output_transient,
                                keys=OUTPUT_KEYS, device=dev)
        want = render(params, *check_rays(args.chunk, dev))
        meta["check"] = {}
        for g, name in zip(got, OUTPUT_KEYS):
            w = want[name]
            err = float((g - w).abs().max())
            meta["check"][name] = err
            print(f"check {name}: max|err| {err:.2e}", flush=True)
            torch.testing.assert_close(g, w, atol=CHECK_TOL, rtol=CHECK_TOL)
        print("roundtrip check OK", flush=True)
    return meta


if __name__ == "__main__":
    main(get_opts())
