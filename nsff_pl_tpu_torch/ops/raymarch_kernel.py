"""Composited no-grad planar evaluator: CUDA kernel + plain PyTorch version.

Port of `nsff_pl_tpu/ops/raymarch_kernel.py::make_planar_nerf_eval_comp`
(and the helpers it takes from `ops/mlp_kernel.py` and
`ops/mlp_train_kernel.py`). For every ray it assembles the positional
encoding of xyz = o + d*z at its S samples, runs the static and
transient 8x256 towers (skip at layer 4; viewdir/appearance/time
conditioning per ray), the sigma/rgb/flow heads, and composites the
samples in place, writing ONE (n_map,) row of maps per ray
(`comp_map_cols`).

Rounding points follow the TPU kernel: matmul inputs in bf16, products
accumulated in f32, every activation rounded to bf16 after its ReLU (and
the linear `*_final` features before the next matmul), biases and all
compositing in f32. The posenc sine is the range-reduced degree-9
polynomial `_sin_poly`, which is what the kernel computes.

Weight layout (`pack_padded_weights`): the JAX package's (in, out)
matrices in bf16, with every input segment re-laid at a 128-row boundary
(`SEG`): layer 0 is (128, 256); the skip layer reads `[pe ; h]` through
rows [0, 128) and [128, 384); `static_dir` holds the feature at rows
[0, 256), the direction embedding at [256, 256+27) and the appearance at
[384, 384+48); the transient sigma/rgb/flow heads are one (256, 4|10)
matrix. The CUDA kernel reads this same layout. A tower input (posenc [+
time latent]) wider than one segment takes n = ceil(width / 128)
(`input_segs`): layer 0 is then (128 n, 256) and the skip layer (128 n +
256, 256), h at rows [128 n, 128 n + 256); a direction or appearance
embedding wider than one segment takes as many as it needs, the
appearance after the direction's (`static_dir_rows`). Only the packed
evaluator (B5, `ops/mlp_kernel.py`) reads those layouts, as the JAX
package runs them only in its packed evaluator's unpadded layout. The
planar kernels (B1, B2) and the packed backward (B4) take one segment, as
the JAX kernels (their gradients) do (`check_one_segment`).

`planar_eval_comp` launches `csrc/planar_eval_comp.cu` for CUDA tensors
and runs `planar_eval_comp_ref` for CPU tensors; nothing else chooses
between them.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nsff_pl_tpu_torch.ops.compositing import (deltas_from_zs,
                                               exclusive_cumsum, softplus)
from nsff_pl_tpu_torch.ops.posenc import posenc_freqs

SEG = 128  # row segment of the padded weights (the TPU's lane width)
WIDTH = 256
# posenc frequencies the one-segment tower kernels (B1, B2, B4) take, as
# many as one segment holds (3 + 6 n lanes); `ops/cuda_build.py` passes it
# to nvcc as the C side's MAXF (`csrc/planar_tower.cuh`), so one constant
# bounds both. The packed evaluator (B5) takes any count, from a device
# table (`ops/mlp_kernel.py::freq_table`).
MAX_FREQS = (SEG - 3) // 6


def input_segs(width: int) -> int:
    """The SEG-lane segments a tower input (posenc [+ time latent]) or a
    per-ray embedding of `width` lanes takes in the padded layout:
    ceil(width / SEG), at least one."""
    return max(1, -(-width // SEG))


def static_dir_rows(dir_w: int, n_a: int, encode_a: bool):
    """(first appearance row, rows) of the packed `static_dir`: the feature
    in rows [0, 256), the direction embedding in its segments from row
    256, the appearance (with `encode_a`) in its segments after them."""
    a0 = WIDTH + SEG * input_segs(dir_w)
    return a0, a0 + (SEG * input_segs(n_a) if encode_a else 0)


def check_one_segment(xyz_w: int, n_tau: int, what: str, jax_fn: str) -> None:
    """The width check of the planar kernels (B1, B2) and the packed
    backward (B4): posenc (+ time latent) within one SEG-lane segment. The
    JAX function `jax_fn` refuses wider inputs too (its planar kernels, the
    gradient of its `make_fused_nerf_train`)."""
    if xyz_w + n_tau > SEG:
        raise ValueError(
            f"{what} takes posenc + time latent within one {SEG}-lane "
            f"segment, got {xyz_w} + {n_tau} = {xyz_w + n_tau} lanes; the "
            f"JAX {jax_fn} refuses these widths too (ROADMAP C): train with "
            f"train_backend='xla' (the plain evaluators), serve and evaluate "
            f"with planar_eval='off' (the packed evaluator, B5, takes any "
            f"width)")


def check_samples(S: int, what: str) -> None:
    """The sample-count check of every CUDA wrapper, before any launch:
    the tower and compositor kernels (the planar B1, B2, B3 and the packed
    B4, B5, B6) take any S >= 1 (tiles of 128 samples, the last one partly
    used; the compositors in chunks of a ray, the tail masked)."""
    if S < 1:
        raise ValueError(f"{what} needs at least one sample a ray, got {S}")


def check_cuda(t: torch.Tensor, what: str) -> None:
    """A CUDA wrapper's device check, after its sample check: CPU tensors
    take the plain version through the dispatching function, never the
    wrapper."""
    if not t.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors, got one on {t.device}")


def _sin_poly(x: torch.Tensor) -> torch.Tensor:
    """bf16-grade sin: range-reduce to [-pi, pi], then a degree-9 odd
    polynomial (max abs error 8.7e-5 for |x| <= 1100; posenc arguments
    reach 2^9 * |xyz|, where a hardware fast sine is wrong)."""
    n = torch.round(x * 0.15915494309189535)
    r = x - n * 6.283185307179586
    u = r * r
    return r * (0.999979402976 + u * (-0.166624406237 + u * (
        0.00830899340721 + u * (-0.000192651216281 + u * 2.14793467522e-06))))


def _posenc_tables(freqs, width: int):
    """Per-lane posenc tables: source channel, frequency, identity flag,
    phase (pi/2 on cos lanes, cos(x) = sin(x + pi/2)) and validity."""
    n63 = 3 + 6 * len(freqs)
    chan = np.zeros((width,), np.int64)
    freq = np.zeros((width,), np.float32)
    is_id = np.zeros((width,), np.float32)
    phase = np.zeros((width,), np.float32)
    valid = np.zeros((width,), np.float32)
    for j in range(min(n63, width)):
        valid[j] = 1.0
        if j < 3:
            chan[j], freq[j], is_id[j] = j, 1.0, 1.0
        else:
            k, r = (j - 3) // 6, (j - 3) % 6
            chan[j], freq[j] = r % 3, freqs[k]
            if r >= 3:
                phase[j] = np.pi / 2
    return chan, freq, is_id, phase, valid


def branch_weight_names(*, D, skips, use_viewdir, static_branch, encode_t):
    """The kernel-side weight list (packed transient heads)."""
    static_names = ([f"static_xyz_{i}" for i in range(D)]
                    + ["static_xyz_final"]
                    + (["static_dir"] if use_viewdir else [])
                    + ["static_sigma", "static_rgb"]) if static_branch else []
    transient_names = ([f"transient_xyz_{i}" for i in range(D)]
                       + ["transient_xyz_final", "transient_heads"]
                       ) if encode_t else []
    return static_names, transient_names


def _pad_rows(w: torch.Tensor, layout, total: int) -> torch.Tensor:
    out = w.new_zeros((total, w.shape[1]))
    for (s0, s1), d in layout:
        out[d:d + (s1 - s0)] = w[s0:s1]
    return out


def pack_padded_weights(params, weight_names, *, output_flow, skips, xyz_w,
                        n_tau, dir_w, n_a, encode_a):
    """Params dict -> {name: {"w": bf16 (K_padded, out), "b": f32 (out,)}}
    in the segment-padded layout described in the module docstring; the
    towers' input takes the segments of posenc [+ time latent, with the
    transient tower], the direction and appearance embeddings theirs
    (`input_segs`, `static_dir_rows`)."""
    kin = SEG * input_segs(
        xyz_w + (n_tau if "transient_xyz_0" in weight_names else 0))
    packed = dict(params)
    if "transient_heads" in weight_names:
        names = ["transient_sigma", "transient_rgb"] + [
            f"transient_flow_{f}" for f in ("fw", "bw") if f in output_flow]
        sig = params["transient_sigma"]
        # a model without flow heads gets zero columns in their place
        zero = {"w": sig["w"].new_zeros((sig["w"].shape[0], 3)),
                "b": sig["b"].new_zeros((3,))}
        packed["transient_heads"] = {
            "w": torch.cat([params.get(n, zero)["w"] for n in names], -1),
            "b": torch.cat([params.get(n, zero)["b"] for n in names], -1)}
    out = {}
    for name in weight_names:
        w = packed[name]["w"]
        k = w.shape[0]
        if name == "static_xyz_0":
            w = _pad_rows(w, [((0, xyz_w), 0)], kin)
        elif name in [f"static_xyz_{i}" for i in skips]:
            w = _pad_rows(w, [((0, xyz_w), 0), ((xyz_w, k), kin)],
                          kin + WIDTH)
        elif name == "transient_xyz_0":
            w = _pad_rows(w, [((0, k), 0)], kin)
        elif name in [f"transient_xyz_{i}" for i in skips]:
            inw = xyz_w + n_tau
            w = _pad_rows(w, [((0, inw), 0), ((inw, k), kin)], kin + WIDTH)
        elif name == "static_dir":
            a0, total = static_dir_rows(dir_w, n_a, encode_a)
            layout = [((0, WIDTH), 0), ((WIDTH, WIDTH + dir_w), WIDTH)]
            if encode_a:
                layout.append(((WIDTH + dir_w, WIDTH + dir_w + n_a), a0))
            w = _pad_rows(w, layout, total)
        out[name] = {"w": w.to(torch.bfloat16).contiguous(),
                     "b": packed[name]["b"].float().contiguous()}
    return out


def comp_map_cols(*, encode_t: bool, flow: bool):
    """Column layout of the (N, M) maps output: an ordered
    {name: (start, width)} and the width M, padded to a multiple of 8."""
    cols = {"rgb_fine": (0, 3), "depth_fine": (3, 1)}
    m = 4
    if encode_t:
        cols.update({"transient_rgb_map": (4, 3), "transient_alpha": (7, 1),
                     "_static_rgb_fine": (8, 3), "_static_depth_fine": (11, 1)})
        m = 12
        if flow:
            cols.update({"xyz_fine": (12, 3), "transient_flow_fw": (15, 3),
                         "transient_flow_bw": (18, 3)})
            m = 21
    return cols, (m + 7) // 8 * 8


# ----------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """Exact bf16 products with f32 accumulation (`w` is bf16)."""
    y = x.to(torch.bfloat16).float() @ w.float()
    return y if b is None else y + b


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _posenc_rows(o, d, zs, freqs, flows=None):
    """Posenc pre-activation `xs` and encoding `pe` of xyz = o + d*z
    (+ flow) as (N*S, SEG) f32 rows, ray-major, in the kernels' lane
    layout (`_posenc_tables`): xs_j = o_c f_j + (d_c f_j) z [+ flow_c f_j]."""
    n, S = zs.shape
    chan, freq, is_id, phase, valid = (
        torch.as_tensor(a, device=zs.device)
        for a in _posenc_tables(freqs, SEG))
    o_sel = o[:, chan] * freq  # (N, SEG)
    d_sel = d[:, chan] * freq
    xs = o_sel[:, None, :] + d_sel[:, None, :] * zs[:, :, None]
    if flows is not None:
        xs = xs + torch.stack(flows, -1)[:, :, chan] * freq
    xs = xs.reshape(n * S, SEG)
    pe = torch.where(is_id > 0, xs, _sin_poly(xs + phase)) * valid
    return xs, pe


def _bcast(v: torch.Tensor, S: int) -> torch.Tensor:
    """(N, C) per ray -> (N*S, C) per sample."""
    n = v.shape[0]
    return v[:, None, :].expand(n, S, v.shape[-1]).reshape(n * S, -1)


def _tower_ref(pw, prefix, inp, D, skips, keep=False):
    """The ReLU tower on bf16-valued rows (their width the packing's input
    segments); with `keep`, the list [inp, h_1, ..., h_D] of every layer's
    input and output."""
    acts = [inp]
    h = inp
    kin = inp.shape[1]
    for i in range(D):
        w, b = pw[f"{prefix}_{i}"]["w"], pw[f"{prefix}_{i}"]["b"]
        if i in skips:
            z = _mm(inp, w[:kin]) + _mm(h, w[kin:kin + WIDTH]) + b
        else:
            z = _mm(h, w, b)
        h = _bf16(torch.relu(z))
        acts.append(h)
    return acts if keep else h


def _t_lanes(t_emb, xyz_w, S, width=SEG):
    """The time latent in lanes [xyz_w, xyz_w + n_tau) of a `width`-wide
    per-sample row (the transient tower's input segments)."""
    t_part = t_emb.new_zeros((t_emb.shape[0], width))
    t_part[:, xyz_w:xyz_w + t_emb.shape[1]] = t_emb
    return _bcast(t_part, S)


def planar_eval_comp_ref(pw, o, d, zs, vis, dir_emb, a_emb, t_emb, *,
                         freqs, encode_t: bool, flow_maps: bool,
                         use_viewdir: bool, encode_a: bool, z_far: float,
                         flow_scale: float, n_tau: int, n_map: int,
                         D: int = 8, skips=(4,)) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N, n_map) f32 maps."""
    n, S = zs.shape
    xyz_w = 3 + 6 * len(freqs)
    _, pe = _posenc_rows(o, d, zs, freqs)

    def bcast(v):
        return _bcast(v, S)

    def tower(prefix, inp):
        return _tower_ref(pw, prefix, inp, D, skips)

    def lin(name, x):
        return _mm(x, pw[name]["w"], pw[name]["b"])

    h = tower("static_xyz", _bf16(pe))
    ssig = lin("static_sigma", h)[:, 0]
    feat = _bf16(lin("static_xyz_final", h))
    if use_viewdir:
        w, b = pw["static_dir"]["w"], pw["static_dir"]["b"]
        dir_w = dir_emb.shape[-1]
        ray_z = _mm(dir_emb, w[WIDTH:WIDTH + dir_w]) + b
        if encode_a:
            ray_z = ray_z + _mm(
                a_emb, w[WIDTH + SEG:WIDTH + SEG + a_emb.shape[-1]])
        feat = _bf16(torch.relu(_mm(feat, w[:WIDTH]) + bcast(ray_z)))
    srgb = torch.sigmoid(lin("static_rgb", feat))

    def plane(v):  # (N*S,) -> (N, S)
        return v.reshape(n, S)

    srgb = [plane(srgb[:, c]) for c in range(3)]
    ssig = plane(ssig)
    d_s, d_t = deltas_from_zs(zs)
    tau_s = d_s * softplus(ssig)
    _sw = (1.0 - torch.exp(-tau_s)) * torch.exp(-exclusive_cumsum(tau_s))
    maps = []
    if not encode_t:
        maps += [(_sw * c).sum(-1) for c in srgb] + [(_sw * zs).sum(-1)]
    else:
        tx = _bf16(pe + _t_lanes(t_emb, xyz_w, S))
        h = tower("transient_xyz", tx)
        featb = _bf16(lin("transient_xyz_final", h))
        th = lin("transient_heads", featb)
        tsig = plane(th[:, 0])
        trgb = [plane(torch.sigmoid(th[:, 1 + c])) for c in range(3)]
        if vis is not None:
            tsig = torch.where(vis == 0, torch.full_like(tsig, -10.0), tsig)
        tau_t = d_t * softplus(tsig)
        u = tau_s + tau_t
        T = torch.exp(-exclusive_cumsum(u))
        sw = (1.0 - torch.exp(-tau_s)) * T
        tw = (1.0 - torch.exp(-tau_t)) * T
        w_ = (1.0 - torch.exp(-u)) * T
        maps += [(sw * sc + tw * tc).sum(-1) for sc, tc in zip(srgb, trgb)]
        maps.append((w_ * zs).sum(-1))
        maps += [(tw * tc).sum(-1) for tc in trgb]
        maps.append(tw.sum(-1))
        maps += [(_sw * sc).sum(-1) for sc in srgb]
        maps.append((_sw * zs).sum(-1))
        if flow_maps:
            far = zs > z_far
            maps += [(w_ * (o[:, c:c + 1] + d[:, c:c + 1] * zs)).sum(-1)
                     for c in range(3)]
            for c in range(6):
                fpl = plane(flow_scale * torch.tanh(th[:, 4 + c]))
                maps.append((w_ * torch.where(far, 0.0, fpl)).sum(-1))
    out = torch.stack(maps, -1)
    if out.shape[1] < n_map:
        out = torch.cat([out, out.new_zeros((n, n_map - out.shape[1]))], -1)
    return out


# ----------------------------------------------------------------------
# CUDA kernel wrapper
# ----------------------------------------------------------------------

# weight slots of the C interface (csrc/planar_eval_comp.cu)
_SLOTS = ([f"static_xyz_{i}" for i in range(8)]
          + ["static_xyz_final", "static_dir", "static_sigma", "static_rgb"]
          + [f"transient_xyz_{i}" for i in range(8)]
          + ["transient_xyz_final", "transient_heads"])


def _bind(lib):
    fn = lib.nsff_planar_eval_comp
    P = ctypes.c_void_p
    fn.argtypes = ([P] * 7 + [ctypes.POINTER(P), ctypes.POINTER(P), P]
                   + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_int]
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [P])
    fn.restype = ctypes.c_int
    return fn


def _check(t: Optional[torch.Tensor], name: str, shape, dtype, dev):
    if t is None:
        raise ValueError(f"{name} is required by this kernel configuration")
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {dev}"
                         f", got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def packed_in_rows(pw) -> int:
    """The input rows of packed weights: SEG times their input segments."""
    return next(pw[k]["w"].shape[0] for k in ("static_xyz_0",
                                              "transient_xyz_0") if k in pw)


def _slot_ptrs(pw, names, dev, heads: int, encode_a: bool, kin: int = SEG,
               dir_w: int = SEG, n_a: int = SEG):
    """Checked (w, b) pointer arrays over `_SLOTS` for the packed weights
    `names` of `pw`, whose towers read `kin` input rows and whose
    `static_dir` holds `dir_w` direction and `n_a` appearance lanes."""
    f32 = torch.float32
    wshape = {"static_xyz_0": (kin, WIDTH), "static_xyz_4": (kin + WIDTH, WIDTH),
              "transient_xyz_0": (kin, WIDTH),
              "transient_xyz_4": (kin + WIDTH, WIDTH),
              "static_dir": (static_dir_rows(dir_w, n_a, encode_a)[1], WIDTH),
              "static_sigma": (WIDTH, 1), "static_rgb": (WIDTH, 3),
              "transient_heads": (WIDTH, heads)}
    wp = (ctypes.c_void_p * len(_SLOTS))()
    bp = (ctypes.c_void_p * len(_SLOTS))()
    for i, name in enumerate(_SLOTS):
        if name not in names:
            continue
        shp = wshape.get(name, (WIDTH, WIDTH))
        _check(pw[name]["w"], f"{name}.w", shp, torch.bfloat16, dev)
        _check(pw[name]["b"], f"{name}.b", (shp[1],), f32, dev)
        if pw[name]["w"].data_ptr() % 16 or pw[name]["b"].data_ptr() % 16:
            # TMA tensor maps and the evaluators' 16-byte parameter copies
            raise ValueError(f"{name}: weights must start 16-byte aligned")
        wp[i] = pw[name]["w"].data_ptr()
        bp[i] = pw[name]["b"].data_ptr()
    return wp, bp


def planar_eval_comp_cuda(pw, o, d, zs, vis, dir_emb, a_emb, t_emb, *,
                          freqs, encode_t: bool, flow_maps: bool,
                          use_viewdir: bool, encode_a: bool, z_far: float,
                          flow_scale: float, n_tau: int, n_map: int,
                          D: int = 8, skips=(4,)) -> torch.Tensor:
    """Launch the hand-written Hopper kernel (one CTA per ray, which runs
    the ray's tiles of 128 samples in turn) on the current stream; adds
    one to `planar_eval_comp_cuda.launches[S]`."""
    from nsff_pl_tpu_torch.ops import cuda_build

    dev = o.device
    n, S = zs.shape
    xyz_w = 3 + 6 * len(freqs)
    check_samples(S, "the CUDA kernel")
    check_one_segment(xyz_w, n_tau if encode_t else 0,
                      "the planar serving kernel (B1)",
                      "make_planar_nerf_eval_comp")
    check_cuda(o, "the CUDA kernel")
    if D != 8 or tuple(skips) != (4,):
        raise NotImplementedError("the CUDA kernel is built for D=8, skips=(4,)")
    f32 = torch.float32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(zs, "zs", (n, S), f32, dev)
    if vis is not None:
        _check(vis, "vis", (n, S), f32, dev)
    dir_w = n_a = 0
    if use_viewdir:
        dir_w = dir_emb.shape[-1] if dir_emb is not None else 0
        _check(dir_emb, "dir_emb", (n, dir_w), f32, dev)
        if dir_w > SEG:
            raise ValueError("dir embedding wider than one segment")
        if encode_a:
            n_a = a_emb.shape[-1] if a_emb is not None else 0
            _check(a_emb, "a_emb", (n, n_a), f32, dev)
            if n_a > SEG:
                raise ValueError("appearance embedding wider than a segment")
    if encode_t:
        _check(t_emb, "t_emb", (n, n_tau), f32, dev)
    wp, bp = _slot_ptrs(pw, [k for k in _SLOTS if k in pw], dev,
                        10 if flow_maps else 4, encode_a)
    needed = [f"static_xyz_{i}" for i in range(8)] + [
        "static_xyz_final", "static_sigma", "static_rgb"]
    if use_viewdir:
        needed.append("static_dir")
    if encode_t:
        needed += [f"transient_xyz_{i}" for i in range(8)] + [
            "transient_xyz_final", "transient_heads"]
    missing = [k for k in needed if k not in pw]
    if missing:
        raise ValueError(f"packed weights lack {missing}")

    out = torch.empty((n, n_map), dtype=f32, device=dev)
    if n == 0:
        return out
    fn = _bind(cuda_build.load("planar_eval_comp"))
    cfreqs = (ctypes.c_float * MAX_FREQS)(*[float(f) for f in freqs])

    def ptr(t):
        return t.data_ptr() if t is not None else None

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ptr(o), ptr(d), ptr(zs), ptr(vis),
            ptr(dir_emb) if use_viewdir else None,
            ptr(a_emb) if (use_viewdir and encode_a) else None,
            ptr(t_emb) if encode_t else None,
            wp, bp, out.data_ptr(),
            n, S, xyz_w, dir_w, n_a, cfreqs, len(freqs),
            int(encode_t), int(flow_maps), int(use_viewdir),
            int(use_viewdir and encode_a), int(vis is not None),
            float(z_far), float(flow_scale), n_tau if encode_t else 0,
            n_map, stream)
    if rc != 0:
        raise RuntimeError(f"planar_eval_comp kernel launch failed: "
                           f"cudaError {rc}")
    planar_eval_comp_cuda.launches[S] += 1
    return out


planar_eval_comp_cuda.launches = Counter()  # by sample count


def planar_eval_comp(pw, o, d, zs, vis, dir_emb, a_emb, t_emb, **kw):
    """CUDA tensors launch the kernel; CPU tensors take the plain version.
    Under `torch.export` the call goes through the custom op
    `nsff_torch::planar_eval_comp` (`ops/library.py`), which does the
    same when the exported program runs."""
    if torch.compiler.is_exporting():
        from nsff_pl_tpu_torch.ops import library

        return library.call_planar_eval_comp(pw, o, d, zs, vis, dir_emb,
                                             a_emb, t_emb, **kw)
    if o.is_cuda:
        return planar_eval_comp_cuda(pw, o, d, zs, vis, dir_emb, a_emb,
                                     t_emb, **kw)
    return planar_eval_comp_ref(pw, o, d, zs, vis, dir_emb, a_emb, t_emb,
                                **kw)


def make_planar_nerf_eval_comp(
    n_samples: int,
    *,
    use_viewdir: bool = False,
    encode_a: bool = False,
    encode_t: bool = True,
    output_flow: Tuple[str, ...] = (),
    vis_in: bool = False,
    z_far: float = 0.95,
    n_emb_xyz: int = 10,
    s_emb_xyz: float = 9.0,
    n_emb_dir: int = 4,
    n_a: int = 48,
    n_tau: int = 48,
    flow_scale: float = 0.2,
    D: int = 8,
    skips=(4,),
):
    """Build fn(params, o, d, zs, vis, dir_emb, a_emb, t_emb, pw=None) ->
    (N, M) f32 maps, the JAX function's contract: o/d (N, 3) NDC ray
    origins and directions, zs (N, S) sample depths, vis (N, S)
    visibility counts when `vis_in` (vis == 0 forces transient sigma to
    -10 before the softplus), per-ray embeddings. Flow maps mask samples
    beyond `z_far`. `pw` takes weights already packed by `fn.pack`.
    `fn.cols_map` / `fn.n_map` give the column layout."""
    freqs = tuple(float(f) for f in posenc_freqs(s_emb_xyz, n_emb_xyz))
    xyz_w = 3 + 6 * n_emb_xyz
    dir_w = 3 + 6 * n_emb_dir
    check_one_segment(xyz_w, n_tau if encode_t else 0,
                      "the planar serving kernel (B1)",
                      "make_planar_nerf_eval_comp")
    flow = tuple(f for f in output_flow if f in ("fw", "bw")) \
        if encode_t else ()
    flow_maps = bool(flow)
    head_flow = ("fw", "bw") if flow_maps else ()
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir, static_branch=True,
        encode_t=encode_t)
    weight_names = static_names + transient_names
    cols_map, n_map = comp_map_cols(encode_t=encode_t, flow=flow_maps)
    pack_kw = dict(output_flow=head_flow, skips=skips, xyz_w=xyz_w,
                   n_tau=n_tau, dir_w=dir_w, n_a=n_a, encode_a=encode_a)
    kw = dict(freqs=freqs, encode_t=encode_t, flow_maps=flow_maps,
              use_viewdir=use_viewdir, encode_a=encode_a, z_far=z_far,
              flow_scale=flow_scale, n_tau=n_tau, n_map=n_map, D=D,
              skips=tuple(skips))

    def fn(params: Dict, o, d, zs, vis=None, dir_emb=None, a_emb=None,
           t_emb=None, pw=None):
        if vis_in != (vis is not None):
            raise ValueError(f"vis_in={vis_in} but vis is "
                             f"{'given' if vis is not None else 'None'}")
        if pw is None:
            pw = pack_padded_weights(params, weight_names, **pack_kw)
        return planar_eval_comp(
            pw, o.contiguous(), d.contiguous(), zs.contiguous(),
            vis.contiguous() if vis is not None else None,
            dir_emb.contiguous() if use_viewdir else None,
            a_emb.contiguous() if encode_a else None,
            t_emb.contiguous() if encode_t else None, **kw)

    fn.cols_map = cols_map
    fn.n_map = n_map
    fn.kernel_kw = kw
    fn.pack = lambda params: pack_padded_weights(params, weight_names,
                                                 **pack_kw)
    return fn


# ======================================================================
# Trainable planar evaluator (port of `make_planar_nerf_train`)
# ======================================================================
#
# Forward: the same towers and heads as the composited evaluator, writing
# dense (N, S) planes (`planar_out_keys`) instead of compositing them.
# Warped evaluations (`flow_in`) add a scene-flow plane to xyz before the
# encoding; `static_branch=False` runs the transient tower only.
#
# Backward, one pass per branch (static, transient), as the TPU kernel's
# `_branch_bwd_host`: recompute the tower, backpropagate through the heads
# and the tower with bf16 matmul inputs (every cotangent `dz` rounded to
# bf16 before its products), f32 accumulation, dW/db over all samples,
# per-ray embedding gradients, and for warped calls the flow-plane
# cotangents. o/d/zs are data and get no gradient.
#
# One packing per step: the transient heads are always packed with both
# flow columns ([sigma, rgb(3), fw(3), bw(3)]); a call that outputs one
# flow (or none) gets zero cotangents on the other columns, so their
# weight gradients are exactly zero, as the TPU kernel's narrower head
# matrix gives.

TRAIN_HEADS = ("fw", "bw")
# plane slots of the train kernels' C interface
_TRAIN_PLANES = ("srgb_r", "srgb_g", "srgb_b", "ssig",
                 "trgb_r", "trgb_g", "trgb_b", "tsig",
                 "ffw_x", "ffw_y", "ffw_z", "fbw_x", "fbw_y", "fbw_z")
_HEAD_COL = {"fw": 4, "bw": 7}  # first column of each flow head


def planar_out_keys(*, static_branch: bool, encode_t: bool,
                    output_flow: Tuple[str, ...]):
    """Ordered output-plane names of the trainable evaluator."""
    keys = []
    if static_branch:
        keys += ["srgb_r", "srgb_g", "srgb_b", "ssig"]
    if encode_t:
        keys += ["trgb_r", "trgb_g", "trgb_b", "tsig"]
        if "fw" in output_flow:
            keys += ["ffw_x", "ffw_y", "ffw_z"]
        if "bw" in output_flow:
            keys += ["fbw_x", "fbw_y", "fbw_z"]
    return keys


def unpad_padded_grads(dws, weight_names, *, output_flow, skips, xyz_w,
                       n_tau, dir_w, n_a, encode_a):
    """Padded/packed dW, db ({name: {"w", "b"}}) -> gradients keyed like
    the params dict (port of `ops/mlp_train_kernel.py::unpad_padded_grads`),
    the inverse of `pack_padded_weights` in any number of input segments."""
    def unpad(name, w):
        kin = w.shape[0] - WIDTH  # a skip layer's input rows
        if name == "static_xyz_0":
            return w[:xyz_w]
        if name in [f"static_xyz_{i}" for i in skips]:
            return torch.cat([w[:xyz_w], w[kin:kin + WIDTH]], 0)
        if name == "transient_xyz_0":
            return w[:xyz_w + n_tau]
        if name in [f"transient_xyz_{i}" for i in skips]:
            return torch.cat([w[:xyz_w + n_tau], w[kin:kin + WIDTH]], 0)
        if name == "static_dir":
            parts = [w[:WIDTH], w[WIDTH:WIDTH + dir_w]]
            if encode_a:
                a0 = static_dir_rows(dir_w, n_a, encode_a)[0]
                parts.append(w[a0:a0 + n_a])
            return torch.cat(parts, 0)
        return w

    g = {}
    for name in weight_names:
        dw = unpad(name, dws[name]["w"]).float()
        db = dws[name]["b"].float()
        if name == "transient_heads":
            g["transient_sigma"] = {"w": dw[:, 0:1], "b": db[0:1]}
            g["transient_rgb"] = {"w": dw[:, 1:4], "b": db[1:4]}
            c = 4
            for f in ("fw", "bw"):
                if f in output_flow:
                    g[f"transient_flow_{f}"] = {"w": dw[:, c:c + 3],
                                                "b": db[c:c + 3]}
                    c += 3
        else:
            g[name] = {"w": dw, "b": db}
    return g


def _pad_seg(v: torch.Tensor) -> torch.Tensor:
    """bf16-round a (N, C) per-ray embedding and zero-pad it to SEG lanes."""
    out = v.new_zeros((v.shape[0], SEG))
    out[:, :v.shape[1]] = _bf16(v)
    return out


def _ray_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    """(N*S, C) per sample -> (N, C) sums over each ray's samples."""
    return v.reshape(-1, S, v.shape[-1]).sum(1)


def planar_nerf_train_ref(pw, o, d, zs, flows, dir_emb, a_emb, t_emb, *,
                          freqs, static_branch: bool, use_viewdir: bool,
                          encode_a: bool, encode_t: bool, output_flow,
                          flow_scale: float, D: int = 8,
                          skips=(4,)) -> torch.Tensor:
    """The train kernel's forward in plain PyTorch: (n_out, N, S) f32
    planes in `planar_out_keys` order."""
    n, S = zs.shape
    xyz_w = 3 + 6 * len(freqs)
    _, pe = _posenc_rows(o, d, zs, freqs, flows)
    cols = []
    if static_branch:
        h = _tower_ref(pw, "static_xyz", _bf16(pe), D, skips)
        ssig = _mm(h, pw["static_sigma"]["w"], pw["static_sigma"]["b"])
        feat0 = _mm(h, pw["static_xyz_final"]["w"], pw["static_xyz_final"]["b"])
        if use_viewdir:
            w, b = pw["static_dir"]["w"], pw["static_dir"]["b"]
            ray_z = _mm(dir_emb, w[WIDTH:WIDTH + dir_emb.shape[1]]) + b
            if encode_a:
                ray_z = ray_z + _mm(
                    a_emb, w[WIDTH + SEG:WIDTH + SEG + a_emb.shape[1]])
            feat = _bf16(torch.relu(_mm(feat0, w[:WIDTH]) + _bcast(ray_z, S)))
        else:
            feat = _bf16(feat0)
        srgb = torch.sigmoid(_mm(feat, pw["static_rgb"]["w"],
                                 pw["static_rgb"]["b"]))
        cols += [srgb, ssig]
    if encode_t:
        tx = _bf16(pe + _t_lanes(t_emb, xyz_w, S))
        h = _tower_ref(pw, "transient_xyz", tx, D, skips)
        featb = _bf16(_mm(h, pw["transient_xyz_final"]["w"],
                          pw["transient_xyz_final"]["b"]))
        th = _mm(featb, pw["transient_heads"]["w"], pw["transient_heads"]["b"])
        cols += [torch.sigmoid(th[:, 1:4]), th[:, 0:1]]
        for f in ("fw", "bw"):
            if f in output_flow:
                c = _HEAD_COL[f]
                cols.append(flow_scale * torch.tanh(th[:, c:c + 3]))
    packed = torch.cat(cols, -1)  # (N*S, n_out)
    return packed.T.reshape(packed.shape[1], n, S).contiguous()


def _mmT(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ w.T with exact products and f32 sums (`w` is bf16)."""
    return _bf16(x) @ w.float().T


def _tower_bwd_ref(pw, prefix, acts, dh, dws, D, skips, need_dinp):
    """Backward through the ReLU tower: accumulates dW/db into `dws` and
    returns the cotangent of the tower input (f32) when `need_dinp`."""
    inp = acts[0]
    dinp = None
    for i in range(D - 1, -1, -1):
        w = pw[f"{prefix}_{i}"]["w"]
        dz = dh * (acts[i + 1] > 0)
        dzb = _bf16(dz)
        if i in skips:
            dw = torch.cat([inp.T @ dzb, acts[i].T @ dzb], 0)
            dinp = _mmT(dzb, w[:SEG]) if need_dinp else None
            dh = _mmT(dzb, w[SEG:SEG + WIDTH])
        else:
            dw = acts[i].T @ dzb
            dh = _mmT(dzb, w) if (i > 0 or need_dinp) else None
        dws[f"{prefix}_{i}"] = {"w": dw, "b": dz.sum(0)}
    if not need_dinp:
        return None
    return dh if dinp is None else dinp + dh


def _posenc_adjoint(dinp, xs, freqs, round_ops: bool = False):
    """Cotangent of the sample points from the cotangent `dinp` of the
    (N*S, SEG) encoding rows: dxs = dinp on identity lanes and
    dinp * cos(xs + phase) on sine lanes (the cosine as the polynomial
    sine of xs + phase + pi/2), then the product with the transposed
    selector; `round_ops` rounds both of its operands to bf16. (N*S, 3)."""
    dev = xs.device
    chan, freq, is_id, phase, valid = (
        torch.as_tensor(a, device=dev) for a in _posenc_tables(freqs, SEG))
    dpe = dinp * valid
    dxs = torch.where(is_id > 0, dpe,
                      dpe * _sin_poly(xs + phase + 1.5707963267948966))
    sel = torch.zeros((3, SEG), device=dev)
    sel[chan, torch.arange(SEG, device=dev)] = freq * valid
    if round_ops:
        return _bf16(dxs) @ _bf16(sel).T
    return dxs @ sel.T


def _branch_bwd_rows(branch: str, pw, pe, g, S: int, dir_emb, a_emb, t_emb, *,
                     xyz_w: int, use_viewdir: bool, encode_a: bool,
                     flow_scale: float, need_dinp: bool, D: int = 8,
                     skips=(4,)):
    """One branch of the hand-written backward on (N*S, .) rows, shared by
    the planar and the packed layout. `pe` holds the encoding rows, `g` the
    branch's cotangent columns: static (N*S, 4) [rgb(3), sigma]; transient
    (N*S, 10) [rgb(3), sigma, fw(3), bw(3)]. Returns (out, dinp): out has
    "dws" ({name: {"w": padded f32 dW, "b": db}}) and "ddir"/"da" (static)
    or "dt" (transient); dinp is the f32 cotangent of the tower's input
    rows (always for the transient branch, for the static one only with
    `need_dinp`, else None)."""
    dws, out = {}, {}
    if branch == "static":
        acts = _tower_ref(pw, "static_xyz", _bf16(pe), D, skips, keep=True)
        h8 = acts[-1]
        w_sig = pw["static_sigma"]["w"]
        w_fin, b_fin = pw["static_xyz_final"]["w"], pw["static_xyz_final"]["b"]
        feat0 = _mm(h8, w_fin, b_fin)
        if use_viewdir:
            w_dir, b_dir = pw["static_dir"]["w"], pw["static_dir"]["b"]
            dir_tile = _pad_seg(dir_emb)
            ray_z = dir_tile @ w_dir[WIDTH:WIDTH + SEG].float() + b_dir
            if encode_a:
                a_tile = _pad_seg(a_emb)
                ray_z = ray_z + a_tile @ w_dir[WIDTH + SEG:WIDTH + 2 * SEG].float()
            feat0b = _bf16(feat0)
            feat = torch.relu(feat0b @ w_dir[:WIDTH].float() + _bcast(ray_z, S))
        else:
            feat = feat0
        featb = _bf16(feat)
        w_rgb, b_rgb = pw["static_rgb"]["w"], pw["static_rgb"]["b"]
        s_rgb = torch.sigmoid(_mm(featb, w_rgb, b_rgb))
        g_srgb = g[:, 0:3] * s_rgb * (1.0 - s_rgb)
        g_ssig = g[:, 3:4]
        dws["static_rgb"] = {"w": featb.T @ _bf16(g_srgb), "b": g_srgb.sum(0)}
        dfeat = _mmT(g_srgb, w_rgb)
        if use_viewdir:
            dz = dfeat * (feat > 0)
            dzb = _bf16(dz)
            dzrb = _bf16(_ray_sum(dz, S))
            parts = [feat0b.T @ dzb, dir_tile.T @ dzrb]
            out["ddir"] = _mmT(dzrb, w_dir[WIDTH:WIDTH + dir_emb.shape[1]])
            if encode_a:
                parts.append(a_tile.T @ dzrb)
                out["da"] = _mmT(
                    dzrb, w_dir[WIDTH + SEG:WIDTH + SEG + a_emb.shape[1]])
            dws["static_dir"] = {"w": torch.cat(parts, 0), "b": dz.sum(0)}
            dfeat0 = _mmT(dzb, w_dir[:WIDTH])
        else:
            dfeat0 = dfeat
        dws["static_xyz_final"] = {"w": h8.T @ _bf16(dfeat0),
                                   "b": dfeat0.sum(0)}
        dh8 = _mmT(dfeat0, w_fin)
        g_ssigb = _bf16(g_ssig)
        dws["static_sigma"] = {"w": h8.T @ g_ssigb, "b": g_ssig.sum(0)}
        dh8 = dh8 + _mmT(g_ssigb, w_sig)
        dinp = _tower_bwd_ref(pw, "static_xyz", acts, dh8, dws, D, skips,
                              need_dinp)
    else:
        tx = _bf16(pe + _t_lanes(t_emb, xyz_w, S))
        acts = _tower_ref(pw, "transient_xyz", tx, D, skips, keep=True)
        th8 = acts[-1]
        w_tfin, b_tfin = (pw["transient_xyz_final"]["w"],
                          pw["transient_xyz_final"]["b"])
        tfeatb = _bf16(_mm(th8, w_tfin, b_tfin))
        w_th, b_th = pw["transient_heads"]["w"], pw["transient_heads"]["b"]
        th = _mm(tfeatb, w_th, b_th)
        t_rgb = torch.sigmoid(th[:, 1:4])
        tf = torch.tanh(th[:, 4:10])
        g_th = torch.cat([g[:, 3:4], g[:, 0:3] * t_rgb * (1.0 - t_rgb),
                          g[:, 4:10] * flow_scale * (1.0 - tf * tf)], -1)
        dws["transient_heads"] = {"w": tfeatb.T @ _bf16(g_th),
                                  "b": g_th.sum(0)}
        dtfeat = _mmT(g_th, w_th)
        dws["transient_xyz_final"] = {"w": th8.T @ _bf16(dtfeat),
                                      "b": dtfeat.sum(0)}
        dth8 = _mmT(dtfeat, w_tfin)
        dinp = _tower_bwd_ref(pw, "transient_xyz", acts, dth8, dws, D, skips,
                              True)
        n_tau = t_emb.shape[1]
        out["dt"] = _bf16(_ray_sum(dinp, S))[:, xyz_w:xyz_w + n_tau]
    out["dws"] = dws
    return out, dinp


def planar_nerf_train_bwd_ref(branch: str, pw, o, d, zs, flows, dir_emb,
                              a_emb, t_emb, g, *, freqs, use_viewdir: bool,
                              encode_a: bool, flow_scale: float, D: int = 8,
                              skips=(4,)):
    """One branch of the hand-written backward in plain PyTorch.

    `g` holds the branch's cotangent planes, each (N, S) f32 or None
    (zero): static ("srgb_r", "srgb_g", "srgb_b", "ssig"); transient
    ("trgb_r", "trgb_g", "trgb_b", "tsig", "ffw_x".."ffw_z",
    "fbw_x".."fbw_z"). Returns {"dws": {name: {"w": padded f32 dW,
    "b": db}}} plus "ddir"/"da" (static) or "dt"/"dflows" (transient)."""
    n, S = zs.shape
    xs, pe = _posenc_rows(o, d, zs, freqs, flows)
    keys = _TRAIN_PLANES[0:4] if branch == "static" else _TRAIN_PLANES[4:14]
    cols = [g.get(k) for k in keys]
    cols = [c if c is not None else zs.new_zeros((n, S)) for c in cols]
    g_rows = torch.stack([c.reshape(n * S) for c in cols], -1)
    out, dinp = _branch_bwd_rows(
        branch, pw, pe, g_rows, S, dir_emb, a_emb, t_emb,
        xyz_w=3 + 6 * len(freqs), use_viewdir=use_viewdir, encode_a=encode_a,
        flow_scale=flow_scale, need_dinp=False, D=D, skips=skips)
    if branch != "static" and flows is not None:
        dfl = _posenc_adjoint(dinp, xs, freqs)  # (N*S, 3)
        out["dflows"] = tuple(dfl[:, c].reshape(n, S) for c in range(3))
    return out


# ---------------------------- CUDA kernels -----------------------------

def _train_checks(o, d, zs, flows, dir_emb, a_emb, t_emb, *, freqs,
                  use_viewdir, encode_a, encode_t, n_tau):
    """Shared argument checks of the train kernels; returns (n, dir_w, n_a)."""
    dev = o.device
    n, S = zs.shape
    f32 = torch.float32
    check_samples(S, "the CUDA train kernels")
    check_one_segment(3 + 6 * len(freqs), n_tau,
                      "the planar train kernel (B2)", "make_planar_nerf_train")
    check_cuda(o, "the CUDA train kernels")
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(zs, "zs", (n, S), f32, dev)
    if flows is not None:
        for c, f in enumerate(flows):
            _check(f, f"flows[{c}]", (n, S), f32, dev)
    dir_w = n_a = 0
    if use_viewdir:
        dir_w = dir_emb.shape[-1]
        _check(dir_emb, "dir_emb", (n, dir_w), f32, dev)
        if encode_a:
            n_a = a_emb.shape[-1]
            _check(a_emb, "a_emb", (n, n_a), f32, dev)
        if dir_w > SEG or n_a > SEG:
            raise ValueError("dir/appearance embedding wider than a segment")
    if encode_t:
        _check(t_emb, "t_emb", (n, n_tau), f32, dev)
    return n, dir_w, n_a


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _plane_ptrs(planes: Dict[str, torch.Tensor], names):
    arr = (ctypes.c_void_p * len(names))()
    for i, k in enumerate(names):
        if planes.get(k) is not None:
            arr[i] = planes[k].data_ptr()
    return arr


def planar_nerf_train_fwd_cuda(pw, o, d, zs, flows, dir_emb, a_emb, t_emb, *,
                               freqs, static_branch: bool, use_viewdir: bool,
                               encode_a: bool, encode_t: bool, output_flow,
                               flow_scale: float, D: int = 8,
                               skips=(4,)) -> torch.Tensor:
    """Launch `csrc/planar_nerf_train.cu`'s forward (one CTA per ray and
    tile of 128 samples) on the current stream; adds one to
    `planar_nerf_train_fwd_cuda.launches[S]`."""
    from nsff_pl_tpu_torch.ops import cuda_build

    if D != 8 or tuple(skips) != (4,):
        raise NotImplementedError("the CUDA kernels are built for D=8, skips=(4,)")
    n_tau = t_emb.shape[-1] if encode_t else 0
    n, dir_w, n_a = _train_checks(
        o, d, zs, flows, dir_emb, a_emb, t_emb, freqs=freqs,
        use_viewdir=use_viewdir, encode_a=encode_a, encode_t=encode_t,
        n_tau=n_tau)
    keys = planar_out_keys(static_branch=static_branch, encode_t=encode_t,
                           output_flow=output_flow)
    out = torch.empty((len(keys), n, zs.shape[1]), dtype=torch.float32,
                      device=o.device)
    if n == 0:
        return out
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir,
        static_branch=static_branch, encode_t=encode_t)
    wp, bp = _slot_ptrs(pw, static_names + transient_names, o.device,
                        len(TRAIN_HEADS) * 3 + 4, encode_a)
    fn = cuda_build.load("planar_nerf_train").nsff_planar_train_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 6 + [ctypes.POINTER(P)] * 4
                   + [I] * 5 + [ctypes.POINTER(ctypes.c_float), I] + [I] * 4
                   + [ctypes.c_float, I, P])
    fn.restype = I
    fl = (P * 3)(*[_ptr(f) for f in flows]) if flows is not None else (P * 3)()
    outs = _plane_ptrs(dict(zip(keys, out)), _TRAIN_PLANES)
    cfreqs = (ctypes.c_float * MAX_FREQS)(*[float(f) for f in freqs])
    rc = fn(_ptr(o), _ptr(d), _ptr(zs),
            _ptr(dir_emb) if use_viewdir else None,
            _ptr(a_emb) if use_viewdir and encode_a else None,
            _ptr(t_emb) if encode_t else None, fl, wp, bp, outs,
            n, zs.shape[1], 3 + 6 * len(freqs), dir_w, n_a, cfreqs, len(freqs),
            int(static_branch), int(encode_t), int(use_viewdir),
            int(use_viewdir and encode_a), float(flow_scale), n_tau,
            torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"planar_nerf_train forward launch failed: "
                           f"cudaError {rc}")
    planar_nerf_train_fwd_cuda.launches[zs.shape[1]] += 1
    return out


planar_nerf_train_fwd_cuda.launches = Counter()  # by sample count


def planar_nerf_train_bwd_cuda(branch: str, pw, o, d, zs, flows, dir_emb,
                               a_emb, t_emb, g, *, freqs, use_viewdir: bool,
                               encode_a: bool, flow_scale: float, D: int = 8,
                               skips=(4,)):
    """Launch `csrc/planar_nerf_train.cu`'s backward for one branch on the
    current stream (a chain kernel per ray and tile, the dW kernel and the
    fixed-order reductions); adds one to
    `planar_nerf_train_bwd_cuda.launches[branch][S]`. Same contract as
    `planar_nerf_train_bwd_ref`."""
    from nsff_pl_tpu_torch.ops import cuda_build

    if D != 8 or tuple(skips) != (4,):
        raise NotImplementedError("the CUDA kernels are built for D=8, skips=(4,)")
    static = branch == "static"
    if branch not in ("static", "transient"):
        raise ValueError(f"unknown branch {branch!r}")
    use_viewdir = use_viewdir and static
    encode_a = encode_a and use_viewdir
    n_tau = 0 if static else t_emb.shape[-1]
    n, dir_w, n_a = _train_checks(
        o, d, zs, flows, dir_emb, a_emb, t_emb, freqs=freqs,
        use_viewdir=use_viewdir, encode_a=encode_a, encode_t=not static,
        n_tau=n_tau)
    S = zs.shape[1]
    dev = o.device
    f32 = torch.float32
    gkeys = _TRAIN_PLANES[0:4] if static else _TRAIN_PLANES[4:14]
    for k in gkeys:
        if g.get(k) is not None:
            _check(g[k], f"g[{k}]", (n, S), f32, dev)
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir, static_branch=True,
        encode_t=True)
    names = static_names if static else transient_names
    wp, bp = _slot_ptrs(pw, names, dev, len(TRAIN_HEADS) * 3 + 4, encode_a)
    dws = {name: {"w": torch.empty(pw[name]["w"].shape, dtype=f32, device=dev),
                  "b": torch.empty(pw[name]["b"].shape, dtype=f32, device=dev)}
           for name in names}
    out = {"dws": dws}
    if static:
        if use_viewdir:
            out["ddir"] = torch.empty((n, dir_w), dtype=f32, device=dev)
        if encode_a:
            out["da"] = torch.empty((n, n_a), dtype=f32, device=dev)
    else:
        out["dt"] = torch.empty((n, n_tau), dtype=f32, device=dev)
        if flows is not None:
            out["dflows"] = tuple(torch.empty((n, S), dtype=f32, device=dev)
                                  for _ in range(3))
    lib = cuda_build.load("planar_nerf_train")
    P, I = ctypes.c_void_p, ctypes.c_int
    size_fn = lib.nsff_planar_train_bwd_scratch_bytes
    size_fn.argtypes = [I] * 5
    size_fn.restype = ctypes.c_size_t
    scratch = torch.empty((int(size_fn(int(static), n, S, int(use_viewdir),
                                       int(encode_a))),),
                          dtype=torch.uint8, device=dev)
    dwp = (P * len(_SLOTS))()
    dbp = (P * len(_SLOTS))()
    for i, name in enumerate(_SLOTS):
        if name in dws:
            dwp[i] = dws[name]["w"].data_ptr()
            dbp[i] = dws[name]["b"].data_ptr()
    fn = lib.nsff_planar_train_bwd
    fn.argtypes = ([I] + [P] * 6 + [ctypes.POINTER(P)] * 6 + [P] * 3
                   + [ctypes.POINTER(P), P]
                   + [I] * 5 + [ctypes.POINTER(ctypes.c_float), I] + [I] * 2
                   + [ctypes.c_float, I, P])
    fn.restype = I
    fl = (P * 3)(*[_ptr(f) for f in flows]) if flows is not None else (P * 3)()
    dfl = out.get("dflows")
    dflp = (P * 3)(*[_ptr(f) for f in dfl]) if dfl is not None else (P * 3)()
    cfreqs = (ctypes.c_float * MAX_FREQS)(*[float(f) for f in freqs])
    rc = fn(int(static), _ptr(o), _ptr(d), _ptr(zs),
            _ptr(dir_emb) if use_viewdir else None,
            _ptr(a_emb) if encode_a else None,
            _ptr(t_emb) if not static else None,
            fl, wp, bp, _plane_ptrs(g, gkeys), dwp, dbp,
            _ptr(out.get("ddir")), _ptr(out.get("da")), _ptr(out.get("dt")),
            dflp, scratch.data_ptr(), n, S, 3 + 6 * len(freqs), dir_w, n_a,
            cfreqs, len(freqs), int(use_viewdir), int(encode_a),
            float(flow_scale), n_tau,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"planar_nerf_train backward ({branch}) launch "
                           f"failed: cudaError {rc}")
    planar_nerf_train_bwd_cuda.launches[branch][S] += 1
    return out


# by branch, then by sample count
planar_nerf_train_bwd_cuda.launches = {"static": Counter(),
                                       "transient": Counter()}


def planar_nerf_train_fwd(pw, o, d, zs, flows, dir_emb, a_emb, t_emb, **kw):
    """CUDA tensors launch the kernel; CPU tensors take the plain version.
    Under `torch.export` the call goes through the custom op
    `nsff_torch::planar_nerf_train_fwd` (`ops/library.py`), which does the
    same when the exported program runs."""
    if torch.compiler.is_exporting():
        from nsff_pl_tpu_torch.ops import library

        return library.call_planar_nerf_train_fwd(pw, o, d, zs, flows,
                                                  dir_emb, a_emb, t_emb, **kw)
    if o.is_cuda:
        return planar_nerf_train_fwd_cuda(pw, o, d, zs, flows, dir_emb,
                                          a_emb, t_emb, **kw)
    return planar_nerf_train_ref(pw, o, d, zs, flows, dir_emb, a_emb, t_emb,
                                 **kw)


def planar_nerf_train_bwd(branch, pw, o, d, zs, flows, dir_emb, a_emb, t_emb,
                          g, **kw):
    """CUDA tensors launch the kernels; CPU tensors take the plain version."""
    if o.is_cuda:
        return planar_nerf_train_bwd_cuda(branch, pw, o, d, zs, flows,
                                          dir_emb, a_emb, t_emb, g, **kw)
    return planar_nerf_train_bwd_ref(branch, pw, o, d, zs, flows, dir_emb,
                                     a_emb, t_emb, g, **kw)


class _PlanarNerfTrain(torch.autograd.Function):
    """Planes of one evaluation; differentiable in the unpadded params
    (passed as `leaves` so autograd reaches them), the flow planes and the
    per-ray embeddings. The packed weights `pw` travel beside them."""

    @staticmethod
    def forward(ctx, op, names, pw, o, d, zs, f0, f1, f2, dir_emb, a_emb,
                t_emb, *leaves):
        flows = (f0, f1, f2) if f0 is not None else None
        ctx.op, ctx.names, ctx.pw = op, names, pw
        ctx.save_for_backward(o, d, zs, f0, f1, f2, dir_emb, a_emb, t_emb)
        return planar_nerf_train_fwd(pw, o, d, zs, flows, dir_emb, a_emb,
                                     t_emb, **op.kernel_kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        op = ctx.op
        o, d, zs, f0, f1, f2, dir_emb, a_emb, t_emb = ctx.saved_tensors
        flows = (f0, f1, f2) if f0 is not None else None
        gd = {k: g[i].contiguous() for i, k in enumerate(op.out_keys)}
        kw = {k: op.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                           "flow_scale", "D", "skips")}
        dws, ddir, da, dt, dfl = {}, None, None, None, (None,) * 3
        for branch in (["static"] if op.static_branch else []) + (
                ["transient"] if op.encode_t else []):
            r = planar_nerf_train_bwd(branch, ctx.pw, o, d, zs, flows,
                                      dir_emb, a_emb, t_emb, gd, **kw)
            dws.update(r["dws"])
            ddir, da = r.get("ddir", ddir), r.get("da", da)
            dt, dfl = r.get("dt", dt), r.get("dflows", dfl)
        dparams = unpad_padded_grads(dws, op.weight_names, **op.unpad_kw)
        grads = [dparams[name][part] for name, part in ctx.names]
        return (None, None, None, None, None, None, *dfl, ddir, da, dt,
                *grads)


def make_planar_nerf_train(
    n_samples: int,
    *,
    static_branch: bool = True,
    flow_in: bool = False,
    use_viewdir: bool = False,
    encode_a: bool = False,
    encode_t: bool = True,
    output_flow: Tuple[str, ...] = (),
    n_emb_xyz: int = 10,
    s_emb_xyz: float = 9.0,
    n_emb_dir: int = 4,
    n_a: int = 48,
    n_tau: int = 48,
    flow_scale: float = 0.2,
    D: int = 8,
    skips=(4,),
):
    """Build fn(params, o, d, zs, flows, dir_emb, a_emb, t_emb, pw=None) ->
    dict of dense (N, S) planes (`planar_out_keys`), the JAX function's
    contract: o/d (N, 3) rays, zs (N, S) depths (xyz = o + d*z is formed
    in the kernel), flows a 3-tuple of (N, S) planes added to xyz when
    `flow_in`. Differentiable in params, flows and the per-ray
    embeddings. Flow planes are raw (flow_scale * tanh); the caller
    applies the z > z_far mask outside, so autograd carries it.

    `pw` takes weights already packed by `fn.pack` (once per step for
    every call that shares them); by default each call packs its own."""
    freqs = tuple(float(f) for f in posenc_freqs(s_emb_xyz, n_emb_xyz))
    xyz_w = 3 + 6 * n_emb_xyz
    dir_w = 3 + 6 * n_emb_dir
    check_one_segment(xyz_w, n_tau if encode_t else 0,
                      "the planar train kernel (B2)", "make_planar_nerf_train")
    use_viewdir = use_viewdir and static_branch
    encode_a = encode_a and static_branch
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir,
        static_branch=static_branch, encode_t=encode_t)

    weight_names = static_names + transient_names
    pack_kw = dict(output_flow=TRAIN_HEADS, skips=skips, xyz_w=xyz_w,
                   n_tau=n_tau, dir_w=dir_w, n_a=n_a, encode_a=encode_a)
    param_names = [n for n in weight_names if n != "transient_heads"] + (
        ["transient_sigma", "transient_rgb"]
        + [f"transient_flow_{f}" for f in TRAIN_HEADS] if encode_t else [])
    # static configuration handed to the autograd Function
    op = SimpleNamespace(
        static_branch=static_branch, encode_t=encode_t,
        out_keys=planar_out_keys(static_branch=static_branch,
                                 encode_t=encode_t, output_flow=output_flow),
        weight_names=weight_names, unpad_kw=pack_kw,
        leaves=[(n, part) for n in param_names for part in ("w", "b")],
        kernel_kw=dict(freqs=freqs, static_branch=static_branch,
                       use_viewdir=use_viewdir, encode_a=encode_a,
                       encode_t=encode_t, output_flow=tuple(output_flow),
                       flow_scale=flow_scale, D=D, skips=tuple(skips)))

    def pack(params):
        with torch.no_grad():
            return pack_padded_weights(params, op.weight_names, **pack_kw)

    def fn(params: Dict, o, d, zs, flows=None, dir_emb=None, a_emb=None,
           t_emb=None, pw=None):
        if zs.shape[1] != n_samples:
            raise ValueError(f"zs has {zs.shape[1]} samples, op built for "
                             f"{n_samples}")
        if flow_in != (flows is not None):
            raise ValueError(f"flow_in={flow_in} but flows is "
                             f"{'given' if flows is not None else 'None'}")
        fl = tuple(f.contiguous() for f in flows) if flow_in else (None,) * 3
        # a model without flow heads (the coarse one) has no leaves there
        names = [(n, part) for n, part in op.leaves if n in params]
        leaves = [params[name][part] for name, part in names]
        planes = _PlanarNerfTrain.apply(
            op, names, pack(params) if pw is None else pw, o.contiguous(),
            d.contiguous(), zs.contiguous(), *fl,
            dir_emb.contiguous() if use_viewdir else None,
            a_emb.contiguous() if encode_a else None,
            t_emb.contiguous() if encode_t else None, *leaves)
        return {k: planes[i] for i, k in enumerate(op.out_keys)}

    fn.out_keys = op.out_keys
    fn.weight_names = weight_names
    fn.pack_kw = pack_kw
    fn.kernel_kw = op.kernel_kw
    fn.pack = pack
    return fn
