"""Packed-boundary NeRF evaluator: CUDA kernel + plain PyTorch version.

Port of `nsff_pl_tpu/ops/mlp_kernel.py::make_fused_nerf_eval`. For given
sample points xyz (N, S, 3) and per-ray conditioning (direction,
appearance and time embeddings, (N, C) each) it evaluates the positional
encoding, the static 8x256 tower with its heads and the transient tower
with the packed transient heads, and returns the reference's packed
(N, S, 16) f32 layout

    [static_rgb(3), static_sigma, transient_rgb(3), transient_sigma,
     flow(3), flow(3), 0, 0]

where the flow columns hold the heads of `output_flow` in the order fw,
bw, unmasked (`flow_scale * tanh`; the renderer masks samples beyond
z_far). Sigmas are raw (pre-softplus). `static_branch=False` leaves
columns 0-3 zero; without `encode_t` columns 4-15 are zero.

Rounding points, weight layout and the posenc tables are those of
`ops/raymarch_kernel.py` (bf16 matmul inputs, f32 accumulation, bf16
activations, f32 biases; `pack_padded_weights`). The posenc
pre-activation of lane j is `x_c * f_j`, one f32 product, as the TPU
kernel's selector matmul gives. The transient heads are always packed
10 wide ([sigma, rgb, fw, bw]; zero columns where the model has no flow
head) and `output_flow` picks the columns that are written, so one
packing serves every evaluation of a step.

`fused_nerf_eval` launches `csrc/fused_nerf_eval.cu` for CUDA tensors and
runs `fused_nerf_eval_ref` for CPU tensors; nothing else chooses between
them. The CUDA kernel takes any S >= 1: one CTA per (ray, tile of 128
samples), the rows past S of a partly used last tile computed and not
written. It takes a tower input (posenc [+ time latent]) of any width,
as the JAX kernel does in its unpadded layout past one segment: the
packing then has n = ceil(width / 128) input segments
(`pack_padded_weights`), the rounding points stay (bf16 of pe + t, the
per-ray direction bias), and the kernel runs its instance for one, two,
or more segments (the last streams them through two resident buffers).
It reads any count of posenc frequencies from a device table
(`freq_table`). Past one input segment it also takes direction and
appearance embeddings wider than one segment, as JAX's unpadded layout
does; within one segment it refuses them, as JAX raises or is wrong there
(`check_embedding_widths`).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Tuple

import torch

from nsff_pl_tpu_torch.ops.posenc import posenc_freqs
from nsff_pl_tpu_torch.ops.raymarch_kernel import (
    _HEAD_COL, SEG, TRAIN_HEADS, WIDTH, _bcast, _bf16, _check, _mm,
    _posenc_tables, _ptr, _sin_poly, _slot_ptrs, _t_lanes, _tower_ref,
    branch_weight_names, check_cuda, check_one_segment, check_samples,
    input_segs, pack_padded_weights, packed_in_rows, static_dir_rows)

N_PACKED = 16  # columns of the packed output
# the least input segments that the kernel's streamed instance runs (below
# it, the segments stay resident); the card's tests lower it to hold the
# streamed instance against the resident ones, bit for bit
STREAM_FROM = 3


def unpack_fused(out: torch.Tensor, *, encode_t: bool,
                 output_flow: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Split the packed (N, S, 16) output into the renderer's quantities."""
    res = {"static_rgbs": out[..., 0:3], "static_sigmas_raw": out[..., 3]}
    if encode_t:
        res["transient_rgbs"] = out[..., 4:7]
        res["transient_sigmas_raw"] = out[..., 7]
        c = 8
        for f in TRAIN_HEADS:
            if f in output_flow:
                res[f"transient_flows_{f}"] = out[..., c:c + 3]
                c += 3
    return res


def posenc_rows_xyz(xyz: torch.Tensor, freqs, width: int = SEG):
    """Posenc pre-activation `xs` and encoding `pe` of given points as
    (N*S, width) f32 rows in the kernels' lane layout: xs_j = x_c * f_j."""
    chan, freq, is_id, phase, valid = (
        torch.as_tensor(a, device=xyz.device)
        for a in _posenc_tables(freqs, width))
    xs = xyz.reshape(-1, 3)[:, chan] * freq
    pe = torch.where(is_id > 0, xs, _sin_poly(xs + phase)) * valid
    return xs, pe


def fused_nerf_eval_ref(pw, xyz, dir_emb, a_emb, t_emb, *, freqs,
                        static_branch: bool, use_viewdir: bool,
                        encode_a: bool, encode_t: bool, output_flow,
                        flow_scale: float, D: int = 8,
                        skips=(4,)) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N, S, 16) f32, on the
    input segments of the packing `pw`."""
    n, S = xyz.shape[0], xyz.shape[1]
    xyz_w = 3 + 6 * len(freqs)
    kin = packed_in_rows(pw)
    _, pe = posenc_rows_xyz(xyz, freqs, kin)
    out = xyz.new_zeros((n * S, N_PACKED))
    if static_branch:
        h = _tower_ref(pw, "static_xyz", _bf16(pe), D, skips)
        out[:, 3:4] = _mm(h, pw["static_sigma"]["w"], pw["static_sigma"]["b"])
        feat0 = _mm(h, pw["static_xyz_final"]["w"], pw["static_xyz_final"]["b"])
        if use_viewdir:
            w, b = pw["static_dir"]["w"], pw["static_dir"]["b"]
            dir_w = dir_emb.shape[1]
            ray_z = _mm(dir_emb, w[WIDTH:WIDTH + dir_w]) + b
            if encode_a:
                a0 = static_dir_rows(dir_w, a_emb.shape[1], True)[0]
                ray_z = ray_z + _mm(a_emb, w[a0:a0 + a_emb.shape[1]])
            feat = _bf16(torch.relu(_mm(feat0, w[:WIDTH]) + _bcast(ray_z, S)))
        else:
            feat = _bf16(feat0)
        out[:, 0:3] = torch.sigmoid(_mm(feat, pw["static_rgb"]["w"],
                                        pw["static_rgb"]["b"]))
    if encode_t:
        tx = _bf16(pe + _t_lanes(t_emb, xyz_w, S, kin))
        h = _tower_ref(pw, "transient_xyz", tx, D, skips)
        featb = _bf16(_mm(h, pw["transient_xyz_final"]["w"],
                          pw["transient_xyz_final"]["b"]))
        th = _mm(featb, pw["transient_heads"]["w"], pw["transient_heads"]["b"])
        out[:, 4:7] = torch.sigmoid(th[:, 1:4])
        out[:, 7:8] = th[:, 0:1]
        c = 8
        for f in TRAIN_HEADS:
            if f in output_flow:
                h0 = _HEAD_COL[f]
                out[:, c:c + 3] = flow_scale * torch.tanh(th[:, h0:h0 + 3])
                c += 3
    return out.reshape(n, S, N_PACKED)


def check_train_width(xyz_w: int, n_tau: int) -> None:
    """The packed backward's (B4's) width check: posenc (+ time latent) in
    one segment, where the gradient of the JAX `make_fused_nerf_train`
    works too."""
    check_one_segment(xyz_w, n_tau, "the packed backward (B4)",
                      "make_fused_nerf_train (its gradient)")


def check_embedding_widths(lanes: int, dir_w: int, n_a: int) -> None:
    """Direction (`dir_w`) and appearance (`n_a`) embeddings wider than one
    segment are taken where the tower input (`lanes`: posenc [+ time
    latent]) is wider than one too. The JAX kernel then runs its unpadded
    layout, which takes them; within one segment it runs its padded
    layout, which raises at them or, with both, overlaps their rows."""
    if lanes <= SEG and (dir_w > SEG or n_a > SEG):
        raise ValueError(
            f"a direction ({dir_w} lanes) or appearance ({n_a}) embedding "
            f"wider than one {SEG}-lane segment, with a tower input of "
            f"{lanes} lanes (one segment): the JAX packed evaluator raises "
            f"at these widths or, with both, is wrong (its padded layout "
            f"overlaps their rows; ROADMAP C). It runs them with a tower "
            f"input wider than {SEG} lanes (its unpadded layout), and so does "
            f"the port; else render with the plain evaluators "
            f"(mlp_backend='xla')")


def packed_checks(xyz, dir_emb, a_emb, t_emb, *, freqs, use_viewdir,
                  encode_a, encode_t, pw=None, backward=False):
    """Argument checks shared by the packed kernels' wrappers: the
    evaluator (B5) takes as many input segments as its packed weights
    `pw` have; the backward (B4, `backward`) one. Returns (n, dir_w, n_a,
    n_tau)."""
    dev, f32 = xyz.device, torch.float32
    if xyz.ndim != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz: shape {tuple(xyz.shape)} is not (N, S, 3)")
    n, S = xyz.shape[0], xyz.shape[1]
    check_samples(S, "the packed CUDA kernels (B4, B5)")
    n_tau = t_emb.shape[-1] if encode_t and t_emb is not None else 0
    xyz_w = 3 + 6 * len(freqs)
    if backward:
        check_train_width(xyz_w, n_tau)
    else:
        kin = packed_in_rows(pw) if pw is not None else SEG
        if input_segs(xyz_w + n_tau) * SEG > kin:
            raise ValueError(f"posenc + time latent of {xyz_w + n_tau} "
                             f"lanes, packed weights of {kin} input rows")
    _check(xyz, "xyz", (n, S, 3), f32, dev)
    dir_w = n_a = 0
    if use_viewdir:
        dir_w = dir_emb.shape[-1] if dir_emb is not None else 0
        _check(dir_emb, "dir_emb", (n, dir_w), f32, dev)
        if encode_a:
            n_a = a_emb.shape[-1] if a_emb is not None else 0
            _check(a_emb, "a_emb", (n, n_a), f32, dev)
        check_embedding_widths(xyz_w + n_tau, dir_w, n_a)
    if encode_t:
        _check(t_emb, "t_emb", (n, n_tau), f32, dev)
    return n, dir_w, n_a, n_tau


@functools.lru_cache(maxsize=None)
def freq_table(freqs: Tuple[float, ...], device) -> torch.Tensor:
    """The posenc frequencies as an f32 device tensor, which B5 reads
    (any count). Made once per frequency tuple and device, by fills on
    the device (a copy from the host would wait on it, which a captured
    CUDA graph cannot hold), outside inference mode, as `ops/posenc.py`
    keeps its own."""
    with torch.inference_mode(False):
        return torch.stack([torch.full((), f, dtype=torch.float32,
                                       device=device) for f in freqs])


def fused_nerf_eval_cuda(pw, xyz, dir_emb, a_emb, t_emb, *, freqs,
                         static_branch: bool, use_viewdir: bool,
                         encode_a: bool, encode_t: bool, output_flow,
                         flow_scale: float, D: int = 8,
                         skips=(4,)) -> torch.Tensor:
    """Launch `csrc/fused_nerf_eval.cu` (one CTA per (ray, tile); its
    instance for the input segments of the packed weights) on the current
    stream; adds one to `fused_nerf_eval_cuda.launches[S]`."""
    from nsff_pl_tpu_torch.ops import cuda_build

    if D != 8 or tuple(skips) != (4,):
        raise NotImplementedError("the CUDA kernels are built for D=8, skips=(4,)")
    if not (static_branch or encode_t):
        raise ValueError("neither branch is evaluated")
    use_viewdir = use_viewdir and static_branch
    encode_a = encode_a and use_viewdir
    n, dir_w, n_a, n_tau = packed_checks(
        xyz, dir_emb, a_emb, t_emb, freqs=freqs, use_viewdir=use_viewdir,
        encode_a=encode_a, encode_t=encode_t, pw=pw)
    check_cuda(xyz, "the packed CUDA kernel (B5)")
    kin = packed_in_rows(pw)
    out = torch.empty((n, xyz.shape[1], N_PACKED), dtype=torch.float32,
                      device=xyz.device)
    if n == 0:
        return out
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir,
        static_branch=static_branch, encode_t=encode_t)
    wp, bp = _slot_ptrs(pw, static_names + transient_names, xyz.device,
                        len(TRAIN_HEADS) * 3 + 4, encode_a, kin, dir_w, n_a)
    fn = cuda_build.load("fused_nerf_eval").nsff_fused_eval
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 4 + [ctypes.POINTER(P)] * 2 + [P] + [I] * 5
                   + [P, I] + [I] * 6 + [ctypes.c_float, I, I, I, P])
    fn.restype = I
    ftab = freq_table(tuple(float(f) for f in freqs), xyz.device)
    rc = fn(_ptr(xyz), _ptr(dir_emb) if use_viewdir else None,
            _ptr(a_emb) if encode_a else None,
            _ptr(t_emb) if encode_t else None, wp, bp, out.data_ptr(),
            n, xyz.shape[1], 3 + 6 * len(freqs), dir_w, n_a,
            ftab.data_ptr(), len(freqs),
            int(static_branch), int(encode_t), int(use_viewdir),
            int(encode_a), int(encode_t and "fw" in output_flow),
            int(encode_t and "bw" in output_flow), float(flow_scale), n_tau,
            kin // SEG, STREAM_FROM,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_nerf_eval kernel launch failed: "
                           f"cudaError {rc}")
    fused_nerf_eval_cuda.launches[xyz.shape[1]] += 1
    return out


fused_nerf_eval_cuda.launches = Counter()  # by sample count


def fused_nerf_eval(pw, xyz, dir_emb, a_emb, t_emb, **kw):
    """CUDA tensors launch the kernel; CPU tensors take the plain version.
    Under `torch.export` the call goes through the custom op
    `nsff_torch::fused_nerf_eval` (`ops/library.py`), which does the same
    when the exported program runs."""
    if torch.compiler.is_exporting():
        from nsff_pl_tpu_torch.ops import library

        return library.call_fused_nerf_eval(pw, xyz, dir_emb, a_emb, t_emb,
                                            **kw)
    if xyz.is_cuda:
        return fused_nerf_eval_cuda(pw, xyz, dir_emb, a_emb, t_emb, **kw)
    return fused_nerf_eval_ref(pw, xyz, dir_emb, a_emb, t_emb, **kw)


def packed_op_config(*, use_viewdir, encode_a, encode_t, output_flow,
                     n_emb_xyz, s_emb_xyz, n_emb_dir, n_a, n_tau, flow_scale,
                     D, skips, static_branch):
    """(weight_names, pack_kw, kernel_kw) of a packed evaluator, shared
    with `ops/mlp_train_kernel.py`."""
    use_viewdir = use_viewdir and static_branch
    encode_a = encode_a and use_viewdir
    static_names, transient_names = branch_weight_names(
        D=D, skips=skips, use_viewdir=use_viewdir,
        static_branch=static_branch, encode_t=encode_t)
    pack_kw = dict(output_flow=TRAIN_HEADS, skips=skips,
                   xyz_w=3 + 6 * n_emb_xyz, n_tau=n_tau,
                   dir_w=3 + 6 * n_emb_dir, n_a=n_a, encode_a=encode_a)
    kernel_kw = dict(
        freqs=tuple(float(f) for f in posenc_freqs(s_emb_xyz, n_emb_xyz)),
        static_branch=static_branch, use_viewdir=use_viewdir,
        encode_a=encode_a, encode_t=encode_t,
        output_flow=tuple(f for f in output_flow if f in TRAIN_HEADS)
        if encode_t else (),
        flow_scale=flow_scale, D=D, skips=tuple(skips))
    return static_names + transient_names, pack_kw, kernel_kw


def make_fused_nerf_eval(
    n_samples: int,
    *,
    use_viewdir: bool,
    encode_a: bool,
    encode_t: bool,
    output_flow: Tuple[str, ...],
    n_emb_xyz: int = 10,
    s_emb_xyz: float = 9.0,
    n_emb_dir: int = 4,
    n_a: int = 48,
    n_tau: int = 48,
    flow_scale: float = 0.2,
    D: int = 8,
    skips=(4,),
    static_branch: bool = True,
):
    """Build fn(params, xyz, dir_emb=None, a_emb=None, t_emb=None, pw=None)
    -> (N, S, 16), the JAX function's contract: xyz (N, S, 3), per-ray
    (N, C) conditioning embeddings. No gradient (`ops/mlp_train_kernel.py`
    is the trainable form). `pw` takes weights already packed by `fn.pack`.
    The posenc [+ time latent] may take any number of input segments;
    direction and appearance embeddings wider than one segment only where
    it takes more than one (`check_embedding_widths`)."""
    use_dir = use_viewdir and static_branch
    check_embedding_widths(
        3 + 6 * n_emb_xyz + (n_tau if encode_t else 0),
        3 + 6 * n_emb_dir if use_dir else 0,
        n_a if use_dir and encode_a else 0)
    weight_names, pack_kw, kernel_kw = packed_op_config(
        use_viewdir=use_viewdir, encode_a=encode_a, encode_t=encode_t,
        output_flow=output_flow, n_emb_xyz=n_emb_xyz, s_emb_xyz=s_emb_xyz,
        n_emb_dir=n_emb_dir, n_a=n_a, n_tau=n_tau, flow_scale=flow_scale,
        D=D, skips=skips, static_branch=static_branch)

    def pack(params):
        with torch.no_grad():
            return pack_padded_weights(params, weight_names, **pack_kw)

    def fn(params: Dict, xyz, dir_emb=None, a_emb=None, t_emb=None, pw=None):
        if xyz.shape[1] != n_samples:
            raise ValueError(f"xyz has {xyz.shape[1]} samples, evaluator "
                             f"built for {n_samples}")
        if encode_t and t_emb.shape[-1] != n_tau:
            raise ValueError(f"evaluator built for n_tau={n_tau}, t_emb has "
                             f"{t_emb.shape[-1]}")
        with torch.no_grad():
            return fused_nerf_eval(
                pack(params) if pw is None else pw, xyz.contiguous(),
                dir_emb.contiguous() if kernel_kw["use_viewdir"] else None,
                a_emb.contiguous() if kernel_kw["encode_a"] else None,
                t_emb.contiguous() if encode_t else None, **kernel_kw)

    fn.weight_names = weight_names
    fn.pack_kw = pack_kw
    fn.kernel_kw = kernel_kw
    fn.pack = pack
    return fn
