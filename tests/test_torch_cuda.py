"""The port's CUDA kernels on the card, each against its plain PyTorch
version at full width. Marked `cuda`; they skip without a card. This file
imports no JAX (the card's machine has none), so it runs there alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from nsff_pl_tpu_torch.ops import raymarch_kernel as trk


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("encode_t,flow,vis_in", [
    (True, (), False), (True, ("fw", "bw"), True), (False, (), False)])
def test_cuda_kernel_matches_plain(encode_t, flow, vis_in, n):
    """planar_eval_comp at S=128, 8x256 towers, N_tau=48, for one ray, an
    odd ray count and 4096 rays; tolerance as in chip_smoke.py (same bf16
    rounding points, f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn

    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    s = 128
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.linspace(0, 1, s).expand(n, s).contiguous()
    vis = (torch.rand(n, s, generator=g) > 0.3).float()
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, 48, generator=g)
    o, d, zs, vis, dirs, t = (x.cuda() for x in (o, d, zs, vis, dirs, t))
    fn = trk.make_planar_nerf_eval_comp(s, use_viewdir=True,
                                        encode_t=encode_t, output_flow=flow,
                                        vis_in=vis_in)
    args = (fn.pack(params), o, d, zs, vis if vis_in else None, dirs, None,
            t if encode_t else None)
    before = trk.planar_eval_comp_cuda.launches
    got = trk.planar_eval_comp(*args, **fn.kernel_kw)
    torch.cuda.synchronize()
    assert trk.planar_eval_comp_cuda.launches == before + 1
    want = trk.planar_eval_comp_ref(*args, **fn.kernel_kw)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


def _train_inputs(n, flow_in, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, 128, generator=g), 1).values
    flows = tuple(0.05 * torch.randn(n, 128, generator=g) for _ in range(3)) \
        if flow_in else None
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, 48, generator=g)
    cuda = lambda x: x.cuda().contiguous()  # noqa: E731
    return (cuda(o), cuda(d), cuda(zs),
            tuple(cuda(f) for f in flows) if flow_in else None,
            cuda(dirs), cuda(t), g)


# (static_branch, flow_in, output_flow, use_viewdir, encode_a, encode_t):
# main, main without the view direction, main with the appearance
# embedding, the static-only model (no transient branch), fw warp, bw warp
TRAIN_VARIANTS = {
    "main": (True, False, ("fw", "bw"), True, False, True),
    "main_no_viewdir": (True, False, ("fw", "bw"), False, False, True),
    "main_encode_a": (True, False, ("fw", "bw"), True, True, True),
    "static_only": (True, False, (), True, False, False),
    "fw_warp": (False, True, ("bw",), True, False, True),
    "bw_warp": (False, True, ("fw",), True, False, True)}


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-12)


def _train_setup(variant, n):
    from nsff_pl_tpu_torch.models import nerf as tn

    (static_branch, flow_in, output_flow, viewdir, encode_a,
     encode_t) = TRAIN_VARIANTS[variant]
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=viewdir,
                                 encode_appearance=encode_a,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    o, d, zs, flows, dirs, t, g = _train_inputs(n, flow_in)
    a = torch.randn(n, 48, generator=g).cuda() if encode_a else None
    fn = trk.make_planar_nerf_train(128, static_branch=static_branch,
                                    flow_in=flow_in, use_viewdir=viewdir,
                                    encode_a=encode_a, encode_t=encode_t,
                                    output_flow=output_flow)
    de = dirs if static_branch and viewdir else None
    return fn, fn.pack(params), (o, d, zs, flows, de, a,
                                 t if encode_t else None), g


def _branches(variant):
    static_branch, encode_t = TRAIN_VARIANTS[variant][0::5]
    return (["static"] if static_branch else []) + (
        ["transient"] if encode_t else [])


def _grad_pairs(got, want, keys=("ddir", "da", "dt")):
    pairs = [(f"{k}.{p}", got["dws"][k][p], want["dws"][k][p])
             for k in want["dws"] for p in ("w", "b")]
    pairs += [(k, got[k], want[k]) for k in keys if k in want]
    if "dflows" in want:
        pairs += [(f"dflow{c}", got["dflows"][c], want["dflows"][c])
                  for c in range(3)]
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 512])
@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_train_kernels_match_plain(variant, n):
    """planar_nerf_train forward and both backward branches at S=128, 8x256
    towers, N_tau=48, for one ray, an odd ray count and the training batch.
    Forward planes: at most 2e-3 abs and at most a fifth of the samples off
    by more than 1e-5 (a per-sample plane shows a bf16 rounding flip of an
    activation whole); gradients: every leaf within 0.1 of its largest
    entry and 5e-2 in Frobenius norm (such a flip can turn a ReLU mask), as
    in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn, pw, args, g = _train_setup(variant, n)
    kw = fn.kernel_kw
    before = trk.planar_nerf_train_fwd_cuda.launches
    got = trk.planar_nerf_train_fwd(pw, *args, **kw)
    torch.cuda.synchronize()
    assert trk.planar_nerf_train_fwd_cuda.launches == before + 1
    want = trk.planar_nerf_train_ref(pw, *args, **kw)
    err = (got - want).abs()
    assert float(err.max()) <= 2e-3
    assert float((err > 1e-5).float().mean()) <= 0.2

    cot = {k: torch.randn(n, 128, generator=g).cuda() for k in fn.out_keys}
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale", "D", "skips")}
    for branch in _branches(variant):
        b0 = trk.planar_nerf_train_bwd_cuda.launches[branch]
        got = trk.planar_nerf_train_bwd(branch, pw, *args, cot, **bkw)
        torch.cuda.synchronize()
        assert trk.planar_nerf_train_bwd_cuda.launches[branch] == b0 + 1
        want = trk.planar_nerf_train_bwd_ref(branch, pw, *args, cot, **bkw)
        assert set(got) == set(want)
        for name, a, b in _grad_pairs(got, want):
            assert bool(torch.isfinite(a).all()), name
            assert _rel_err(a, b) <= 0.1, (name, _rel_err(a, b))
            assert float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-12, \
                name


# a tower unit whose f64 pre-activation lies within FLIP_BOUND of zero is a
# candidate for a ReLU decision that f32 sums in another order can turn
FLIP_BOUND = 1e-4
F32_EPS = 2.0 ** -24  # unit roundoff of f32


def _static_tower_preacts(pw, args, freqs):
    """The plain forward's static tower on the card: the list of its
    activations (as `_tower_ref(keep=True)`) and, per layer, the f64
    pre-activation of every (row, unit) from the same bf16 inputs and its
    f32 reordering bound K 2^-24 (sum |a_k w_k| + |b|), K the layer's
    fan-in (the error bound of any order of f32 sums)."""
    o, d, zs, flows = args[:4]
    _, pe = trk._posenc_rows(o, d, zs, freqs, flows)
    inp = trk._bf16(pe)
    acts = trk._tower_ref(pw, "static_xyz", inp, 8, (4,), keep=True)
    pre = []
    for i in range(8):
        w = pw[f"static_xyz_{i}"]["w"].double()
        b = pw[f"static_xyz_{i}"]["b"].double()
        x = torch.cat([inp, acts[i]], 1) if i == 4 else acts[i]
        x = x.double()
        z = x @ w + b
        bound = w.shape[0] * F32_EPS * (x.abs() @ w.abs() + b.abs())
        pre.append((z, bound))
    return acts, pre


@pytest.mark.cuda
def test_main_no_viewdir_one_ray_gap_is_relu_flips(monkeypatch):
    """On the inputs of `test_train_kernels_match_plain[main_no_viewdir-1]`
    (one ray, no view direction: one sample is a tenth of a leaf), any gap
    between the static backward kernel's gradients and the plain
    version's must come from ReLU decisions at units whose pre-activation
    lies within f32 reordering error of zero. The candidates are the
    static tower's (row, unit) pairs whose f64 pre-activation (from the
    plain forward) is within FLIP_BOUND of zero; flips are chosen
    greedily, each the candidate whose flipped mask in the plain backward
    most lowers the worst leaf error, while one lowers it by a tenth.
    Then every leaf agrees within the case's own limits (0.1 of the
    leaf's largest entry, 5e-2 Frobenius), and every flipped unit's
    |pre-activation| is within its row's f32 reordering bound. A kernel
    whose posenc sine let the compiler contract a multiply-add failed
    here: one lane's bf16 rounding moved, and the one flip that explained
    the gap (0.109 of `static_xyz_2.w`) lay at 7x that bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn, pw, args, g = _train_setup("main_no_viewdir", 1)
    kw = fn.kernel_kw
    # the cotangents of the case, drawn as test_train_kernels_match_plain does
    cot = {k: torch.randn(1, 128, generator=g).cuda() for k in fn.out_keys}
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale", "D", "skips")}
    got = trk.planar_nerf_train_bwd("static", pw, *args, cot, **bkw)
    torch.cuda.synchronize()
    acts, pre = _static_tower_preacts(pw, args, kw["freqs"])
    cands = [(i, int(r), int(u)) for i, (z, _) in enumerate(pre)
             for r, u in (z.abs() < FLIP_BOUND).nonzero().tolist()]
    tower_ref = trk._tower_ref
    flips = []

    def flipped_tower(pw_, prefix, inp, D, skips, keep=False):
        out = tower_ref(pw_, prefix, inp, D, skips, keep)
        if keep and prefix == "static_xyz":
            out = [a.clone() for a in out]
            for i, r, u in flips:  # the mask of layer i's output
                a = out[i + 1]
                a[r, u] = 0.0 if a[r, u] > 0 else torch.finfo(torch.bfloat16).tiny
        return out

    monkeypatch.setattr(trk, "_tower_ref", flipped_tower)

    def errors():
        want = trk.planar_nerf_train_bwd_ref("static", pw, *args, cot, **bkw)
        pairs = _grad_pairs(got, want)
        return (max(_rel_err(a, b) for _, a, b in pairs),
                max(float((a - b).norm()) / max(float(b.norm()), 1e-12)
                    for _, a, b in pairs))

    base = best = errors()
    while len(flips) < 8:
        trials = []
        for c in cands:
            if c in flips:
                continue
            flips.append(c)
            trials.append((errors(), c))
            flips.pop()
        if not trials:
            break
        err, c = min(trials)
        if err[0] > 0.9 * best[0]:
            break
        flips.append(c)
        best = err
    detail = [(i, r, u, float(pre[i][0][r, u]), float(pre[i][1][r, u]))
              for i, r, u in flips]
    print(f"candidates {len(cands)}; worst error/max, Frobenius: no flip "
          f"{base}, with flips {best}; flips (layer, row, unit, f64 "
          f"pre-activation, f32 bound) {detail}")
    assert best[0] <= 0.1 and best[1] <= 5e-2, (base, best, detail)
    for i, r, u, z, bound in detail:
        assert abs(z) <= bound, (i, r, u, z, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["main", "static_only", "fw_warp"])
def test_forward_is_deterministic(variant):
    """Two forward calls on the same inputs give the same bits in every
    plane at the training batch, for each of the kernel's three variants
    (static + transient, static, transient with flows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn, pw, args, _ = _train_setup(variant, 512)
    first = trk.planar_nerf_train_fwd(pw, *args, **fn.kernel_kw)
    second = trk.planar_nerf_train_fwd(pw, *args, **fn.kernel_kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _flat_outputs(out):
    """Every tensor of a backward's output dict, by name."""
    flat = {}
    for k, v in out.items():
        if k == "dws":
            flat.update({f"{n}.{p}": t for n, d in v.items()
                         for p, t in d.items()})
        elif isinstance(v, tuple):
            flat.update({f"{k}{c}": t for c, t in enumerate(v)})
        else:
            flat[k] = v
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["planar", "packed"])
def test_backward_is_deterministic(path):
    """Two calls of each backward branch on the same inputs give the same
    bits in every output (dW, db, ddir, dt, dflows / dxyz) at the training
    batch: partials are reduced in a fixed order, no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 512
    calls = []
    if path == "planar":
        for variant in ("main", "fw_warp"):
            fn, pw, args, g = _train_setup(variant, n)
            kw = fn.kernel_kw
            cot = {k: torch.randn(n, 128, generator=g).cuda()
                   for k in fn.out_keys}
            bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                      "flow_scale", "D", "skips")}
            for branch in (["static"] if variant == "main" else []) + [
                    "transient"]:
                calls.append(lambda b=branch, pw=pw, a=args, c=cot, k=bkw:
                             trk.planar_nerf_train_bwd(b, pw, *a, c, **k))
    else:
        from nsff_pl_tpu_torch.models import nerf as tn
        from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

        params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                     use_viewdir=True, encode_transient=True,
                                     output_flow=True, device="cuda")
        xyz, _, dirs, _, t, g = _packed_inputs(n)
        op = mtk.make_fused_nerf_train(128, use_viewdir=True, encode_a=False,
                                       encode_t=True,
                                       output_flow=("fw", "bw"))
        pw, kw = op.pack(params), op.kernel_kw
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "output_flow", "flow_scale", "D", "skips")}
        cot = torch.randn(n, 128, 16, generator=g).cuda()
        for branch in ("static", "transient"):
            calls.append(lambda b=branch: mtk.fused_nerf_train_bwd(
                b, pw, xyz, dirs, None, t, cot, need_dxyz=True, **bkw))
    for call in calls:
        first = _flat_outputs(call())
        second = _flat_outputs(call())
        torch.cuda.synchronize()
        assert set(first) == set(second)
        for name in first:
            assert torch.equal(first[name], second[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 510, 512])
def test_compositor_kernels_match_plain(n):
    """planar_compositor forward (1e-5 abs) and adjoint (1e-4 of each
    plane's largest cotangent: the same f32 formulas, scans and
    transcendentals in another order), at one ray, ray counts that fill
    no whole block of four rays (37, 510) and the training batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck

    g = torch.Generator().manual_seed(n)
    ins = {"zs": torch.sort(torch.rand(n, 128, generator=g), 1).values}
    for k in tck.IN_KEYS[1:9]:
        ins[k] = torch.randn(n, 128, generator=g) * 2
    for k in tck.IN_KEYS[9:]:
        ins[k] = torch.rand(n, 128, generator=g)
    ins = {k: v.cuda() for k, v in ins.items()}
    cot = {k: torch.randn(n, 128, generator=g).cuda() for k in tck.OUT_KEYS}
    gmap = torch.randn(n, tck.N_MAP, generator=g).cuda()
    f0 = tck.planar_compositor_fwd_cuda.launches
    w, maps = tck.planar_compositor_fwd(ins)
    d = tck.planar_compositor_bwd(ins, cot, gmap)
    torch.cuda.synchronize()
    assert tck.planar_compositor_fwd_cuda.launches == f0 + 1
    rw, rmaps = tck.planar_compositor_fwd_ref(ins)
    rd = tck.planar_compositor_bwd_ref(ins, cot, gmap)
    torch.testing.assert_close(w, rw, atol=1e-5, rtol=0)
    torch.testing.assert_close(maps, rmaps, atol=1e-5, rtol=0)
    for i, k in enumerate(tck.GRAD_KEYS):
        assert _rel_err(d[i], rd[i]) <= 1e-4, k


def _packed_inputs(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, 128, generator=g), 1).values
    xyz = o[:, None] + d[:, None] * zs[..., None]
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    a = torch.randn(n, 48, generator=g)
    t = torch.randn(n, 48, generator=g)
    return tuple(x.cuda().contiguous() for x in (xyz, zs, dirs, a, t)) + (g,)


# (static_branch, encode_t, encode_a, output_flow)
PACKED_VARIANTS = {"full": (True, True, False, ("fw", "bw")),
                   "appearance": (True, True, True, ("fw", "bw")),
                   "static_only": (True, False, False, ()),
                   "fw_warp": (False, True, False, ("bw",)),
                   "bw_warp": (False, True, False, ("fw",)),
                   "no_flow": (True, True, False, ())}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("variant", sorted(PACKED_VARIANTS))
def test_packed_kernels_match_plain(variant, n):
    """fused_nerf_eval at S=128, 8x256 towers, N_tau=48, for one ray, an
    odd ray count and 4096 rays, and both
    branches of the fused_nerf_train backward (with and without the xyz
    cotangent) at one ray and the odd count. Packed rows: at most 1e-3 abs and at most
    a fifth of the rows off by more than 1e-5 in any column (a row shows a
    bf16 rounding flip of an activation whole); unused columns exactly
    zero; gradients: every leaf within 0.1 of its largest entry and 5e-2
    in Frobenius norm, the per-sample xyz cotangent within 0.25 of its
    largest entry (a flipped ReLU mask shows whole in one sample's entry),
    as in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

    static_branch, encode_t, encode_a, flow = PACKED_VARIANTS[variant]
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=True, encode_appearance=encode_a,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    xyz, _, dirs, a, t, g = _packed_inputs(n)
    op = mtk.make_fused_nerf_train(128, use_viewdir=True, encode_a=encode_a,
                                   encode_t=encode_t, output_flow=flow,
                                   static_branch=static_branch)
    pw, kw = op.pack(params), op.kernel_kw
    args = (pw, xyz, dirs if static_branch else None,
            a if encode_a else None, t if encode_t else None)
    before = mk.fused_nerf_eval_cuda.launches
    got = mk.fused_nerf_eval(*args, **kw)
    torch.cuda.synchronize()
    assert mk.fused_nerf_eval_cuda.launches == before + 1
    want = mk.fused_nerf_eval_ref(*args, **kw)
    err = (got - want).abs()
    assert float(err.max()) <= 1e-3
    assert float((err.amax(-1) > 1e-5).float().mean()) <= 0.2
    unused = ([] if static_branch else [0, 1, 2, 3]) + list(
        range(8 + 3 * len(flow) if encode_t else 4, 16))
    assert not bool(got[..., unused].any())
    if n > 37:  # the backward at one ray and the odd count
        return

    cot = torch.randn(n, 128, 16, generator=g).cuda()
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "output_flow", "flow_scale", "D", "skips")}
    for branch in (["static"] if static_branch else []) + (
            ["transient"] if encode_t else []):
        for need_dxyz in (False, True):
            b0 = mtk.fused_nerf_train_bwd_cuda.launches[branch]
            got = mtk.fused_nerf_train_bwd(branch, *args, cot,
                                           need_dxyz=need_dxyz, **bkw)
            torch.cuda.synchronize()
            assert mtk.fused_nerf_train_bwd_cuda.launches[branch] == b0 + 1
            want = mtk.fused_nerf_train_bwd_ref(branch, *args, cot,
                                                need_dxyz=need_dxyz, **bkw)
            assert ("dxyz" in got) == need_dxyz
            pairs = [(f"{k}.{p}", got["dws"][k][p], want["dws"][k][p], 0.1)
                     for k in want["dws"] for p in ("w", "b")]
            pairs += [(k, got[k], want[k], 0.1)
                      for k in ("ddir", "da", "dt") if k in want]
            if need_dxyz:
                pairs.append(("dxyz", got["dxyz"], want["dxyz"], 0.25))
            assert set(got) == set(want)
            for name, x, y, tol in pairs:
                assert bool(torch.isfinite(x).all()), name
                assert _rel_err(x, y) <= tol, (name, _rel_err(x, y))
                assert float((x - y).norm()) <= 5e-2 * float(y.norm()) \
                    + 1e-12, name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 512, 8192])
def test_packed_compositing_kernels_match_plain(n):
    """fused_compositing forward (1e-5 abs) and adjoint (1e-4 of each
    column's largest cotangent; columns 8-15 exactly zero), with sigmas
    that drive 1 - alpha to underflow at some samples and raw sigmas of
    exactly zero at others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck

    g = torch.Generator().manual_seed(n)
    packed = torch.randn(n, 128, 16, generator=g)
    packed[..., [0, 1, 2, 4, 5, 6]] = torch.rand(n, 128, 6, generator=g)
    packed[..., [3, 7]] *= 3
    packed[::3, 40, 3] = 2000.0  # opaque sample: 1 - alpha underflows
    packed[1::3, ::7, 3] = 0.0
    zs = torch.sort(torch.rand(n, 128, generator=g), 1).values
    ns, nt = (torch.randn(n, 128, generator=g) for _ in range(2))
    ns[1::3, ::7] = 0.0
    packed, zs, ns, nt = (x.cuda().contiguous() for x in (packed, zs, ns, nt))
    cot = {k: torch.randn(n, 128, generator=g).cuda() for k in fck.OUT_KEYS}
    gmap = torch.randn(n, 4, generator=g).cuda()
    f0 = fck.fused_compositing_fwd_cuda.launches
    b0 = fck.fused_compositing_bwd_cuda.launches
    planes, maps = fck.fused_compositing_fwd(packed, zs, ns, nt)
    dp = fck.fused_compositing_bwd(packed, zs, ns, nt, cot, gmap)
    torch.cuda.synchronize()
    assert fck.fused_compositing_fwd_cuda.launches == f0 + 1
    assert fck.fused_compositing_bwd_cuda.launches == b0 + 1
    rplanes, rmaps = fck.fused_compositing_fwd_ref(packed, zs, ns, nt)
    rdp = fck.fused_compositing_bwd_ref(packed, zs, ns, nt, cot, gmap)
    torch.testing.assert_close(planes, rplanes, atol=1e-5, rtol=0)
    torch.testing.assert_close(maps, rmaps, atol=1e-5, rtol=0)
    assert bool(torch.isfinite(dp).all())
    assert not bool(dp[..., 8:].any())
    for c in range(8):
        assert _rel_err(dp[..., c], rdp[..., c]) <= 1e-4, c


@pytest.mark.cuda
def test_packed_compositing_is_deterministic():
    """The packed compositor's forward and adjoint give the same bits on
    two calls (fixed-order scans and sums, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck

    g = torch.Generator(device="cuda").manual_seed(3)
    n = 512
    packed = torch.randn(n, 128, 16, generator=g, device="cuda")
    zs = torch.sort(torch.rand(n, 128, generator=g, device="cuda"), 1).values
    ns, nt = (torch.randn(n, 128, generator=g, device="cuda")
              for _ in range(2))
    cot = {k: torch.randn(n, 128, generator=g, device="cuda")
           for k in fck.OUT_KEYS}
    gmap = torch.randn(n, 4, generator=g, device="cuda")
    runs = [(fck.fused_compositing_fwd(packed, zs, ns, nt),
             fck.fused_compositing_bwd(packed, zs, ns, nt, cot, gmap))
            for _ in range(2)]
    torch.cuda.synchronize()
    (p1, m1), d1 = runs[0]
    (p2, m2), d2 = runs[1]
    assert torch.equal(p1, p2) and torch.equal(m1, m2) and torch.equal(d1, d2)


def _train_inputs_small(n_frames=3, hw=4096, seed=0):
    """A small ray table in the JAX package's channel layout (rays 0:6,
    rgb 6:9, t 9, disparity 10, mask 11, flow targets 12:16) and the
    cameras of the flow loss."""
    g = torch.Generator().manual_seed(seed)
    table = torch.rand(n_frames, hw, 16, generator=g)
    table[..., 0:2] = table[..., 0:2] * 2 - 1
    table[..., 2] = -1.0
    table[..., 3:5] = (table[..., 3:5] - 0.5) * 0.4
    table[..., 5] = 2.0
    table[..., 9] = torch.arange(n_frames, dtype=torch.float32)[:, None]
    f = 200.0
    K = torch.tensor([[[f, 0, 32], [0, f, 32], [0, 0, 1]]])
    Ps = K[:, None] @ torch.eye(3, 4).expand(1, n_frames, 3, 4)
    return table.cuda(), K.cuda(), Ps.contiguous().cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("path", ["planar", "packed"])
def test_graphed_steps_match_eager(path, hard):
    """Three steps as one graphed dispatch (`make_train_step(scan_steps=
    3)`, one CUDA graph) against three eager single steps from a copy of
    the same state on the same frames and draws, at full width and
    batch 64: the same kernels on the same inputs, so loss terms within
    1e-4 relative and the params within 1e-5; the capture recorded each
    kernel's per-step launches; a dispatch that draws from a registered
    generator draws anew on each replay. With `hard`, both sample by
    hard sampling on random weights (the graph then also holds the
    weighted draw and the `tmp_rgb[t, rand_idx] = rgb` write), from
    uniforms that pick distinct pixels, so every write lands: the graphed
    buffer must equal the eager steps' rgb written at their ray ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.config import (NSFFConfig, build_params,
                                          loss_config, render_config)
    from nsff_pl_tpu_torch.training.optim import make_optimizer, param_leaves
    from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

    K, B, S = 3, 64, 128
    cfg = NSFFConfig(img_wh=(64, 64), start_end=(0, 3), use_viewdir=True,
                     encode_t=True, N_samples=S, batch_size=B, lr=5e-4,
                     lr_scheduler="cosine", num_epochs=50, dtype="bfloat16")
    if path == "packed":
        cfg = cfg.replace(fused_train="off", fused_compositing=True)
    table, Ks, Ps = _train_inputs_small()
    g = torch.Generator(device="cuda").manual_seed(1)
    hw = table.shape[1]
    weights = (torch.rand(table.shape[:2], generator=g, device="cuda") + 0.5
               if hard else torch.ones(table.shape[:2], device="cuda"))
    ts = torch.tensor([0, 2, 1], device="cuda")
    idx = torch.argsort(torch.rand((K, hw), generator=g, device="cuda"),
                        1)[:, :B]
    # hard sampling: the uniform at the middle of each pixel's CDF step
    cw = torch.cumsum(weights[ts], 1)
    lo = torch.where(idx > 0, cw.gather(1, (idx - 1).clamp(min=0)), 0.0)
    batch_u = (lo + cw.gather(1, idx)) / 2 / cw[:, -1:]
    sel = dict(batch_u=batch_u) if hard else dict(idx=idx)
    draws = {k: (torch.rand if k == "u" else torch.randn)(
        (K, B, S), generator=g, device="cuda")
        for k in ("u", "ns", "nt", "nw1", "nw2")}

    def setup(scan_steps):
        params = build_params(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
        tx = make_optimizer(cfg, 100)
        step = make_train_step(
            render_config(cfg), loss_config(cfg), tx, output_transient=True,
            output_transient_flow=tuple(cfg.output_transient_flow),
            steps_per_epoch=100, batch_size=B, hard_sampling=hard,
            scan_steps=scan_steps)
        assert step.use_planar == (path == "planar")
        return TrainState(params, tx.init(params), 0), step

    state, single = setup(1)
    rows = []
    want_tmp = torch.zeros(table.shape[:2] + (3,), device="cuda")
    for i in range(K):
        state, m, aux = single(state, table, weights, Ks, Ps, None,
                               ts[i], **{k: v[i] for k, v in sel.items()},
                               draws={k: v[i] for k, v in draws.items()})
        rows.append(m)
        assert torch.equal(aux["rand_idx"], idx[i])
        want_tmp[ts[i], aux["rand_idx"]] = aux["rgb_fine"]
    gstate, multi = setup(K)
    tmp = torch.zeros_like(want_tmp) if hard else torch.zeros(1, 1, 3,
                                                              device="cuda")
    gstate, tmp_out, gm = multi(gstate, tmp, table, weights, Ks, Ps, None,
                                ts, **sel, draws=draws)
    torch.cuda.synchronize()
    assert multi.replays == 1 and gstate.step == K and tmp_out is tmp
    if hard:
        assert int((tmp != 0).any(-1).sum()) == K * B
        torch.testing.assert_close(tmp, want_tmp, rtol=1e-4, atol=1e-6)
    else:
        assert not tmp.any()
    for k in rows[0]:
        want = torch.stack([r[k] for r in rows])
        torch.testing.assert_close(gm[k], want, rtol=1e-4, atol=1e-9)
    for a, b in zip(param_leaves(gstate.params), param_leaves(state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    fwd = ("planar_nerf_train_fwd" if path == "planar"
           else "fused_nerf_eval")
    assert multi.graph_launches[fwd] == 3 * K

    # draws from a registered generator: each replay draws anew
    _, drawing = setup(K)
    dstate = setup(1)[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dstate, _, m1 = drawing(dstate, tmp, table, weights, Ks, Ps, gen, ts)
    dstate, _, m2 = drawing(dstate, tmp, table, weights, Ks, Ps, gen, ts)
    if hard:  # fresh weighted draws write fresh pixels
        assert int((tmp != 0).any(-1).sum()) > K * B
    torch.cuda.synchronize()
    assert drawing.replays == 2
    assert all(bool(torch.isfinite(v).all()) for v in m2.values())
    assert not torch.equal(m1["col_l"], m2["col_l"])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["composited", "planes"])
def test_render_chunks_graph_matches_host_loop(route):
    """`render_full_image(scan_chunks=True)` on the card: the equal chunks
    of a 3000-ray frame (3 x 1024) captured as one CUDA graph and replayed
    once a frame equal the host loop's frame within 1e-6 (the same
    kernels; a ray's result does not depend on its chunk); the capture
    holds one launch per chunk of the route's kernels (the serving
    evaluator; or the planes route's forward and compositor); a second
    frame leaves the first one's tensors as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.models.rendering import RenderConfig
    from nsff_pl_tpu_torch.training import step as tstep

    g = torch.Generator().manual_seed(0)
    params = {"nerf_fine": tn.init_nerf_params(
        g, "fine", use_viewdir=True, encode_transient=True, output_flow=True,
        device="cuda"), "embedding_t": tn.init_embedding(g, 4, 48)}
    n, chunk = 3000, 1024
    keys = ("rgb_fine", "depth_fine") + (
        ("transient_flows_fw", "static_alphas_fine") if route == "planes"
        else ())
    render = tstep.make_render_fn(
        RenderConfig(use_viewdir=True, encode_t=True,
                     compute_dtype="bfloat16", img_wh=(64, 48)),
        output_transient=True, output_transient_flow=("fw", "bw"),
        with_visibility=True, keys=keys)
    K = torch.tensor([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    poses = torch.zeros(1, 3, 4)
    poses[0, :, :3] = torch.eye(3)

    def frame(seed):
        gg = torch.Generator().manual_seed(seed)
        rays = torch.rand(n, 6, generator=gg)
        rays[:, 0:2] = rays[:, 0:2] * 2 - 1
        rays[:, 2] = -1
        rays[:, 3:5] = (rays[:, 3:5] - 0.5) * 0.4
        rays[:, 5] = 2
        return rays.cuda(), torch.randint(0, 4, (n,), generator=gg).cuda()

    rays, ts = frame(1)
    kw = dict(chunk=chunk, vis_poses=poses.cuda(), vis_K=K.cuda())
    got = tstep.render_full_image(render, params, rays, ts,
                                  scan_chunks=True, **kw)
    want = tstep.render_full_image(render, params, rays, ts, **kw)
    for k in keys:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    (graph,) = render.chunk_graphs.values()
    assert graph.replays == 1 and graph.n_chunks == 3
    runs = ({"planar_eval_comp": 3} if route == "composited" else
            {"planar_nerf_train_fwd": 3, "planar_compositor_fwd": 3})
    assert {k: v for k, v in graph.graph_launches.items() if v} == runs
    first = {k: v.clone() for k, v in got.items()}
    tstep.render_full_image(render, params, *frame(2), scan_chunks=True,
                            **kw)
    assert graph.replays == 2
    for k in keys:
        assert torch.equal(got[k], first[k]), k
