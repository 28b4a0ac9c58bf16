"""The port's CUDA kernels on the card, each against its plain PyTorch
version at full width. Marked `cuda`; they skip without a card. This file
imports no JAX (the card's machine has none), so it runs there alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from nsff_pl_tpu_torch.ops import raymarch_kernel as trk

# a backward's bounds: every summed leaf (dW, db, the per-ray embedding
# gradients) within GRAD_MAX of its largest entry and GRAD_FRO in
# Frobenius norm; the packed call's per-sample xyz cotangent within DX_MAX
GRAD_MAX, GRAD_FRO, DX_MAX = 0.1, 5e-2, 0.25

# The rule of few rows (`_flips_explain`). Where a leaf sums at most
# FEW_ROWS tower rows an entry (dW of one ray of up to 128 samples or of
# 37 rays of one sample; a ray's embedding gradient at up to 128 samples;
# the per-sample xyz cotangent), one ReLU decision that the kernel and
# the plain version take apart shows whole in it (on an H100, 0.186 of
# `static_xyz_6.w` at 37 rays of one sample, from one unit whose f64
# pre-activation is -2.2e-7; 0.110 of `dt` at 512 rays of one sample).
# There a backward that misses its bounds passes only if flipping at most
# FLIP_MAX tower units whose f64 pre-activation lies within FLIP_BOUND of
# zero brings every leaf within them, and each flip is one the kernel can
# take: within its f32 reordering bound of zero, or moved there by one
# bf16 rounding tie of an earlier layer of its row, itself within its own
# f32 reordering bound of a rounding midpoint (or of zero). The sample counts that
# these tests held before every kernel took any S (OLD_S) keep their
# bounds without the rule.
FEW_ROWS = 128
OLD_S = (64, 128, 192, 256)
FLIP_BOUND = 1e-4
FLIP_MAX = 8
F32_EPS = 2.0 ** -24  # unit roundoff of f32


def _few_rows(n, s, missed):
    """Whether every leaf that missed its bounds (`missed`: (name, error))
    sums at most FEW_ROWS tower rows an entry (dW and db: all n s rows;
    the per-ray embedding gradients: the ray's s; the xyz cotangent: one)
    at a sample count outside OLD_S."""
    def rows(name):
        return s if name in ("ddir", "da", "dt") else (
            1 if name == "dxyz" else n * s)
    return s not in OLD_S and all(rows(k) <= FEW_ROWS for k, _ in missed)


def _summed_verdict(got):
    """`_relu_flip_search`'s verdict against a backward kernel's output
    `got`: (worst error over a leaf's largest entry, worst Frobenius
    ratio) over the weight and bias gradients, the per-ray embedding
    gradients and the packed call's xyz cotangent, that last error scaled
    by GRAD_MAX / DX_MAX (its own bound; the planar call's flow-plane
    cotangents are held apart)."""
    def verdict(want):
        pairs = [(got["dws"][k][p], want["dws"][k][p], 1.0)
                 for k in want["dws"] for p in ("w", "b")]
        pairs += [(got[k], want[k], 1.0) for k in ("ddir", "da", "dt")
                  if k in want]
        if "dxyz" in want:
            pairs.append((got["dxyz"], want["dxyz"], GRAD_MAX / DX_MAX))
        return (max(_rel_err(a, b) * f for a, b, f in pairs),
                max(float((a - b).norm()) / max(float(b.norm()), 1e-12)
                    for a, b, _ in pairs))
    return verdict


def _layer_preacts(pw, prefix, x, i):
    """Layer i's f64 pre-activations of the rows `x` (its input, with the
    tower input in front at the skip layer) and their f32 reordering
    bounds K 2^-24 (sum |x_k w_k| + |b|), K the fan-in: the error bound of
    any order of f32 sums."""
    w = pw[f"{prefix}_{i}"]["w"].double()[:x.shape[-1]]
    b = pw[f"{prefix}_{i}"]["b"].double()
    x = x.double()
    return x @ w + b, w.shape[0] * F32_EPS * (x.abs() @ w.abs() + b.abs())


def _layer_input(acts, i):
    return torch.cat([acts[0], acts[i]], -1) if i == 4 else acts[i]


def _other_bf16(h, z):
    """The bf16 neighbour of the positive bf16 values `h` on the side of
    their unrounded values `z`."""
    bits = h.to(torch.bfloat16).view(torch.int16)
    step = torch.where(z > h, 1, -1).to(torch.int16)
    return (bits + step).view(torch.bfloat16).double()


def _row_ties(pw, prefix, acts, r, i):
    """The bf16 rounding ties of row r in layers 0..i-1 of a tower: (layer,
    unit, distance of the f64 pre-activation to its rounding midpoint, its
    f32 reordering bound, the other rounding). A ReLU decision within its
    bound is one too (its other value 0, or the positive value)."""
    ties = []
    for j in range(i):
        z, bound = _layer_preacts(pw, prefix, _layer_input(acts, j)[r], j)
        h = acts[j + 1][r].double()
        pos = (h > 0) & (z > 0)
        other = torch.where(pos, _other_bf16(h.clamp(min=1e-30), z), 0.0)
        dist = torch.where(pos, (z - (h + other) / 2).abs(), z.abs())
        relu = z.abs() <= bound
        other = torch.where(relu & (h > 0), 0.0, other)
        other = torch.where(relu & (h == 0),
                            z.abs().to(torch.bfloat16).double(), other)
        for v in ((dist <= bound) | relu).nonzero().flatten().tolist():
            ties.append((j, v, float(dist[v]), float(bound[v]),
                         float(other[v])))
    return ties


def _preact_after_tie(pw, prefix, acts, r, i, u, tie):
    """Unit u's f64 pre-activation at layer i of row r, and its bound, with
    the rounding tie `tie` (`_row_ties`) taken the other way; the later
    layers' bf16 roundings that this moves are moved with it."""
    plain = [a[r].double() for a in acts]
    row = list(plain)
    tj, v, _, _, other = tie
    row[tj + 1] = row[tj + 1].clone()
    row[tj + 1][v] = other
    for j in range(tj + 1, i):
        z, _ = _layer_preacts(pw, prefix, _layer_input(row, j), j)
        z0, _ = _layer_preacts(pw, prefix, _layer_input(plain, j), j)
        h = torch.relu(z).to(torch.bfloat16).double()
        h0 = torch.relu(z0).to(torch.bfloat16).double()
        row[j + 1] = torch.where(h != h0, h, plain[j + 1])
    z, bound = _layer_preacts(pw, prefix, _layer_input(row, i), i)
    return float(z[u]), float(bound[u])


def _tie_explains(pw, prefix, acts, flip):
    """The upstream rounding tie (`_row_ties`) that, taken the other way,
    moves `flip` (prefix, i, r, u, z, bound) to within its f32 bound of the
    kernel's side of zero, or None."""
    _, i, r, u, z, _ = flip
    side = -1.0 if z > 0 else 1.0  # the kernel's side
    for t in _row_ties(pw, prefix, acts, r, i):
        z2, b2 = _preact_after_tie(pw, prefix, acts, r, i, u, t)
        if side * z2 >= -b2:
            return t
    return None


def _relu_flip_search(plain_bwd, verdict, towers=None, stop=True):
    """`plain_bwd()` runs a plain backward (planar or packed) whose towers
    `ops/raymarch_kernel.py::_tower_ref` builds; `verdict(out)` gives its
    (worst error over a leaf's largest entry, worst Frobenius ratio)
    against the kernel's. Flips, greedily, the mask of the candidate unit
    that lowers the worst error most, while one lowers it by a tenth, at
    most FLIP_MAX; with `stop`, until every leaf is within GRAD_MAX /
    GRAD_FRO. Candidates: the units of `towers` (None: every tower the
    backward ran) whose f64 pre-activation lies within FLIP_BOUND of zero.
    Returns (verdict before, verdict after, the flips as (tower, layer,
    row, unit, f64 pre-activation, f32 bound), the towers' weights and
    activations)."""
    tower_ref = trk._tower_ref
    seen, flips = {}, []

    def flipped(pw_, prefix, inp, D, skips, keep=False):
        out = tower_ref(pw_, prefix, inp, D, skips, keep)
        if keep:
            seen[prefix] = (pw_, out)
            mine = [f for f in flips if f[0] == prefix]
            if mine:
                out = [a.clone() for a in out]
                for _, i, r, u in mine:  # the mask of layer i's output
                    a = out[i + 1]
                    a[r, u] = 0.0 if a[r, u] > 0 else \
                        torch.finfo(torch.bfloat16).tiny
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(trk, "_tower_ref", flipped)
        base = best = verdict(plain_bwd())
        cands = {}
        for prefix, (pw_, acts) in seen.items():
            if towers is not None and prefix not in towers:
                continue
            for i in range(8):
                z, bound = _layer_preacts(pw_, prefix, _layer_input(acts, i),
                                          i)
                for r, u in (z.abs() < FLIP_BOUND).nonzero().tolist():
                    cands[prefix, i, r, u] = (float(z[r, u]),
                                              float(bound[r, u]))
        while len(flips) < FLIP_MAX:
            trials = []
            for c in cands:
                if c in flips:
                    continue
                flips.append(c)
                trials.append((verdict(plain_bwd()), c))
                flips.pop()
            if not trials:
                break
            err, c = min(trials)
            if err[0] > 0.9 * best[0]:
                break
            flips.append(c)
            best = err
            if stop and best[0] <= GRAD_MAX and best[1] <= GRAD_FRO:
                break
    return base, best, [(*c, *cands[c]) for c in flips], seen


def _flips_explain(plain_bwd, verdict, what, ties=True, towers=None):
    """The rule of few rows: asserts that at most FLIP_MAX ReLU flips bring
    a backward's leaves within GRAD_MAX / GRAD_FRO, each within its f32
    bound of zero or (`ties`) moved there by an upstream rounding tie
    (`_tie_explains`); prints the search. Without `ties` the search runs
    to its end (`_relu_flip_search`) and every flip must lie within its
    bound."""
    base, best, flips, seen = _relu_flip_search(plain_bwd, verdict, towers,
                                                stop=ties)
    causes = []
    for f in flips:
        if abs(f[4]) <= f[5]:
            causes.append("within its bound")
        elif ties:
            pw_, acts = seen[f[0]]
            causes.append(_tie_explains(pw_, f[0], acts, f))
        else:
            causes.append(None)
    print(f"{what}: worst error/max, Frobenius {base} without a flip; "
          f"{best} with {len(flips)} ReLU flips (tower, layer, row, unit, "
          f"f64 pre-activation, f32 bound) {flips}; each flip's cause "
          f"(an upstream tie as layer, unit, distance to the rounding "
          f"midpoint, f32 bound, other rounding) {causes}")
    assert best[0] <= GRAD_MAX and best[1] <= GRAD_FRO, (what, base, best)
    assert all(c is not None for c in causes), (what, flips, causes)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("encode_t,flow,vis_in", [
    (True, (), False), (True, ("fw", "bw"), True), (False, (), False)])
def test_cuda_kernel_matches_plain(encode_t, flow, vis_in, n):
    """planar_eval_comp at S=128, 8x256 towers, N_tau=48, for one ray, an
    odd ray count and 4096 rays; tolerance as in chip_smoke.py (same bf16
    rounding points, f32 sums in another order)."""
    _check_eval_comp(encode_t, flow, vis_in, n, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 96, 100, 192, 256, 320, 512])
@pytest.mark.parametrize("n", [1, 37, 512, 2048])
@pytest.mark.parametrize("encode_t,flow,vis_in", [
    (True, ("fw", "bw"), True), (False, (), False)])
def test_cuda_kernel_matches_plain_at_samples(encode_t, flow, vis_in, n, s):
    """planar_eval_comp at any sample count (a ray's tiles of 128 samples,
    a run-time count, the last one 1 to 128 samples used: one sample, 33,
    64, 96 and 100 in one tile; 192 and 256 in two; 320 in three, the last
    with 64; 512 in four whole tiles) on sorted random depths, as at
    S=128: 5e-4 abs."""
    _check_eval_comp(encode_t, flow, vis_in, n, s)


def _check_eval_comp(encode_t, flow, vis_in, n, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn

    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    if s == 128:
        zs = torch.linspace(0, 1, s).expand(n, s).contiguous()
    else:
        zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    vis = (torch.rand(n, s, generator=g) > 0.3).float()
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, 48, generator=g)
    o, d, zs, vis, dirs, t = (x.cuda() for x in (o, d, zs, vis, dirs, t))
    fn = trk.make_planar_nerf_eval_comp(s, use_viewdir=True,
                                        encode_t=encode_t, output_flow=flow,
                                        vis_in=vis_in)
    args = (fn.pack(params), o, d, zs, vis if vis_in else None, dirs, None,
            t if encode_t else None)
    before = trk.planar_eval_comp_cuda.launches[s]
    got = trk.planar_eval_comp(*args, **fn.kernel_kw)
    torch.cuda.synchronize()
    assert trk.planar_eval_comp_cuda.launches[s] == before + 1
    want = trk.planar_eval_comp_ref(*args, **fn.kernel_kw)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


def _train_inputs(n, flow_in, seed=0, s=128):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    flows = tuple(0.05 * torch.randn(n, s, generator=g) for _ in range(3)) \
        if flow_in else None
    dirs = torch.rand(n, 27, generator=g) * 2 - 1
    t = torch.randn(n, 48, generator=g)
    cuda = lambda x: x.cuda().contiguous()  # noqa: E731
    return (cuda(o), cuda(d), cuda(zs),
            tuple(cuda(f) for f in flows) if flow_in else None,
            cuda(dirs), cuda(t), g)


# (static_branch, flow_in, output_flow, use_viewdir, encode_a, encode_t):
# main, main without the view direction, main with the appearance
# embedding, the static-only model (no transient branch), fw warp, bw warp,
# both warps in one call (both flow heads)
TRAIN_VARIANTS = {
    "main": (True, False, ("fw", "bw"), True, False, True),
    "main_no_viewdir": (True, False, ("fw", "bw"), False, False, True),
    "main_encode_a": (True, False, ("fw", "bw"), True, True, True),
    "static_only": (True, False, (), True, False, False),
    "fw_warp": (False, True, ("bw",), True, False, True),
    "bw_warp": (False, True, ("fw",), True, False, True),
    "stacked_warp": (False, True, ("fw", "bw"), True, False, True)}


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-12)


def _train_setup(variant, n, s=128):
    from nsff_pl_tpu_torch.models import nerf as tn

    (static_branch, flow_in, output_flow, viewdir, encode_a,
     encode_t) = TRAIN_VARIANTS[variant]
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=viewdir,
                                 encode_appearance=encode_a,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    o, d, zs, flows, dirs, t, g = _train_inputs(n, flow_in, s=s)
    a = torch.randn(n, 48, generator=g).cuda() if encode_a else None
    fn = trk.make_planar_nerf_train(s, static_branch=static_branch,
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
    in chip_smoke.py; the warps' flow-plane cotangents also to the
    unrounded model (`_dflows_rule`)."""
    _check_train_kernels(variant, n, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 96, 100, 192, 256, 320, 512])
@pytest.mark.parametrize("n", [1, 37, 512])
@pytest.mark.parametrize("variant", ["main", "main_encode_a", "static_only",
                                     "fw_warp", "stacked_warp"])
def test_train_kernels_match_plain_at_samples(variant, n, s):
    """planar_nerf_train forward and backward at any sample count (one CTA
    per ray and tile of 128 samples, the last tile 1 to 128 used, its
    padded rows with zero cotangent; up to four tiles at 512; the per-ray
    embedding gradients summed over a ray's tiles), held as at S=128, but
    for the flow-plane cotangents of the warp calls: they are per sample,
    so a ReLU mask turned by a bf16 rounding flip shows whole in one
    sample, as in the forward planes (at S=64 and 512 rays one sample of
    32768 parted by 0.104 of the plane's largest entry). At every S they
    are held to 5e-2 in Frobenius norm and to the unrounded model
    (`_dflows_rule`); at S=128 also within 0.1 of the plane's largest
    entry. Where a leaf sums few rows an entry (`_few_rows`: dW of one ray
    or of 37 rays of one sample, a ray's embedding gradient at one sample)
    leaves that miss the bounds are held to the rule of few rows
    (`_flips_explain`); everywhere else they fail."""
    _check_train_kernels(variant, n, s)


# the flow-plane cotangents against the unrounded model, per plane: the
# kernel's mean distance at most EXACT_MEAN times the plain version's and
# its largest at most EXACT_MAX times (as chip_smoke.py holds them)
EXACT_MEAN, EXACT_MAX = 1.1, 1.5


def _unrounded_dflows(pw, args, kw, cot, out_keys):
    """The flow-plane cotangents of the unrounded model: the plain forward
    without its bf16 roundings of activations and in float64 (the weights
    stay the bf16 values the kernel reads), differentiated by autograd
    against the cotangent planes `cot`."""
    def mm(x, w, b=None):
        y = x.double() @ w.double()
        return y if b is None else y + b.double()

    a = [x.double() if torch.is_tensor(x) else x for x in args]
    a[3] = flows = tuple(f.double().requires_grad_() for f in a[3])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(trk, "_bf16", lambda x: x.double())
        m.setattr(trk, "_mm", mm)
        planes = trk.planar_nerf_train_ref(pw, *a, **kw)
    loss = sum((planes[i] * cot[k].double()).sum()
               for i, k in enumerate(out_keys))
    return [g.float() for g in torch.autograd.grad(loss, flows)]


def _dflows_rule(got, want, exact, what):
    """Hold each flow-plane cotangent to the unrounded model; prints the
    ratios."""
    for c in range(3):
        ek = (got[c] - exact[c]).abs()
        ep = (want[c] - exact[c]).abs()
        mean = float((ek.mean() + 1e-9) / (ep.mean() + 1e-9))
        top = float((ek.max() + 1e-9) / (ep.max() + 1e-9))
        own = float(ep.max() / exact[c].abs().max())
        print(f"{what} dflow{c}: distance to the unrounded model over the "
              f"plain version's: mean {mean:.3f}, largest {top:.3f}; the "
              f"plain version's own largest {own:.3f} of the plane's "
              "largest entry")
        assert mean <= EXACT_MEAN and top <= EXACT_MAX, (what, c, mean, top)


def _check_train_kernels(variant, n, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn, pw, args, g = _train_setup(variant, n, s)
    kw = fn.kernel_kw
    before = trk.planar_nerf_train_fwd_cuda.launches[s]
    got = trk.planar_nerf_train_fwd(pw, *args, **kw)
    torch.cuda.synchronize()
    assert trk.planar_nerf_train_fwd_cuda.launches[s] == before + 1
    want = trk.planar_nerf_train_ref(pw, *args, **kw)
    err = (got - want).abs()
    assert float(err.max()) <= 2e-3
    assert float((err > 1e-5).float().mean()) <= 0.2

    cot = {k: torch.randn(n, s, generator=g).cuda() for k in fn.out_keys}
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale", "D", "skips")}
    for branch in _branches(variant):
        b0 = trk.planar_nerf_train_bwd_cuda.launches[branch][s]
        got = trk.planar_nerf_train_bwd(branch, pw, *args, cot, **bkw)
        torch.cuda.synchronize()
        assert trk.planar_nerf_train_bwd_cuda.launches[branch][s] == b0 + 1
        want = trk.planar_nerf_train_bwd_ref(branch, pw, *args, cot, **bkw)
        assert set(got) == set(want)
        missed = []
        for name, a, b in _grad_pairs(got, want):
            assert bool(torch.isfinite(a).all()), name
            if (s == 128 or not name.startswith("dflow")) \
                    and _rel_err(a, b) > 0.1:
                missed.append((name, _rel_err(a, b)))
            fro = float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-12
            assert fro or not name.startswith("dflow"), name
            if not fro:
                missed.append((name, "Frobenius"))
        if missed:
            assert _few_rows(n, s, missed), missed
            _flips_explain(lambda: trk.planar_nerf_train_bwd_ref(
                branch, pw, *args, cot, **bkw), _summed_verdict(got),
                f"{variant} n={n} S={s} {branch}")
        if "dflows" in want:
            exact = _unrounded_dflows(pw, args, kw, cot, fn.out_keys)
            _dflows_rule(got["dflows"], want["dflows"], exact,
                         f"{variant} n={n} S={s} {branch}")


@pytest.mark.cuda
def test_main_no_viewdir_one_ray_gap_is_relu_flips():
    """On the inputs of `test_train_kernels_match_plain[main_no_viewdir-1]`
    (one ray, no view direction: one sample is a tenth of a leaf), any gap
    between the static backward kernel's gradients and the plain
    version's must come from ReLU decisions at units whose pre-activation
    lies within f32 reordering error of zero. The candidates are the
    static tower's (row, unit) pairs whose f64 pre-activation (from the
    plain forward) is within FLIP_BOUND of zero; flips are chosen
    greedily, each the candidate whose flipped mask in the plain backward
    most lowers the worst leaf error, while one lowers it by a tenth
    (`_relu_flip_search`, to the end of the search).
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
    _flips_explain(lambda: trk.planar_nerf_train_bwd_ref(
        "static", pw, *args, cot, **bkw), _summed_verdict(got),
        "main_no_viewdir n=1 S=128 static", ties=False,
        towers=("static_xyz",))


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
def test_backward_is_deterministic_at_256_samples():
    """The planar backward at 256 samples (two tiles a ray, the per-ray
    sums reduced over the tiles in order) gives the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 512
    for variant in ("main", "fw_warp"):
        fn, pw, args, g = _train_setup(variant, n, 256)
        kw = fn.kernel_kw
        cot = {k: torch.randn(n, 256, generator=g).cuda() for k in fn.out_keys}
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "flow_scale", "D", "skips")}
        for branch in _branches(variant):
            first = _flat_outputs(trk.planar_nerf_train_bwd(branch, pw, *args,
                                                            cot, **bkw))
            second = _flat_outputs(trk.planar_nerf_train_bwd(branch, pw, *args,
                                                             cot, **bkw))
            torch.cuda.synchronize()
            for name in first:
                assert torch.equal(first[name], second[name]), (variant, name)


@pytest.mark.cuda
def test_backward_is_deterministic_at_320_samples():
    """The planar and the packed backward at 320 samples (three tiles a
    ray, the last with 64 rows; the per-ray sums reduced over the tiles
    in order) give the same bits twice at the training batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

    n, s = 512, 320
    calls = []
    for variant in ("main", "fw_warp"):
        fn, pw, args, g = _train_setup(variant, n, s)
        kw = fn.kernel_kw
        cot = {k: torch.randn(n, s, generator=g).cuda() for k in fn.out_keys}
        bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                  "flow_scale", "D", "skips")}
        for branch in _branches(variant):
            calls.append(lambda b=branch, pw=pw, a=args, c=cot, k=bkw:
                         trk.planar_nerf_train_bwd(b, pw, *a, c, **k))
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 use_viewdir=True, encode_transient=True,
                                 output_flow=True, device="cuda")
    xyz, _, dirs, _, t, g = _packed_inputs(n, s=s)
    op = mtk.make_fused_nerf_train(s, use_viewdir=True, encode_a=False,
                                   encode_t=True, output_flow=("fw", "bw"))
    ppw, pkw = op.pack(params), op.kernel_kw
    pbkw = {k: pkw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                "output_flow", "flow_scale", "D", "skips")}
    pcot = torch.randn(n, s, 16, generator=g).cuda()
    for branch in ("static", "transient"):
        calls.append(lambda b=branch: mtk.fused_nerf_train_bwd(
            b, ppw, xyz, dirs, None, t, pcot, need_dxyz=True, **pbkw))
    for call in calls:
        first = _flat_outputs(call())
        second = _flat_outputs(call())
        torch.cuda.synchronize()
        assert set(first) == set(second)
        for name in first:
            assert torch.equal(first[name], second[name]), name


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
    _check_compositor(n, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 96, 100, 192, 256, 320, 512])
@pytest.mark.parametrize("n", [1, 37, 512])
def test_compositor_kernels_match_plain_at_samples(n, s):
    """planar_compositor at any sample count: a ray in chunks of at most
    8 samples a lane (1 to 8; two chunks at 320 and 512), the lanes' tails
    masked, 4-byte accesses where a row of S floats is not 16-byte
    aligned (33, 100), held as at S=128."""
    _check_compositor(n, s)


def _check_compositor(n, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.ops import compositing_planar_kernel as tck

    g = torch.Generator().manual_seed(n)
    ins = {"zs": torch.sort(torch.rand(n, s, generator=g), 1).values}
    for k in tck.IN_KEYS[1:9]:
        ins[k] = torch.randn(n, s, generator=g) * 2
    for k in tck.IN_KEYS[9:]:
        ins[k] = torch.rand(n, s, generator=g)
    ins = {k: v.cuda() for k, v in ins.items()}
    cot = {k: torch.randn(n, s, generator=g).cuda() for k in tck.OUT_KEYS}
    gmap = torch.randn(n, tck.N_MAP, generator=g).cuda()
    f0 = tck.planar_compositor_fwd_cuda.launches[s]
    w, maps = tck.planar_compositor_fwd(ins)
    d = tck.planar_compositor_bwd(ins, cot, gmap)
    torch.cuda.synchronize()
    assert tck.planar_compositor_fwd_cuda.launches[s] == f0 + 1
    rw, rmaps = tck.planar_compositor_fwd_ref(ins)
    rd = tck.planar_compositor_bwd_ref(ins, cot, gmap)
    torch.testing.assert_close(w, rw, atol=1e-5, rtol=0)
    torch.testing.assert_close(maps, rmaps, atol=1e-5, rtol=0)
    for i, k in enumerate(tck.GRAD_KEYS):
        assert _rel_err(d[i], rd[i]) <= 1e-4, k


def _packed_inputs(n, seed=0, s=128, n_tau=48, dir_w=27, n_a=48):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand(n, 3, generator=g) * 2 - 1
    o[:, 2] = -1
    d = (torch.rand(n, 3, generator=g) - 0.5) * 0.4
    d[:, 2] = 2
    zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    xyz = o[:, None] + d[:, None] * zs[..., None]
    dirs = torch.rand(n, dir_w, generator=g) * 2 - 1
    a = torch.randn(n, n_a, generator=g)
    t = torch.randn(n, n_tau, generator=g)
    return tuple(x.cuda().contiguous() for x in (xyz, zs, dirs, a, t)) + (g,)


# (static_branch, encode_t, encode_a, output_flow)
PACKED_VARIANTS = {"full": (True, True, False, ("fw", "bw")),
                   "appearance": (True, True, True, ("fw", "bw")),
                   "static_only": (True, False, False, ()),
                   "fw_warp": (False, True, False, ("bw",)),
                   "bw_warp": (False, True, False, ("fw",)),
                   "no_flow": (True, True, False, ())}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 96, 100, 128, 192, 256, 320, 512])
@pytest.mark.parametrize("n", [1, 37, 4096])
@pytest.mark.parametrize("variant", sorted(PACKED_VARIANTS))
def test_packed_kernels_match_plain(variant, n, s):
    """fused_nerf_eval at any sample count (one CTA per ray and tile of
    128 samples, the last tile 1 to 128 used; sorted
    random depths), 8x256 towers, N_tau=48, for one ray, an
    odd ray count and 4096 rays, and both
    branches of the fused_nerf_train backward (with and without the xyz
    cotangent) at one ray and the odd count. Packed rows: at most 1e-3 abs and at most
    a fifth of the rows off by more than 1e-5 in any column (a row shows a
    bf16 rounding flip of an activation whole); unused columns exactly
    zero; gradients: every leaf within 0.1 of its largest entry and 5e-2
    in Frobenius norm, the per-sample xyz cotangent within 0.25 of its
    largest entry (a flipped ReLU mask shows whole in one sample's entry),
    as in chip_smoke.py; at every S the same bounds (a multi-tile ray's
    d(dir), d(a), d(t) are sums over its tiles), with the rule of few
    rows (`_few_rows`, `_flips_explain`) where a leaf sums few rows."""
    _check_packed(variant, n, s)


# input widths past the flagship's: 17 posenc frequencies (113 lanes with
# N_tau 8, one segment), two 128-lane segments (B5's wide instance): N_tau
# 80 (143 lanes), 22 frequencies (135 lanes); three and more (B5's
# streamed instance): N_tau 200 (263 lanes, three), 43 frequencies with
# N_tau 200 (461 lanes, four), N_tau 900 (963 lanes, eight); and the
# direction and appearance embeddings past one segment (N_emb_dir 22, N_a
# 160) at N_tau 80. (N_emb_xyz, N_tau[, N_emb_dir, N_a])
PACKED_WIDTHS = {"n_emb_xyz_17": (17, 8), "n_tau_80": (10, 80),
                 "n_emb_xyz_22": (22, 48), "n_tau_200": (10, 200),
                 "n_emb_xyz_43_n_tau_200": (43, 200), "n_tau_900": (10, 900),
                 "dir_22_a_160": (10, 80, 22, 160)}
# (widths, rays, samples): the two-segment and 17-frequency grid; three
# segments at S = 1, 100, 128 and 320; four at 128; eight at 256 rays;
# the wide embeddings at 128
WIDTH_CASES = (
    [(w, n, s) for w in ("n_emb_xyz_17", "n_tau_80", "n_emb_xyz_22")
     for n in (1, 37, 4096) for s in (1, 33, 128, 320)]
    + [("n_tau_200", n, s) for n in (1, 37, 4096) for s in (1, 100, 128, 320)]
    + [("n_emb_xyz_43_n_tau_200", n, 128) for n in (1, 37, 4096)]
    + [("n_tau_900", 256, s) for s in (100, 128)]
    + [("dir_22_a_160", n, 128) for n in (1, 37, 4096)])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(PACKED_VARIANTS))
@pytest.mark.parametrize("widths,n,s", WIDTH_CASES)
def test_packed_kernels_match_plain_at_widths(widths, n, s, variant):
    """`test_packed_kernels_match_plain` at the PACKED_WIDTHS, with its
    bounds: B5 (its wide instance at two segments, its streamed instance
    past two) and, at 17 frequencies, both backward branches of B4; past
    one segment B4's wrapper raises (the JAX gradient does too). With the
    wide direction and appearance embeddings the static-only variant's
    tower input (63 lanes) fits one segment, where B5 refuses them."""
    _check_packed(variant, n, s, *PACKED_WIDTHS[widths])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [100, 128, 320])
@pytest.mark.parametrize("variant", ["full", "static_only", "fw_warp"])
@pytest.mark.parametrize("widths", ["flagship", "n_tau_80"])
def test_streamed_instance_equals_resident_bits(widths, variant, s):
    """B5's streamed instance (the input segments filled at layer 0 and
    the skip layer while the products run) against the resident one- and
    two-segment instances on the same inputs, launched with the streamed
    instance from one segment on (`mlp_kernel.STREAM_FROM`): the same
    products in the same order, so the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk

    n_emb, n_tau = {"flagship": (10, 48), "n_tau_80": (10, 80)}[widths]
    static_branch, encode_t, encode_a, flow = PACKED_VARIANTS[variant]
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 in_channels_xyz=3 + 6 * n_emb,
                                 use_viewdir=True, encode_transient=True,
                                 in_channels_t=n_tau, output_flow=True,
                                 device="cuda")
    xyz, _, dirs, a, t, _ = _packed_inputs(37, s=s, n_tau=n_tau)
    op = mk.make_fused_nerf_eval(s, use_viewdir=True, encode_a=encode_a,
                                 encode_t=encode_t, output_flow=flow,
                                 static_branch=static_branch,
                                 n_emb_xyz=n_emb, n_tau=n_tau)
    args = (op.pack(params), xyz, dirs if static_branch else None, None,
            t if encode_t else None)
    resident = mk.fused_nerf_eval_cuda(*args, **op.kernel_kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(mk, "STREAM_FROM", 1)
        streamed = mk.fused_nerf_eval_cuda(*args, **op.kernel_kw)
    torch.cuda.synchronize()
    assert torch.equal(streamed, resident)


def _check_packed(variant, n, s, n_emb=10, n_tau=48, n_dir=4, n_a=48):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import mlp_kernel as mk
    from nsff_pl_tpu_torch.ops import mlp_train_kernel as mtk

    static_branch, encode_t, encode_a, flow = PACKED_VARIANTS[variant]
    params = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                                 in_channels_xyz=3 + 6 * n_emb,
                                 use_viewdir=True,
                                 in_channels_dir=3 + 6 * n_dir,
                                 encode_appearance=encode_a,
                                 in_channels_a=n_a,
                                 encode_transient=True, in_channels_t=n_tau,
                                 output_flow=True, device="cuda")
    xyz, _, dirs, a, t, g = _packed_inputs(n, s=s, n_tau=n_tau,
                                           dir_w=3 + 6 * n_dir, n_a=n_a)
    lanes = 3 + 6 * n_emb + (n_tau if encode_t else 0)
    wide = lanes > trk.SEG
    wkw = dict(use_viewdir=True, encode_a=encode_a, encode_t=encode_t,
               output_flow=flow, static_branch=static_branch,
               n_emb_xyz=n_emb, n_tau=n_tau, n_emb_dir=n_dir, n_a=n_a)
    if not wide and (n_dir, n_a) != (4, 48):
        # wide embeddings within one segment: refused, as JAX's padded
        # layout raises or is wrong there
        with pytest.raises(ValueError, match="ROADMAP C"):
            mk.make_fused_nerf_eval(s, **wkw)
        return
    op = (mk.make_fused_nerf_eval if wide else mtk.make_fused_nerf_train)(
        s, **wkw)
    pw, kw = op.pack(params), op.kernel_kw
    assert trk.packed_in_rows(pw) == trk.input_segs(lanes) * trk.SEG
    args = (pw, xyz, dirs if static_branch else None,
            a if encode_a else None, t if encode_t else None)
    before = mk.fused_nerf_eval_cuda.launches[s]
    got = mk.fused_nerf_eval(*args, **kw)
    torch.cuda.synchronize()
    assert mk.fused_nerf_eval_cuda.launches[s] == before + 1
    want = mk.fused_nerf_eval_ref(*args, **kw)
    err = (got - want).abs()
    assert float(err.max()) <= 1e-3
    assert float((err.amax(-1) > 1e-5).float().mean()) <= 0.2
    unused = ([] if static_branch else [0, 1, 2, 3]) + list(
        range(8 + 3 * len(flow) if encode_t else 4, 16))
    assert not bool(got[..., unused].any())
    if wide:
        with pytest.raises(ValueError, match="one 128-lane segment"):
            mtk.make_fused_nerf_train(s, **wkw)
        return
    if n > 37:  # the backward at one ray and the odd count
        return

    cot = torch.randn(n, s, 16, generator=g).cuda()
    bkw = {k: kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "output_flow", "flow_scale", "D", "skips")}
    for branch in (["static"] if static_branch else []) + (
            ["transient"] if encode_t else []):
        for need_dxyz in (False, True):
            b0 = mtk.fused_nerf_train_bwd_cuda.launches[branch][s]
            got = mtk.fused_nerf_train_bwd(branch, *args, cot,
                                           need_dxyz=need_dxyz, **bkw)
            torch.cuda.synchronize()
            assert mtk.fused_nerf_train_bwd_cuda.launches[branch][s] == \
                b0 + 1
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
            missed = []
            for name, x, y, tol in pairs:
                assert bool(torch.isfinite(x).all()), name
                fro = float((x - y).norm()) <= 5e-2 * float(y.norm()) + 1e-12
                if _rel_err(x, y) > tol or not fro:
                    missed.append((name, _rel_err(x, y)))
            if missed:
                assert _few_rows(n, s, missed), missed
                _flips_explain(lambda: mtk.fused_nerf_train_bwd_ref(
                    branch, *args, cot, need_dxyz=need_dxyz, **bkw),
                    _summed_verdict(got), f"{variant} n={n} S={s} {branch}")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 64, 96, 100, 128, 192, 256, 320, 512])
@pytest.mark.parametrize("n", [1, 37, 512, 8192])
def test_packed_compositing_kernels_match_plain(n, s):
    """fused_compositing forward (1e-5 abs) and adjoint (1e-4 of each
    column's largest cotangent; columns 8-15 exactly zero) at any sample
    count (a ray in chunks of at most 8 warps, the last warp's tail
    masked; two chunks at 320 and 512), with sigmas that drive 1 - alpha
    to underflow at some samples (at sample 40, or the last of a shorter
    ray) and raw sigmas of exactly zero at others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.ops import compositing_kernel as fck

    g = torch.Generator().manual_seed(n)
    packed = torch.randn(n, s, 16, generator=g)
    packed[..., [0, 1, 2, 4, 5, 6]] = torch.rand(n, s, 6, generator=g)
    packed[..., [3, 7]] *= 3
    packed[::3, min(40, s - 1), 3] = 2000.0  # opaque: 1 - alpha underflows
    packed[1::3, ::7, 3] = 0.0
    zs = torch.sort(torch.rand(n, s, generator=g), 1).values
    ns, nt = (torch.randn(n, s, generator=g) for _ in range(2))
    ns[1::3, ::7] = 0.0
    packed, zs, ns, nt = (x.cuda().contiguous() for x in (packed, zs, ns, nt))
    cot = {k: torch.randn(n, s, generator=g).cuda() for k in fck.OUT_KEYS}
    gmap = torch.randn(n, 4, generator=g).cuda()
    f0 = fck.fused_compositing_fwd_cuda.launches[s]
    b0 = fck.fused_compositing_bwd_cuda.launches[s]
    planes, maps = fck.fused_compositing_fwd(packed, zs, ns, nt)
    dp = fck.fused_compositing_bwd(packed, zs, ns, nt, cot, gmap)
    torch.cuda.synchronize()
    assert fck.fused_compositing_fwd_cuda.launches[s] == f0 + 1
    assert fck.fused_compositing_bwd_cuda.launches[s] == b0 + 1
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


@pytest.mark.cuda
def test_tmp_rgb_write_keeps_the_last_draw_on_the_card():
    """`training/step.py::write_tmp_rgb` on the card, eagerly and replayed
    from a CUDA graph, on 4096 draws of 64 pixels (each pixel drawn ~64
    times): the CPU write's bits, which keep each pixel's last draw in
    batch order (tests/test_torch_c2f_step.py holds the CPU write to the
    JAX step's scatter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.training.step import write_tmp_rgb

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 64, (4096,), generator=g)
    rgb = torch.rand((4096, 3), generator=g)
    want = torch.zeros(3, 64, 3)
    write_tmp_rgb(want, 1, idx, rgb)
    last = {int(p): i for i, p in enumerate(idx)}
    for p, i in last.items():
        assert torch.equal(want[1, p], rgb[i])
    got = torch.zeros(3, 64, 3, device="cuda")
    t = torch.tensor(1, device="cuda")
    idx_c, rgb_c = idx.cuda(), rgb.cuda()
    write_tmp_rgb(got, t, idx_c, rgb_c)
    assert torch.equal(got.cpu(), want)
    got.zero_()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        write_tmp_rgb(got, t, idx_c, rgb_c)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_hard_sampling_draw_is_deterministic():
    """The weighted draw of a batch (`data/pipeline.py::_sample_batch`
    with hard sampling) on non-integer weights of a 512x288 frame: the
    same pixels from the same uniforms on every call (the CDF is
    `weight_cdf`, no timing-dependent scan), and its CDF within 1e-6 of
    the float64 cumulative sum relative to the total."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.data.pipeline import _sample_batch, blocked_cumsum

    g = torch.Generator(device="cuda").manual_seed(3)
    hw = 512 * 288
    table = torch.rand((2, hw, 16), generator=g, device="cuda")
    weights = torch.rand((2, hw), generator=g, device="cuda")
    u = torch.rand((4096,), generator=g, device="cuda")
    first = [_sample_batch(table, weights, 1, 4096, True, u=u)["rand_idx"]
             for _ in range(5)]
    assert all(torch.equal(first[0], x) for x in first[1:])
    cdf = [blocked_cumsum(weights[1]) for _ in range(5)]
    assert all(torch.equal(cdf[0], x) for x in cdf[1:])
    want = torch.cumsum(weights[1].double(), 0)
    assert float((cdf[0].double() - want).abs().max()) <= 1e-6 * float(
        want[-1])



@pytest.mark.cuda
@pytest.mark.parametrize("op", ["planar_eval_comp", "fused_nerf_eval",
                                "planar_nerf_train_fwd"])
def test_custom_ops_launch_the_kernels(op):
    """B1, B5 and B2's forward as the custom ops of `ops/library.py` on
    CUDA tensors: `torch.library.opcheck` passes, and a call launches the
    kernel once and gives the wrapper's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.models import nerf as tn
    from nsff_pl_tpu_torch.ops import library
    from nsff_pl_tpu_torch.ops import mlp_kernel as tmk

    n, s = 37, 128
    g = torch.Generator().manual_seed(0)
    params = tn.init_nerf_params(g, "fine", use_viewdir=True,
                                 encode_transient=True, output_flow=True,
                                 device="cuda")
    o = (torch.rand(n, 3, generator=g) * 2 - 1).cuda()
    d = ((torch.rand(n, 3, generator=g) - 0.5) * 0.4).cuda()
    dirs = (torch.rand(n, 27, generator=g) * 2 - 1).cuda()
    t = torch.randn(n, 48, generator=g).cuda()
    zs = torch.linspace(0, 1, s, device="cuda").expand(n, s).contiguous()
    if op == "planar_eval_comp":
        fn = trk.make_planar_nerf_eval_comp(s, use_viewdir=True)
        args = (fn.pack(params), o, d, zs, None, dirs, None, t)
        call, wrapper = library.call_planar_eval_comp, trk.planar_eval_comp
        counter = trk.planar_eval_comp_cuda.launches
    elif op == "planar_nerf_train_fwd":
        fn = trk.make_planar_nerf_train(s, use_viewdir=True,
                                        output_flow=("fw", "bw"))
        args = (fn.pack(params), o, d, zs, None, dirs, None, t)
        call = library.call_planar_nerf_train_fwd
        wrapper = trk.planar_nerf_train_fwd
        counter = trk.planar_nerf_train_fwd_cuda.launches
    else:
        fn = tmk.make_fused_nerf_eval(s, use_viewdir=True, encode_a=False,
                                      encode_t=True, output_flow=("fw",))
        xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
        args = (fn.pack(params), xyz, dirs, None, t)
        call, wrapper = library.call_fused_nerf_eval, tmk.fused_nerf_eval
        counter = tmk.fused_nerf_eval_cuda.launches
    want = wrapper(*args, **fn.kernel_kw)
    before = counter[s]
    got = call(*args, **fn.kernel_kw)
    torch.cuda.synchronize()
    assert counter[s] == before + 1
    assert torch.equal(got, want)
    w, b, slots = library.slot_lists(args[0])
    kw = dict(fn.kernel_kw, freqs=list(fn.kernel_kw["freqs"]),
              skips=list(fn.kernel_kw["skips"]))
    if op != "planar_eval_comp":
        flow = kw.pop("output_flow")
        kw.update(flow_fw="fw" in flow, flow_bw="bw" in flow)
    rest = args[1:]
    if op == "planar_nerf_train_fwd":  # flows: a list, empty for none
        rest = rest[:3] + ([],) + rest[4:]
    torch.library.opcheck(getattr(library, op), (w, b, slots, *rest), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("encode_t", [True, False])
def test_exported_kernel_route_on_the_card(tmp_path, encode_t):
    """`tools/export_render.py --mlp_backend pallas --platforms cuda` on a
    seeded model: the graph holds the kernel's op (B1 with encode_t, B5
    without), and the reloaded program gives the live renderer's output
    (--check) with one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.ops import library
    from nsff_pl_tpu_torch.ops import mlp_kernel as tmk
    from nsff_pl_tpu_torch.tools import export_render
    from nsff_pl_tpu_torch.training import checkpoint

    params = build_params(NSFFConfig(use_viewdir=True, encode_t=encode_t,
                                     start_end=(0, 4)),
                          torch.Generator().manual_seed(0), device="cuda")
    ckpt = checkpoint.save_checkpoint(str(tmp_path), 0, {"params": params})
    out = str(tmp_path / "render.pt2")
    argv = ["--ckpt_path", ckpt, "--out", out, "--chunk", "512",
            "--img_wh", "32", "16", "--use_viewdir", "--N_frames", "4",
            "--dtype", "bfloat16", "--mlp_backend", "pallas",
            "--platforms", "cuda", "--check"]
    if encode_t:
        argv += ["--encode_t", "--output_transient"]
    meta = export_render.main(export_render.get_opts(argv))
    assert max(meta["check"].values()) <= export_render.CHECK_TOL
    name = "planar_eval_comp" if encode_t else "fused_nerf_eval"
    counter = (trk.planar_eval_comp_cuda if encode_t
               else tmk.fused_nerf_eval_cuda).launches
    prog = torch.export.load(out)
    assert {str(n.target) for n in prog.graph.nodes
            if str(n.target).startswith(library.NAMESPACE)} == {
        f"{library.NAMESPACE}.{name}.default"}
    before = counter[128]
    rays, ts = export_render.check_rays(512, torch.device("cuda"))
    prog.module()(rays, ts)
    torch.cuda.synchronize()
    assert counter[128] == before + 1


@pytest.mark.cuda
def test_exported_c2f_route_on_the_card(tmp_path):
    """The planar coarse-to-fine route (`--encode_t --N_importance 64`):
    the graph holds B2's forward and B1, and the reloaded program gives
    the live renderer's bits with one launch of each a call, B2's forward
    at 128 samples and B1 at 192."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.ops import library
    from nsff_pl_tpu_torch.tools import export_render
    from nsff_pl_tpu_torch.training import checkpoint

    params = build_params(NSFFConfig(use_viewdir=True, encode_t=True,
                                     N_importance=64, start_end=(0, 4)),
                          torch.Generator().manual_seed(0), device="cuda")
    ckpt = checkpoint.save_checkpoint(str(tmp_path), 0, {"params": params})
    out = str(tmp_path / "render.pt2")
    meta = export_render.main(export_render.get_opts(
        ["--ckpt_path", ckpt, "--out", out, "--chunk", "512", "--img_wh",
         "32", "16", "--use_viewdir", "--N_frames", "4", "--encode_t",
         "--N_importance", "64", "--dtype", "bfloat16", "--mlp_backend",
         "pallas", "--platforms", "cuda", "--check"]))
    assert max(meta["check"].values()) == 0.0
    prog = torch.export.load(out)
    assert sorted(str(n.target) for n in prog.graph.nodes
                  if str(n.target).startswith(library.NAMESPACE)) == [
        f"{library.NAMESPACE}.planar_eval_comp.default",
        f"{library.NAMESPACE}.planar_nerf_train_fwd.default"]
    fwd = trk.planar_nerf_train_fwd_cuda.launches
    b1 = trk.planar_eval_comp_cuda.launches
    before = (fwd[128], b1[192])
    rays, ts = export_render.check_rays(512, torch.device("cuda"))
    prog.module()(rays, ts)
    torch.cuda.synchronize()
    assert (fwd[128], b1[192]) == (before[0] + 1, before[1] + 1)
