"""The port's tower kernels at tower inputs (posenc [+ time latent]) wider
than the flagship's, against the JAX package, whose Pallas kernels run
here in interpret mode as the JAX package's own tests run them.

Three things are held here:
- **17-20 posenc frequencies** (3 + 6 N_emb_xyz = 105-123 lanes), which
  fit one 128-lane segment: the JAX kernels run there, and every wrapper
  of the port takes them (the one-segment kernels' frequency bound is
  `ops/raymarch_kernel.py::MAX_FREQS`, which `ops/cuda_build.py` hands to
  nvcc as their MAXF). The plain B2 forward and gradients and B4's
  gradients at N_emb_xyz 17, N_tau 8 against JAX.
- **The packed evaluator (B5) at any input width**: two segments (N_tau
  80, 143 lanes; N_emb_xyz 22, 135; N_emb_xyz 20 with N_tau 8, 131),
  three and more (N_tau 200, 263 lanes; N_emb_xyz 43, 309; both, 461;
  N_tau 321, 384), where the JAX kernel drops to its unpadded layout and
  the port packs ceil(lanes / 128) input segments. The plain B5 against
  JAX, the packing's round trip, the test-time `render_rays` on the kernel
  backend, and the export op. There the JAX gradient of
  `make_fused_nerf_train` and the JAX planar kernels raise, and so do the
  port's B4 and planar builders and wrappers.
- **Direction and appearance embeddings past one segment** (N_emb_dir
  22, N_a 160): taken where the tower input passes one segment, as JAX's
  unpadded layout takes them, and refused within one, where JAX raises or
  is wrong (ROADMAP C).

Tolerances are the existing files' (tests/test_torch_mlp_kernel.py,
tests/test_torch_train_kernel.py, tests/test_torch_mlp_train_kernel.py,
tests/test_torch_packed_render.py), for the same reasons: both sides
round at the same points, the f32 sums run in another order. At 131
and 309 lanes (20 and 43 posenc frequencies) one raw transient sigma
reads past the forward's 1e-4: there the test requires that at most two
bf16 rounding ties of its row, each within its f32 reordering bound,
taken the other way bring it within 1e-6 of JAX's (`_ties_explain`). Inputs are dyadic, so x * f is exact in f32 on
both sides at dyadic frequencies. S = 16; torch runs on one thread, each
JAX reference under one `jax.jit`.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them there at these widths."""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.models.rendering import render_rays as j_render_rays
from nsff_pl_tpu.ops import mlp_kernel as jmk
from nsff_pl_tpu.ops import mlp_train_kernel as jmt
from nsff_pl_tpu.ops import raymarch_kernel as jrk
from nsff_pl_tpu_torch.models import nerf as tn
from nsff_pl_tpu_torch.models.rendering import RenderConfig, render_rays
from nsff_pl_tpu_torch.ops import cuda_build, library
from nsff_pl_tpu_torch.ops import mlp_kernel as tmk
from nsff_pl_tpu_torch.ops import mlp_train_kernel as tmt
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk
from nsff_pl_tpu_torch.tools import export_render as ter
from nsff_pl_tpu_torch.training.checkpoint import params_from_jax
from tests.test_torch_mlp_kernel import check_packed

S = 16
N = 8
# (N_emb_xyz, N_tau[, N_emb_dir, N_a]) past one segment: two segments (143,
# 135 and 131 lanes), three and more (263, 309, 461, 384 lanes), and the
# wide direction and appearance embeddings (143 lanes); the repaired
# frequency counts
WIDE = {"n_tau_80": (10, 80), "n_emb_xyz_22": (22, 48),
        "n_emb_xyz_20": (20, 8), "n_tau_200": (10, 200),
        "n_emb_xyz_43": (43, 48), "n_emb_xyz_43_n_tau_200": (43, 200),
        "n_tau_321": (10, 321), "dir_22_a_160": (10, 80, 22, 160)}
# the widths where a miss of the forward's 1e-4 must be explained by
# rounding ties (`_ties_explain`): 131 and 309 lanes (20 and 43
# frequencies), ROADMAP C; the pairs of ties tried, nearest first
TIE_WIDTHS = ("n_emb_xyz_20", "n_emb_xyz_43")
TIE_MAX = 2
TIE_PAIRS = 512
REPAIR = (17, 8)
FWD_TOL, FWD_EXACT, FWD_EXACT_SHARE = 1e-4, 1e-6, 0.1
GRAD_MAX, GRAD_FRO = 0.1, 5e-2
KERNEL_TOL, KERNEL_EXACT, KERNEL_SHARE = 2e-4, 1e-5, 0.05
JAX_REFUSES = (ValueError, TypeError)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_params(n_emb, n_tau, n_dir=4, n_a=None):
    """JAX-initialised fine-model params; `n_a` None: no appearance."""
    return jn.init_nerf_params(
        jax.random.PRNGKey(1), "fine", use_viewdir=True,
        encode_transient=True, in_channels_xyz=3 + 6 * n_emb,
        in_channels_dir=3 + 6 * n_dir, encode_appearance=n_a is not None,
        in_channels_a=n_a or 48, in_channels_t=n_tau, output_flow=True)


def port_params(n_emb, n_tau, grad=False, n_dir=4, n_a=None):
    p = params_from_jax(jax.tree.map(np.asarray,
                                     jax_params(n_emb, n_tau, n_dir, n_a)),
                        "cpu")
    if grad:
        for leaf in (x for layer in p.values() for x in layer.values()):
            leaf.requires_grad_(True)
    return p


def points(n, n_tau, seed=0):
    """Dyadic points (n, S, 3), direction embeddings (n, 27), time latents
    (n, n_tau)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(-64, 65, (n, S, 3)) / 64.0).astype(np.float32)
    dirs = (rng.rand(n, 27) * 2 - 1).astype(np.float32)
    t = rng.randn(n, n_tau).astype(np.float32)
    return xyz, dirs, t


def embeddings(n, n_dir, n_a, seed=5):
    """Direction embeddings (n, 3 + 6 n_dir) and appearance embeddings
    (n, n_a), or None without appearance."""
    rng = np.random.RandomState(seed)
    dirs = (rng.rand(n, 3 + 6 * n_dir) * 2 - 1).astype(np.float32)
    a = rng.randn(n, n_a).astype(np.float32) if n_a else None
    return dirs, a


def rays(n, n_tau, seed=0):
    """Dyadic planar inputs: o, d (n, 3), sorted depths (n, S), the
    direction embeddings and time latents."""
    rng = np.random.RandomState(seed)
    o = (rng.randint(-32, 32, (n, 3)) / 64).astype(np.float32)
    d = (rng.randint(-32, 32, (n, 3)) / 64).astype(np.float32)
    zs = np.stack([np.sort(rng.choice(256, S, replace=False))
                   for _ in range(n)]).astype(np.float32) / 256
    dirs = rng.uniform(-1, 1, (n, 27)).astype(np.float32)
    t = rng.randn(n, n_tau).astype(np.float32)
    return o, d, zs, dirs, t


# ------------------------------------------------ B5 past one segment

B5_VARIANTS = {"full": (True, True, ("fw", "bw")),
               "static_only": (True, False, ()),
               "transient_only": (False, True, ("bw",))}


def _widths(width):
    """(n_emb, n_tau, n_dir, n_a) of a WIDE entry; n_a None: no
    appearance."""
    n_emb, n_tau, n_dir, n_a = (WIDE[width] + (4, None))[:4]
    return n_emb, n_tau, n_dir, n_a


def _b5_kw(n_emb, n_tau, variant, n_dir=4, n_a=None):
    static_branch, encode_t, flow = B5_VARIANTS[variant]
    return dict(use_viewdir=True, encode_a=n_a is not None,
                encode_t=encode_t, output_flow=flow, n_emb_xyz=n_emb,
                n_tau=n_tau, n_emb_dir=n_dir, n_a=n_a or 48,
                static_branch=static_branch)


def _b5_against_jax(n_emb, n_tau, variant, n_dir=4, n_a=None):
    """(port's plain B5, JAX's interpreted kernel, the packed weights, the
    port's inputs) at S = 16 on N rays."""
    kw = _b5_kw(n_emb, n_tau, variant, n_dir, n_a)
    static_branch, encode_t, _ = B5_VARIANTS[variant]
    xyz, dirs, t = points(N, n_tau)
    a = None
    if (n_dir, n_a) != (4, None):
        dirs, a = embeddings(N, n_dir, n_a)
    encode_a = a is not None and static_branch
    jfn = jax.jit(jmk.make_fused_nerf_eval(S, block_rows=8 * S, **kw))
    want = np.asarray(jfn(
        jax_params(n_emb, n_tau, n_dir, n_a), jnp.asarray(xyz),
        dir_emb=jnp.asarray(dirs) if static_branch else None,
        a_emb=jnp.asarray(a) if encode_a else None,
        t_emb=jnp.asarray(t) if encode_t else None))
    fn = tmk.make_fused_nerf_eval(S, **kw)
    tp = port_params(n_emb, n_tau, n_dir=n_dir, n_a=n_a)
    pw = fn.pack(tp)
    T = torch.from_numpy
    args = (T(xyz), T(dirs), T(a) if encode_a else None, T(t))
    got = fn(tp, *args, pw=pw).numpy()
    return got, want, fn, pw, args


def _ties_explain(fn, pw, args, ray, s, col, want):
    """At most TIE_MAX bf16 rounding ties of row (ray, s) in the tower that
    feeds column `col` (`tests/test_torch_cuda.py::_row_ties`: each within
    its f32 reordering bound of a rounding midpoint, or a ReLU decision
    within its bound of zero), taken the other way in the plain version's
    own f32 forward, bring the column within FWD_EXACT of JAX's `want`.
    Returns the ties and the value they give; asserts they exist."""
    from tests.test_torch_cuda import _row_ties

    prefix = "static_xyz" if col < 4 else "transient_xyz"
    ray_args = tuple(x[ray:ray + 1] if x is not None else None for x in args)

    def run(chosen):
        seen = {}

        def tower(pw_, pre, inp, D, skips, keep=False):
            acts = [inp]
            h, kin = inp, inp.shape[1]
            for i in range(D):
                w, b = pw_[f"{pre}_{i}"]["w"], pw_[f"{pre}_{i}"]["b"]
                z = (trk._mm(inp, w[:kin]) + trk._mm(h, w[kin:kin + trk.WIDTH])
                     + b) if i in skips else trk._mm(h, w, b)
                h = trk._bf16(torch.relu(z))
                for j, v, *_, other in chosen:
                    if pre == prefix and j == i:
                        h = h.clone()
                        h[s, v] = other
                acts.append(h)
            seen[pre] = acts
            return acts if keep else h

        with pytest.MonkeyPatch.context() as m:
            m.setattr(tmk, "_tower_ref", tower)
            out = fn(None, *ray_args, pw=pw)
        return float(out[0, s, col]), seen

    base, seen = run(())
    ties = _row_ties(pw, prefix, seen[prefix], s, 8)
    moved = [(run((t,))[0], t) for t in ties]
    for v, t in moved:
        if abs(v - want) <= FWD_EXACT:
            return [t], v
    # pairs, nearest first by the sum of their single moves
    gap = want - base
    pairs = sorted(
        ((abs((v1 - base) + (v2 - base) - gap), t1, t2)
         for i, (v1, t1) in enumerate(moved) for v2, t2 in moved[i + 1:]),
        key=lambda x: x[0])
    for _, t1, t2 in pairs[:TIE_PAIRS]:
        v = run((t1, t2))[0]
        if abs(v - want) <= FWD_EXACT:
            return [t1, t2], v
    raise AssertionError(
        f"row ({ray}, {s}) column {col}: {base} against JAX's {want}, no "
        f"{TIE_MAX} of its {len(ties)} rounding ties bring it within "
        f"{FWD_EXACT}")


@pytest.mark.parametrize("variant", sorted(B5_VARIANTS))
@pytest.mark.parametrize("width", sorted(WIDE))
def test_packed_evaluator_matches_jax_past_one_segment(width, variant):
    """The plain B5 against JAX's interpreted `make_fused_nerf_eval` at
    every WIDE width, in ceil(lanes / 128) input segments, under
    `check_packed`'s bounds. At the TIE_WIDTHS (131 and 309 lanes) an
    entry past 1e-4 must be explained by at most TIE_MAX rounding ties of
    its row (`_ties_explain`). The wide direction and appearance embeddings are
    taken past one segment; static only (63 lanes, one segment) both
    packages refuse them, the port with its labelled message."""
    n_emb, n_tau, n_dir, n_a = _widths(width)
    static_branch, encode_t, flow = B5_VARIANTS[variant]
    lanes = 3 + 6 * n_emb + (n_tau if encode_t else 0)
    if n_a is not None and lanes <= trk.SEG:
        kw = _b5_kw(n_emb, n_tau, variant, n_dir, n_a)
        xyz, _, _ = points(N, n_tau)
        dirs, a = embeddings(N, n_dir, n_a)
        with pytest.raises(JAX_REFUSES):
            jmk.make_fused_nerf_eval(S, block_rows=8 * S, **kw)(
                jax_params(n_emb, n_tau, n_dir, n_a), jnp.asarray(xyz),
                dir_emb=jnp.asarray(dirs), a_emb=jnp.asarray(a))
        with pytest.raises(ValueError, match="ROADMAP C"):
            tmk.make_fused_nerf_eval(S, **kw)
        return
    got, want, fn, pw, args = _b5_against_jax(n_emb, n_tau, variant, n_dir,
                                              n_a)
    assert trk.packed_in_rows(pw) == trk.input_segs(lanes) * trk.SEG
    assert got.shape == want.shape == (N, S, 16)
    err = np.abs(got - want)
    assert (err.max(-1) > FWD_EXACT).mean() <= FWD_EXACT_SHARE
    if width in TIE_WIDTHS:
        for ray, s, col in np.argwhere(err > FWD_TOL):
            ties, v = _ties_explain(fn, pw, args, ray, s, col,
                                    float(want[ray, s, col]))
            print(f"{width} {variant}: row ({ray}, {s}) column {col} "
                  f"{got[ray, s, col]} against JAX's {want[ray, s, col]}; "
                  f"{v} with the ties (layer, unit, distance to the "
                  f"midpoint, f32 bound, other rounding) {ties}")
    else:
        check_packed(got, want)
    assert not got[..., (8 + 3 * len(flow)) if encode_t else 4:].any()


@pytest.mark.parametrize("width", ["n_tau_80", "n_emb_xyz_22"])
def test_two_segment_packing_round_trips(width):
    """`pack_padded_weights` in two segments (layer 0 (256, 256), the skip
    layer (512, 256), h at rows [256, 512)) and `unpad_padded_grads` give
    back the bf16 weights, as the JAX package's unpadded layout holds
    them."""
    _check_round_trip(*WIDE[width], 2)


def _check_round_trip(n_emb, n_tau, n_segs, n_dir=4, n_a=None):
    fn = tmk.make_fused_nerf_eval(S, **_b5_kw(n_emb, n_tau, "full", n_dir,
                                              n_a))
    tp = port_params(n_emb, n_tau, n_dir=n_dir, n_a=n_a)
    pw = fn.pack(tp)
    kin = n_segs * trk.SEG
    for p in ("static", "transient"):
        assert pw[f"{p}_xyz_0"]["w"].shape == (kin, trk.WIDTH)
        assert pw[f"{p}_xyz_4"]["w"].shape == (kin + trk.WIDTH, trk.WIDTH)
        assert not pw[f"{p}_xyz_4"]["w"][
            3 + 6 * n_emb + (n_tau if p == "transient" else 0):kin].any()
    dir_w = 3 + 6 * n_dir
    a0, rows = trk.static_dir_rows(dir_w, n_a or 0, n_a is not None)
    sd = pw["static_dir"]["w"]
    assert sd.shape == (rows, trk.WIDTH)
    assert not sd[trk.WIDTH + dir_w:a0].any()
    assert not sd[a0 + (n_a or 0):].any()
    back = trk.unpad_padded_grads(pw, fn.weight_names, **fn.pack_kw)
    for name in fn.weight_names:
        if name == "transient_heads":
            continue
        want = tp[name]["w"].to(torch.bfloat16)
        assert torch.equal(back[name]["w"], want.float()), name
    assert torch.equal(back["transient_rgb"]["w"],
                       tp["transient_rgb"]["w"].to(torch.bfloat16).float())


@pytest.mark.parametrize("n_emb,n_tau,n_segs,n_dir,n_a", [
    (10, 200, 3, 4, None), (43, 48, 3, 4, None), (43, 200, 4, 4, None),
    (10, 321, 3, 4, None), (43, 700, 8, 4, None), (10, 80, 2, 22, 160),
    (10, 200, 3, 22, 48)])
def test_packing_round_trips_at_any_segment_count(n_emb, n_tau, n_segs,
                                                  n_dir, n_a):
    """The N-segment packing: layer 0 (128 n, 256), the skip layer (128 n
    + 256, 256) with h at row 128 n, the direction embedding in its
    segments from row 256 and the appearance after them; zero rows
    between; `unpad_padded_grads` gives back the bf16 weights."""
    _check_round_trip(n_emb, n_tau, n_segs, n_dir, n_a)


@pytest.mark.parametrize("n_tau,n_dir,n_a", [
    (80, 22, None), (200, 22, None), (200, 4, 160), (200, 22, 48),
    (48, 22, 48)])
def test_wide_embeddings_match_jax(n_tau, n_dir, n_a):
    """Direction (N_emb_dir 22, 135 lanes) and appearance (N_a 160)
    embeddings past one segment, full evaluation, against JAX's unpadded
    layout at 143 and 263 lanes under `check_packed`. At 111 lanes (one
    segment) JAX runs its padded layout, whose direction rows overlap the
    appearance's (ROADMAP C): there the port's builder and wrapper refuse
    with the labelled message."""
    n_emb = 10
    if 3 + 6 * n_emb + n_tau <= trk.SEG:
        kw = _b5_kw(n_emb, n_tau, "full", n_dir, n_a)
        with pytest.raises(ValueError, match="ROADMAP C.*mlp_backend='xla'"):
            tmk.make_fused_nerf_eval(S, **kw)
        fn = tmk.make_fused_nerf_eval(
            S, **_b5_kw(n_emb, n_tau, "full"))  # the narrow build, for its packing
        xyz, _, t = points(2, n_tau)
        dirs, a = embeddings(2, n_dir, n_a)
        T = torch.from_numpy
        tp = port_params(n_emb, n_tau, n_dir=n_dir, n_a=n_a)
        with pytest.raises(ValueError, match="ROADMAP C"):
            tmk.fused_nerf_eval_cuda(
                fn.pack(tp), T(xyz), T(dirs), T(a), T(t),
                **dict(fn.kernel_kw, encode_a=True))
        return
    got, want, _, pw, _ = _b5_against_jax(n_emb, n_tau, "full", n_dir, n_a)
    assert pw["static_dir"]["w"].shape[0] == trk.static_dir_rows(
        3 + 6 * n_dir, n_a or 0, n_a is not None)[1]
    check_packed(got, want)


# ------------------------------------------- the 16-frequency cap, repaired

def _hold_or_explain(plain_bwd, leaves, want, what):
    """Every gradient leaf of the port's plain backward within GRAD_MAX of
    the JAX leaf's largest entry and GRAD_FRO in Frobenius norm. Where one
    misses, the rule of few rows (`tests/test_torch_cuda.py::
    _flips_explain`; every leaf here sums at most 80 rows an entry, where
    one ReLU decision taken apart shows whole): at most FLIP_MAX flipped
    tower units, each within its f32 reordering bound of zero or moved
    there by one upstream bf16 rounding tie within its own bound, must
    bring every leaf within the bounds. `leaves(out)`: {name: array} of a
    plain backward's output, keyed like `want` (JAX's)."""
    from tests.test_torch_cuda import _flips_explain

    def verdict(out):
        got, e_max, e_fro = leaves(out), 0.0, 0.0
        for name, w in want.items():
            if not np.any(w):
                assert not np.any(got.get(name, 0.0)), name
                continue
            g = got[name]
            e_max = max(e_max, float(np.abs(g - w).max() / np.abs(w).max()))
            e_fro = max(e_fro, float(np.linalg.norm(g - w)
                                     / np.linalg.norm(w)))
        return e_max, e_fro

    base = verdict(plain_bwd())
    if base[0] > GRAD_MAX or base[1] > GRAD_FRO:
        with torch.no_grad():
            _flips_explain(plain_bwd, verdict, what)


def _param_leaves(dws, op):
    """{"<name>.<w|b>": array} of padded dW / db (`unpad_padded_grads`)."""
    g = trk.unpad_padded_grads(dws, op.weight_names, **op.pack_kw)
    return {f"{k}.{p}": v.detach().numpy() for k, d in g.items()
            for p, v in d.items()}


def _jax_leaves(jdp):
    return {f"{k}.{p}": np.asarray(v) for k, layer in jdp.items()
            for p, v in layer.items()}


@pytest.mark.parametrize("variant", ["main", "fw_warp"])
def test_planar_train_at_17_frequencies_matches_jax(variant):
    """B2's plain forward and hand-written backward at N_emb_xyz 17, N_tau
    8 (113 lanes) against the JAX kernel's forward and custom VJP."""
    static_branch, flow_in, output_flow = {
        "main": (True, False, ("fw", "bw")),
        "fw_warp": (False, True, ("bw",))}[variant]
    n_emb, n_tau = REPAIR
    kw = dict(static_branch=static_branch, flow_in=flow_in,
              use_viewdir=static_branch, encode_a=False, encode_t=True,
              output_flow=output_flow, n_emb_xyz=n_emb, n_tau=n_tau)
    jop = jrk.make_planar_nerf_train(S, block_rows=32, bwd_block_rows=32,
                                     **kw)
    top = trk.make_planar_nerf_train(S, **kw)
    n = 5
    o, d, zs, dirs, t = rays(n, n_tau, seed=1)
    rng = np.random.RandomState(11)
    flows = tuple((rng.randint(-16, 16, (n, S)) / 256).astype(np.float32)
                  for _ in range(3)) if flow_in else None
    g = {k: rng.randn(n, S).astype(np.float32) for k in top.out_keys}
    J = jnp.asarray

    @jax.jit
    def jvjp(p, fl, de, te):
        out, vjp = jax.vjp(lambda p, fl, de, te: jop(
            p, J(o), J(d), J(zs), fl, de, None, te), p, fl, de, te)
        return out, vjp({k: J(v) for k, v in g.items()})

    jout, (jdp, jdfl, jddir, jdt) = jvjp(
        jax_params(n_emb, n_tau),
        tuple(J(x) for x in flows) if flow_in else None,
        J(dirs) if static_branch else None, J(t))
    T = torch.from_numpy
    tp = port_params(n_emb, n_tau, grad=True)
    fl = tuple(T(x).requires_grad_(True) for x in flows) if flow_in else None
    te = T(t).requires_grad_(True)
    de = T(dirs).requires_grad_(static_branch)
    out = top(tp, T(o), T(d), T(zs), fl, de, None, te)
    torch.autograd.backward([out[k] for k in g], [T(g[k]) for k in g])
    for k in jout:
        err = np.abs(out[k].detach().numpy() - np.asarray(jout[k]))
        assert err.max() <= FWD_TOL, (k, err.max())
        assert (err > FWD_EXACT).mean() <= FWD_EXACT_SHARE, k

    want = _jax_leaves(jdp)
    want["t"] = np.asarray(jdt)
    if static_branch:
        want["dir"] = np.asarray(jddir)
    if flow_in:
        want.update({f"flow{c}": np.asarray(jdfl[c]) for c in range(3)})
    pw = top.pack(tp)
    bkw = {k: top.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                         "flow_scale")}
    gd = {k: T(v) for k, v in g.items()}
    flt = tuple(T(x) for x in flows) if flow_in else None

    @torch.no_grad()
    def plain_bwd():
        r = {"dws": {}}
        for branch in (["static"] if static_branch else []) + ["transient"]:
            rb = trk.planar_nerf_train_bwd_ref(
                branch, pw, T(o), T(d), T(zs), flt,
                T(dirs) if static_branch else None, None, T(t), gd, **bkw)
            r["dws"].update(rb.pop("dws"))
            r.update(rb)
        return r

    def leaves(r):
        got = _param_leaves(r["dws"], top)
        got["t"] = r["dt"].numpy()
        if static_branch:
            got["dir"] = r["ddir"].numpy()
        if flow_in:
            got.update({f"flow{c}": r["dflows"][c].numpy()
                        for c in range(3)})
        return got

    # autograd reached the same plain backward
    got = leaves(plain_bwd())
    assert np.array_equal(got["t"], te.grad.numpy())
    for k, layer in tp.items():
        for p, v in layer.items():
            if v.grad is not None:
                assert np.array_equal(got[f"{k}.{p}"], v.grad.numpy()), k
    _hold_or_explain(plain_bwd, leaves, want, f"B2 {variant} at 17 freqs")


@pytest.mark.parametrize("variant", ["main_dxyz", "fw_warp"])
def test_packed_train_at_17_frequencies_matches_jax(variant):
    """B4's plain backward (and B5's forward) at N_emb_xyz 17, N_tau 8
    against JAX's `make_fused_nerf_train`."""
    static_branch, flow = {"main_dxyz": (True, ("fw", "bw")),
                           "fw_warp": (False, ("bw",))}[variant]
    n_emb, n_tau = REPAIR
    n = 5
    kw = dict(use_viewdir=True, encode_a=False, encode_t=True,
              output_flow=flow, n_emb_xyz=n_emb, n_tau=n_tau,
              static_branch=static_branch, need_dxyz=True)
    xyz, dirs, t = points(n, n_tau, seed=2)
    g = np.random.RandomState(102).randn(n, S, 16).astype(np.float32)
    jfn = jmt.make_fused_nerf_train(S, block_rows=8 * S, bwd_block_rows=8 * S,
                                    **kw)

    @jax.jit
    def jvjp(p, x, de, te):
        out, vjp = jax.vjp(lambda p, x, de, te: jfn(p, x, de, None, te),
                           p, x, de, te)
        return out, vjp(jnp.asarray(g))

    jout, (jdp, jdx, jddir, jdt) = jvjp(
        jax_params(n_emb, n_tau), jnp.asarray(xyz),
        jnp.asarray(dirs) if static_branch else None, jnp.asarray(t))
    tp = port_params(n_emb, n_tau, grad=True)
    tin = [torch.from_numpy(v).requires_grad_(True) for v in (xyz, dirs, t)]
    op = tmt.make_fused_nerf_train(S, **kw)
    out = op(tp, tin[0], tin[1] if static_branch else None, None, tin[2])
    (out * torch.from_numpy(g)).sum().backward()
    check_packed(out.detach().numpy(), np.asarray(jout))

    want = _jax_leaves(jdp)
    want.update(xyz=np.asarray(jdx), t=np.asarray(jdt))
    if static_branch:
        want["dir"] = np.asarray(jddir)
    pw = op.pack(tp)
    bkw = {k: op.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                        "output_flow", "flow_scale")}
    T = torch.from_numpy

    @torch.no_grad()
    def plain_bwd():
        r = {"dws": {}}
        for branch in (["static"] if static_branch else []) + ["transient"]:
            rb = tmt.fused_nerf_train_bwd_ref(
                branch, pw, T(xyz), T(dirs) if static_branch else None, None,
                T(t), T(g), need_dxyz=True, **bkw)
            r["dws"].update(rb.pop("dws"))
            dx = rb.pop("dxyz")
            r["dxyz"] = dx if "dxyz" not in r else r["dxyz"] + dx
            r.update(rb)
        return r

    def leaves(r):
        got = _param_leaves(r["dws"], op)
        got.update(xyz=r["dxyz"].numpy(), t=r["dt"].numpy())
        if static_branch:
            got["dir"] = r["ddir"].numpy()
        return got

    got = leaves(plain_bwd())
    assert np.array_equal(got["xyz"], tin[0].grad.numpy())
    _hold_or_explain(plain_bwd, leaves, want, f"B4 {variant} at 17 freqs")


def _wrapper_calls(n_emb, n_tau, static_only=False, plain=False):
    """{name: thunk} calling each CUDA wrapper on CPU tensors of the given
    widths: each must pass its width checks and stop at its device
    check; with `plain`, also "B5 plain": the dispatching function, which
    runs B5's plain version on them."""
    n = 2
    tp = tn.init_nerf_params(torch.Generator().manual_seed(0), "fine",
                             in_channels_xyz=3 + 6 * n_emb,
                             encode_transient=True,
                             in_channels_t=max(n_tau, 1), output_flow=True,
                             device="cpu")
    T = torch.from_numpy
    o, d, zs, dirs, t = (T(v) for v in rays(n, max(n_tau, 1)))
    t = t[:, :n_tau].contiguous()
    xyz = (o[:, None] + d[:, None] * zs[..., None]).contiguous()
    encode_t = not static_only
    te = t if encode_t else None
    calls = {}
    b5 = tmk.make_fused_nerf_eval(
        S, use_viewdir=True, encode_a=False, encode_t=encode_t,
        output_flow=("fw", "bw") if encode_t else (), n_emb_xyz=n_emb,
        n_tau=n_tau)
    calls["B5"] = lambda: tmk.fused_nerf_eval_cuda(
        b5.pack(tp), xyz, dirs, None, te, **b5.kernel_kw)
    if plain:
        calls["B5 plain"] = lambda: b5(tp, xyz, dirs, None, te)
    if 3 + 6 * n_emb + (n_tau if encode_t else 0) > trk.SEG:
        return calls
    b1 = trk.make_planar_nerf_eval_comp(S, use_viewdir=True,
                                        encode_t=encode_t, n_emb_xyz=n_emb,
                                        n_tau=n_tau)
    calls["B1"] = lambda: trk.planar_eval_comp_cuda(
        b1.pack(tp), o, d, zs, None, dirs, None, te, **b1.kernel_kw)
    if static_only:
        return calls
    b2 = trk.make_planar_nerf_train(S, use_viewdir=True,
                                    output_flow=("fw", "bw"),
                                    n_emb_xyz=n_emb, n_tau=n_tau)
    kk = b2.kernel_kw
    bkw = {k: kk[k] for k in ("freqs", "use_viewdir", "encode_a",
                              "flow_scale")}
    calls["B2 forward"] = lambda: trk.planar_nerf_train_fwd_cuda(
        b2.pack(tp), o, d, zs, None, dirs, None, t, **kk)
    calls["B2 backward"] = lambda: trk.planar_nerf_train_bwd_cuda(
        "transient", b2.pack(tp), o, d, zs, None, dirs, None, t, {}, **bkw)
    b4 = tmt.make_fused_nerf_train(S, use_viewdir=True, encode_a=False,
                                   encode_t=True, output_flow=("fw", "bw"),
                                   n_emb_xyz=n_emb, n_tau=n_tau)
    calls["B4"] = lambda: tmt.fused_nerf_train_bwd_cuda(
        "transient", b4.pack(tp), xyz, None, None, t,
        torch.zeros((n, S, 16)), need_dxyz=True,
        **{k: b4.kernel_kw[k] for k in ("freqs", "use_viewdir", "encode_a",
                                        "output_flow", "flow_scale")})
    return calls


@pytest.mark.parametrize("n_emb", [17, 18, 19, 20])
def test_every_wrapper_takes_up_to_20_frequencies(n_emb):
    """17-20 frequencies with the time latent filling the segment up:
    every wrapper (B1, B2's forward and backward, B4, B5) passes its width
    checks and stops at the device check only."""
    n_tau = trk.SEG - (3 + 6 * n_emb)
    calls = _wrapper_calls(n_emb, n_tau)
    assert set(calls) == {"B1", "B2 forward", "B2 backward", "B4", "B5"}
    for name, call in calls.items():
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call()


@pytest.mark.parametrize("n_emb,n_tau,static_only", [
    (10, 200, False), (43, 48, True), (43, 200, False), (43, 700, False)])
def test_packed_evaluator_wrapper_takes_two_segments(n_emb, n_tau,
                                                     static_only):
    """B5 past two segments (3, 4 and 8 input segments here, 43
    frequencies, with and without the time latent): its builder takes the
    widths, its wrapper passes its width checks and stops at the device
    check, and its plain version runs them."""
    calls = _wrapper_calls(n_emb, n_tau, static_only, plain=True)
    lanes = 3 + 6 * n_emb + (0 if static_only else n_tau)
    assert trk.input_segs(lanes) == {261: 3, 263: 3, 461: 4, 961: 8}[lanes]
    out = calls.pop("B5 plain")()
    assert out.shape == (2, S, 16) and bool(torch.isfinite(out).all())
    assert set(calls) == {"B5"}
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        calls["B5"]()


def test_one_frequency_bound_feeds_both_sides():
    """The one-segment kernels' wrappers (B1, B2, B4) size their frequency
    arrays by MAX_FREQS, the most frequencies one segment holds, and the
    build hands the same number to the kernels as MAXF; one frequency
    more is past one segment, which their builders refuse. B5 reads its
    frequencies, any count, from a device table, and no MAXF."""
    assert trk.MAX_FREQS == 20 == (trk.SEG - 3) // 6
    assert f"-DNSFF_MAX_FREQS={trk.MAX_FREQS}" in cuda_build.NVCC_FLAGS
    header = (Path(cuda_build.CSRC_DIR) / "planar_tower.cuh").read_text()
    assert "constexpr int MAXF = NSFF_MAX_FREQS;" in header
    assert "MAXF = 16" not in header
    kw = dict(use_viewdir=True, output_flow=("fw", "bw"),
              n_emb_xyz=trk.MAX_FREQS + 1, n_tau=0)
    for build in (lambda: trk.make_planar_nerf_train(S, **kw),
                  lambda: trk.make_planar_nerf_eval_comp(S, **kw),
                  lambda: tmt.make_fused_nerf_train(S, encode_a=False,
                                                    encode_t=True, **kw)):
        with pytest.raises(ValueError, match="one 128-lane segment"):
            build()
    b5 = (Path(cuda_build.CSRC_DIR) / "fused_nerf_eval.cu").read_text()
    assert "MAXF" not in b5 and not hasattr(tmk, "MAX_FREQS")


# ----------------------------------------- the widths that JAX refuses too

@pytest.mark.parametrize("width", sorted(WIDE))
def test_backward_and_planar_kernels_refuse_past_one_segment(width):
    """Past one segment the JAX `make_fused_nerf_train` traces its forward
    (B5's) and its gradient raises, and its planar train kernel raises
    (traced with `jax.eval_shape`: the errors are the tracer's); the port's
    B4 and planar builders and wrappers raise there too, with the way
    round in the message."""
    n_emb, n_tau = WIDE[width][:2]
    jp = jax_params(n_emb, n_tau)
    xyz, dirs, t = points(2, n_tau)
    J = jnp.asarray
    jfn = jmt.make_fused_nerf_train(
        S, block_rows=8 * S, bwd_block_rows=8 * S, use_viewdir=True,
        encode_a=False, encode_t=True, output_flow=("fw", "bw"),
        n_emb_xyz=n_emb, n_tau=n_tau)
    assert jax.eval_shape(lambda p: jfn(p, J(xyz), J(dirs), None, J(t)),
                          jp).shape == (2, S, 16)
    with pytest.raises(JAX_REFUSES):
        jax.eval_shape(jax.grad(
            lambda p: jfn(p, J(xyz), J(dirs), None, J(t)).sum()), jp)
    o, d, zs, dirs2, t2 = rays(2, n_tau)
    jop = jrk.make_planar_nerf_train(
        S, block_rows=32, bwd_block_rows=32, use_viewdir=True,
        output_flow=("fw", "bw"), n_emb_xyz=n_emb, n_tau=n_tau)
    with pytest.raises(JAX_REFUSES):
        jax.eval_shape(lambda p: jop(p, J(o), J(d), J(zs), None, J(dirs2),
                                     None, J(t2)), jp)

    kw = dict(use_viewdir=True, output_flow=("fw", "bw"), n_emb_xyz=n_emb,
              n_tau=n_tau)
    for build in (
            lambda: tmt.make_fused_nerf_train(S, encode_a=False,
                                              encode_t=True, **kw),
            lambda: trk.make_planar_nerf_train(S, **kw),
            lambda: trk.make_planar_nerf_eval_comp(S, **kw)):
        with pytest.raises(ValueError, match="one 128-lane segment.*"
                                             "train_backend='xla'"):
            build()
    # the wrappers, on weights packed for the evaluator (two segments)
    b5 = tmk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                  encode_t=True, output_flow=("fw", "bw"),
                                  n_emb_xyz=n_emb, n_tau=n_tau)
    tp = port_params(n_emb, n_tau)
    pw = b5.pack(tp)
    T = torch.from_numpy
    freqs = b5.kernel_kw["freqs"]
    bkw = dict(freqs=freqs, use_viewdir=False, encode_a=False,
               flow_scale=0.2)
    for name, call in {
            "B4": lambda: tmt.fused_nerf_train_bwd(
                "transient", pw, T(xyz), None, None, T(t),
                torch.zeros((2, S, 16)), output_flow=("fw", "bw"),
                need_dxyz=True, **bkw),
            "B4 CUDA": lambda: tmt.fused_nerf_train_bwd_cuda(
                "transient", pw, T(xyz), None, None, T(t),
                torch.zeros((2, S, 16)), output_flow=("fw", "bw"),
                need_dxyz=True, **bkw),
            "B2 forward": lambda: trk.planar_nerf_train_fwd_cuda(
                pw, T(o), T(d), T(zs), None, None, None, T(t2),
                freqs=freqs, static_branch=False, use_viewdir=False,
                encode_a=False, encode_t=True, output_flow=(),
                flow_scale=0.2),
            "B2 backward": lambda: trk.planar_nerf_train_bwd_cuda(
                "transient", pw, T(o), T(d), T(zs), None, None, None,
                T(t2), {}, **bkw),
            "B1": lambda: trk.planar_eval_comp_cuda(
                pw, T(o), T(d), T(zs), None, None, None, T(t2),
                freqs=freqs, encode_t=True, flow_maps=False,
                use_viewdir=False, encode_a=False, z_far=0.95,
                flow_scale=0.2, n_tau=n_tau, n_map=16)}.items():
        with pytest.raises(ValueError, match="one 128-lane segment"):
            call()


# ------------------------------------------------------- the slice's paths

def _render_params(n_tau, frames=4):
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    return {"nerf_fine": jn.init_nerf_params(
                ks[0], "fine", use_viewdir=True, in_channels_t=n_tau,
                encode_transient=True, output_flow=True),
            "embedding_t": jn.init_embedding(ks[1], frames, n_tau)}


def test_test_time_render_at_n_tau_80_matches_jax():
    """`render_rays` at test time on the kernel backend with
    planar_eval='off' (the serving and eval path's packed route: here B5's
    plain version at two segments) against the JAX renderer on its
    interpreted kernel, key for key."""
    _check_test_time_render(80)


def test_test_time_render_at_n_tau_200_matches_jax():
    """`test_test_time_render_at_n_tau_80_matches_jax` at N_tau 200 (263
    lanes, three input segments)."""
    _check_test_time_render(200)


def _check_test_time_render(n_tau):
    frames, n = 4, 12
    cfg = dict(N_samples=S, N_importance=0, perturb=1.0, noise_std=1.0,
               use_viewdir=True, encode_t=True, N_tau=n_tau,
               max_t=frames - 1, compute_dtype="bfloat16",
               mlp_backend="pallas", train_backend="pallas",
               planar_eval="off", fused_train="off")
    rng = np.random.RandomState(0)
    rays_np = np.zeros((n, 6), np.float32)
    rays_np[:, 0:2] = rng.rand(n, 2) * 2 - 1
    rays_np[:, 2] = -1.0 + 0.1 * rng.rand(n)
    rays_np[:, 3:5] = (rng.rand(n, 2) - 0.5) * 0.4
    rays_np[:, 5] = 1.0 - rays_np[:, 2]
    ts = rng.randint(0, frames, n).astype(np.int32)
    jp = _render_params(n_tau, frames)
    kw = dict(test_time=True, output_transient=True,
              output_transient_flow=("fw", "bw"))
    jout = jax.jit(lambda p, r, t: j_render_rays(
        {"fine": p["nerf_fine"]}, {"t": p["embedding_t"]}, r, t,
        jax.random.PRNGKey(7), JRenderConfig(**cfg), **kw))(
        jp, jnp.asarray(rays_np), jnp.asarray(ts))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        tout = render_rays({"fine": tp["nerf_fine"]},
                           {"t": tp["embedding_t"]},
                           torch.from_numpy(rays_np),
                           torch.from_numpy(ts).long(), RenderConfig(**cfg),
                           **kw)
    assert set(tout) == set(jout) and "transient_flow_fw" in tout
    off = total = 0
    for k, want in jout.items():
        got, want = tout[k].numpy(), np.asarray(want)
        assert got.shape == want.shape, k
        err = np.abs(got - want)
        assert err.max() <= KERNEL_TOL, (k, err.max())
        off += int((err > KERNEL_EXACT).sum())
        total += err.size
    assert off <= KERNEL_SHARE * total, off / total


def test_export_op_takes_two_segments(tmp_path):
    """The custom op `nsff_torch::fused_nerf_eval` and its fake take the
    two-segment packing: `torch.library.opcheck`, and
    `tools/export_render.py`'s program on the packed route at N_tau 80
    exported with B5 in its graph, reloaded equal to the live render."""
    _check_export_op(tmp_path, 80)


def test_export_op_takes_three_segments(tmp_path):
    """`test_export_op_takes_two_segments` at N_tau 200 (three input
    segments)."""
    _check_export_op(tmp_path, 200)


def _check_export_op(tmp_path, n_tau):
    frames, n = 4, 16
    tp = params_from_jax(jax.tree.map(np.asarray, _render_params(n_tau)),
                         "cpu")
    fn = tmk.make_fused_nerf_eval(S, use_viewdir=True, encode_a=False,
                                  encode_t=True, output_flow=("fw",),
                                  n_tau=n_tau)
    pw = fn.pack(tp["nerf_fine"])
    assert trk.packed_in_rows(pw) == trk.input_segs(63 + n_tau) * trk.SEG
    xyz, dirs, t = (torch.from_numpy(v) for v in points(3, n_tau))
    w, b, slots = library.slot_lists(pw)
    kk = fn.kernel_kw
    kw = dict(freqs=list(kk["freqs"]), static_branch=True, use_viewdir=True,
              encode_a=False, encode_t=True, flow_fw=True, flow_bw=False,
              flow_scale=kk["flow_scale"], D=8, skips=list(kk["skips"]))
    args = (w, b, slots, xyz, dirs, None, t)
    torch.library.opcheck(library.fused_nerf_eval, args, kw)
    assert torch.equal(library.fused_nerf_eval(*args, **kw),
                       tmk.fused_nerf_eval_ref(pw, xyz, dirs, None, t, **kk))

    rcfg = RenderConfig(N_samples=S, use_viewdir=True, encode_t=True,
                        max_t=frames - 1, N_tau=n_tau, img_wh=(16, 12),
                        compute_dtype="bfloat16", mlp_backend="pallas",
                        fused_train="off", planar_eval="off")
    prog = ter.RenderProgram(rcfg, tp, True, ter.pack_fine(rcfg, tp, True))
    rng = np.random.RandomState(0)
    rays_np = np.zeros((n, 6), np.float32)
    rays_np[:, 0:2] = rng.rand(n, 2) * 2 - 1
    rays_np[:, 2] = -1.0
    rays_np[:, 3:5] = (rng.rand(n, 2) - 0.5) * 0.4
    rays_np[:, 5] = 2.0
    example = (torch.from_numpy(rays_np),
               torch.from_numpy(rng.randint(0, frames, n)).long())
    with torch.no_grad():
        exported = torch.export.export(prog, example)
        path = str(tmp_path / "wide.pt2")
        torch.export.save(exported, path)
        loaded = torch.export.load(path)
        assert {str(nd.target) for nd in loaded.graph.nodes
                if str(nd.target).startswith(library.NAMESPACE)} == {
            "nsff_torch.fused_nerf_eval.default"}
        got = loaded.module()(*example)
        want = prog(*example)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
