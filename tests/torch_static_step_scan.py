"""Where the gradients of the static-only packed train step part between
the port and the JAX package, shown event by event. Shared by
tests/test_torch_packed_step.py; as a script it scans first-step keys:

    JAX_PLATFORMS=cpu python -m tests.torch_static_step_scan [--two-steps] \
        [key ...]

For each key (PRNGKey(key), frame 1, initial weights; with `--two-steps`
the weights after two JAX steps on key, key + 1 and then key + 2 on frame
3, as the three-step test runs them) it prints the worst gradient error
of the whole loss and of each term, both sides' two median rays of the
depth term, and the kernel-level analysis of `toggle_analysis`.

Two events explain every difference found (keys 21..103, batch 24, S=16):

- a ReLU mask toggle. The port's plain backward and the JAX kernel's,
  given the same points, directions and cotangent, agree bit for bit in
  the point cotangent of every sample but a few (7 of 384 on key 31).
  Each of those has one unit, in one layer, whose pre-activation lies
  within 2e-4 of zero (on other keys a sample now and then has its unit
  in the view-direction layer, which this search leaves out): the two
  sides round an input of that product to bf16 differently, the sign
  differs, and the unit's cotangent passes on one side only. Toggling
  that one mask bit in the port makes the sample's point cotangent
  bit-equal again, and with all toggles the weight gradients agree to
  4e-3 of each leaf's largest entry (from 0.26).
- a tie at the batch median of the depth term. Where the two middle
  depths of the batch lie within an ulp of a third (key 103 after two
  steps: 3e-7), the sides sort them differently and the median's share of
  the cotangent (8.3 of a largest 10.1 there) goes to another ray; half
  the gradient differs (0.62 in Frobenius norm, 0.74 of a leaf's largest
  entry). The port's loss on the JAX side's depths gives the JAX
  cotangent to 1e-6.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nsff_pl_tpu import config as jconfig
from nsff_pl_tpu.models import nerf as jn
from nsff_pl_tpu.models.rendering import render_rays as j_render_rays
from nsff_pl_tpu.ops import mlp_train_kernel as jmt
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu.training import optim as joptim
from nsff_pl_tpu.training import step as jstep
from nsff_pl_tpu.training.trainer import render_config as j_render_config
from nsff_pl_tpu_torch import config as tconfig
from nsff_pl_tpu_torch.data.pipeline import _sample_batch
from nsff_pl_tpu_torch.models.rendering import render_rays
from nsff_pl_tpu_torch.ops import mlp_train_kernel as tmt
from nsff_pl_tpu_torch.ops import raymarch_kernel as trk
from nsff_pl_tpu_torch.training import loss as tloss
from tests.test_torch_train_step import _step_inputs, _table
from tests.torch_train_helpers import FRAMES, NTAU, S, cams, to_torch

B = 24
CFG_KW = dict(img_wh=(16, 16), start_end=(0, FRAMES), use_viewdir=True,
              encode_t=False, N_samples=S, N_tau=NTAU, optimizer="adam",
              lr=1e-3, lr_scheduler="cosine", num_epochs=2, batch_size=B,
              dtype="bfloat16", fused_train="off", train_backend="pallas")
KERNEL_KW = dict(use_viewdir=True, encode_a=False, encode_t=False,
                 output_flow=(), n_tau=NTAU, static_branch=True,
                 need_dxyz=True)
ROW_TOL = 2e-4  # a sample's point cotangent differs: share of the largest
NEAR_ZERO = 1e-3  # |pre-activation| of a unit whose mask may toggle


def static_jax_params():
    return {"nerf_fine": jn.init_nerf_params(
        jax.random.PRNGKey(0), "fine", use_viewdir=True,
        encode_transient=False)}


def jax_side(jp, key, t, term="all"):
    """(gradients, results, batch) of one loss term of the JAX step."""
    table = _table()
    k_sample, k_render = jax.random.split(key)
    batch = jstep._sample_batch(
        jnp.asarray(table), jnp.ones(table.shape[:2]), k_sample, t, B, False)
    rc = j_render_config(jconfig.NSFFConfig(**CFG_KW))

    def f(p):
        res = j_render_rays({"fine": p["nerf_fine"]}, {}, batch["rays"],
                            None, k_render, rc, test_time=False,
                            output_transient=False, output_transient_flow=())
        ld = jloss.compute_losses(res, batch, jloss.LossConfig(
            max_t=FRAMES - 1), epoch=0, output_transient_flow=(), Ks=None,
            Ps=None)
        return (jloss.total_loss(ld) if term == "all" else ld[term]), res

    (_, res), g = jax.value_and_grad(f, has_aux=True)(jp)
    return (jax.tree.map(np.asarray, g),
            {k: np.asarray(v) for k, v in res.items()}, batch)


def port_side(jp, key, t, term="all"):
    """(gradients, results, captured) of the port's step; `captured` has
    the evaluator's points, direction embedding and the cotangent of its
    packed output."""
    table = _table()
    idx, draws = _step_inputs(key, table, B)
    batch = _sample_batch(torch.from_numpy(table),
                          torch.ones(table.shape[:2]), t, B, False, idx=idx)
    p = to_torch(jp)
    for leaf in jax.tree.leaves(p):
        leaf.requires_grad_(True)
    cap = {}
    make = tmt.make_fused_nerf_train

    def spy(*a, **kw):
        op = make(*a, **kw)

        def fn(params, xyz, d, a_emb, t_emb, pw=None):
            out = op(params, xyz, d, a_emb, t_emb, pw=pw)
            out.retain_grad()
            cap.update(xyz=xyz.detach(), dir=d.detach(), out=out)
            return out

        fn.pack = op.pack
        return fn

    tmt.make_fused_nerf_train = spy
    try:
        res = render_rays(
            {"fine": p["nerf_fine"]}, {}, batch["rays"], None,
            tconfig.render_config(tconfig.NSFFConfig(**CFG_KW)),
            test_time=False, output_transient=False,
            output_transient_flow=(), draws=draws)
    finally:
        tmt.make_fused_nerf_train = make
    ld = tloss.compute_losses(res, batch, tloss.LossConfig(max_t=FRAMES - 1),
                              epoch=0, output_transient_flow=(), Ks=None,
                              Ps=None)
    (tloss.total_loss(ld) if term == "all" else ld[term]).backward()
    grads = {"nerf_fine": {k: {q: v.grad.numpy() for q, v in layer.items()}
                           for k, layer in p["nerf_fine"].items()}}
    cap["g"] = cap.pop("out").grad.clone()
    return grads, {k: v.detach().numpy() for k, v in res.items()}, cap


def worst_errs(got, want):
    """(error / leaf's largest, its leaf, Frobenius ratio, its leaf), the
    worst over the leaves of two like trees."""
    out = (0.0, None, 0.0, None)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        e = np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)
        fro = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        if e > out[0]:
            out = (float(e), name) + out[2:]
        if fro > out[2]:
            out = out[:2] + (float(fro), name)
    return out


def median_rays(depth):
    order = np.argsort(depth)
    n = len(depth)
    return int(order[(n - 1) // 2]), int(order[n // 2])


def _tower_pre_activations(pw, pe):
    """The static tower's pre-activations [z_0 .. z_7] on the encoding
    rows, as `raymarch_kernel._tower_ref` forms them."""
    inp = h = trk._bf16(pe)
    zs = []
    for i in range(8):
        w, b = pw[f"static_xyz_{i}"]["w"], pw[f"static_xyz_{i}"]["b"]
        if i == 4:
            z = (trk._mm(inp, w[:trk.SEG])
                 + trk._mm(h, w[trk.SEG:trk.SEG + trk.WIDTH]) + b)
        else:
            z = trk._mm(h, w, b)
        zs.append(z)
        h = trk._bf16(torch.relu(z))
    return zs


@torch.no_grad()
def toggle_analysis(jp, xyz, dirs, g):
    """The port's plain backward of the static branch against the JAX
    kernel's on the same points, directions and cotangent. Finds the
    samples whose point cotangent differs by more than ROW_TOL of the
    largest and, for each, the one tower unit with a pre-activation under
    NEAR_ZERO whose mask toggle makes the sample agree; then compares all
    gradients with those toggles applied.

    Returns {"rows": [(row, error, (layer, unit, |z|) or None)],
    "before": worst_errs, "after": worst_errs, "left": rows still off}."""
    jfn = jmt.make_fused_nerf_train(S, **KERNEL_KW)

    @jax.jit  # an eager call runs the interpreted kernel op by op
    def jvjp(p, x, dr, cot):
        return jax.vjp(jfn, p, x, dr, None, None)[1](cot)

    jg = jvjp(jp["nerf_fine"], jnp.asarray(xyz.numpy()),
              jnp.asarray(dirs.numpy()), jnp.asarray(g.numpy()))
    want = jax.tree.map(np.asarray, jg[0])
    jdx = np.asarray(jg[1]).reshape(-1, 3)
    scale = np.abs(jdx).max()

    op = tmt.make_fused_nerf_train(S, **KERNEL_KW)
    pw = op.pack(to_torch(jp)["nerf_fine"])
    bkw = {k: op.kernel_kw[k] for k in (
        "freqs", "use_viewdir", "encode_a", "output_flow", "flow_scale", "D",
        "skips")}
    names = trk.branch_weight_names(D=8, skips=(4,), use_viewdir=True,
                                    static_branch=True, encode_t=False)[0]
    tower = trk._tower_ref
    toggles = []  # (layer, row, unit)

    def toggled_tower(*a, **kw):
        acts = tower(*a, **kw)
        for layer, row, unit in toggles:
            h = acts[layer + 1]
            # the mask is h > 0; the value itself is next to zero
            h[row, unit] = 0.0 if h[row, unit] > 0 else 1e-30
        return acts

    def run():
        trk._tower_ref = toggled_tower
        try:
            r = tmt.fused_nerf_train_bwd_ref("static", pw, xyz, dirs, None,
                                             None, g, need_dxyz=True, **bkw)
        finally:
            trk._tower_ref = tower
        un = trk.unpad_padded_grads(
            r["dws"], names, output_flow=(), skips=(4,), xyz_w=63, n_tau=0,
            dir_w=dirs.shape[1], n_a=0, encode_a=False)
        grads = {k: {q: v.numpy() for q, v in un[k].items()} for k in want}
        row_err = np.abs(r["dxyz"].numpy().reshape(-1, 3) - jdx).max(-1)
        return grads, row_err / scale

    grads, row_err = run()
    before = worst_errs(grads, want)
    zs = _tower_pre_activations(pw, tmt.posenc_rows_xyz(xyz, bkw["freqs"])[1])
    rows, found = [], []
    for row in np.nonzero(row_err > ROW_TOL)[0]:
        cands = sorted((float(z[row, u].abs()), layer, int(u))
                       for layer, z in enumerate(zs)
                       for u in z[row].abs().argsort()[:4])
        hit = None
        for az, layer, unit in cands:
            if az >= NEAR_ZERO:
                break
            toggles[:] = [(layer, int(row), unit)]
            if run()[1][row] < ROW_TOL * 0.05:
                hit = (layer, unit, az)
                found.append((layer, int(row), unit))
                break
        rows.append((int(row), float(row_err[row]), hit))
    toggles[:] = found
    grads, row_err = run()
    return {"rows": rows, "before": before, "after": worst_errs(grads, want),
            "left": [int(r) for r in np.nonzero(row_err > ROW_TOL)[0]]}


def depth_cotangents(jres, tres, batch):
    """d mean(depth term) / d depth: (JAX on its depths, the port on the
    JAX depths, the port on its own depths)."""
    disp = np.asarray(batch["disps"])

    def port(depth):
        d = torch.from_numpy(depth.copy()).requires_grad_(True)
        tloss.shiftscale_invariant_depthloss(
            d, torch.from_numpy(disp)).mean().backward()
        return d.grad.numpy()

    jcot = np.asarray(jax.grad(
        lambda d: jloss.shiftscale_invariant_depthloss(
            d, jnp.asarray(disp)).mean())(jnp.asarray(jres["depth_fine"])))
    return jcot, port(jres["depth_fine"]), port(tres["depth_fine"])


def _after_two_steps(jp, k0):
    jcfg = jconfig.NSFFConfig(**CFG_KW)
    tx = joptim.make_optimizer(jcfg, 10)
    train = jstep.make_train_step(
        j_render_config(jcfg), jloss.LossConfig(max_t=FRAMES - 1), tx,
        donate=False, output_transient=False, output_transient_flow=(),
        steps_per_epoch=10, batch_size=B)
    table = _table()
    Ks, Ps = cams()
    state = jstep.TrainState(jp, tx.init(jp), jnp.zeros((), jnp.int32))
    for i in range(2):
        state, _, _ = train(state, jnp.asarray(table),
                            jnp.ones(table.shape[:2]), jnp.asarray(Ks),
                            jnp.asarray(Ps), jax.random.PRNGKey(k0 + i),
                            jnp.asarray(1 + i))
    return state.params


def main(argv):
    two = "--two-steps" in argv
    keys = [int(a) for a in argv if a != "--two-steps"] or range(21, 102, 10)
    for k in keys:
        jp, t = static_jax_params(), 1
        if two:
            jp, k, t = _after_two_steps(jp, k), k + 2, 3
        key = jax.random.PRNGKey(k)
        line = []
        for term in ("all", "col_l", "disp_l"):
            jg, jres, batch = jax_side(jp, key, t, term)
            tg, tres, cap = port_side(jp, key, t, term)
            e = worst_errs(tg, jg)
            line.append(f"{term} {e[0]:.3f} {e[1]} (Frobenius {e[2]:.3f})")
        print(f"key {k} frame {t}: worst error / leaf's largest: "
              + " | ".join(line))
        jcot, on_jax, own = depth_cotangents(jres, tres, batch)
        print(f"   median rays: jax {median_rays(jres['depth_fine'])}, port "
              f"{median_rays(tres['depth_fine'])}; depth cotangent, port "
              f"loss on the JAX depths against JAX "
              f"{np.abs(on_jax - jcot).max():.1e}"
              f", on its own depths {np.abs(own - jcot).max():.3g} of a "
              f"largest {np.abs(jcot).max():.3g}")
        a = toggle_analysis(jp, cap["xyz"], cap["dir"], cap["g"])
        print(f"   same inputs through both backwards: {a['before'][0]:.4f} "
              f"{a['before'][1]} (Frobenius {a['before'][2]:.4f}); "
              f"{len(a['rows'])} of {B * S} samples differ")
        for row, err, hit in a["rows"]:
            print(f"   sample {row}: point cotangent off by {err:.2e}; "
                  + (f"layer {hit[0]} unit {hit[1]} has |z| = {hit[2]:.2e}, "
                     "its toggle makes the sample agree" if hit
                     else "no single tower unit explains it"))
        print(f"   with the toggles: {a['after'][0]:.2e} {a['after'][1]} "
              f"(Frobenius {a['after'][2]:.2e}), samples still off "
              f"{a['left']}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
