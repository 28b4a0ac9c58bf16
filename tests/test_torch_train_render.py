"""The port's training render and loss against the JAX package on the
CPU: `render_train_planar` + `compute_losses_planar` + `total_loss` and
their gradients from the same weights, batch and random draws (the JAX
key splits rebuilt in tests/torch_train_helpers.py). The JAX side runs
its Pallas kernels in interpret mode with `planar_compositing='on'`, as
`tests/test_planar_path.py` does. Tolerances (loss terms 1e-3 relative,
gradients 5e-2 Frobenius and 0.1 of each leaf's largest) and their
reasons: tests/test_torch_train_step.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.models.raymarch import render_train_planar as j_render
from nsff_pl_tpu.models.rendering import RenderConfig as JRenderConfig
from nsff_pl_tpu.training import loss as jloss
from nsff_pl_tpu_torch.models.raymarch import render_train_planar
from nsff_pl_tpu_torch.models.rendering import RenderConfig
from nsff_pl_tpu_torch.training import loss as tloss
from nsff_pl_tpu_torch.training import optim as toptim
from tests.torch_train_helpers import (COMMON, FRAMES, LOSS_RTOL, N,
                                       make_batch, cams, jax_draws, grads_close,
                                       jax_params, to_torch)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's render is thousands of small ops; with the test workers'
    threads already on every core, torch's own pool only waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["flagship", "corners"])
def test_render_loss_and_grads_match_jax(case):
    """`corners`: perturb=0, noise_std=0, no viewdir, thickness 3, epoch
    11 (lambda_geo decayed, cross-entropy ramp done). Its gradients leave
    out the depth loss: with every ray sampled at the same depths the
    rendered depths lie within rounding of each other, and the median
    then picks another middle ray on each side (the term's value agrees;
    its gradient goes to another ray)."""
    rkw, lkw, epoch = dict(COMMON), dict(max_t=FRAMES - 1), 2
    if case == "corners":
        rkw.update(perturb=0.0, noise_std=0.0, use_viewdir=False)
        lkw.update(thickness=3)
        epoch = 11
    jcfg, tcfg = JRenderConfig(**rkw), RenderConfig(**rkw)
    jl, tl = jloss.LossConfig(**lkw), tloss.LossConfig(**lkw)
    b = make_batch()
    Ks, Ps = cams()
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss_fn(p):
        res = j_render(p["nerf_fine"], {"t": p["embedding_t"]}, jb["rays"],
                       jb["ts"], key, jcfg)
        ld = jloss.compute_losses_planar(res, jb, jl, epoch=epoch,
                                         Ks=jnp.asarray(Ks), Ps=jnp.asarray(Ps))
        return jloss.total_loss(ld) - skip * ld["disp_l"], ld

    skip = 1.0 if case == "corners" else 0.0
    jparams = jax_params()
    # under one jit: an eager call runs the interpreted kernels op by op
    (_, jld), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams)

    params = to_torch(jparams)
    for leaf in toptim.param_leaves(params):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["ts"] = tb["ts"].long()
    tb["cam_ids"] = tb["cam_ids"].long()
    res = render_train_planar(params["nerf_fine"], {"t": params["embedding_t"]},
                              tb["rays"], tb["ts"], tcfg, draws=jax_draws(key, N))
    ld = tloss.compute_losses_planar(res, tb, tl, epoch=epoch,
                                     Ks=torch.from_numpy(Ks),
                                     Ps=torch.from_numpy(Ps))
    (tloss.total_loss(ld) - skip * ld["disp_l"]).backward()

    assert set(ld) == set(jld) and len(ld) == 11
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]),
                                   rtol=LOSS_RTOL, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(tloss.total_loss(ld)),
                               float(jloss.total_loss(jld)), rtol=LOSS_RTOL)
    grads_close(jax.tree.map(
        lambda t: (t.grad if t.grad is not None else torch.zeros_like(t))
        .numpy(), params, is_leaf=lambda x: isinstance(x, torch.Tensor)), jg)
