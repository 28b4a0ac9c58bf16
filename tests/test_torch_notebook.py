"""Drift guard for the port's notebook (`notebooks/test_torch.ipynb`), the
counterpart of `tests/test_notebook.py`: every code cell parses, the
import cell runs in a fresh interpreter without loading JAX, every
`out["..."]` key the cells read is one the port's `render_rays`
produces at test time (and, for the render cell's key filter, one the
card's composited route gives), and the render, panel and interpolation
cells run on the CPU on a 32x24 synthetic scene with seeded weights
(matplotlib's Agg backend; `device` and `chunk` set to the CPU's).
Tolerances: none (the cells' outputs are checked finite and shaped).
"""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_PATH = os.path.join(REPO, "notebooks", "test_torch.ipynb")


def _cells():
    with open(NB_PATH) as f:
        nb = json.load(f)
    return [("".join(c["source"]), c["cell_type"]) for c in nb["cells"]]


def _code():
    return [src for src, kind in _cells() if kind == "code"]


def test_notebook_cells_parse():
    code = _code()
    assert len(code) == 5
    for src in code:
        ast.parse(src)


def test_notebook_imports_execute_without_jax():
    src = next(s for s in _code() if "import" in s and "NSFFConfig" in s)
    check = ("\nbad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'nsff_pl_tpu')]\n"
             "assert not bad, bad\nprint('imported', device, chunk)\n")
    r = subprocess.run([sys.executable, "-c", src + check],
                       cwd=os.path.join(REPO, "notebooks"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "imported cuda 32768" in r.stdout


def _keys_used():
    keys = set()
    for src in _code():
        keys |= set(re.findall(r"out\[[\"']([a-z_]+)[\"']\]", src))
    return keys


def test_notebook_result_keys_exist():
    """Every out['...'] key the notebook reads is produced by the port's
    `render_rays` in test-time mode, and lies within the composited
    route's keys (the card renders the cell's filter through B1)."""
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.models.raymarch import comp_eval_keys
    from nsff_pl_tpu_torch.models.rendering import RenderConfig
    from nsff_pl_tpu_torch.training.step import make_render_fn

    used = _keys_used()
    assert used, "no result keys referenced?"
    cfg = NSFFConfig(encode_t=True, use_viewdir=True, N_samples=8, N_tau=8,
                     start_end=(0, 3), dtype="float32")
    params = build_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    render = make_render_fn(
        RenderConfig(N_samples=8, use_viewdir=True, encode_t=True, N_tau=8,
                     max_t=2, img_wh=(4, 4)),
        test_time=True, output_transient=True, output_transient_flow=(),
        with_visibility=False, device="cpu")
    rays = torch.cat([torch.zeros(4, 2), -torch.ones(4, 1),
                      torch.zeros(4, 2), 2 * torch.ones(4, 1)], -1)
    out = render(params, rays, torch.zeros(4, dtype=torch.long))
    missing = used - set(out)
    assert not missing, f"notebook references stale result keys: {missing}"
    assert used <= comp_eval_keys(True, ())


def _set(src, name, value):
    """Replace the assignment of `name` at the start of a line."""
    new, n = re.subn(rf"^{re.escape(name)}\s*=.*$", f"{name} = {value}", src,
                     count=1, flags=re.M)
    assert n == 1, name
    return new


def test_notebook_cells_run_on_cpu(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
    from tests.helpers_scene import make_synthetic_scene

    root = make_synthetic_scene(str(tmp_path / "scene"), W=32, H=24, N=5,
                                learnable=True)
    model = dict(N_samples=8, encode_t=True, use_viewdir=True,
                 dtype="float32")
    cfg = NSFFConfig(root_dir=root, img_wh=(32, 24), start_end=(0, 30),
                     **model)
    params = build_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu")
    ckpt = ckpt_lib.save_checkpoint(str(tmp_path / "ckpts"), 7,
                                    {"params": params})
    code = _code()
    monkeypatch.chdir(os.path.join(REPO, "notebooks"))
    monkeypatch.setattr(plt, "show", lambda: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ns = {}
    try:
        exec(code[0], ns)
        ns.update(device="cpu", chunk=256)
        src = _set(code[1], "ROOT_DIR", repr(root))
        src = _set(src, "CKPT", repr(ckpt))
        src = _set(src, "W, H", "32, 24")
        src = _set(src, "MODEL", repr(model))
        exec(src, ns)
        for k in ("w", "b"):  # the checkpoint's weights were loaded
            assert torch.equal(ns["params"]["nerf_fine"]["static_xyz_0"][k],
                               params["nerf_fine"]["static_xyz_0"][k])
        for src in code[2:]:
            exec(src, ns)
    finally:
        torch.set_num_threads(threads)
        plt.close("all")
    assert ns["out"]["rgb_fine"].shape == (32 * 24, 3)
    assert np.isfinite(ns["psnr"]) and np.isfinite(ns["ssim"])
    assert all(np.isfinite(np.asarray(im, np.float64)).all()
               for _, im in ns["panels"])
    assert ns["im"].shape == (24, 32, 3) and np.isfinite(ns["im"]).all()
    assert ns["dt"] > 0
