"""The port's tools (`nsff_pl_tpu_torch/tools/`) on the CPU.

- `save_weights_only`: trainer checkpoints written with each optimizer
  (adam, sgd, radam, ranger; one epoch of the synthetic scene of
  tests/test_torch_trainer.py) and a reference Lightning `.ckpt`
  (`tests/test_golden_cross.py::make_torch_ckpt`) become params-only
  checkpoints that the eval CLI's `load_params` and `checkpoint.load`
  (the render server's loader) read with the same bits as the full one;
  the CLI prints the parameter count.
- `profile_step.main` at batch 8 on both train paths (auto: the planar
  path; off: the packed one) with 1 timed and 1 traced step: a finite
  loss, a time per step and a trace file holding the step's ops.
Torch runs on one thread.
"""
import glob
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nsff_pl_tpu_torch.apps.evaluate import load_params
from nsff_pl_tpu_torch.config import NSFFConfig
from nsff_pl_tpu_torch.tools import profile_step, save_weights_only
from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
from nsff_pl_tpu_torch.training.optim import param_leaves
from nsff_pl_tpu_torch.training.trainer import NSFFSystem
from tests.helpers_scene import make_synthetic_scene

W, H, N = 32, 24, 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    return make_synthetic_scene(root, W=W, H=H, N=N, learnable=True)


def _same(a, b):
    la, lb = param_leaves(a), param_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _strip(ckpt, out, cfg, capsys):
    n = save_weights_only.main(["--ckpt_path", ckpt, "--out", out])
    assert f"({n:,} params)" in capsys.readouterr().out
    tree = ckpt_lib.restore_checkpoint(out)
    assert set(tree) == {"params"}
    assert n == sum(p.numel() for p in param_leaves(tree["params"]))
    full = load_params(SimpleNamespace(ckpt_path=ckpt), cfg, "cpu")
    stripped = load_params(SimpleNamespace(ckpt_path=out), cfg, "cpu")
    assert _same(full, stripped)
    assert _same(stripped, ckpt_lib.load(out, "cpu"))
    return full


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "radam", "ranger"])
def test_save_weights_only_trainer_checkpoint(scene, tmp_path, optimizer,
                                              capsys):
    cfg = NSFFConfig(root_dir=scene, img_wh=(W, H), start_end=(0, N),
                     encode_t=True, use_viewdir=True, N_samples=16,
                     batch_size=32, num_epochs=1, optimizer=optimizer,
                     hard_sampling=True, log_dir=str(tmp_path / "logs"),
                     ckpt_dir=str(tmp_path / "ckpts"), exp_name="x")
    system = NSFFSystem(cfg, device="cpu")
    system.fit(progress=False)
    ckpt = ckpt_lib.latest_checkpoint(str(tmp_path / "ckpts" / "x"))
    full_tree = ckpt_lib.restore_checkpoint(ckpt)
    assert {"opt_state", "tmp_rgb"} <= set(full_tree)
    out = str(tmp_path / "weights")
    full = _strip(ckpt, out, cfg, capsys)
    assert _same(full, system.state.params)
    # the file itself, not only its directory, and the full checkpoint
    # through the server's loader
    assert _same(ckpt_lib.load(os.path.join(ckpt, ckpt_lib.STATE_FILE),
                               "cpu"), full)
    assert os.path.getsize(os.path.join(out, ckpt_lib.STATE_FILE)) < \
        os.path.getsize(os.path.join(ckpt, ckpt_lib.STATE_FILE))


def test_save_weights_only_reference_ckpt(tmp_path, capsys):
    from tests.test_golden_cross import N_FRAMES, N_TAU, make_torch_ckpt

    path = str(tmp_path / "ref.ckpt")
    make_torch_ckpt(path, np.random.RandomState(0))
    cfg = NSFFConfig(encode_t=True, use_viewdir=True, N_tau=N_TAU,
                     start_end=(0, N_FRAMES))
    full = _strip(path, str(tmp_path / "weights"), cfg, capsys)
    assert _same(full, ckpt_lib.import_pl_checkpoint(path))


@pytest.mark.parametrize("fused_train", ["auto", "off"])
def test_profile_step_on_cpu(tmp_path, fused_train, capsys):
    out = str(tmp_path / "trace")
    res = profile_step.main([fused_train, out, "8", "--device", "cpu"],
                            timed_steps=1, traced_steps=1)
    printed = capsys.readouterr().out
    assert "ms/step" in printed and f"trace -> {out}" in printed
    assert math.isfinite(res["loss"]) and res["ms_per_step"] > 0
    files = glob.glob(f"{out}/*.pt.trace.json")
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
