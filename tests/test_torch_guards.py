"""Boundaries of the PyTorch/CUDA port: it never imports JAX or the JAX
package, its entry points refuse to run without a GPU unless asked for
the CPU, and `chip_smoke.py` fails without a card or without the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "nsff_pl_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib") or top == "nsff_pl_tpu"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nsff_pl_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nsff_pl_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.strip()) >= 15  # every module was imported


def _entry_points():
    from nsff_pl_tpu_torch import resolve_device
    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.models import nerf
    from nsff_pl_tpu_torch.models.rendering import RenderConfig
    from nsff_pl_tpu_torch.data.pipeline import RayBatcher
    from nsff_pl_tpu_torch.models.rendering import RenderConfig as RC
    from nsff_pl_tpu_torch.training import checkpoint
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import make_render_fn, make_train_step

    g = torch.Generator().manual_seed(0)
    train_cfg = NSFFConfig(encode_t=True, use_viewdir=True, N_importance=4,
                           batch_size=4, lr_scheduler="cosine")
    return {
        "resolve_device": lambda: resolve_device(),
        "init_nerf_params": lambda: nerf.init_nerf_params(g),
        "init_embedding": lambda: nerf.init_embedding(g, 2, 4),
        "build_params": lambda: build_params(NSFFConfig(), g),
        "params_from_jax": lambda: checkpoint.params_from_jax({}),
        "load": lambda: checkpoint.load("unused.pt"),
        "to_device": lambda: checkpoint.to_device({}, "cuda"),
        "make_render_fn": lambda: make_render_fn(RenderConfig(),
                                                 output_transient=False),
        "RenderService": lambda: RenderService(
            {}, torch.eye(3).numpy(), torch.zeros(1, 3, 4).numpy(),
            (8, 6), NSFFConfig()),
        "build_params_train": lambda: build_params(train_cfg, g),
        "make_train_step": lambda: make_train_step(
            RC(encode_t=True, fused_train="on"), None,
            make_optimizer(train_cfg, 1), output_transient=True,
            output_transient_flow=("fw", "bw"), steps_per_epoch=1,
            batch_size=4),
        "RayBatcher": lambda: RayBatcher(torch.zeros(2, 4, 16).numpy(), 4),
        "opt_state_from_jax": lambda: checkpoint.opt_state_from_jax(
            {}, None, checkpoint.params_from_jax({"w": torch.zeros(1).numpy()})),
    }


@pytest.mark.parametrize("name", sorted(
    ["resolve_device", "init_nerf_params", "init_embedding", "build_params",
     "params_from_jax", "load", "to_device", "make_render_fn",
     "RenderService", "build_params_train", "make_train_step", "RayBatcher",
     "opt_state_from_jax"]))
def test_entry_points_need_a_gpu_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_points_run_on_cpu_when_asked():
    import numpy as np

    from nsff_pl_tpu_torch.config import NSFFConfig, build_params
    from nsff_pl_tpu_torch.data.pipeline import RayBatcher
    from nsff_pl_tpu_torch.models import nerf
    from nsff_pl_tpu_torch.models.rendering import RenderConfig
    from nsff_pl_tpu_torch.training import checkpoint
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import make_train_step

    p = nerf.init_nerf_params(torch.Generator().manual_seed(0), D=2,
                              skips=(), W=8, device="cpu")
    assert p["static_xyz_0"]["w"].device.type == "cpu"
    cfg = NSFFConfig(encode_t=True, use_viewdir=True, N_importance=4)
    params = build_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == {"nerf_fine", "nerf_coarse", "embedding_t"}
    assert "transient_flow_fw" not in params["nerf_coarse"]
    tx = make_optimizer(cfg, 1)
    step = make_train_step(RenderConfig(encode_t=True, fused_train="on"),
                           None, tx, output_transient=True,
                           output_transient_flow=("fw", "bw"),
                           steps_per_epoch=1, batch_size=4, device="cpu")
    assert step.device.type == "cpu"
    b = RayBatcher(np.zeros((2, 4, 16), np.float32), 4, device="cpu")
    assert b.table.device.type == "cpu"
    opt = tx.init(params)
    checkpoint.opt_state_from_jax(
        {"count": 0, "mu": checkpoint.params_to_numpy(params),
         "nu": checkpoint.params_to_numpy(params)}, opt, params)


def _smoke(cwd, env=None):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _smoke(REPO, env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_png_bytes_is_a_valid_png():
    import struct
    import zlib

    import numpy as np

    from nsff_pl_tpu_torch.apps.serve import png_bytes

    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3), np.uint8)
    png = png_bytes(rgb)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xffffffff
        chunks[tag] = data
        pos += 12 + n
    assert struct.unpack(">II", chunks[b"IHDR"][:8]) == (7, 5)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    np.testing.assert_array_equal(raw.reshape(5, 22)[:, 1:].reshape(5, 7, 3),
                                  rgb)
