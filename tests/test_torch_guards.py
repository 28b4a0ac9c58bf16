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
# scripts/jax_ckpt_to_torch.py bridges the two packages (it reads the JAX
# package's orbax checkpoints) and runs where both are installed, never
# on the card's machine
BRIDGES = {REPO / "scripts" / "jax_ckpt_to_torch.py"}
PORT_FILES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted(p for p in (REPO / "scripts").glob("*.py")
                       if p not in BRIDGES))


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
    from nsff_pl_tpu_torch.apps import evaluate as eval_app
    from nsff_pl_tpu_torch.apps import train as train_app
    from nsff_pl_tpu_torch.scene import MonocularScene
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem

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
        # the packed-boundary path
        "build_params_static": lambda: build_params(
            NSFFConfig(use_viewdir=True), g),
        "make_train_step_packed": lambda: make_train_step(
            RC(encode_t=True, fused_train="off", fused_compositing=True),
            None, make_optimizer(train_cfg, 1), output_transient=True,
            output_transient_flow=("fw", "bw", "disocc"), steps_per_epoch=1,
            batch_size=4),
        "make_train_step_static": lambda: make_train_step(
            RC(), None, make_optimizer(train_cfg, 1), output_transient=False,
            output_transient_flow=(), steps_per_epoch=1, batch_size=4),
        "make_render_fn_train_mode": lambda: make_render_fn(
            RC(encode_t=True, planar_eval="off"), test_time=False,
            output_transient=True, output_transient_flow=("fw", "bw")),
        "RenderService_packed_float32": lambda: RenderService(
            {}, torch.eye(3).numpy(), torch.zeros(1, 3, 4).numpy(),
            (8, 6), NSFFConfig(dtype="float32", planar_eval="off")),
        # the scene on disk, the trainer and the train CLI
        "MonocularScene": lambda: MonocularScene("unused"),
        "NSFFSystem": lambda: NSFFSystem(train_cfg),
        "train_main": lambda: train_app.main(train_cfg),
        # the eval CLI
        "eval_main": lambda: eval_app.main(eval_app.get_opts(
            ["--root_dir", "unused", "--ckpt_path", "unused"])),
    }


@pytest.mark.parametrize("name", sorted(
    ["resolve_device", "init_nerf_params", "init_embedding", "build_params",
     "params_from_jax", "load", "to_device", "make_render_fn",
     "RenderService", "build_params_train", "make_train_step", "RayBatcher",
     "opt_state_from_jax", "build_params_static", "make_train_step_packed",
     "make_train_step_static", "make_render_fn_train_mode",
     "RenderService_packed_float32", "MonocularScene", "NSFFSystem",
     "train_main", "eval_main"]))
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


def test_packed_entry_points_run_on_cpu_when_asked():
    """The packed-boundary path from its entry points on the CPU: a
    static-only model takes a training step through render_rays (the
    kernels' plain versions), and a float32 service with
    `planar_eval="off"` renders a frame on the plain evaluators."""
    import numpy as np

    from nsff_pl_tpu_torch.apps.serve import RenderService
    from nsff_pl_tpu_torch.config import (NSFFConfig, build_params,
                                          loss_config, render_config)
    from nsff_pl_tpu_torch.ops import mlp_kernel, mlp_train_kernel
    from nsff_pl_tpu_torch.training.optim import make_optimizer
    from nsff_pl_tpu_torch.training.step import TrainState, make_train_step

    cfg = NSFFConfig(img_wh=(8, 6), start_end=(0, 2), use_viewdir=True,
                     N_samples=8, batch_size=4, dtype="bfloat16",
                     train_backend="pallas")
    params = build_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == {"nerf_fine"}
    assert not any(k.startswith("transient") for k in params["nerf_fine"])
    tx = make_optimizer(cfg, 1)
    step = make_train_step(render_config(cfg), loss_config(cfg), tx,
                           output_transient=False, output_transient_flow=(),
                           steps_per_epoch=1, batch_size=4, device="cpu")
    assert step.device.type == "cpu" and not step.use_planar
    rng = np.random.RandomState(0)
    table = rng.rand(2, 48, 16).astype(np.float32)
    table[..., 2], table[..., 5] = -1.0, 2.0
    table[..., 9] = np.arange(2, dtype=np.float32)[:, None]
    K = np.array([[7.0, 0, 4], [0, 7.0, 3], [0, 0, 1]], np.float32)
    eye = np.eye(4, dtype=np.float32)[None, :3]
    before = mlp_kernel.fused_nerf_eval_cuda.launches
    state, metrics, _ = step(
        TrainState(params, tx.init(params), 0), torch.from_numpy(table),
        torch.ones(2, 48), torch.from_numpy(K[None]),
        torch.from_numpy(K[None] @ eye), torch.Generator().manual_seed(1), 1)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    # CPU tensors take the plain versions: no launch is counted
    assert mlp_kernel.fused_nerf_eval_cuda.launches == before
    assert mlp_train_kernel.fused_nerf_train_bwd_cuda.launches == {
        "static": 0, "transient": 0}

    poses = np.tile(eye, (2, 1, 1))
    svc = RenderService(params, K, poses, (8, 6),
                        cfg.replace(dtype="float32", planar_eval="off"),
                        chunk=32, device="cpu")
    rgb, depth = svc.render_pose(1)
    assert rgb.shape == (6, 8, 3) and depth.shape == (6, 8)
    assert np.isfinite(depth).all()


def test_scene_entry_points_run_on_cpu_when_asked(tmp_path):
    """`MonocularScene`, `NSFFSystem` and the train CLI's `main` on the CPU
    on a scene too small for a step (16x12, 3 frames: 0 steps an epoch):
    the ray table and the system's state lie on the CPU."""
    from nsff_pl_tpu_torch.apps.train import main
    from nsff_pl_tpu_torch.config import NSFFConfig
    from nsff_pl_tpu_torch.scene import MonocularScene
    from nsff_pl_tpu_torch.training.trainer import NSFFSystem
    from tests.helpers_scene import make_synthetic_scene

    root = make_synthetic_scene(str(tmp_path / "scene"), W=16, H=12, N=3)
    scene = MonocularScene(root, img_wh=(16, 12), start_end=(0, 3),
                           device="cpu")
    assert scene.rays.device.type == "cpu" and len(scene) == 0
    cfg = NSFFConfig(root_dir=root, img_wh=(16, 12), start_end=(0, 3),
                     encode_t=True, N_samples=8, batch_size=4,
                     log_dir=str(tmp_path / "logs"),
                     ckpt_dir=str(tmp_path / "ckpts"))
    system = NSFFSystem(cfg, device="cpu")
    assert system.batcher.table.device.type == "cpu"
    system = main(cfg, device="cpu")
    assert system.state.step == 0 == system.total_steps
    assert (tmp_path / "logs" / "exp" / "metrics.jsonl").exists()


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
