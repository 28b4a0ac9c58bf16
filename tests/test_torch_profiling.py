"""Profiling in the port (`nsff_pl_tpu_torch/utils/profiling.py` and the
trainer's `profile_dir`) on the CPU.

- `trace()` writes a torch.profiler trace (`*.pt.trace.json`) that holds
  the traced ops; `force`, `Timer` and `rays_per_sec` agree with the JAX
  package's `nsff_pl_tpu.utils.profiling`.
- `NSFFSystem` with `profile_dir` on the synthetic scene of
  tests/test_torch_trainer.py (32x24, 5 frames: 3 steps an epoch;
  N_samples 16, batch 32, hard sampling, a validation every 9 steps,
  float32 on the plain evaluators), with `scan_steps=2` asked for: K is
  1, the trace holds the ranges of steps
  10-14 (`step <n>`) and no other, and the run ends with the same bits
  (params, Adam, `tmp_rgb`, sampling weights, every JSONL row) as a run
  with `scan_steps=1` and no profiling. A run that ends at step 12, inside
  the window, stops the trace there and writes it.
Torch runs on one thread (many tiny ops).
"""
import glob
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsff_pl_tpu.utils import profiling as jprof
from nsff_pl_tpu_torch.config import NSFFConfig
from nsff_pl_tpu_torch.training.optim import param_leaves
from nsff_pl_tpu_torch.training.trainer import NSFFSystem
from nsff_pl_tpu_torch.utils import profiling
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


def _trace_events(logdir):
    files = glob.glob(f"{logdir}/*.pt.trace.json")
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def _step_ranges(events):
    return sorted(int(e["name"].split()[1]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("step "))


def test_trace_holds_the_traced_ops(tmp_path):
    a, b = torch.rand(64, 32), torch.rand(32, 16)
    with profiling.trace(str(tmp_path), "cpu") as t:
        with torch.profiler.record_function("my block"):
            c = a @ b
        profiling.force(c)
    names = {e.get("name") for e in _trace_events(tmp_path)}
    assert {"my block", "aten::mm"} <= names
    assert t.seconds > 0


def test_helpers_agree_with_jax():
    rng = np.random.RandomState(0)
    tree = {"b": rng.rand(3, 4).astype(np.float32),
            "a": [rng.rand(5).astype(np.float32), np.float32(2.5)]}
    ttree = {"b": torch.from_numpy(tree["b"]),
             "a": [torch.from_numpy(tree["a"][0]), torch.tensor(2.5)]}
    jtree = {"b": jnp.asarray(tree["b"]),
             "a": [jnp.asarray(tree["a"][0]), jnp.asarray(2.5)]}
    np.testing.assert_allclose(profiling.force(ttree), jprof.force(jtree),
                               rtol=1e-6)
    assert profiling.force(torch.tensor(2.5)) == jprof.force(
        jnp.asarray(2.5)) == 2.5
    for args in ((512, 30, 0.25), (8192, 4, 1.5), (1, 1, 0.0)):
        assert profiling.rays_per_sec(*args) == jprof.rays_per_sec(*args)
    for timer in (profiling.Timer(), jprof.Timer()):
        with timer as t:
            time.sleep(0.01)
        assert t is timer and 0.01 <= t.elapsed < 1.0


def _cfg(scene, out, exp, **extra):
    kw = dict(root_dir=scene, img_wh=(W, H), start_end=(0, N),
              encode_t=True, use_viewdir=True, N_samples=16, batch_size=32,
              num_epochs=6, lr_scheduler="cosine", hard_sampling=True,
              scan_steps=1, val_every_steps=9, log_dir=str(out / "logs"),
              ckpt_dir=str(out / "ckpts"), exp_name=exp)
    kw.update(extra)
    return NSFFConfig(**kw)


def _end(system, out, exp):
    opt = system.state.opt_state
    rows = {}
    with open(out / "logs" / exp / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if "train/loss" in r:
                rows[r["step"]] = r
    return {"tensors": ([p.detach().clone()
                         for p in param_leaves(system.state.params)]
                        + [t.clone() for t in opt.tensors()]
                        + [system.tmp_rgb.clone(),
                           system.batcher.weights.clone()]),
            "step": system.state.step, "rows": rows}


def test_profile_dir_traces_steps_10_to_15_and_changes_no_bit(
        scene, tmp_path, capsys):
    logdir = str(tmp_path / "prof")
    prof = NSFFSystem(_cfg(scene, tmp_path, "prof", profile_dir=logdir,
                           scan_steps=2), device="cpu")
    assert prof.scan_steps == 1
    prof.fit(progress=False)
    assert f"profile trace written to {logdir}" in capsys.readouterr().out
    assert prof.trace_steps == [10, 11, 12, 13, 14]
    assert prof.trace_seconds > 0
    events = _trace_events(logdir)
    assert _step_ranges(events) == [10, 11, 12, 13, 14]
    assert any(e.get("name", "").startswith("aten::") for e in events)

    plain = NSFFSystem(_cfg(scene, tmp_path, "plain"), device="cpu")
    plain.fit(progress=False)
    a, b = _end(prof, tmp_path, "prof"), _end(plain, tmp_path, "plain")
    assert a["step"] == b["step"] == 18
    assert len(a["tensors"]) == len(b["tensors"])
    assert all(torch.equal(x, y) for x, y in zip(a["tensors"],
                                                 b["tensors"]))
    assert a["rows"] == b["rows"] and sorted(a["rows"]) == list(range(18))


def test_loop_ending_inside_the_window_stops_the_trace(scene, tmp_path,
                                                       capsys):
    logdir = str(tmp_path / "prof")
    system = NSFFSystem(_cfg(scene, tmp_path, "short", profile_dir=logdir,
                             num_epochs=4), device="cpu")
    system.fit(progress=False)
    assert system.state.step == 12
    assert system.trace_steps == [10, 11]
    assert f"profile trace written to {logdir}" in capsys.readouterr().out
    assert _step_ranges(_trace_events(logdir)) == [10, 11]
