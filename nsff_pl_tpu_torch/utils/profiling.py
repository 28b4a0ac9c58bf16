"""Profiling and timing (port of `nsff_pl_tpu/utils/profiling.py`).

- `trace(logdir)`: context manager around `torch.profiler.profile`
  writing a TensorBoard / Perfetto trace (`*.pt.trace.json`, one file per
  trace, through `tensorboard_trace_handler`) under `logdir`; CPU and
  CUDA activities, or the CPU alone when the device is the CPU.
  `Trace` is the same with explicit `start()` / `stop()`, which the
  trainer's window of steps 10-15 uses;
- `force(x)`: forces the device to finish a computation by fetching
  one scalar of its first leaf;
- `Timer`: wall-clock timing of a block (force inside it);
- `rays_per_sec`: the throughput the trainers report.

Open a trace with TensorBoard's profiler plugin (`tensorboard --logdir
<logdir>`) or drop the JSON file on https://ui.perfetto.dev; kernel
launches are the events of category "kernel".
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _leaves(x):
    """Leaves in `jax.tree.leaves` order (dict keys sorted)."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


class Trace:
    """A torch.profiler trace written under `logdir` at `stop()`.
    `seconds` is the wall time from `start()` to the end of the device's
    work at `stop()`, before the trace is written."""

    def __init__(self, logdir: str, device="cuda"):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        from nsff_pl_tpu_torch import resolve_device

        self.device = resolve_device(device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.logdir = logdir
        self.prof = profile(activities=acts,
                            on_trace_ready=tensorboard_trace_handler(logdir))
        self.seconds: Optional[float] = None
        self._t0 = 0.0

    def start(self) -> "Trace":
        self.prof.start()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        self.prof.stop()


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a trace: `with trace('logs/profile'): step(...)`."""
    t = Trace(logdir, device).start()
    try:
        yield t
    finally:
        t.stop()


def force(x) -> float:
    """Force completion of a computation by fetching one scalar (the sum
    of the first tensor leaf of `x`)."""
    leaf = next(v for v in _leaves(x) if isinstance(v, torch.Tensor))
    return float(leaf.sum()) if leaf.ndim else float(leaf)


class Timer:
    """Measure steady-state step time with a forced fetch at the end."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.elapsed: float = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def rays_per_sec(batch_size: int, n_steps: int, elapsed: float) -> float:
    return batch_size * n_steps / max(elapsed, 1e-12)
