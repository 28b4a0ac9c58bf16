"""Device-resident ray-table pipeline (port of
`nsff_pl_tpu/data/pipeline.py`).

The whole (N_frames, H*W, 16) ray table lives on the device, and a
training batch is a gather from it inside the train step: no host to
device copy per step.

- `FrameScheduler` (host): the frame of each step, sampled outside a
  +-`window` band around the last frame of its stream, with
  `num_streams` round-robin streams (the reference's data-loader
  workers). An exact numpy port: the same seed gives the same frames.
- `RayBatcher` / `_sample_batch` (device): `batch_size` rays of frame t,
  uniformly or by inverse-CDF draws over the hard-sampling weights. The
  pixel indices (uniform) or the uniforms (hard) can be passed in. t is a
  Python int or a 0-d device tensor (a captured step's frame, which
  indexing with `table[t]` would read on the host); the rays are one
  gather at t * H*W + index from the flattened table.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device


class FrameScheduler:
    """Temporal anti-correlation frame sampling."""

    def __init__(self, n_frames: int, window: int = 5, seed: int = 42,
                 num_streams: int = 4):
        self.n_frames = n_frames
        self.window = window
        self.rng = np.random.RandomState(seed)
        self.last_ts = [-1] * max(1, int(num_streams))
        self._turn = 0

    def next(self) -> int:
        s = self._turn % len(self.last_ts)
        self._turn += 1
        last = self.last_ts[s]
        if last == -1:
            t = int(self.rng.choice(self.n_frames))
        else:
            valid = list(set(range(self.n_frames))
                         - set(range(last - self.window,
                                     last + self.window + 1)))
            if not valid:  # tiny scenes: fall back to uniform
                valid = list(range(self.n_frames))
            t = int(self.rng.choice(valid))
        self.last_ts[s] = t
        return t


class RayBatcher:
    """Batch gather over the device-resident ray table."""

    # ray-table channel layout
    RAYS = slice(0, 6)
    RGB = slice(6, 9)
    T = 9
    DISP = 10
    MASK = 11
    UV_FW = slice(12, 14)
    UV_BW = slice(14, 16)

    def __init__(self, table, batch_size: int, hard_sampling: bool = False,
                 device="cuda"):
        """table: (N_frames, H*W, 16) float32 array or tensor."""
        dev = resolve_device(device)
        self.table = torch.as_tensor(table, dtype=torch.float32).to(dev)
        self.n_frames, self.n_pixels, _ = self.table.shape
        self.batch_size = batch_size
        self.hard_sampling = hard_sampling
        # hard-sampling distribution (1 - SSIM per pixel), refreshed from
        # validation renders
        self.weights = torch.ones((self.n_frames, self.n_pixels),
                                  device=dev)

    def update_weights(self, t: int, w) -> None:
        self.weights[t] = torch.as_tensor(w, dtype=torch.float32,
                                          device=self.weights.device)

    def sample(self, generator: Optional[torch.Generator], t: int, *,
               idx=None, u=None) -> Dict[str, torch.Tensor]:
        return _sample_batch(self.table, self.weights, t, self.batch_size,
                             self.hard_sampling, generator=generator,
                             idx=idx, u=u)


def blocked_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a 1-D tensor, the same bits on every
    run: within rows of 1024 (on a CUDA device one block a row, in a
    fixed order), then plus each row's offset (a scan along the other
    dimension of a two-column copy: one thread a column, in order). The
    hard-sampling draw's CDF on the card: there torch.cumsum of a 1-D
    tensor runs CUB's single-pass scan, whose look-back adds the partial
    sums of earlier tiles in an order that depends on timing; float
    addition does not associate, so once the weights are not integers
    (after the first hard-sampling refresh) two runs drew other pixels
    from the same uniforms (ROADMAP C1)."""
    n, cols = w.shape[0], 1024
    rows = -(-n // cols)
    x = torch.nn.functional.pad(w, (0, rows * cols - n)).view(rows, cols)
    within = torch.cumsum(x, 1)
    tot = within[:, -1:]
    inc = torch.cumsum(torch.cat([tot, tot], 1), 0)[:, 0]
    off = torch.cat([inc.new_zeros(1), inc[:-1]])
    return (within + off[:, None]).reshape(-1)[:n]


def _sample_batch(table, weights, t, batch_size: int, hard_sampling: bool,
                  *, generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None,
                  u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One training batch of frame `t`. Uniform: pixel indices `idx`, or
    drawn from `generator`. Hard sampling: weighted draws with
    replacement by inverse-CDF sampling, from uniforms `u` ((B,) in
    [0, 1)) or drawn from `generator`."""
    n_frames, n_pixels, n_ch = table.shape
    dev = table.device
    if hard_sampling:
        w = weights[t] if not isinstance(t, torch.Tensor) else \
            weights.index_select(0, t.reshape(1))[0]
        w = torch.clamp(w, min=0.0)
        # the CPU keeps the sequential scan: the JAX package's bits
        cw = blocked_cumsum(w) if w.is_cuda else torch.cumsum(w, 0)
        if u is None:
            u = torch.rand((batch_size,), generator=generator, device=dev)
        idx = torch.clamp(torch.searchsorted(cw, u.to(dev) * cw[-1],
                                             right=True), 0, n_pixels - 1)
    elif idx is None:
        idx = torch.randint(0, n_pixels, (batch_size,), generator=generator,
                            device=dev)
    idx = torch.as_tensor(idx, device=dev).long()
    rays = table.reshape(n_frames * n_pixels, n_ch)[t * n_pixels + idx]
    B = RayBatcher
    return {
        "rays": rays[:, B.RAYS],
        "rgbs": rays[:, B.RGB],
        "ts": rays[:, B.T].long(),
        "cam_ids": torch.zeros((batch_size,), dtype=torch.long, device=dev),
        "disps": rays[:, B.DISP],
        "rays_mask": rays[:, B.MASK],
        "uv_fw": rays[:, B.UV_FW],
        "uv_bw": rays[:, B.UV_BW],
        "rand_idx": idx,
    }
