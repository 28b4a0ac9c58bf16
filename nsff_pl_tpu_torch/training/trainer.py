"""Training orchestration (port of `nsff_pl_tpu/training/trainer.py`):
`NSFFSystem`, a plain loop around the train step.

- the scenes, params (with an optional warm start), the optimizer
  (adam, sgd, radam or ranger) and its schedule, the device ray table
  with its hard-sampling weights, the frame scheduler and the train
  step (`make_train_step(scan_steps=K)`: one CUDA graph of K steps on
  the card), as the JAX trainer builds them;
- `fit`: groups of K steps clipped at the epoch end, the validation
  cadence and the last step (a clipped group runs single steps); the
  per-step metrics of a window are copied to the host without a wait
  and read after the next group has been dispatched; validation and a
  checkpoint at each epoch end; `time_budget_s`; with `profile_dir`, a
  torch.profiler trace of steps 10-15 of the run (`utils/profiling.py`;
  K is 1 then; each single step is a `step <n>` range);
- `validate`: the middle frame (read from disk once, kept on the
  device) rendered on the card, PSNR and SSIM (and their masked
  variants), image grids for TensorBoard, and the
  hard-sampling refresh, weight = 1 - SSIM(tmp_rgb, gt) per pixel, all
  on the device;
- `save` / `restore`: params, the optimizer's state (Adam's count and
  moments; sgd's trace; ranger's slow weights and lookahead count too,
  so that a resume syncs from the right slow point), the step, the
  sampling weights, and (for an exact resume) the hard-sampling buffer,
  the train generator's and the frame scheduler's states. `restore`
  copies into the tensors the captured graph reads, so a restore needs
  no new capture.

Nothing here rebinds a tensor the train step reads: the params, the
optimizer's state, the table, the weights and `tmp_rgb` keep their
storage for the life of the system, so each dispatch shape is captured
once.

Data-parallel (`mesh`, one rank a GPU, started by `apps/train.py`
through `parallel.distributed.launch`): every rank builds the same
system from the same seed and files and runs the same loop (the
schedule, the draws, the validation and the hard-sampling refresh);
the step shards its field evaluations and sums the gradients
(`training/step.py`), and the validation's render shards each chunk's
rays over the ranks (its chunk rounded to them as the JAX trainer
rounds it), every rank getting the whole frame, so the metrics, the
SSIM maps and the refresh run replicated on the same bits. Rank 0
alone logs, prints and writes checkpoints, the ranks meeting at a
barrier after each save; a time budget is decided by rank 0 for all.
Checkpoints are those of one process, so either restores in the other.

Not ported (raises `NotImplementedError` naming its ROADMAP item):
datasets other than `monocular`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nsff_pl_tpu_torch import resolve_device
from nsff_pl_tpu_torch.config import (NSFFConfig, build_params, loss_config,
                                      render_config)
from nsff_pl_tpu_torch.data.pipeline import FrameScheduler, RayBatcher
from nsff_pl_tpu_torch.parallel import distributed as dist_lib
from nsff_pl_tpu_torch.parallel.mesh import check_device, round_chunk
from nsff_pl_tpu_torch.training import checkpoint as ckpt_lib
from nsff_pl_tpu_torch.training import metrics as metrics_lib
from nsff_pl_tpu_torch.training.optim import (make_lr_schedule,
                                              make_optimizer, param_leaves)
from nsff_pl_tpu_torch.training.step import (TrainState, make_render_fn,
                                             make_train_step,
                                             render_full_image,
                                             write_tmp_rgb)
from nsff_pl_tpu_torch.utils import profiling
from nsff_pl_tpu_torch.utils import visualization as viz

VAL_KEYS = ("rgb_fine", "depth_fine", "transient_alpha_fine",
            "_static_rgb_fine", "_static_depth_fine")


class TensorBoardLogger:
    """torch's SummaryWriter when `tensorboard` imports, and a JSONL file
    (`metrics.jsonl`) always."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir)
        except Exception:
            self.writer = None
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value, step: int, jsonl: bool = True):
        v = float(value)
        if self.writer is not None:
            self.writer.add_scalar(tag, v, step)
        if jsonl:
            self.jsonl.write(f'{{"step": {step}, "{tag}": {v}}}\n')

    def row_jsonl(self, metrics: dict, step: int):
        """One step's metrics to the JSONL only (TensorBoard takes a point
        every `log_every` steps)."""
        vals = ", ".join(f'"{t}": {float(v)}' for t, v in metrics.items())
        self.jsonl.write(f'{{"step": {step}, {vals}}}\n')

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if self.writer is not None:
            self.writer.add_image(tag, np.asarray(img_hwc), step,
                                  dataformats="HWC")

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
        self.jsonl.flush()


class _NullLogger:
    """The logger of a rank other than 0: writes nothing."""
    writer = None

    def scalar(self, *a, **k):
        pass

    def row_jsonl(self, *a, **k):
        pass

    def image(self, *a, **k):
        pass

    def flush(self):
        pass


def check_ported(cfg: NSFFConfig, mesh=None) -> None:
    """Raise for the options whose features the port has not yet, for
    the bootstrap flags the JAX package refuses, and for more than one
    rank asked for without the ranks' mesh."""
    dist_lib.check(cfg)
    if dist_lib.asked(cfg) > 1 and mesh is None:
        raise ValueError(
            f"--num_gpus x --num_nodes = {dist_lib.asked(cfg)} ranks but no "
            "mesh: multi-GPU training starts one rank a GPU through "
            "apps.train (parallel.distributed.launch), which hands each "
            "rank its mesh")
    if cfg.dataset_name != "monocular":
        raise NotImplementedError(
            f"dataset {cfg.dataset_name!r} is not ported; the port reads "
            "'monocular' scenes")


def _scheduler_state(s: FrameScheduler) -> dict:
    name, keys, pos, has_gauss, cached = s.rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached),
            "last_ts": list(s.last_ts), "turn": s._turn}


def _set_scheduler_state(s: FrameScheduler, st: dict) -> None:
    s.rng.set_state(("MT19937", st["keys"].numpy().astype(np.uint32),
                     st["pos"], st["has_gauss"], st["cached_gaussian"]))
    s.last_ts = list(st["last_ts"])
    s._turn = st["turn"]


class _Fetch:
    """A window of per-step metrics on its way to the host: one stacked
    device tensor copied without a wait, read after the next group is
    dispatched."""

    def __init__(self, rows, dev: torch.device):
        self.meta = [(s0, n) for s0, n, _ in rows]
        self.keys = list(rows[0][2])
        stacked = torch.cat([torch.stack([m[k].reshape(-1) for k in self.keys])
                             for _, _, m in rows], 1)
        self.event = None
        if dev.type == "cuda":
            self.host = torch.empty(stacked.shape, dtype=stacked.dtype,
                                    pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = stacked

    def rows(self):
        """(step, {name: value}) for every step of the window."""
        if self.event is not None:
            self.event.synchronize()
        vals = self.host.numpy()
        col = 0
        for s0, n in self.meta:
            for i in range(n):
                yield s0 + i, {k: float(vals[j, col])
                               for j, k in enumerate(self.keys)}
                col += 1


class NSFFSystem:
    """End-to-end training system on `device` (default the card); one
    rank of a data-parallel job with `mesh` (this rank's, on `device`)."""

    def __init__(self, cfg: NSFFConfig, device="cuda", mesh=None):
        dev = resolve_device(device)
        check_ported(cfg, mesh)
        if mesh is not None:
            check_device(mesh, dev)
        self.device = dev
        self.cfg = cfg
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0

        from nsff_pl_tpu_torch.scene import scene_dict

        scene_cls = scene_dict[cfg.dataset_name]
        kwargs = dict(root_dir=cfg.root_dir, img_wh=tuple(cfg.img_wh),
                      start_end=tuple(cfg.start_end),
                      cache_dir=cfg.cache_dir or None,
                      hard_sampling=cfg.hard_sampling, device=dev)
        t0 = time.perf_counter()
        self.train_scene = scene_cls(split="train", **kwargs)
        self.val_scene = scene_cls(split="val", **kwargs)
        self.load_seconds = time.perf_counter() - t0
        # frame count may have been clamped by the files present
        if self.train_scene.N_frames != cfg.N_frames:
            cfg = cfg.replace(start_end=(cfg.start_end[0], cfg.start_end[0]
                                         + self.train_scene.N_frames))
            self.cfg = cfg

        self.steps_per_epoch = len(self.train_scene)
        self.total_steps = self.steps_per_epoch * cfg.num_epochs
        self.render_cfg = render_config(cfg)
        self.loss_cfg = loss_config(cfg)

        params = build_params(cfg, torch.Generator().manual_seed(cfg.seed),
                              device=dev)
        if cfg.weight_path:
            loaded = self._load_weights(cfg.weight_path)
            params = ckpt_lib.merge_params(
                params, ckpt_lib.to_device(loaded, dev))
        self.tx = make_optimizer(cfg, self.steps_per_epoch)
        self.lr_schedule = make_lr_schedule(cfg, self.steps_per_epoch)
        self.state = TrainState(params, self.tx.init(params), 0)

        self.batcher = RayBatcher(self.train_scene.rays, cfg.batch_size,
                                  hard_sampling=cfg.hard_sampling,
                                  device=dev)
        self.scheduler = FrameScheduler(cfg.N_frames, seed=cfg.seed)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.Ks = torch.from_numpy(self.train_scene.Ks).to(dev)
        self.Ps = torch.from_numpy(self.train_scene.Ps).to(dev)

        self._step_kwargs = dict(
            output_transient=cfg.output_transient,
            output_transient_flow=tuple(cfg.output_transient_flow),
            steps_per_epoch=self.steps_per_epoch,
            batch_size=cfg.batch_size, hard_sampling=cfg.hard_sampling,
            device=dev, mesh=mesh)
        # K-step dispatch; profiling wants per-step dispatch boundaries
        self.scan_steps = 1 if cfg.profile_dir else max(cfg.scan_steps, 1)
        self.train_step = make_train_step(
            self.render_cfg, self.loss_cfg, self.tx,
            scan_steps=self.scan_steps, **self._step_kwargs)
        self._single_step = self.train_step if self.scan_steps == 1 \
            else None  # built at the first clipped group
        self.single_steps = 0  # steps run one at a time
        self._val_item = None
        self.val_render = make_render_fn(
            self.render_cfg, test_time=True,
            output_transient=cfg.output_transient, output_transient_flow=(),
            keys=VAL_KEYS, device=dev, mesh=mesh)

        self.logger = (TensorBoardLogger(os.path.join(cfg.log_dir,
                                                      cfg.exp_name))
                       if self.primary else _NullLogger())
        self.ckpt_dir = os.path.join(cfg.ckpt_dir, cfg.exp_name)
        w, h = cfg.img_wh
        # the hard-sampling buffer; a (1, 1, 3) stand-in passes through a
        # dispatch untouched otherwise
        shape = (cfg.N_frames, h * w, 3) if cfg.hard_sampling else (1, 1, 3)
        self.tmp_rgb = torch.zeros(shape, device=dev)
        # what fit / validate / save took, for the logs and measurements
        self.val_seconds: List[float] = []
        self.val_history: List[Tuple[int, Dict[str, float]]] = []
        self.save_seconds: List[float] = []
        self.fit_seconds = 0.0
        self.steps_run = 0
        # the profiled window: its steps and wall seconds (to the end of
        # its device work, without writing the trace)
        self.trace_steps: List[int] = []
        self.trace_seconds: Optional[float] = None
        if cfg.ckpt_path:  # full resume
            self.restore(cfg.ckpt_path)

    # ------------------------------------------------------------------
    def _load_weights(self, path: str):
        if path.endswith(".ckpt"):
            return ckpt_lib.import_pl_checkpoint(path,
                                                 self.cfg.prefixes_to_ignore)
        return ckpt_lib.restore_checkpoint(path)["params"]

    def restore(self, path: str) -> None:
        """Load a checkpoint into the system's own tensors (in place)."""
        tree = ckpt_lib.restore_checkpoint(path)
        mine, src = (param_leaves(self.state.params),
                     param_leaves(tree["params"]))
        if [tuple(t.shape) for t in mine] != [tuple(t.shape) for t in src]:
            raise ValueError(f"{path}: parameter shapes differ from this "
                             "configuration's")
        opt = self.state.opt_state
        try:
            ckpt_lib.load_opt_fields(opt, tree["opt_state"],
                                     self.state.params)
        except ValueError as e:
            raise ValueError(f"{path}: {e} (optimizer "
                             f"{self.cfg.optimizer!r})") from e
        with torch.no_grad():
            torch._foreach_copy_(mine, [t.to(self.device) for t in src])
            self.batcher.weights.copy_(tree["sampling_weights"])
            if tree.get("tmp_rgb", torch.empty(0)).shape == \
                    self.tmp_rgb.shape:
                self.tmp_rgb.copy_(tree["tmp_rgb"])
        if "generator" in tree:
            self.generator.set_state(tree["generator"])
        if "scheduler" in tree:
            _set_scheduler_state(self.scheduler, tree["scheduler"])
        self.state = self.state._replace(step=int(tree["step"]))

    def save(self) -> str:
        """Checkpoint `ckpt_dir/<exp>/step_<n>`, and the config beside it
        (rank 0 writes; every rank of a mesh waits for it)."""
        t0 = time.perf_counter()
        step = int(self.state.step)
        path = os.path.join(self.ckpt_dir, f"step_{step}")
        if self.primary:
            params = self.state.params
            tree = {
                "params": params,
                "opt_state": ckpt_lib.opt_state_tree(self.state.opt_state,
                                                     params),
                "step": step,
                "sampling_weights": self.batcher.weights,
                "tmp_rgb": self.tmp_rgb,
                "generator": self.generator.get_state(),
                "scheduler": _scheduler_state(self.scheduler),
            }
            path = ckpt_lib.save_checkpoint(self.ckpt_dir, step, tree)
            with open(os.path.join(self.ckpt_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(self.cfg), f, indent=2,
                          default=str)
        if self.mesh is not None:
            dist_lib.barrier(self.mesh)
        self.save_seconds.append(time.perf_counter() - t0)
        return path

    def _out_of_time(self, t_fit0: float) -> bool:
        """Has the run spent its time budget? Rank 0's clock decides for
        every rank of a mesh (one broadcast a dispatch, only with a
        budget)."""
        over = time.time() - t_fit0 > self.cfg.time_budget_s
        if self.mesh is None:
            return over
        flag = torch.tensor([float(over)], device=self.device)
        torch.distributed.broadcast(flag, 0, group=self.mesh.group)
        return bool(flag.item())

    def _remainder_step(self):
        if self._single_step is None:
            self._single_step = make_train_step(
                self.render_cfg, self.loss_cfg, self.tx, scan_steps=1,
                **self._step_kwargs)
        return self._single_step

    def _to_device(self, ts: np.ndarray) -> torch.Tensor:
        """A host schedule on the device without a wait."""
        t = torch.from_numpy(ts)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _write_rows(self, fetch: _Fetch, at_step: int, log_every: int,
                    progress: bool, t0: float) -> None:
        last, tb_rows, n = None, [], 0
        for s, row in fetch.rows():
            self.logger.row_jsonl({f"train/{k}": v for k, v in row.items()},
                                  s)
            last, n = row, n + 1
            if s % log_every == log_every - 1:
                tb_rows.append((row, s))
        if at_step == self.total_steps and not tb_rows:
            tb_rows.append((last, at_step - 1))
        for row, s in tb_rows:
            for name, v in row.items():
                self.logger.scalar(f"train/{name}", v, s, jsonl=False)
            self.logger.scalar("lr", self.lr_schedule(s), s)
        if progress:
            dt = time.time() - t0
            rays_s = self.cfg.batch_size * n / max(dt, 1e-9)
            print(f"step {at_step}/{self.total_steps} "
                  f"loss={last['loss']:.4f} psnr={last['psnr']:.2f} "
                  f"({rays_s:,.0f} rays/s)", flush=True)

    # ------------------------------------------------------------------
    def fit(self, log_every: int = 50, progress: bool = True):
        """The training loop: groups of `scan_steps` steps per dispatch,
        clipped so that no group crosses an epoch end, a validation or
        the last step; the steps of a clipped group run one at a time.
        Only rank 0 prints its progress."""
        cfg = self.cfg
        progress = progress and self.primary
        K = self.scan_steps
        pending: List[Tuple[int, int, Dict[str, torch.Tensor]]] = []
        n_pending = 0
        ready: Optional[_Fetch] = None
        fetch_every = max(log_every, 8 * K)
        t0 = t_fit0 = time.time()

        def drain(fetch, at_step):
            nonlocal t0
            if fetch is not None:
                self._write_rows(fetch, at_step, log_every, progress, t0)
                t0 = time.time()

        trace = None
        step = step0 = self.state.step
        while step < self.total_steps:
            # a trace of steps 10-15 (K is 1 here), on rank 0
            if cfg.profile_dir and self.primary:
                if step == step0 + 10 and trace is None:
                    trace = profiling.Trace(cfg.profile_dir,
                                            self.device).start()
                elif step >= step0 + 15 and trace is not None:
                    self._end_trace(trace)
                    trace = None
            g = min(K, self.total_steps - step)
            g = min(g, self.steps_per_epoch - step % self.steps_per_epoch)
            if cfg.val_every_steps > 0:
                g = min(g, cfg.val_every_steps - step % cfg.val_every_steps)
            if g == K and K > 1:
                ts = np.fromiter((self.scheduler.next() for _ in range(g)),
                                 np.int64, g)
                self.state, _, metrics = self.train_step(
                    self.state, self.tmp_rgb, self.batcher.table,
                    self.batcher.weights, self.Ks, self.Ps, self.generator,
                    self._to_device(ts))
                pending.append((step, g, metrics))
            else:
                single = self._remainder_step()
                for i in range(g):
                    t = self.scheduler.next()
                    with torch.profiler.record_function(f"step {step + i}"):
                        self.state, metrics, aux = single(
                            self.state, self.batcher.table,
                            self.batcher.weights, self.Ks, self.Ps,
                            self.generator, t)
                    if trace is not None:
                        self.trace_steps.append(step + i)
                    if cfg.hard_sampling:
                        with torch.no_grad():
                            write_tmp_rgb(self.tmp_rgb, t, aux["rand_idx"],
                                          aux["rgb_fine"])
                    pending.append((step + i, 1, metrics))
                self.single_steps += g
            step += g
            n_pending += g

            if ready is not None:
                # the previous window, read while this group runs
                drain(ready, step - g)
                ready = None
            if step == self.total_steps:
                drain(_Fetch(pending, self.device), step)
                pending, n_pending = [], 0
            elif n_pending >= fetch_every:
                ready = _Fetch(pending, self.device)
                pending, n_pending = [], 0

            if cfg.val_every_steps > 0 and step % cfg.val_every_steps == 0:
                self.validate(step / self.steps_per_epoch)
            if step % self.steps_per_epoch == 0:
                if cfg.val_every_steps <= 0:
                    self.validate(step // self.steps_per_epoch)
                self.save()
            if (cfg.time_budget_s > 0 and step < self.total_steps
                    and self._out_of_time(t_fit0)):
                drain(ready, step)
                if pending:
                    drain(_Fetch(pending, self.device), step)
                ready, pending, n_pending = None, [], 0
                if step % self.steps_per_epoch != 0:  # else saved above
                    self.save()
                if progress:
                    print(f"time budget ({cfg.time_budget_s:.0f}s) reached "
                          f"at step {step}/{self.total_steps}; "
                          f"checkpointed and exiting cleanly", flush=True)
                break
        if trace is not None:  # the loop ended inside the window
            self._end_trace(trace)
        self.logger.flush()
        self.fit_seconds += time.time() - t_fit0
        self.steps_run += step - step0
        return self.state

    def _end_trace(self, trace: profiling.Trace) -> None:
        trace.stop()
        self.trace_seconds = trace.seconds
        if self.primary:
            print(f"profile trace written to {self.cfg.profile_dir}",
                  flush=True)

    # ------------------------------------------------------------------
    def validate(self, epoch) -> Dict[str, float]:
        """The middle frame: PSNR / SSIM (and masked), image grids, and
        the hard-sampling weights from `tmp_rgb`, on the device."""
        t_val0 = time.perf_counter()
        cfg = self.cfg
        w, h = cfg.img_wh
        if self._val_item is None:  # the same frame every time
            self._val_item = self.val_scene.test_item(0)
        item = self._val_item
        rays, ts = item["rays"], item["ts"]
        chunk = round_chunk(min(max(cfg.chunk // 4, 1024), rays.shape[0]),
                            self.mesh)
        out = render_full_image(self.val_render, self.state.params, rays, ts,
                                chunk=chunk)
        step = int(self.state.step)

        img = torch.clamp(out["rgb_fine"].float().reshape(h, w, 3), 0, 1)
        img_gt = item["rgbs"].reshape(h, w, 3)
        mask = item["mask"].reshape(h, w)
        ssim_pix = metrics_lib.ssim(img_gt, img, reduction="none").mean(-1)
        vals = {"psnr": metrics_lib.psnr(img_gt, img),
                "ssim": ssim_pix.mean()}
        static = mask == 0
        if cfg.output_transient and bool(static.any()):
            vals["psnr_mask"] = metrics_lib.psnr(img_gt, img, static)
            vals["ssim_mask"] = ssim_pix[static].mean()
        host = torch.stack(list(vals.values())).cpu().tolist()
        log = dict(zip(vals, host))
        for name, v in log.items():
            self.logger.scalar(f"val/{name}", v, step)

        if self.logger.writer is not None:
            self._log_images(out, item, img, img_gt, mask, ssim_pix, step)
        if cfg.hard_sampling:
            self.refresh_weights()
            if self.logger.writer is not None:
                mid = cfg.N_frames // 2
                tmp = torch.clamp(self.tmp_rgb[mid].reshape(h, w, 3), 0, 1)
                sm = metrics_lib.ssim(
                    self.batcher.table[mid, :, 6:9].reshape(h, w, 3), tmp,
                    reduction="none").mean(-1)
                self.logger.image("misc/moving_ssim", viz.blend_images(
                    tmp.cpu().numpy(), viz.visualize_depth(
                        -sm.cpu().numpy()), 0.5), step)
        self.logger.flush()
        if self.primary:
            print(f"epoch {epoch}: " + " ".join(
                f"val/{k}={v:.4f}" for k, v in log.items()), flush=True)
        self.val_seconds.append(time.perf_counter() - t_val0)
        self.val_history.append((step, log))
        return log

    def refresh_weights(self) -> None:
        """Hard-sampling weights, 1 - SSIM(tmp_rgb, gt) per pixel, for
        every frame, written in place."""
        w, h = self.cfg.img_wh
        with torch.no_grad():
            for i in range(self.cfg.N_frames):
                gt = self.batcher.table[i, :, 6:9].reshape(h, w, 3)
                tmp = torch.clamp(self.tmp_rgb[i].reshape(h, w, 3), 0, 1)
                sm = metrics_lib.ssim(gt, tmp, reduction="none").mean(-1)
                self.batcher.update_weights(i, (1 - sm).reshape(-1))

    def _log_images(self, out, item, img, img_gt, mask, ssim_pix, step):
        """The decomposition grid and the error maps (host copies made only
        for a TensorBoard writer)."""
        cfg = self.cfg
        w, h = cfg.img_wh

        def host(x, *shape):
            return x.float().reshape(*shape).cpu().numpy()

        img_n, gt_n, mask_n = host(img, h, w, 3), host(img_gt, h, w, 3), \
            host(mask, h, w)
        imgs = [gt_n, img_n, viz.visualize_depth(host(out["depth_fine"], h,
                                                      w))]
        if cfg.output_transient:
            imgs.append(viz.visualize_mask(host(out["transient_alpha_fine"],
                                                h, w)))
            imgs.append(np.clip(host(out["_static_rgb_fine"], h, w, 3), 0, 1))
            imgs.append(viz.visualize_depth(host(out["_static_depth_fine"],
                                                 h, w)))
        imgs.append(viz.visualize_mask(1 - mask_n))
        imgs.append(viz.visualize_depth(-host(item["disp"], h, w)))
        self.logger.image("reconstruction/decomposition",
                          viz.make_grid(imgs, nrow=3), step)
        rmse_map = np.sqrt(((gt_n - img_n) ** 2).mean(-1))
        self.logger.image("error_map/rmse", viz.blend_images(
            img_n, viz.visualize_depth(-rmse_map), 0.5), step)
        self.logger.image("error_map/ssim", viz.blend_images(
            img_n, viz.visualize_depth(-host(ssim_pix, h, w)), 0.5), step)
