"""Multi-process data parallelism over torch.distributed (port of
`nsff_pl_tpu/parallel/distributed.py`).

The reference trains with Lightning DDP over NCCL (`--num_gpus` GPUs on
each of `--num_nodes` nodes); the JAX package spans one mesh over every
process's chips. Here each GPU is one rank, a process of its own:

- `launch` starts this node's ranks, local rank 0 in the calling
  process and the others by `torch.multiprocessing` (start method
  'spawn'), and joins each to the job's process group (`initialize`):
  NCCL on CUDA, gloo on the CPU, never one for the other;
- the ranks of one node meet at a rendezvous file in a fresh temporary
  directory, the nodes of a job at `--coordinator_address host:port`
  (node 0, `--node_rank` 0, holds the store);
- every rank runs the same host loop (same seeds, same frame schedule,
  the same batch and draws), so host-side state stays the same; rank 0
  owns the side effects (logs, prints, checkpoints);
- the server's rank 0 alone takes requests: it broadcasts each to the
  other ranks (`send_request`), which wait for it in a follow loop
  (`receive_request`), with a keep-alive while it is idle so that no
  wait outlasts the group's timeout.

The eval and serve CLIs take `--num_gpus` alone, as the JAX tools do:
their options lack the multi-node flags, which then read one node.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from nsff_pl_tpu_torch.parallel.mesh import Mesh, backend_for, make_mesh

# how long a rank waits on the others (rendezvous, a collective)
TIMEOUT_S = 600
# the most an idle server's followers wait between two broadcasts
KEEP_ALIVE_S = 60

# the multi-node flags of options that lack them (one node)
_ONE_NODE = {"num_nodes": 1, "coordinator_address": "", "node_rank": -1}


def _flag(cfg, name):
    return getattr(cfg, name, _ONE_NODE[name])


def asked(cfg) -> int:
    """The ranks the flags ask for: --num_gpus x --num_nodes."""
    return cfg.num_gpus * max(_flag(cfg, "num_nodes"), 1)


def check(cfg) -> None:
    """The JAX package's refusals of the bootstrap flags, and the port's
    one more: several nodes need a coordinator to meet at."""
    nodes, coordinator, node_rank = (_flag(cfg, k) for k in _ONE_NODE)
    if coordinator and node_rank < 0:
        raise ValueError("--coordinator_address requires --node_rank")
    if nodes > 1 and not coordinator:
        raise ValueError(f"--num_nodes {nodes}: multi-node training "
                         "needs --coordinator_address host:port (node 0's) "
                         "and --node_rank")
    if cfg.num_gpus < 1 or nodes < 1:
        raise ValueError(f"--num_gpus {cfg.num_gpus} --num_nodes "
                         f"{nodes}: each must be at least 1")
    if nodes > 1 and not 0 <= node_rank < nodes:
        raise ValueError(f"--node_rank {node_rank} outside the "
                         f"{nodes} nodes")


def local_ranks(cfg, device) -> int:
    """This node's ranks: --num_gpus on the CPU, at most the GPUs
    present on CUDA."""
    if torch.device(device).type == "cuda":
        return min(cfg.num_gpus, torch.cuda.device_count())
    return cfg.num_gpus


def initialize(cfg, device, local_rank: int = 0, local_size: int = 1,
               init_method=None) -> Mesh:
    """Join this process to the job's process group as rank node_rank x
    local_size + local_rank, on `device` (`cuda:<local rank>` or the
    CPU), and return its mesh. The group meets at `tcp://<coordinator>`
    when --coordinator_address is set, else at `init_method`. A group
    that fails to form raises."""
    check(cfg)
    device = torch.device(device)
    nodes = max(_flag(cfg, "num_nodes"), 1)
    coordinator = _flag(cfg, "coordinator_address")
    node = _flag(cfg, "node_rank") if coordinator else 0
    if coordinator:
        init_method = f"tcp://{coordinator}"
    if init_method is None:
        raise ValueError("no rendezvous: give init_method or "
                         "--coordinator_address")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=nodes * local_size,
                            rank=node * local_size + local_rank,
                            timeout=timedelta(seconds=TIMEOUT_S), **kw)
    return make_mesh(device)


def multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the rank that owns logging, printing and checkpoints (and
    in a process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh."""
    if mesh.device.type == "cuda":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


# a request's kinds (`send_request`)
STOP, RENDER, KEEP_ALIVE = 0, 1, 2
_REQUEST_LEN = 15  # kind, t, has a pose, the 3x4 pose


def send_request(mesh: Mesh, kind: int, t: int = 0, c2w=None) -> None:
    """Rank 0: broadcast one request to the mesh's other ranks: a fixed
    (15,) float64 tensor on the mesh's device holding the kind (STOP,
    RENDER or KEEP_ALIVE), the frame time `t` and, where given, the 3x4
    camera pose `c2w` (already checked by the caller: a request the
    followers cannot take must never be sent)."""
    buf = torch.zeros((_REQUEST_LEN,), dtype=torch.float64)
    buf[0], buf[1] = kind, t
    if c2w is not None:
        buf[2] = 1
        buf[3:] = torch.as_tensor(c2w, dtype=torch.float64).reshape(12)
    dist.broadcast(buf.to(mesh.device), 0, group=mesh.group)


def receive_request(mesh: Mesh):
    """A follower: wait for rank 0's next request (`send_request`) and
    return (kind, t, c2w as a (3, 4) float32 array or None). The wait
    ends within the group's timeout (`TIMEOUT_S`); an idle rank 0 sends
    a KEEP_ALIVE every `KEEP_ALIVE_S`."""
    buf = torch.empty((_REQUEST_LEN,), dtype=torch.float64,
                      device=mesh.device)
    dist.broadcast(buf, 0, group=mesh.group)
    buf = buf.cpu()
    c2w = (buf[3:].reshape(3, 4).to(torch.float32).numpy()
           if buf[2] else None)
    return int(buf[0]), int(buf[1]), c2w


def _rank_main(local_rank, fn, cfg, dev_type, local_size, init_method,
               threads, args):
    """One rank: join the group on its device, run fn(mesh, *args),
    leave the group. A CPU rank runs on `threads` torch threads."""
    before = torch.get_num_threads()
    if dev_type == "cpu":
        torch.set_num_threads(threads)
    device = (torch.device("cuda", local_rank) if dev_type == "cuda"
              else torch.device("cpu"))
    try:
        mesh = initialize(cfg, device, local_rank, local_size, init_method)
        try:
            return fn(mesh, *args)
        finally:
            dist.destroy_process_group()
    finally:
        torch.set_num_threads(before)


def _spawned_rank(i, *rank_args):
    _rank_main(i + 1, *rank_args)


def launch(fn, cfg, device="cuda", args=()):
    """Run `fn(mesh, *args)` on each of this node's ranks
    (`local_ranks`), every rank joined to the job's process group, and
    return local rank 0's result.

    Local rank 0 runs in the calling process; the others are spawned
    processes (start method 'spawn'), so `fn` and `args` must pickle (a
    module-level function). This call returns when all have ended; it
    raises if one failed (and then ends the others). CPU ranks share the
    caller's torch threads. Node 0 prints the JAX package's note when
    fewer GPUs are present than the flags ask for; the job then uses
    them all."""
    from nsff_pl_tpu_torch import resolve_device

    check(cfg)
    dev = resolve_device(device)
    n_local = local_ranks(cfg, dev)
    nodes = max(_flag(cfg, "num_nodes"), 1)
    world = n_local * nodes
    if max(_flag(cfg, "node_rank"), 0) == 0:
        if world != asked(cfg):
            print(f"note: --num_gpus x --num_nodes = {asked(cfg)} but "
                  f"{world} GPUs are attached; using all {world}",
                  flush=True)
        print(f"mesh: {world} {dev.type} ranks over "
              f"{nodes} node(s), data-parallel over rays", flush=True)
    tmp = None if _flag(cfg, "coordinator_address") else tempfile.mkdtemp(
        prefix="nsff_rendezvous_")
    init = None if tmp is None else "file://" + os.path.join(tmp, "store")
    threads = max(1, torch.get_num_threads() // n_local)
    rank_args = (fn, cfg, dev.type, n_local, init, threads, tuple(args))
    others = None
    try:
        if n_local > 1:
            others = torch.multiprocessing.start_processes(
                _spawned_rank, args=rank_args, nprocs=n_local - 1,
                join=False, start_method="spawn")
        try:
            result = _rank_main(0, *rank_args)
        except BaseException:
            if others is not None:
                for p in others.processes:
                    p.terminate()
            raise
        if others is not None:
            while not others.join():
                pass
        return result
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
