"""The data mesh and the row sharding of a field evaluation (port of
`nsff_pl_tpu/parallel/mesh.py` and of the JAX package's `shard_map`
wrappers `models/raymarch.py::_shard_planar`,
`models/rendering.py::_shard_over_rays` and `_shard_comp`).

Rays are the batch dimension, so data parallelism is ray sharding: a
1-D mesh of ranks, each holding the whole (replicated) weights. The
batch and every random draw stay global on every rank. Each field
evaluation runs on the rank's contiguous block of rows and its outputs
are gathered back to the global rows (`shard_rows`), so everything
between evaluations (the compositing glue, the warp plan, the loss)
runs replicated on the same bits everywhere. In the backward the
gather returns each rank its own rows of the (replicated) cotangent,
and the cut gathers the cotangents of the rows it handed out, so the
replicated code sees whole cotangents on every rank: the embedding
tables, looked up there, get their whole gradient on every rank, and
the weights the evaluations take whole get their rows' share, which one
all-reduce (sum) after the backward (`all_reduce_grads`) makes the
one-rank gradient on every rank.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, NamedTuple

import torch
import torch.distributed as dist

# collectives called, by kind ("all_gather", "all_reduce"): a captured
# graph replays what was called while it was captured
CALLED: Counter = Counter()


class Mesh(NamedTuple):
    """One rank's view of the data mesh: the process group, this rank,
    the world size and the rank's device."""
    group: Any
    rank: int
    size: int
    device: torch.device


_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: torch.device) -> str:
    """The one backend of a device type: NCCL on CUDA, gloo on the CPU."""
    if device.type not in _BACKEND:
        raise ValueError(f"no process-group backend for device {device}")
    return _BACKEND[device.type]


def make_mesh(device) -> Mesh:
    """The mesh of every rank of the default process group, on `device`
    (this rank's). The group's backend must be the device's
    (`backend_for`): a CUDA device never runs on gloo. A first
    all-reduce here creates the communicator, so that no collective of
    a step (nor of a CUDA graph's warm-up) is the group's first."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: join one first "
                           "(parallel.distributed.initialize)")
    device = torch.device(device)
    backend = dist.get_backend()
    if backend != backend_for(device):
        raise ValueError(f"process group backend {backend!r} on {device}: "
                         f"{device.type} ranks run on "
                         f"{backend_for(device)!r}")
    mesh = Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                device)
    dist.all_reduce(torch.zeros((1,), device=device), group=mesh.group)
    return mesh


def check_device(mesh: Mesh, device) -> None:
    """Raise unless `device` is the mesh's ('cuda' names the current
    card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    if d != mesh.device:
        raise ValueError(f"the mesh's device {mesh.device} is not {d}")


def round_chunk(chunk: int, mesh) -> int:
    """A render chunk over `mesh`, as the JAX package's eval CLI, server
    and validation size it: max(n, chunk - chunk % n) for n ranks, so that
    every chunk's rays divide over them; `chunk` itself without a mesh."""
    if mesh is None:
        return chunk
    n = mesh.size
    return max(n, chunk - chunk % n)


def _all_gather(mesh: Mesh, local) -> List[torch.Tensor]:
    """Each tensor of `local` (this rank's rows) -> the global rows, in
    rank order: one all-gather a dtype of the tensors flattened side by
    side. On a world of one each result is a contiguous copy."""
    out: List[torch.Tensor] = [None] * len(local)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(local):
        by_dtype.setdefault(t.dtype, []).append(i)
    # `all_gather_single` is the newer name of the same collective
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    for idx in by_dtype.values():
        flat = torch.cat([local[i].reshape(-1) for i in idx])
        both = flat.new_empty((mesh.size * flat.numel(),))
        gather(both, flat, group=mesh.group)
        CALLED["all_gather"] += 1
        both = both.view(mesh.size, flat.numel())
        off = 0
        for i in idx:
            t = local[i]
            out[i] = both[:, off:off + t.numel()].reshape(
                (mesh.size * t.shape[0],) + tuple(t.shape[1:]))
            off += t.numel()
    return out


def _own(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over the "
                         f"{mesh.size}-rank mesh")
    b = n // mesh.size
    return t[mesh.rank * b:(mesh.rank + 1) * b]


class _ScatterRows(torch.autograd.Function):
    """Global rows -> this rank's block of each tensor. The backward
    gathers the blocks' cotangents back to the global rows, so that the
    code around the sharded evaluations, which runs replicated, sees on
    every rank the whole cotangent of its values (a warp evaluated on
    rows that another rank's block produced passes its flow cotangent
    back to that block this way)."""

    @staticmethod
    def forward(ctx, mesh, *full):
        ctx.mesh = mesh
        return tuple(_own(t, mesh) for t in full)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]
        out = [None] * len(grads)
        for i, g in zip(need, _all_gather(ctx.mesh, [grads[i]
                                                     for i in need])):
            out[i] = g
        return (None, *out)


class _GatherRows(torch.autograd.Function):
    """This rank's block of rows of each tensor -> the global rows. The
    backward returns the rank's own rows of each incoming cotangent,
    unreduced: the code around runs replicated on the gathered values,
    so those cotangents are already the same on every rank (a
    reduce-scatter here, as `torch.distributed.nn.functional.all_gather`
    does in its backward, would give N times the gradient)."""

    @staticmethod
    def forward(ctx, mesh, *local):
        ctx.mesh = mesh
        return tuple(_all_gather(mesh, local))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *(None if g is None else _own(g, ctx.mesh)
                        for g in grads))


def _leaves(x, out: List[torch.Tensor]):
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, torch.Tensor):
        out.append(x)
    return out


def _rebuild(x, it):
    if isinstance(x, dict):
        return {k: _rebuild(v, it) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    return next(it) if isinstance(x, torch.Tensor) else x


def rows_of(x, mesh: Mesh):
    """This rank's contiguous block of rows of every tensor in `x` (a
    tensor, None, or a tuple / list / dict of them): rows [r n / N,
    (r + 1) n / N) of a tensor of n rows, n divisible by the world
    (`_ScatterRows`; its backward gathers the cotangents)."""
    flat = _leaves(x, [])
    if not flat:
        return x
    return _rebuild(x, iter(_ScatterRows.apply(mesh, *flat)))


def gather_rows(x, mesh: Mesh):
    """Every tensor of `x` (a tensor or a tuple / list / dict of them),
    each this rank's rows, gathered to the global rows: one collective a
    dtype (`_GatherRows`). Called on a world of one too."""
    flat = _leaves(x, [])
    if not flat:
        return x
    return _rebuild(x, iter(_GatherRows.apply(mesh, *flat)))


def shard_rows(op, mesh, whole: int = 1):
    """`op` evaluated data-parallel by rows over `mesh`: the first
    `whole` positional arguments (the weights) and every keyword argument
    (packed weights) pass whole, every other positional argument (a
    tensor of rows, None, or a tuple / dict of them) is cut to this
    rank's block of rows (`rows_of`), and the outputs are gathered back
    to the global rows (`gather_rows`). The weights' gradients come out
    as this rank's rows' share (`all_reduce_grads` sums them); the
    gradients of what the rows were computed from, whole on every rank.
    Without a mesh it is `op` itself."""
    if mesh is None:
        return op

    def sharded(*args, **kw):
        rows = rows_of(list(args[whole:]), mesh)
        return gather_rows(op(*args[:whole], *rows, **kw), mesh)

    return sharded


def all_reduce_grads(leaves, mesh: Mesh) -> None:
    """Sum the gradients of `leaves` (the weights the sharded evaluations
    take whole: each rank holds its rows' share) over the mesh, in place:
    one all-reduce of one flat buffer a dtype. Leaves without a gradient
    (the same on every rank: one graph) are skipped."""
    grads = [p.grad for p in leaves if p.grad is not None]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=mesh.group)
        CALLED["all_reduce"] += 1
        parts = torch.split(flat, [g.numel() for g in gs])
        torch._foreach_copy_(gs, [p.view_as(g) for p, g in zip(parts, gs)])
