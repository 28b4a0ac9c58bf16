"""Data-parallel training over torch.distributed (port of
`nsff_pl_tpu/parallel/`): one rank a GPU, the ray batch sharded by rows
inside each field evaluation, the weights replicated and their
gradients summed by one all-reduce a step. Training only; eval and
serving run on one GPU ('multi-GPU eval and serving')."""

from nsff_pl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_grads,
    gather_rows,
    make_mesh,
    rows_of,
    shard_rows,
)
from nsff_pl_tpu_torch.parallel import distributed  # noqa: F401
