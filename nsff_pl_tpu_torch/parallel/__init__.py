"""Data parallelism over torch.distributed (port of
`nsff_pl_tpu/parallel/`): one rank a GPU, the rays sharded by rows
inside each field evaluation and gathered back, the weights replicated.
In training their gradients are summed by one all-reduce a step; at
test time (the eval CLI, the server, the trainer's validation) each
render chunk's rays divide over the ranks (`round_chunk`), and the
server's rank 0 broadcasts each request to the others
(`distributed.send_request` / `receive_request`)."""

from nsff_pl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_grads,
    gather_rows,
    make_mesh,
    round_chunk,
    rows_of,
    shard_rows,
)
from nsff_pl_tpu_torch.parallel import distributed  # noqa: F401
