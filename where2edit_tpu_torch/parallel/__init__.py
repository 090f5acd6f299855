"""Data parallelism over ``torch.distributed`` (counterpart of
where2edit_tpu/parallel/): one process per card, each with the whole model
and its rows of the global batch; gradients averaged explicitly before
every optimizer step, so a step at world size N computes what one process
computes on the global batch. SP and TP (the JAX package's
``parallel/tp.py`` and the generator's spatial mesh) are not ported."""

from where2edit_tpu_torch.parallel.collectives import (
    broadcast_from_first,
    gather_with_grad,
)
from where2edit_tpu_torch.parallel.dist import (
    all_reduce_grads,
    any_rank,
    barrier,
    initialize_multihost,
    is_main,
    launch,
    rank,
    rows,
    world,
)

__all__ = [
    "all_reduce_grads",
    "any_rank",
    "barrier",
    "broadcast_from_first",
    "gather_with_grad",
    "initialize_multihost",
    "is_main",
    "launch",
    "rank",
    "rows",
    "world",
]
