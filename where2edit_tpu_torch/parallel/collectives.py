"""Differentiable collectives (counterpart of
where2edit_tpu/parallel/collectives.py).

``gather_with_grad`` is the reference's ``GatherLayer``
(utils.py:114-131) and JAX's ``lax.all_gather(tiled=True)``: the global
concat along dim 0, whose backward sums the incoming gradient over the
ranks and keeps this rank's rows (all_gather's transpose). The two
``autograd.Function``s below are each other's adjoint, so each backward is
itself differentiable: R1 differentiates through the discriminator's
gathered minibatch-stddev twice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from where2edit_tpu_torch.parallel.dist import in_group, rows, world


class _GatherRows(torch.autograd.Function):
    """x (b, ...) on each rank → (world·b, ...), rank order."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceRows.apply(grad)


class _ReduceRows(torch.autograd.Function):
    """y (world·b, ...) on each rank → this rank's rows of the sum of y over
    the ranks: the adjoint of ``_GatherRows``."""

    @staticmethod
    def forward(ctx, y):
        total = y.contiguous().clone()
        dist.all_reduce(total)
        return rows(total).clone()

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad)


def gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Differentiable (to any order) global concat along the batch dim; ``x``
    itself outside a group."""
    if not in_group():
        return x
    return _GatherRows.apply(x)


def broadcast_from_first(x: torch.Tensor) -> torch.Tensor:
    """dist.broadcast(src=0) (run_attention.py:1143,1212-1229): every rank
    gets rank 0's value (not differentiated)."""
    if not in_group():
        return x
    out = x.detach().contiguous().clone()
    dist.broadcast(out, src=0)
    return out
