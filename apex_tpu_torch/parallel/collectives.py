"""Collectives over a process group.

Twin of ``apex_tpu/parallel/collectives.py`` (``psum_g``, ``pmean_g``,
``all_gather_g``) on ``torch.distributed``.  ``psum_g`` and ``pmean_g``
are differentiable: the gradient of a sum over ranks is the sum over
ranks of the gradients (the transpose of a psum is a psum), which is
what SyncBatchNorm's backward needs.  ``all_gather_g`` is not (gloo
has no all_gather of CUDA tensors, so nothing on the training path
gathers).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import WORLD, ProcessGroup


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the gradients."""

    @staticmethod
    def forward(ctx, x, handle):
        ctx.handle = handle
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=handle)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.handle), None


def psum_g(x: torch.Tensor,
           group: Optional[ProcessGroup] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (default: the world), as
    a new tensor; differentiable."""
    return _AllReduceSum.apply(x, (group or WORLD).handle)


def pmean_g(x: torch.Tensor,
            group: Optional[ProcessGroup] = None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group``; differentiable."""
    group = group or WORLD
    return psum_g(x, group) / group.size()


def all_gather_g(x: torch.Tensor, group: Optional[ProcessGroup] = None, *,
                 axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in group order, stacked on a new ``axis``
    (concatenated along it with ``tiled``)."""
    group = group or WORLD
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x.contiguous(), group=group.handle)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)
