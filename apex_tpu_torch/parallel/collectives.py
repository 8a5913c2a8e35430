"""Collectives over a process group.

Twin of ``apex_tpu/parallel/collectives.py`` (``psum_g``, ``pmean_g``,
``all_gather_g``) on ``torch.distributed``.  ``psum_g`` and ``pmean_g``
are differentiable: the gradient of a sum over ranks is the sum over
ranks of the gradients (the transpose of a psum is a psum), which is
what SyncBatchNorm's backward needs, where each rank holds a part of
the batch.  ``all_gather_g`` is not differentiable.

Tensor parallelism needs the other pair, Megatron's ``f`` and ``g``:
the activations a TP group's ranks hold are replicated, so the
downstream gradient is already the same on every rank and a psum in
the backward would multiply it by the group's size.
:func:`copy_to_group` is the identity forward and a sum in the
backward (in front of a column-parallel product);
:func:`reduce_from_group` a sum forward and the identity backward
(after a row-parallel product); :func:`gather_from_group` concatenates
a column-parallel output over the group and keeps this rank's slice of
the gradient.  On GSPMD the JAX package gets all three from the
partitioner.

:func:`pmax_g` reduces a flag or a max on the device (no host sync on
NCCL).  :func:`all_gather_flat` and :func:`reduce_scatter_flat` are the
tiled dim-0 collectives ZeRO moves its shards with.  Sequence
parallelism (``parallel.sequence``) needs three more:
:func:`ppermute_g`, the ring step (``lax.ppermute`` by a shift; its
backward the inverse shift), :func:`all_to_all_g`, the tiled swap of
``lax.all_to_all(..., tiled=True)`` (its backward the reverse swap),
and :func:`all_gather_g` with ``tiled`` for the key mask.  Their form
is chosen by the group's backend name, never by trying one:

- ``nccl``: ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``batch_isend_irecv``, ``all_to_all_single`` on a contiguous
  buffer of the chunks, ``all_gather``;
- any other (gloo): every gather, the ring step and the swap as one
  ``broadcast`` per rank of what it sends (each rank keeps what is
  its own), the reduce-scatter as an ``all_reduce`` of the whole
  buffer and a slice of it (gloo has no all-gather, reduce-scatter,
  all-to-all or send/recv for CUDA tensors; it has ``broadcast`` and
  ``all_reduce``).

Without an initialized process group every collective is the identity
(a world of one process).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import WORLD, ProcessGroup


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


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
    (concatenated along it with ``tiled``); not differentiable.  NCCL:
    ``all_gather``; other backends: one ``broadcast`` per rank."""
    group = group or WORLD
    if not _initialized():
        parts = [x]
    else:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size())]
        if _native(group):
            dist.all_gather(parts, x, group=group.handle)
        else:
            for i, src in enumerate(group.members()):
                if src == dist.get_rank():
                    parts[i] = x
                dist.broadcast(parts[i], src=src, group=group.handle)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, handle):
        ctx.handle = handle
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.handle)
        return out, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, handle):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=handle)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is, its gradient summed over
    ``group`` (a column-parallel layer's input)."""
    if not _initialized():
        return x
    return _CopyToGroup.apply(x, group.handle)


def reduce_from_group(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """Megatron's ``g``: the sum of ``x`` over ``group``, its gradient
    passed through as it is (a row-parallel layer's output)."""
    if not _initialized():
        return x
    return _ReduceFromGroup.apply(x, group.handle)


class _GatherFromGroup(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``axis``; the backward keeps
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.rank, ctx.size, ctx.axis = group.rank(), x.shape[axis], axis
        return all_gather_g(x, group, axis=axis, tiled=True)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.axis, ctx.rank * ctx.size, ctx.size), None, \
            None


def gather_from_group(x: torch.Tensor, group: ProcessGroup,
                      axis: int = -1) -> torch.Tensor:
    """Megatron's gather of a column-parallel output: the ranks' ``x``
    concatenated along ``axis`` in group order, whose gradient is this
    rank's slice of the cotangent (every rank computes the same
    replicated function of the gathered tensor, so its slice is the true
    gradient of its part); ``x`` itself without a process group."""
    if group is None or not _initialized():
        return x
    return _GatherFromGroup.apply(x, group, axis % x.dim())


def pmax_g(x: torch.Tensor,
           group: Optional[ProcessGroup] = None) -> torch.Tensor:
    """Elementwise max of ``x`` over ``group``, as a new tensor on the
    device (bools reduce as int32 and come back bool); not
    differentiable."""
    if not _initialized():
        return x.clone()
    work = x.detach().to(torch.int32) if x.dtype == torch.bool \
        else x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(work, op=dist.ReduceOp.MAX,
                    group=(group or WORLD).handle)
    return work.bool() if x.dtype == torch.bool else work


def _native(group: ProcessGroup) -> bool:
    return group.backend() == "nccl"


def all_gather_flat(x: torch.Tensor, group: ProcessGroup,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group order, into
    ``out`` when given (contiguous, ``n`` times ``x``'s rows).  ``x`` may
    be this rank's own slice of ``out`` (the gather is then in place).
    NCCL: ``all_gather_into_tensor``; other backends: one ``broadcast``
    per rank of its slice."""
    n = group.size() if _initialized() else 1
    if out is None:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    rows = x.shape[0]
    if not _initialized():
        if out.data_ptr() != x.data_ptr():
            out.copy_(x)
        return out
    mine = out[group.rank() * rows:(group.rank() + 1) * rows]
    if mine.data_ptr() != x.data_ptr():
        mine.copy_(x)
    if _native(group):
        dist.all_gather_into_tensor(out, mine, group=group.handle)
        return out
    for i, src in enumerate(group.members()):
        dist.broadcast(out[i * rows:(i + 1) * rows], src=src,
                       group=group.handle)
    return out


def reduce_scatter_flat(x: torch.Tensor,
                        group: ProcessGroup) -> torch.Tensor:
    """This rank's 1/n of the sum of ``x`` over ``group``, cut along dim
    0 in group order (``x``'s rows divide by n).  NCCL:
    ``reduce_scatter_tensor`` (the full sum is never formed); other
    backends: an ``all_reduce`` of a copy of ``x``, then this rank's
    slice of it."""
    if not _initialized():
        return x.clone()
    n, r = group.size(), group.rank()
    rows = x.shape[0] // n
    if rows * n != x.shape[0]:
        raise ValueError(f"reduce_scatter_flat: {x.shape[0]} rows do not "
                         f"divide over {n} ranks")
    if _native(group):
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group.handle)
        return out
    work = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(work, group=group.handle)
    return work[r * rows:(r + 1) * rows]


def _ppermute(x: torch.Tensor, group: ProcessGroup, shift: int
              ) -> torch.Tensor:
    n, r = group.size(), group.rank()
    members = group.members()
    x = x.contiguous()
    if shift % n == 0:
        return x.clone()
    if _native(group):
        out = torch.empty_like(x)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, members[(r + shift) % n],
                           group=group.handle),
                dist.P2POp(dist.irecv, out, members[(r - shift) % n],
                           group=group.handle)]):
            work.wait()
        return out
    keep = (r - shift) % n
    out = None
    for i, src in enumerate(members):
        buf = x if i == r else torch.empty_like(x)
        dist.broadcast(buf, src=src, group=group.handle)
        if i == keep:
            out = buf
    return out


class _PPermute(torch.autograd.Function):
    """Each rank's ``x`` to the rank ``shift`` after it in the group;
    the backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _PPermute.apply(grad, ctx.group, -ctx.shift), None, None


def ppermute_g(x: torch.Tensor, group: ProcessGroup,
               shift: int = 1) -> torch.Tensor:
    """The ring step: rank i of ``group`` sends ``x`` to rank ``(i +
    shift) % n`` and returns what rank ``(i - shift) % n`` sent
    (``lax.ppermute`` with the pairs ``(i, (i + shift) % n)``);
    differentiable, its backward the inverse shift.  NCCL: one
    ``batch_isend_irecv``; other backends: a ``broadcast`` per rank."""
    if not _initialized():
        return x
    return _PPermute.apply(x, group, int(shift))


def _shift(x: torch.Tensor, group: ProcessGroup, shift: int,
           senders=None) -> torch.Tensor:
    """The hop's pairs ``(i, i + shift)`` that fit in the group; with
    ``senders`` (group indices) only the pairs whose sender is in it, so
    a rank whose source does not send gets zeros and a rank that does
    not send takes part only as a receiver (``x`` its buffer's
    template)."""
    n, r = group.size(), group.rank()
    members = group.members()
    x = x.contiguous()
    src, dst = r - shift, r + shift

    def sends(i):
        return 0 <= i + shift < n and (senders is None or i in senders)
    if _native(group):
        ops = []
        if sends(r):
            ops.append(dist.P2POp(dist.isend, x, members[dst],
                                  group=group.handle))
        out = torch.zeros_like(x)
        if 0 <= src < n and sends(src):
            ops.append(dist.P2POp(dist.irecv, out, members[src],
                                  group=group.handle))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out
    out = None
    for i, member in enumerate(members):
        if not sends(i):
            continue            # rank i sends to no one: no broadcast
        buf = x if i == r else torch.empty_like(x)
        dist.broadcast(buf, src=member, group=group.handle)
        if i == src:
            out = buf
    return torch.zeros_like(x) if out is None else out


class _Shift(torch.autograd.Function):
    """Each rank's ``x`` to the rank ``shift`` after it, if there is one;
    the backward sends the gradients back the same way."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _Shift.apply(grad, ctx.group, -ctx.shift), None, None


def shift_g(x: torch.Tensor, group: ProcessGroup,
            shift: int = 1) -> torch.Tensor:
    """The pipeline's hop: rank i of ``group`` sends ``x`` to rank ``i +
    shift`` when that rank exists and returns what rank ``i - shift``
    sent, or zeros where there is no such rank (``lax.ppermute`` with
    the pairs ``(i, i + shift)`` that fit in the group, no wrap-around);
    differentiable, its backward the reverse shift.  Every rank of the
    group must call it, with a tensor of the same shape and dtype.
    NCCL: one ``batch_isend_irecv`` of the pairs that exist; other
    backends: a ``broadcast`` per sending rank."""
    if not _initialized():
        return torch.zeros_like(x) if shift else x
    return _Shift.apply(x, group, int(shift))


def _all_to_all(x: torch.Tensor, group: ProcessGroup, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n, r = group.size(), group.rank()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all_g: dim {split_dim} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    # chunk j (for rank j) leads: one contiguous buffer of n chunks
    send = torch.stack(x.chunk(n, dim=split_dim))
    if _native(group):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group.handle)
        parts = recv.unbind(0)
    else:
        parts = []
        for i, src in enumerate(group.members()):
            buf = send if i == r else torch.empty_like(send)
            dist.broadcast(buf, src=src, group=group.handle)
            parts.append(buf[r].clone() if i != r else send[r])
    return torch.cat(parts, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """The tiled swap; the backward swaps back."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _AllToAll.apply(grad, ctx.group, concat_dim, split_dim), \
            None, None, None


def all_to_all_g(x: torch.Tensor, group: ProcessGroup, split_dim: int,
                 concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``x`` cut into n chunks along ``split_dim``, chunk j
    sent to rank j, and the chunks received concatenated along
    ``concat_dim`` in group order; differentiable, its backward the
    reverse swap.  NCCL: ``all_to_all_single`` on the stacked chunks;
    other backends: a ``broadcast`` per rank of its stacked chunks."""
    if not _initialized():
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(),
                           concat_dim % x.dim())
