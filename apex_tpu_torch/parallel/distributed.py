"""Data-parallel gradient reduction over ``torch.distributed``.

Twin of ``apex_tpu/parallel/distributed.py`` (reference
``apex/parallel/distributed.py``): ``DistributedDataParallel`` with the
reference's numeric policy and an explicit ``reduce_gradients(grads)``
after the backward, as in the JAX API, plus ``Reducer``,
``broadcast_params``, ``all_reduce_tree`` and ``all_gather_tree``.

``reduce_gradients`` is the reference's ``allreduce_bucket`` (:374-395):
optional fp32 cast, divide by ``gradient_predivide_factor``, all-reduce,
multiply by ``factor / n`` when averaging, cast back.  It reduces in
flat buckets of at most ``message_size`` elements, one dtype each
(``ops.flatten``), so a ResNet-50 step makes three all-reduces, not
161; the arithmetic is elementwise, so the result is the one a
leaf-by-leaf reduction gives.  The reference's autograd hooks and side
stream, which overlap the reduction with the backward, are not copied
(the JAX package drops them too): the reduction runs on the current
stream after the backward.

Without an initialized process group the world is this process: a
reduction is the identity apart from the policy's casts and scaling,
as an all-reduce over one rank is.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from apex_tpu_torch.ops.flatten import flatten, unflatten
from apex_tpu_torch.parallel.collectives import all_gather_g, pmean_g, \
    psum_g
from apex_tpu_torch.parallel.mesh import WORLD, ProcessGroup

Tree = Any


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _group(process_group: Optional[ProcessGroup]) -> ProcessGroup:
    return WORLD if process_group is None else process_group


def all_reduce_tree(tree: Tree, process_group=None, *,
                    average: bool = False) -> Tree:
    """Sum (or mean) of every leaf over the group, as new tensors."""
    pg = _group(process_group)
    if not _initialized():
        return pytree.tree_map(torch.clone, tree)
    op = pmean_g if average else psum_g
    with torch.no_grad():
        return pytree.tree_map(lambda x: op(x, pg), tree)


def all_gather_tree(tree: Tree, process_group=None, *, axis: int = 0,
                    tiled: bool = False) -> Tree:
    """Every rank's leaf, in group order, stacked on ``axis`` (or
    concatenated along it with ``tiled``)."""
    pg = _group(process_group)
    if not _initialized():
        return pytree.tree_map(
            lambda x: x.clone() if tiled else x.unsqueeze(axis), tree)
    return pytree.tree_map(
        lambda x: all_gather_g(x, pg, axis=axis, tiled=tiled), tree)


def broadcast_params(params: Tree, process_group=None, src: int = 0) -> Tree:
    """Every rank's params set to those of the ``src``-th member of its
    group (the reference's construction-time broadcast, :237), as new
    tensors."""
    pg = _group(process_group)
    initialized = _initialized()
    root = pg.members()[src] if initialized else None

    def one(x):
        out = x.detach().clone()
        if initialized:
            dist.broadcast(out, src=root, group=pg.handle)
        return out.requires_grad_(x.requires_grad)

    return pytree.tree_map(one, params)


class Reducer:
    """Manual averaging (the reference's ``Reducer``, :89): no hooks; call
    ``reduce(tree)`` when the tensors are ready."""

    def __init__(self, process_group: Optional[ProcessGroup] = None):
        self.process_group = _group(process_group)

    def reduce(self, tree: Tree) -> Tree:
        return all_reduce_tree(tree, self.process_group, average=True)


def _buckets(leaves: List[torch.Tensor], dtypes, message_size: int):
    """Leaf indices grouped by reduction dtype, in order, each group cut
    into runs of at most ``message_size`` elements (a leaf larger than
    that is a run of its own)."""
    by_dtype = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)
    out = []
    for dt, idx in by_dtype.items():
        run, size = [], 0
        for i in idx:
            n = leaves[i].numel()
            if run and size + n > message_size:
                out.append((dt, run))
                run, size = [], 0
            run.append(i)
            size += n
        if run:
            out.append((dt, run))
    return out


class DistributedDataParallel:
    """Gradient averaging with apex's numeric options.

    ``module`` may be an ``amp.AmpModel`` or None (the reduction API
    alone); ``init`` and ``apply`` pass through to it.
    ``message_size`` is the bucket size in elements.  The reference's
    overlap options (``delay_allreduce`` and the rest) are not taken:
    the reduction always runs after the backward."""

    def __init__(self, module=None, message_size: int = 10000000,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 process_group: Optional[ProcessGroup] = None):
        self.module = module
        self.message_size = int(message_size)
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.process_group = _group(process_group)

    def init(self, *args, **kwargs):
        return self.module.init(*args, **kwargs)

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)

    @property
    def unwrapped(self):
        return self.module

    def reduce_gradients(self, grads: Tree) -> Tree:
        """Every rank's ``grads`` replaced by their reduction over the
        group: fp32 cast (``allreduce_always_fp32``), ``/ factor``,
        all-reduce, ``* factor / n`` (``gradient_average``), cast back.
        Returns a new tree; leaves are views of the bucket buffers."""
        leaves, spec = pytree.tree_flatten(grads)
        if not leaves:
            return grads
        f = self.gradient_predivide_factor
        n = self.process_group.size() if _initialized() else 1
        dtypes = [torch.float32 if self.allreduce_always_fp32 else x.dtype
                  for x in leaves]
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        with torch.no_grad():
            for dt, run in _buckets(leaves, dtypes, self.message_size):
                flat, fspec = flatten([leaves[i] for i in run], dtype=dt)
                if f != 1.0:
                    flat.div_(f)
                if n > 1:
                    dist.all_reduce(flat, group=self.process_group.handle)
                if self.gradient_average:
                    flat.mul_(f / n)
                for i, piece in zip(run, unflatten(flat, fspec)):
                    out[i] = piece
        return pytree.tree_unflatten(out, spec)

    def broadcast_params(self, params: Tree, src: int = 0) -> Tree:
        return broadcast_params(params, self.process_group, src=src)
