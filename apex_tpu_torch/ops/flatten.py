"""Tree flatten/unflatten into contiguous 1-D buffers.

Twin of ``apex_tpu/ops/flatten.py``: a whole parameter tree (nested
dicts, lists and tuples of tensors, ``torch.utils._pytree`` order)
becomes one contiguous 1-D buffer, so a single kernel (FusedAdam's B1)
updates every parameter in one launch.  :func:`unflatten` returns
*views* of the buffer where no cast is needed, so the caller's tensors
and the buffer share memory and an in-place update of the buffer is an
update of every leaf.

:func:`flatten_grouped` lays the buffer out group by group (FusedAdam's
``param_groups``): each group's leaves are one contiguous slice, in
tree order within the group, and ``FlatSpec.perm`` and ``group_bounds``
record the layout; ``offsets`` stay indexed by tree position, so
:func:`unflatten` needs nothing else.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

Tree = Any


class FlatSpec(NamedTuple):
    """Metadata needed to invert :func:`flatten`.  ``perm`` is the
    buffer order of the leaves (empty: tree order, one implicit group),
    ``group_bounds`` each group's ``(start, size)`` slice."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]  # start offset of each leaf in the buffer
    total: int                # logical element count (without padding)
    perm: Tuple[int, ...] = ()
    group_bounds: Tuple[Tuple[int, int], ...] = ()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _pad_flat(flat: torch.Tensor, pad_to: int) -> torch.Tensor:
    """Zero-pad a 1-D buffer to a length that is a multiple of
    ``pad_to``."""
    if pad_to > 1 and flat.shape[0] % pad_to:
        extra = pad_to - flat.shape[0] % pad_to
        flat = torch.cat([flat, flat.new_zeros((extra,))])
    return flat


def _result_dtype(leaves):
    dt = leaves[0].dtype
    for x in leaves[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def flatten(tree: Tree, dtype=None, pad_to: int = 1):
    """Concatenate all leaves of ``tree`` into one 1-D tensor, cast to
    ``dtype`` (default: the promoted leaf dtype) and zero-padded to a
    multiple of ``pad_to`` (``spec.total`` stays the logical count).
    Returns ``(flat, spec)``."""
    leaves, treedef = pytree.tree_flatten(tree)
    if not leaves:
        return (torch.zeros((0,), dtype=dtype or torch.float32),
                FlatSpec(treedef, (), (), (), 0))
    if dtype is None:
        dtype = _result_dtype(leaves)
    shapes = tuple(tuple(x.shape) for x in leaves)
    offsets, total = [], 0
    for s in shapes:
        offsets.append(total)
        total += _numel(s)
    flat = _pad_flat(torch.cat([x.detach().to(dtype).reshape(-1)
                                for x in leaves]), pad_to)
    spec = FlatSpec(treedef, shapes, tuple(x.dtype for x in leaves),
                    tuple(offsets), total)
    return flat, spec


def flatten_grouped(tree: Tree, group_ids: Sequence[int], dtype=None,
                    pad_to: int = 1):
    """Like :func:`flatten`, but group by group: ``group_ids`` gives each
    leaf's group (tree order, groups numbered 0..max), and each group's
    leaves become one contiguous slice, in tree order within it.  Only
    the total is padded.  Returns ``(flat, spec)``."""
    leaves, treedef = pytree.tree_flatten(tree)
    if len(group_ids) != len(leaves):
        raise ValueError(f"{len(group_ids)} group ids for {len(leaves)} "
                         "leaves")
    if not leaves:
        return (torch.zeros((0,), dtype=dtype or torch.float32),
                FlatSpec(treedef, (), (), (), 0))
    if dtype is None:
        dtype = _result_dtype(leaves)
    perm = tuple(sorted(range(len(leaves)),
                        key=lambda i: (group_ids[i], i)))
    shapes = tuple(tuple(x.shape) for x in leaves)
    offsets = [0] * len(leaves)
    bounds, cursor = [], 0
    for g in range(max(group_ids) + 1):
        start = cursor
        for i in perm:
            if group_ids[i] == g:
                offsets[i] = cursor
                cursor += _numel(shapes[i])
        bounds.append((start, cursor - start))
    flat = _pad_flat(torch.cat([leaves[i].detach().to(dtype).reshape(-1)
                                for i in perm]), pad_to)
    spec = FlatSpec(treedef, shapes, tuple(x.dtype for x in leaves),
                    tuple(offsets), cursor, perm, tuple(bounds))
    return flat, spec


def flatten_like(tree: Tree, spec: FlatSpec, dtype=None,
                 pad_to: int = 1) -> torch.Tensor:
    """Flatten ``tree`` (with ``spec``'s structure) into a new 1-D buffer
    in ``spec``'s layout (grouped where it is), without rebuilding the
    spec."""
    leaves, treedef = pytree.tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError("tree does not match the spec's structure")
    if not leaves:
        return torch.zeros((0,), dtype=dtype or torch.float32)
    if dtype is None:
        dtype = _result_dtype(leaves)
    if spec.perm:
        leaves = [leaves[i] for i in spec.perm]
    return _pad_flat(torch.cat([x.detach().to(dtype).reshape(-1)
                                for x in leaves]), pad_to)


def unflatten(flat: torch.Tensor, spec: FlatSpec, *,
              cast_back: bool = True) -> Tree:
    """Invert :func:`flatten`: slice ``flat`` back into the original
    tree.  Leaves are views of ``flat``; with ``cast_back`` a leaf whose
    original dtype differs from the buffer's is cast (a copy)."""
    leaves = []
    for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.offsets):
        piece = flat[off:off + _numel(shape)].view(shape)
        leaves.append(piece.to(dt) if cast_back else piece)
    return pytree.tree_unflatten(leaves, spec.treedef)
