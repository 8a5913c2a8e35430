"""ZeRO-1 and ZeRO-2: the optimizer state sharded over the data ranks.

Twin of ``apex_tpu/parallel/zero.py``.  On the TPU, ZeRO-1 is placement:
the JAX package places the optimizer state's large leaves sharded over
the data axis and GSPMD runs the update shard-local with the
collectives it needs.  PyTorch has no partitioner, so here the state
holds this rank's slices and the steps move the shards themselves:

- :func:`shard_optimizer_state` cuts this rank's part of each large
  leaf: a flat ``FusedAdam`` state's ``m`` and ``v`` on dim 0 (its
  master buffer ``p`` stays whole: the params are views of it), a
  per-leaf moment tree's leaves (``optimizers.transforms``' SGD
  momentum, optax-style Adam, ``FusedAdam(layout="tree")``) on their
  first dimension that divides over the ranks, at least ``n * 128``
  elements; everything else, the step counters and loss scales
  included, stays replicated.
- ``like_params`` (``{name: tensor_parallel.Place}``, e.g. a TP
  model's ``tp_places()``): the tree layout's moments of
  tensor-parallel params, as the JAX package's ``like_params`` places
  them.  A leaf is read in the JAX layout
  (``tensor_parallel.jax_view``: a ``Linear``'s weight transposed, a
  dim of heads as (heads, head_dim)), keeps its model split, and
  shards over the data ranks on the first still-free dim of that
  view that divides, if the full (unsplit) tensor holds at least ``n
  * 128`` elements.  The shard is that view's slice, made contiguous
  once here: each rank's moment shard is the JAX placement's device
  shard as it is.
- ZeRO-1, the update after the usual all-reduce of the gradients:
  ``FusedAdam.with_zero`` runs B1 on this rank's slice of the flat
  buffers and all-gathers the fresh slice into the flat ``p``; over
  the tree layout, B1-multi steps each leaf's moment shard with
  contiguous copies of its param's and gradient's slices, and the
  fresh slices are all-gathered (one flat gather) into the params;
  ``AmpOptimizer.with_zero`` over an optax-style optimizer runs its
  update on each sharded leaf's slice (:func:`zero1_update`) and
  gathers the parameters back.
- ZeRO-2, :func:`zero2_update`: the local (unreduced) gradients are
  reduce-scattered straight into this rank's shard, B1 updates it and
  the parameters are all-gathered.
- :func:`unshard_optimizer_state` gathers a sharded state back to its
  full shapes (for checkpoints).

The collectives are ``parallel.all_gather_flat`` and
``reduce_scatter_flat``, whose form follows the group's backend (NCCL's
own collectives; on gloo a broadcast per rank, and an all-reduce then a
slice).  A flat buffer shards when its length divides by the ranks into
slices whose length divides by 4 (B1's 16-byte accesses) and it holds
at least ``min_shard_elems``; else it takes the replicated update, as
the JAX package's kernel takes its jnp update.

A ``FusedLAMBState``'s per-leaf ``m`` and ``v`` shard as the tree
layout's moments do (``like_params`` included: a TP model's or a
pipelined one's ``tp_places()``, whose stage leaves count the pipe ranks
their JAX stack spans); ``FusedLAMB.with_zero`` then runs LAMB's
update on each rank's slices, its trust-ratio norms summed over the
data group, and gathers the params.  ZeRO-2 takes a flat-layout
``FusedAdam`` only, as the JAX package's ``zero2_update``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from apex_tpu_torch.ops.flatten import flatten_like
from apex_tpu_torch.parallel.collectives import all_gather_flat, \
    reduce_scatter_flat
from apex_tpu_torch.parallel.mesh import ProcessGroup
from apex_tpu_torch.parallel.tensor_parallel import Place, jax_view

Tree = Any

# the smallest leaf a rank's share makes worth sharding, per rank: the
# JAX package's one lane-width tile a device
MIN_SHARD_PER_RANK = 128


def group_place(group: ProcessGroup):
    """``(n, rank)`` in ``group``; ``(1, 0)`` without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return group.size(), group.rank()


def min_shard(group: ProcessGroup, min_shard_elems: Optional[int]) -> int:
    n, _ = group_place(group)
    return n * MIN_SHARD_PER_RANK if min_shard_elems is None \
        else int(min_shard_elems)


def flat_shard_len(total: int, n: int, min_shard_elems: int
                   ) -> Optional[int]:
    """The length of each rank's slice of a flat buffer of ``total``
    elements over ``n`` ranks, or None where it stays replicated (it
    does not divide, is under ``min_shard_elems``, or its slices would
    not be whole float4s for B1)."""
    if total < min_shard_elems or total % n or (total // n) % 4:
        return None
    return total // n


def leaf_shard_dim(shape: Sequence[int], n: int,
                   min_shard_elems: int) -> Optional[int]:
    """The dim a per-leaf state tensor of ``shape`` shards on: its first
    that divides over ``n`` ranks, if it holds ``min_shard_elems``; None
    where it stays replicated (the JAX package's rule)."""
    numel = 1
    for s in shape:
        numel *= s
    if numel < min_shard_elems:
        return None
    for d, size in enumerate(shape):
        if size >= n and size % n == 0:
            return d
    return None


def view_shard_dim(x: torch.Tensor, place: Place, n: int,
                   min_shard_elems: int):
    """``(view, dim)``: a tree-layout leaf in the JAX layout
    (``tensor_parallel.jax_view``) and the dim of that view its shard
    is cut on over ``n`` data ranks: the first dim its model split
    leaves free that divides, where the full tensor holds
    ``min_shard_elems``; ``dim`` None where the leaf stays replicated
    over the data ranks (the JAX package's ``like_params`` rule)."""
    view, spec = jax_view(x, place)
    if n == 1 or x.numel() * place.split < min_shard_elems:
        return view, None
    for d, (size, e) in enumerate(zip(view.shape, spec)):
        if e is None and size >= n and size % n == 0:
            return view, d
    return view, None


def tree_shard(x: torch.Tensor, place: Place, n: int, r: int,
               min_shard_elems: int):
    """``(view, dim, shard)``: this rank's shard of a tree-layout leaf
    (:func:`view_shard_dim`) as a view of ``x``; ``shard`` is ``view``
    itself where the leaf stays whole."""
    view, d = view_shard_dim(x, place, n, min_shard_elems)
    return view, d, _narrow(view, d, n, r)


def _narrow(x: torch.Tensor, d: Optional[int], n: int, r: int):
    if d is None:
        return x
    k = x.shape[d] // n
    return x.narrow(d, r * k, k)


def _is_adam_state(x) -> bool:
    from apex_tpu_torch.optimizers.fused_adam import FusedAdamState
    return isinstance(x, FusedAdamState)


def _is_fused_state(x) -> bool:
    """A ``FusedAdamState`` or a ``FusedLAMBState``: states whose
    moments ``shard_optimizer_state`` cuts as a unit."""
    from apex_tpu_torch.optimizers.fused_lamb import FusedLAMBState
    return _is_adam_state(x) or isinstance(x, FusedLAMBState)


def _per_leaf_moments(x) -> bool:
    """A state whose ``m`` and ``v`` are trees like the params: a
    tree-layout ``FusedAdamState`` or a ``FusedLAMBState``."""
    return _is_fused_state(x) and getattr(x, "spec", None) is None


def shard_optimizer_state(state: Tree, group: ProcessGroup,
                          min_shard_elems: Optional[int] = None,
                          like_params=None) -> Tree:
    """``state`` with each large leaf replaced by this rank's slice of it
    over ``group`` (a new tensor); see the module docstring for which.
    ``min_shard_elems`` defaults to ``n * 128``, as in the JAX package,
    and must match what the optimizer's ``with_zero`` was given.
    ``like_params`` (``{name: Place}``) places the tree layout's
    moments of tensor-parallel params; a flat state ignores it, as in
    the JAX package."""
    n, r = group_place(group)
    least = min_shard(group, min_shard_elems)

    def adam(st):
        if _per_leaf_moments(st):
            from apex_tpu_torch.optimizers.param_groups import leaf_paths
            places = dict(like_params or {})

            def cut(tree):
                leaves, spec = pytree.tree_flatten(tree)
                out = []
                for name, x in zip(leaf_paths(tree), leaves):
                    _, d, shard = tree_shard(x, places.get(name, Place()),
                                             n, r, least)
                    out.append(x if d is None else shard.clone(
                        memory_format=torch.contiguous_format))
                return pytree.tree_unflatten(out, spec)
            return st._replace(m=cut(st.m), v=cut(st.v))
        k = flat_shard_len(st.m.shape[0], n, least)
        if k is None:
            return st
        return st._replace(m=st.m[r * k:(r + 1) * k].clone(),
                           v=st.v[r * k:(r + 1) * k].clone())

    def leaf(x):
        if _is_fused_state(x):
            return adam(x)
        if not isinstance(x, torch.Tensor):
            return x
        d = leaf_shard_dim(x.shape, n, least)
        return x if d is None else _narrow(x, d, n, r).clone(
            memory_format=torch.contiguous_format)

    return pytree.tree_map(leaf, state, is_leaf=_is_fused_state)


def unshard_optimizer_state(state: Tree, group: ProcessGroup,
                            like: Tree, like_params=None) -> Tree:
    """The full state from a sharded one: each leaf whose shape differs
    from ``like``'s (the unsharded state, or any tree of its structure
    with tensors of its shapes, e.g. on the ``meta`` device) is gathered
    over ``group`` along the dim where they differ.  A tree-layout
    ``FusedAdam`` state or a ``FusedLAMB`` state sharded with
    ``like_params`` needs the same ``like_params`` here.  Every rank of
    the group must call it."""
    if like_params is not None:
        return _unshard_places(state, group, like, like_params)
    leaves, spec = pytree.tree_flatten(state)
    like_leaves = pytree.tree_leaves(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"the state has {len(leaves)} leaves, like "
                         f"{len(like_leaves)}")
    sharded, dims = [], []
    for i, (x, ref) in enumerate(zip(leaves, like_leaves)):
        if isinstance(x, torch.Tensor) and x.shape != ref.shape:
            sharded.append(i)
            dims.append(next(d for d, (a, b) in
                             enumerate(zip(x.shape, ref.shape)) if a != b))
    full = _gather_leaves([leaves[i] for i in sharded], dims, group)
    for i, x in zip(sharded, full):
        leaves[i] = x
    return pytree.tree_unflatten(leaves, spec)


def _unshard_places(state, group, like, places):
    """:func:`unshard_optimizer_state` of tree-layout ``FusedAdam`` and
    ``FusedLAMB`` states sharded with ``like_params``."""
    from apex_tpu_torch.optimizers.param_groups import leaf_paths
    n, _ = group_place(group)
    least = min_shard(group, None)

    def whole(st, ref):
        if not _per_leaf_moments(st):
            return st

        def grow(tree, ref_tree):
            leaves, spec = pytree.tree_flatten(tree)
            dev = leaves[0].device
            fulls = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                     for x in pytree.tree_leaves(ref_tree)]
            views, dims, shards = [], [], []
            for name, full, x in zip(leaf_paths(ref_tree), fulls, leaves):
                view, d = view_shard_dim(full, places.get(name, Place()),
                                         n, least)
                if d is None:
                    full.copy_(x)
                else:
                    views.append(view)
                    dims.append(d)
                    shards.append(x)
            _gather_into(shards, views, dims, group)
            return pytree.tree_unflatten(fulls, spec)
        return st._replace(m=grow(st.m, ref.m), v=grow(st.v, ref.v))

    return pytree.tree_map(whole, state, like, is_leaf=_is_fused_state)


def _gather_into(shards: List[torch.Tensor], views: List[torch.Tensor],
                 dims: List[int], group: ProcessGroup) -> None:
    """Each rank's ``shards`` gathered over ``group`` into ``views`` (the
    full leaves, as views) along ``dims``: one flat all-gather a dtype."""
    for view, full in zip(views, _gather_leaves(shards, dims, group)):
        view.copy_(full)


def _gather_leaves(locals_: List[torch.Tensor], dims: List[int],
                   group: ProcessGroup) -> List[torch.Tensor]:
    """Each sharded leaf gathered along its dim: one flat all-gather a
    dtype."""
    n, _ = group_place(group)
    out: List[Optional[torch.Tensor]] = [None] * len(locals_)
    by_dtype = {}
    for i, x in enumerate(locals_):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([locals_[i].reshape(-1) for i in idx])
        full = all_gather_flat(flat, group).view(n, -1)
        off = 0
        for i in idx:
            x = locals_[i]
            c = x.numel()
            pieces = full[:, off:off + c].reshape((n,) + tuple(x.shape))
            out[i] = torch.cat(list(pieces.unbind(0)), dim=dims[i])
            off += c
    return out


def zero1_update(inner, params: Tree, grads: Tree, state: Tree,
                 group: ProcessGroup, keep: torch.Tensor,
                 min_shard_elems: Optional[int] = None):
    """ZeRO-1 for an optimizer in optax's protocol whose state
    :func:`shard_optimizer_state` sharded: the update runs on each
    sharded parameter's slice (the dim its moments shard on, read from
    the parameter's shape) and on the replicated ones whole, the
    overflow ``keep`` selects new or old values, and the sharded
    parameters are all-gathered.  ``grads`` are the reduced (full)
    gradients.  Returns ``(params, state)``; the update is elementwise,
    so the result is the replicated step's bit for bit."""
    from apex_tpu_torch.optimizers.transforms import apply_updates
    n, r = group_place(group)
    least = min_shard(group, min_shard_elems)
    p_leaves, treedef = pytree.tree_flatten(params)
    g_leaves = pytree.tree_leaves(grads)
    dims = [leaf_shard_dim(p.shape, n, least) for p in p_leaves]
    p_loc = [_narrow(p.detach(), d, n, r) for p, d in zip(p_leaves, dims)]
    g_loc = [_narrow(g, d, n, r) for g, d in zip(g_leaves, dims)]
    with torch.no_grad():
        updates, new_state = inner.update(
            pytree.tree_unflatten(g_loc, treedef), state,
            pytree.tree_unflatten(p_loc, treedef))
        new_loc = pytree.tree_leaves(apply_updates(
            pytree.tree_unflatten(p_loc, treedef), updates))
        new_loc = [torch.where(keep, a, b) for a, b in zip(new_loc, p_loc)]
        new_state = pytree.tree_map(lambda a, b: torch.where(keep, a, b),
                                    new_state, state)
        sharded = [i for i, d in enumerate(dims) if d is not None]
        full = _gather_leaves([new_loc[i] for i in sharded],
                              [dims[i] for i in sharded], group)
        for i, x in zip(sharded, full):
            new_loc[i] = x
    out = [x.requires_grad_(p.requires_grad)
           for x, p in zip(new_loc, p_leaves)]
    return pytree.tree_unflatten(out, treedef), new_state


def zero2_update(optimizer, params: Tree, grads: Tree, state,
                 group: ProcessGroup, *, average: bool = True, scale=1.0,
                 skip=None, grad_norm=None):
    """ZeRO-2 with a flat-layout ``FusedAdam``: this rank's LOCAL
    (unreduced) ``grads`` are reduce-scattered into its shard (times
    ``1 / n`` with ``average``, as ``DistributedDataParallel`` averages),
    B1 updates this rank's slice of the master buffer and its ``m``,
    ``v`` shard, and the fresh slices are all-gathered into the whole
    buffer.  ``state`` is a flat ``FusedAdamState`` sharded by
    :func:`shard_optimizer_state`; ``scale`` and ``skip`` are amp's
    loss scale and overflow flag (a skipped step keeps every bit);
    ``max_grad_norm`` clips by the norm of the reduced gradient, its
    square summed over the ranks' shards.  Returns ``(params, state)``,
    the params views of the buffer as ``FusedAdam.step`` returns them.
    At a world of two every reduced element is one sum of two addends,
    so the step equals DDP's all-reduce and ``FusedAdam.step`` bit for
    bit."""
    if getattr(optimizer, "layout", None) != "flat":
        raise ValueError(
            "zero2_update needs a flat-layout FusedAdam "
            f"(got layout={getattr(optimizer, 'layout', None)!r})")
    if optimizer.param_groups:
        raise NotImplementedError(
            "zero2_update v1 does not support param_groups (group "
            "bounds do not align with shard bounds); use ZeRO-1 "
            "(shard_optimizer_state) for grouped configs")
    if getattr(optimizer, "_zero", None) is not None:
        raise ValueError(
            "zero2_update is already shard-local over the ZeRO group — "
            "pass the plain optimizer, not optimizer.with_zero(...) "
            "(its ZeRO-1 update would shard the shard again)")
    from apex_tpu_torch.optimizers.fused_adam import _to_len
    n, r = group_place(group)
    p, spec = state.p, state.spec
    total, k = p.shape[0], state.m.shape[0]
    if k * n != total or k % 4:
        raise ValueError(
            f"zero2_update: m holds {k} of the buffer's {total} elements "
            f"over {n} ranks; shard the state with shard_optimizer_state")
    with torch.no_grad():
        if not optimizer._are_views(params, state):
            p.copy_(_to_len(flatten_like(params, spec, dtype=torch.float32),
                            total))
        g = _to_len(flatten_like(grads, spec, dtype=torch.float32), total)
        g_shard = reduce_scatter_flat(g, group)
        if average:
            g_shard = g_shard * (1.0 / n)
        keep, step = optimizer._keep_and_step(state, skip)
        lo = r * k

        def norm_of(start, size):
            # the reduced gradient's norm: this shard's part of the range
            # squared, summed over the ranks
            a, b = max(start - lo, 0), min(start + size - lo, k)

            def norm():
                piece = g_shard[a:max(a, b)]
                sq = torch.sum(piece * piece)
                if dist.is_initialized():
                    dist.all_reduce(sq, group=group.handle)
                return torch.sqrt(sq)
            return norm

        optimizer._step_flat_shard(p, g_shard, state, spec, step, scale, keep,
                                   norm_of, grad_norm, group, lo, k)
    new_state = state._replace(step=step)
    return optimizer.params(new_state), new_state
