"""Multi-tensor ops with carried overflow flags.

Twin of ``apex_tpu/ops/multi_tensor.py`` (the TPU re-design of apex's
``amp_C`` multi-tensor kernels), plain PyTorch as the reference is plain
jnp.  Trees are nested dicts, lists and tuples of tensors
(``torch.utils._pytree``).  Semantics:

- ``multi_tensor_scale``: ``out = in * scale``; the overflow flag is set
  if any *scaled output* element is non-finite;
- ``multi_tensor_axpby``: ``out = a*x + b*y``; ``arg_to_check`` selects
  which input's non-finite values raise the flag (-1 both, 0 x, 1 y);
- ``multi_tensor_l2norm``: global L2 norm in fp32, optionally per tensor.

All arithmetic is fp32 whatever the input dtype.  The overflow flag is a
0-d bool tensor on the inputs' device: nothing here reads a value back to
the host, so an amp step stays free of device syncs.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

Tree = Any


def _any_flag(flags, device):
    if not flags:
        return torch.zeros((), dtype=torch.bool, device=device)
    return torch.stack(flags).any()


def _nonfinite(x32: torch.Tensor) -> torch.Tensor:
    return ~torch.isfinite(x32).all()


def _device(leaves):
    return leaves[0].device if leaves else torch.device("cpu")


def tree_any_nonfinite(tree: Tree) -> torch.Tensor:
    """True iff any floating leaf of ``tree`` holds a non-finite value
    (a 0-d device bool; integer and bool leaves cannot overflow)."""
    leaves = [x for x in pytree.tree_leaves(tree)
              if isinstance(x, torch.Tensor)]
    flags = [_nonfinite(x.float()) for x in leaves
             if x.is_floating_point() or x.is_complex()]
    return _any_flag(flags, _device(leaves))


def _dtype_leaves(out_dtype, n):
    if out_dtype is None or isinstance(out_dtype, torch.dtype):
        return [out_dtype] * n
    leaves = pytree.tree_leaves(out_dtype)
    if len(leaves) != n:
        raise ValueError(
            f"out_dtype tree has {len(leaves)} leaves; expected {n}")
    return leaves


def multi_tensor_scale(tree: Tree, scale, *, out_dtype=None):
    """``out = tree * scale`` with overflow detection on the fp32 scaled
    output.  Returns ``(out_tree, overflow)``.  ``out_dtype`` casts each
    output leaf (one dtype, or a tree of dtypes matching ``tree``)."""
    leaves, spec = pytree.tree_flatten(tree)
    dtypes = _dtype_leaves(out_dtype, len(leaves))
    outs, flags = [], []
    for x, dt in zip(leaves, dtypes):
        y32 = x.float() * scale
        flags.append(_nonfinite(y32))
        outs.append(y32.to(dt if dt is not None else x.dtype))
    return pytree.tree_unflatten(outs, spec), _any_flag(flags,
                                                        _device(leaves))


def multi_tensor_unscale(tree: Tree, scale, *, out_dtype=None):
    """``out = tree * (1 / scale)`` — the gradient unscale
    (``LossScaler.unscale``)."""
    if isinstance(scale, torch.Tensor):
        inv = torch.reciprocal(scale.float())
    else:
        inv = 1.0 / float(scale)
    return multi_tensor_scale(tree, inv, out_dtype=out_dtype)


def multi_tensor_axpby(a, x_tree: Tree, b, y_tree: Tree, *,
                       arg_to_check: int = -1, out_dtype=None):
    """``out = a*x + b*y`` leafwise in fp32; ``arg_to_check`` picks the
    overflow source (-1 both inputs, 0 ``x`` only, 1 ``y`` only).
    Output leaves take ``out_dtype`` or the promoted input dtype.
    Returns ``(out_tree, overflow)``."""
    if arg_to_check not in (-1, 0, 1):
        raise ValueError(f"arg_to_check must be -1, 0 or 1; got "
                         f"{arg_to_check}")
    x_leaves, spec = pytree.tree_flatten(x_tree)
    y_leaves, y_spec = pytree.tree_flatten(y_tree)
    if y_spec != spec:
        raise ValueError(f"x and y trees must have the same structure; got "
                         f"{spec} vs {y_spec}")
    outs, flags = [], []
    for x, y in zip(x_leaves, y_leaves):
        x32, y32 = x.float(), y.float()
        out32 = a * x32 + b * y32
        if arg_to_check == 0:
            flags.append(_nonfinite(x32))
        elif arg_to_check == 1:
            flags.append(_nonfinite(y32))
        else:
            flags.append(_nonfinite(x32) | _nonfinite(y32))
        dt = out_dtype if out_dtype is not None else torch.promote_types(
            x.dtype, y.dtype)
        outs.append(out32.to(dt))
    return pytree.tree_unflatten(outs, spec), _any_flag(flags,
                                                        _device(x_leaves))


def multi_tensor_l2norm(tree: Tree, *, per_tensor: bool = False):
    """Global L2 norm of all leaves in fp32; with ``per_tensor`` returns
    ``(norm, tree_of_per_leaf_norms)``."""
    leaves, spec = pytree.tree_flatten(tree)
    if not leaves:
        z = torch.zeros((), dtype=torch.float32)
        return (z, tree) if per_tensor else z
    sqs = [x.float().square().sum() for x in leaves]
    total = torch.stack(sqs).sum().sqrt()
    if not per_tensor:
        return total
    return total, pytree.tree_unflatten([s.sqrt() for s in sqs], spec)
