"""Manual mixed-precision conversion helpers (legacy toolkit).

Twin of ``apex_tpu/fp16_utils/fp16util.py`` (reference
``apex/fp16_utils/fp16util.py``).  The reference mutates ``nn.Module``
objects in place; here, as in the JAX package, every helper is a
function over a parameter dict ``{dotted name: tensor}`` (a
``state_dict``, ``named_parameters`` or a gradient dict) that returns a
new one.  The default half dtype is bfloat16; fp16 works by passing
``dtype=torch.float16``.

The batchnorm-stays-fp32 rule (reference ``BN_convert_float`` :22,
``convert_module`` skipping ``_BatchNorm`` :65-66) is the name-pattern
policy shared with ``amp`` (``BATCHNORM_PATTERNS``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

from apex_tpu_torch.amp.model import BATCHNORM_PATTERNS, _path_matches, \
    applier, cast_tree
from apex_tpu_torch.ops.flatten import flatten, flatten_like, unflatten
from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm

Tree = Any

DEFAULT_HALF = torch.bfloat16


def tofp16(value, dtype=DEFAULT_HALF):
    """Cast the float tensors inside any nested container to the half
    dtype (the input stage of the reference's ``tofp16`` module,
    :7-19, as a function on batches and arguments)."""
    return applier(value, lambda x: x.to(dtype))


def BN_convert_float(variables: Dict[str, torch.Tensor]):
    """``variables`` with the float tensors on BatchNorm paths cast to
    fp32 and everything else untouched (reference ``BN_convert_float``
    :22-32: BatchNorm is numerically unstable in fp16)."""
    return {name: x.float() if x.is_floating_point()
            and _path_matches(name, BATCHNORM_PATTERNS) else x
            for name, x in variables.items()}


def convert_tree(variables: Dict[str, torch.Tensor], dtype):
    """Every float tensor (parameters and buffers alike) cast to
    ``dtype``: the reference's ``convert_module`` (:44-57) without the
    BatchNorm exemption."""
    return cast_tree(variables, dtype)


def convert_network(variables: Dict[str, torch.Tensor], dtype=DEFAULT_HALF):
    """BatchNorm-safe whole-network cast (reference ``convert_network``
    :60-71): float tensors go to ``dtype`` except those on BatchNorm
    paths, which stay as they are (fp32)."""
    return cast_tree(variables, dtype, except_patterns=BATCHNORM_PATTERNS)


def network_to_half(variables: Dict[str, torch.Tensor], dtype=DEFAULT_HALF):
    """Reference ``network_to_half`` (:35-41): BatchNorm-safe half
    conversion.  Input casting, a prepended ``tofp16`` layer there, is
    the caller's job here, or :class:`FP16Model`'s."""
    return convert_network(variables, dtype)


class FP16Model:
    """Half-precision wrapper around an ``nn.Module`` (reference
    ``FP16Model`` :73-87): ``init()`` gives the module's parameters
    converted BatchNorm-safely to the half dtype, ``apply(params, *args)``
    casts float inputs and runs the module on those parameters through
    ``torch.func.functional_call``."""

    def __init__(self, network: nn.Module, dtype=DEFAULT_HALF):
        self.network = network
        self.dtype = dtype

    def init(self) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            params = convert_network(
                {n: p.detach().clone()
                 for n, p in self.network.named_parameters()}, self.dtype)
        return {n: p.requires_grad_(p.is_floating_point())
                for n, p in params.items()}

    def apply(self, params: Dict[str, torch.Tensor], *args, **kwargs):
        args = tuple(tofp16(a, self.dtype) for a in args)
        kwargs = {k: tofp16(v, self.dtype) for k, v in kwargs.items()}
        return torch.func.functional_call(self.network, params, args, kwargs)

    def __call__(self, params, *args, **kwargs):
        return self.apply(params, *args, **kwargs)


def _fp32_copy(tree: Tree) -> Tree:
    return pytree.tree_map(
        lambda x: x.detach().to(torch.float32, copy=True), tree)


def prep_param_lists(params: Tree, flat_master: bool = False):
    """fp32 master copies of ``params`` (reference :90-133).

    Returns ``(model_params, master_params)``: ``model_params`` is the
    input unchanged, ``master_params`` an fp32 copy of the same tree, or
    with ``flat_master=True`` a pair ``(flat_fp32, FlatSpec)`` holding
    one contiguous buffer (mixed dtypes are promoted into it)."""
    if flat_master:
        return params, flatten(params, dtype=torch.float32)
    return params, _fp32_copy(params)


def model_grads_to_master_grads(model_grads: Tree, master_params=None,
                                flat_master: bool = False):
    """Model-layout gradients as fp32 master gradients (reference
    :136-155): a flat fp32 buffer in the layout of the ``(flat, spec)``
    masters with ``flat_master=True``, else an fp32 tree."""
    if flat_master:
        if master_params is None:
            raise ValueError(
                "flat_master=True needs the (flat, spec) master pair")
        _, spec = master_params
        return flatten_like(model_grads, spec, dtype=torch.float32)
    return _fp32_copy(model_grads)


def master_params_to_model_params(model_params: Tree, master_params,
                                  flat_master: bool = False) -> Tree:
    """The master values in the model's dtypes (reference :158-179),
    as a new tree: each master cast to its model tensor's dtype."""
    if flat_master:
        flat, spec = master_params
        return unflatten(flat, spec)
    return pytree.tree_map(lambda p, m: m.detach().to(p.dtype),
                           model_params, master_params)


def clip_grad_norm(grads: Tree, max_norm: float,
                   norm_type: float = 2.0) -> Tuple[Tree, torch.Tensor]:
    """Global-norm gradient clipping (the reference re-exports torch's
    ``clip_grad_norm``, :182-187; ``FP16_Optimizer.clip_master_grads``
    uses it).  Returns ``(clipped_grads, total_norm)``: the norm in
    fp32, the clip coefficient ``min(1, max_norm / (norm + 1e-6))`` on
    the device (no host sync), cast to each gradient's dtype."""
    leaves = pytree.tree_leaves(grads)
    if norm_type == float("inf"):
        total = torch.stack([g.float().abs().max() for g in leaves]).max()
    elif norm_type == 2.0:
        total = multi_tensor_l2norm(grads)
    else:
        p = float(norm_type)
        total = torch.stack([g.float().abs().pow(p).sum()
                             for g in leaves]).sum().pow(1.0 / p)
    coef = (torch.full_like(total, float(max_norm))
            / (total + 1e-6)).clamp_max(1.0)
    clipped = pytree.tree_map(lambda g: g * coef.to(g.dtype), grads)
    return clipped, total
