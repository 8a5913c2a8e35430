"""Megatron tensor parallelism: the param-sharding rules and the split.

Twin of ``apex_tpu/parallel/tensor_parallel.py``.  On the TPU the rules
are all there is: the JAX package places the weights sharded over a
``"model"`` mesh axis and XLA's SPMD partitioner runs each product
shard-local and inserts the collectives.  PyTorch has no partitioner,
so here the rules pick each parameter's split, :func:`shard_params`
cuts this rank's slice of a full state dict, and the model builds the
sharded layers with their collectives itself
(``models.GPTLMHeadModel(..., tp=<model group>)``, over
``parallel.copy_to_group`` / ``reduce_from_group``).

A rule is ``(regex, spec)``: the regex searches a parameter's dotted
name, the spec names per dimension the mesh axis it splits over or
``None``.  The rules are written for the port's names and
``nn.Linear``'s (out, in) layout, so the JAX kernel ``(H, heads, hd)``
split on ``heads`` is ``attention.query.weight`` split on dim 0, and
``attention/output/kernel (heads, hd, H)`` is ``attention.output.weight``
split on dim 1.  A dim that holds whole attention heads is split as
``Heads(axis)``: it divides when the head count does (the JAX kernel's
heads dim), which :func:`param_specs` reads from ``num_heads``.

The first rule whose regex matches decides: its spec if it divides the
shape, else the parameter stays replicated (``()``).  A spec of more
dims than the parameter, or one naming an axis the mesh lacks, raises.

:func:`param_places` says how each local parameter reads in the JAX
package's layout (a ``Linear``'s weight transposed, a dim of heads as
(heads, head_dim)): ZeRO-1 shards a tensor-parallel leaf's moments over
the data ranks on the dim the JAX package's ``like_params`` picks.

Not here yet: ``pipeline_param_specs`` and BERT's sharded forward (both
come with pipeline parallelism; BERT's rules are here).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.mesh import Mesh, ProcessGroup


class Heads(NamedTuple):
    """A split over ``axis`` of a dim holding whole attention heads."""

    axis: str


Entry = Union[None, str, Heads]
Spec = Tuple[Entry, ...]
Rules = Sequence[Tuple[str, Spec]]


def bert_tp_rules(axis: str = "model") -> Rules:
    """Megatron's split for ``models.bert``: q/k/v column-parallel over
    heads, the attention output and the MLP's ``output`` row-parallel,
    ``intermediate`` column-parallel, the word embeddings and the MLM
    decoder over the vocab."""
    h = Heads(axis)
    return (
        (r"attention\.(query|key|value)\.weight$", (h, None)),
        (r"attention\.(query|key|value)\.bias$", (h,)),
        (r"attention\.output\.weight$", (None, h)),
        (r"intermediate\.weight$", (axis, None)),
        (r"intermediate\.bias$", (axis,)),
        (r"output\.weight$", (None, axis)),
        (r"word_embeddings\.weight$", (axis, None)),
        (r"mlm_decoder\.weight$", (axis, None)),
        (r"mlm_decoder\.bias$", (axis,)),
    )


BERT_TP_RULES = bert_tp_rules()


def gpt_tp_rules(axis: str = "model") -> Rules:
    """Megatron's split for ``models.gpt``: the attention as BERT's,
    ``mlp_in`` column- and ``mlp_out`` row-parallel, and the tied
    ``wte`` over its vocab rows (the lookup a masked local gather and a
    sum, the head a column-parallel product: each rank its vocab slice
    of the logits).  ``wpe`` stays replicated."""
    h = Heads(axis)
    return (
        (r"attention\.(query|key|value)\.weight$", (h, None)),
        (r"attention\.(query|key|value)\.bias$", (h,)),
        (r"attention\.output\.weight$", (None, h)),
        (r"mlp_in\.weight$", (axis, None)),
        (r"mlp_in\.bias$", (axis,)),
        (r"mlp_out\.weight$", (None, axis)),
        (r"wte\.weight$", (axis, None)),
    )


def _axis(entry: Entry) -> Optional[str]:
    return entry.axis if isinstance(entry, Heads) else entry


def _spec_fits(shape, spec: Spec, sizes: Mapping[str, int], rule_pat: str,
               num_heads: Optional[int]) -> bool:
    if len(spec) > len(shape):
        raise ValueError(
            f"TP rule {rule_pat!r} has a {len(spec)}-dim spec but matched "
            f"a rank-{len(shape)} param {tuple(shape)}")
    for dim, entry in zip(shape, spec):
        axis = _axis(entry)
        if axis is None:
            continue
        if axis not in sizes:
            raise ValueError(
                f"TP rule {rule_pat!r} names mesh axis {axis!r}, but the "
                f"mesh only has axes {tuple(sizes)}; build the mesh with "
                "that axis or use rules for yours (e.g. "
                "bert_tp_rules(axis=...))")
        n = sizes[axis]
        if isinstance(entry, Heads):
            if num_heads is None:
                raise ValueError(f"TP rule {rule_pat!r} splits attention "
                                 "heads: pass num_heads")
            if dim % num_heads or num_heads % n:
                return False
        elif dim % n:
            return False
    return True


def param_specs(params: Mapping[str, torch.Tensor], mesh: Mesh, rules: Rules,
                *, num_heads: Optional[int] = None,
                keep_heads: bool = False) -> Dict[str, Tuple]:
    """``{dotted name: spec}`` for ``params`` (a ``{name: tensor}``
    dict): per dim the axis it splits over or ``None``; ``()`` for a
    replicated parameter.  ``keep_heads`` keeps a ``Heads(axis)`` entry
    as it is (else its axis name)."""
    out = {}
    for name, x in params.items():
        out[name] = ()
        for pat, spec in rules:
            if re.search(pat, name):
                if _spec_fits(tuple(x.shape), spec, mesh.shape, pat,
                              num_heads):
                    out[name] = tuple(e if keep_heads else _axis(e)
                                      for e in spec)
                break
    return out


class Place(NamedTuple):
    """How a rank's local parameter reads in the JAX package's layout:
    ``spec`` its split (per dim None, an axis or ``Heads(axis)``),
    ``transposed`` for an ``nn.Linear``-style (out, in) weight (the JAX
    kernel is (in, out)), ``heads`` the heads a ``Heads`` dim holds on
    this rank, ``split`` the ranks the full tensor is cut over."""

    spec: Spec = ()
    transposed: bool = False
    heads: int = 0
    split: int = 1


def jax_view(x: torch.Tensor, place: Place):
    """``(view, spec)``: ``x`` as a view in the JAX package's layout (a
    transposed weight read back, a ``Heads`` dim unflattened to (heads,
    head_dim)) and the split of each of the view's dims."""
    spec = tuple(place.spec) + (None,) * (x.dim() - len(place.spec))
    if place.transposed:
        x, spec = x.t(), spec[::-1]
    for d, e in enumerate(spec):
        if isinstance(e, Heads):
            x = x.unflatten(d, (place.heads, -1))
            spec = spec[:d] + (e.axis, None) + spec[d + 1:]
            break
    return x, spec


def param_places(module: torch.nn.Module, specs: Mapping[str, Spec],
                 sizes: Mapping[str, int], num_heads: int
                 ) -> Dict[str, Place]:
    """``{dotted name: Place}`` for ``module``'s local parameters under
    ``specs`` (:func:`param_specs` with ``keep_heads``, read from the
    full model): every 2-D weight but an embedding table's is read
    transposed."""
    out = {}
    for name, p in module.named_parameters():
        spec = specs.get(name, ())
        owner = module.get_submodule(name.rpartition(".")[0])
        transposed = p.dim() == 2 and name.endswith("weight") \
            and not type(owner).__name__.endswith("Embedding")
        split, heads = 1, 0
        for e in spec:
            if e is not None:
                split *= sizes[_axis(e)]
            if isinstance(e, Heads):
                heads = num_heads // sizes[e.axis]
        out[name] = Place(spec, transposed, heads, split)
    return out


def local_slice(x: torch.Tensor, spec: Tuple, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The slice of the full ``x`` that the rank at ``coords`` (axis ->
    index) holds under ``spec``, as a new contiguous tensor."""
    for d, axis in enumerate(spec):
        if axis is not None:
            k = x.shape[d] // sizes[axis]
            x = x.narrow(d, coords[axis] * k, k)
    return x.clone(memory_format=torch.contiguous_format)


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 rules: Rules, *, num_heads: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter of the full ``params`` (a
    ``{name: tensor}`` state dict), as new contiguous tensors."""
    coords = {axis: mesh.index(axis) for axis in mesh.shape}
    specs = param_specs(params, mesh, rules, num_heads=num_heads)
    return {name: local_slice(x, specs[name], mesh.shape, coords)
            for name, x in params.items()}


def tp_grad_norm(grads: Mapping[str, torch.Tensor],
                 sharded: Mapping[str, bool], group: ProcessGroup,
                 device) -> torch.Tensor:
    """The global L2 norm of a TP rank's gradients: the sum of squares
    of the sharded leaves over ``group``, each replicated leaf counted
    once (a fp32 0-d tensor on ``device``; no host sync)."""
    def sq(keep):
        terms = [torch.sum(g.float() * g.float())
                 for name, g in grads.items() if sharded[name] == keep]
        return torch.stack(terms).sum() if terms \
            else torch.zeros((), device=device)

    part = sq(True)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(part, group=group.handle)
    return torch.sqrt(part + sq(False))
