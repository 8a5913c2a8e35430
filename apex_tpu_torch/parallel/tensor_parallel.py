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

The Megatron blocks the tensor-parallel models share
(``models.GPTLMHeadModel(tp=)``, ``models.BertForPreTraining(tp=)`` and
the pipelined families' stages under ``tp_axis``): :class:`TPPlace`, a
layer's model group and its place in it; :class:`RowParallelLinear`;
:class:`VocabParallelEmbedding`; :func:`head_slice_dropout`, the default
attention's dropout on a rank's heads.  A column-parallel layer is a
plain ``nn.Linear`` of the rank's output features behind
``copy_to_group``; its output is gathered with ``gather_from_group``
where a whole tensor is needed (BERT's MLM logits).

:func:`pipeline_param_specs` is the pipelined models' placement: the
stage leaves' specs carry the pipe axis in front (the JAX layout stacks
the stages on a leading dim; a port rank holds its stage's row of it),
the embeddings' and heads' their plain specs.  :func:`model_grad_norm`
is the clipping norm of a model whose leaves are split over several
groups (TP inside the pipeline: the pipe and the model groups), each
replicated leaf counted once.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

import torch
import torch.distributed as dist

import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel.collectives import reduce_from_group
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
                 rules: Rules, *, num_heads: Optional[int] = None,
                 coords: Optional[Mapping[str, int]] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter of the full ``params`` (a
    ``{name: tensor}`` state dict), as new contiguous tensors; the slice
    of the rank at ``coords`` (axis -> index) when given, e.g. on a mesh
    of shapes only."""
    if coords is None:
        coords = {axis: mesh.index(axis) for axis in mesh.shape}
    specs = param_specs(params, mesh, rules, num_heads=num_heads)
    return {name: local_slice(x, specs[name], mesh.shape, coords)
            for name, x in params.items()}


def tp_slice(state_dict: Mapping[str, torch.Tensor], rules: Rules,
             num_heads: Optional[int], tp: int,
             tp_rank: int) -> Dict[str, torch.Tensor]:
    """Model rank ``tp_rank``'s slice of a full state dict (a dense
    model's or a pipeline rank's names) under ``rules`` at ``tp`` model
    ranks (:func:`shard_params`); as it is at ``tp`` 1."""
    if tp == 1:
        return dict(state_dict)
    return shard_params(state_dict, Mesh({"model": tp}), rules,
                        num_heads=num_heads, coords={"model": tp_rank})


@torch.no_grad()
def reset_seeded(module: torch.nn.Module, specs: Mapping[str, Tuple],
                 places: Mapping[str, "TPPlace"], seed: int,
                 std: float) -> None:
    """The dense model's initialization of ``module`` (a split rank under
    the dense model's names): from a CPU generator seeded ``seed``, each
    weight's full tensor drawn normal(``std``) in parameter order and
    this rank's slice under ``specs`` kept (``places`` maps each axis the
    specs name to this rank's place in its group), unit LayerNorm
    scales, zero biases; so a seed gives the dense model's weights,
    split."""
    gen = torch.Generator().manual_seed(int(seed))
    sizes = {axis: place.size for axis, place in places.items()}
    coords = {axis: place.rank for axis, place in places.items()}
    for name, p in module.named_parameters():
        if name.endswith("_ln.scale"):
            p.fill_(1.0)
        elif is_bias(name):
            p.zero_()
        else:
            spec = specs.get(name, ())
            shape = tuple(d * sizes[axis] if axis else d for d, axis in
                          zip(p.shape, spec + (None,) * p.dim()))
            full = torch.empty(shape, dtype=torch.float32).normal_(
                0.0, std, generator=gen)
            if spec:
                full = local_slice(full, spec, sizes, coords)
            p.copy_(full)


def is_bias(name: str) -> bool:
    """A bias leaf by its dotted name (``bias``, an MoE layer's
    ``experts_bias_in``/``experts_bias_out``): zero-initialized."""
    return "bias" in name.rsplit(".", 1)[-1]


def pipeline_param_specs(params: Mapping[str, torch.Tensor], mesh: Mesh,
                         rules: Rules, pipe_axis: str,
                         stage_key: str = "stages", *,
                         num_heads: Optional[int] = None) -> Dict[str, Tuple]:
    """``{dotted name: spec}`` of a pipelined model's parameters at their
    full (unsplit) per-stage shapes: the twin of the JAX package's
    ``pipeline_param_specs``.  A leaf under ``stage_key`` takes
    ``(pipe_axis, *spec)``, its rule's spec behind the pipe axis of the
    JAX layout's stacked stage dim (``(pipe_axis,)`` where no rule
    applies); every other leaf its plain :func:`param_specs` spec (``()``
    without a rule, and everything without ``rules``)."""
    prefix = stage_key + "."
    plain = param_specs(params, mesh, rules, num_heads=num_heads)
    return {name: (pipe_axis,) + spec if name.startswith(prefix) else spec
            for name, spec in plain.items()}


def model_grad_norm(grads: Mapping[str, torch.Tensor],
                    split: Mapping[str, Tuple[str, ...]],
                    groups: Mapping[str, ProcessGroup],
                    device) -> torch.Tensor:
    """The global L2 norm of a model whose leaves are split over several
    groups: ``split`` maps each dotted name to the axes (keys of
    ``groups``) its leaf is split over (each rank holds its own part)
    and is replicated over the others.  The squares of the leaves of one
    set of axes are summed on the rank, then over each of its groups in
    turn (one all-reduce a group, of the sums of every set holding it),
    so each replicated leaf counts once.  A fp32 0-d tensor on
    ``device``; no host sync."""
    axes = list(groups)
    sets = sorted({tuple(a for a in axes if a in split[name])
                   for name in grads} | {()})
    part = {s: [] for s in sets}
    for name, g in grads.items():
        part[tuple(a for a in axes if a in split[name])].append(
            torch.sum(g.float() * g.float()))
    sums = {s: torch.stack(t).sum() if t else torch.zeros((), device=device)
            for s, t in part.items()}
    if dist.is_available() and dist.is_initialized():
        for axis in axes:
            held = [s for s in sets if axis in s]
            if not held:
                continue
            work = torch.stack([sums[s] for s in held])
            dist.all_reduce(work, group=groups[axis].handle)
            sums.update(zip(held, work.unbind()))
    return torch.sqrt(torch.stack([sums[s] for s in sets]).sum())


def sum_over_groups(values: torch.Tensor,
                    masks: Mapping[str, torch.Tensor],
                    groups: Mapping[str, ProcessGroup]) -> torch.Tensor:
    """``values`` (one entry a leaf) with each entry summed over the
    groups whose ``masks`` (a bool vector a group) hold it: one
    all-reduce a group.  FusedLAMB's whole-leaf norms under TP and
    ZeRO."""
    if not (dist.is_available() and dist.is_initialized()):
        return values
    for axis, group in groups.items():
        mask = masks[axis]
        work = torch.where(mask, values, 0.0)
        dist.all_reduce(work, group=group.handle)
        values = torch.where(mask, work, values)
    return values


class TPPlace(NamedTuple):
    """A tensor-parallel layer's place: the model group, this rank's
    index in it and the group's size."""

    group: ProcessGroup
    rank: int
    size: int


def tp_place(group: Optional[ProcessGroup]) -> Optional[TPPlace]:
    """The :class:`TPPlace` of this rank in ``group``; None for None."""
    if group is None:
        return None
    if not dist.is_initialized():
        raise RuntimeError("a tensor-parallel model needs an initialized "
                           "process group")
    return TPPlace(group, group.rank(), group.size())


class RowParallelLinear(nn.Module):
    """``y = sum over the model group of (x_local @ W_local^T) + b``:
    ``weight`` is this rank's (out, in / n) columns, ``bias`` the whole
    (out,) vector, added once after the sum (adding it on every rank
    before the sum would count it n times)."""

    def __init__(self, in_local: int, out_features: int, tp: TPPlace, *,
                 device, dtype):
        super().__init__()
        self.tp = tp
        self.weight = nn.Parameter(torch.empty(out_features, in_local,
                                               device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return reduce_from_group(F.linear(x, self.weight),
                                 self.tp.group) + self.bias


class VocabParallelEmbedding(nn.Module):
    """The embedding's rows ``[rank * V/n, (rank + 1) * V/n)``: ids
    outside them look up zeros, and the sum over the model group gives
    every rank the whole lookup."""

    def __init__(self, rows_local: int, dim: int, tp: TPPlace, *, device,
                 dtype):
        super().__init__()
        self.tp = tp
        self.start = tp.rank * rows_local
        self.weight = nn.Parameter(torch.empty(rows_local, dim,
                                               device=device, dtype=dtype))

    def forward(self, ids):
        local = ids - self.start
        valid = (local >= 0) & (local < self.weight.shape[0])
        emb = F.embedding(torch.where(valid, local, 0), self.weight)
        emb = torch.where(valid[..., None], emb, 0.0)
        return reduce_from_group(emb, self.tp.group)


def head_slice_dropout(dropout, scope, tp: TPPlace, heads: int):
    """The default attention's ``dropout_fn`` on a TP rank: the dense
    model's draw over the full (B, heads, S, S) probs, this rank's heads
    kept (flax's ``Dropout_0`` at the attention's scope; ``dropout`` a
    ``threefry.Dropout``, ``scope`` a ``threefry.RngScope``)."""
    from apex_tpu_torch.ops import threefry
    drop = scope.push("Dropout_0")
    keep_prob = 1.0 - dropout.rate

    def dropout_fn(p):
        b, hl = p.shape[:2]
        keep = threefry.bernoulli(drop.make_rng(), keep_prob,
                                  (b, heads) + tuple(p.shape[2:]), p.device)
        keep = keep[:, tp.rank * hl:(tp.rank + 1) * hl]
        div = torch.full((), keep_prob, dtype=p.dtype, device=p.device)
        return torch.where(keep, p / div, torch.zeros((), dtype=p.dtype,
                                                      device=p.device))

    return dropout_fn
