"""BERT encoder for pretraining — the FusedLayerNorm + FusedLAMB workload.

Twin of ``apex_tpu/models/bert.py`` (``BertForPreTraining`` and what it
is built from): a post-LN transformer encoder on :class:`FusedLayerNorm`
(eps 1e-12), exact-erf ``gelu``, an untied MLM decoder with bias, a
``[CLS]`` tanh pooler and the NSP head.  One tensor per JAX leaf, named
as the flax modules are (``encoder.layer_0.attention.query.bias``,
``encoder.layer_0.attention_ln.scale``, ...): LAMB's trust ratio is per
tensor and the BERT recipe's ``(bias|_ln)`` regex picks the no-decay
leaves by name, so a fused or renamed leaf would change the update.
Projections are plain ``nn.Linear`` (the JAX package leaves them to
XLA).

Attention runs through ``attention_fn(q, k, v, bias, dropout_fn)``
(default :func:`dot_product_attention`; ``make_flash_attention()`` for
the fused kernels).  Dropout draws from flax's ``dropout`` rng stream as
the JAX model does: ``forward(..., deterministic=False,
dropout_key=key)`` takes the key that the JAX model takes as
``rngs={"dropout": key}`` (two uint32, e.g. ``threefry.PRNGKey(seed)``
or ``np.asarray(jax.random.PRNGKey(seed))``), and every draw is keyed
by its flax module path and call count (``ops/threefry.py``), so the
same key drops the same positions in both packages:

- hidden dropout (the embeddings' ``Dropout_0`` after their LN, and
  each layer's one ``Dropout_0``, called on the attention output and
  then on the MLP output, its count advancing between the two):
  :class:`~apex_tpu_torch.ops.threefry.Dropout` (flax's ``nn.Dropout``
  bit for bit, the ``threefry_dropout`` kernel on the card);
- attention dropout: with a custom ``attention_fn``, each layer's int32
  seed ``randint(make_rng("dropout"), (), 0, int32 max)`` at the
  attention's scope, handed over as ``dropout_fn.rate`` /
  ``.seed`` for the flash kernels (dropout inside the kernel); the
  encoder draws all layers' seeds on the host and moves them to the
  card in one ``non_blocking`` copy from pinned memory; the default
  attention applies ``dropout_fn`` (the attention's ``Dropout_0``) to
  its materialized probs.

The keys depend only on the step key, the paths and the counts, so
they are computed on the host: nothing syncs.

``BertConfig.remat`` rematerialises each encoder layer in the backward
(``models/_remat.py``: ``torch.utils.checkpoint``, non-reentrant), as
``nn.remat`` does in the JAX model; the recompute draws the forward's
dropout keys, so the gradients equal those without remat bit for bit.

Sequence parallelism (``BertForPreTraining(cfg, attention_fn, sp=<sp
group>)`` with ``parallel.make_ring_attention`` or
``make_ulysses_attention``): each rank holds its S/sp tokens through the
whole model.  Its embeddings take positions ``sp_rank * S_local +
arange(S_local)``, its ``attention_mask`` is its shard's (the ring
carries it with its K/V, Ulysses gathers it), the hidden dropouts draw
its window of the dense activation's threefry stream
(``threefry.window``), and the heads give its (B, S_local, V) MLM
logits; the NSP logits are the pooled ``[CLS]`` token's only on sequence
rank 0, where that token lives (the caller takes the NSP term there
alone).

Tensor parallelism (``BertForPreTraining(cfg, ..., tp=<model group>)``,
the twin of the JAX model under ``parallel.bert_tp_rules``): each rank
builds its local shapes under the dense model's names, from the shared
Megatron blocks of ``parallel.tensor_parallel``.  q/k/v and
``intermediate`` are column-parallel (``copy_to_group`` in front), the
attention ``output`` and the MLP's ``output`` row-parallel, the word
embeddings vocab-parallel, the MLM decoder column-parallel over the
vocabulary with its logits gathered over the group (so the forward
returns whole logits, as under GSPMD).  A split whose dim does not
divide leaves its leaves whole, as ``param_specs`` falls back
(:func:`tp_splits`).  Dropout draws the dense model's masks: the hidden
dropouts act on replicated activations, the attention's keep this
rank's heads (the default attention's whole draw sliced, the flash
kernels' hash at the global head index).

Pipeline parallelism: :class:`PipelinedBert` (one stage a rank of the
mesh's pipe axis, optionally with a sequence axis and a model axis
inside it) over the ``BertEmbeddings``/``BertStage``/``BertHeads``
split; :func:`dense_to_rank` maps a dense state dict to a rank's (with
``tp``, its Megatron slice).  HuggingFace checkpoints load through
``utils.load_hf_bert``.

Switch-MoE layers (``BertConfig.moe_experts`` above 0): each layer's
MLP is a :class:`~apex_tpu_torch.models.moe.MoEMlp` named ``moe`` in
place of ``intermediate``/``output``, as the JAX layer's.  The JAX model
sows each layer's load-balance aux into its ``"losses"`` collection;
the port has no ``sow``, so a model with MoE layers returns the sum over
its layers as one more output: ``BertForPreTraining`` gives ``(mlm, nsp,
aux)`` (the JAX ``PipelinedBert``'s convention), ``BertStage`` ``(x,
aux)``.  Remat checkpoints the layer with its aux.  Under TP the MoE
stays whole on every model rank (``bert_tp_rules`` match no MoE leaf).
``BertForPreTraining(..., ep=<group>)`` holds each layer's experts split
over the group (expert parallelism, ``models.moe``), and
``moe_aux_group``, the ranks that share a step, makes the MoE's batch
theirs: the aux's token fractions and the capacity dispatch's cap and
arrival order are the whole batch's (``MoEMlp``'s ``aux_group``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models._remat import remat as remat_layer
from apex_tpu_torch.models.moe import MoEMlp, ep_specs
from apex_tpu_torch.models.moe import params_from_jax as moe_params_from_jax
from apex_tpu_torch.models.pipelined_common import PipelinedCommon, \
    gather_seq, rank_state_dict
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.parallel.collectives import copy_to_group, \
    gather_from_group, pmean_g
from apex_tpu_torch.parallel import tensor_parallel as tpar
from apex_tpu_torch.parallel.mesh import ProcessGroup
from apex_tpu_torch.parallel.tensor_parallel import RowParallelLinear, \
    TPPlace, VocabParallelEmbedding, head_slice_dropout, tp_place


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # rematerialize each encoder layer in the backward (training only)
    remat: bool = False
    # >0: each layer's MLP is a Switch-MoE of this many experts
    # (models.MoEMlp), whose load-balance aux the model returns
    moe_experts: int = 0
    # "dense" (exact, E x FLOPs) or "capacity" (Switch gather/scatter)
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


def _scope(dropout_key) -> threefry.RngScope:
    """The flax scope of the ``dropout`` stream a module draws from: the
    root scope of a key, or the scope its parent hands down."""
    if dropout_key is None:
        raise ValueError("dropout (deterministic=False) needs a threefry "
                         "key: pass dropout_key=")
    return threefry.RngScope.of(dropout_key)


def dot_product_attention(q, k, v, bias=None, dropout_fn=None):
    """(B, S, H, D) q/k/v -> (B, S, H, D); softmax in fp32, then the
    probs in q's dtype through ``dropout_fn`` when one is given."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    scores = scores.float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_dropout_fn(dropout, scope, fused: bool, attention_seed,
                         device):
    """The ``dropout_fn`` an attention hands its ``attention_fn``: its
    ``Dropout_0`` (``dropout``, a ``threefry.Dropout``) on the probs,
    keyed from the attention's ``scope``.  A ``fused`` adapter cannot
    call a probs -> probs closure (the probs are never materialized):
    it consumes ``.rate`` and ``.seed``, the scope's per-call seed
    (``attention_seed`` when the caller drew it already), drawn on the
    host and put on ``device`` by a copy that does not sync."""
    drop = scope.push("Dropout_0")

    def dropout_fn(p):
        return dropout(p, drop.make_rng())

    if fused:
        if attention_seed is None:
            attention_seed = threefry.attention_seeds([scope], device)[0]
        dropout_fn.rate = dropout.rate
        dropout_fn.seed = attention_seed
    return dropout_fn


def _linear(n_in, n_out, dev, dtype):
    return nn.Linear(n_in, n_out, device=dev, dtype=dtype)


def _layer_norm(cfg, dev, dtype):
    return FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                          device=dev, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _full_tp_specs(cfg: BertConfig, n: int,
                   keep_heads: bool) -> Dict[str, tuple]:
    """``parallel.bert_tp_rules``' spec of each parameter of the full
    dense model at ``n`` model ranks (``param_specs``, read from the
    model on ``meta``): where BERT's Megatron placement is decided, a
    split whose dim does not divide left replicated."""
    full = BertForPreTraining(cfg, device="meta", seed=None)
    return tpar.param_specs(dict(full.named_parameters()),
                            tpar.Mesh({"model": n}), tpar.bert_tp_rules(),
                            num_heads=cfg.num_attention_heads,
                            keep_heads=keep_heads)


def tp_splits(cfg: BertConfig, n: int) -> Dict[str, bool]:
    """Which of BERT's Megatron splits apply at ``n`` model ranks, read
    from the full model's placement (``_full_tp_specs``): ``"heads"``
    (q, k, v column- and the attention output row-parallel), ``"mlp"``
    (``intermediate`` column- and ``output`` row-parallel), ``"vocab"``
    (the word embeddings and the MLM decoder).  A split whose dim does
    not divide leaves its leaves replicated, as the JAX package's
    ``param_specs`` does (BERT's 30522 words at 4 ranks).  An MoE model
    has no ``"mlp"`` split."""
    specs = _full_tp_specs(cfg, n, False)
    return {split: bool(specs.get(name)) for split, name in (
        ("heads", "encoder.layer_0.attention.query.weight"),
        ("mlp", "encoder.layer_0.intermediate.weight"),
        ("vocab", "encoder.word_embeddings.weight"))}


def _split_place(tp: Optional[TPPlace], cfg, split: str):
    """``tp`` where ``split`` applies at its size (:func:`tp_splits`),
    else None: the layer stays replicated."""
    return tp if tp is not None and tp_splits(cfg, tp.size)[split] else None


class BertSelfAttention(nn.Module):
    """q/k/v projections (one ``nn.Linear`` each, as the JAX leaves
    are), attention, output projection.  ``dropout_key`` is the
    attention's flax scope (or a key for a standalone call);
    ``attention_seed``, when given, is its already drawn per-call seed
    (a 0-d int32 tensor on the model's device).  Under TP (``tp``, a
    ``parallel.tensor_parallel.TPPlace``, where the heads divide) q/k/v
    hold this rank's heads behind ``copy_to_group`` and ``output`` is
    row-parallel; attention dropout keeps the dense model's mask on this
    rank's heads (the default attention draws the whole (B, heads, S, S)
    mask, the fused kernels hash the global head index through
    ``dropout_fn.offsets``)."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[TPPlace] = None):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        self.cfg = cfg
        self.tp = tp = _split_place(tp, cfg, "heads")
        n = tp.size if tp is not None else 1
        self.num_heads = cfg.num_attention_heads // n
        self.attention_fn = attention_fn
        self.query = _linear(h, h // n, dev, dtype)
        self.key = _linear(h, h // n, dev, dtype)
        self.value = _linear(h, h // n, dev, dtype)
        self.output = _linear(h, h, dev, dtype) if tp is None \
            else RowParallelLinear(h // n, h, tp, device=dev, dtype=dtype)
        self.dropout = threefry.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None, attention_seed=None):
        cfg = self.cfg
        b, s, h = x.shape
        nh, heads = self.num_heads, cfg.num_attention_heads
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        q, k, v = (proj(x).view(b, s, nh, h // heads)
                   for proj in (self.query, self.key, self.value))
        dropout_fn = None
        if cfg.attention_probs_dropout_prob > 0 and not deterministic:
            fused = self.attention_fn is not None
            if self.tp is not None and not fused:
                dropout_fn = head_slice_dropout(
                    self.dropout, _scope(dropout_key), self.tp, heads)
            else:
                dropout_fn = attention_dropout_fn(
                    self.dropout, _scope(dropout_key), fused,
                    attention_seed, x.device)
            if self.tp is not None and fused:
                # the flash kernels hash GLOBAL head coordinates
                dropout_fn.offsets = (0, 0, self.tp.rank * nh, heads)
        attn = self.attention_fn or dot_product_attention
        ctx = attn(q, k, v, bias=attn_bias, dropout_fn=dropout_fn)
        return self.output(ctx.reshape(b, s, nh * (h // heads)))


def _dropout_scope(cfg, deterministic, dropout_key):
    """The scope a module's dropouts draw from, None when none is
    active (flax then draws nothing and needs no key)."""
    if deterministic or (cfg.hidden_dropout_prob == 0.0
                         and cfg.attention_probs_dropout_prob == 0.0):
        return None
    return _scope(dropout_key)


def _drop(module, x, scope, window=None):
    """``module`` (a ``threefry.Dropout``) on x, keyed by the next draw
    of ``scope``'s ``Dropout_0``; x as it is without a scope or at rate
    0 (flax draws nothing then).  ``window``: x is a sequence-parallel
    rank's slice of the dense activation (``threefry.window``)."""
    if scope is None or module.rate == 0.0:
        return x
    key = scope.push("Dropout_0").make_rng()
    return module(x, key) if window is None else module(x, key, window)


class BertLayer(nn.Module):
    """Post-LN: LN(x + drop(Attn(x))); LN(x + drop(MLP(x))), ``drop``
    one module (flax's ``Dropout_0`` of the layer) called twice.  Under
    TP (``tp``) ``intermediate`` is column-parallel and ``output``
    row-parallel where the MLP width divides; the hidden dropouts act
    on replicated activations, the same keys on every model rank.  With
    ``cfg.moe_experts`` the MLP is ``moe`` (an :class:`MoEMlp`, whole on
    every model rank; ``ep`` and ``moe_aux_group`` its groups,
    ``moe_seq_shards`` its ``seq_shards``) and the forward returns ``(x,
    aux)``."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[TPPlace] = None,
                 ep: Optional[ProcessGroup] = None,
                 moe_aux_group: Optional[ProcessGroup] = None,
                 moe_seq_shards: int = 1):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg, attention_fn, device=dev,
                                           dtype=dtype, tp=tp)
        self.attention_ln = _layer_norm(cfg, dev, dtype)
        self.tp = tp = _split_place(tp, cfg, "mlp")
        if cfg.moe_experts:
            self.moe = MoEMlp(cfg.moe_experts, cfg.hidden_size,
                              cfg.intermediate_size, cfg.moe_dispatch,
                              cfg.moe_capacity_factor, device=dev,
                              dtype=dtype, ep=ep, aux_group=moe_aux_group,
                              seq_shards=moe_seq_shards)
        else:
            il = cfg.intermediate_size // (tp.size if tp is not None else 1)
            self.intermediate = _linear(cfg.hidden_size, il, dev, dtype)
            self.output = _linear(il, cfg.hidden_size, dev, dtype) \
                if tp is None else RowParallelLinear(
                    il, cfg.hidden_size, tp, device=dev, dtype=dtype)
        self.output_ln = _layer_norm(cfg, dev, dtype)
        self.drop = threefry.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None, attention_seed=None, drop_window=None):
        """``drop_window``: x is a sequence-parallel rank's slice of the
        dense activation (``threefry.window``)."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        attn_out = self.attention(
            x, attn_bias, deterministic,
            None if scope is None else scope.push("attention"),
            attention_seed)
        x = self.attention_ln(x + _drop(self.drop, attn_out, scope,
                                        drop_window))
        if self.cfg.moe_experts:
            y, aux = self.moe(x)
            return self.output_ln(x + _drop(self.drop, y, scope,
                                            drop_window)), aux
        y = x if self.tp is None else copy_to_group(x, self.tp.group)
        y = self.output(F.gelu(self.intermediate(y)))   # exact erf gelu
        return self.output_ln(x + _drop(self.drop, y, scope, drop_window))


def _embed_block(module, input_ids, token_type_ids, scope, offset=0,
                 window=None):
    """Embedding sum + LN + dropout, shared by :class:`BertEncoder` and
    :class:`BertEmbeddings` (``module`` holds the tables, the LN and the
    dropout under the same names in both)."""
    s = input_ids.shape[1]
    pos = offset + torch.arange(s, device=input_ids.device)[None, :]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    # the type rows as a one-hot product, not a gather: every token of a
    # type adds into one row, and the gather's backward on the card sums
    # such a row in no fixed order (two runs differ in the last bits);
    # the product's backward is a GEMM, the same bits each run
    types = module.token_type_embeddings.weight
    x = module.embeddings_ln(module.word_embeddings(input_ids)
                             + module.position_embeddings(pos)
                             + F.one_hot(token_type_ids.long(),
                                         types.shape[0]).to(types.dtype)
                             @ types)
    return _drop(module.embeddings_dropout, x, scope, window)


def _run_layers(module, n, attention_fn, x, attn_bias, deterministic,
                scope, window=None):
    """``module``'s ``layer_0`` .. ``layer_<n-1>`` on x (remat under
    ``cfg.remat`` while training), each keyed from ``scope`` pushed by
    its name: the encoder's loop and a pipeline stage's.  With MoE
    layers, ``(x, aux)``: aux the sum of the layers' in layer order."""
    cfg = module.cfg
    scopes = [None if scope is None else scope.push(f"layer_{i}")
              for i in range(n)]
    seeds = [None] * n
    if scope is not None and attention_fn is not None \
            and cfg.attention_probs_dropout_prob > 0:
        # every layer's attention seed in one copy to the device
        seeds = threefry.attention_seeds(
            [sc.push("attention") for sc in scopes], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(n):
        layer = getattr(module, f"layer_{i}")
        if remat:
            x = remat_layer(layer, scopes[i], x, attn_bias, deterministic,
                            attention_seed=seeds[i], drop_window=window)
        else:
            x = layer(x, attn_bias, deterministic, scopes[i], seeds[i],
                      drop_window=window)
        if cfg.moe_experts:
            x, aux = x
            auxes.append(aux)
    return (x, sum(auxes)) if cfg.moe_experts else x


def _add_embeddings(module, cfg, dev, dtype, tp=None):
    h = cfg.hidden_size
    tp = _split_place(tp, cfg, "vocab")
    module.word_embeddings = nn.Embedding(
        cfg.vocab_size, h, device=dev, dtype=dtype) if tp is None \
        else VocabParallelEmbedding(cfg.vocab_size // tp.size, h, tp,
                                    device=dev, dtype=dtype)
    module.position_embeddings = nn.Embedding(
        cfg.max_position_embeddings, h, device=dev, dtype=dtype)
    module.token_type_embeddings = nn.Embedding(
        cfg.type_vocab_size, h, device=dev, dtype=dtype)
    module.embeddings_ln = _layer_norm(cfg, dev, dtype)
    module.embeddings_dropout = threefry.Dropout(cfg.hidden_dropout_prob)


def _add_heads(module, cfg, dev, dtype, tp=None):
    h = cfg.hidden_size
    module.vocab_tp = tp = _split_place(tp, cfg, "vocab")
    module.mlm_transform = _linear(h, h, dev, dtype)
    module.mlm_ln = _layer_norm(cfg, dev, dtype)
    module.mlm_decoder = _linear(
        h, cfg.vocab_size // (tp.size if tp is not None else 1), dev, dtype)
    module.pooler = _linear(h, h, dev, dtype)
    module.nsp_classifier = _linear(h, 2, dev, dtype)


def _pretraining_heads(module, seq):
    """MLM (transform, gelu, LN, untied decoder) and NSP (tanh pooler
    over ``[CLS]``) heads in fp32, shared by :class:`BertForPreTraining`
    and :class:`BertHeads`.  Under TP the decoder is column-parallel
    over the vocabulary and its (B, S, V/n) logits are gathered over the
    model group: the caller's loss takes whole logits."""
    h = module.mlm_ln(F.gelu(module.mlm_transform(seq)))
    tp = module.vocab_tp
    if tp is None:
        mlm_logits = module.mlm_decoder(h).float()
    else:
        mlm_logits = gather_from_group(
            module.mlm_decoder(copy_to_group(h, tp.group)), tp.group).float()
    cls = torch.tanh(module.pooler(seq[:, 0]))
    nsp_logits = module.nsp_classifier(cls).float()
    return mlm_logits, nsp_logits


class BertEncoder(nn.Module):
    """input_ids/token_type_ids (B, S) int, attention_mask (B, S) {0,1}
    -> sequence output (B, S, H) (with MoE layers ``(seq, aux)``).
    Embedding sum + LN + dropout (``_embed_block``), then the layers,
    named ``layer_<i>``.  ``sp`` (a sequence group): the inputs are this
    rank's S_local tokens (module docstring); ``tp`` (a ``TPPlace``)
    builds a tensor-parallel rank's layers and word embeddings; ``ep``
    and ``moe_aux_group``: the MoE layers' groups."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32, sp=None,
                 tp: Optional[TPPlace] = None,
                 ep: Optional[ProcessGroup] = None,
                 moe_aux_group: Optional[ProcessGroup] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if sp is not None and attention_fn is None:
            raise ValueError("a sequence-parallel BERT takes a "
                             "sequence-parallel attention_fn "
                             "(parallel.make_ring_attention or "
                             "make_ulysses_attention)")
        self.sp = sp
        self.attention_fn = attention_fn
        _add_embeddings(self, cfg, dev, dtype, tp)
        shards = sp.size() if sp is not None and dist.is_initialized() \
            else 1
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                cfg, attention_fn, device=dev, dtype=dtype, tp=tp, ep=ep,
                moe_aux_group=moe_aux_group, moe_seq_shards=shards))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_key=None):
        cfg = self.cfg
        n = cfg.num_hidden_layers
        scope = _dropout_scope(cfg, deterministic, dropout_key)
        offset, window = 0, None
        if self.sp is not None and dist.is_initialized():
            b, s = input_ids.shape
            offset = self.sp.rank() * s
            window = threefry.window((b, s * self.sp.size(),
                                      cfg.hidden_size), 1, offset, s)
        x = _embed_block(self, input_ids, token_type_ids, scope, offset,
                         window)
        attn_bias = None
        if attention_mask is not None:
            attn_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                    0.0, -1e9).float()
        return _run_layers(self, n, self.attention_fn, x, attn_bias,
                           deterministic, scope, window)


class BertForPreTraining(nn.Module):
    """Encoder + MLM head (transform, gelu, LN, untied decoder) + NSP
    head (tanh pooler over ``[CLS]``); returns fp32 ``(mlm_logits,
    nsp_logits)``.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``device="cpu"`` is passed.  ``seed`` initialises the weights with
    the JAX model's distributions (normal(initializer_range) for
    embeddings and kernels, zero biases, unit LN scales) from a CPU
    ``torch.Generator``, the same weights on any device; ``seed=None``
    leaves PyTorch's init for callers that load a state dict.  ``sp``
    (a sequence group) builds a sequence-parallel rank's model (module
    docstring).

    ``tp`` (a ``parallel.ProcessGroup``, the mesh's model group) builds
    this rank's part of the tensor-parallel model, the twin of the JAX
    model under ``parallel.bert_tp_rules``: each leaf split as
    ``param_specs`` places it (q/k/v and ``intermediate`` column-, the
    attention output and ``output`` row-parallel, the word embeddings
    and the MLM decoder over the vocabulary; a split whose dim does not
    divide stays replicated, :func:`tp_splits`), under the dense model's
    names.  The MLM logits are gathered over the group, so the forward
    returns what the dense model returns; ``seed`` draws each full
    tensor as the dense model does and keeps this rank's slice.

    With MoE layers (``cfg.moe_experts``) the forward returns ``(mlm,
    nsp, aux)``, aux (fp32, 0-d) the sum of the layers' load-balance
    aux (module docstring).  ``ep`` (a ``ProcessGroup`` whose ranks hold
    the same tokens) splits each layer's experts over it, as
    ``parallel.shard_params(..., models.EP_RULES)`` cuts a state dict
    (``ep`` set on the model when the experts divide); ``seed`` then
    keeps this rank's experts of each full draw.  ``moe_aux_group``: the
    ranks that run one step on different tokens (the data group; under
    sequence parallelism the (data x sp) ranks, in the mesh's
    ``"data_sp"`` order): each layer's token fractions are averaged over
    it, so the group's mean aux is the whole batch's, and the capacity
    dispatch's cap and arrival order are the whole batch's
    (``MoEMlp``)."""

    def __init__(self, cfg: BertConfig,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0, sp=None,
                 tp: Optional[ProcessGroup] = None,
                 ep: Optional[ProcessGroup] = None,
                 moe_aux_group: Optional[ProcessGroup] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp = place = tp_place(tp)
        self.encoder = BertEncoder(cfg, attention_fn, device=dev,
                                   dtype=dtype, sp=sp, tp=place, ep=ep,
                                   moe_aux_group=moe_aux_group)
        moe = getattr(self.encoder.layer_0, "moe", None) \
            if cfg.num_hidden_layers else None
        self.ep = None if moe is None or moe.ep is None else TPPlace(
            moe.ep, moe.ep_rank, moe.ep_size)
        _add_heads(self, cfg, dev, dtype, place)
        if seed is not None:
            self.reset_parameters(seed)

    def tp_specs(self, keep_heads: bool = False) -> Dict[str, tuple]:
        """Each parameter's split under ``parallel.bert_tp_rules`` at this
        model's TP size (``{}`` without TP), read from the full model's
        shapes."""
        if self.tp is None:
            return {}
        return dict(_full_tp_specs(self.cfg, self.tp.size, keep_heads))

    def tp_places(self) -> Dict[str, tuple]:
        """Each local parameter's ``parallel.tensor_parallel.Place``: the
        ``like_params`` ZeRO-1 shards the moments with."""
        n = self.tp.size if self.tp is not None else 1
        return tpar.param_places(self, self.tp_specs(keep_heads=True),
                                 {"model": n}, self.cfg.num_attention_heads)

    def reset_parameters(self, seed: int) -> None:
        from apex_tpu_torch.parallel.tensor_parallel import reset_seeded
        places = {} if self.tp is None else {"model": self.tp}
        specs = self.tp_specs()
        if self.ep is not None:
            places["expert"] = self.ep
            specs.update(ep_specs(self))
        reset_seeded(self, specs, places, seed, self.cfg.initializer_range)

    def _pretraining_heads(self, seq):
        return _pretraining_heads(self, seq)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_key=None):
        """``dropout_key``: the key the JAX model takes as
        ``rngs={"dropout": key}``; needed when ``deterministic`` is False
        and a dropout rate is above 0."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        seq = self.encoder(input_ids, attention_mask, token_type_ids,
                           deterministic,
                           None if scope is None else scope.push("encoder"))
        if self.cfg.moe_experts:
            seq, aux = seq
            return (*self._pretraining_heads(seq), aux)
        return self._pretraining_heads(seq)


class BertEmbeddings(nn.Module):
    """The embeddings split out for pipeline parallelism (names as the
    encoder's inline ones): ``forward(input_ids, token_type_ids=None,
    deterministic=True, dropout_key=None)``, ``dropout_key`` its root
    scope's key.  ``tp``: a ``TPPlace``, the word embeddings
    vocab-parallel where the vocabulary divides."""

    def __init__(self, cfg: BertConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[TPPlace] = None):
        super().__init__()
        self.cfg = cfg
        _add_embeddings(self, cfg, resolve_device(device), dtype, tp)

    def forward(self, input_ids, token_type_ids=None,
                deterministic: bool = True, dropout_key=None, offset=0,
                window=None):
        """``offset``: the position of the first token; ``window``: the
        activation is that slice of a larger one's dropout stream
        (``threefry.window``)."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        return _embed_block(self, input_ids, token_type_ids, scope, offset,
                            window)


class BertStage(nn.Module):
    """``layers_per_stage`` consecutive encoder layers, ``layer_0`` ..,
    the stage body of :class:`PipelinedBert`; its dropout scope's root
    is the stage (the JAX stage module's paths).  ``tp``: a
    ``TPPlace``, the layers tensor-parallel (:class:`BertLayer`).  With
    MoE layers the forward returns ``(x, aux)``, aux the stage's sum
    (what the JAX stage sows)."""

    def __init__(self, cfg: BertConfig, layers_per_stage: int,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[TPPlace] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layers_per_stage = layers_per_stage
        self.attention_fn = attention_fn
        for i in range(layers_per_stage):
            self.add_module(f"layer_{i}", BertLayer(
                cfg, attention_fn, device=dev, dtype=dtype, tp=tp))

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None):
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        return _run_layers(self, self.layers_per_stage, self.attention_fn,
                           x, attn_bias, deterministic, scope)


class BertHeads(nn.Module):
    """The MLM and NSP heads split out for pipeline parallelism (names as
    :class:`BertForPreTraining`'s).  ``tp``: a ``TPPlace``, the MLM
    decoder column-parallel over the vocabulary where it divides, its
    logits gathered."""

    def __init__(self, cfg: BertConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[TPPlace] = None):
        super().__init__()
        self.cfg = cfg
        _add_heads(self, cfg, resolve_device(device), dtype, tp)

    def forward(self, seq):
        return _pretraining_heads(self, seq)


def _bias(input_ids, attention_mask, neg=-1e9):
    """The additive key bias (B, 1, 1, S) of a {0, 1} mask; None without
    one (a zero bias, as the JAX pipelined models pass, adds nothing)."""
    if attention_mask is None:
        return None
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).float()


def _rows(t, j, mb):
    return None if t is None else t[j * mb:(j + 1) * mb]


class PipelinedBert(PipelinedCommon, nn.Module):
    """BERT for pretraining with the encoder pipelined over the mesh's
    ``pipe_axis`` group: the twin of the JAX ``PipelinedBert``, one stage
    a rank.  Rank r holds ``embed.*`` (:class:`BertEmbeddings`),
    ``stages.layer_<i>.*`` (its ``L / pp`` layers, :class:`BertStage`,
    ``i`` local to the stage: dense layer ``r * L / pp + i``) and
    ``heads.*`` (:class:`BertHeads`); the embeddings and heads run on
    every rank.

    ``forward`` is GPipe (``parallel.pipeline.gpipe``):
    ``(mlm_logits, nsp_logits)`` of this rank's batch, the same on every
    rank of its pipe group.  :meth:`loss_and_grad_1f1b` is 1F1B
    (``parallel.pipeline.onef1b``), the heads as the schedule's
    ``loss_params``.  ``batch_axis`` (the mesh's data axis): each data
    index runs the pipeline on its own rows and the dropout keys fold in
    the data index.  Both schedules leave the mean over the data group
    to the caller: GPipe's gradients are autograd's on this index's
    rows, and :meth:`loss_and_grad_1f1b` returns this index's loss and
    gradients (the JAX method returns their data mean, which one
    ``DistributedDataParallel.reduce_gradients`` gives).

    Dropout: ``deterministic=False`` with ``dropout_key`` (the JAX
    model's ``rngs={"dropout": key}``): the embeddings draw from
    ``fold_in(key, 2**20)``, microbatch j's stage from
    ``_stage_dropout_key(key, j)``, so 1F1B's rematerialized forward
    draws the forward's masks and both schedules equal the JAX model's
    bit for bit.  The attention bias and the microbatch index do not
    ride the activations: each rank slices them from the batch it holds
    (``microbatch_index``).

    ``seed`` draws the dense :class:`BertForPreTraining`'s weights from
    the same seed and keeps this rank's (:func:`dense_to_rank`), so
    ``PipelinedBert(..., seed=s)`` on the pipe ranks together is
    ``BertForPreTraining(..., seed=s)``.

    ``seq_axis`` (the mesh's sequence axis, with ``attention_fn`` a
    ``parallel.make_ring_attention`` or ``make_ulysses_attention`` of its
    group): the inputs are still the data index's whole (B, S) batch, and
    this rank runs its S/sp tokens (``models/pipelined_common.py``): its
    embeddings take positions ``sp_rank * S/sp + arange(S/sp)``, its
    attention bias is its keys' shard (the ring carries it with its K/V,
    Ulysses gathers it).  ``forward`` gives this rank's (B, S/sp, V) MLM
    logits and NSP logits that are the pooled ``[CLS]`` token's on
    sequence rank 0 alone, where that token lives; its gradients are
    partial on each shard, for the caller to sum over the sequence
    group.  :meth:`loss_and_grad_1f1b` takes only an attention marked
    ``onef1b_compatible`` (Ulysses; the ring raises, as in the
    reference), gathers the hidden states before ``loss_fn`` and
    returns the gradients summed over the sequence group.

    ``tp_axis`` (the mesh's model axis, ``parallel.create_mesh(pp=,
    tp=)``): Megatron tensor parallelism inside each stage, with or
    without ``seq_axis``, under both schedules.  The stage's layers, the
    word embeddings and the MLM decoder hold this rank's slices as
    :meth:`param_spec_tree` places them (``parallel.bert_tp_rules``;
    BERT-large's 30522 words stay whole at 4 ranks); the MLM logits are
    gathered over the model group, so both schedules' ``loss_fn`` and
    outputs see the whole vocabulary, and the gradients are this rank's
    slices.  ``seed`` and :meth:`shard_variables` give each rank its
    slice of the dense weights.

    MoE configs (dense or capacity dispatch, the experts whole on each
    stage): the stage's aux rides the activations as a per-row ``(mb,)``
    fp32 leaf (every row of a microbatch carries its running total over
    the stages), so its gradient reaches each stage's router through the
    schedules' hops.  ``forward`` returns ``(mlm, nsp, aux)``, aux the
    mean over the rows (the mean of the microbatches' estimates; under
    ``seq_axis`` also over the sequence group, ``pmean_g``);
    :meth:`loss_and_grad_1f1b` adds ``moe_aux_weight * mean(aux)`` to
    each microbatch's loss at the last stage, and refuses ``seq_axis``
    with MoE, as the JAX method does."""

    tp_rules_name = "bert_tp_rules"

    def __init__(self, cfg: BertConfig, mesh, pp: int,
                 num_microbatches: int, pipe_axis: str = "pipe",
                 batch_axis: Optional[str] = None,
                 seq_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        nn.Module.__init__(self)
        self._setup(cfg, mesh, pp, num_microbatches, pipe_axis, batch_axis,
                    seq_axis, tp_axis, attention_fn,
                    "parallel.make_ring_attention(seq_axis)")
        dev = resolve_device(device)
        self.embed = BertEmbeddings(cfg, device=dev, dtype=dtype,
                                    tp=self.tp)
        self.stages = BertStage(cfg, cfg.num_hidden_layers // pp,
                                attention_fn, device=dev, dtype=dtype,
                                tp=self.tp)
        self.heads = BertHeads(cfg, device=dev, dtype=dtype, tp=self.tp)
        if seed is not None:
            self.reset_parameters(seed)

    def _meta_layout(self):
        cfg = self.cfg
        return nn.ModuleDict({
            "embed": BertEmbeddings(cfg, device="meta"),
            "stages": BertStage(cfg, self.stages.layers_per_stage,
                                device="meta"),
            "heads": BertHeads(cfg, device="meta")})

    def reset_parameters(self, seed: int) -> None:
        """The dense model's draws from ``seed``, this rank's kept."""
        self._reset_from_dense(
            BertForPreTraining(self.cfg, device="meta", seed=None),
            _rank_name, self.stages.layers_per_stage, seed)

    def _build_stage_fn(self, needs_rng, base_key, deterministic, bias, mb):
        """The stage body both schedules run: ``(params, h, j) -> h``,
        microbatch j's rows of ``bias`` and its stage key; with MoE
        layers ``h`` is ``(hidden, aux)`` and the stage adds its aux to
        every row's running total."""
        moe = self.cfg.moe_experts > 0

        def stage_fn(sp, h, j):
            key = self._stage_dropout_key(base_key, j) if needs_rng \
                else None
            if moe:
                h, aux = h
            out = torch.func.functional_call(
                self.stages, sp, (h, _rows(bias, j, mb)),
                {"deterministic": deterministic, "dropout_key": key})
            if moe:
                out, stage_aux = out
                return out, aux + stage_aux
            return out

        return stage_fn

    def _activations(self, x):
        """The schedules' input: ``x``, or with MoE layers ``(x, aux0)``,
        aux0 a per-row fp32 zero."""
        if not self.cfg.moe_experts:
            return x
        return x, torch.zeros(x.shape[0], dtype=torch.float32,
                              device=x.device)

    def _embed_and_stage(self, input_ids, attention_mask, token_type_ids,
                         deterministic, dropout_key, caller):
        """This rank's embeddings (of its tokens under ``seq_axis``) and
        the stage body, both schedules' prologue."""
        needs_rng, base_key, embed_key = self._dropout_setup(
            deterministic, dropout_key, caller)
        offset, window = self._embed_window(input_ids)
        ids = self._seq_slice(input_ids)
        x = self.embed(ids, self._seq_slice(token_type_ids), deterministic,
                       embed_key, offset, window)
        stage_fn = self._build_stage_fn(
            needs_rng, base_key, deterministic,
            _bias(ids, self._seq_slice(attention_mask)),
            ids.shape[0] // self.num_microbatches)
        return x, stage_fn

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_key=None):
        from apex_tpu_torch.parallel.pipeline import gpipe
        x, stage_fn = self._embed_and_stage(
            input_ids, attention_mask, token_type_ids, deterministic,
            dropout_key, "PipelinedBert.apply")
        seq = gpipe(self._pipe(), stage_fn,
                    dict(self.stages.named_parameters()),
                    self._activations(x), self.num_microbatches,
                    microbatch_index=True)
        if not self.cfg.moe_experts:
            return self.heads(seq)
        seq, aux = seq
        # every row of a microbatch carries its stage-summed aux: the
        # mean over the rows is the mean over the microbatches
        aux = aux.mean()
        group = self._seq_group()
        if group is not None and group.size() > 1:
            # each sequence shard routes its own tokens: a local estimate,
            # averaged over the shards (lax.pmean's value and transpose)
            aux = pmean_g(aux, group)
        return (*self.heads(seq), aux)

    def loss_and_grad_1f1b(self, input_ids, loss_fn, targets,
                           attention_mask=None, token_type_ids=None,
                           deterministic: bool = True, dropout_key=None,
                           moe_aux_weight=0.0):
        """The 1F1B training step on this rank's batch: ``loss_fn(mlm,
        nsp, target_mb) -> scalar`` (a mean over the microbatch's rows),
        ``targets`` a pytree of per-row tensors.  Returns ``(loss,
        grads)``: the loss the mean over the microbatches, the gradients
        a ``{name: tensor}`` dict of this rank's parameters (``embed.*``
        through the pipeline's input gradient, ``stages.*`` from the
        schedule, ``heads.*`` as its ``loss_params``), the same on every
        rank of the pipe group but ``stages.*``; both this data index's,
        for the caller to average over the data group.  Under
        ``seq_axis`` ``loss_fn`` sees the whole sequence's logits (the
        hidden states gathered over the sequence group), ``targets`` are
        per row of the whole batch, and ``embed.*`` and ``stages.*`` are
        summed over the sequence group.  With MoE layers the loss of a
        microbatch is ``loss_fn(...) + moe_aux_weight * mean(aux)`` (a
        float, or a tensor such as the aux weight times amp's loss
        scale); a weight of 0 warns, as the JAX method does."""
        from apex_tpu_torch.parallel.pipeline import onef1b
        self._check_onef1b()
        moe = self.cfg.moe_experts > 0
        if moe and self.seq_axis is not None:
            raise NotImplementedError(
                "seq_axis + MoE under 1F1B: the sp-local aux estimate "
                "breaks the loss/grad reduction algebra; use the GPipe "
                "apply() path")
        statically_zero = isinstance(moe_aux_weight, (int, float)) \
            and moe_aux_weight == 0.0
        use_aux = moe and not statically_zero
        if moe and statically_zero:
            warnings.warn(
                "loss_and_grad_1f1b on an MoE config with "
                "moe_aux_weight=0: the load-balance aux term is dropped "
                "and nothing pushes the router toward balance (the GPipe "
                "apply() path returns the aux explicitly); pass "
                "moe_aux_weight to include it", stacklevel=2)
        m = self.num_microbatches
        embed = dict(self.embed.named_parameters())
        with torch.enable_grad():
            x, stage_fn = self._embed_and_stage(
                input_ids, attention_mask, token_type_ids, deterministic,
                dropout_key, "loss_and_grad_1f1b")
        seq = self._seq_group()

        def pl_loss(y, tgt, heads_p):
            h = y[0] if moe else y
            mlm, nsp = torch.func.functional_call(
                self.heads, heads_p, (gather_seq(h, seq),))
            loss = loss_fn(mlm, nsp, tgt)
            if use_aux:
                loss = loss + moe_aux_weight * torch.mean(y[-1])
            return loss

        loss, g_stage, dx, g_heads = onef1b(
            self._pipe(), stage_fn, pl_loss,
            dict(self.stages.named_parameters()),
            self._activations(x.detach()), targets, m,
            dict(self.heads.named_parameters()), microbatch_index=True)
        if moe:
            dx = dx[0]
        g_embed = dict(zip(embed, torch.autograd.grad(
            x, list(embed.values()), dx)))
        # the embeddings' and the stage's are partial on each sequence
        # shard; the heads', on the gathered states, are whole already
        shared = self._sum_over_seq(
            {**{f"embed.{k}": v for k, v in g_embed.items()},
             **{f"stages.{k}": v for k, v in g_stage.items()}})
        return loss, {**shared,
                      **{f"heads.{k}": v for k, v in g_heads.items()}}


def _rank_name(name: str, layers_per_stage: int, rank: int):
    """A dense :class:`BertForPreTraining` parameter's name on pipeline
    rank ``rank``, or None when another rank holds it."""
    if name.startswith("encoder.layer_"):
        i, rest = name[len("encoder.layer_"):].split(".", 1)
        stage, local = divmod(int(i), layers_per_stage)
        return f"stages.layer_{local}.{rest}" if stage == rank else None
    if name.startswith("encoder."):
        return "embed." + name[len("encoder."):]
    return "heads." + name


def dense_to_rank(state_dict: Mapping[str, torch.Tensor], cfg: BertConfig,
                  pp: int, rank: int, tp: int = 1,
                  tp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """A dense :class:`BertForPreTraining` state dict (or a gradient tree
    of the same names) as :class:`PipelinedBert`'s on pipeline rank
    ``rank`` of ``pp``: dense layer ``rank * L / pp + i`` becomes
    ``stages.layer_<i>``, the embeddings ``embed.*``, the heads
    ``heads.*``; with ``tp`` above 1, model rank ``tp_rank``'s Megatron
    slice of each (``parallel.tensor_parallel.tp_slice``)."""
    return tpar.tp_slice(rank_state_dict(state_dict, _rank_name,
                                         cfg.num_hidden_layers // pp, rank),
                         tpar.bert_tp_rules(), cfg.num_attention_heads, tp,
                         tp_rank)


def params_from_jax(params: Mapping, cfg: BertConfig,
                    rank: Optional[int] = None, tp: int = 1,
                    tp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX package's ``BertForPreTraining`` param tree
    (``{"params": ...}`` or its inner dict, leaves as arrays) as this
    model's ``state_dict`` — and equally a gradient tree of the same
    shape.  A ``PipelinedBert`` tree (``{"embed", "stages", "heads"}``,
    the stage leaves stacked on dim 0) gives pipeline rank ``rank``'s
    state dict, row ``rank`` of each stacked leaf.  DenseGeneral q/k/v
    kernels (h, nh, hd) and the output kernel (nh, hd, h) flatten to (h,
    h) and transpose into ``nn.Linear``'s (out, in) layout; Dense kernels
    (in, out) transpose; embeddings and LN scale/bias carry over as they
    are; an MoE layer's stacked experts carry over as they are and its
    router kernel (H, E) transposes.  ``tp`` above 1: model rank
    ``tp_rank``'s Megatron slice of each leaf (``parallel.tensor_parallel.tp_slice``), what
    ``BertForPreTraining(tp=)`` or a ``PipelinedBert(tp_axis=)`` rank
    holds."""
    p = params.get("params", params)
    if "stages" in p:
        stages = p["stages"]
        pp = np.asarray(pytree.tree_leaves(stages)[0]).shape[0]
        lps = cfg.num_hidden_layers // pp
        enc = dict(p["embed"])
        for st in range(pp):
            for li in range(lps):
                enc[f"layer_{st * lps + li}"] = pytree.tree_map(
                    lambda a, st=st: np.asarray(a)[st],
                    stages[f"layer_{li}"])
        dense = params_from_jax({"encoder": enc, **p["heads"]}, cfg)
        return dense_to_rank(dense, cfg, pp, 0 if rank is None else rank,
                             tp, tp_rank)
    if tp > 1:
        return tpar.tp_slice(params_from_jax(params, cfg),
                             tpar.bert_tp_rules(), cfg.num_attention_heads, tp,
                             tp_rank)
    h = cfg.hidden_size

    def t(a, shape=None):
        a = np.array(a)  # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    def dense(sd, name, leaf):
        sd[f"{name}.weight"] = t(np.asarray(leaf["kernel"]).T)
        sd[f"{name}.bias"] = t(leaf["bias"])

    def ln(sd, name, leaf):
        sd[f"{name}.scale"] = t(leaf["scale"])
        sd[f"{name}.bias"] = t(leaf["bias"])

    enc = p["encoder"]
    sd = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"encoder.{name}.weight"] = t(enc[name]["embedding"])
    ln(sd, "encoder.embeddings_ln", enc["embeddings_ln"])
    for i in range(cfg.num_hidden_layers):
        lay, pre = enc[f"layer_{i}"], f"encoder.layer_{i}."
        att = lay["attention"]
        for name in ("query", "key", "value"):
            sd[f"{pre}attention.{name}.weight"] = t(
                np.asarray(att[name]["kernel"]).reshape(h, h).T)
            sd[f"{pre}attention.{name}.bias"] = t(att[name]["bias"], (h,))
        sd[f"{pre}attention.output.weight"] = t(
            np.asarray(att["output"]["kernel"]).reshape(h, h).T)
        sd[f"{pre}attention.output.bias"] = t(att["output"]["bias"])
        ln(sd, f"{pre}attention_ln", lay["attention_ln"])
        if "moe" in lay:
            for name, v in moe_params_from_jax(lay["moe"]).items():
                sd[f"{pre}moe.{name}"] = v
        else:
            dense(sd, f"{pre}intermediate", lay["intermediate"])
            dense(sd, f"{pre}output", lay["output"])
        ln(sd, f"{pre}output_ln", lay["output_ln"])
    for name in ("mlm_transform", "mlm_decoder", "pooler", "nsp_classifier"):
        dense(sd, name, p[name])
    ln(sd, "mlm_ln", p["mlm_ln"])
    return sd
