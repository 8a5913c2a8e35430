"""Decoder-only causal language model (GPT-style).

Twin of ``apex_tpu/models/gpt.py`` for serving and training: pre-LN blocks on
:class:`FusedLayerNorm`, learned positional embeddings, a weight-tied LM
head with fp32 logits, ``gelu(approximate="tanh")``, and the serving
hooks ``positions``, ``cache_views`` and ``return_kv``.  The
projections are plain ``nn.Linear`` (the reference leaves them to XLA,
outside any kernel).  Attention runs through ``attention_fn`` (e.g.
``make_flash_attention(causal=True)``) on the full causal forward, and
through ``ops.cached_attention`` / ``ops.chunk_cached_attention`` over
a cache view.  With ``kv_quant=True`` (the int8 pool) fresh K/V are
quantized at the projection (``ops.kv_quant``) and attention everywhere
runs on the quantized grid.

The training forward (no cache views) is differentiable end to end,
the kernels included (their autograd functions), and :func:`lm_loss` is
the next-token cross entropy in fp32.

Dropout draws from flax's ``dropout`` rng stream as the JAX model does
(the same rule as ``models/bert.py``): ``forward(...,
deterministic=False, dropout_key=key)`` takes the key the JAX model
takes as ``rngs={"dropout": key}``, and each draw is keyed by its flax
module path and call count (``ops/threefry.py``), so the same key drops
the same positions in both packages:

- hidden dropout: the embeddings' ``Dropout_0`` at the model's root,
  and each block's one ``Dropout_0`` (``block_<i>``), called on the
  attention output and then on the MLP output;
- attention dropout: with a custom ``attention_fn``, each block's int32
  seed ``randint(make_rng("dropout"), (), 0, int32 max)`` at the
  attention's scope, handed over as ``dropout_fn.rate`` / ``.seed``
  (all blocks' seeds drawn on the host and moved to the card in one
  ``non_blocking`` copy from pinned memory); the default attention
  applies the attention's own ``Dropout_0`` to its probs.

``GPTConfig.remat`` rematerialises each block in the backward
(``models/_remat.py``: ``torch.utils.checkpoint``, non-reentrant), as
``nn.remat`` does in the JAX model, when training (no ``return_kv``, no
cache views).  The recompute draws the forward's dropout keys (the
block runs on a fork of its scope's counters, and the attention seeds
are drawn before the blocks), so the gradients equal those without
remat bit for bit.

Tensor parallelism (``GPTLMHeadModel(cfg, ..., tp=<model group>)``,
the twin of the JAX model under ``parallel.gpt_tp_rules``): each rank
builds its local shapes under the dense model's names.  q/k/v and
``mlp_in`` are column-parallel (``parallel.copy_to_group`` in front),
the attention ``output`` and ``mlp_out`` row-parallel
(:class:`RowParallelLinear`: the bias added once, after
``reduce_from_group``), ``wte`` vocab-parallel
(:class:`VocabParallelEmbedding`).  The head is left to
``ops.vocab_parallel_lm_loss``: a TP forward takes ``return_hidden=True``
(the final LN's output, as the JAX model's flag).  Dropout draws what
the dense model draws: the hidden dropouts act on replicated
activations with the same keys on every rank; the flash kernels get
``dropout_offsets`` ``(0, 0, m * heads_local, heads)`` on model rank m,
and the default attention draws the full ``(B, heads, S, S)`` mask and
keeps this rank's heads.  ``reset_parameters(seed)`` draws each full
tensor as the dense model does and keeps this rank's slice, so a seed
gives the dense model's weights, split.  Serving under TP is not here.

Sequence parallelism (``GPTLMHeadModel(cfg, attention_fn, sp=<sp
group>)`` with an ``attention_fn`` of ``parallel.make_ring_attention``
or ``make_ulysses_attention``): each rank holds its S/sp tokens through
the whole model, where the JAX model under the examples' ``--sp``
leaves everything but the attention to GSPMD.  Positions default to
``sp_rank * S_local + arange(S_local)``; the hidden dropouts draw this
rank's window of the dense activation's threefry stream
(``threefry.window``), so the masks are the dense model's; the head
gives this rank's (B, S_local, V) logits, and :func:`lm_loss_shard`
takes its part of the next-token loss.

TP with SP in one model (``tp=`` and ``sp=`` together, on the
``(dp, sp, tp)`` mesh of ``parallel.create_mesh``): each rank runs its
H/tp heads over its S/sp tokens (Ulysses then needs ``(H / tp) % sp ==
0``), the vocab-parallel embedding keeps its rows and takes positions at
the sequence offset, the hidden dropouts draw the rank's window and the
attention dropout hashes the global (token, head) coordinates (the
``dropout_fn.offsets`` the TP attention sets carry the head offset to
the sequence-parallel attention); ``ops.vocab_parallel_lm_loss_shard``
takes the rank's part of the loss from its hidden states.

Pipeline parallelism: :class:`PipelinedGPT` (one stage a rank of the
mesh's pipe axis, over :class:`GPTEmbed` and :class:`GPTStage`),
optionally with a sequence axis and a model axis inside it.  The
Megatron blocks (:class:`RowParallelLinear`,
:class:`VocabParallelEmbedding`) live in ``parallel.tensor_parallel``,
shared with BERT; their names import from here as before.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models._remat import remat as remat_block
from apex_tpu_torch.models.bert import _drop, _dropout_scope, _rows, \
    attention_dropout_fn, dot_product_attention
from apex_tpu_torch.models.pipelined_common import PipelinedCommon, \
    gather_seq, rank_state_dict
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.decode_attention import (
    cached_attention,
    chunk_cached_attention,
)
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from apex_tpu_torch.parallel.collectives import copy_to_group, \
    gather_from_group
from apex_tpu_torch.parallel import tensor_parallel as tpar
from apex_tpu_torch.parallel.mesh import ProcessGroup
# the Megatron blocks live beside the rules; the names stay importable
# from here
from apex_tpu_torch.parallel.tensor_parallel import RowParallelLinear, \
    TPPlace as _TP, VocabParallelEmbedding, \
    head_slice_dropout as _head_slice_dropout, tp_place as _tp_place

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # rematerialize each block in the backward (training only)
    remat: bool = False


def gpt_small() -> GPTConfig:
    """The 124M 12x768 configuration (GPT-2 small)."""
    return GPTConfig()


def gpt_medium() -> GPTConfig:
    return GPTConfig(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096)


def padded_vocab(vocab_size: int, tp: int) -> int:
    """``vocab_size`` rounded up to a multiple of ``128 * tp``: the JAX
    example's padding of the embedding rows under the vocab-parallel
    loss (Megatron's ``make_vocab_size_divisible_by``; GPT-2's 50257 at
    ``--tp 2`` is 50432)."""
    unit = 128 * tp
    return -(-vocab_size // unit) * unit


def causal_dot_product_attention(q, k, v, bias=None, dropout_fn=None):
    """The default attention path: the causal mask folded into the
    additive bias, then ``bert.dot_product_attention`` (fp32 softmax,
    ``dropout_fn`` on the probs), as the JAX model delegates."""
    sq, sk = q.shape[1], k.shape[1]
    pos_q = torch.arange(sq, device=q.device)
    pos_k = torch.arange(sk, device=q.device)
    cmask = torch.where(pos_q[:, None] >= pos_k[None, :], 0.0, NEG_INF)
    bias = cmask[None, None] if bias is None else bias + cmask[None, None]
    return dot_product_attention(q, k, v, bias=bias, dropout_fn=dropout_fn)


class GPTSelfAttention(nn.Module):
    """Under TP (``tp``, a :class:`_TP`) q/k/v hold this rank's heads and
    ``output`` is row-parallel."""

    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32,
                 tp: Optional[_TP] = None):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        n = tp.size if tp is not None else 1
        self.tp = tp
        self.num_heads_total = cfg.num_attention_heads
        self.num_heads = cfg.num_attention_heads // n
        hl = h // n
        self.attention_fn = attention_fn
        self.query = nn.Linear(h, hl, device=dev, dtype=dtype)
        self.key = nn.Linear(h, hl, device=dev, dtype=dtype)
        self.value = nn.Linear(h, hl, device=dev, dtype=dtype)
        self.output = nn.Linear(h, h, device=dev, dtype=dtype) if tp is None \
            else RowParallelLinear(hl, h, tp, device=dev, dtype=dtype)
        self.dropout = threefry.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x, attn_bias, cache_view=None, return_kv: bool = False,
                kv_quant: bool = False, dropout_key=None,
                attention_seed=None):
        """``cache_view``: ``(k_ctx, v_ctx, ctx_bias)`` with k/v_ctx
        (B, T, H, D) gathered cache context and ctx_bias (B, T).  A single
        new token (decode) attends [context; self] through
        ``cached_attention``; a chunk attends [context; chunk] through
        ``chunk_cached_attention``.  ``return_kv`` also returns this call's
        freshly projected ``(k, v)``.

        ``kv_quant``: fresh K/V are quantized here, so attention sees
        the same int8 grid whether a key is fresh or read back from the
        pool.  ``cache_view`` is then ``(k_ctx, v_ctx, ctx_bias,
        k_scale_ctx, v_scale_ctx)`` with int8 context; the fresh int8
        K/V and their scales concatenate onto it and nothing is cast to
        the compute dtype (the attention ops widen at read).  Without a
        cache view, ``attention_fn`` attends the dequantized K/V.
        ``return_kv`` then returns ``((k_q, k_scale), (v_q,
        v_scale))``.

        ``dropout_key``: the attention's flax scope (or a key for a
        standalone call) when attention dropout is on; its
        ``Dropout_0`` drops the default path's probs, and a custom
        ``attention_fn`` gets the rate and the scope's per-call seed
        (``attention_seed`` when already drawn: a 0-d int32 tensor on
        the model's device)."""
        b, s, h = x.shape
        nh = self.num_heads
        hd = h // self.num_heads_total
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        q = self.query(x).view(b, s, nh, hd)
        k = self.key(x).view(b, s, nh, hd)
        v = self.value(x).view(b, s, nh, hd)
        kv_out = (k, v)
        if kv_quant:
            (k_q, k_s), (v_q, v_s) = kv_out = quantize_kv(k), quantize_kv(v)
        if cache_view is not None:
            ks_full = vs_full = None
            if kv_quant:
                k_ctx, v_ctx, ctx_bias, ks_ctx, vs_ctx = cache_view
                k_full = torch.cat([k_ctx, k_q], dim=1)
                v_full = torch.cat([v_ctx, v_q], dim=1)
                ks_full = torch.cat([ks_ctx, k_s], dim=1)
                vs_full = torch.cat([vs_ctx, v_s], dim=1)
            else:
                k_ctx, v_ctx, ctx_bias = cache_view
                k_full = torch.cat([k_ctx.to(k.dtype), k], dim=1)
                v_full = torch.cat([v_ctx.to(v.dtype), v], dim=1)
            if s == 1:
                # decode: the self slot is always live (bias 0)
                bias = torch.cat([ctx_bias, ctx_bias.new_zeros((b, 1))],
                                 dim=1)
                ctx = cached_attention(q, k_full, v_full, kv_bias=bias,
                                       k_scale=ks_full, v_scale=vs_full)
            else:
                ctx = chunk_cached_attention(q, k_full, v_full, ctx_bias,
                                             k_scale=ks_full,
                                             v_scale=vs_full)
        else:
            if kv_quant:
                k = dequantize_kv(k_q, k_s, k.dtype)
                v = dequantize_kv(v_q, v_s, v.dtype)
            attn = self.attention_fn or causal_dot_product_attention
            dropout_fn = None
            if dropout_key is not None and self.dropout.rate > 0:
                scope = threefry.RngScope.of(dropout_key)
                fused = self.attention_fn is not None
                if self.tp is not None and not fused:
                    dropout_fn = _head_slice_dropout(
                        self.dropout, scope, self.tp, self.num_heads_total)
                else:
                    dropout_fn = attention_dropout_fn(
                        self.dropout, scope, fused, attention_seed,
                        x.device)
                if self.tp is not None and fused:
                    # the flash kernels hash GLOBAL head coordinates
                    dropout_fn.offsets = (0, 0, self.tp.rank * nh,
                                          self.num_heads_total)
            ctx = attn(q, k, v, bias=attn_bias, dropout_fn=dropout_fn)
        out = self.output(ctx.reshape(b, s, nh * hd))
        if return_kv:
            return out, kv_out
        return out


class GPTBlock(nn.Module):
    """Pre-LN: x + drop(Attn(LN(x))); x + drop(MLP(LN(x))), ``drop`` one
    module (flax's ``Dropout_0`` of the block) called twice.
    ``dropout_key`` is the block's flax scope when dropout is on."""

    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32,
                 tp: Optional[_TP] = None):
        super().__init__()
        dev = resolve_device(device)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        il = cfg.intermediate_size // (tp.size if tp is not None else 1)
        self.tp = tp
        self.attn_ln = FusedLayerNorm(h, eps=eps, device=dev, dtype=dtype)
        self.attention = GPTSelfAttention(cfg, attention_fn, device=dev,
                                          dtype=dtype, tp=tp)
        self.mlp_ln = FusedLayerNorm(h, eps=eps, device=dev, dtype=dtype)
        self.mlp_in = nn.Linear(h, il, device=dev, dtype=dtype)
        self.mlp_out = nn.Linear(il, h, device=dev, dtype=dtype) \
            if tp is None else RowParallelLinear(il, h, tp, device=dev,
                                                 dtype=dtype)
        self.drop = threefry.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias, cache_view=None, return_kv: bool = False,
                kv_quant: bool = False, dropout_key=None,
                attention_seed=None, drop_window=None):
        """``drop_window``: x is a sequence-parallel rank's slice of the
        dense activation (``threefry.window``)."""
        scope = None if dropout_key is None \
            else threefry.RngScope.of(dropout_key)
        h = self.attention(self.attn_ln(x), attn_bias, cache_view=cache_view,
                           return_kv=return_kv, kv_quant=kv_quant,
                           dropout_key=None if scope is None
                           else scope.push("attention"),
                           attention_seed=attention_seed)
        kv = None
        if return_kv:
            h, kv = h
        x = x + _drop(self.drop, h, scope, drop_window)
        h = self.mlp_ln(x)
        if self.tp is not None:
            h = copy_to_group(h, self.tp.group)
        h = self.mlp_out(F.gelu(self.mlp_in(h), approximate="tanh"))
        if return_kv:
            return x + _drop(self.drop, h, scope, drop_window), kv
        return x + _drop(self.drop, h, scope, drop_window)


class GPTLMHeadModel(nn.Module):
    """Token + position embeddings -> pre-LN blocks -> final LN ->
    weight-tied LM head.  Returns (B, S, V) fp32 logits.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``device="cpu"`` is passed.  ``seed`` initialises the weights with the
    reference's distributions (normal(initializer_range) for embeddings
    and projection weights, zero biases, unit LN scales) from a CPU
    ``torch.Generator``, so a seed gives the same weights on any device;
    ``seed=None`` leaves PyTorch's default init for callers that load a
    state dict.

    Serving hooks (``serving.engine`` is the caller): ``positions``
    (B, S) explicit position indices; ``cache_views`` ``(k_ctx, v_ctx,
    ctx_bias)`` with k/v_ctx (L, B, T, H, D) per-layer gathered context;
    ``return_kv`` also returns the per-layer fresh ``(k, v)`` list;
    ``kv_quant`` serves from the int8 pool: ``cache_views`` grows the
    per-layer (L, B, T, H) scale legs (a 5-tuple), fresh K/V are
    quantized at the projection, and ``return_kv`` yields per-layer
    ``((k_q, k_scale), (v_q, v_scale))``.

    ``tp`` (a ``parallel.ProcessGroup``, the mesh's model group) builds
    this rank's part of the tensor-parallel model (module docstring);
    its forward needs ``return_hidden=True``.  ``sp`` (the mesh's
    sequence group) makes it a sequence-parallel rank's model: its
    ``input_ids`` are this rank's S_local tokens and ``attention_fn``
    must attend over the group (module docstring).
    """

    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0,
                 tp: Optional[ProcessGroup] = None,
                 sp: Optional[ProcessGroup] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        if sp is not None and attention_fn is None:
            raise ValueError(
                "a sequence-parallel GPT takes a sequence-parallel "
                "attention_fn (parallel.make_ring_attention or "
                "make_ulysses_attention)")
        self.sp = sp
        place = self.tp = _tp_place(tp)
        if place is not None:
            n = place.size
            for what, size in (("num_attention_heads",
                                cfg.num_attention_heads),
                               ("intermediate_size", cfg.intermediate_size),
                               ("vocab_size", cfg.vocab_size)):
                if size % n:
                    raise ValueError(f"{what} {size} does not divide over "
                                     f"{n} tensor-parallel ranks")
            self.wte = VocabParallelEmbedding(cfg.vocab_size // n, h, place,
                                              device=dev, dtype=dtype)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, h, device=dev,
                                    dtype=dtype)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, h, device=dev,
                                dtype=dtype)
        self.blocks = nn.ModuleList(
            GPTBlock(cfg, attention_fn, device=dev, dtype=dtype, tp=place)
            for _ in range(cfg.num_hidden_layers))
        self.final_ln = FusedLayerNorm(h, eps=cfg.layer_norm_eps, device=dev,
                                       dtype=dtype)
        self.embed_dropout = threefry.Dropout(cfg.hidden_dropout_prob)
        self.attention_fn = attention_fn
        if seed is not None:
            self.reset_parameters(seed)

    def tp_specs(self) -> Dict[str, tuple]:
        """Each parameter's split under ``parallel.gpt_tp_rules`` at this
        model's TP size (``{}`` without TP), read from the full model's
        shapes."""
        if self.tp is None:
            return {}
        full = GPTLMHeadModel(self.cfg, device="meta", seed=None)
        return tpar.param_specs(dict(full.named_parameters()),
                                tpar.Mesh({"model": self.tp.size}),
                                tpar.gpt_tp_rules(),
                                num_heads=self.cfg.num_attention_heads)

    def tp_places(self) -> Dict[str, tuple]:
        """Each local parameter's ``parallel.tensor_parallel.Place`` (its
        split with the heads kept, and how it reads in the JAX layout):
        the ``like_params`` ZeRO-1 shards the tree layout's moments
        with."""
        n = self.tp.size if self.tp is not None else 1
        specs = {}
        if self.tp is not None:
            full = GPTLMHeadModel(self.cfg, device="meta", seed=None)
            specs = tpar.param_specs(dict(full.named_parameters()),
                                     tpar.Mesh({"model": n}),
                                     tpar.gpt_tp_rules(),
                                     num_heads=self.cfg.num_attention_heads,
                                     keep_heads=True)
        return tpar.param_places(self, specs, {"model": n},
                                 self.cfg.num_attention_heads)

    def reset_parameters(self, seed: int) -> None:
        from apex_tpu_torch.parallel.tensor_parallel import reset_seeded
        reset_seeded(self, self.tp_specs(),
                     {} if self.tp is None else {"model": self.tp}, seed,
                     self.cfg.initializer_range)

    def forward(self, input_ids, attention_mask=None, positions=None,
                cache_views=None, return_kv: bool = False,
                kv_quant: bool = False, deterministic: bool = True,
                dropout_key=None, return_hidden: bool = False):
        """``dropout_key``: the key the JAX model takes as
        ``rngs={"dropout": key}``; needed when ``deterministic`` is False
        and a dropout rate is above 0.  ``return_hidden``: the final LN's
        output (B, S, H) in place of the logits, for
        ``ops.vocab_parallel_lm_loss``."""
        cfg = self.cfg
        b, s = input_ids.shape
        if self.tp is not None and (not return_hidden or return_kv
                                    or cache_views is not None):
            raise ValueError(
                "a tensor-parallel GPT trains only: pass return_hidden=True "
                "and take the loss with ops.vocab_parallel_lm_loss "
                "(serving under TP is not ported)")
        offset, window = 0, None
        if self.sp is not None and dist.is_initialized():
            n_sp, offset = self.sp.size(), self.sp.rank() * s
            window = threefry.window((b, s * n_sp, cfg.hidden_size), 1,
                                     offset, s)
        if positions is None:
            positions = offset + torch.arange(s, device=input_ids.device)[
                None, :]
        scope = _dropout_scope(cfg, deterministic, dropout_key)
        x = _drop(self.embed_dropout, self.wte(input_ids)
                  + self.wpe(positions), scope, window)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               NEG_INF).float()
        n = cfg.num_hidden_layers
        scopes = [None if scope is None else scope.push(f"block_{i}")
                  for i in range(n)]
        seeds = [None] * n
        if scope is not None and self.attention_fn is not None \
                and cfg.attention_probs_dropout_prob > 0 \
                and cache_views is None:
            # every block's attention seed in one copy to the device,
            # drawn before any block runs (so a recompute draws none)
            seeds = threefry.attention_seeds(
                [sc.push("attention") for sc in scopes], x.device)
        remat = cfg.remat and not return_kv and cache_views is None \
            and torch.is_grad_enabled()
        kvs = []
        for i, block in enumerate(self.blocks):
            cv = None
            if cache_views is not None:
                k_ctx, v_ctx, ctx_bias, *scales = cache_views
                cv = (k_ctx[i], v_ctx[i], ctx_bias, *(t[i] for t in scales))
            if return_kv:
                x, kv = block(x, bias, cache_view=cv, return_kv=True,
                              kv_quant=kv_quant, dropout_key=scopes[i],
                              attention_seed=seeds[i])
                kvs.append(kv)
            elif remat:
                x = remat_block(block, scopes[i], x, bias, kv_quant=kv_quant,
                                attention_seed=seeds[i], drop_window=window)
            else:
                x = block(x, bias, cache_view=cv, kv_quant=kv_quant,
                          dropout_key=scopes[i], attention_seed=seeds[i],
                          drop_window=window)
        x = self.final_ln(x)
        if return_hidden:
            return x
        logits = F.linear(x, self.wte.weight).float()  # weight-tied head
        if return_kv:
            return logits, kvs
        return logits


class GPTEmbed(nn.Module):
    """Token + position embeddings + dropout, split out for pipeline
    parallelism (``wte``, ``wpe`` as :class:`GPTLMHeadModel`'s); its
    dropout scope's root is the module (the JAX ``GPTEmbed``'s).
    ``tp`` (a ``TPPlace``): ``wte`` vocab-parallel where the vocabulary
    divides (``vocab_tp``), else whole, as ``param_specs`` falls back."""

    def __init__(self, cfg: GPTConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[_TP] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.vocab_tp = tp if tp is not None \
            and cfg.vocab_size % tp.size == 0 else None
        self.wte = nn.Embedding(cfg.vocab_size, h, device=dev, dtype=dtype) \
            if self.vocab_tp is None else VocabParallelEmbedding(
                cfg.vocab_size // tp.size, h, tp, device=dev, dtype=dtype)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, h, device=dev,
                                dtype=dtype)
        self.embed_dropout = threefry.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, deterministic: bool = True,
                dropout_key=None, offset=0, window=None):
        """``offset``: the position of the first token; ``window``: the
        activation is that slice of a larger one's dropout stream
        (``threefry.window``)."""
        scope = _dropout_scope(self.cfg, deterministic, dropout_key)
        pos = offset + torch.arange(input_ids.shape[1],
                                    device=input_ids.device)
        return _drop(self.embed_dropout, self.wte(input_ids)
                     + self.wpe(pos[None, :]), scope, window)


class GPTStage(nn.Module):
    """``n_layers`` consecutive pre-LN blocks, ``block_0`` .., one
    pipeline stage; its dropout scope's root is the stage.  ``tp`` (a
    ``TPPlace``): the blocks tensor-parallel (:class:`GPTBlock`)."""

    def __init__(self, cfg: GPTConfig, n_layers: int,
                 attention_fn: Optional[Callable] = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 tp: Optional[_TP] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.n_layers = cfg, n_layers
        self.attention_fn = attention_fn
        for i in range(n_layers):
            self.add_module(f"block_{i}", GPTBlock(
                cfg, attention_fn, device=dev, dtype=dtype, tp=tp))

    def forward(self, x, attn_bias, deterministic: bool = True,
                dropout_key=None):
        cfg = self.cfg
        scope = _dropout_scope(cfg, deterministic, dropout_key)
        scopes = [None if scope is None else scope.push(f"block_{i}")
                  for i in range(self.n_layers)]
        seeds = [None] * self.n_layers
        if scope is not None and self.attention_fn is not None \
                and cfg.attention_probs_dropout_prob > 0:
            seeds = threefry.attention_seeds(
                [sc.push("attention") for sc in scopes], x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(self.n_layers):
            block = getattr(self, f"block_{i}")
            if remat:
                x = remat_block(block, scopes[i], x, attn_bias,
                                attention_seed=seeds[i])
            else:
                x = block(x, attn_bias, dropout_key=scopes[i],
                          attention_seed=seeds[i])
        return x


class PipelinedGPT(PipelinedCommon, nn.Module):
    """GPT over the mesh's ``pipe_axis`` group, one stage a rank: the
    twin of the JAX ``PipelinedGPT`` (the decoder counterpart of
    ``models.PipelinedBert``, the same schedules).  Rank r holds
    ``embed.*`` (:class:`GPTEmbed`: ``wte``, ``wpe``), ``stages.block_<i>``
    (its ``L / pp`` blocks, dense block ``r * L / pp + i``) and ``head.*``
    (the final LayerNorm); the LM head is tied to ``embed.wte``.

    ``forward`` is GPipe: the (B, S, V) fp32 logits of this rank's
    batch.  :meth:`loss_and_grad_1f1b` is 1F1B with ``{"head", "wte"}``
    as the schedule's ``loss_params``: ``wte``'s gradient is the
    embedding's vjp plus the head's, summed, the tied parameter's chain
    rule.  With ``attention_mask`` each microbatch's loss is its masked
    SUM over the global denominator ``total_keep / (M * n_dp)`` (the
    keep count all-reduced over the data group), so the schedule's mean
    over microbatches and the caller's data mean give the global masked
    mean exactly under any padding skew.  ``batch_axis``, ``seq_axis``
    (causal ring or Ulysses; ``forward`` gives this rank's (B, S/sp, V)
    logits, :meth:`loss_and_grad_1f1b` takes Ulysses only and gathers
    the hidden states for the shifted loss), dropout and ``seed`` as in
    ``PipelinedBert`` (the dense model is :class:`GPTLMHeadModel`).

    ``tp_axis`` (the mesh's model axis): the blocks tensor-parallel
    (``parallel.gpt_tp_rules``; the heads and the MLP width must divide,
    as :class:`GPTLMHeadModel`'s), the tied ``wte`` vocab-sharded on
    every stage where the vocabulary divides (else whole, the rules'
    fallback).  The LM head is column-parallel: each rank's (B, S, V/n)
    logits are gathered over the model group, so ``forward`` and the
    1F1B loss see the whole vocabulary."""

    tp_rules_name = "gpt_tp_rules"

    def __init__(self, cfg: GPTConfig, mesh, pp: int,
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
                    "parallel.make_ulysses_attention(seq_axis, causal=True)")
        dev = resolve_device(device)
        if self.tp is not None:
            for what, size in (("num_attention_heads",
                                cfg.num_attention_heads),
                               ("intermediate_size", cfg.intermediate_size)):
                if size % self.tp.size:
                    raise ValueError(f"{what} {size} does not divide over "
                                     f"{self.tp.size} tensor-parallel ranks")
        self.embed = GPTEmbed(cfg, device=dev, dtype=dtype, tp=self.tp)
        self.stages = GPTStage(cfg, cfg.num_hidden_layers // pp,
                               attention_fn, device=dev, dtype=dtype,
                               tp=self.tp)
        self.head = FusedLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                   device=dev, dtype=dtype)
        if seed is not None:
            self.reset_parameters(seed)

    def _meta_layout(self):
        cfg = self.cfg
        return nn.ModuleDict({
            "embed": GPTEmbed(cfg, device="meta"),
            "stages": GPTStage(cfg, self.stages.n_layers, device="meta"),
            "head": FusedLayerNorm(cfg.hidden_size, device="meta")})

    def reset_parameters(self, seed: int) -> None:
        """The dense model's draws from ``seed``, this rank's kept."""
        self._reset_from_dense(
            GPTLMHeadModel(self.cfg, device="meta", seed=None), _rank_name,
            self.stages.n_layers, seed)

    def _build_stage_fn(self, needs_rng, base_key, deterministic, bias, mb):

        def stage_fn(sp, h, j):
            key = self._stage_dropout_key(base_key, j) if needs_rng \
                else None
            return torch.func.functional_call(
                self.stages, sp, (h, _rows(bias, j, mb)),
                {"deterministic": deterministic, "dropout_key": key})

        return stage_fn

    def _stage_inputs(self, input_ids, attention_mask, deterministic,
                      dropout_key, caller):
        """This rank's embeddings (of its tokens under ``seq_axis``) and
        the stage body, both schedules' prologue."""
        needs_rng, base_key, embed_key = self._dropout_setup(
            deterministic, dropout_key, caller)
        mask = self._seq_slice(attention_mask)
        bias = None if mask is None else torch.where(
            mask[:, None, None, :] > 0, 0.0, NEG_INF).float()
        stage_fn = self._build_stage_fn(
            needs_rng, base_key, deterministic, bias,
            input_ids.shape[0] // self.num_microbatches)
        offset, window = self._embed_window(input_ids)
        x = self.embed(self._seq_slice(input_ids), deterministic, embed_key,
                       offset, window)
        return x, stage_fn

    def _head(self, h, head_p, wte):
        """The tied LM head's fp32 logits (B, S, V): under TP the
        column-parallel product of this rank's vocab rows, gathered over
        the model group."""
        x = torch.func.functional_call(self.head, head_p, (h,))
        tp = self.embed.vocab_tp
        if tp is None:
            return F.linear(x, wte).float()
        return gather_from_group(F.linear(copy_to_group(x, tp.group), wte),
                                 tp.group).float()

    def forward(self, input_ids, attention_mask=None,
                deterministic: bool = True, dropout_key=None):
        from apex_tpu_torch.parallel.pipeline import gpipe
        x, stage_fn = self._stage_inputs(
            input_ids, attention_mask, deterministic, dropout_key,
            "PipelinedGPT.apply")
        h = gpipe(self._pipe(), stage_fn,
                  dict(self.stages.named_parameters()), x,
                  self.num_microbatches, microbatch_index=True)
        return self._head(h, dict(self.head.named_parameters()),
                          self.embed.wte.weight)

    def loss_and_grad_1f1b(self, input_ids, targets, attention_mask=None,
                           deterministic: bool = True, dropout_key=None):
        """1F1B on this rank's batch: ``targets`` the (B, S) token ids the
        loss shifts against (usually ``input_ids``).  Returns ``(loss,
        grads)``, the gradients a ``{name: tensor}`` dict of this rank's
        parameters, ``embed.wte.weight``'s the sum of its lookup's and
        the LM head's; both this data index's, as
        ``PipelinedBert.loss_and_grad_1f1b``'s (under ``seq_axis`` the
        lookup's summed over the sequence group, the head's whole on
        every shard)."""
        from apex_tpu_torch.parallel.pipeline import onef1b
        self._check_onef1b()
        m = self.num_microbatches
        embed = dict(self.embed.named_parameters())
        with torch.enable_grad():
            x, stage_fn = self._stage_inputs(
                input_ids, attention_mask, deterministic, dropout_key,
                "loss_and_grad_1f1b")
        seq = self._seq_group()

        def pl_loss(h, tgt, lp):
            logits = self._head(gather_seq(h, seq), lp["head"], lp["wte"])
            if "mask" in tgt:
                return (_lm_masked_sum(logits, tgt["ids"], tgt["mask"])
                        / tgt["denom"][0])
            return lm_loss(logits, tgt["ids"])

        tgt = {"ids": targets}
        if attention_mask is not None:
            keep = attention_mask[:, 1:].sum().float()
            n_dp = 1
            if self.batch_axis and dist.is_initialized():
                group = self.mesh.group(self.batch_axis)
                keep = keep.clone()
                dist.all_reduce(keep, group=group.handle)
                n_dp = group.size()
            tgt["mask"] = attention_mask
            tgt["denom"] = (keep.clamp_min(1.0) / (m * n_dp)).expand(
                targets.shape[0])
        loss_params = {"head": dict(self.head.named_parameters()),
                       "wte": embed["wte.weight"]}
        loss, g_stage, dx, g_lp = onef1b(
            self._pipe(), stage_fn, pl_loss,
            dict(self.stages.named_parameters()), x.detach(), tgt, m,
            loss_params, microbatch_index=True)
        g_embed = dict(zip(embed, torch.autograd.grad(
            x, list(embed.values()), dx)))
        # partial on each sequence shard: the lookup's and the stage's
        grads = self._sum_over_seq(
            {**{f"embed.{k}": v for k, v in g_embed.items()},
             **{f"stages.{k}": v for k, v in g_stage.items()}})
        # the tied wte: the lookup's gradient and the head's, summed
        grads["embed.wte.weight"] = grads["embed.wte.weight"] + g_lp["wte"]
        return loss, {**grads,
                      **{f"head.{k}": v for k, v in g_lp["head"].items()}}


def _rank_name(name: str, layers_per_stage: int, rank: int):
    """A dense :class:`GPTLMHeadModel` parameter's name on pipeline rank
    ``rank``, or None when another rank holds it."""
    if name.startswith("blocks."):
        i, rest = name[len("blocks."):].split(".", 1)
        stage, local = divmod(int(i), layers_per_stage)
        return f"stages.block_{local}.{rest}" if stage == rank else None
    if name.startswith("final_ln."):
        return "head." + name[len("final_ln."):]
    return "embed." + name


def dense_to_rank(state_dict: Mapping[str, torch.Tensor], cfg: GPTConfig,
                  pp: int, rank: int, tp: int = 1,
                  tp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """A dense :class:`GPTLMHeadModel` state dict (or gradient tree) as
    :class:`PipelinedGPT`'s on pipeline rank ``rank`` of ``pp``: dense
    block ``rank * L / pp + i`` becomes ``stages.block_<i>``, ``final_ln``
    ``head``, ``wte``/``wpe`` ``embed.*``; with ``tp`` above 1, model
    rank ``tp_rank``'s Megatron slice of each
    (``parallel.tensor_parallel.tp_slice``)."""
    return tpar.tp_slice(rank_state_dict(state_dict, _rank_name,
                                         cfg.num_hidden_layers // pp, rank),
                         tpar.gpt_tp_rules(), cfg.num_attention_heads, tp,
                         tp_rank)


def params_from_jax(params: Mapping, cfg: GPTConfig,
                    rank: Optional[int] = None, tp: int = 1,
                    tp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX package's GPT param tree (``{"params": ...}`` or its
    inner dict, leaves as numpy arrays) as this model's ``state_dict``.

    DenseGeneral q/k/v kernels (h, nh, hd) and the output kernel
    (nh, hd, h) flatten to (h, h) and transpose into ``nn.Linear``'s
    (out, in) layout; Dense kernels (in, out) transpose; embeddings and
    LN scale/bias carry over as they are.  A ``cfg`` whose vocab is
    padded (:func:`padded_vocab`, the JAX example's padding under
    ``--tp``) takes a JAX tree of the padded model as it is, or one of
    the true vocab with zero rows appended; ``parallel.shard_params``
    then cuts each TP rank's part.  A ``PipelinedGPT`` tree (``{"embed",
    "stages", "head"}``, the stage leaves stacked on dim 0) gives
    pipeline rank ``rank``'s state dict, row ``rank`` of each stacked
    leaf.  ``tp`` above 1: model rank ``tp_rank``'s Megatron slice of
    each leaf (``parallel.tensor_parallel.tp_slice``)."""
    p = params.get("params", params)
    if "stages" in p:
        stages = p["stages"]
        pp = np.asarray(stages["block_0"]["mlp_in"]["kernel"]).shape[0]
        lps = cfg.num_hidden_layers // pp
        mono = {"wte": p["embed"]["wte"], "wpe": p["embed"]["wpe"],
                "final_ln": p["head"]}
        for st in range(pp):
            for li in range(lps):
                mono[f"block_{st * lps + li}"] = pytree.tree_map(
                    lambda a, st=st: np.asarray(a)[st],
                    stages[f"block_{li}"])
        return dense_to_rank(params_from_jax(mono, cfg), cfg, pp,
                             0 if rank is None else rank, tp, tp_rank)
    if tp > 1:
        return tpar.tp_slice(params_from_jax(params, cfg),
                             tpar.gpt_tp_rules(), cfg.num_attention_heads, tp,
                             tp_rank)
    h = cfg.hidden_size
    rows = np.asarray(p["wte"]["embedding"]).shape[0]
    if rows > cfg.vocab_size:
        raise ValueError(f"the JAX tree's wte has {rows} rows, the config "
                         f"{cfg.vocab_size}")

    def t(a, shape=None):
        a = np.array(a)  # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    wte = np.asarray(p["wte"]["embedding"])
    if rows < cfg.vocab_size:
        wte = np.concatenate([wte, np.zeros((cfg.vocab_size - rows, h),
                                            wte.dtype)])
    sd = {"wte.weight": t(wte),
          "wpe.weight": t(p["wpe"]["embedding"]),
          "final_ln.scale": t(p["final_ln"]["scale"]),
          "final_ln.bias": t(p["final_ln"]["bias"])}
    for i in range(cfg.num_hidden_layers):
        blk, pre = p[f"block_{i}"], f"blocks.{i}."
        for ln in ("attn_ln", "mlp_ln"):
            sd[f"{pre}{ln}.scale"] = t(blk[ln]["scale"])
            sd[f"{pre}{ln}.bias"] = t(blk[ln]["bias"])
        att = blk["attention"]
        for name in ("query", "key", "value"):
            sd[f"{pre}attention.{name}.weight"] = t(
                np.asarray(att[name]["kernel"]).reshape(h, h).T)
            sd[f"{pre}attention.{name}.bias"] = t(att[name]["bias"], (h,))
        sd[f"{pre}attention.output.weight"] = t(
            np.asarray(att["output"]["kernel"]).reshape(h, h).T)
        sd[f"{pre}attention.output.bias"] = t(att["output"]["bias"])
        for name in ("mlp_in", "mlp_out"):
            sd[f"{pre}{name}.weight"] = t(np.asarray(blk[name]["kernel"]).T)
            sd[f"{pre}{name}.bias"] = t(blk[name]["bias"])
    return sd


def _lm_masked_sum(logits, input_ids, attention_mask):
    """Masked SUM of next-token cross entropy (no normalization)."""
    b, s, v = logits.shape
    per_tok = F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                              input_ids[:, 1:].reshape(-1).long(),
                              reduction="none").view(b, s - 1)
    return (per_tok * attention_mask[:, 1:].to(per_tok.dtype)).sum()


def lm_loss(logits, input_ids, attention_mask=None):
    """Next-token cross entropy in fp32: predict token t+1 from the
    prefix up to t.  Position S-1 has no target and is dropped; with a
    padding mask, positions whose TARGET is padding are dropped too.
    Mean over the kept positions."""
    if attention_mask is None:
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                               input_ids[:, 1:].reshape(-1).long())
    keep = attention_mask[:, 1:].sum().float()
    return (_lm_masked_sum(logits, input_ids, attention_mask)
            / keep.clamp_min(1.0))


def lm_loss_shard(logits, input_ids, rank: int, n: int):
    """A sequence-parallel rank's part of :func:`lm_loss`: the SUM of the
    next-token cross entropy over its positions (fp32), from its (B,
    S_local, V) ``logits`` and the batch's whole (B, S) ``input_ids``.
    The label of this rank's last position is the next shard's first
    token; the last rank drops its final position, which has none.  The
    loss of the batch is the sum over the ranks divided by ``B * (S -
    1)``."""
    b, s_local, v = logits.shape
    start = rank * s_local
    labels = input_ids[:, start + 1:start + s_local + 1]
    kept = labels.shape[1]            # s_local, or s_local - 1 at the end
    return F.cross_entropy(logits[:, :kept].reshape(-1, v).float(),
                           labels.reshape(-1).long(), reduction="sum")