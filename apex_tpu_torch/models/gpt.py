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

Not here: the pipelined and tensor-parallel variants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models._remat import remat as remat_block
from apex_tpu_torch.models.bert import _drop, _dropout_scope, \
    attention_dropout_fn, dot_product_attention
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.decode_attention import (
    cached_attention,
    chunk_cached_attention,
)
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv

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
    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.attention_fn = attention_fn
        self.query = nn.Linear(h, h, device=dev, dtype=dtype)
        self.key = nn.Linear(h, h, device=dev, dtype=dtype)
        self.value = nn.Linear(h, h, device=dev, dtype=dtype)
        self.output = nn.Linear(h, h, device=dev, dtype=dtype)
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
        q = self.query(x).view(b, s, nh, h // nh)
        k = self.key(x).view(b, s, nh, h // nh)
        v = self.value(x).view(b, s, nh, h // nh)
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
                dropout_fn = attention_dropout_fn(
                    self.dropout, threefry.RngScope.of(dropout_key),
                    self.attention_fn is not None, attention_seed, x.device)
            ctx = attn(q, k, v, bias=attn_bias, dropout_fn=dropout_fn)
        out = self.output(ctx.reshape(b, s, h))
        if return_kv:
            return out, kv_out
        return out


class GPTBlock(nn.Module):
    """Pre-LN: x + drop(Attn(LN(x))); x + drop(MLP(LN(x))), ``drop`` one
    module (flax's ``Dropout_0`` of the block) called twice.
    ``dropout_key`` is the block's flax scope when dropout is on."""

    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attn_ln = FusedLayerNorm(h, eps=eps, device=dev, dtype=dtype)
        self.attention = GPTSelfAttention(cfg, attention_fn, device=dev,
                                          dtype=dtype)
        self.mlp_ln = FusedLayerNorm(h, eps=eps, device=dev, dtype=dtype)
        self.mlp_in = nn.Linear(h, cfg.intermediate_size, device=dev,
                                dtype=dtype)
        self.mlp_out = nn.Linear(cfg.intermediate_size, h, device=dev,
                                 dtype=dtype)
        self.drop = threefry.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias, cache_view=None, return_kv: bool = False,
                kv_quant: bool = False, dropout_key=None,
                attention_seed=None):
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
        x = x + _drop(self.drop, h, scope)
        h = self.mlp_out(F.gelu(self.mlp_in(self.mlp_ln(x)),
                                approximate="tanh"))
        if return_kv:
            return x + _drop(self.drop, h, scope), kv
        return x + _drop(self.drop, h, scope)


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
    """

    def __init__(self, cfg: GPTConfig, attention_fn: Optional[Callable] = None,
                 *, device="cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.wte = nn.Embedding(cfg.vocab_size, h, device=dev, dtype=dtype)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, h, device=dev,
                                dtype=dtype)
        self.blocks = nn.ModuleList(
            GPTBlock(cfg, attention_fn, device=dev, dtype=dtype)
            for _ in range(cfg.num_hidden_layers))
        self.final_ln = FusedLayerNorm(h, eps=cfg.layer_norm_eps, device=dev,
                                       dtype=dtype)
        self.embed_dropout = threefry.Dropout(cfg.hidden_dropout_prob)
        self.attention_fn = attention_fn
        if seed is not None:
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("_ln.scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32)
                        .normal_(0.0, std, generator=gen))

    def forward(self, input_ids, attention_mask=None, positions=None,
                cache_views=None, return_kv: bool = False,
                kv_quant: bool = False, deterministic: bool = True,
                dropout_key=None):
        """``dropout_key``: the key the JAX model takes as
        ``rngs={"dropout": key}``; needed when ``deterministic`` is False
        and a dropout rate is above 0."""
        cfg = self.cfg
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :]
        scope = _dropout_scope(cfg, deterministic, dropout_key)
        x = _drop(self.embed_dropout, self.wte(input_ids)
                  + self.wpe(positions), scope)
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
                                attention_seed=seeds[i])
            else:
                x = block(x, bias, cache_view=cv, kv_quant=kv_quant,
                          dropout_key=scopes[i], attention_seed=seeds[i])
        x = self.final_ln(x)
        logits = F.linear(x, self.wte.weight).float()  # weight-tied head
        if return_kv:
            return logits, kvs
        return logits


def params_from_jax(params: Mapping, cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's GPT param tree (``{"params": ...}`` or its
    inner dict, leaves as numpy arrays) as this model's ``state_dict``.

    DenseGeneral q/k/v kernels (h, nh, hd) and the output kernel
    (nh, hd, h) flatten to (h, h) and transpose into ``nn.Linear``'s
    (out, in) layout; Dense kernels (in, out) transpose; embeddings and
    LN scale/bias carry over as they are."""
    p = params.get("params", params)
    h = cfg.hidden_size

    def t(a, shape=None):
        a = np.array(a)  # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(np.ascontiguousarray(a))

    sd = {"wte.weight": t(p["wte"]["embedding"]),
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
