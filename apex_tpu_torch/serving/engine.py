"""Prefill and single-token decode steps over the KV cache.

Twin of ``apex_tpu/serving/engine.py`` for the slice that serves greedy
traffic:

- **prefill** (one request, prompt zero-padded to a length *bucket*):
  the causal GPT forward through the flash kernel
  (``make_flash_attention(causal=True)``, the reference's
  ``serve_gpt.py --flash``) with
  ``return_kv=True``; the per-layer K/V scatter into the request's
  blocks, padded positions into the garbage block.  Padding to the same
  bucket ladder as the JAX engine keeps the shapes, and the numbers, the
  same.
- **decode** (the whole running batch, always ``max_batch_size`` wide):
  gather every slot's context through its block table, run one token per
  slot at its own position (``ops.cached_attention`` inside), scatter
  the new K/V, return next-token logits.
- **sampled variants** (``prefill_sampled`` / ``decode_sampled``): the
  same steps with the greedy argmax and the non-finite row guard on the
  device, returning token ids and finite flags instead of logits.

With ``kv_quant="int8"`` the pool stores int8 K/V and their fp32
scales: the model quantizes fresh K/V at the projection, prefill
attends the dequantized values through the flash kernel, and decode
hands the int8 context and its scales to ``ops.cached_attention``
(kernel B8), which widens them at read.

Empty decode slots ride along as no-ops: position 0 masks their whole
context, and their zeroed block table sends the K/V write to the
garbage block.  The pool is updated in place.

Not here yet: chunked prefill, verify, block copies, cross-pool
transfer, import/export, stochastic sampling and tensor parallelism.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from apex_tpu_torch.ops.flash_attention import make_flash_attention
from apex_tpu_torch.ops.sampling import finite_rows, greedy_argmax
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    context_bias,
    gather_context,
    gather_scales,
    init_kv_cache,
    resolve_kv_quant,
    slot_index,
    write_prefill,
    write_tokens,
)


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.int8`` -> ``"int8"``: the reference's dtype names."""
    return str(dtype).removeprefix("torch.")


def default_prefill_buckets(max_context: int,
                            smallest: int = 16) -> Tuple[int, ...]:
    """Power-of-two bucket ladder capped at ``max_context``."""
    buckets = []
    b = smallest
    while b < max_context:
        buckets.append(b)
        b *= 2
    buckets.append(max_context)
    return tuple(buckets)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``length`` (buckets ascending); raises past
    the largest."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"length {length} exceeds the largest bucket {buckets[-1]}")


class DecodeEngine:
    """The device half of the serving stack: owns the model, the cache
    pool and the prefill/decode steps — admission and batching live in
    ``serving.scheduler`` / ``serving.api``.

    Args:
      cfg: the GPT architecture.
      params: the model's ``state_dict`` (e.g. from
        :func:`models.gpt.params_from_jax` or
        ``GPTLMHeadModel(...).state_dict()``), copied onto ``device``.
      device: ``"cuda"`` (default) or ``"cpu"``; without CUDA the default
        raises.
      max_batch_size: decode batch width (running-request slots).
      max_context: per-request token capacity; default
        ``cfg.max_position_embeddings``.
      num_blocks: physical blocks in the pool (incl. the reserved garbage
        block 0); default ``max_batch_size`` full-context requests + 1.
      block_size: tokens per block.
      cache_dtype: KV compute dtype; None = the amp policy's
        ``cast_model_type``, else bfloat16
        (:func:`serving.kv_cache.resolve_cache_dtype`).
      kv_quant: ``"int8"`` stores the pool as int8 plus a per-slot,
        per-head fp32 scale sidecar; None (default) or ``"off"`` keeps
        it full width in ``cache_dtype``.

    Prefill attends through ``ops.flash_attention`` (causal) and decode
    through ``ops.cached_attention``; prompts pad to
    :func:`default_prefill_buckets` of ``max_context``.
    """

    def __init__(self, cfg: GPTConfig, params: Mapping[str, torch.Tensor], *,
                 device="cuda",
                 max_batch_size: int = 8,
                 max_context: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 block_size: int = 16,
                 cache_dtype: Optional[torch.dtype] = None,
                 kv_quant: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.quantized = self.kv_quant is not None
        self.max_batch_size = int(max_batch_size)
        self.max_context = int(max_context or cfg.max_position_embeddings)
        if self.max_context > cfg.max_position_embeddings:
            raise ValueError(
                f"max_context={self.max_context} exceeds the model's "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        self.block_size = int(block_size)
        self.blocks_per_seq = -(-self.max_context // self.block_size)
        if num_blocks is None:
            num_blocks = self.max_batch_size * self.blocks_per_seq + 1
        self.cache_cfg = KVCacheConfig(
            num_layers=cfg.num_hidden_layers,
            num_heads=cfg.num_attention_heads,
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            num_blocks=int(num_blocks),
            block_size=self.block_size,
            dtype=cache_dtype,
            quantize=self.kv_quant)
        self.allocator = BlockAllocator(self.cache_cfg)
        self.cache = init_kv_cache(self.cache_cfg, self.device)
        self.model = GPTLMHeadModel(cfg, make_flash_attention(causal=True),
                                    device=self.device, seed=None)
        self.model.load_state_dict(params)
        self.model.eval().requires_grad_(False)
        self.prefill_buckets = default_prefill_buckets(self.max_context)

    # -- device steps -----------------------------------------------------

    def _cache_views(self, tables, bias):
        """The model's ``cache_views`` for one gathered context:
        ``(k, v, bias)``, plus the scale legs under quantization."""
        k_ctx, v_ctx = gather_context(self.cache, tables, self.block_size)
        if not self.quantized:
            return (k_ctx, v_ctx, bias)
        ks_ctx, vs_ctx = gather_scales(self.cache, tables, self.block_size)
        return (k_ctx, v_ctx, bias, ks_ctx, vs_ctx)

    def _stack_kvs(self, kvs):
        """Per-layer fresh K/V -> the scatter layout: a stacked
        (L, B, S, H, D) pair, or under quantization the
        ``((k_q, k_scale), (v_q, v_scale))`` quadruple."""
        if self.quantized:
            return tuple((torch.stack([kv[i][0] for kv in kvs]),
                          torch.stack([kv[i][1] for kv in kvs]))
                         for i in (0, 1))
        return (torch.stack([kv[0] for kv in kvs]),
                torch.stack([kv[1] for kv in kvs]))

    @torch.no_grad()
    def _prefill_impl(self, ids, length, table):
        """ids (1, Sb) zero-padded prompt; length (1,) true length;
        table (1, blocks_per_seq).  Returns last-token logits (1, V)."""
        sb = ids.shape[1]
        pos = torch.arange(sb, device=self.device)[None, :]
        mask = (pos < length[:, None]).int()
        logits, kvs = self.model(ids, attention_mask=mask, return_kv=True,
                                 kv_quant=self.quantized)
        # padded positions scatter into the garbage block (slot 0)
        slots = torch.where(mask > 0, slot_index(table, pos, self.block_size),
                            0)
        write_prefill(self.cache, self._stack_kvs(kvs), slots)
        return logits[torch.arange(1, device=self.device), length - 1]

    @torch.no_grad()
    def _decode_impl(self, tokens, positions, tables):
        """tokens (B,) current input token per slot; positions (B,) its
        position (== cached context length); tables (B, blocks_per_seq).
        Returns logits (B, V)."""
        t_ctx = self.blocks_per_seq * self.block_size
        bias = context_bias(positions, t_ctx)
        logits, kvs = self.model(tokens[:, None],
                                 positions=positions[:, None],
                                 cache_views=self._cache_views(tables, bias),
                                 return_kv=True, kv_quant=self.quantized)
        slots = slot_index(tables, positions, self.block_size)
        write_tokens(self.cache, self._stack_kvs(kvs), slots)
        return logits[:, 0]

    # -- host API ---------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        try:
            return pick_bucket(length, self.prefill_buckets)
        except ValueError:
            raise ValueError(
                f"prompt length {length} exceeds max_context "
                f"{self.max_context}") from None

    def _to_device(self, *arrays: np.ndarray):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _prefill_args(self, prompt, block_table):
        n = len(prompt)
        sb = self.bucket_for(n)
        ids = np.zeros((1, sb), np.int64)
        ids[0, :n] = prompt
        table = np.zeros((1, self.blocks_per_seq), np.int64)
        table[0, :len(block_table)] = block_table
        return self._to_device(ids, np.asarray([n], np.int64), table)

    def _decode_args(self, tokens, positions, tables):
        return self._to_device(np.asarray(tokens, np.int64),
                               np.asarray(positions, np.int64),
                               np.asarray(tables, np.int64))

    def prefill(self, prompt, block_table) -> torch.Tensor:
        """Run one prompt through the bucketed prefill, writing its K/V
        into ``block_table``'s blocks.  Returns the last-token logits
        (V,)."""
        return self._prefill_impl(*self._prefill_args(prompt,
                                                      block_table))[0]

    def prefill_sampled(self, prompt, block_table):
        """:meth:`prefill` with the greedy argmax and finite guard on the
        device: returns ``(token_ids (1,) int32, finite (1,) bool)``."""
        last = self._prefill_impl(*self._prefill_args(prompt, block_table))
        return greedy_argmax(last), finite_rows(last)

    def decode(self, tokens, positions, tables) -> torch.Tensor:
        """One decode step over all slots: (B,), (B,), (B, blocks_per_seq)
        with inactive slots zeroed.  Returns next-token logits (B, V)."""
        return self._decode_impl(*self._decode_args(tokens, positions,
                                                    tables))

    def decode_sampled(self, tokens, positions, tables):
        """:meth:`decode` with the greedy argmax and finite guard on the
        device: returns ``(token_ids (B,) int32, finite (B,) bool)``."""
        logits = self._decode_impl(*self._decode_args(tokens, positions,
                                                      tables))
        return greedy_argmax(logits), finite_rows(logits)

    def memory_info(self) -> dict:
        """Pool geometry for ``stats()["memory"]``: usable blocks, tokens
        per block, the pool's bytes by its config and as read off the
        live tensors (one device: the two agree), the bytes of one
        block, and the storage and compute dtypes.  Under quantization
        every count includes the scale sidecar."""
        cfg = self.cache_cfg
        return {
            "blocks_usable": cfg.num_blocks - 1,
            "block_size": cfg.block_size,
            "pool_tokens": cfg.usable_tokens,
            "pool_bytes": cfg.bytes(),
            "pool_bytes_per_device": sum(
                t.numel() * t.element_size() for t in self.cache.values()),
            "bytes_per_block": cfg.bytes_per_block,
            "cache_dtype": _dtype_name(self.cache["k"].dtype),
            "quantize": cfg.quantize,
            "compute_dtype": _dtype_name(cfg.resolved_dtype()),
        }

    def reset_cache(self):
        """Zero the pool and refill the allocator in place."""
        for arr in self.cache.values():
            arr.zero_()
        self.allocator.reset()
