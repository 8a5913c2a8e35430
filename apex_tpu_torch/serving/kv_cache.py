"""Block-table-indexed KV cache — the serving memory manager.

Twin of ``apex_tpu/serving/kv_cache.py`` without quantization, copies or
prefix-cache hooks.  The cache is one preallocated pool of
``num_blocks`` blocks of ``block_size`` token slots per layer,

    k, v: (num_layers, num_blocks * block_size, num_heads, head_dim)

held as a dict of tensors and updated IN PLACE (``index_copy_``) where
the JAX version rebuilds it functionally and donates it.  Every request
owns an ordered block table mapping its logical positions to physical
blocks.  Physical block 0 is the reserved garbage sink: unallocated
table entries and padded positions point at it, and the context bias
masks whatever sits there.

The default cache dtype is bfloat16 (the port has no amp policy yet);
``KVCacheConfig(dtype=torch.float32)`` pins a full-width pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

NEG_INF = -1e9


def resolve_cache_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """An explicit floating dtype wins; None means bfloat16.  Integer
    dtypes are refused: the pool holds compute-dtype K/V."""
    if dtype is None:
        return torch.bfloat16
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(
            f"cache dtype must be a floating-point torch.dtype, got {dtype}")
    return dtype


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Geometry of the block pool.  ``num_blocks`` INCLUDES the reserved
    garbage block 0, so the usable capacity is
    ``(num_blocks - 1) * block_size`` tokens."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_blocks: int
    block_size: int = 16
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(
                "num_blocks must be >= 2 (block 0 is the reserved "
                f"garbage sink); got {self.num_blocks}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1; got "
                             f"{self.block_size}")
        self.resolved_dtype()

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size

    def resolved_dtype(self) -> torch.dtype:
        return resolve_cache_dtype(self.dtype)


def init_kv_cache(cfg: KVCacheConfig, device) -> Dict[str, torch.Tensor]:
    """The zeroed pool ``{"k", "v"}``, each (L, num_slots, H, D)."""
    shape = (cfg.num_layers, cfg.num_slots, cfg.num_heads, cfg.head_dim)
    dt = cfg.resolved_dtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def slot_index(block_tables: torch.Tensor, positions: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """Flat pool slot of logical ``positions`` — (B,) or (B, S) — under
    ``block_tables`` (B, max_blocks): ``table[pos // bs] * bs + pos % bs``."""
    blk = positions // block_size
    off = positions % block_size
    squeeze = blk.ndim == block_tables.ndim - 1
    if squeeze:
        blk = blk[..., None]
    phys = torch.gather(block_tables, -1, blk)
    if squeeze:
        phys = phys[..., 0]
    return phys * block_size + off


def write_tokens(cache, kvs, slots) -> None:
    """Scatter one new token per sequence into the pool, in place.
    kvs: ``(k_new, v_new)`` each (L, B, 1, H, D); slots: (B,)."""
    k_new, v_new = kvs
    slots = slots.long()
    cache["k"].index_copy_(1, slots, k_new[:, :, 0].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v_new[:, :, 0].to(cache["v"].dtype))


def write_prefill(cache, kvs, slots) -> None:
    """Scatter a whole prompt's K/V into the pool, in place.
    kvs: ``(k_new, v_new)`` each (L, B, S, H, D); slots: (B, S) with
    padded positions pointed at the garbage block by the caller."""
    k_new, v_new = kvs
    L = k_new.shape[0]
    flat = slots.reshape(-1).long()
    cache["k"].index_copy_(1, flat, k_new.reshape(L, -1, *k_new.shape[3:])
                           .to(cache["k"].dtype))
    cache["v"].index_copy_(1, flat, v_new.reshape(L, -1, *v_new.shape[3:])
                           .to(cache["v"].dtype))


def gather_context(cache, block_tables: torch.Tensor, block_size: int):
    """Each sequence's logical context: ``(k_ctx, v_ctx)`` of shape
    (L, B, max_blocks * block_size, H, D); gathered position j IS
    logical token j because tables are ordered."""
    b, mb = block_tables.shape
    slots = (block_tables[:, :, None] * block_size
             + torch.arange(block_size, device=block_tables.device)
             [None, None, :]).reshape(b, mb * block_size)
    return cache["k"][:, slots], cache["v"][:, slots]


def context_bias(lengths: torch.Tensor, max_context: int) -> torch.Tensor:
    """(B,) valid-token counts -> (B, T) additive bias: 0 for logical
    slots < length, NEG_INF beyond."""
    t = torch.arange(max_context, device=lengths.device)[None, :]
    return torch.where(t < lengths[:, None], 0.0, NEG_INF).float()


class BlockAllocator:
    """Free list over physical blocks 1..num_blocks-1 (0 is the garbage
    sink and never handed out).  LIFO reuse keeps recently touched blocks
    hot; a set mirrors the list for O(1) double-free checks.  Every live
    block holds one reference (nothing shares blocks without the prefix
    cache, which brings the refcount increments back)."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        self.reset()

    def reset(self):
        """Return every block to the free list."""
        self._free: List[int] = list(range(self.cfg.num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop n blocks; :class:`MemoryError` when the pool
        is exhausted (the scheduler checks :meth:`can_alloc` first)."""
        if n <= 0:
            return []
        if n > len(self._free):
            raise MemoryError(
                f"KV cache pool exhausted: requested {n} blocks, "
                f"{len(self._free)} free (pool={self.cfg.num_blocks - 1})")
        out = self._free[-n:][::-1]
        del self._free[len(self._free) - n:]
        for blk in out:
            self._free_set.discard(blk)
            self._refs[blk] = 1
        return out

    def refs(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    def free(self, blocks: List[int]):
        """Return blocks to the free list.  All blocks validate before
        any state changes."""
        for blk in blocks:
            if not 1 <= blk < self.cfg.num_blocks:
                raise ValueError(f"freeing invalid block id {blk}")
            if blk in self._free_set:
                raise ValueError(f"double free of block {blk}")
            if blk not in self._refs:
                raise ValueError(f"freeing unallocated block {blk}")
        for blk in blocks:
            del self._refs[blk]
            self._free.append(blk)
            self._free_set.add(blk)

    @staticmethod
    def blocks_for(num_tokens: int, block_size: int) -> int:
        return -(-max(num_tokens, 1) // block_size)
