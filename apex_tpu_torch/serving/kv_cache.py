"""Block-table-indexed KV cache — the serving memory manager.

Twin of ``apex_tpu/serving/kv_cache.py`` without the prefix-cache
hooks.  The cache is one preallocated pool of ``num_blocks`` blocks of
``block_size`` token slots per layer,

    k, v: (num_layers, num_blocks * block_size, num_heads, head_dim)

held as a dict of tensors and updated IN PLACE (``index_copy_``) where
the JAX version rebuilds it functionally and donates it.  Every request
owns an ordered block table mapping its logical positions to physical
blocks.  Physical block 0 is the reserved garbage sink: unallocated
table entries and padded positions point at it, and the context bias
masks whatever sits there.

``KVCacheConfig(quantize="int8")`` stores K/V as int8 with a per-slot,
per-head fp32 scale sidecar ``k_scale``/``v_scale`` (L, num_slots, H);
the model quantizes at the projection (``ops.kv_quant``) and the
attention ops widen at read.  ``dtype`` is the compute dtype: an
explicit one wins, else the installed amp policy's
``cast_model_type``, else bfloat16 (:func:`resolve_cache_dtype`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from apex_tpu_torch.amp._amp_state import _amp_state

NEG_INF = -1e9

# env twin of the ``kv_quant=`` knob (InferenceServer reads it)
KV_QUANT_ENV = "APEX_TPU_KV_QUANT"

_QUANT_MODES = (None, "int8")


def resolve_kv_quant(value) -> Optional[str]:
    """Normalize a ``kv_quant`` knob or ``APEX_TPU_KV_QUANT`` value to
    None or ``"int8"``; anything else raises."""
    if value is None:
        return None
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("", "0", "none", "off"):
            return None
        if v in ("1", "int8"):
            return "int8"
    raise ValueError(
        f"unknown KV quantization mode {value!r} "
        f"(expected one of: None/'', 'int8')")


def resolve_cache_dtype(dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The compute dtype of the pool's values: an explicit dtype wins;
    else the installed amp policy's ``cast_model_type`` (O0 float32,
    O2/O3 bfloat16); else bfloat16.  Integer dtypes are refused: int8
    storage is a quantization mode, not a cache dtype."""
    if dtype is not None:
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise TypeError(
                f"cache dtype must be a floating-point compute dtype, "
                f"got {dtype}; for an int8-quantized KV pool pass "
                f"KVCacheConfig(quantize='int8') (per-block-scaled "
                f"storage), not dtype={dtype}")
        return dtype
    props = _amp_state.opt_properties
    cast = props.cast_model_type if props is not None else None
    return cast if cast is not None else torch.bfloat16


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Geometry of the block pool.  ``num_blocks`` INCLUDES the reserved
    garbage block 0, so the usable capacity is
    ``(num_blocks - 1) * block_size`` tokens.  ``dtype=None`` defers to
    :func:`resolve_cache_dtype`.  ``quantize="int8"`` stores int8 K/V
    plus the fp32 scale sidecar, and every byte count includes the
    sidecar."""

    num_layers: int
    num_heads: int
    head_dim: int
    num_blocks: int
    block_size: int = 16
    dtype: Optional[torch.dtype] = None
    quantize: Optional[str] = None

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(
                "num_blocks must be >= 2 (block 0 is the reserved "
                f"garbage sink); got {self.num_blocks}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1; got "
                             f"{self.block_size}")
        if self.quantize not in _QUANT_MODES:
            raise ValueError(
                f"quantize must be one of {_QUANT_MODES}; got "
                f"{self.quantize!r}")
        self.resolved_dtype()

    @property
    def num_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def usable_tokens(self) -> int:
        return (self.num_blocks - 1) * self.block_size

    @property
    def quantized(self) -> bool:
        return self.quantize is not None

    def resolved_dtype(self) -> torch.dtype:
        return resolve_cache_dtype(self.dtype)

    def storage_dtype(self) -> torch.dtype:
        """int8 under quantization, the compute dtype otherwise."""
        return torch.int8 if self.quantized else self.resolved_dtype()

    @property
    def scale_bytes_per_block(self) -> int:
        """One block's share of the scale sidecar, K and V; 0 when
        quantization is off."""
        if not self.quantized:
            return 0
        return 2 * self.num_layers * self.block_size * self.num_heads * 4

    @property
    def bytes_per_block(self) -> int:
        """Device bytes of one physical block: the K and V payload plus
        the scale sidecar under quantization."""
        payload = (2 * self.num_layers * self.block_size * self.num_heads
                   * self.head_dim * self.storage_dtype().itemsize)
        return payload + self.scale_bytes_per_block

    def bytes(self) -> int:
        """Device bytes of the whole pool, sidecar included."""
        return self.num_blocks * self.bytes_per_block


def init_kv_cache(cfg: KVCacheConfig, device) -> Dict[str, torch.Tensor]:
    """The zeroed pool ``{"k", "v"}``, each (L, num_slots, H, D) in the
    storage dtype, plus under quantization ``{"k_scale", "v_scale"}``,
    each (L, num_slots, H) fp32."""
    shape = (cfg.num_layers, cfg.num_slots, cfg.num_heads, cfg.head_dim)
    dt = cfg.storage_dtype()
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.quantized:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache


def slot_index(block_tables: torch.Tensor, positions: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """Flat pool slot of logical ``positions`` — (B,) or (B, S) — under
    ``block_tables`` (B, max_blocks): ``table[pos // bs] * bs + pos % bs``.
    A position past the table lands in the garbage block, as an
    unallocated entry does: ``torch.gather`` raises on an index that
    ``jnp.take_along_axis`` fills, so the block index is clamped for the
    gather and its result replaced by block 0 (a chunk's padded tail
    runs past the table when ``max_context`` is not a multiple of the
    chunk)."""
    blk = positions // block_size
    off = positions % block_size
    squeeze = blk.ndim == block_tables.ndim - 1
    if squeeze:
        blk = blk[..., None]
    last = block_tables.shape[-1] - 1
    phys = torch.gather(block_tables, -1, blk.clamp_max(last))
    phys = torch.where(blk <= last, phys, 0)
    if squeeze:
        phys = phys[..., 0]
    return phys * block_size + off


def write_tokens(cache, kvs, slots) -> None:
    """Scatter one new token per sequence into the pool, in place.
    kvs: ``(k_new, v_new)`` each (L, B, 1, H, D); under quantization
    ``((k_q, k_scale), (v_q, v_scale))`` with the payloads int8 and the
    scales (L, B, 1, H) fp32, already quantized by the model.  slots:
    (B,)."""
    write_prefill(cache, kvs, slots[:, None])


def write_prefill(cache, kvs, slots) -> None:
    """Scatter a whole prompt's K/V into the pool, in place.
    kvs: ``(k_new, v_new)`` each (L, B, S, H, D), or the quantized
    quadruple as in :func:`write_tokens` (scales (L, B, S, H)); slots:
    (B, S) with padded positions pointed at the garbage block by the
    caller."""
    flat = slots.reshape(-1).long()
    k_new, v_new = kvs
    legs = [("k", k_new), ("v", v_new)]
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = k_new, v_new
        legs = [("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)]
    for name, new in legs:
        pool = cache[name]
        pool.index_copy_(1, flat, new.reshape(pool.shape[0], -1,
                                              *new.shape[3:]).to(pool.dtype))


def _context_slots(block_tables: torch.Tensor, block_size: int):
    """(B, max_blocks) tables -> (B, max_blocks * block_size) pool slots
    in logical order."""
    b, mb = block_tables.shape
    return (block_tables[:, :, None] * block_size
            + torch.arange(block_size, device=block_tables.device)
            [None, None, :]).reshape(b, mb * block_size)


def gather_context(cache, block_tables: torch.Tensor, block_size: int):
    """Each sequence's logical context: ``(k_ctx, v_ctx)`` of shape
    (L, B, max_blocks * block_size, H, D); gathered position j IS
    logical token j because tables are ordered."""
    slots = _context_slots(block_tables, block_size)
    return cache["k"][:, slots], cache["v"][:, slots]


def gather_scales(cache, block_tables: torch.Tensor, block_size: int):
    """The scale sidecar's leg of :func:`gather_context`, by the same
    slot map: ``(k_scale, v_scale)`` each (L, B, max_blocks *
    block_size, H) fp32."""
    slots = _context_slots(block_tables, block_size)
    return cache["k_scale"][:, slots], cache["v_scale"][:, slots]


def context_bias(lengths: torch.Tensor, max_context: int) -> torch.Tensor:
    """(B,) valid-token counts -> (B, T) additive bias: 0 for logical
    slots < length, NEG_INF beyond."""
    t = torch.arange(max_context, device=lengths.device)[None, :]
    return torch.where(t < lengths[:, None], 0.0, NEG_INF).float()


def _block_rows(ids: torch.Tensor, block_size: int) -> torch.Tensor:
    """(M,) block ids -> (M * block_size,) their pool slots, in order."""
    off = torch.arange(block_size, device=ids.device)
    return (ids[:, None] * block_size + off[None, :]).reshape(-1)


def copy_blocks_across(dst_cache, src_cache, src, dst,
                       block_size: int) -> None:
    """Whole-block copy ``src[i]`` (in ``src_cache``) -> ``dst[i]`` (in
    ``dst_cache``) between two pools of one geometry, in place on
    ``dst_cache``: the hand-off of a finished prefill's blocks from one
    engine's pool into another's.  src, dst: (M,) block ids,
    (0, 0)-padded (the garbage block onto itself).  Every leaf moves,
    the int8 pool's scale sidecar with its payload."""
    s = _block_rows(src.long(), block_size)
    d = _block_rows(dst.long(), block_size)
    for name, arr in dst_cache.items():
        arr[:, d] = src_cache[name][:, s]


def copy_blocks(cache, src, dst, block_size: int) -> None:
    """Whole-block copy ``src[i] -> dst[i]`` inside the pool, in place:
    the device half of copy-on-write.  src, dst: (M,) block ids (a
    (0, 0) pair copies the garbage block onto itself).  Every leaf is
    copied, the scale sidecar included.  The source rows are gathered
    before any is written, as the reference's
    ``arr.at[:, d].set(arr[:, s])`` reads the old pool: a pair whose
    source is another pair's destination copies the old block."""
    copy_blocks_across(cache, cache, src, dst, block_size)


class BlockAllocator:
    """Refcounted free list over physical blocks 1..num_blocks-1 (0 is
    the garbage sink and never handed out).  LIFO reuse keeps recently
    touched blocks hot; a set mirrors the list for O(1) double-free
    checks.

    Refcounts are what let the prefix cache share blocks: a block in
    several requests' tables holds one ref per table (:meth:`incref`),
    and :meth:`free` drops one.  A block whose count reaches zero is
    first offered to ``release_hook`` (the prefix cache): True keeps it
    out of the free list, resident and evictable later through
    :meth:`release_to_free`.  Every block is in exactly one of three
    states: free, live (refcount >= 1) or cache-held (refcount 0,
    retained by the hook)."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        self.release_hook = None      # blk -> bool; True = hook keeps it
        self.reset_hooks: List = []   # called on reset() (cache clears)
        self.reset()

    def reset(self):
        """Return every block to the free list; the reset hooks fire so
        a prefix cache indexing the old blocks drops its entries."""
        self._free: List[int] = list(range(self.cfg.num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: Dict[int, int] = {}
        self.live_peak = 0          # high-watermark of live blocks
        for hook in self.reset_hooks:
            hook()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Blocks referenced by at least one table."""
        return len(self._refs)

    def _note_live(self) -> None:
        if len(self._refs) > self.live_peak:
            self.live_peak = len(self._refs)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Pop n blocks at refcount 1; :class:`MemoryError` when the pool
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
        self._note_live()
        return out

    def refs(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    def incref(self, blocks: List[int]):
        """Add one ref per block (a second table now references it)."""
        for blk in blocks:
            if blk not in self._refs:
                raise ValueError(f"incref of unallocated block {blk}")
            self._refs[blk] += 1

    def adopt(self, blk: int):
        """Re-own a cache-held block (refcount 0, hook-retained) at
        refcount 1: the prefix cache reactivating a matched block."""
        if blk in self._free_set or blk in self._refs:
            raise ValueError(
                f"adopt of block {blk} that is not cache-held "
                f"(free={blk in self._free_set}, "
                f"refs={self._refs.get(blk)})")
        self._refs[blk] = 1
        self._note_live()

    def free(self, blocks: List[int]):
        """Drop one ref per block; a block reaching zero returns to the
        free list unless ``release_hook`` claims it.  All blocks
        validate before any state changes."""
        for blk in blocks:
            if not 1 <= blk < self.cfg.num_blocks:
                raise ValueError(f"freeing invalid block id {blk}")
            if blk in self._free_set:
                raise ValueError(f"double free of block {blk}")
            if blk not in self._refs:
                raise ValueError(f"freeing unallocated block {blk}")
        for blk in blocks:
            if self._refs[blk] > 1:
                self._refs[blk] -= 1
                continue
            del self._refs[blk]
            if self.release_hook is not None and self.release_hook(blk):
                continue
            self._free.append(blk)
            self._free_set.add(blk)

    def release_to_free(self, blk: int):
        """Return a cache-held block (refcount 0) to the free list: the
        prefix cache's eviction path."""
        if blk in self._free_set or blk in self._refs:
            raise ValueError(
                f"release_to_free of block {blk} that is not cache-held")
        self._free.append(blk)
        self._free_set.add(blk)

    @staticmethod
    def blocks_for(num_tokens: int, block_size: int) -> int:
        return -(-max(num_tokens, 1) // block_size)
