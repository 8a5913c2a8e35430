"""Prefill, chunk, decode and verify steps over the KV cache, block
copies and the checksummed block hand-off.

Twin of ``apex_tpu/serving/engine.py`` on one device:

- **prefill** (one request, prompt zero-padded to a length *bucket*):
  the causal GPT forward through the flash kernel
  (``make_flash_attention(causal=True)``, the reference's
  ``serve_gpt.py --flash``) with ``return_kv=True``; the per-layer K/V
  scatter into the request's blocks, padded positions into the garbage
  block.  Padding to the same bucket ladder as the JAX engine keeps the
  shapes, and the numbers, the same.
- **chunk prefill** (one request, one chunk at a carried KV position):
  the chunk attends the request's cached context through its block
  table (gather + ``ops.chunk_cached_attention``) plus itself causally,
  and its K/V scatter at block-offset slots.  A padded tail that runs
  past the table or the embedding table is clamped and sunk into the
  garbage block.
- **decode** (the whole running batch, always ``max_batch_size`` wide):
  gather every slot's context through its block table, run one token per
  slot at its own position (``ops.cached_attention`` inside), scatter
  the new K/V, return next-token logits.
- **verify** (the whole batch, ``max_batch_size`` x K fed tokens): every
  slot's pending token and drafts at carried positions, the chunk
  program batched, returning EVERY row's logits (B, K, V).
- **block copies**: :meth:`DecodeEngine.copy_blocks` inside the pool
  (copy-on-write), :meth:`~DecodeEngine.copy_blocks_from` from another
  engine's pool, each one launch over all its pairs;
  :meth:`~DecodeEngine.export_blocks` / :meth:`~DecodeEngine.import_blocks`
  ship blocks as host bytes with a crc32 a leaf (a bf16 leaf as its
  uint16 bits, the dtype named in the payload), so the crc equals the
  JAX engine's for the same pool contents.
- **sampled variants** (``prefill_sampled`` / ``chunk_prefill_sampled``
  / ``decode_sampled`` / ``verify_sampled``): the same steps with the
  sampler on the device, returning token ids and finite flags.
  ``sampling=None`` is the greedy argmax; a ``(temperature, top_k,
  top_p, seed)`` tuple of per-row arrays runs ``ops.sample_tokens`` with
  the counter of the token being drawn (prompt length for a prefill
  token, ``position + 1`` for a decode step, ``start + 1 + column`` for
  a verify row).  Greedy rows inside such a launch stay argmax.

With ``kv_quant="int8"`` the pool stores int8 K/V and their fp32
scales: the model quantizes fresh K/V at the projection, prefill
attends the dequantized values through the flash kernel, chunks and
verify through ``chunk_cached_attention`` over the dequantized
context, and decode hands the int8 context and its scales to
``ops.cached_attention`` (kernel B8), which widens them at read.

Empty decode slots ride along as no-ops: position 0 masks their whole
context, and their zeroed block table sends the K/V write to the
garbage block.  The pool is updated in place.

No twin here of the reference's trace counts (``compile_counts``,
``verify_compiles``, ``collective_programs``: eager PyTorch traces
nothing) or of its per-program accounting (``_qkey``; it comes with
``observability``).  Tensor parallelism is not here yet.
"""

from __future__ import annotations

import zlib
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from apex_tpu_torch.ops.flash_attention import make_flash_attention
from apex_tpu_torch.ops.sampling import (
    finite_rows,
    greedy_argmax,
    sample_tokens,
)
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    context_bias,
    copy_blocks,
    copy_blocks_across,
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


def _host_bytes(rows: torch.Tensor) -> np.ndarray:
    """Pool rows -> a contiguous host array of the same bytes; a bf16
    leaf, which numpy has no dtype for, as its uint16 bits."""
    rows = rows.contiguous().cpu()
    if rows.dtype == torch.bfloat16:
        return rows.view(torch.int16).numpy().view(np.uint16)
    return rows.numpy()


def _device_rows(name: str, arr, pool: torch.Tensor) -> torch.Tensor:
    """A payload leaf's host array -> the same bytes as ``pool``'s dtype
    on its device (a bf16 leaf may come as uint16 bits or as the JAX
    engine's ml_dtypes bfloat16)."""
    a = np.ascontiguousarray(arr)
    if a.dtype.itemsize != pool.element_size():
        raise ValueError(
            f"hand-off payload leaf {name!r} holds {a.dtype} elements; "
            f"the pool's are {_dtype_name(pool.dtype)}")
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.uint8)).view(pool.dtype).to(
        pool.device)


# the reference's padded width of one block-copy launch, kept for parity
# of names; the port copies all pairs in one unpadded launch
_COPY_WIDTH = 8


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
      prefill_buckets: ascending prompt-length buckets; None =
        :func:`default_prefill_buckets` of ``max_context``.  The largest
        must reach ``max_context``.

    Prefill attends through ``ops.flash_attention`` (causal), chunks and
    verify through ``ops.chunk_cached_attention`` and decode through
    ``ops.cached_attention``.
    """

    def __init__(self, cfg: GPTConfig, params: Mapping[str, torch.Tensor], *,
                 device="cuda",
                 max_batch_size: int = 8,
                 max_context: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 block_size: int = 16,
                 cache_dtype: Optional[torch.dtype] = None,
                 kv_quant: Optional[str] = None,
                 prefill_buckets: Optional[Sequence[int]] = None):
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
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_context)
        self.prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
        if self.prefill_buckets[-1] < self.max_context:
            raise ValueError(
                f"largest prefill bucket {self.prefill_buckets[-1]} "
                f"< max_context {self.max_context}")

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
    def _chunk_impl(self, ids, start, length, table):
        """One prefill chunk at a carried KV position: ids (1, Cb)
        zero-padded chunk; start (1,) position of ``ids[0]`` (== tokens
        already materialized through ``table``); length (1,) valid
        tokens; table (1, blocks_per_seq).  Returns the last valid
        token's logits (1, V)."""
        return self._verify_impl(ids, start, length, table)[
            torch.arange(1, device=self.device), length - 1]

    @torch.no_grad()
    def _verify_impl(self, ids, start, length, tables):
        """The chunk and verify body: ids (B, K) each slot's fed tokens
        (a chunk, or the pending token and its drafts), zero-padded;
        start (B,) position of ``ids[:, 0]``; length (B,) valid tokens a
        slot (0 = idle); tables (B, blocks_per_seq).  The fed tokens
        attend the cached context (slots < start) and themselves
        causally; their K/V scatter at block-offset slots, invalid
        columns into the garbage block.  Padded columns can run past the
        embedding table and the block table: their positions clamp for
        the embedding (their logits are discarded) and their slots sink.
        Returns every row's logits (B, K, V)."""
        kw = ids.shape[1]
        off = torch.arange(kw, device=self.device)[None, :]
        pos = start[:, None] + off
        bias = context_bias(start, self.blocks_per_seq * self.block_size)
        logits, kvs = self.model(
            ids, positions=pos.clamp_max(self.cfg.max_position_embeddings
                                         - 1),
            cache_views=self._cache_views(tables, bias), return_kv=True,
            kv_quant=self.quantized)
        slots = torch.where(off < length[:, None],
                            slot_index(tables, pos, self.block_size), 0)
        write_prefill(self.cache, self._stack_kvs(kvs), slots)
        return logits

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

    @torch.no_grad()
    def _sample(self, logits, counters, sampling):
        """The on-device sampler: greedy argmax and the finite guard when
        ``sampling`` is None; else :func:`ops.sample_tokens` with the
        per-slot ``(temperature, top_k, top_p, seed)`` tensors broadcast
        over verify's columns and ``counters`` the sequence index of
        each token drawn."""
        if sampling is None:
            return greedy_argmax(logits), finite_rows(logits)
        rows = logits.shape[:-1]
        extra = logits.ndim - 1 - sampling[0].ndim     # 1 on verify's

        def bc(x):
            return x.reshape(x.shape + (1,) * extra).expand(rows)

        return sample_tokens(logits, *(bc(x) for x in sampling),
                             counters.expand(rows))

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

    def _sampling_args(self, sampling):
        """A ``(temperature, top_k, top_p, seed)`` tuple of per-row host
        arrays (``Scheduler.sampling_inputs``/``prefill_sampling``) on
        the device; None stays None (greedy)."""
        if sampling is None:
            return None
        temp, tk, tp, seed = sampling
        return self._to_device(np.asarray(temp, np.float32),
                               np.asarray(tk, np.int32),
                               np.asarray(tp, np.float32),
                               np.asarray(seed, np.int64))

    def _table(self, block_table):
        table = np.zeros((1, self.blocks_per_seq), np.int64)
        table[0, :len(block_table)] = block_table
        return table

    def _prefill_args(self, prompt, block_table):
        n = len(prompt)
        sb = self.bucket_for(n)
        ids = np.zeros((1, sb), np.int64)
        ids[0, :n] = prompt
        return self._to_device(ids, np.asarray([n], np.int64),
                               self._table(block_table))

    def _chunk_args(self, tokens, start, block_table, pad_to):
        n = len(tokens)
        cb = pad_to if pad_to is not None else self.bucket_for(n)
        if n > cb:
            raise ValueError(f"chunk of {n} tokens exceeds pad_to={cb}")
        ids = np.zeros((1, cb), np.int64)
        ids[0, :n] = tokens
        return self._to_device(ids, np.asarray([start], np.int64),
                               np.asarray([n], np.int64),
                               self._table(block_table))

    def _decode_args(self, tokens, positions, tables):
        return self._to_device(np.asarray(tokens, np.int64),
                               np.asarray(positions, np.int64),
                               np.asarray(tables, np.int64))

    def _verify_args(self, tokens, lengths, positions, tables):
        return self._to_device(np.asarray(tokens, np.int64),
                               np.asarray(positions, np.int64),
                               np.asarray(lengths, np.int64),
                               np.asarray(tables, np.int64))

    def prefill(self, prompt, block_table) -> torch.Tensor:
        """Run one prompt through the bucketed prefill, writing its K/V
        into ``block_table``'s blocks.  Returns the last-token logits
        (V,)."""
        return self._prefill_impl(*self._prefill_args(prompt,
                                                      block_table))[0]

    def prefill_sampled(self, prompt, block_table, sampling=None):
        """:meth:`prefill` with the sampler on the device: returns
        ``(token_ids (1,) int32, finite (1,) bool)``.  ``sampling``: None
        (greedy) or ``(temperature, top_k, top_p, seed)`` (1,) arrays;
        the token's counter is the prompt length."""
        args = self._prefill_args(prompt, block_table)
        last = self._prefill_impl(*args)
        return self._sample(last, args[1], self._sampling_args(sampling))

    def chunk_prefill(self, tokens, start: int, block_table,
                      pad_to: Optional[int] = None) -> torch.Tensor:
        """Run one prefill chunk, ``tokens`` at positions ``start ..
        start + len - 1``, writing its K/V through ``block_table``
        (positions < start must be materialized already).  Returns the
        chunk's last-token logits (V,).  ``pad_to``: the chunk width
        (default: the prompt bucket of ``len(tokens)``)."""
        return self._chunk_impl(*self._chunk_args(tokens, start,
                                                  block_table, pad_to))[0]

    def chunk_prefill_sampled(self, tokens, start: int, block_table,
                              pad_to: Optional[int] = None,
                              sampling=None):
        """:meth:`chunk_prefill` with the sampler on the device: returns
        ``(token_ids (1,) int32, finite (1,) bool)`` for the chunk's last
        valid token (meaningful on the final chunk); the counter is
        ``start + len(tokens)``.  ``sampling`` as in
        :meth:`prefill_sampled`."""
        ids, start_t, length, table = self._chunk_args(tokens, start,
                                                       block_table, pad_to)
        last = self._chunk_impl(ids, start_t, length, table)
        return self._sample(last, start_t + length,
                            self._sampling_args(sampling))

    def decode(self, tokens, positions, tables) -> torch.Tensor:
        """One decode step over all slots: (B,), (B,), (B, blocks_per_seq)
        with inactive slots zeroed.  Returns next-token logits (B, V)."""
        return self._decode_impl(*self._decode_args(tokens, positions,
                                                    tables))

    def decode_sampled(self, tokens, positions, tables, sampling=None):
        """:meth:`decode` with the sampler on the device: returns
        ``(token_ids (B,) int32, finite (B,) bool)``.  ``sampling``: None
        (greedy) or per-slot (B,) arrays; a slot's counter is its
        position + 1."""
        args = self._decode_args(tokens, positions, tables)
        logits = self._decode_impl(*args)
        return self._sample(logits, args[1] + 1,
                            self._sampling_args(sampling))

    def verify(self, tokens, lengths, positions, tables) -> torch.Tensor:
        """One speculative verify step over all slots: tokens (B, K)
        (pending token + drafts a slot, zero-padded), lengths (B,) valid
        tokens a slot (0 = idle), positions (B,) each slot's cached
        context length, tables (B, blocks_per_seq).  Writes every valid
        token's K/V and returns every row's logits (B, K, V)."""
        return self._verify_impl(*self._verify_args(tokens, lengths,
                                                    positions, tables))

    def verify_sampled(self, tokens, lengths, positions, tables,
                       sampling=None):
        """:meth:`verify` with the sampler on the device: returns
        ``(token_ids (B, K) int32, finite (B, K) bool)``.  Column j of a
        slot draws with the counter ``position + 1 + j``."""
        ids, start, length, tabs = self._verify_args(tokens, lengths,
                                                     positions, tables)
        logits = self._verify_impl(ids, start, length, tabs)
        counters = start[:, None] + 1 + torch.arange(
            ids.shape[1], device=self.device)[None, :]
        return self._sample(logits, counters, self._sampling_args(sampling))

    def swap_params(self, params) -> None:
        """Load a new ``state_dict`` of the same structure into the
        model's tensors, in place (``load_state_dict``): the steps run on
        with the new weights."""
        self.model.load_state_dict(params)

    # -- block copies and the hand-off ---------------------------------------

    def _copy_ids(self, pairs):
        """``[(src, dst), ...]`` -> (src, dst) device id tensors, one
        launch for every pair: eager torch compiles nothing, so the
        reference's fixed ``_COPY_WIDTH`` padding buys nothing here."""
        ids = np.asarray(pairs, np.int64).reshape(-1, 2)
        return self._to_device(ids[:, 0], ids[:, 1])

    @torch.no_grad()
    def copy_blocks(self, pairs) -> None:
        """Duplicate physical blocks ``[(src, dst), ...]`` inside the pool
        (copy-on-write), every leaf."""
        if len(pairs):
            copy_blocks(self.cache, *self._copy_ids(pairs), self.block_size)

    @torch.no_grad()
    def copy_blocks_from(self, src_engine: "DecodeEngine", pairs) -> None:
        """Copy physical blocks ``[(src, dst), ...]`` from another
        engine's pool of the same geometry into this one (a finished
        prefill's hand-off), every leaf."""
        if len(pairs):
            copy_blocks_across(self.cache, src_engine.cache,
                               *self._copy_ids(pairs), self.block_size)

    def _block_slots(self, block_ids, pad_to: int) -> np.ndarray:
        """Flat pool slots of ``block_ids``' token rows, padded with the
        garbage block's slots to ``pad_to`` blocks."""
        bs = self.block_size
        ids = np.zeros((pad_to,), np.int64)
        ids[:len(block_ids)] = block_ids
        return (ids[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)

    @torch.no_grad()
    def export_blocks(self, block_ids, *,
                      per_block_crc: bool = False) -> dict:
        """``block_ids``' contents as a host payload: every leaf's rows
        (the scale sidecar under quantization) as numpy arrays, each
        leaf's dtype (``"dtypes"``; a bf16 leaf ships as its uint16
        bits) and a crc32 of each leaf's bytes, equal to the JAX
        engine's for the same pool contents.  ``per_block_crc=True``
        adds a crc32 a block a leaf (``"block_crc"``)."""
        slots = torch.from_numpy(
            self._block_slots(block_ids, len(block_ids))).to(self.device)
        leaves = {name: _host_bytes(arr[:, slots])
                  for name, arr in self.cache.items()}
        bs = self.block_size
        payload = {
            "num_blocks": len(block_ids),
            "block_size": bs,
            "leaves": leaves,
            "dtypes": {name: _dtype_name(arr.dtype)
                       for name, arr in self.cache.items()},
            "crc": {name: zlib.crc32(a.tobytes())
                    for name, a in leaves.items()},
        }
        if per_block_crc:
            payload["block_crc"] = {
                name: [zlib.crc32(np.ascontiguousarray(
                    a[:, i * bs:(i + 1) * bs]).tobytes())
                    for i in range(len(block_ids))]
                for name, a in leaves.items()}
        return payload

    @torch.no_grad()
    def import_blocks(self, block_ids, payload) -> None:
        """Scatter an :meth:`export_blocks` payload (this package's or
        the JAX engine's) into this pool's ``block_ids`` (same count,
        same geometry).  Every leaf's crc32 is checked first and a
        mismatch raises :class:`ValueError`: a torn payload is rejected
        whole, never half-imported.  An empty transfer touches
        nothing."""
        if payload.get("block_size") != self.block_size \
                or payload.get("num_blocks") != len(block_ids):
            raise ValueError(
                f"hand-off payload geometry mismatch: payload holds "
                f"{payload.get('num_blocks')} blocks of "
                f"{payload.get('block_size')} slots, importing "
                f"{len(block_ids)} blocks of {self.block_size}")
        leaves = payload["leaves"]
        if set(leaves) != set(self.cache):
            raise ValueError(
                f"hand-off payload leaves {sorted(leaves)} != pool "
                f"leaves {sorted(self.cache)} (quantization modes "
                f"must match across replicas)")
        for name, arr in leaves.items():
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            want = payload["crc"].get(name)
            if got != want:
                raise ValueError(
                    f"torn hand-off payload: leaf {name!r} for "
                    f"block(s) {list(map(int, block_ids))} has "
                    f"checksum {got} (actual) != {want} (expected); "
                    f"payload rejected whole")
        if not len(block_ids):
            return
        slots = torch.from_numpy(
            self._block_slots(block_ids, len(block_ids))).to(self.device)
        rows = {name: _device_rows(name, leaves[name], pool)
                for name, pool in self.cache.items()}
        for name, pool in self.cache.items():
            pool[:, slots] = rows[name]

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
