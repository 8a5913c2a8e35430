"""Block-level prefix cache: RadixAttention's sharing, hash-chained.

Twin of ``apex_tpu/serving/prefix_cache.py`` with its offload tier
(without the cross-replica ``export_nodes``/``seed_nodes``).
Shared-prefix traffic (system prompts, few-shot templates, multi-turn
chat) would re-prefill the same tokens for every request; a
block-granular KV pool already holds them, so the cache is only an
index from token content to physical blocks:

- the unit of sharing is one FULL block (``block_size`` tokens);
- block i's key is ``(parent physical block, its block_size tokens)``:
  chaining on the parent's id makes the key cover the whole prefix (a
  flat-dict encoding of the radix tree);
- :meth:`match` walks a new request's context down the chain and
  returns the longest cached run of full blocks, one ref taken a block;
- a registered block whose refcount drops to zero is NOT freed: the
  allocator's ``release_hook`` parks it in an LRU of evictable holds,
  so a finished request's prefix serves matches until the pool needs
  the room;
- :meth:`evict` reclaims LRU holds, cascading over registered
  descendants (their keys would dangle once the parent id is reused).

The cache is host bookkeeping over block ids; its only device work is
the offload tier's, through the cache-home engine's closures.  The int8
pool needs nothing more: its scale sidecar is indexed by the same slots,
so a block id names its scales too, ``kv_cache.copy_blocks`` copies every
leaf on copy-on-write, and an exported block carries its scales.

**The offload tier** (:mod:`serving.offload`, attached by the server
with ``enable_kv_offload``): every registered block also gets a chain
CONTENT hash (:func:`_chunk_hash`, the reference's bit for bit), which
keys the host/disk store.  An evicted hold **demotes** — its bytes are
exported into the store instead of dying, all of one eviction pass's
victims in one batched export — and an admission's walk, where the
device tier stops, **promotes**: it continues by content hash through
the store and imports the run it finds into fresh blocks in one batched
import.  Every failure (a miss, a torn payload, no room, a card OOM, a
transport failure) falls back to cold prefill.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from apex_tpu_torch.serving.kv_cache import BlockAllocator
from apex_tpu_torch.serving.offload import (
    merge_payloads,
    split_payload,
    verify_payload,
)
from apex_tpu_torch.serving.oom import OOM_ERRORS
from apex_tpu_torch.serving.transport.base import TransportError
from apex_tpu_torch.utils.meters import CounterMeter

# chain parent of a sequence's first block: the garbage block's id,
# which is never allocated and so never collides
ROOT = 0

# chain hash of ROOT, the seed of every sequence's content-hash chain:
# block i's hash covers its whole prefix by induction, as the (parent
# id, chunk) key covers it by id chaining
_ROOT_HASH = b"\x00" * 16


def _chunk_hash(parent_hash: bytes, chunk) -> bytes:
    """Content hash of a chain node, ``blake2b(parent_hash || chunk
    tokens)``: a function of token CONTENT, not of block ids, so it stays
    valid across block-id reuse and process restarts and keys the offload
    store's tiers."""
    h = hashlib.blake2b(parent_hash, digest_size=16)
    for t in chunk:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


class PrefixCache:
    """Content -> physical-block index over a :class:`BlockAllocator`.

    Wires itself into the allocator: ``release_hook`` parks registered
    ref-0 blocks in the evictable LRU, and a reset hook drops the index
    when the allocator resets.  ``counters`` (a :class:`CounterMeter`)
    accumulates ``prefix_hit_tokens``, ``prefix_miss_tokens``,
    ``prefix_hit_requests``, ``prefix_miss_requests``,
    ``prefix_evicted_blocks`` and ``prefix_cow_blocks``; the offload
    tier's counters go to the meter :meth:`attach_offload` gives.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 counters: Optional[CounterMeter] = None):
        self.allocator = allocator
        self.block_size = block_size
        self.counters = counters if counters is not None else CounterMeter()
        self._map: Dict[Tuple[int, tuple], int] = {}   # key -> block
        self._key_of: Dict[int, Tuple[int, tuple]] = {}
        self._children: Dict[int, Set[int]] = {}       # block -> blocks
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # evictable
        self.evictable_peak = 0     # high-watermark of LRU holds
        # the offload tier (attach_offload): chain content hashes of the
        # registered blocks, the victims one eviction pass demotes, the
        # store and the cache-home engine's export/import closures; the
        # store is None while offload is off, and every offload branch
        # below guards on it
        self._hash_of: Dict[int, bytes] = {}
        self._demote_pending: List[Tuple[int, bytes]] = []
        self._offload = None
        self._exporter = None
        self._importer = None
        self.offload_counters: Optional[CounterMeter] = None
        self.promote_samples: Optional[List[float]] = None
        self._clock = time.monotonic
        allocator.release_hook = self._on_release
        allocator.reset_hooks.append(self.clear)

    def attach_offload(self, store, exporter, importer, *,
                       counters: Optional[CounterMeter] = None,
                       promote_samples: Optional[List[float]] = None,
                       clock=None) -> None:
        """Wire the host/disk offload tiers in.  ``exporter(ids)`` /
        ``importer(ids, payload)`` are the cache-home engine's
        ``export_blocks`` (with ``per_block_crc``) and ``import_blocks``,
        as closures, so wrappers installed later still intercept;
        ``counters`` gets the demote, promote and skip counts and
        ``promote_samples`` (a list) each promote's seconds on
        ``clock``; both stay public attributes (``offload_counters``,
        ``promote_samples``), which a meter reset replaces.  Must be
        attached before any block registers: chain hashes are computed
        at registration."""
        if self._key_of:
            raise RuntimeError(
                "attach_offload must run before any block registers "
                "(chain hashes are computed at registration)")
        self._offload = store
        self._exporter = exporter
        self._importer = importer
        self.offload_counters = (counters if counters is not None
                              else CounterMeter())
        self.promote_samples = promote_samples
        if clock is not None:
            self._clock = clock

    # -- allocator hooks --------------------------------------------------

    def _on_release(self, blk: int) -> bool:
        """Refcount hit zero: a registered block becomes an evictable
        hold (newest at the back); an unregistered one goes free."""
        if blk in self._key_of:
            self._lru[blk] = None
            self.evictable_peak = max(self.evictable_peak, len(self._lru))
            return True
        return False

    def clear(self):
        """Drop the whole index (allocator reset: every id dangles)."""
        self._map.clear()
        self._key_of.clear()
        self._children.clear()
        self._lru.clear()
        self._hash_of.clear()
        # dropped, not demoted: after a reset every stored id dangles,
        # so nothing coherent is left to export
        self._demote_pending.clear()
        self.evictable_peak = 0

    # -- introspection ----------------------------------------------------

    @property
    def num_cached_blocks(self) -> int:
        """Registered blocks, shared or evictable."""
        return len(self._key_of)

    @property
    def num_evictable(self) -> int:
        """Ref-0 holds that :meth:`evict` can reclaim."""
        return len(self._lru)

    def held_blocks(self) -> Set[int]:
        return set(self._lru)

    def is_registered(self, blk: int) -> bool:
        return blk in self._key_of

    # -- the index --------------------------------------------------------

    def match(self, tokens: List[int]) -> List[int]:
        """The longest cached run of ``tokens``' full-block chunks, as
        block ids with one ref taken a block (LRU holds are adopted back
        out of the evictable set).  The caller commits them into a table
        or returns them through :meth:`cancel`."""
        bs = self.block_size
        out: List[int] = []
        parent = ROOT
        for i in range(len(tokens) // bs):
            blk = self._map.get((parent, tuple(tokens[i * bs:(i + 1) * bs])))
            if blk is None:
                break
            if blk in self._lru:
                del self._lru[blk]
                self.allocator.adopt(blk)
            else:
                self.allocator.incref([blk])
            out.append(blk)
            parent = blk
        return out

    def cancel(self, blocks: List[int]):
        """Undo :meth:`match`'s refs for an admission that did not go
        through (registered blocks drop back into the LRU)."""
        self.allocator.free(blocks)

    def register(self, parent: int, chunk: Tuple[int, ...],
                 blk: int) -> bool:
        """Index the full block ``blk`` holding ``chunk`` under its chain
        ``parent``.  The first registration wins: a key that already
        maps to ANOTHER block leaves ``blk`` private, and the caller must
        stop registering its descendants.  Returns whether ``blk`` is
        the indexed block for this key."""
        if len(chunk) != self.block_size:
            raise ValueError(
                f"register needs a full block of {self.block_size} "
                f"tokens; got {len(chunk)}")
        key = (parent, tuple(chunk))
        cur = self._map.get(key)
        if cur is not None:
            return cur == blk
        if blk in self._key_of:
            return False        # one block under two keys: keep the first
        self._map[key] = blk
        self._key_of[blk] = key
        self._children.setdefault(parent, set()).add(blk)
        if self._offload is not None:
            ph = (_ROOT_HASH if parent == ROOT
                  else self._hash_of.get(parent))
            if ph is not None:
                self._hash_of[blk] = _chunk_hash(ph, key[1])
        return True

    # -- promotion (serving/offload) -----------------------------------------

    def promote(self, tokens: List[int], matched: List[int],
                alloc_fn) -> int:
        """Extend a :meth:`match` run with blocks brought back from the
        offload store: the host/disk -> device crossing, called at
        admission right after the device-tier walk stops.  The walk goes
        on by CONTENT hash: each missing chunk's chain hash is probed in
        the store; the run found is imported through the checksummed
        ``import_blocks`` path into fresh blocks (``alloc_fn``, the
        scheduler's evicting allocator: colder holds may demote to make
        room), registered, and appended to ``matched`` with
        :meth:`match`'s one ref a block.

        Every failure degrades to cold prefill: a store miss or a dry
        pool stops the walk; a checksum reject discards the torn payload
        whole (``crc_rejects``); an import OOM (:data:`OOM_ERRORS`) puts
        every payload back (``capacity_skips``), as does a transport
        failure (``transport_skips``).  Returns the blocks promoted.

        Two stages: stage 1 probes and verifies each chunk on the host
        (a torn spill is rejected HERE, before any device or index state
        moves); stage 2 allocates the run at once and imports it in ONE
        batched ``import_blocks``."""
        if self._offload is None:
            return 0
        bs = self.block_size
        total = len(tokens) // bs
        if len(matched) >= total:
            return 0
        parent = matched[-1] if matched else ROOT
        ph = (_ROOT_HASH if parent == ROOT
              else self._hash_of.get(parent))
        if ph is None:
            return 0
        t0 = self._clock()
        # -- stage 1: walk the chain, collect verified payloads ------------
        pending = []            # (hash, chunk, payload, tier)
        for i in range(len(matched), total):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            h = _chunk_hash(ph, chunk)
            hit = self._offload.take(h)
            if hit is None:
                break
            payload, tier = hit
            try:
                verify_payload(payload)
            except ValueError:
                # corrupt: discard it WHOLE (stored again it would fail
                # again forever) and cold-prefill from here
                self.offload_counters.incr("crc_rejects")
                break
            pending.append((h, chunk, payload, tier))
            ph = h
        if not pending:
            return 0
        # -- stage 2: one allocation (one batched demote on the way when
        # the pool is tight), one batched import ----------------------------
        fresh = alloc_fn(len(pending))
        if fresh is None:
            # the pool is dry even after eviction: keep the payloads warm
            # for a later admission, cold-prefill this one
            self._put_back(pending, "capacity_skips")
            return 0
        try:
            self._importer(fresh, merge_payloads([p[2] for p in pending]))
        except OOM_ERRORS:
            # a transient OOM mid-import: the payloads are still good
            self.allocator.free(fresh)
            self._put_back(pending, "capacity_skips")
            return 0
        except ValueError:
            # stage 1 verified the stored checksums, so a reject here
            # means the bytes rotted in flight: discard, cold-prefill
            self.allocator.free(fresh)
            self.offload_counters.incr("crc_rejects")
            return 0
        except TransportError:
            # the transport spent its envelope (retries, deadline, an
            # open breaker): the payloads are still good
            self.allocator.free(fresh)
            self._put_back(pending, "transport_skips")
            return 0
        promoted = 0
        parent = matched[-1] if matched else ROOT
        for j, (_, chunk, _, tier) in enumerate(pending):
            blk = fresh[j]
            if not self.register(parent, chunk, blk):
                # cannot happen on one thread (the chain was missing a
                # moment ago), but never leak: free this block and every
                # unregistered one behind it
                self.allocator.free(fresh[j:])
                break
            matched.append(blk)
            self.offload_counters.incr(
                "promotes_host" if tier == "host" else "promotes_disk")
            promoted += 1
            parent = blk
        if promoted and self.promote_samples is not None:
            self.promote_samples.append(self._clock() - t0)
        return promoted

    def _put_back(self, pending, reason: str) -> None:
        """Return a promote walk's payloads to the store and count why
        the promote was skipped."""
        for h, _, payload, _ in pending:
            self._offload.put(h, payload)
        self.offload_counters.incr(reason)

    # -- eviction ---------------------------------------------------------

    def evict(self, n: int = 1) -> int:
        """Reclaim at least ``n`` blocks from the LRU (oldest first) to
        the free list, each victim's registered subtree with it.
        Returns the blocks freed (0 = nothing evictable)."""
        freed = 0
        while freed < n and self._lru:
            freed += self._evict_subtree(next(iter(self._lru)))
        self._flush_demotes()
        if freed:
            self.counters.incr("prefix_evicted_blocks", freed)
        return freed

    def _evict_subtree(self, blk: int) -> int:
        """Unregister ``blk`` and every registered descendant, freeing
        those in the LRU (a descendant a live table still references
        only loses shareability)."""
        freed = 0
        for child in list(self._children.get(blk, ())):
            freed += self._evict_subtree(child)
        h = self._hash_of.get(blk)    # before _unregister drops it
        self._unregister(blk)
        if blk in self._lru:
            del self._lru[blk]
            if self._offload is not None and h is not None:
                self._demote_pending.append((blk, h))
            self.allocator.release_to_free(blk)
            freed += 1
        return freed

    def _flush_demotes(self) -> None:
        """Export every block this eviction pass victimized into the
        offload store in ONE batched gather: the device -> host crossing.
        Safe after ``release_to_free``: a freed block's bytes stay until
        an engine call rewrites them, and the flush runs before
        :meth:`evict` returns the ids to its caller.  Each block is
        stored under its own content hash with the crc the engine
        recorded for it (``offload.split_payload``).  An export OOM
        drops the whole batch (the blocks die as they did before offload
        existed)."""
        pending, self._demote_pending = self._demote_pending, []
        if not pending:
            return
        try:
            payload = self._exporter([blk for blk, _ in pending])
        except OOM_ERRORS:
            self.offload_counters.incr("demote_failed", len(pending))
            return
        for (_, h), sub in zip(pending, split_payload(payload)):
            self._offload.put(h, sub)
        self.offload_counters.incr("demotes", len(pending))

    def _unregister(self, blk: int):
        self._hash_of.pop(blk, None)
        key = self._key_of.pop(blk, None)
        if key is None:
            return
        del self._map[key]
        kids = self._children.get(key[0])
        if kids is not None:
            kids.discard(blk)
            if not kids:
                del self._children[key[0]]
        self._children.pop(blk, None)

    # -- invariants (tests + chip smoke) -------------------------------------

    def audit(self):
        """Index consistency: the map and its inverse agree, chain
        parents are indexed (or ROOT), LRU holds are registered at ref 0,
        no registered block is free, every chain hash belongs to a
        registered block and no demote batch is left unflushed.  Raises
        :class:`AssertionError`."""
        if len(self._map) != len(self._key_of):
            raise AssertionError("prefix map / inverse sizes differ")
        for key, blk in self._map.items():
            if self._key_of.get(blk) != key:
                raise AssertionError(f"block {blk}: inverse key differs")
            parent = key[0]
            if parent != ROOT and parent not in self._key_of:
                raise AssertionError(
                    f"block {blk} chained to unindexed parent {parent}")
            if blk not in self._children.get(parent, ()):
                raise AssertionError(
                    f"block {blk} missing from parent {parent}'s children")
        for blk in self._lru:
            if blk not in self._key_of:
                raise AssertionError(f"unregistered LRU hold {blk}")
            if self.allocator.refs(blk):
                raise AssertionError(
                    f"LRU hold {blk} has refs {self.allocator.refs(blk)}")
        for blk in self._key_of:
            if blk in self.allocator._free_set:
                raise AssertionError(
                    f"registered block {blk} is on the free list")
        for blk in self._hash_of:
            if blk not in self._key_of:
                raise AssertionError(
                    f"chain hash held for unregistered block {blk}")
        if self._demote_pending:
            raise AssertionError(
                "demote batch not flushed by the evict pass")
