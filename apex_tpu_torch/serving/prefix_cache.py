"""Block-level prefix cache: RadixAttention's sharing, hash-chained.

Twin of the device tier of ``apex_tpu/serving/prefix_cache.py``.
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

The cache is host bookkeeping over block ids and never touches device
memory.  The int8 pool needs nothing more: its scale sidecar is indexed
by the same slots, so a block id names its scales too, and
``kv_cache.copy_blocks`` copies every leaf on copy-on-write.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from apex_tpu_torch.serving.kv_cache import BlockAllocator
from apex_tpu_torch.utils.meters import CounterMeter

# chain parent of a sequence's first block: the garbage block's id,
# which is never allocated and so never collides
ROOT = 0


class PrefixCache:
    """Content -> physical-block index over a :class:`BlockAllocator`.

    Wires itself into the allocator: ``release_hook`` parks registered
    ref-0 blocks in the evictable LRU, and a reset hook drops the index
    when the allocator resets.  ``counters`` (a :class:`CounterMeter`)
    accumulates ``prefix_hit_tokens``, ``prefix_miss_tokens``,
    ``prefix_hit_requests``, ``prefix_miss_requests``,
    ``prefix_evicted_blocks`` and ``prefix_cow_blocks``.
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
        allocator.release_hook = self._on_release
        allocator.reset_hooks.append(self.clear)

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
        return True

    # -- eviction ---------------------------------------------------------

    def evict(self, n: int = 1) -> int:
        """Reclaim at least ``n`` blocks from the LRU (oldest first) to
        the free list, each victim's registered subtree with it.
        Returns the blocks freed (0 = nothing evictable)."""
        freed = 0
        while freed < n and self._lru:
            freed += self._evict_subtree(next(iter(self._lru)))
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
        self._unregister(blk)
        if blk in self._lru:
            del self._lru[blk]
            self.allocator.release_to_free(blk)
            freed += 1
        return freed

    def _unregister(self, blk: int):
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
        and no registered block is free.  Raises
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
