"""Continuous-batching request scheduler (Orca-style iteration-level).

Twin of ``apex_tpu/serving/scheduler.py``, with the one-host half of
the disaggregated hand-off (:meth:`Scheduler.admit_handoff`,
:meth:`Scheduler.release_handoff`) and without the router's
``withdraw_waiting``.  Every iteration the scheduler admits waiting
requests into free batch slots while the block pool can hold their
prompts, grows each running request's block table just in time for its
next token — preempting the worst-priority, youngest request back to
the waiting queue when the pool runs dry — and retires finished
requests at once, so their slot and blocks serve the next iteration.

**Prefix caching** (:mod:`serving.prefix_cache`).  At admission the
context is matched against the block-level prefix index; matched full
blocks enter the table SHARED (one ref a table) and only the uncached
tail is prefilled; with the offload tier attached, the walk goes on
through the host/disk store (:meth:`PrefixCache.promote`).  Blocks
register into the index as they fill
(:meth:`Scheduler.register_progress`, from prefill chunks and from
decode or verify steps crossing a block boundary), and a finished
request's registered blocks stay as evictable holds, reclaimed (and,
with the offload tier, demoted) by :meth:`Scheduler._try_alloc` only
when the pool runs low.  When the
WHOLE context is cached, the last matched block is duplicated
copy-on-write: the request must recompute the last token's logits and
re-write its K/V, which may not touch a shared block; the server copies
``pending_cow`` and :meth:`Scheduler.cow_done` drops the extra ref.

**Chunked prefill** (Sarathi-style): :meth:`Scheduler.prefill_plan`
hands out the uncached tail ``chunk_size`` tokens at a time (the whole
tail at once when ``chunk_size`` is None), and
:meth:`Scheduler.chunk_done` carries the KV position.

**Speculative lookahead**: a request with drafts needs room for up to
K token writes this iteration; :meth:`Scheduler.lookahead_capacity`
grows the table opportunistically (evicting cache holds, never
preempting), and :meth:`Scheduler.rollback_lookahead` frees the blocks
that hold only rejected positions after each verify step.

**Overload control** (:mod:`serving.overload`): requests carry a
priority and a block-cost estimate; under pressure the scheduler sheds
the lowest-priority, newest waiting work (``finish_reason="shed"``),
queue-full arrivals displace lower-priority queued work, and the
preemption victim is chosen worst-priority first.

Preemption is recompute: the victim's blocks are freed, and on
re-admission its sequence so far re-prefills as a pseudo-prompt
(``prompt + generated[:-1]``) whose logits are discarded — the pending
last token re-enters the decode batch unchanged, so generation, greedy
or counter-keyed stochastic, is bit-stable across preemptions (and with
the prefix cache on, the victim's registered blocks usually come back
as a cache hit).

**The in-flight hold** (the pipelined serve loop): between a decode or
verify launch and its retire, :meth:`Scheduler.hold_inflight` pins the
launched requests — the pending device step still writes K/V through
their tables, so the preemption victim chooser skips them, and
:meth:`Scheduler.audit` checks that every held request is still running
with its blocks.

A request whose context can never fit the pool fails alone
(``finish_reason="capacity"``); a bounded waiting queue
(``max_waiting``) refuses arrivals with :class:`QueueFullError`.  The
scheduler is host-side bookkeeping and never touches device tensors.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.ops.sampling import SamplingParams
from apex_tpu_torch.serving import reasons
from apex_tpu_torch.serving.kv_cache import BlockAllocator
from apex_tpu_torch.serving.overload import OverloadPolicy
from apex_tpu_torch.serving.prefix_cache import ROOT, PrefixCache

_uid = itertools.count()

# registration-cursor sentinel: once a request's chain breaks (a COW
# duplicate or a key collision) none of its later blocks may register —
# their chain parent is unindexed
_REG_STOPPED = 1 << 60


class QueueFullError(RuntimeError):
    """The bounded waiting queue is at ``max_waiting``; the request was
    NOT enqueued."""


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""

    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))
    # per-request sampling knobs; the default instance is greedy argmax
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)

    # overload control: nice-style priority (0 = foreground) and the
    # completion-size estimate in KV blocks, stamped at submit
    priority: int = 0
    cost_blocks: int = 0

    # budgets (None = unbounded): scheduler iterations from submission,
    # or wall seconds on the server's clock; both expire to "timeout"
    deadline_iters: Optional[int] = None
    deadline_s: Optional[float] = None
    submit_iter: int = 0
    submitted_at: float = 0.0

    # timeline (server clock): admitted_at keeps its FIRST value across
    # preemptions; itl_gaps holds the gap before each token after the
    # first, stamped as tokens are applied
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    itl_gaps: List[float] = dataclasses.field(default_factory=list)
    last_token_at: Optional[float] = None

    # runtime state (owned by the scheduler)
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                  # decode batch slot; -1 = not running
    block_table: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0             # tokens with K/V materialized
    next_input: Optional[int] = None  # pending token for the next decode
    finished: bool = False
    finish_reason: Optional[str] = None
    preemptions: int = 0
    # lifetime drafted and accepted tokens (speculation)
    spec_drafted: int = 0
    spec_accepted: int = 0
    # the context being (chunk-)prefilled, and whether its final chunk's
    # logits sample a token (False after preemption: the pending token
    # continues instead); an admission-time COW copy (src, dst) the
    # server performs before the first chunk; the tokens the prefix
    # cache supplied; the registration cursor (full blocks
    # [0, _reg_blocks) are indexed)
    prefill_ctx: Optional[List[int]] = None
    prefill_sample: bool = True
    pending_cow: Optional[Tuple[int, int]] = None
    cached_prefix_tokens: int = 0
    _reg_blocks: int = 0

    @property
    def running(self) -> bool:
        return self.slot >= 0 and not self.finished

    @property
    def prefilling(self) -> bool:
        """Admitted with context K/V still to materialize: the decode
        batch skips it until its last chunk lands."""
        return self.prefill_ctx is not None

    def record_token(self, token: int) -> None:
        """Account one sampled token and evaluate termination."""
        self.generated.append(int(token))
        self.next_input = int(token)
        if self.eos_id is not None and int(token) == self.eos_id:
            self.finished = True
            self.finish_reason = reasons.EOS
        elif len(self.generated) >= self.max_new_tokens:
            self.finished = True
            self.finish_reason = reasons.LENGTH

    def timeline(self) -> dict:
        """The lifecycle timestamps (server clock seconds) and the waits
        derived from them."""
        out = {
            "uid": self.uid,
            "priority": self.priority,
            "submitted_at": self.submitted_at,
            "admitted_at": self.admitted_at,
            "first_token_at": self.first_token_at,
            "finished_at": self.finished_at,
            "finish_reason": self.finish_reason,
            "tokens": len(self.generated),
            "preemptions": self.preemptions,
        }
        if self.admitted_at is not None:
            out["queue_wait_s"] = self.admitted_at - self.submitted_at
        if self.first_token_at is not None:
            out["ttft_s"] = self.first_token_at - self.submitted_at
        if (self.finished_at is not None
                and self.first_token_at is not None
                and len(self.generated) >= 2):
            out["decode_token_s"] = (
                (self.finished_at - self.first_token_at)
                / (len(self.generated) - 1))
        if self.itl_gaps:
            gaps = sorted(self.itl_gaps)
            n = len(gaps)
            out["itl_p99_s"] = gaps[min(n - 1, -(-99 * n // 100) - 1)]
            out["itl_max_s"] = gaps[-1]
        return out


class Scheduler:
    """Slot + block bookkeeping for continuous batching.

    ``max_batch_size`` decode slots, ``block_size`` tokens per block,
    ``max_context`` per request, over the shared :class:`BlockAllocator`.
    ``max_waiting`` bounds the waiting queue.  ``chunk_size``: prefill
    chunk in tokens (None = the whole context in one
    :meth:`prefill_plan`, chunked prefill off).  ``prefix_cache``: a
    :class:`PrefixCache` sharing full blocks at admission (None = every
    prompt prefills from scratch).  ``overload``: an
    :class:`OverloadPolicy` (None = queue-full rejects, no pressure
    shedding; the preemption victim is then the youngest, as it is
    under uniform priorities)."""

    def __init__(self, allocator: BlockAllocator, *, max_batch_size: int,
                 block_size: int, max_context: int,
                 max_waiting: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 overload: Optional[OverloadPolicy] = None):
        if max_waiting is not None and max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = chunk_size
        self.allocator = allocator
        self.max_batch_size = max_batch_size
        self.block_size = block_size
        self.max_context = max_context
        self.max_waiting = max_waiting
        self.prefix_cache = prefix_cache
        self.overload = overload
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._free_slots = list(range(max_batch_size - 1, -1, -1))
        self.finished: List[Request] = []
        self.failures: Dict[str, int] = {}
        self.preemption_count = 0
        # speculative lookahead blocks granted / rolled back
        self.lookahead_granted = 0
        self.lookahead_rolled_back = 0
        # admission order among running requests: the preemption victim
        # is the worst priority, youngest within it, which converges
        self._admit_order: List[Request] = []
        # the in-flight hold: requests whose launched device step is not
        # retired yet (uid -> request); their blocks are pinned
        self.inflight: Dict[int, Request] = {}

    # -- submission -------------------------------------------------------

    def submit(self, req: Request) -> Request:
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if len(req.prompt) >= self.max_context:
            raise ValueError(
                f"prompt length {len(req.prompt)} must be < max_context "
                f"{self.max_context}")
        req.cost_blocks = BlockAllocator.blocks_for(
            len(req.prompt) + req.max_new_tokens, self.block_size)
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            # an arrival that outranks the worst queued request displaces
            # it (the victim finishes "shed"); one that outranks nobody
            # is rejected
            victim = (self._shed_candidate()
                      if self.overload is not None and self.overload.displace
                      else None)
            if victim is None or victim.priority <= req.priority:
                raise QueueFullError(
                    f"waiting queue full ({self.max_waiting} requests); "
                    f"request {req.uid} rejected")
            self.fail(victim, reasons.SHED)
        self.waiting.append(req)
        return req

    def _shed_candidate(self) -> Optional[Request]:
        """The waiting request shed first: the lowest priority class
        (highest number), the newest among equals."""
        if not self.waiting:
            return None
        return max(self.waiting, key=lambda r: (r.priority, r.uid))

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- overload pressure ---------------------------------------------------

    def pressure(self) -> float:
        """The overload signal: the max of the queue fill fraction and
        ``(live blocks + queued demand + prefill backlog) / usable
        blocks``; cache holds count as reclaimable.  May exceed 1."""
        q = (len(self.waiting) / self.max_waiting
             if self.max_waiting else 0.0)
        usable = self.allocator.cfg.num_blocks - 1
        reclaimable = self.allocator.num_free + (
            self.prefix_cache.num_evictable
            if self.prefix_cache is not None else 0)
        demand = sum(r.cost_blocks for r in self.waiting)
        demand += self.prefill_backlog_blocks()
        return max(q, (usable - reclaimable + demand) / usable)

    def prefill_backlog_blocks(self) -> int:
        """The running requests' tokens still to prefill, in blocks."""
        bs = self.block_size
        backlog = 0
        for r in self.running.values():
            if r.prefill_ctx is not None:
                rem = len(r.prefill_ctx) - r.num_cached
                if rem > 0:
                    backlog += -(-rem // bs)
        return backlog

    def shed_overload(self) -> List[Request]:
        """Shed best-effort waiting work, worst first, while
        :meth:`pressure` is at or above the policy's threshold; priority
        0 is never pressure-shed.  Returns the shed requests."""
        if self.overload is None or not self.waiting:
            return []
        shed: List[Request] = []
        while self.pressure() >= self.overload.shed_threshold:
            candidates = [r for r in self.waiting
                          if self.overload.sheddable(r.priority)]
            if not candidates:
                break
            victim = max(candidates, key=lambda r: (r.priority, r.uid))
            self.fail(victim, reasons.SHED)
            shed.append(victim)
        return shed

    # -- allocation under cache pressure ------------------------------------

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting prefix-cache holds as needed;
        None when nothing is free and nothing is evictable."""
        if n <= 0:
            return []
        while not self.allocator.can_alloc(n):
            # the whole deficit in ONE evict call: the victims demote to
            # the offload tier (when attached) as one batched export
            deficit = n - self.allocator.num_free
            if self.prefix_cache is None \
                    or not self.prefix_cache.evict(max(1, deficit)):
                return None
        return self.allocator.alloc(n)

    # -- iteration-level decisions ---------------------------------------

    def admit(self) -> List[Request]:
        """Fill free slots from the waiting queue (FIFO) while the pool
        can hold each candidate's prefill context plus one decode block.
        Matched prefix blocks come shared from the cache (promoted from
        its offload tier past the device tier); only the uncached tail
        needs fresh blocks (and one more for a
        whole-context match's COW duplicate).  Returns the newly
        admitted requests, now prefilling.  A head request that needs
        more blocks than the whole pool owns fails alone (``capacity``)
        and admission moves on."""
        admitted = []
        bs = self.block_size
        pool_blocks = self.allocator.cfg.num_blocks - 1
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            ctx = self._prefill_context(req)
            need = BlockAllocator.blocks_for(len(ctx) + 1, bs)
            if need > pool_blocks:
                self.fail(req, reasons.CAPACITY)
                continue
            matched = []
            if self.prefix_cache is not None:
                matched = self.prefix_cache.match(ctx)
                # where the device-tier walk stopped, the offload tier
                # goes on by content hash: promoted blocks extend
                # ``matched`` BEFORE the arithmetic below, so a hit
                # across tiers plans its prefill as a device hit of the
                # same depth does
                self.prefix_cache.promote(ctx, matched, self._try_alloc)
            hit = len(matched) * bs
            # a whole-context match still recomputes the last token's
            # logits, and its K/V write may not land in a shared block
            cow = bool(matched) and hit >= len(ctx)
            fresh = self._try_alloc(need - len(matched) + (1 if cow else 0))
            if fresh is None:
                if matched:
                    self.prefix_cache.cancel(matched)
                break               # fits once running requests retire
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            if cow:
                req.pending_cow = (matched[-1], fresh[0])
                req.block_table = matched[:-1] + fresh
                req.num_cached = len(ctx) - 1
            else:
                req.block_table = matched + fresh
                req.num_cached = hit
            req.cached_prefix_tokens = min(hit, len(ctx))
            req.prefill_ctx = ctx
            req.prefill_sample = not req.generated
            # matched blocks are indexed already; a COW duplicate stays
            # private, which breaks the chain for good
            req._reg_blocks = _REG_STOPPED if cow else len(matched)
            self.running[req.slot] = req
            self._admit_order.append(req)
            admitted.append(req)
            if self.prefix_cache is not None:
                c = self.prefix_cache.counters
                c.incr("prefix_hit_tokens", req.cached_prefix_tokens)
                c.incr("prefix_miss_tokens",
                       len(ctx) - req.cached_prefix_tokens)
                c.incr("prefix_hit_requests" if matched
                       else "prefix_miss_requests")
                if cow:
                    c.incr("prefix_cow_blocks")
        return admitted

    @staticmethod
    def _prefill_context(req: Request) -> List[int]:
        """The prompt, plus — after a preemption — every generated token
        except the pending one."""
        if req.generated:
            return req.prompt + req.generated[:-1]
        return list(req.prompt)

    def cow_done(self, req: Request) -> None:
        """The server duplicated ``pending_cow``; drop the admission's
        extra ref on the shared source block."""
        src, _ = req.pending_cow
        req.pending_cow = None
        self.allocator.free([src])

    def prefill_plan(self, req: Request) -> Tuple[List[int], int, bool]:
        """The next chunk of ``req``'s pending prefill: ``(tokens, start,
        is_last)``, ``start`` the position of ``tokens[0]`` (== K/V
        already materialized).  The caller runs the chunk through the
        engine, then :meth:`chunk_done`."""
        ctx = req.prefill_ctx
        if ctx is None:
            raise ValueError(f"prefill_plan on a request that is not "
                             f"prefilling (uid {req.uid})")
        start = req.num_cached
        n = len(ctx) - start
        if self.chunk_size is not None:
            n = min(n, self.chunk_size)
        return ctx[start:start + n], start, start + n == len(ctx)

    def chunk_done(self, req: Request, n: int) -> bool:
        """Account ``n`` freshly prefilled tokens and register the newly
        full blocks.  True = the prefill is complete and ``req`` joins
        the decode batch (the caller samples from the final chunk when
        ``req.prefill_sample``)."""
        req.num_cached += n
        self.register_progress(req)
        if req.num_cached == len(req.prefill_ctx):
            req.prefill_ctx = None
            return True
        return False

    def register_progress(self, req: Request) -> None:
        """Index every newly FULL block of ``req`` (prefill chunks, and
        decode or verify steps crossing a block boundary).  Stops for
        good at the first chain collision."""
        if self.prefix_cache is None:
            return
        bs = self.block_size
        full = req.num_cached // bs
        seq = req.prompt + req.generated
        while req._reg_blocks < full:
            i = req._reg_blocks
            parent = req.block_table[i - 1] if i else ROOT
            if not self.prefix_cache.register(
                    parent, tuple(seq[i * bs:(i + 1) * bs]),
                    req.block_table[i]):
                req._reg_blocks = _REG_STOPPED
                break
            req._reg_blocks += 1

    # -- the disaggregated prefill/decode hand-off ---------------------------

    @property
    def has_free_slot(self) -> bool:
        return bool(self._free_slots)

    def admit_handoff(self, req: Request, block_table: List[int]) -> None:
        """Admit a request whose context K/V is already materialized in
        this scheduler's pool (the decode half of the hand-off):
        ``block_table`` holds blocks allocated from THIS allocator, into
        which the caller copied the context.  The request skips the
        prefill state machine and enters the decode batch at its carried
        ``num_cached`` position with ``next_input`` pending — the state a
        just-finished local prefill leaves, so decode from here is the
        monolithic server's bit for bit.  No free slot, or no carried
        position, raises :class:`AssertionError`."""
        if not self._free_slots:
            raise AssertionError("admit_handoff with no free slot")
        if req.num_cached <= 0 or req.next_input is None:
            raise AssertionError(
                f"handoff request {req.uid} has no carried KV position "
                f"(num_cached={req.num_cached}, "
                f"next_input={req.next_input})")
        req.slot = self._free_slots.pop()
        req.block_table = list(block_table)
        req.prefill_ctx = None
        req.cached_prefix_tokens = 0
        # the handed-off blocks hold the request's own context, so they
        # register into this pool's prefix index (when one exists) as
        # locally prefilled blocks would
        req._reg_blocks = 0 if self.prefix_cache is not None \
            else _REG_STOPPED
        self.running[req.slot] = req
        self._admit_order.append(req)

    def release_handoff(self, req: Request) -> None:
        """Free a request's slot and blocks in THIS pool after its
        context was copied out (the prefill half of the hand-off).  Newly
        full blocks register into the prefix index first, so the prefill
        pool doubles as the warm shared-prefix cache: the blocks stay as
        evictable holds and the next shared-prefix admission matches
        them."""
        self.register_progress(req)
        self._release(req)

    def ensure_decode_capacity(self, req: Request) -> bool:
        """Grow ``req``'s block table if its next token write needs a
        fresh block, evicting cache holds first, then preempting while
        the pool stays dry.  False = ``req`` outgrew the pool with
        nothing left to evict or preempt; the caller fails it with
        ``finish_reason="capacity"``."""
        need_blocks = req.num_cached // self.block_size + 1
        while len(req.block_table) < need_blocks:
            fresh = self._try_alloc(1)
            if fresh is not None:
                req.block_table.extend(fresh)
                continue
            victim = self._preempt_victim(exclude=req)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    def lookahead_capacity(self, req: Request, tokens: int) -> int:
        """Grow ``req``'s table so up to ``tokens`` tokens can write at
        positions ``num_cached..``: the speculation lookahead.  Never
        preempts (a bad drafter must not degrade its neighbours), but
        may evict cache holds.  Returns how many tokens fit; the caller
        trims its draft to ``fit - 1``."""
        bs = self.block_size
        tokens = min(tokens, self.max_context - req.num_cached)
        while len(req.block_table) * bs - req.num_cached < tokens:
            fresh = self._try_alloc(1)
            if fresh is None:
                break
            req.block_table.extend(fresh)
            self.lookahead_granted += 1
        return max(0, min(tokens, len(req.block_table) * bs - req.num_cached))

    def rollback_lookahead(self, req: Request) -> int:
        """After a verify step, free the table blocks past the one the
        next token writes into: lookahead blocks allocated this
        iteration that hold only rejected positions (refcount 1, never
        registered).  Rejected K/V inside the kept block sits beyond
        ``num_cached``, masked.  Returns the blocks released."""
        keep = req.num_cached // self.block_size + 1
        tail = req.block_table[keep:]
        if not tail:
            return 0
        del req.block_table[keep:]
        self.allocator.free(tail)
        self.lookahead_rolled_back += len(tail)
        return len(tail)

    # -- the pipelined in-flight hold ---------------------------------------

    def hold_inflight(self, reqs: List[Request]) -> None:
        """Pin ``reqs`` for a launched-but-not-retired device step: until
        :meth:`release_inflight` they may not be preempted (their pending
        K/V writes would land in reallocated blocks).  One launch window
        at a time: holding while a hold is live is a serve-loop
        sequencing bug and raises :class:`AssertionError`."""
        if self.inflight:
            raise AssertionError(
                "hold_inflight while a launch window is already held")
        for req in reqs:
            if not req.running:
                raise AssertionError(
                    f"in-flight hold on non-running request {req.uid}")
            self.inflight[req.uid] = req

    def release_inflight(self) -> None:
        """The launched step's results were consumed: the window's
        requests are ordinary running requests again."""
        self.inflight.clear()

    # -- sampling-param batching -------------------------------------------

    @staticmethod
    def _pack_sampling(by_slot, width: int) -> Tuple[np.ndarray, ...]:
        """``{slot: SamplingParams}`` -> the per-slot launch arrays
        ``(temperature f32, top_k i32, top_p f32, seed i32)``, each
        ``(width,)``.  Unlisted slots get temperature 0: the greedy
        lane."""
        temp = np.zeros((width,), np.float32)
        tk = np.zeros((width,), np.int32)
        tp = np.ones((width,), np.float32)
        seed = np.zeros((width,), np.int32)
        for slot, s in by_slot.items():
            temp[slot] = s.temperature
            tk[slot] = 0 if s.top_k is None else int(s.top_k)
            tp[slot] = s.top_p
            seed[slot] = int(s.seed) & 0x7FFFFFFF
        return temp, tk, tp, seed

    def sampling_inputs(self, requests) -> Optional[Tuple]:
        """The per-slot sampling arrays of one batched decode or verify
        launch; None when every request is greedy (the argmax-only
        step)."""
        if all(r.sampling.is_greedy for r in requests):
            return None
        return self._pack_sampling({r.slot: r.sampling for r in requests},
                                   self.max_batch_size)

    @staticmethod
    def prefill_sampling(req: Request) -> Optional[Tuple]:
        """The (1,)-wide sampling arrays of one request's prefill or
        chunk launch (None = greedy)."""
        if req.sampling.is_greedy:
            return None
        return Scheduler._pack_sampling({0: req.sampling}, 1)

    def _preempt_victim(self, exclude: Request) -> Optional[Request]:
        """The worst priority class (highest number) among running
        requests other than ``exclude`` and the in-flight hold,
        youngest-admitted within it; with uniform priorities, the
        youngest."""
        victim = victim_key = None
        for i, req in enumerate(self._admit_order):
            if req is exclude or req.uid in self.inflight:
                continue
            key = (req.priority, i)
            if victim_key is None or key > victim_key:
                victim, victim_key = req, key
        return victim

    def preempt(self, req: Request) -> None:
        """Evict ``req`` to the waiting queue's FRONT (it has seniority
        over never-started requests), freeing its slot and blocks."""
        if not req.running:
            raise ValueError(f"can only preempt a running request "
                             f"(uid {req.uid})")
        req.preemptions += 1
        self.preemption_count += 1
        self._release(req)
        req.num_cached = 0
        self.waiting.appendleft(req)

    def retire(self, req: Request) -> None:
        """Return a finished request's slot and blocks (its registered
        blocks become evictable cache holds)."""
        if not req.finished:
            raise ValueError(f"retire() is for finished requests "
                             f"(uid {req.uid})")
        self.register_progress(req)
        self._release(req)
        self.finished.append(req)

    def fail(self, req: Request, reason: str) -> None:
        """Finish ``req`` with ``finish_reason=reason`` wherever it is in
        its lifecycle, returning any held slot and blocks.  Tokens
        generated so far stay on the request."""
        if req.finished:
            raise ValueError(f"fail() is for live requests (uid {req.uid})")
        if req.running:
            self._release(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        req.finished = True
        req.finish_reason = reason
        self.finished.append(req)
        self.failures[reason] = self.failures.get(reason, 0) + 1

    def _release(self, req: Request) -> None:
        del self.running[req.slot]
        self._admit_order.remove(req)
        self.inflight.pop(req.uid, None)
        self._free_slots.append(req.slot)
        req.slot = -1
        req.prefill_ctx = None
        req._reg_blocks = 0
        req.cached_prefix_tokens = 0
        if req.pending_cow is not None:
            # the admission's COW never ran: drop its ref on the source
            self.allocator.free([req.pending_cow[0]])
            req.pending_cow = None
        if req.block_table:
            self.allocator.free(req.block_table)
            req.block_table = []

    # -- invariants (tests + chip smoke) -----------------------------------

    def audit(self) -> None:
        """Refcount/free-list invariants: every block's refcount equals
        the running tables referencing it (plus a pending COW's source),
        a ref-0 block is either free or cache-held, the free list and
        free set mirror each other, waiting requests hold nothing, and
        every request in the in-flight hold is still running with its
        blocks.  Raises :class:`AssertionError`."""
        alloc = self.allocator
        table_refs: Dict[int, int] = {}
        for req in self.running.values():
            for b in req.block_table:
                table_refs[b] = table_refs.get(b, 0) + 1
            if req.pending_cow is not None:
                src = req.pending_cow[0]
                table_refs[src] = table_refs.get(src, 0) + 1
        for req in self.waiting:
            if req.block_table or req.pending_cow is not None:
                raise AssertionError(f"waiting request {req.uid} holds "
                                     "blocks")
        for uid, req in self.inflight.items():
            if not req.running or self.running.get(req.slot) is not req:
                raise AssertionError(
                    f"in-flight request {uid} is no longer running")
            if not req.block_table:
                raise AssertionError(
                    f"in-flight request {uid} holds no blocks")
        free = set(alloc._free)
        if not len(alloc._free) == len(free) == len(alloc._free_set) \
                or free != alloc._free_set:
            raise AssertionError("free list / free set diverged")
        held = (self.prefix_cache.held_blocks()
                if self.prefix_cache is not None else set())
        for b in range(1, alloc.cfg.num_blocks):
            r, t = alloc.refs(b), table_refs.get(b, 0)
            if r != t:
                raise AssertionError(
                    f"block {b}: refcount {r} != {t} table references")
            if r == 0 and (b in free) == (b in held):
                raise AssertionError(
                    f"ref-0 block {b}: free={b in free} held={b in held} "
                    "(must be exactly one)")
            if r and (b in free or b in held):
                raise AssertionError(f"live block {b} also free/held")
        if self.prefix_cache is not None:
            self.prefix_cache.audit()
