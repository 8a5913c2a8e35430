"""Continuous-batching request scheduler (Orca-style iteration-level).

Twin of ``apex_tpu/serving/scheduler.py`` for the slice without prefix
caching, overload control, disaggregated hand-off or speculative
look-ahead.  Every iteration the scheduler admits waiting requests into
free batch slots while the block pool can hold their prompts, grows each
running request's block table just in time for its next token —
preempting the youngest request back to the waiting queue when the pool
runs dry — and retires finished requests at once, so their slot and
blocks serve the next iteration.

Chunked prefill (Sarathi-style): :meth:`Scheduler.prefill_plan` hands
out a request's pending prefill ``chunk_size`` tokens at a time (the
whole context at once when ``chunk_size`` is None); the server runs one
chunk per prefilling request per iteration, interleaved with the decode
step, and :meth:`Scheduler.chunk_done` carries the KV position.

Preemption is recompute: the victim's blocks are freed, and on
re-admission its sequence so far re-prefills as a pseudo-prompt
(``prompt + generated[:-1]``) whose logits are discarded — the pending
last token re-enters the decode batch unchanged, so generation, greedy
or counter-keyed stochastic, is bit-stable across preemptions.

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

_uid = itertools.count()


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

    # runtime state (owned by the scheduler)
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                  # decode batch slot; -1 = not running
    block_table: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0             # tokens with K/V materialized
    next_input: Optional[int] = None  # pending token for the next decode
    finished: bool = False
    finish_reason: Optional[str] = None
    preemptions: int = 0
    # the context being (chunk-)prefilled, and whether its final chunk's
    # logits sample a token (False after preemption: the pending token
    # continues instead)
    prefill_ctx: Optional[List[int]] = None
    prefill_sample: bool = True

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


class Scheduler:
    """Slot + block bookkeeping for continuous batching.

    ``max_batch_size`` decode slots, ``block_size`` tokens per block,
    ``max_context`` per request, over the shared :class:`BlockAllocator`.
    ``max_waiting`` bounds the waiting queue.  ``chunk_size``: prefill
    chunk in tokens (None = the whole context in one
    :meth:`prefill_plan`, chunked prefill off)."""

    def __init__(self, allocator: BlockAllocator, *, max_batch_size: int,
                 block_size: int, max_context: int,
                 max_waiting: Optional[int] = None,
                 chunk_size: Optional[int] = None):
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
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> request
        self._free_slots = list(range(max_batch_size - 1, -1, -1))
        self.finished: List[Request] = []
        self.failures: Dict[str, int] = {}
        self.preemption_count = 0
        # admission order among running requests: the preemption victim
        # is the youngest, which converges — the oldest keeps its blocks
        self._admit_order: List[Request] = []

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
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            raise QueueFullError(
                f"waiting queue full ({self.max_waiting} requests); "
                f"request {req.uid} rejected")
        self.waiting.append(req)
        return req

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- iteration-level decisions ---------------------------------------

    def admit(self) -> List[Request]:
        """Fill free slots from the waiting queue (FIFO) while the pool
        can hold each candidate's prefill context plus one decode block.
        Returns the newly admitted requests, now prefilling.  A head
        request that needs more blocks than the whole pool owns fails
        alone (``capacity``) and admission moves on."""
        admitted = []
        pool_blocks = self.allocator.cfg.num_blocks - 1
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            ctx = self._prefill_context(req)
            need = BlockAllocator.blocks_for(len(ctx) + 1, self.block_size)
            if need > pool_blocks:
                self.fail(req, reasons.CAPACITY)
                continue
            if not self.allocator.can_alloc(need):
                break               # fits once running requests retire
            self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.block_table = self.allocator.alloc(need)
            req.num_cached = 0
            req.prefill_ctx = ctx
            req.prefill_sample = not req.generated
            self.running[req.slot] = req
            self._admit_order.append(req)
            admitted.append(req)
        return admitted

    @staticmethod
    def _prefill_context(req: Request) -> List[int]:
        """The prompt, plus — after a preemption — every generated token
        except the pending one."""
        if req.generated:
            return req.prompt + req.generated[:-1]
        return list(req.prompt)

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
        """Account ``n`` freshly prefilled tokens.  True = the prefill is
        complete and ``req`` joins the decode batch (the caller samples
        from the final chunk when ``req.prefill_sample``)."""
        req.num_cached += n
        if req.num_cached == len(req.prefill_ctx):
            req.prefill_ctx = None
            return True
        return False

    def ensure_decode_capacity(self, req: Request) -> bool:
        """Grow ``req``'s block table if its next token write needs a
        fresh block, preempting younger requests while the pool is dry.
        False = ``req`` outgrew the pool with nothing left to preempt;
        the caller fails it with ``finish_reason="capacity"``."""
        need_blocks = req.num_cached // self.block_size + 1
        while len(req.block_table) < need_blocks:
            if self.allocator.can_alloc(1):
                req.block_table.extend(self.allocator.alloc(1))
                continue
            victim = self._preempt_victim(exclude=req)
            if victim is None:
                return False
            self.preempt(victim)
        return True

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
        """The youngest-admitted running request other than ``exclude``."""
        for req in reversed(self._admit_order):
            if req is not exclude:
                return req
        return None

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
        """Return a finished request's slot and blocks."""
        if not req.finished:
            raise ValueError(f"retire() is for finished requests "
                             f"(uid {req.uid})")
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
        self._free_slots.append(req.slot)
        req.slot = -1
        req.prefill_ctx = None
        if req.block_table:
            self.allocator.free(req.block_table)
            req.block_table = []

    # -- invariants (tests + chip smoke) -----------------------------------

    def audit(self) -> None:
        """Refcount/free-list invariants: every block's refcount equals
        the number of running tables referencing it, ref-0 blocks are
        free, the free list and free set mirror each other, and waiting
        requests hold nothing.  Raises :class:`AssertionError`."""
        alloc = self.allocator
        table_refs: Dict[int, int] = {}
        for req in self.running.values():
            for b in req.block_table:
                table_refs[b] = table_refs.get(b, 0) + 1
        for req in self.waiting:
            if req.block_table:
                raise AssertionError(f"waiting request {req.uid} holds "
                                     "blocks")
        free = set(alloc._free)
        if not len(alloc._free) == len(free) == len(alloc._free_set) \
                or free != alloc._free_set:
            raise AssertionError("free list / free set diverged")
        for b in range(1, alloc.cfg.num_blocks):
            r, t = alloc.refs(b), table_refs.get(b, 0)
            if r != t:
                raise AssertionError(
                    f"block {b}: refcount {r} != {t} table references")
            if (r == 0) != (b in free):
                raise AssertionError(
                    f"block {b}: refcount {r} but free={b in free}")
