"""The continuous-batching server, pipelined by default.

Twin of ``apex_tpu/serving/api.py::InferenceServer`` with the reference's
default serving layers — the pipelined (dispatch-ahead) loop, the
circuit breaker and the transient-OOM retry, the prefix cache with
copy-on-write, n-gram speculative decoding, overload control, deadlines,
the drain/cancel/close lifecycle and per-token streaming — its
disaggregated prefill/decode on one host and its hierarchical KV offload
over the KV transport (both off by default, as there); without the
cross-replica hand-off, program accounting, a metrics registry or a
mesh.

Each :meth:`step` first RETIRES the previous iteration's launched decode
or verify step (waits on its CUDA event and applies its token ids and
finite flags), then plans: expires deadlines, sheds overload, admits
what fits (matching cached prefix blocks, duplicating a whole-context
hit's last block), advances every prefilling request by ONE chunk
(``prefill_chunk`` tokens, the default; the whole uncached tail with
``enable_chunked_prefill=False``) and samples the first token from a
prompt's last chunk; then it LAUNCHES one batched step over the rest of
the running batch — a verify step when any request has a draft, else a
decode step — without waiting on the card: the engine stages its inputs
in pinned memory, and the step's ids and finite flags come back by a
``non_blocking`` copy behind an event the next retire waits on.  Every
host decision therefore sees the state the synchronous loop would see,
and the tokens are the same; ``submit`` and ``cancel`` retire the window
first.  ``enable_pipeline=False`` runs the same steps synchronously.

**Disaggregated prefill/decode** (``enable_disagg=True``): a second
engine with its own pool (``disagg_prefill_blocks``) and its own
scheduler (``prefill_max_concurrent`` slots) runs every prefill on a
CUDA stream of its own, and the main engine becomes a pure decode pool
on the current stream — the two pools share no tensor, so their device
work does not serialize.  A step retires and launches the decode pool's
step first, then the prefill pool's chunks, which run under it.  A
finished prefill's first token and blocks move at the start of the next
step: its token is read, its blocks are copied into the decode pool
(``DecodeEngine.copy_blocks_from``) and the request joins the decode
batch at its carried position.  Two orderings cross the streams: the
copy waits (on the device) for an event the prefill stream records
after the request's last chunk, and the prefill stream's next launch
waits for an event the decode stream records after the copy, since the
released prefill blocks may be rewritten at once.  The prefill pool
holds the prefix cache, so released blocks stay warm there.  A hand-off
that finds no decode slot or blocks, or whose copy OOMs (torn or not),
stays queued with its blocks and retries whole next step.

**Hierarchical KV offload** (``enable_kv_offload=True``, or the
``APEX_TPU_KV_OFFLOAD`` environment variable when the kwarg is None):
evicted prefix-cache blocks demote into a bounded host-RAM store
(:class:`serving.offload.OffloadStore`, spilling to ``kv_offload_dir``)
and promote back at a later admission's cache walk, imported through the
checksummed ``import_blocks`` into the cache home's pool (the prefill
pool under disaggregation).  The promote rides the KV transport
(``kv_transport``, default an :class:`serving.transport.InProcessTransport`
on ``clock``): the server registers its ``"offload"`` peer there.

**Streaming** (``enable_streaming=True``, the default):
:meth:`InferenceServer.stream` gives a request's tokens as they retire
(:class:`serving.streaming.StreamBroker`): each applied token is
published, and each finished request's terminal reason.

Sampling happens on the device (the engine's ``*_sampled`` steps):
greedy, or a request's :class:`ops.SamplingParams` counter-keyed by its
seed, so only token ids and finite flags cross to the host.  A custom
``sample_fn`` takes the logits steps and samples on the host, with the
pipeline and speculation off.

Failure isolation: a request whose logits go non-finite fails alone, and
the :class:`resilience.CircuitBreaker` counts it, with every transient
engine OOM, as a failure: after a streak, ``submit`` fast-rejects
(``"breaker_open"``) until a half-open probe succeeds.  An OOM
(:data:`OOM_ERRORS`) out of an engine call skips that call for one
iteration — nothing was accounted and the K/V writes come last, so the
retry is bit for bit.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch._kernels.build import launch_counts
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.ops.sampling import SamplingParams
from apex_tpu_torch.resilience.breaker import CircuitBreaker
from apex_tpu_torch.serving import reasons
from apex_tpu_torch.serving.engine import DecodeEngine
from apex_tpu_torch.serving.kv_cache import KV_QUANT_ENV
from apex_tpu_torch.serving.offload import KV_OFFLOAD_ENV, OffloadStore, \
    resolve_kv_offload
from apex_tpu_torch.serving.oom import OOM_ERRORS
from apex_tpu_torch.serving.overload import AdmissionEstimator, \
    OverloadPolicy
from apex_tpu_torch.serving.prefix_cache import PrefixCache
from apex_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler
from apex_tpu_torch.serving.speculation import DraftSource, NgramDraft
from apex_tpu_torch.serving.streaming import StreamBroker, TokenStream
from apex_tpu_torch.serving.transport import InProcessTransport, \
    KVTransport, TransportPolicy
from apex_tpu_torch.utils.meters import CounterMeter

# the reference's default prefill chunk, capped at max_context
DEFAULT_PREFILL_CHUNK = 256
# the reference's default drafted tokens a verify step
DEFAULT_SPEC_TOKENS = 4


def greedy_sample(logits) -> np.ndarray:
    """(…, V) host logits -> (…,) argmax token ids; ties break toward
    the LOWEST id (``np.argmax``'s rule, the contract the device-side
    :func:`ops.greedy_argmax` matches)."""
    logits = np.asarray(logits)
    if not np.issubdtype(logits.dtype, np.floating):
        raise TypeError(
            f"greedy_sample expects floating-point logits, got dtype "
            f"{logits.dtype} (token ids passed where logits belong?)")
    return np.argmax(logits, axis=-1)


class _Gauge:
    """Latest value, peak and running mean of a level sampled once per
    step."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.peak = self.sum = 0.0
        self.count = 0

    def update(self, val: float):
        self.val = float(val)
        self.peak = max(self.peak, self.val)
        self.sum += self.val
        self.count += 1

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def _rank(v, pct: int):
    """The ``pct``-th percentile of the sorted list ``v``, nearest
    rank."""
    return v[-(-pct * len(v) // 100) - 1]


def _depths(values) -> dict:
    """count, p50, p90 (nearest rank), mean and max of recorded
    drafted or accepted depths."""
    if not values:
        return {"count": 0}
    v = sorted(values)
    return {"count": len(v), "p50": _rank(v, 50), "p90": _rank(v, 90),
            "mean": round(sum(v) / len(v), 3), "max": v[-1]}


def _hist_ms(seconds) -> dict:
    """count, p50, p90, p99 (nearest rank) and max in milliseconds of
    recorded durations in seconds: the reference's histogram view, over
    the exact samples."""
    if not seconds:
        return {"count": 0}
    v = sorted(seconds)
    return {"count": len(v),
            **{f"p{p}": round(_rank(v, p) * 1e3, 3) for p in (50, 90, 99)},
            "max": round(v[-1] * 1e3, 3)}


class _InflightStep:
    """One launched-but-not-retired device step (the depth-1 window):
    the requests it covers, the draft map and per-slot lengths (verify
    only), the host tensors its token ids and finite flags are being
    copied into, the event after that copy (None on the CPU, where the
    tensors are the results themselves), and the launch-time clock that
    device-side failures observed a step later are anchored to."""

    __slots__ = ("kind", "running", "drafts", "lengths", "ids", "finite",
                 "event", "launched_at")

    def __init__(self, kind, running, ids, finite, event, launched_at,
                 drafts=None, lengths=None):
        self.kind = kind                  # "decode" | "verify"
        self.running = running
        self.ids = ids
        self.finite = finite
        self.event = event
        self.launched_at = launched_at
        self.drafts = drafts
        self.lengths = lengths


class _Handoff:
    """One finished prefill waiting to move pools (``enable_disagg``):
    the request; under pipelining the host tensors its last chunk's
    token id and finite flag are being copied into, read when the
    hand-off is processed next step; and the event the prefill engine
    recorded after that chunk (after those copies), which the copy into
    the decode pool waits on (None on the CPU)."""

    __slots__ = ("req", "handles", "event")

    def __init__(self, req, handles=None, event=None):
        self.req = req
        self.handles = handles
        self.event = event


class InferenceServer:
    """Batched GPT inference with a paged KV cache and continuous
    batching.

    Args (the first group passes to :class:`DecodeEngine`):
      cfg, params: the architecture and its ``state_dict``.
      device: ``"cuda"`` (default) or ``"cpu"``.
      max_batch_size, max_context, num_blocks, block_size, cache_dtype:
        see :class:`DecodeEngine` (flash prefill, chunk attention,
        cached-attention decode).
      kv_quant: ``"int8"`` serves from the quantized pool (decode on
        kernel B8); ``"off"`` pins the full-width pool; None defers to
        the ``APEX_TPU_KV_QUANT`` environment variable (unset: off).
        A kwarg that is given wins over the environment.
      sample_fn: a custom host sampler, (…, V) numpy logits -> (…,)
        token ids.  Passing one warns: it takes the logits steps,
        samples on the host, turns the pipeline and speculation off and
        ignores per-request :class:`SamplingParams`.  None (default) is
        :func:`greedy_sample`, with sampling on the device.
      max_waiting: bound on the waiting queue; a submit past it comes
        back already finished with ``finish_reason="rejected"`` (or
        displaces lower-priority queued work under overload control).
      clock: the wall-deadline, timeline and breaker time source
        (monotonic seconds), injectable so deadline tests never sleep.
      enable_prefix_cache: block-level prefix sharing at admission
        (:mod:`serving.prefix_cache`, default on): shared-prefix traffic
        skips re-prefilling cached full blocks.
      enable_chunked_prefill: prefill in chunks of ``prefill_chunk``
        tokens (default on, as the reference); False prefills each
        prompt whole through the bucketed flash prefill (a prefix hit's
        tail through one bucketed chunk).
      prefill_chunk: the chunk, default ``min(256, max_context)``.
      enable_speculation: speculative decoding (default on): each decode
        iteration, requests with a draft feed their pending token plus
        up to ``spec_tokens`` guesses through ``engine.verify_sampled``
        and keep the longest prefix equal to the model's own tokens,
        plus the model's next token.  Greedy requests keep the argmax's
        tokens exactly; stochastic ones compare drafts against each
        column's counter-keyed sample (rejection sampling), so the
        stream is the same with speculation on or off.
      spec_tokens: the most drafted tokens a verify step (default 4).
      draft_source: the :class:`serving.speculation.DraftSource`
        (default :class:`~serving.speculation.NgramDraft`).
      enable_pipeline: the dispatch-ahead loop (default on): decode and
        verify steps are launched without waiting on the card and
        retired at the start of the next step; the tokens are the
        synchronous loop's.  Off with a custom ``sample_fn``.
      enable_overload: priority-aware load shedding (default on) with
        ``overload_policy`` (default: :class:`OverloadPolicy`'s stock
        thresholds); False makes queue-full strictly reject.
      enable_breaker: the circuit breaker in front of ``submit``
        (default on); ``breaker`` a :class:`resilience.CircuitBreaker`
        (default: one on ``clock`` with the reference's thresholds).  A
        breaker without counters reports through ``stats()``.
      enable_disagg: disaggregated prefill/decode on one host (default
        off): every prefill runs in a second engine with its own pool of
        ``disagg_prefill_blocks`` blocks (default room for
        ``prefill_max_concurrent`` full-context prefills plus the garbage
        block; fewer than one full context plus the garbage block
        raises) and ``prefill_max_concurrent`` slots (default 2, at
        least 1), on a CUDA stream of its own; finished prefills hand
        their blocks to this engine's pool, which only decodes.
      enable_streaming: per-token delivery through :meth:`stream`
        (default on), each stream's queue bounded at
        ``stream_queue_tokens`` (default 256; a slow consumer's oldest
        notifications drop and are backfilled from the request).
      enable_kv_offload: hierarchical KV offload (default off; None
        defers to the ``APEX_TPU_KV_OFFLOAD`` environment variable, and
        a kwarg that is given wins): cold evictable prefix-cache blocks
        demote into a bounded host-RAM store — optionally spilling to
        ``kv_offload_dir`` with checksummed atomic writes — instead of
        dying at eviction, and promote back into fresh blocks
        (checksummed ``import_blocks``) when a later admission's walk
        wants them, so a cache hit spans device -> host -> disk at a
        fixed pool.  Every integrity or capacity failure on the offload
        path falls back to cold prefill, with the same tokens.  Needs
        the prefix cache (``ValueError`` without it).
      kv_offload_host_bytes: the host-RAM tier's byte bound (default 64
        MiB); the coldest entries past it spill or drop.
      kv_offload_dir: optional disk spill tier directory; surviving
        entries are adopted on construction (content-addressed).
      kv_transport: the KV transport backend the offload promote rides,
        a :class:`serving.transport.KVTransport`; default a fresh
        :class:`~serving.transport.InProcessTransport` on ``clock`` (the
        direct import call under the envelope).  The server registers
        its ``"offload"`` ingest peer on it, ``stats()["transport"]``
        reports the envelope's counters either way, and :meth:`close`
        closes it.

    Example::

        server = InferenceServer(cfg, params, device="cuda")
        outs = server.generate(prompts, max_new_tokens=64,
                               sampling=SamplingParams(temperature=0.8,
                                                       top_p=0.9, seed=1))
    """

    def __init__(self, cfg: GPTConfig, params, *,
                 device="cuda",
                 max_batch_size: int = 8,
                 max_context: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 block_size: int = 16,
                 cache_dtype: Optional[torch.dtype] = None,
                 kv_quant: Optional[str] = None,
                 sample_fn: Optional[Callable] = None,
                 max_waiting: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 enable_prefix_cache: bool = True,
                 enable_chunked_prefill: bool = True,
                 prefill_chunk: Optional[int] = None,
                 enable_speculation: bool = True,
                 spec_tokens: Optional[int] = None,
                 draft_source: Optional[DraftSource] = None,
                 enable_pipeline: bool = True,
                 enable_overload: bool = True,
                 overload_policy: Optional[OverloadPolicy] = None,
                 enable_breaker: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 enable_disagg: bool = False,
                 disagg_prefill_blocks: Optional[int] = None,
                 prefill_max_concurrent: int = 2,
                 enable_streaming: bool = True,
                 stream_queue_tokens: int = 256,
                 enable_kv_offload: Optional[bool] = None,
                 kv_offload_host_bytes: int = 64 << 20,
                 kv_offload_dir: Optional[str] = None,
                 kv_transport: Optional[KVTransport] = None):
        if kv_quant is None:
            kv_quant = os.environ.get(KV_QUANT_ENV)
        self.engine = DecodeEngine(
            cfg, params, device=device, max_batch_size=max_batch_size,
            max_context=max_context, num_blocks=num_blocks,
            block_size=block_size, cache_dtype=cache_dtype,
            kv_quant=kv_quant)
        # the prefill pool: same geometry, dtype and quantization, one
        # request a prefill, its launches on a stream of its own
        self.disagg = bool(enable_disagg)
        self.prefill_engine: Optional[DecodeEngine] = None
        if self.disagg:
            if prefill_max_concurrent < 1:
                raise ValueError(
                    f"prefill_max_concurrent must be >= 1, got "
                    f"{prefill_max_concurrent}")
            bps = self.engine.blocks_per_seq
            if disagg_prefill_blocks is None:
                disagg_prefill_blocks = prefill_max_concurrent * bps + 1
            if disagg_prefill_blocks < bps + 1:
                raise ValueError(
                    f"disagg_prefill_blocks={disagg_prefill_blocks} "
                    f"cannot hold one full-context prefill ({bps} "
                    f"blocks + garbage)")
            dev = self.engine.device
            self.prefill_engine = DecodeEngine(
                cfg, params, device=dev, max_batch_size=1,
                max_context=self.engine.max_context,
                num_blocks=int(disagg_prefill_blocks),
                block_size=block_size, cache_dtype=cache_dtype,
                kv_quant=kv_quant,
                stream=(torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None))
        self.clock = clock
        self.sample_fn = sample_fn or greedy_sample
        if self.sample_fn is not greedy_sample:
            warnings.warn(
                "a custom sample_fn disables the serving fast paths: "
                "speculative decoding and the pipelined loop fall back to "
                "the synchronous logits path, and per-request "
                "SamplingParams are ignored; pass SamplingParams(...) per "
                "request instead", UserWarning, stacklevel=2)
        self.prefill_chunk = None
        if enable_chunked_prefill:
            self.prefill_chunk = int(
                prefill_chunk if prefill_chunk is not None
                else min(DEFAULT_PREFILL_CHUNK, self.engine.max_context))
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else DEFAULT_SPEC_TOKENS)
        if self.spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1, got {self.spec_tokens}")
        self.draft_source = (draft_source if draft_source is not None
                             else NgramDraft())
        self.speculating = bool(enable_speculation
                                and self.sample_fn is greedy_sample)
        # the pipelined loop needs the sampler on the device
        self.pipelining = bool(enable_pipeline
                               and self.sample_fn is greedy_sample)
        self._inflight: Optional[_InflightStep] = None
        self._pending_produced = 0     # retired outside step() (submit)
        self.breaker_events = CounterMeter()
        self.breaker = (
            breaker if breaker is not None
            else CircuitBreaker(clock=clock, counters=self.breaker_events)
        ) if enable_breaker else None
        if self.breaker is not None and self.breaker.counters is None:
            # a caller's breaker without counters reports through stats()
            self.breaker.counters = self.breaker_events
        self.overload_policy = (
            overload_policy if overload_policy is not None
            else OverloadPolicy()) if enable_overload else None
        # predictive admission: only when the policy arms it
        self.admission = (
            AdmissionEstimator(
                min_history=self.overload_policy.admission_min_history,
                margin=self.overload_policy.admission_margin)
            if self.overload_policy is not None
            and self.overload_policy.predictive_admission else None)
        self.prefix = CounterMeter()
        # the prefix cache lives with the pool that runs prefills
        self.prefix_cache = (
            PrefixCache((self.prefill_engine or self.engine).allocator,
                        self.engine.block_size, counters=self.prefix)
            if enable_prefix_cache else None)
        if enable_kv_offload is None:
            enable_kv_offload = os.environ.get(KV_OFFLOAD_ENV)
        self.kv_offload = resolve_kv_offload(enable_kv_offload)
        # the offload promote rides the transport's envelope; the default
        # in-process backend on the server's clock is the direct import
        # call, with no extra random draws and no extra branch
        self.kv_transport = kv_transport if kv_transport is not None \
            else InProcessTransport(policy=TransportPolicy(clock=clock))
        self.kv_transport.register_peer("offload", self._offload_ingest)
        self.offload_store: Optional[OffloadStore] = None
        if self.kv_offload:
            if self.prefix_cache is None:
                raise ValueError(
                    "enable_kv_offload requires the prefix cache "
                    "(enable_prefix_cache=True) — the offload tiers "
                    "extend its radix index")
            self.offload_store = OffloadStore(
                host_bytes=kv_offload_host_bytes, spill_dir=kv_offload_dir)
            # the closures resolve the cache-home engine at call time, so
            # a wrapper installed on it later intercepts; reset_meters
            # gives the store and the cache the server's meters
            self.prefix_cache.attach_offload(
                self.offload_store,
                lambda ids: self._cache_home().export_blocks(
                    ids, per_block_crc=True),
                lambda ids, payload: self.kv_transport.send(
                    "offload",
                    {"op": "promote", "blocks": [int(b) for b in ids]},
                    payload),
                clock=clock)
        self.scheduler = Scheduler(
            self.engine.allocator,
            max_batch_size=self.engine.max_batch_size,
            block_size=self.engine.block_size,
            max_context=self.engine.max_context,
            max_waiting=None if self.disagg else max_waiting,
            chunk_size=self.prefill_chunk,
            prefix_cache=None if self.disagg else self.prefix_cache,
            overload=self.overload_policy)
        self.prefill_scheduler: Optional[Scheduler] = None
        self._handoff: Deque[_Handoff] = deque()
        if self.disagg:
            self.prefill_scheduler = Scheduler(
                self.prefill_engine.allocator,
                max_batch_size=int(prefill_max_concurrent),
                block_size=self.engine.block_size,
                max_context=self.engine.max_context,
                max_waiting=max_waiting, chunk_size=self.prefill_chunk,
                prefix_cache=self.prefix_cache,
                overload=self.overload_policy)
            # one terminal ledger across the pools: a request finishes
            # once, wherever it is
            self.prefill_scheduler.finished = self.scheduler.finished
            self.prefill_scheduler.failures = self.scheduler.failures
        self.stream_broker: Optional[StreamBroker] = (
            StreamBroker(queue_tokens=stream_queue_tokens)
            if enable_streaming else None)
        self._iter = 0              # scheduler iterations served
        self._finalized = 0         # scheduler.finished timeline cursor
        self._draining = False
        self._closed = False
        self._final_stats: Optional[dict] = None
        self.queue_depth = _Gauge()
        self.occupancy = _Gauge()
        self.chunk_iters = _Gauge()
        self.pressure_gauge = _Gauge()
        self.handoff_pending = _Gauge()
        self.reset_meters()

    # -- request lifecycle ------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None, *,
               priority: int = 0,
               deadline_iters: Optional[int] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Enqueue one request.  ``max_new_tokens`` must be >= 1; a prompt
        leaving no room to generate within ``max_context`` raises
        :class:`ValueError`, and a budget overshooting the remaining
        context is capped to fit.  ``priority`` is nice-style (0 =
        foreground; larger = lower, sheddable under overload).
        ``deadline_iters`` / ``deadline_s`` expire the request to
        ``finish_reason="timeout"``.  ``sampling``: a
        :class:`SamplingParams` (None = greedy); anything else raises
        :class:`TypeError`.

        The request may come back already finished, ``finished_at``
        stamped now: ``"rejected"`` (queue full, nothing lower to
        displace), ``"draining"`` (after :meth:`begin_drain`),
        ``"breaker_open"`` (the breaker is open) or ``"shed"``
        (predictive admission).  A queue-full submit may instead
        displace a lower-priority queued request, which then finishes
        ``"shed"``.  A launched step is retired first, so the breaker,
        the displacement and the queue see its results.  Submitting to
        a closed server raises :class:`RuntimeError`."""
        if self._closed:
            raise RuntimeError(
                "InferenceServer is closed; no further submissions")
        if self._inflight is not None:
            self._pending_produced += self._flush_window()
        prompt = [int(t) for t in prompt]
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        cap = self.engine.max_context - len(prompt)
        if cap <= 0:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room to generate "
                f"within max_context={self.engine.max_context}")
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError(
                f"sampling must be a SamplingParams (or None for "
                f"greedy), got {type(sampling).__name__}")
        req = Request(prompt=prompt,
                      max_new_tokens=min(int(max_new_tokens), cap),
                      eos_id=eos_id, priority=int(priority),
                      deadline_iters=deadline_iters, deadline_s=deadline_s,
                      submit_iter=self._iter, submitted_at=self.clock(),
                      sampling=sampling if sampling is not None
                      else SamplingParams())
        klass = req.sampling.klass
        self.sampling_requests[klass] = \
            self.sampling_requests.get(klass, 0) + 1
        if self._draining:
            return self._finish_at_submit(req, reasons.DRAINING)
        if self.breaker is not None and not self.breaker.allow():
            return self._finish_at_submit(req, reasons.BREAKER_OPEN)
        if self.admission is not None and self.admission.doomed(req):
            return self._finish_at_submit(req, reasons.SHED)
        try:
            # under disaggregation every request enters through the
            # prefill pool's queue; the decode pool admits only hand-offs
            (self.prefill_scheduler if self.disagg
             else self.scheduler).submit(req)
        except QueueFullError:
            return self._finish_at_submit(req, reasons.REJECTED)
        # a displaced victim finished "shed" inside scheduler.submit
        self._finalize_finished()
        return req

    def _finish_at_submit(self, req: Request, reason: str) -> Request:
        """Finish ``req`` without enqueueing it, ``finished_at`` now."""
        sched = self.scheduler
        req.finished = True
        req.finish_reason = reason
        sched.finished.append(req)
        sched.failures[reason] = sched.failures.get(reason, 0) + 1
        self._finalize_finished()
        return req

    def _expire_deadlines(self) -> None:
        """Fail every live request, waiting or running (in both pools
        under disaggregation), whose iteration or wall budget is
        spent."""
        now = self.clock()
        for sched in self._schedulers():
            for req in list(sched.waiting) + list(sched.running.values()):
                over_iters = (req.deadline_iters is not None
                              and self._iter - req.submit_iter
                              > req.deadline_iters)
                over_wall = (req.deadline_s is not None
                             and now - req.submitted_at >= req.deadline_s)
                if over_iters or over_wall:
                    sched.fail(req, reasons.TIMEOUT)

    def _schedulers(self):
        """``(decode, prefill)`` under disaggregation, else the one
        scheduler."""
        if self.disagg:
            return (self.scheduler, self.prefill_scheduler)
        return (self.scheduler,)

    @property
    def has_work(self) -> bool:
        """Queued, running, launched-but-not-retired or pending hand-off
        work, in either pool."""
        return (any(sched.has_work for sched in self._schedulers())
                or self._inflight is not None or bool(self._handoff))

    def pressure(self) -> float:
        """The overload signal (:meth:`Scheduler.pressure`), the larger
        of the two pools' under disaggregation."""
        return max(sched.pressure() for sched in self._schedulers())

    def step(self) -> int:
        """One continuous-batching iteration: retire the previous
        iteration's launched step (pipelined loop), expire deadlines,
        shed overload, admit (copying whole-context hits' last blocks),
        advance every prefilling request by one chunk (sampling its
        first token from the last, synchronously in both loops), then
        one step across the rest of the running batch — verify when any
        request has a draft, else decode — launched without waiting when
        pipelining (its tokens retire at the start of the next step or
        at the next ``submit``/``cancel``), applied at once otherwise.
        Returns the number of tokens applied to requests in this call.
        A request whose logits go non-finite, that outgrows the pool
        with nothing left to preempt, or whose deadline passes, fails
        alone; a transient engine OOM skips the affected call for one
        iteration, and its retry is bit for bit."""
        if self.disagg:
            return self._step_disagg()
        sched = self.scheduler
        self._iter += 1
        produced, self._pending_produced = self._pending_produced, 0
        # RETIRE before any host decision: deadlines, shedding, admission
        # and drafts then see the state the synchronous loop would see
        produced += self._flush_window()
        plan_start = self.clock()
        self._expire_deadlines()
        # the pressure signal at its pre-shed peak, then the shed
        self.pressure_gauge.update(sched.pressure())
        sched.shed_overload()
        self._admit(sched, self.engine)
        chunks = 0
        for req in [r for r in sched._admit_order if r.prefilling]:
            launched = self._prefill_launch(req, sched, self.engine)
            if launched is None:
                continue        # an OOM: this exact chunk replays next step
            out, finite, n, monolithic = launched
            if not monolithic:
                chunks += 1
            if not sched.chunk_done(req, n) or not req.prefill_sample:
                continue    # mid-prefill, or a resumed request's pending
                            # token continues
            produced += self._first_token(sched, req,
                                          self._prefill_token(out, finite))
        self.chunk_iters.update(chunks)
        self.prefill_chunks += chunks
        produced += self._decode_batch()
        return self._end_step(produced, plan_start, sched.num_waiting)

    def _admit(self, sched: Scheduler, engine: DecodeEngine) -> None:
        """Admit what fits into ``sched``'s pool, stamping first
        admissions, then duplicate whole-context cache hits' last shared
        blocks, so the re-write of the last token stays private."""
        now = self.clock()
        for req in sched.admit():
            if req.admitted_at is None:
                req.admitted_at = now
        cows = [r for r in sched._admit_order if r.pending_cow]
        if cows:
            try:
                engine.copy_blocks([r.pending_cow for r in cows])
            except OOM_ERRORS:
                # nothing was accounted: the same copies run next step
                self._note_oom("copy_blocks")
            else:
                for req in cows:
                    sched.cow_done(req)

    def _first_token(self, sched: Scheduler, req: Request,
                     tok: Optional[int]) -> int:
        """Apply a prefill's first token (None: its logits went
        non-finite, and ``req`` fails); retire ``req`` if the token
        finishes it.  Returns the tokens produced."""
        if tok is None:
            sched.fail(req, reasons.NONFINITE)
            if self.breaker is not None:
                self.breaker.record_failure()
            return 0
        req.record_token(tok)
        self._note_token(req)
        if req.finished:
            sched.retire(req)
            if self.breaker is not None:
                self.breaker.record_success()
        return 1

    def _decode_batch(self) -> int:
        """The decode pool's share of a step: grow every running
        request's table for its next token (preempting, or failing a
        request that outgrew the pool), then one step across the running
        batch — verify when any request has a draft, else decode —
        launched when pipelining (its tokens retire next step), applied
        at once otherwise.  Returns the tokens applied."""
        sched = self.scheduler
        for req in list(sched.running.values()):
            if req.running and not req.prefilling \
                    and not sched.ensure_decode_capacity(req):
                sched.fail(req, reasons.CAPACITY)
        if self.disagg:
            # a decode-pool preemption victim re-prefills: it re-enters
            # at the front of the prefill pool's queue, keeping its
            # seniority (its pending token continues, as monolithic)
            while sched.waiting:
                self.prefill_scheduler.waiting.appendleft(
                    sched.waiting.pop())
        running = [r for r in sched.running.values() if not r.prefilling]
        if not running:
            return 0
        drafts = self._propose_drafts(running) if self.speculating else {}
        if self.pipelining:
            # LAUNCH: its tokens retire at the next step
            if drafts:
                self._launch_verify(running, drafts)
            else:
                self._launch_decode(running)
            return 0
        if drafts:
            return self._verify_step(running, drafts)
        return self._decode_step(running)

    def _end_step(self, produced: int, plan_start: float,
                  waiting: int) -> int:
        """A step's bookkeeping: the plan time (pipelined), the token
        count, the gauges and the finished requests' stamps."""
        if self.pipelining:
            self.plan_time.append(self.clock() - plan_start)
        self.tokens_generated += produced
        self.queue_depth.update(waiting)
        self.occupancy.update(self.scheduler.num_running
                              / self.engine.max_batch_size)
        self._finalize_finished()
        return produced

    def _prefill_launch(self, req: Request, sched: Scheduler,
                        engine: DecodeEngine):
        """Run ``req``'s next prefill chunk (or its monolithic prefill)
        on ``engine``: ``(ids, finite, tokens fed, monolithic)`` — under
        a custom ``sample_fn`` the last-token logits and None in place
        of ids and finite — or None when the engine OOMed.  Only a fresh
        prompt's last chunk passes its sampling parameters.  Counts a
        monolithic prefill."""
        tokens, start, is_last = sched.prefill_plan(req)
        host = self.sample_fn is not greedy_sample
        samp = (sched.prefill_sampling(req)
                if is_last and req.prefill_sample and not host else None)
        # the kwarg is left out on greedy launches, as the reference
        # does, so engine wrappers without it keep working
        kw = {"sampling": samp} if samp is not None else {}
        # no cached prefix, no chunking: the monolithic prefill
        monolithic = start == 0 and is_last and self.prefill_chunk is None
        try:
            if monolithic:
                out = (engine.prefill(tokens, req.block_table) if host
                       else engine.prefill_sampled(tokens, req.block_table,
                                                   **kw))
            else:
                out = (engine.chunk_prefill(tokens, start, req.block_table,
                                            pad_to=self.prefill_chunk)
                       if host else engine.chunk_prefill_sampled(
                           tokens, start, req.block_table,
                           pad_to=self.prefill_chunk, **kw))
        except OOM_ERRORS:
            # chunk_done is not called: the chunk replays next step
            self._note_oom("prefill")
            return None
        if monolithic:
            self.prefills += 1
        if host:
            return out, None, len(tokens), monolithic
        return out[0], out[1], len(tokens), monolithic

    def _prefill_token(self, out, finite) -> Optional[int]:
        """A request's first token from its last chunk's result, read
        synchronously in both loops (the token decides whether the
        request joins this step's launch); None when the logits went
        non-finite."""
        if finite is None:          # a custom sample_fn's host logits
            logits = out.cpu().numpy()
            if not np.all(np.isfinite(logits)):
                return None
            return int(self.sample_fn(logits))
        if not bool(finite[0]):
            return None
        return int(out[0])

    # -- disaggregated prefill/decode ---------------------------------------

    def _step_disagg(self) -> int:
        """One disaggregated iteration: the decode pool retires, hands
        off the prefills finished earlier, and launches its pure
        decode/verify step; then the prefill pool admits and launches up
        to ``prefill_max_concurrent`` chunks on its own stream, which
        run under the in-flight decode step.  The tokens are the
        monolithic server's: the same steps on the same contexts, and
        the copy moves every byte."""
        psched = self.prefill_scheduler
        self._iter += 1
        produced, self._pending_produced = self._pending_produced, 0
        # RETIRE the decode pool's step first: the inter-token edge the
        # disaggregation protects
        produced += self._flush_window()
        plan_start = self.clock()
        self._expire_deadlines()
        self.pressure_gauge.update(self.pressure())
        psched.shed_overload()
        produced += self._process_handoffs()
        produced += self._decode_batch()
        # the prefill pool's launches come after the decode launch, so
        # they run under it instead of in front of it
        chunks, pf_produced = self._prefill_slice()
        self.chunk_iters.update(chunks)
        self.prefill_chunks += chunks
        self.handoff_pending.update(len(self._handoff))
        return self._end_step(produced + pf_produced, plan_start,
                              psched.num_waiting)

    def _prefill_slice(self):
        """The prefill pool's share of a disaggregated step: admission,
        COW copies and one chunk per prefilling request on the prefill
        engine's stream.  A finished prefill joins the hand-off queue
        with the event its engine records after the last chunk; under
        pipelining its token's host copy is only started here and read
        at the hand-off, so the slice does not wait on the card.
        Returns ``(chunk launches, tokens produced)``."""
        psched, engine = self.prefill_scheduler, self.prefill_engine
        self._admit(psched, engine)
        chunks = produced = 0
        for req in [r for r in psched._admit_order if r.prefilling]:
            launched = self._prefill_launch(req, psched, engine)
            if launched is None:
                continue        # an OOM: this exact chunk replays next step
            out, finite, n, monolithic = launched
            if not monolithic:
                chunks += 1
            if not psched.chunk_done(req, n):
                continue
            if not req.prefill_sample:
                # resumed after a preemption: the pending token
                # continues, nothing to sample
                self._handoff.append(_Handoff(req,
                                              event=engine.record_event()))
                continue
            # the token's results live on the prefill stream: bring them
            # back on it, behind an event (a custom sample_fn's logits
            # alone)
            if finite is None:
                (out,), event = engine.to_host_async(out)
            else:
                (out, finite), event = engine.to_host_async(out, finite)
            if self.pipelining:
                self._handoff.append(_Handoff(req, (out, finite), event))
                continue
            if event is not None:
                event.synchronize()
            produced += self._first_token(psched, req,
                                          self._prefill_token(out, finite))
            if not req.finished:
                self._handoff.append(_Handoff(req, event=event))
        return chunks, produced

    def _process_handoffs(self) -> int:
        """Drain the hand-off queue, first in first out: read each
        finished prefill's first token (pipelined), then copy its blocks
        into the decode pool and admit it there.  One that finds no
        decode slot or blocks, or whose copy OOMs (torn or not), stays
        queued with its prefill blocks and retries whole next step: the
        copy moves whole tables, so a torn copy is re-copied as a
        delayed one.  Returns the first tokens produced."""
        sched, psched = self.scheduler, self.prefill_scheduler
        q = self._handoff
        produced = 0
        while q:
            ent = q[0]
            req = ent.req
            if req.finished or not req.running:
                q.popleft()     # expired, cancelled or failed while queued
                continue
            if ent.handles is not None:
                if ent.event is not None:
                    ent.event.synchronize()
                tok = self._prefill_token(*ent.handles)
                ent.handles = None
                produced += self._first_token(psched, req, tok)
                if req.finished:
                    if tok is not None:
                        self.handoffs.incr("finished_at_prefill")
                    q.popleft()
                    continue
            n = len(req.block_table)
            dst = sched._try_alloc(n) if sched.has_free_slot else None
            if dst is None:
                self.handoffs.incr("deferred")
                break
            # read after write: the copy waits for the last chunk
            self.engine.wait_event(ent.event)
            try:
                self.engine.copy_blocks_from(
                    self.prefill_engine, list(zip(req.block_table, dst)))
            except OOM_ERRORS:
                sched.allocator.free(dst)
                self._note_oom("handoff")
                break
            finally:
                # write after read: released prefill blocks may be
                # rewritten by the prefill stream's next launch, which
                # waits for what the copy read (a torn copy read some)
                self.prefill_engine.wait_event(self.engine.record_event())
            psched.release_handoff(req)
            sched.admit_handoff(req, dst)
            self.handoffs.incr("requests")
            self.handoffs.incr("blocks", n)
            q.popleft()
        return produced

    # -- the offload tier -----------------------------------------------------

    def _cache_home(self) -> DecodeEngine:
        """The engine whose pool holds the prefix cache: the prefill
        engine under disaggregation, else the engine."""
        return self.prefill_engine if self.disagg else self.engine

    def _offload_ingest(self, meta: dict, payload: dict) -> dict:
        """The receiving half of an offload promote: import the
        checksummed payload into the blocks the sender reserved, in the
        cache home's pool, on its engine's stream.  Under disaggregation
        that stream already waits for every hand-off copy that read the
        blocks a hand-off freed (``_process_handoffs`` orders it before
        the release), so the import, like a chunk, writes only after the
        decode stream's read.  A torn payload raises ``ValueError``
        natively: the transport reports it to the sender un-retried and
        caches nothing."""
        blocks = [int(b) for b in meta["blocks"]]
        self._cache_home().import_blocks(blocks, payload)
        return {"blocks": len(blocks)}

    def _note_token(self, req: Request) -> None:
        """Stamp the first-token edge of ``req``'s timeline, or the gap
        since its previous token."""
        now = self.clock()
        if req.first_token_at is None and req.generated:
            req.first_token_at = now
        elif req.last_token_at is not None:
            req.itl_gaps.append(now - req.last_token_at)
        req.last_token_at = now
        # every applied token comes through here: the streams' publish
        if self.stream_broker is not None:
            self.stream_broker.publish(req.uid, len(req.generated) - 1,
                                       req.generated[-1])

    def _finalize_finished(self) -> None:
        """Stamp ``finished_at`` on every request finished since the last
        call (retired, failed or turned away at submit), once each."""
        fin = self.scheduler.finished
        while self._finalized < len(fin):
            req = fin[self._finalized]
            self._finalized += 1
            if req.finished_at is None:
                req.finished_at = self.clock()
            if self.admission is not None:
                self.admission.observe(req)
            # the terminal event: delivery backfills any token the
            # bounded queue dropped
            if self.stream_broker is not None:
                self.stream_broker.finish(req.uid, req.finish_reason or "")

    def _decode_inputs(self, running):
        engine = self.engine
        b, mb = engine.max_batch_size, engine.blocks_per_seq
        tokens = np.zeros((b,), np.int64)
        positions = np.zeros((b,), np.int64)
        tables = np.zeros((b, mb), np.int64)
        for req in running:
            tokens[req.slot] = req.next_input
            positions[req.slot] = req.num_cached
            tables[req.slot, :len(req.block_table)] = req.block_table
        return tokens, positions, tables

    def _decode_step(self, running) -> int:
        """One batched decode step over ``running``, materialized and
        applied in the same call (the synchronous loop; with a custom
        ``sample_fn`` through the logits step and the host sampler).
        Returns the tokens produced."""
        tokens, positions, tables = self._decode_inputs(running)
        host = self.sample_fn is not greedy_sample
        samp = None if host else self.scheduler.sampling_inputs(running)
        kw = {"sampling": samp} if samp is not None else {}
        try:
            if host:
                logits = self.engine.decode(tokens, positions,
                                            tables).cpu().numpy()
            else:
                ids, fin = self.engine.decode_sampled(tokens, positions,
                                                      tables, **kw)
                ids, fin = ids.cpu().numpy(), fin.cpu().numpy()
        except OOM_ERRORS:
            # no request state moved: the same decode runs next step
            self._note_oom("decode")
            return 0
        self.decode_steps += 1
        if host:
            ids = self.sample_fn(logits)
            fin = np.all(np.isfinite(logits), axis=-1)
        return self._apply_decode_results(running, ids, fin)

    def _launch_decode(self, running) -> bool:
        """The pipelined decode launch: enqueue the sampled step, start
        its ids and finite flags on their way to the host and hold
        ``running`` as the in-flight window; the results retire next
        step.  False when the launch OOMed (skipped and retried, as in
        the synchronous loop)."""
        sched = self.scheduler
        tokens, positions, tables = self._decode_inputs(running)
        samp = sched.sampling_inputs(running)
        kw = {"sampling": samp} if samp is not None else {}
        try:
            ids, fin = self.engine.decode_sampled(tokens, positions, tables,
                                                  **kw)
        except OOM_ERRORS:
            self._note_oom("decode")
            return False
        self.decode_steps += 1
        (ids, fin), event = self.engine.to_host_async(ids, fin)
        self._inflight = _InflightStep("decode", list(running), ids, fin,
                                       event, self.clock())
        sched.hold_inflight(running)
        self.pipe.incr("launches")
        return True

    def _apply_decode_results(self, running, toks, finite,
                              now: Optional[float] = None) -> int:
        """Apply one decode step's (B,) host ids and finite flags to
        ``running``: the retire half of both loops.  ``now`` backdates
        a breaker failure to the launch clock (the pipelined retire sees
        it a step late).  A False flag fails that request before its
        token counts.  Returns the tokens produced."""
        sched = self.scheduler
        produced = 0
        for req in running:
            if req.finished or not req.running:
                continue        # failed between launch and retire
            if not finite[req.slot]:
                sched.fail(req, reasons.NONFINITE)
                if self.breaker is not None:
                    self.breaker.record_failure(now)
                continue
            req.num_cached += 1
            req.record_token(int(toks[req.slot]))
            self._note_token(req)
            produced += 1
            if req.finished:
                sched.retire(req)
                if self.breaker is not None:
                    self.breaker.record_success()
            else:
                # index a block this token just filled
                sched.register_progress(req)
        self.spec.incr("decode_tokens", produced)
        return produced

    # -- speculative decoding ----------------------------------------------

    def _propose_drafts(self, running) -> Dict[int, List[int]]:
        """uid -> drafted tokens this iteration: the draft source's
        guesses, capped by the request's remaining budget, cut at the
        first out-of-vocabulary id, and trimmed to the lookahead blocks
        the scheduler grants without preempting."""
        sched = self.scheduler
        vocab = self.engine.cfg.vocab_size
        drafts: Dict[int, List[int]] = {}
        for req in running:
            budget = min(self.spec_tokens,
                         req.max_new_tokens - len(req.generated) - 1)
            if budget < 1:
                continue
            d = list(self.draft_source.propose(
                req.prompt + req.generated, budget))[:budget]
            for i, t in enumerate(d):
                if not 0 <= int(t) < vocab:
                    d = d[:i]
                    break
            if not d:
                continue
            fit = sched.lookahead_capacity(req, 1 + len(d))
            d = d[:fit - 1]
            if d:
                drafts[req.uid] = d
        return drafts

    def _verify_inputs(self, running, drafts):
        """(tokens, lengths, positions, tables): every slot's pending
        token and its drafts (none = a one-token column), zero-padded to
        ``spec_tokens + 1`` columns."""
        engine = self.engine
        kw = self.spec_tokens + 1
        b, mb = engine.max_batch_size, engine.blocks_per_seq
        tokens = np.zeros((b, kw), np.int64)
        lengths = np.zeros((b,), np.int64)
        positions = np.zeros((b,), np.int64)
        tables = np.zeros((b, mb), np.int64)
        for req in running:
            d = drafts.get(req.uid, ())
            n = 1 + len(d)
            tokens[req.slot, 0] = req.next_input
            tokens[req.slot, 1:n] = d
            lengths[req.slot] = n
            positions[req.slot] = req.num_cached
            tables[req.slot, :len(req.block_table)] = req.block_table
        return tokens, lengths, positions, tables

    def _verify_step(self, running, drafts) -> int:
        """One verify step over the whole running batch, materialized
        and applied in the same call (the synchronous loop): each slot
        feeds its pending token and its drafts; acceptance keeps, a
        slot, the longest draft prefix equal to the model's own tokens
        plus the model's next token; rejected lookahead is rolled
        back."""
        tokens, lengths, positions, tables = self._verify_inputs(running,
                                                                 drafts)
        samp = self.scheduler.sampling_inputs(running)
        kw = {"sampling": samp} if samp is not None else {}
        try:
            ids, fin = self.engine.verify_sampled(tokens, lengths, positions,
                                                  tables, **kw)
            ids, fin = ids.cpu().numpy(), fin.cpu().numpy()
        except OOM_ERRORS:
            self._verify_oom(running)
            return 0
        self.verify_steps += 1
        return self._apply_verify_results(running, drafts, lengths, ids, fin)

    def _launch_verify(self, running, drafts) -> bool:
        """The pipelined verify launch: :meth:`_launch_decode`'s twin,
        keeping the drafts and lengths for acceptance at retire.  False
        when the launch OOMed: the lookahead grown for it is rolled back
        and the same verify (drafts are functions of request history)
        runs next step."""
        sched = self.scheduler
        tokens, lengths, positions, tables = self._verify_inputs(running,
                                                                 drafts)
        samp = sched.sampling_inputs(running)
        kw = {"sampling": samp} if samp is not None else {}
        try:
            ids, fin = self.engine.verify_sampled(tokens, lengths, positions,
                                                  tables, **kw)
        except OOM_ERRORS:
            self._verify_oom(running)
            return False
        self.verify_steps += 1
        (ids, fin), event = self.engine.to_host_async(ids, fin)
        self._inflight = _InflightStep("verify", list(running), ids, fin,
                                       event, self.clock(), drafts=drafts,
                                       lengths=lengths)
        sched.hold_inflight(running)
        self.pipe.incr("launches")
        return True

    def _verify_oom(self, running) -> None:
        """A verify call OOMed: no request state moved; the lookahead
        blocks grown for it go back, so the skipped step holds no extra
        pool space."""
        self._note_oom("verify")
        for req in running:
            if req.running:
                self.scheduler.rollback_lookahead(req)

    def _apply_verify_results(self, running, drafts, lengths, row_toks,
                              finite, now: Optional[float] = None) -> int:
        """Acceptance over one verify step's (B, K) host tokens and
        finite flags: the retire half of both loops (``now`` as in
        :meth:`_apply_decode_results`).  Returns the tokens produced."""
        sched = self.scheduler
        produced = 0
        for req in running:
            if req.finished or not req.running:
                continue        # failed between launch and retire
            n = int(lengths[req.slot])
            if not np.all(finite[req.slot, :n]):
                sched.fail(req, reasons.NONFINITE)
                if self.breaker is not None:
                    self.breaker.record_failure(now)
                continue
            toks = row_toks[req.slot]
            d = drafts.get(req.uid, ())
            req.num_cached += 1        # the pending token's K/V landed
            accepted = 0
            for j, guess in enumerate(d):
                if int(guess) != int(toks[j]):
                    break              # the model disagrees: reject the rest
                req.record_token(int(guess))
                self._note_token(req)
                produced += 1
                req.num_cached += 1    # its verify-written K/V is valid
                accepted += 1
                if req.finished:
                    break
            resampled = False
            if not req.finished:
                # the model's own next token after the last accepted one
                # (under sampling, the residual resample of a rejection);
                # its K/V is not written yet: it becomes the pending token
                resampled = accepted < len(d)
                req.record_token(int(toks[accepted]))
                self._note_token(req)
                produced += 1
            if d:
                req.spec_drafted += len(d)
                req.spec_accepted += accepted
                self.spec.incr("drafted_tokens", len(d))
                self.spec.incr("accepted_tokens", accepted)
                self.spec_drafted_depths.append(len(d))
                self.spec_accepted_depths.append(accepted)
                if not req.sampling.is_greedy:
                    self.spec.incr("stoch_drafted_tokens", len(d))
                    self.spec.incr("stoch_accepted_tokens", accepted)
                    if resampled:
                        self.spec.incr("stoch_resamples")
            if req.finished:
                sched.retire(req)
                if self.breaker is not None:
                    self.breaker.record_success()
            else:
                sched.register_progress(req)
                sched.rollback_lookahead(req)
        self.spec.incr("decode_tokens", produced)
        return produced

    def _flush_window(self) -> int:
        """RETIRE: wait for the in-flight step's ids and finite flags
        (timed into ``host_stall_ms``), release the hold before any
        request state moves, and apply them.  A no-op with no window.
        Returns the tokens produced."""
        inf = self._inflight
        if inf is None:
            return 0
        self._inflight = None
        t0 = self.clock()
        if inf.event is not None:
            inf.event.synchronize()
        toks, finite = inf.ids.numpy(), inf.finite.numpy()
        self.retire_wait.append(self.clock() - t0)
        # the step's K/V writes landed: the window's pin lifts first
        self.scheduler.release_inflight()
        self.pipe.incr("retired_behind")
        if inf.kind == "decode":
            return self._apply_decode_results(inf.running, toks, finite,
                                              now=inf.launched_at)
        return self._apply_verify_results(inf.running, inf.drafts,
                                          inf.lengths, toks, finite,
                                          now=inf.launched_at)

    def _note_oom(self, site: str) -> None:
        """Count one transient engine OOM at ``site``: the call was
        skipped (nothing moved) and retries next step; the breaker
        counts it as a failure, so a sustained burst trips fast
        rejection at the front door."""
        self.oom.incr(site)
        if self.breaker is not None:
            self.breaker.record_failure()

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int,
                 eos_id: Optional[int] = None, *,
                 priority: int = 0,
                 deadline_iters: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 sampling: Union[SamplingParams,
                                 Sequence[Optional[SamplingParams]],
                                 None] = None) -> List[List[int]]:
        """Generate completions for ``prompts`` (token-id lists); returns
        the generated ids per prompt, in input order.  ``sampling``: one
        :class:`SamplingParams` for every prompt, or one a prompt (None
        entries greedy).  A request that fails contributes whatever it
        generated before failing."""
        if sampling is None or isinstance(sampling, SamplingParams):
            per_prompt = [sampling] * len(prompts)
        else:
            per_prompt = list(sampling)
            if len(per_prompt) != len(prompts):
                raise ValueError(
                    f"sampling sequence length {len(per_prompt)} != "
                    f"{len(prompts)} prompts")
        reqs = [self.submit(p, max_new_tokens, eos_id, priority=priority,
                            deadline_iters=deadline_iters,
                            deadline_s=deadline_s, sampling=s)
                for p, s in zip(prompts, per_prompt)]
        while self.has_work:
            self.step()
        return [list(r.generated) for r in reqs]

    # -- the lifecycle ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def closed(self) -> bool:
        return self._closed

    def begin_drain(self) -> None:
        """Stop admissions (later submits finish ``"draining"``) and
        leave the running work to the caller's steps.  Idempotent."""
        self._draining = True

    def end_drain(self) -> None:
        """Reopen admissions after :meth:`begin_drain`; a closed server
        cannot reopen."""
        if self._closed:
            raise RuntimeError("cannot end_drain a closed server")
        self._draining = False

    def drain(self) -> dict:
        """Stop admissions and run every live request to a terminal
        state; the work computes as it would undisturbed, so its tokens
        are the same.  Returns :meth:`stats`."""
        self.begin_drain()
        while self.has_work:
            self.step()
        self._account_pending_produced()
        self._finalize_finished()
        return self.stats()

    def close(self) -> dict:
        """:meth:`drain`, then refuse further submissions and close the
        KV transport.  The drain runs once; later calls return the same
        stats snapshot."""
        if self._closed:
            return self._final_stats
        self._final_stats = self.drain()
        self._closed = True
        self.kv_transport.close()
        return self._final_stats

    def cancel(self, uid: int) -> bool:
        """Cancel one live request by uid: it finishes
        ``"cancelled"`` and frees its slot and blocks at once (a queued
        one leaves the queue).  False if the uid is unknown or already
        finished.  A launched step is retired first, so no step still in
        flight writes through the blocks the cancel frees (the retire
        may itself finish the request)."""
        if self._inflight is not None:
            self._pending_produced += self._flush_window()
        cancelled = False
        for sched in self._schedulers():
            for req in list(sched.running.values()) + list(sched.waiting):
                if req.uid == uid and not req.finished:
                    sched.fail(req, reasons.CANCELLED)
                    cancelled = True
                    break
            if cancelled:
                break
        self._finalize_finished()
        return cancelled

    def audit(self) -> None:
        """The scheduler, allocator and prefix-cache invariants
        (:meth:`Scheduler.audit`), of both pools under disaggregation;
        raises :class:`AssertionError`."""
        for sched in self._schedulers():
            sched.audit()

    # -- streaming ----------------------------------------------------------

    def _find_request(self, uid: int) -> Optional[Request]:
        """The live or finished request with ``uid``, or None."""
        for sched in self._schedulers():
            for req in [*sched.running.values(), *sched.waiting]:
                if req.uid == uid:
                    return req
        for req in self.scheduler.finished:
            if req.uid == uid:
                return req
        return None

    def stream(self, req_or_uid, callback: Optional[Callable] = None
               ) -> TokenStream:
        """The per-token delivery stream of a submitted request (a
        :class:`Request` or its uid).  Iterate it (``for tok in
        server.stream(uid)``, from another thread while this one steps),
        poll it (``drain()``, ``take(timeout=)``), or pass ``callback``
        for ``callback("token", tok)`` at each retired token and one
        ``callback("end", finish_reason)``.  A stream opened late
        backfills what was generated already.  Raises
        :class:`RuntimeError` with ``enable_streaming=False`` and
        :class:`KeyError` for an unknown uid."""
        if self.stream_broker is None:
            raise RuntimeError(
                "streaming is disabled (enable_streaming=False)")
        if isinstance(req_or_uid, Request):
            req = req_or_uid
        else:
            req = self._find_request(int(req_or_uid))
            if req is None:
                raise KeyError(f"no request with uid {req_or_uid} on this "
                               f"server")
        return self.stream_broker.open(req.uid, req, callback)

    # -- meters -----------------------------------------------------------

    def _account_pending_produced(self) -> None:
        """Count tokens retired outside a step (a ``submit`` or
        ``cancel`` that retired the window) that no later step took
        up."""
        self.tokens_generated += self._pending_produced
        self._pending_produced = 0

    def reset_meters(self) -> None:
        """Zero the counters (after warm-up, before a timed window).  A
        window still in flight keeps its tokens: they count when it
        retires."""
        self.tokens_generated = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.verify_steps = 0
        self.sampling_requests = {}
        self.spec = CounterMeter()
        self.spec_drafted_depths: List[int] = []
        self.spec_accepted_depths: List[int] = []
        self.prefix = CounterMeter()
        if self.prefix_cache is not None:
            self.prefix_cache.counters = self.prefix
        self.pipe = CounterMeter()
        self.oom = CounterMeter()
        # the offload tier's counters and exact promote seconds (with
        # offload off too: stats() keeps its shape)
        self.offload = CounterMeter()
        self.offload_promote: List[float] = []
        if self.offload_store is not None:
            self.offload_store.counters = self.offload
            self.prefix_cache.offload_counters = self.offload
            self.prefix_cache.promote_samples = self.offload_promote
        self.handoffs = CounterMeter()
        ours = self.breaker is not None \
            and self.breaker.counters is self.breaker_events
        self.breaker_events = CounterMeter()
        if ours:
            self.breaker.counters = self.breaker_events
        # exact samples, seconds: the retire's wait on the card and the
        # host's planning and launching time of a pipelined step
        self.retire_wait: List[float] = []
        self.plan_time: List[float] = []
        self.queue_depth.reset()
        self.occupancy.reset()
        self.chunk_iters.reset()
        self.pressure_gauge.reset()
        self.handoff_pending.reset()
        self.scheduler.finished.clear()
        self.scheduler.failures.clear()
        self._finalized = 0
        self._launches_at_reset = launch_counts()
        self._started = time.perf_counter()

    def stats(self) -> dict:
        """Serving counters since :meth:`reset_meters`.  ``kernel_launches``
        are the CUDA kernels' launches since then, by kernel, counted
        process-wide (a second server in the same process adds to them):
        ``2 * L + 1`` LayerNorm launches per prefill, per chunk, per
        verify and per decode step, ``L`` flash launches per (monolithic)
        prefill and ``L`` decode-attention launches per decode step —
        ``decode_attention`` (B7) on the full-width pool,
        ``decode_attention_q8`` (B8) on the int8 one; a verify step runs
        neither; 0 on the CPU.  ``prefills`` counts monolithic prefills,
        ``prefill_chunks`` chunk launches, ``chunk_iters_peak`` the most
        chunks one step ran, ``decode_steps`` / ``verify_steps`` the two
        kinds of batched step.  ``speculation`` and
        ``sampling["rejection"]`` are the reference's blocks (no
        ``verify_compiles``: eager PyTorch traces nothing); the
        ``prefix_*`` and ``kv_blocks_*`` keys appear with the prefix
        cache.  ``memory`` is the pool: its geometry and bytes
        (:meth:`DecodeEngine.memory_info`) and the allocator's free,
        live, evictable and peak blocks.  ``breaker_state`` (or
        ``"disabled"``), ``breaker_events`` and ``oom_events`` are the
        failure containment's; ``pipeline`` the dispatch-ahead window:
        its launches and retires, whether one is pending, and
        ``host_stall_ms`` (the retire's wait on the card) and
        ``host_plan_ms`` (the host's planning and launching a step), each
        ``{count, p50, p90, p99, max}`` over the exact samples.
        ``disagg`` is ``{"enabled": False}`` on a monolithic server,
        else the prefill pool's blocks and the hand-off counters
        (``memory`` is then the decode pool's, with no evictable holds:
        the prefix cache lives in the prefill pool); ``streams`` the
        broker's counters and open streams, and the cancellations;
        ``offload`` the offload tier's (:meth:`_offload_stats`) and
        ``transport`` the KV transport's envelope counters, totals and a
        row a peer, with each peer's breaker state."""
        sched = self.scheduler
        self._account_pending_produced()
        self._finalize_finished()
        elapsed = max(time.perf_counter() - self._started, 1e-9)
        now = launch_counts()
        launches = {name: n - self._launches_at_reset.get(name, 0)
                    for name, n in now.items()}
        spec = self.spec
        out = {
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": self.tokens_generated / elapsed,
            "queue_depth_peak": self.queue_depth.peak,
            "batch_occupancy_avg": round(self.occupancy.avg, 3),
            "requests_finished": len(sched.finished),
            "requests_failed": dict(sched.failures),
            "requests_failed_total": sum(sched.failures.values()),
            "preemptions": sum(r.preemptions for r in sched.finished),
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "chunk_iters_peak": int(self.chunk_iters.peak),
            "decode_steps": self.decode_steps,
            "verify_steps": self.verify_steps,
            "pressure": round(self.pressure_gauge.val, 3),
            "pressure_peak": round(self.pressure_gauge.peak, 3),
            "breaker_state": (self.breaker.state if self.breaker is not None
                              else "disabled"),
            "breaker_events": self.breaker_events.as_dict(),
            "oom_events": self.oom.total,
            "draining": self._draining,
            "speculation": {
                "enabled": self.speculating,
                "spec_tokens": self.spec_tokens,
                "drafted_tokens": spec.count("drafted_tokens"),
                "accepted_tokens": spec.count("accepted_tokens"),
                "acceptance_rate": round(spec.ratio(
                    "accepted_tokens", "drafted_tokens"), 3),
                "verify_steps": self.verify_steps,
                "decode_steps": self.decode_steps,
                "decode_tokens": spec.count("decode_tokens"),
                "tokens_per_engine_step": round(
                    spec.count("decode_tokens")
                    / max(1, self.verify_steps + self.decode_steps), 3),
                "drafted_per_step": _depths(self.spec_drafted_depths),
                "accepted_per_step": _depths(self.spec_accepted_depths),
            },
            "sampling": {
                "requests": dict(self.sampling_requests),
                "custom_sample_fn": self.sample_fn is not greedy_sample,
                "rejection": {
                    "drafted_tokens": spec.count("stoch_drafted_tokens"),
                    "accepted_tokens": spec.count("stoch_accepted_tokens"),
                    "acceptance_rate": round(spec.ratio(
                        "stoch_accepted_tokens",
                        "stoch_drafted_tokens"), 3),
                    "resamples": spec.count("stoch_resamples"),
                },
            },
            "pipeline": {
                "enabled": self.pipelining,
                "depth": 1 if self.pipelining else 0,
                "launches": self.pipe.count("launches"),
                "retired_behind": self.pipe.count("retired_behind"),
                "pending": 1 if self._inflight is not None else 0,
                "host_stall_ms": _hist_ms(self.retire_wait),
                "host_plan_ms": _hist_ms(self.plan_time),
            },
            "admission": (self.admission.as_stats()
                          if self.admission is not None
                          else {"enabled": False}),
            "kv_blocks_free": self.engine.allocator.num_free,
            "kernel_launches": launches,
            "memory": self._memory_stats(),
            "disagg": self._disagg_stats(),
            "streams": self._stream_stats(),
            "offload": self._offload_stats(),
            "transport": self.kv_transport.stats(),
        }
        if self.prefix_cache is not None:
            pre = self.prefix
            out.update({
                "prefix_hit_tokens": pre.count("prefix_hit_tokens"),
                "prefix_miss_tokens": pre.count("prefix_miss_tokens"),
                "prefix_hit_requests": pre.count("prefix_hit_requests"),
                "prefix_hit_rate": round(pre.ratio(
                    "prefix_hit_tokens",
                    "prefix_hit_tokens", "prefix_miss_tokens"), 3),
                "prefix_evicted_blocks": pre.count("prefix_evicted_blocks"),
                "prefix_cow_blocks": pre.count("prefix_cow_blocks"),
                "kv_blocks_cached": self.prefix_cache.num_cached_blocks,
                "kv_blocks_evictable": self.prefix_cache.num_evictable,
            })
        return out

    def _memory_stats(self) -> dict:
        info = self.engine.memory_info()
        alloc = self.engine.allocator
        # under disaggregation the cache's holds are the prefill pool's
        cache = None if self.disagg else self.prefix_cache
        return {
            "blocks_usable": info["blocks_usable"],
            "blocks_free": alloc.num_free,
            "blocks_live": alloc.num_live,
            "blocks_live_peak": alloc.live_peak,
            "blocks_evictable": cache.num_evictable if cache else 0,
            "blocks_evictable_peak": cache.evictable_peak if cache else 0,
            "lookahead_granted_blocks": self.scheduler.lookahead_granted,
            "lookahead_rolled_back_blocks":
                self.scheduler.lookahead_rolled_back,
            **{key: info[key] for key in (
                "pool_bytes", "pool_bytes_per_device", "bytes_per_block",
                "cache_dtype", "quantize", "compute_dtype")},
        }

    def _disagg_stats(self) -> dict:
        """The ``stats()["disagg"]`` block: the prefill pool's blocks and
        the hand-off counters (``requests``, ``blocks``, ``deferred``,
        ``finished_at_prefill``, as they occur)."""
        if not self.disagg:
            return {"enabled": False}
        palloc = self.prefill_engine.allocator
        info = self.prefill_engine.memory_info()
        evictable = (self.prefix_cache.num_evictable
                     if self.prefix_cache is not None else 0)
        return {
            "enabled": True,
            "prefill_max_concurrent": self.prefill_scheduler.max_batch_size,
            "prefill_blocks_usable": info["blocks_usable"],
            "prefill_blocks_free": palloc.num_free,
            "prefill_blocks_live": palloc.num_live,
            "prefill_blocks_live_peak": palloc.live_peak,
            "prefill_blocks_evictable": evictable,
            "prefill_evictable_bytes": evictable * info["bytes_per_block"],
            "prefill_pool_bytes": info["pool_bytes"],
            "prefill_backlog_blocks":
                self.prefill_scheduler.prefill_backlog_blocks(),
            "handoff": {"pending": len(self._handoff),
                        "pending_peak": int(self.handoff_pending.peak),
                        **self.handoffs.as_dict()},
            "sink_attached": False,
        }

    def _offload_stats(self) -> dict:
        """The ``stats()["offload"]`` block: the demote, promote (by the
        tier it came from), spill and reject counters, the store's tier
        occupancy and ``promote_ms`` (``{count, p50, p90, p99, max}`` over
        the exact samples); every key present, zero, with offload
        off."""
        c = self.offload.count
        store = self.offload_store
        on = store is not None
        return {
            "enabled": self.kv_offload,
            **{key: c(key) for key in (
                "demotes", "demote_failed", "promotes_host",
                "promotes_disk", "spills", "crc_rejects", "disk_torn",
                "capacity_skips", "transport_skips", "host_dropped")},
            "host_entries": store.host_entries if on else 0,
            "host_bytes": store.host_used_bytes if on else 0,
            "host_bytes_cap": store.host_bytes if on else 0,
            "disk_entries": store.disk_entries if on else 0,
            "spill_dir": store.spill_dir if on else None,
            "promote_ms": _hist_ms(self.offload_promote),
        }

    def _stream_stats(self) -> dict:
        """The ``stats()["streams"]`` block: the broker's counters and
        open streams, and the cancellations (with streaming off too)."""
        out = {"enabled": self.stream_broker is not None,
               "cancelled": self.scheduler.failures.get(reasons.CANCELLED,
                                                        0)}
        if self.stream_broker is not None:
            out.update(self.stream_broker.stats())
            out["per_stream"] = self.stream_broker.snapshot()
        return out
