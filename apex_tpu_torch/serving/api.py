"""The synchronous continuous-batching server.

Twin of ``apex_tpu/serving/api.py::InferenceServer`` run with the
subsystems this slice leaves out turned off — no prefix cache,
speculation, pipelined loop, overload control, breaker, streaming,
program accounting or mesh.  Each :meth:`step` admits what fits,
advances every prefilling request by ONE chunk (``prefill_chunk``
tokens, the default; the whole prompt through the bucketed flash
prefill with ``enable_chunked_prefill=False``), samples the first token
from a prompt's last chunk, then runs one batched decode step over the
rest of the running batch and retires requests on ``max_new_tokens`` or
``eos_id``.  Chunks interleave with decode, so a long prompt stalls the
running batch by one chunk at a time.  Sampling happens on the device
(the engine's ``*_sampled`` steps): greedy, or a request's
:class:`ops.SamplingParams` (temperature, top-k, top-p, counter-keyed by
its seed), so only token ids and finite flags cross to the host.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch._kernels.build import launch_counts
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.ops.sampling import SamplingParams
from apex_tpu_torch.serving import reasons
from apex_tpu_torch.serving.engine import DecodeEngine
from apex_tpu_torch.serving.kv_cache import KV_QUANT_ENV
from apex_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler

# the reference's default prefill chunk, capped at max_context
DEFAULT_PREFILL_CHUNK = 256


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
    """Peak and running mean of a level sampled once per step."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.peak = self.sum = 0.0
        self.count = 0

    def update(self, val: float):
        self.peak = max(self.peak, float(val))
        self.sum += float(val)
        self.count += 1

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class InferenceServer:
    """Batched GPT inference with a paged KV cache and continuous
    batching.

    Args (all but the last three pass to :class:`DecodeEngine`):
      cfg, params: the architecture and its ``state_dict``.
      device: ``"cuda"`` (default) or ``"cpu"``.
      max_batch_size, max_context, num_blocks, block_size, cache_dtype:
        see :class:`DecodeEngine` (flash prefill, chunk attention,
        cached-attention decode).
      kv_quant: ``"int8"`` serves from the quantized pool (decode on
        kernel B8); ``"off"`` pins the full-width pool; None defers to
        the ``APEX_TPU_KV_QUANT`` environment variable (unset: off).
        A kwarg that is given wins over the environment.
      max_waiting: bound on the waiting queue; a submit past it comes
        back already finished with ``finish_reason="rejected"``.
      enable_chunked_prefill: prefill in chunks of ``prefill_chunk``
        tokens (default on, as the reference); False prefills each
        prompt whole through the bucketed flash prefill.
      prefill_chunk: the chunk, default ``min(256, max_context)``.

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
                 max_waiting: Optional[int] = None,
                 enable_chunked_prefill: bool = True,
                 prefill_chunk: Optional[int] = None):
        if kv_quant is None:
            kv_quant = os.environ.get(KV_QUANT_ENV)
        self.engine = DecodeEngine(
            cfg, params, device=device, max_batch_size=max_batch_size,
            max_context=max_context, num_blocks=num_blocks,
            block_size=block_size, cache_dtype=cache_dtype,
            kv_quant=kv_quant)
        self.prefill_chunk = None
        if enable_chunked_prefill:
            self.prefill_chunk = int(
                prefill_chunk if prefill_chunk is not None
                else min(DEFAULT_PREFILL_CHUNK, self.engine.max_context))
        self.scheduler = Scheduler(
            self.engine.allocator,
            max_batch_size=self.engine.max_batch_size,
            block_size=self.engine.block_size,
            max_context=self.engine.max_context,
            max_waiting=max_waiting, chunk_size=self.prefill_chunk)
        self.queue_depth = _Gauge()
        self.occupancy = _Gauge()
        self.chunk_iters = _Gauge()
        self.reset_meters()

    # -- request lifecycle ------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None, *,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Enqueue one request.  ``max_new_tokens`` must be >= 1; a prompt
        leaving no room to generate within ``max_context`` raises
        :class:`ValueError`, and a budget overshooting the remaining
        context is capped to fit.  ``sampling``: a
        :class:`SamplingParams` (None = greedy); anything else raises
        :class:`TypeError`.  A full waiting queue returns the request
        already finished with ``finish_reason="rejected"``."""
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
                      eos_id=eos_id,
                      sampling=sampling if sampling is not None
                      else SamplingParams())
        klass = req.sampling.klass
        self.sampling_requests[klass] = \
            self.sampling_requests.get(klass, 0) + 1
        try:
            self.scheduler.submit(req)
        except QueueFullError:
            req.finished = True
            req.finish_reason = reasons.REJECTED
            self.scheduler.finished.append(req)
            self.scheduler.failures[reasons.REJECTED] = \
                self.scheduler.failures.get(reasons.REJECTED, 0) + 1
        return req

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self) -> int:
        """One continuous-batching iteration: admit, advance every
        prefilling request by one chunk (sampling its first token from
        the last), then one decode step across the rest of the running
        batch.  Returns the number of tokens produced.  A request whose
        logits go non-finite, or that outgrows the pool with nothing left
        to preempt, fails alone."""
        sched, engine = self.scheduler, self.engine
        produced = chunks = 0
        sched.admit()
        for req in [r for r in sched._admit_order if r.prefilling]:
            tokens, start, is_last = sched.prefill_plan(req)
            # only a fresh prompt's last chunk samples a token
            samp = (sched.prefill_sampling(req)
                    if is_last and req.prefill_sample else None)
            if self.prefill_chunk is None:     # the whole context at once
                ids, fin = engine.prefill_sampled(tokens, req.block_table,
                                                  sampling=samp)
                self.prefills += 1
            else:
                ids, fin = engine.chunk_prefill_sampled(
                    tokens, start, req.block_table,
                    pad_to=self.prefill_chunk, sampling=samp)
                chunks += 1
            if not sched.chunk_done(req, len(tokens)) \
                    or not req.prefill_sample:
                continue    # mid-prefill, or a resumed request's pending
                            # token continues
            if not bool(fin[0]):
                sched.fail(req, reasons.NONFINITE)
                continue
            req.record_token(int(ids[0]))
            produced += 1
            if req.finished:
                sched.retire(req)
        self.chunk_iters.update(chunks)
        self.prefill_chunks += chunks

        if sched.running:
            for req in list(sched.running.values()):
                if req.running and not req.prefilling \
                        and not sched.ensure_decode_capacity(req):
                    sched.fail(req, reasons.CAPACITY)
            running = [r for r in sched.running.values() if not r.prefilling]
            if running:
                produced += self._decode_step(running)

        self.tokens_generated += produced
        self.queue_depth.update(sched.num_waiting)
        self.occupancy.update(sched.num_running / engine.max_batch_size)
        return produced

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
        sched = self.scheduler
        ids, fin = self.engine.decode_sampled(
            *self._decode_inputs(running),
            sampling=sched.sampling_inputs(running))
        self.decode_steps += 1
        ids, fin = ids.cpu().numpy(), fin.cpu().numpy()
        produced = 0
        for req in running:
            if not fin[req.slot]:
                sched.fail(req, reasons.NONFINITE)
                continue
            req.num_cached += 1
            req.record_token(int(ids[req.slot]))
            produced += 1
            if req.finished:
                sched.retire(req)
        return produced

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int,
                 eos_id: Optional[int] = None, *,
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
        reqs = [self.submit(p, max_new_tokens, eos_id, sampling=s)
                for p, s in zip(prompts, per_prompt)]
        while self.has_work:
            self.step()
        return [list(r.generated) for r in reqs]

    # -- meters -----------------------------------------------------------

    def reset_meters(self) -> None:
        """Zero the counters (after warm-up, before a timed window)."""
        self.tokens_generated = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.sampling_requests = {}
        self.queue_depth.reset()
        self.occupancy.reset()
        self.chunk_iters.reset()
        self.scheduler.finished.clear()
        self.scheduler.failures.clear()
        self._launches_at_reset = launch_counts()
        self._started = time.perf_counter()

    def stats(self) -> dict:
        """Serving counters since :meth:`reset_meters`.  ``kernel_launches``
        are the CUDA kernels' launches since then, by kernel, counted
        process-wide (a second server in the same process adds to them):
        ``2 * L + 1`` LayerNorm launches per prefill, per chunk and per
        decode step, ``L`` flash launches per (monolithic) prefill and
        ``L`` decode-attention launches per decode step —
        ``decode_attention`` (B7) on the full-width pool,
        ``decode_attention_q8`` (B8) on the int8 one; 0 on the CPU.
        ``prefills`` counts monolithic prefills, ``prefill_chunks`` chunk
        launches, ``chunk_iters_peak`` the most chunks one step ran, and
        ``sampling["requests"]`` the submitted requests by
        :attr:`SamplingParams.klass`.  ``memory`` is the pool: its
        geometry and bytes (:meth:`DecodeEngine.memory_info`) and the
        allocator's free, live and peak live blocks."""
        sched = self.scheduler
        elapsed = max(time.perf_counter() - self._started, 1e-9)
        now = launch_counts()
        launches = {name: n - self._launches_at_reset.get(name, 0)
                    for name, n in now.items()}
        return {
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": self.tokens_generated / elapsed,
            "queue_depth_peak": self.queue_depth.peak,
            "batch_occupancy_avg": round(self.occupancy.avg, 3),
            "requests_finished": len(sched.finished),
            "requests_failed": dict(sched.failures),
            "preemptions": sum(r.preemptions for r in sched.finished),
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "chunk_iters_peak": int(self.chunk_iters.peak),
            "decode_steps": self.decode_steps,
            "sampling": {"requests": dict(self.sampling_requests)},
            "kv_blocks_free": self.engine.allocator.num_free,
            "kernel_launches": launches,
            "memory": self._memory_stats(),
        }

    def _memory_stats(self) -> dict:
        info = self.engine.memory_info()
        alloc = self.engine.allocator
        return {
            "blocks_usable": info["blocks_usable"],
            "blocks_free": alloc.num_free,
            "blocks_live": alloc.num_live,
            "blocks_live_peak": alloc.live_peak,
            **{key: info[key] for key in (
                "pool_bytes", "pool_bytes_per_device", "bytes_per_block",
                "cache_dtype", "quantize", "compute_dtype")},
        }
