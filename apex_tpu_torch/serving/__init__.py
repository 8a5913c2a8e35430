"""apex_tpu_torch.serving — batched GPT inference: paged KV cache and
continuous batching.

- :mod:`serving.kv_cache` — the block pool (a dict of tensors updated in
  place; full width or int8 with a scale sidecar) and the host-side
  refcounted allocator;
- :mod:`serving.engine` — bucketed prefill through the flash kernel,
  chunked prefill and speculative verify over the cached context,
  batched single-token decode through the decode-attention kernel,
  block copies and the checksummed block export/import, greedy or
  stochastic sampling on the device;
- :mod:`serving.prefix_cache` — the block-level prefix index (shared
  full blocks, evictable holds, copy-on-write at whole-context hits) and
  its offload tier's demote and promote;
- :mod:`serving.offload` — the host-RAM and disk store behind it
  (:class:`OffloadStore`, :func:`resolve_kv_offload`);
- :mod:`serving.transport` — the KV transport the promote rides
  (in-process or loopback TCP, under a retry/deadline/breaker envelope
  with exactly-once ingest);
- :mod:`serving.speculation` — draft proposers (:class:`NgramDraft`);
- :mod:`serving.overload` — the shed / displace / preempt policy;
- :mod:`serving.reasons` — the finish-reason vocabulary;
- :mod:`serving.streaming` — per-token delivery (:class:`StreamBroker`,
  :class:`TokenStream`);
- :mod:`serving.scheduler` / :mod:`serving.api` — iteration-level
  continuous batching with chunked prefill, prefix sharing, speculative
  lookahead, overload shedding, priority-aware preemption and the
  in-flight hold, and the :class:`InferenceServer` front door
  (``SamplingParams``, priority and deadlines a request; drain, cancel,
  close and ``stream``): a pipelined (dispatch-ahead) loop by default,
  the circuit breaker (:mod:`apex_tpu_torch.resilience`), the
  transient-OOM retry, and disaggregated prefill/decode on one host
  (``enable_disagg``: a prefill pool on a CUDA stream of its own), and
  hierarchical KV offload (``enable_kv_offload``).
"""

from apex_tpu_torch.ops.sampling import SamplingParams
from apex_tpu_torch.serving.api import InferenceServer, greedy_sample
from apex_tpu_torch.serving.engine import (
    DecodeEngine,
    default_prefill_buckets,
    pick_bucket,
)
from apex_tpu_torch.serving.kv_cache import (
    KV_QUANT_ENV,
    BlockAllocator,
    KVCacheConfig,
    gather_scales,
    init_kv_cache,
    resolve_cache_dtype,
    resolve_kv_quant,
)
from apex_tpu_torch.serving.offload import OffloadStore, resolve_kv_offload
from apex_tpu_torch.serving.overload import OverloadPolicy
from apex_tpu_torch.serving.prefix_cache import PrefixCache
from apex_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler
from apex_tpu_torch.serving.speculation import DraftSource, NgramDraft

__all__ = [
    "KV_QUANT_ENV",
    "BlockAllocator",
    "DecodeEngine",
    "DraftSource",
    "InferenceServer",
    "KVCacheConfig",
    "NgramDraft",
    "OffloadStore",
    "OverloadPolicy",
    "PrefixCache",
    "QueueFullError",
    "Request",
    "SamplingParams",
    "Scheduler",
    "default_prefill_buckets",
    "gather_scales",
    "greedy_sample",
    "init_kv_cache",
    "pick_bucket",
    "resolve_cache_dtype",
    "resolve_kv_offload",
    "resolve_kv_quant",
]
