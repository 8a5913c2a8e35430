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
- :mod:`serving.scheduler` / :mod:`serving.api` — iteration-level
  continuous batching with chunked prefill and preempt-youngest on pool
  pressure, and the synchronous :class:`InferenceServer` front door
  (``SamplingParams`` a request).
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
from apex_tpu_torch.serving.scheduler import QueueFullError, Request, Scheduler

__all__ = [
    "KV_QUANT_ENV",
    "BlockAllocator",
    "DecodeEngine",
    "InferenceServer",
    "KVCacheConfig",
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
    "resolve_kv_quant",
]
