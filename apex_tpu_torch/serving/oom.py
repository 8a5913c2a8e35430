"""The transient out-of-memory errors the serving stack degrades on.

The reference catches ``MemoryError``; the CUDA caching allocator raises
``torch.OutOfMemoryError``, which is a ``RuntimeError`` and not a
``MemoryError``.  Every place that skips, retries or reports an OOM
catches :data:`OOM_ERRORS`: the serve loop (``serving.api``), the prefix
cache's offload tier (a promote's import, a demote's export) and the KV
transport (an application rejection, carried natively over the socket
backend).  A module of its own, so each of them imports it without a
cycle.
"""

import torch

OOM_ERRORS = (MemoryError, torch.OutOfMemoryError)
