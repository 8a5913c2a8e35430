"""apex_tpu_torch.resilience — fault containment for serving.

- :class:`CircuitBreaker` (:mod:`resilience.breaker`) — closed → open
  → half-open failure containment in front of admission; the serving
  front door uses it to fast-reject (``finish_reason="breaker_open"``)
  while the engine is demonstrably sick, and the KV transport keeps one
  a peer;
- :func:`retry` / :class:`RetryError` (:mod:`resilience.retry`) —
  bounded retry with decorrelated jitter, the KV transport's envelope.

Twin of ``apex_tpu/resilience/__init__.py`` with the breaker and retry
only; the fault plans, training sentry and chaos schedules are not
ported yet.
"""

from apex_tpu_torch.resilience.breaker import CircuitBreaker
from apex_tpu_torch.resilience.retry import RetryError, retry

__all__ = ["CircuitBreaker", "RetryError", "retry"]
