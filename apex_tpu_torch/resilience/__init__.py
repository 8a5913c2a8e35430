"""apex_tpu_torch.resilience — fault containment for serving.

- :class:`CircuitBreaker` (:mod:`resilience.breaker`) — closed → open
  → half-open failure containment in front of admission; the serving
  front door uses it to fast-reject (``finish_reason="breaker_open"``)
  while the engine is demonstrably sick.

Twin of ``apex_tpu/resilience/__init__.py`` with the breaker only; the
fault plans, retry, training sentry and chaos schedules are not ported
yet.
"""

from apex_tpu_torch.resilience.breaker import CircuitBreaker

__all__ = ["CircuitBreaker"]
