"""Bounded retry with decorrelated jitter.

Twin of ``apex_tpu/resilience/retry.py`` (host only: ``random``,
``time``, ``typing``).  A caller that talks to a flaky medium — the KV
transport's wire (:mod:`apex_tpu_torch.serving.transport`) — retries
transient errors with *decorrelated jitter* (each delay drawn uniformly
from ``[base, 3 * previous]``, capped), which avoids the synchronized
retry stampede that fixed exponential backoff gives a fleet of hosts.

Everything is injectable — ``sleep``, ``clock``, ``rng`` — and the
default rng is seeded, so tests replay the same delays with no real
sleeping.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryError", "retry"]


class RetryError(OSError):
    """All attempts (or the deadline) exhausted; ``__cause__`` is the
    last underlying error."""


def retry(
    fn: Callable,
    *,
    attempts: int = 4,
    backoff: float = 0.05,
    max_backoff: float = 2.0,
    deadline: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn()`` up to ``attempts`` times, sleeping decorrelated-jitter
    delays between failures; give up early once ``deadline`` seconds of
    wall budget would be exceeded.

    Args:
      fn: zero-arg callable (wrap args in a lambda/partial).
      attempts: total tries, including the first (must be >= 1).
      backoff: base delay in seconds; also the jitter floor.
      max_backoff: per-delay cap.
      deadline: total wall-clock budget across all attempts; the next
        sleep is skipped (and :class:`RetryError` raised) when it would
        overrun the budget.
      retry_on: exception types that count as transient; anything else
        propagates immediately.
      sleep/clock/rng: injectables for deterministic tests.  The default
        rng is ``random.Random(0)`` per call — deterministic, and
        independent of the global random state.
      on_retry: ``(attempt_index, error)`` callback before each sleep —
        the hook failure counters attach to.

    Returns ``fn()``'s value; raises :class:`RetryError` (chained to the
    last error) when the budget is spent.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    rng = rng if rng is not None else random.Random(0)
    start = clock()
    delay = float(backoff)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as err:
            last = err
            if attempt == attempts - 1:
                break
            # decorrelated jitter: uniform over [base, 3 * previous]
            delay = min(max_backoff,
                        rng.uniform(backoff, max(backoff, delay * 3.0)))
            if deadline is not None and \
                    (clock() - start) + delay > deadline:
                raise RetryError(
                    f"retry deadline {deadline}s exhausted after "
                    f"{attempt + 1} attempts") from err
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(delay)
    raise RetryError(
        f"all {attempts} attempts failed; last error: "
        f"{type(last).__name__}: {last}") from last
