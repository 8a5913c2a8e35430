"""Circuit breaker — fail fast while the backend is demonstrably sick.

Twin of ``apex_tpu/resilience/breaker.py`` (host only: ``random``,
``time``, ``typing``).  A serving front door that keeps admitting work
into a failing engine converts one fault into thousands: every admitted
request burns queue slots, KV blocks and client patience before failing
anyway.  The standard containment (Nygard's *Release It!* pattern) is a
three-state machine in front of admission:

- **closed** (healthy): requests flow; consecutive failures are
  counted, successes reset the streak.  ``failure_threshold``
  consecutive failures trip the breaker.
- **open** (tripped): every request is rejected immediately.  After
  ``recovery_time`` seconds (on the injectable ``clock``) the breaker
  moves to half-open.
- **half-open** (probing): up to ``probe_quota`` requests are let
  through as canaries.  ``probe_successes`` successes close the
  breaker; any failure re-opens it and restarts the cooldown.

The breaker knows nothing about serving: callers ask :meth:`allow`
before admitting work and report outcomes with :meth:`record_success` /
:meth:`record_failure`.  ``serving.InferenceServer`` wires it in front
of ``submit`` (rejections finish with ``finish_reason="breaker_open"``)
and feeds it non-finite-logits and engine-OOM events as failures,
healthy completions as successes.

Everything is deterministic and injectable: the clock is a parameter
(tests drive transitions without sleeping) and ``counters`` (a
:class:`apex_tpu_torch.utils.meters.CounterMeter`) records every
transition and rejection for ``stats()`` reconciliation.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Three-state failure containment (see module docstring).

    Args:
      failure_threshold: consecutive failures (no success between)
        that trip closed -> open.  Must be >= 1.
      recovery_time: seconds the breaker stays open before probing
        (measured on ``clock``).
      probe_successes: consecutive half-open successes required to
        close.  Must be >= 1.
      probe_quota: how many half-open probes may be admitted per
        episode before further :meth:`allow` calls are rejected while
        the probes resolve (default: ``probe_successes``).
      half_open_backoff: optional cap (seconds) for a decaying probe
        cadence.  A half-open probe failure normally restarts the
        SAME ``recovery_time`` cooldown, so a flapping replica gets
        probed at a fixed interval forever; with a cap set, each
        half-open re-trip grows the effective cooldown by
        decorrelated jitter (``uniform(recovery_time, cooldown * 3)``
        clamped to the cap)
        and any close resets it to ``recovery_time``.  ``None``
        (default) keeps the legacy fixed cadence byte-identical.
      rng: jitter source for ``half_open_backoff`` — injectable so
        tests (and seeded soaks) get deterministic decay; default
        ``random.Random(0)``.
      clock: monotonic-seconds source — injectable so tests drive the
        open -> half-open transition without sleeping.
      counters: optional :class:`apex_tpu_torch.utils.meters.CounterMeter`; gets
        ``breaker_opened`` / ``breaker_half_open`` / ``breaker_closed``
        transition counts and ``breaker_rejections``.
    """

    def __init__(self, *, failure_threshold: int = 5,
                 recovery_time: float = 30.0,
                 probe_successes: int = 1,
                 probe_quota: Optional[int] = None,
                 half_open_backoff: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 counters=None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if recovery_time < 0:
            raise ValueError(
                f"recovery_time must be >= 0, got {recovery_time}")
        if probe_successes < 1:
            raise ValueError(
                f"probe_successes must be >= 1, got {probe_successes}")
        if half_open_backoff is not None \
                and half_open_backoff < recovery_time:
            raise ValueError(
                f"half_open_backoff cap {half_open_backoff} must be >= "
                f"recovery_time {recovery_time}")
        self.failure_threshold = failure_threshold
        self.recovery_time = float(recovery_time)
        self.probe_successes = probe_successes
        self.probe_quota = (probe_quota if probe_quota is not None
                            else probe_successes)
        self.half_open_backoff = (None if half_open_backoff is None
                                  else float(half_open_backoff))
        self._rng = rng if rng is not None else random.Random(0)
        # effective open -> half-open cooldown; grows under
        # half_open_backoff, always == recovery_time without it
        self._cooldown = float(recovery_time)
        self.clock = clock
        self.counters = counters
        self._state = CLOSED
        self._streak = 0            # consecutive failures while closed
        self._opened_at = 0.0
        self._probes_out = 0        # half-open admissions this episode
        self._probe_ok = 0          # half-open successes this episode
        # lifetime transition tallies, kept breaker-side so callers
        # without a CounterMeter (the router's per-replica breakers)
        # still get them from state_snapshot()
        self._transitions = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}

    # -- state ------------------------------------------------------------

    @property
    def state(self) -> str:
        """Current state, advancing open -> half-open when the
        cooldown has elapsed (reading the state IS the probe timer)."""
        if self._state == OPEN and \
                self.clock() - self._opened_at >= self._cooldown:
            self._transition(HALF_OPEN)
            self._probes_out = 0
            self._probe_ok = 0
        return self._state

    _TRANSITION_KEYS = {CLOSED: "breaker_closed",
                        OPEN: "breaker_opened",
                        HALF_OPEN: "breaker_half_open"}

    def _transition(self, state: str) -> None:
        self._state = state
        self._transitions[state] += 1
        if self.counters is not None:
            self.counters.incr(self._TRANSITION_KEYS[state])

    def _trip(self, now: "float | None" = None) -> None:
        reopened = self._state == HALF_OPEN
        self._opened_at = self.clock() if now is None else now
        self._streak = 0
        if self.half_open_backoff is not None:
            if reopened:
                # flapping: decorrelated jitter decays the probe cadence toward the cap
                self._cooldown = min(
                    self.half_open_backoff,
                    self._rng.uniform(
                        self.recovery_time,
                        max(self.recovery_time, self._cooldown * 3.0)))
            else:
                self._cooldown = self.recovery_time
        self._transition(OPEN)

    # -- the caller-facing protocol ---------------------------------------

    def allow(self) -> bool:
        """May one more unit of work be admitted right now?  False is
        the fast rejection; callers must still report the admitted
        work's outcome via :meth:`record_success` /
        :meth:`record_failure`."""
        state = self.state
        if state == CLOSED:
            return True
        if state == HALF_OPEN and self._probes_out < self.probe_quota:
            self._probes_out += 1
            return True
        if self.counters is not None:
            self.counters.incr("breaker_rejections")
        return False

    def record_success(self) -> None:
        """One admitted unit of work completed healthily."""
        if self._state == HALF_OPEN:
            self._probe_ok += 1
            if self._probe_ok >= self.probe_successes:
                self._streak = 0
                self._cooldown = self.recovery_time
                self._transition(CLOSED)
        else:
            self._streak = 0

    def record_failure(self, now: "float | None" = None) -> None:
        """One admitted unit of work failed (non-finite logits, engine
        OOM, ...).  A half-open probe failure re-opens immediately —
        the backend is still sick, restart the cooldown.

        ``now`` optionally backdates the trip's cooldown anchor to
        when the failure actually HAPPENED rather than when it was
        observed — the pipelined serve loop observes a device-side
        failure one iteration after launching it, and anchoring the
        recovery window at launch time keeps the breaker's trajectory
        identical to the synchronous loop's."""
        if self._state == HALF_OPEN:
            self._trip(now)
            return
        if self._state == CLOSED:
            self._streak += 1
            if self._streak >= self.failure_threshold:
                self._trip(now)

    def state_snapshot(self) -> dict:
        """The breaker's full observable state as one JSON-safe dict —
        state (advanced through any due open -> half-open transition),
        the closed-state failure streak, the half-open probe budget
        and how much of it is out/succeeded, and lifetime transition
        counts.  This is how composite owners (the serving router's
        per-replica breakers) surface breaker health in their
        ``stats()`` without reaching into privates."""
        return {
            "state": self.state,
            "failure_streak": self._streak,
            "failure_threshold": self.failure_threshold,
            "probes_out": self._probes_out,
            "probe_ok": self._probe_ok,
            "probe_quota": self.probe_quota,
            "recovery_time": self.recovery_time,
            "current_backoff": self._cooldown,
            "transitions": {
                "opened": self._transitions[OPEN],
                "half_open": self._transitions[HALF_OPEN],
                "closed": self._transitions[CLOSED],
            },
        }

    def reset(self) -> None:
        """Force-close (operator override / between test cases)."""
        self._state = CLOSED
        self._streak = 0
        self._probes_out = 0
        self._probe_ok = 0
        self._cooldown = self.recovery_time
