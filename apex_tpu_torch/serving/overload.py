"""Overload policy: who gets shed, and when, under serving pressure.

Twin of ``apex_tpu/serving/overload.py``.  Requests carry a priority
class (``Request.priority``, nice-style: 0 is the foreground default,
larger is lower) and a cost estimate (``Request.cost_blocks``, the KV
blocks of prompt + budget, stamped at submit).  The scheduler's
``pressure`` is the max of the queue fill fraction and ``(live blocks
+ queued demand + prefill backlog) / usable blocks``; it may exceed 1.

- queue-full **displacement**: an arrival that outranks the worst
  queued request displaces it (the victim finishes ``"shed"``); one
  that outranks nobody is rejected as before;
- pressure **shedding**: each step, while pressure is at or above
  ``shed_threshold``, best-effort waiting work is shed worst-first
  (highest priority number, newest first); priority 0 never is;
- priority-aware **preemption**: the victim is the worst priority,
  then the youngest admitted (uniform priorities: youngest-first);
- predictive **admission** (off by default):
  :class:`AdmissionEstimator` sheds at submit a wall-deadlined arrival
  that even the fastest service ever observed for its class could not
  finish in time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["OverloadPolicy", "AdmissionEstimator"]


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Thresholds of the shed / displace / preempt decisions.

    ``shed_threshold``: pressure at or above which best-effort waiting
    work is shed each step.  ``best_effort_priority``: the class from
    which work is sheddable.  ``displace``: whether queue-full arrivals
    may displace lower-priority queued work.  ``predictive_admission``
    arms submit-time shedding of provably deadline-doomed work, trusted
    after ``admission_min_history`` observations a class, comparing
    ``admission_margin`` times the fastest observed service."""

    shed_threshold: float = 0.9
    best_effort_priority: int = 1
    displace: bool = True
    predictive_admission: bool = False
    admission_min_history: int = 8
    admission_margin: float = 1.0

    def __post_init__(self):
        if self.shed_threshold <= 0:
            raise ValueError(
                f"shed_threshold must be > 0, got {self.shed_threshold}")
        if self.best_effort_priority < 1:
            raise ValueError(
                "best_effort_priority must be >= 1 (priority 0 is the "
                f"never-shed default class), got "
                f"{self.best_effort_priority}")
        if self.admission_min_history < 1:
            raise ValueError(
                f"admission_min_history must be >= 1, got "
                f"{self.admission_min_history}")
        if self.admission_margin < 1.0:
            raise ValueError(
                "admission_margin must be >= 1.0 (below the "
                "fastest-observed bound the shed is no longer "
                f"provable), got {self.admission_margin}")

    def sheddable(self, priority: int) -> bool:
        return priority >= self.best_effort_priority

    @staticmethod
    def slo_debt_tokens(req) -> int:
        """The unearned remainder of a shed victim's token budget."""
        return max(0, req.max_new_tokens - len(req.generated))


class _ClassTrack:
    """Fastest-observed service profile of one priority class."""

    __slots__ = ("observed", "min_ttft_s", "min_decode_token_s")

    def __init__(self):
        self.observed = 0
        self.min_ttft_s: Optional[float] = None
        self.min_decode_token_s: Optional[float] = None


class AdmissionEstimator:
    """Per-priority service-rate learner behind predictive admission.

    Folds in finished requests' :meth:`Request.timeline` (only those
    that produced a first token) and keeps, a class, the FASTEST
    submit-to-first-token and per-token decode times.  :meth:`doomed`
    is True only when even that best case misses the arrival's
    ``deadline_s``: with ``eos_id`` set, or too little history, only
    the first-token bound applies; without a wall deadline nothing is
    predicted.
    """

    def __init__(self, *, min_history: int = 8, margin: float = 1.0):
        self.min_history = int(min_history)
        self.margin = float(margin)
        self._tracks: Dict[int, _ClassTrack] = {}
        self.predicted_sheds = 0

    def observe(self, req) -> None:
        """Fold one finished request's timeline into its class."""
        tl = req.timeline()
        ttft = tl.get("ttft_s")
        if ttft is None:
            return
        tr = self._tracks.setdefault(req.priority, _ClassTrack())
        tr.observed += 1
        if tr.min_ttft_s is None or ttft < tr.min_ttft_s:
            tr.min_ttft_s = ttft
        dec = tl.get("decode_token_s")
        if dec is not None and (tr.min_decode_token_s is None
                                or dec < tr.min_decode_token_s):
            tr.min_decode_token_s = dec

    def doomed(self, req) -> bool:
        """True iff ``req`` provably cannot meet its wall deadline."""
        if req.deadline_s is None:
            return False
        tr = self._tracks.get(req.priority)
        if tr is None or tr.observed < self.min_history \
                or tr.min_ttft_s is None:
            return False
        best = tr.min_ttft_s
        if req.eos_id is None and req.max_new_tokens > 1 \
                and tr.min_decode_token_s is not None:
            best = best + (req.max_new_tokens - 1) * tr.min_decode_token_s
        if best * self.margin > req.deadline_s:
            self.predicted_sheds += 1
            return True
        return False

    def as_stats(self) -> dict:
        """The ``stats()["admission"]`` block."""
        return {
            "enabled": True,
            "min_history": self.min_history,
            "margin": self.margin,
            "predicted_sheds": self.predicted_sheds,
            "by_priority": {
                p: {"observed": tr.observed,
                    "min_ttft_s": tr.min_ttft_s,
                    "min_decode_token_s": tr.min_decode_token_s}
                for p, tr in sorted(self._tracks.items())},
        }
