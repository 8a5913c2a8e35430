"""Meters: twins of ``apex_tpu/utils/meters.py``'s ``AverageMeter``
(reference ``examples/imagenet/main_amp.py:445-460``) and
``CounterMeter`` (without its metrics-registry backing)."""

from __future__ import annotations


class AverageMeter:
    """Tracks the latest value and the running (weighted) average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class CounterMeter:
    """Monotonic named counters (serving: prefix-cache hits and misses,
    speculation tallies).  ``incr`` only counts up, so a later snapshot
    always dominates an earlier one."""

    def __init__(self):
        self._counts = {}

    def incr(self, key: str, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"CounterMeter is monotonic; incr({key!r}, "
                             f"{n}) would decrease it")
        self._counts[key] = self._counts.get(key, 0) + int(n)
        return self._counts[key]

    def count(self, key: str) -> int:
        return self._counts.get(key, 0)

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    def ratio(self, num: str, *parts: str) -> float:
        """``count(num) / sum(count(p) for p in parts)``, 0.0 over an
        empty denominator (``ratio("hits", "hits", "misses")``)."""
        den = sum(self.count(p) for p in parts)
        return self.count(num) / den if den else 0.0

    def as_dict(self) -> dict:
        """Snapshot ordered by key."""
        return {k: self._counts[k] for k in sorted(self._counts)}
