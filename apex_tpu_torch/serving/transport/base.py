"""KV transport: the robustness envelope around block movement.

Twin of ``apex_tpu/serving/transport/base.py`` (host only).  The tiers
that move KV blocks between pools — in this package the offload promote
(:mod:`serving.offload`) — used to call the checksummed
``export_blocks``/``import_blocks`` pair directly.  That path rejects a
torn payload whole but has no deadline, no retry policy, no duplicate
suppression and no fault model beyond corruption; a real socket adds
connection resets, stalls, duplicated delivery and reordering.
:class:`KVTransport` is that path as an interface with interchangeable
backends:

- :class:`~apex_tpu_torch.serving.transport.InProcessTransport` — the
  direct call, the same bytes and schedule as the historical path; the
  default everywhere.
- :class:`~apex_tpu_torch.serving.transport.SocketTransport` —
  length-prefixed crc-framed payloads over a loopback TCP stream with a
  stdlib server thread.

Both backends run under the same :class:`TransportPolicy` envelope:

- **per-transfer deadline** — a send is bounded by ``policy.deadline_s``
  of (injected) clock across all attempts;
- **bounded retry with decorrelated jitter** — transport failures
  (:class:`TransportConnectionError`) retry through
  :func:`apex_tpu_torch.resilience.retry.retry`; the receiving
  handler's rejections (``ValueError`` for a torn payload, an
  :data:`~apex_tpu_torch.serving.oom.OOM_ERRORS` member for a full pool
  or a card OOM) are NOT retried: they re-raise natively, so every
  consumer's degradation path (cold prefill, put the payloads back)
  fires unchanged, and the peer's breaker records a success;
- **per-peer circuit breaker** — a dead endpoint fast-fails new sends
  (:class:`~apex_tpu_torch.resilience.CircuitBreaker`) instead of
  burning the whole retry budget a transfer;
- **exactly-once ingest** — each send carries a monotonic transfer id;
  the receiver keeps a bounded :class:`ReceiverLedger` of completed
  transfers, so a duplicated delivery (or a retry whose first attempt
  DID land) returns the cached ack instead of importing twice.

The exactly-once argument: the ledger records a transfer id only after
its handler returned.  A transfer that failed before the handler ran
leaves no entry, so its retry imports normally; a transfer whose ack was
lost finds its entry on retry and returns the recorded ack without
running the handler.  The ledger is bounded (``policy.dedup_window``),
which is sound because transfer ids are monotonic and retries bounded:
a duplicate arrives within ``policy.attempts`` sends of the original.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from apex_tpu_torch.resilience.breaker import CircuitBreaker
from apex_tpu_torch.resilience.retry import RetryError, retry
from apex_tpu_torch.serving.oom import OOM_ERRORS

__all__ = [
    "KVTransport",
    "ReceiverLedger",
    "TransportConnectionError",
    "TransportError",
    "TransportFrameError",
    "TransportPolicy",
    "TransportTimeoutError",
]

# the handler's rejections: answered, not retried, the peer healthy
APPLICATION_ERRORS = (ValueError,) + OOM_ERRORS


class TransportError(RuntimeError):
    """A transfer failed at the TRANSPORT level (never an application
    rejection: those re-raise natively, a ``ValueError`` or an
    :data:`OOM_ERRORS` member, so consumer degradation paths stay
    unchanged)."""


class TransportConnectionError(TransportError):
    """Connection-class failure: refused, reset mid-frame, closed
    before the ack.  Retried by the policy envelope."""


class TransportTimeoutError(TransportError):
    """The transfer stalled past its deadline.  NOT retried: the
    deadline already bounds the whole send; the consumer degrades."""


class TransportFrameError(TransportError):
    """A malformed wire frame: bad magic, oversized, crc mismatch.  The
    receiving side closes the connection without ingesting anything
    (torn frames are rejected whole, like torn payloads)."""


@dataclass
class TransportPolicy:
    """The robustness envelope both backends run under.  Everything
    time-like is injectable (``clock``/``sleep``/``rng``), so tests
    replay the same schedule with no real sleeping, as
    :func:`~apex_tpu_torch.resilience.retry.retry` does."""

    deadline_s: float = 5.0        # total wall budget a send
    attempts: int = 3              # tries a send, the first included
    backoff: float = 0.01          # decorrelated-jitter base delay
    max_backoff: float = 0.25      # per-delay cap
    breaker_failures: int = 3      # consecutive failures to open
    breaker_recovery_s: float = 30.0
    dedup_window: int = 256        # receiver ledger entries a peer
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep
    rng: Optional[random.Random] = None   # default: seeded a transport


class ReceiverLedger:
    """Bounded memory of completed transfers, the receiver half of
    exactly-once.  Records ``tid -> ack`` only for transfers whose
    handler SUCCEEDED; a duplicate of a recorded tid is answered from
    the ledger (``dedup_hits``) without running the handler again."""

    def __init__(self, window: int):
        self.window = max(1, int(window))
        self._acks: "OrderedDict[int, Any]" = OrderedDict()
        self.dedup_hits = 0

    def lookup(self, tid: int):
        """``(hit, ack)``; a hit counts toward ``dedup_hits``."""
        if tid in self._acks:
            self.dedup_hits += 1
            return True, self._acks[tid]
        return False, None

    def record(self, tid: int, ack) -> None:
        self._acks[tid] = ack
        while len(self._acks) > self.window:
            self._acks.popitem(last=False)

    def __len__(self) -> int:
        return len(self._acks)


_PEER_COUNTER_KEYS = (
    "attempts", "retries", "delivered", "rejects", "failures",
    "deadline_exceeded", "breaker_fastfail", "ingested")


@dataclass
class _PeerState:
    """Everything the envelope tracks a registered peer."""

    name: str
    handler: Optional[Callable[[dict, dict], Any]]
    breaker: CircuitBreaker
    ledger: ReceiverLedger
    address: Optional[tuple] = None      # the socket backend's routes
    counters: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for k in _PEER_COUNTER_KEYS:
            self.counters.setdefault(k, 0)


class KVTransport:
    """The backend-agnostic half: the peer registry, the transfer-id
    counter, the retry/deadline/breaker envelope and the exactly-once
    receiver.  Subclasses implement :meth:`_deliver` (move one payload
    to the peer and return its ack).

    ``chaos`` is the fault-injection seam: an object whose
    ``plan_send(peer)`` returns None or a plan with ``before(payload)``
    (at the top of every attempt: may raise, or return a corrupted
    copy) and ``after(redeliver)`` (after a delivery: may deliver the
    same transfer id again, or raise as if the ack were lost).  ``None``
    (the default) costs nothing and draws no random numbers.
    """

    backend = "abstract"
    # whether meta may carry objects that do not serialize; only the
    # in-process backend can
    carries_objects = False

    def __init__(self, policy: Optional[TransportPolicy] = None):
        self.policy = policy or TransportPolicy()
        # guards the peer registry, ledgers and counters against the
        # socket backend's server threads; an RLock because _dispatch
        # -> _ingest nests
        self._lock = threading.RLock()
        self._peers: Dict[str, _PeerState] = {}
        self._next_tid = 0
        # retry jitter: seeded a transport, independent of the global
        # random state (the retry convention)
        self._rng = self.policy.rng if self.policy.rng is not None \
            else random.Random(0)
        self.chaos = None

    def _peer_state(self, name, handler=None, address=None) -> _PeerState:
        pol = self.policy
        return _PeerState(
            name=name, handler=handler,
            breaker=CircuitBreaker(
                failure_threshold=pol.breaker_failures,
                recovery_time=pol.breaker_recovery_s, clock=pol.clock),
            ledger=ReceiverLedger(pol.dedup_window), address=address)

    # -- registry ----------------------------------------------------------

    def register_peer(self, name: str,
                      handler: Callable[[dict, dict], Any]) -> None:
        """Register a locally served peer: ``handler(meta, payload)``
        ingests one transfer and returns its ack.  Handler exceptions are
        the application's: they reach the sender natively and are never
        cached in the dedup ledger."""
        with self._lock:
            self._peers[name] = self._peer_state(name, handler)

    def peers(self):
        with self._lock:
            return sorted(self._peers)

    # -- the send envelope -------------------------------------------------

    def send(self, peer: str, meta: dict, payload: dict):
        """Move one checksummed payload to ``peer`` under the policy
        envelope; returns the peer handler's ack.

        Raises :class:`TransportError` subclasses for transport failures
        (after retries, the deadline or the breaker), and re-raises the
        handler's ``ValueError`` or OOM (:data:`OOM_ERRORS`) natively, so
        the consumer's torn-payload and at-capacity paths cannot tell
        this from a direct call."""
        with self._lock:
            st = self._peers.get(peer)
            if st is None:
                raise TransportError(
                    f"unknown transport peer {peer!r} "
                    f"(registered: {sorted(self._peers)})")
            tid = self._next_tid
            self._next_tid += 1
        if not st.breaker.allow():
            with self._lock:
                st.counters["breaker_fastfail"] += 1
                st.counters["failures"] += 1
            raise TransportConnectionError(
                f"peer {peer!r} circuit open — transfer {tid} "
                f"fast-failed (degrade, don't wait)")
        plan = self.chaos.plan_send(peer) if self.chaos is not None \
            else None
        pol = self.policy

        def _attempt():
            with self._lock:
                st.counters["attempts"] += 1
            p = payload
            if plan is not None:
                p = plan.before(p)       # may raise or corrupt a copy
            ack = self._deliver(st, tid, meta, p)
            if plan is not None:
                plan.after(lambda: self._deliver(st, tid, meta, payload))
            return ack

        def _on_retry(attempt, err):
            with self._lock:
                st.counters["retries"] += 1

        try:
            ack = retry(_attempt,
                        attempts=pol.attempts,
                        backoff=pol.backoff,
                        max_backoff=pol.max_backoff,
                        deadline=pol.deadline_s,
                        retry_on=(TransportConnectionError,),
                        sleep=pol.sleep, clock=pol.clock,
                        rng=self._rng, on_retry=_on_retry)
        except APPLICATION_ERRORS:
            # the peer answered, so it is HEALTHY: the payload (or the
            # room for it) is the problem
            st.breaker.record_success()
            with self._lock:
                st.counters["rejects"] += 1
            raise
        except TransportTimeoutError:
            st.breaker.record_failure()
            with self._lock:
                st.counters["deadline_exceeded"] += 1
                st.counters["failures"] += 1
            raise
        except RetryError as e:
            st.breaker.record_failure()
            with self._lock:
                st.counters["failures"] += 1
            raise TransportConnectionError(
                f"transfer {tid} to {peer!r} failed: {e}") from e
        except TransportError:
            st.breaker.record_failure()
            with self._lock:
                st.counters["failures"] += 1
            raise
        st.breaker.record_success()
        with self._lock:
            st.counters["delivered"] += 1
        return ack

    # -- the receive side --------------------------------------------------

    def _ingest(self, st: _PeerState, tid: int, meta: dict,
                payload: dict):
        """Exactly-once ingest: answer duplicates from the ledger, else
        run the handler and record its ack.  Handler exceptions are NOT
        recorded: the transfer did not happen, so its retry imports for
        real."""
        with self._lock:
            hit, cached = st.ledger.lookup(tid)
            if hit:
                return cached
            if st.handler is None:
                raise TransportError(
                    f"peer {st.name!r} has no local handler")
            ack = st.handler(meta, payload)
            st.counters["ingested"] += 1
            st.ledger.record(tid, ack)
            return ack

    def _deliver(self, st: _PeerState, tid: int, meta: dict,
                 payload: dict):
        raise NotImplementedError

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The pinned ``stats()["transport"]`` shape: aggregate counters
        and a per-peer table with the breaker's state.  The key set does
        not depend on what happened."""
        with self._lock:
            totals = {k: 0 for k in _PEER_COUNTER_KEYS}
            totals["dedup_hits"] = 0
            per_peer = {}
            for name, st in sorted(self._peers.items()):
                row = dict(st.counters)
                row["dedup_hits"] = st.ledger.dedup_hits
                row["breaker"] = st.breaker.state
                per_peer[name] = row
                for k in _PEER_COUNTER_KEYS:
                    totals[k] += st.counters[k]
                totals["dedup_hits"] += st.ledger.dedup_hits
            out = {"backend": self.backend, "peers": len(per_peer)}
            out.update(totals)
            out["per_peer"] = per_peer
            return out

    def close(self) -> None:
        """Release backend resources (the socket backend's server
        thread); the in-process backend has none."""
