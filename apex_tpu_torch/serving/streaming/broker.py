"""StreamBroker — retire-time token fan-out to bounded per-request
queues.

Twin of ``apex_tpu/serving/streaming/broker.py``, copied: host-only
threading code, no device work.

Threading model: ``publish()``/``finish()`` run on the serve thread
(inside ``step()``, at the point each retired token is applied);
``open()``/``drain()``/``take()``/``close()`` run on consumer threads
(client iterators).  Everything serializes through ONE ``RLock``
(``broker.lock``) with a condition variable for blocking readers, so a
blocked consumer can never hold up the step loop, and the step loop's
publish is a bounded O(1) append.

Delivery indices, not just tokens, ride the queue: ``publish`` dedups
``index < already-published`` (a moved request regenerates its prefix
bit-identically and is republished), and a reader seeing ``index >
delivered`` backfills the gap straight from the request's own
``generated`` list (the backpressure-drop case).  Both rules together
give the acceptance invariant: the delivered stream is always a
byte-identical prefix of the non-streaming output, bounded queue or
not.
"""

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class TokenStream:
    """One request's delivery surface.  Created via
    :meth:`StreamBroker.open`; shares the broker's lock/condition.

    ``source`` duck-types a live request: ``.generated`` (the
    append-only token list — the backfill authority), ``.finished``,
    and ``.finish_reason``; :class:`~serving.scheduler.Request`
    qualifies.
    """

    def __init__(self, broker: "StreamBroker", key: int, source: Any,
                 callback: Optional[Callable[[str, Any], None]] = None):
        self.key = key
        self.lock = broker.lock          # shared: one lock, one cond
        self._broker = broker
        self._cond = broker._cond
        self._source = source
        self._callback = callback
        self._q: deque = deque()         # (index, token), bounded
        self._delivered = 0              # tokens handed to the consumer
        self._published = 0              # high-water publish index + 1
        self._terminal: Optional[str] = None   # published, undelivered
        self.finish_reason: Optional[str] = None  # delivered terminal
        self.drops = 0                   # this stream's overflow count
        self.closed = False

    # -- consumer surface (foreign threads; every path locks) ---------------

    @property
    def done(self) -> bool:
        """True once the terminal event has been delivered — at that
        point every token has been too (terminal delivery backfills)."""
        return self.finish_reason is not None

    def drain(self) -> List[int]:
        """Non-blocking: every token available now, in order (queued +
        gap backfill), absorbing the terminal if published."""
        with self.lock:
            return self._drain_locked()

    def take(self, timeout: Optional[float] = None) -> List[int]:
        """Block until at least one token or the terminal is
        deliverable (or ``timeout`` elapses); returns possibly-empty
        list — check :attr:`finish_reason` / :attr:`done` after."""
        with self.lock:
            got = self._drain_locked()
            if got or self.done:
                return got
            self._cond.wait(timeout)
            return self._drain_locked()

    def __iter__(self):
        """Yield tokens until the terminal event; blocking (bounded
        per-wait by the broker's ``iter_wait_s`` so an abandoned
        producer can't hang a consumer forever)."""
        while True:
            toks = self.take(timeout=self._broker.iter_wait_s)
            for tok in toks:
                yield tok
            if self.done:
                return

    def close(self) -> None:
        """Detach the consumer: the broker stops publishing to this
        stream and forgets it.  Idempotent; does NOT cancel the
        request (the server owns cancellation)."""
        with self.lock:
            self.closed = True
            self._broker._forget(self.key, self)

    # -- internals (broker lock held) ---------------------------------------

    def _tokens(self):
        return self._source.generated

    def _drain_locked(self) -> List[int]:
        out: List[int] = []
        while self._q:
            idx, tok = self._q.popleft()
            if idx < self._delivered:
                continue                  # duplicate (a replay)
            if idx > self._delivered:     # backpressure gap: backfill
                gen = self._tokens()
                out.extend(gen[self._delivered:idx])
                self._delivered = idx
            out.append(tok)
            self._delivered += 1
        if self._terminal is not None and self.finish_reason is None:
            gen = self._tokens()          # late-open / post-drop tail
            if self._delivered < len(gen):
                out.extend(gen[self._delivered:])
                self._delivered = len(gen)
            self.finish_reason = self._terminal
            self._broker._forget(self.key, self)
        return out

    def _deliver_callback(self) -> None:
        """Push everything deliverable through the callback (serve
        thread, broker lock held): callback streams bypass the bounded
        queue entirely, so they never drop."""
        for tok in self._drain_locked():
            self._callback("token", tok)
        if self.finish_reason is not None:
            self._callback("end", self.finish_reason)


class StreamBroker:
    """Fan retired tokens out to per-request :class:`TokenStream`\\ s.

    ``publish``/``finish`` are no-ops for keys nobody opened — the
    broker costs nothing for non-streamed traffic — and a stream
    opened late backfills from the request itself, so open-time never
    races token delivery.
    """

    def __init__(self, *, queue_tokens: int = 256,
                 iter_wait_s: float = 60.0):
        if queue_tokens < 1:
            raise ValueError("queue_tokens must be >= 1")
        self.lock = threading.RLock()
        self._cond = threading.Condition(self.lock)
        self.queue_tokens = queue_tokens
        self.iter_wait_s = iter_wait_s
        self._streams: Dict[int, TokenStream] = {}
        self.opened = 0                  # streams ever opened
        self.published_tokens = 0        # tokens fanned out
        self.backpressure_drops = 0      # oldest-dropped notifications
        self.finished = 0                # terminal events published

    # -- consumer side -------------------------------------------------------

    def open(self, key: int, source: Any,
             callback: Optional[Callable[[str, Any], None]] = None
             ) -> TokenStream:
        """The stream for ``key``, creating it bound to ``source`` (a
        live request — see :class:`TokenStream`).  Re-opening an
        active key returns the existing stream (one consumer cursor
        per request)."""
        with self.lock:
            s = self._streams.get(key)
            if s is None:
                s = TokenStream(self, key, source, callback)
                self._streams[key] = s
                self.opened += 1
                if source.finished:      # already terminal at open
                    s._terminal = source.finish_reason
                if callback is not None:
                    s._deliver_callback()
            return s

    # -- producer side (serve thread, at token-retire time) ------------------

    def publish(self, key: int, index: int, token: int) -> None:
        """Fan one applied token out; O(1), never blocks on the
        consumer.  ``index`` is the token's position in the request's
        stream — re-published prefixes (a replay) dedup here."""
        with self.lock:
            s = self._streams.get(key)
            if s is None or s.closed:
                return
            if index < s._published:
                return                   # already fanned out: dedup
            s._published = index + 1
            self.published_tokens += 1
            if s._callback is not None:
                s._q.append((index, token))
                s._deliver_callback()
            else:
                if len(s._q) >= self.queue_tokens:
                    s._q.popleft()       # slow consumer: drop oldest,
                    s.drops += 1         # reader backfills the gap
                    self.backpressure_drops += 1
                s._q.append((index, token))
            self._cond.notify_all()

    def finish(self, key: int, reason: str) -> None:
        """Publish the terminal event (``finish_reason``); delivery
        backfills any tokens the queue never carried."""
        with self.lock:
            s = self._streams.get(key)
            if s is None or s.closed:
                return
            if s._terminal is None:
                s._terminal = reason
                self.finished += 1
            if s._callback is not None:
                s._deliver_callback()
            self._cond.notify_all()

    # -- introspection -------------------------------------------------------

    @property
    def active(self) -> int:
        """Streams opened and not yet fully delivered/closed."""
        with self.lock:
            return len(self._streams)

    def stats(self) -> dict:
        """The pinned ``stats()["streams"]`` sub-block."""
        with self.lock:
            return {
                "active": len(self._streams),
                "opened": self.opened,
                "published_tokens": self.published_tokens,
                "backpressure_drops": self.backpressure_drops,
                "finished": self.finished,
                "queue_tokens": self.queue_tokens,
            }

    def snapshot(self, limit: int = 64) -> List[dict]:
        """Per-stream rows (open streams only; delivery cursors read
        under the broker lock)."""
        with self.lock:
            rows = []
            for key, s in list(self._streams.items())[:limit]:
                rows.append({
                    "key": key,
                    "delivered": s._delivered,
                    "queued": len(s._q),
                    "drops": s.drops,
                    "terminal": s._terminal,
                })
            return rows

    # -- internal ------------------------------------------------------------

    def _forget(self, key: int, stream: TokenStream) -> None:
        # lock held by caller (close/_drain_locked); keep the dict
        # bounded: consumed/closed streams leave the broker but stay
        # readable by their holder
        if self._streams.get(key) is stream:
            del self._streams[key]
