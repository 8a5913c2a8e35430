"""The in-process KV transport backend: the direct call.

Twin of ``apex_tpu/serving/transport/inprocess.py``.  ``_deliver`` calls
the receiver's handler on the sender's thread: no serialization, no
copy, no extra random draws and, with ``chaos=None``, no branch the
direct call did not take — which is why it is the default backend.

It still runs the whole :class:`~.base.TransportPolicy` envelope —
deadline, bounded retry, per-peer breaker, exactly-once ledger — so the
fault model is testable without a socket: a fault plan injects resets,
stalls and duplicates at the ``_deliver`` seam and every consumer's
degradation path runs for real.
"""

from __future__ import annotations

from apex_tpu_torch.serving.transport.base import KVTransport

__all__ = ["InProcessTransport"]


class InProcessTransport(KVTransport):
    """Direct-call backend: ``send`` is ``handler(meta, payload)`` under
    the policy envelope.  ``carries_objects`` is True: meta may carry
    live objects because nothing is serialized."""

    backend = "inprocess"
    carries_objects = True

    def _deliver(self, st, tid, meta, payload):
        return self._ingest(st, tid, meta, payload)
