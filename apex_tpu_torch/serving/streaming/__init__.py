"""apex_tpu_torch.serving.streaming — per-token delivery.

Twin of ``apex_tpu/serving/streaming``.  The server applies each retired
token request by request; :class:`StreamBroker` fans that same retire
edge out to per-request bounded queues, giving two consumer surfaces
over one contract (delivered tokens are always a byte-identical prefix
of the non-streaming ``Request.generated``):

- iterator: ``for tok in server.stream(uid): ...`` — blocking, with
  non-blocking ``drain()`` / bounded ``take(timeout=)`` underneath;
- callback: ``server.stream(uid, callback=fn)`` — ``fn("token", t)``
  per token at retire time plus one ``fn("end", finish_reason)``.

The reference's third surface, SSE over its HTTP ops plane, comes with
the ops plane.

Backpressure contract: queues are bounded (``stream_queue_tokens``);
a slow consumer drops the OLDEST queued notification instead of ever
stalling ``step()``, and the stream backfills the dropped range from
the request's own token list on the next read — so delivery stays
byte-identical and only the broker's ``backpressure_drops`` counter
records the lag.
"""

from apex_tpu_torch.serving.streaming.broker import StreamBroker, TokenStream

__all__ = ["StreamBroker", "TokenStream"]
