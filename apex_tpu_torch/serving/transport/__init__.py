"""KV transport layer.

Twin of ``apex_tpu/serving/transport/``: the interchangeable-backend
interface the offload promote rides, with a retry/deadline/breaker
envelope and exactly-once ingest (:mod:`.base`), the in-process backend
(:mod:`.inprocess`, the default) and loopback TCP (:mod:`.sockets`).
"""

from apex_tpu_torch.serving.transport.base import (
    KVTransport,
    ReceiverLedger,
    TransportConnectionError,
    TransportError,
    TransportFrameError,
    TransportPolicy,
    TransportTimeoutError,
)
from apex_tpu_torch.serving.transport.inprocess import InProcessTransport
from apex_tpu_torch.serving.transport.sockets import (
    MAX_FRAME_BYTES,
    FrameReader,
    SocketTransport,
    decode_payload,
    encode_frame,
    encode_payload,
)

__all__ = [
    "FrameReader",
    "InProcessTransport",
    "KVTransport",
    "MAX_FRAME_BYTES",
    "ReceiverLedger",
    "SocketTransport",
    "TransportConnectionError",
    "TransportError",
    "TransportFrameError",
    "TransportPolicy",
    "TransportTimeoutError",
    "decode_payload",
    "encode_frame",
    "encode_payload",
]
