"""The socket KV transport backend: crc-framed payloads over TCP.

Twin of ``apex_tpu/serving/transport/sockets.py`` (host only: numpy and
the standard library).  Each transfer opens a one-shot loopback TCP
connection, writes one length-prefixed crc-framed request and waits
(deadline-bounded) for one ack frame.  A stdlib server thread accepts
connections and dispatches frames into the shared exactly-once receiver
(:meth:`~.base.KVTransport._ingest`), so the dedup ledger, the breaker
and the retry envelope are the in-process backend's: only the wire
differs.

Wire format (one frame)::

    magic   b"KVTX"          4 bytes
    version u8               currently 1
    kind    u8               1=REQ  2=ACK  3=ERR
    hlen    u32 (big-endian) JSON header length
    blen    u64 (big-endian) raw body length
    crc     u32 (big-endian) zlib.crc32(header_bytes + body)
    header  hlen bytes       JSON
    body    blen bytes       concatenated raw leaf buffers

A REQ header carries ``peer``, ``tid`` and ``meta``, the payload's
geometry (``num_blocks``/``block_size``), the per-leaf crc dict, the
optional per-block crc sidecar and a ``manifest`` of ``[name, dtype,
shape]`` rows locating each leaf in the body: every cache leaf rides
the same frame, the int8 pool's scale sidecar included.  A leaf dtype
is its numpy byte-order string (``<f4``, ``|i1``), except a bf16 leaf:
the port ships one as its uint16 bits with ``payload["dtypes"]`` naming
it, and the manifest tags it ``bfloat16`` by that name, as the JAX
package tags its ml_dtypes leaves, so the header and the body equal the
JAX package's for the same pool contents.  A ``bfloat16`` tag decodes to
uint16 bits with ``dtypes`` set, and needs no ml_dtypes.

An ACK header carries the handler's ack; an ERR header carries
``etype``/``message`` and turns the handler's rejections (``ValueError``
and the OOMs of :data:`~apex_tpu_torch.serving.oom.OOM_ERRORS`, the
card's ``torch.OutOfMemoryError`` among them) back into the NATIVE
exception at the sender.

Frame integrity is separate from payload integrity: a frame whose crc
fails, whose magic is wrong or whose declared size exceeds
``max_frame_bytes`` raises :class:`~.base.TransportFrameError` and the
connection closes with NOTHING ingested.  Each transfer uses its own
connection, so frames of two transfers never interleave; the
:class:`FrameReader` is still a strict incremental parser (reads split
across frame boundaries are reassembled; trailing garbage is a frame
error).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import List, Optional

import numpy as np

from apex_tpu_torch.serving.transport.base import (
    APPLICATION_ERRORS,
    KVTransport,
    TransportConnectionError,
    TransportError,
    TransportFrameError,
    TransportPolicy,
    TransportTimeoutError,
)

__all__ = [
    "FrameReader",
    "KIND_ACK",
    "KIND_ERR",
    "KIND_REQ",
    "MAX_FRAME_BYTES",
    "SocketTransport",
    "decode_payload",
    "encode_frame",
    "encode_payload",
]

MAGIC = b"KVTX"
VERSION = 1
KIND_REQ, KIND_ACK, KIND_ERR = 1, 2, 3
# a 64 MiB ceiling: a payload at serving scale is a few MiB; anything
# bigger is a corrupt length field, not a payload
MAX_FRAME_BYTES = 64 << 20

_PRELUDE = struct.Struct(">4sBBIQI")     # magic ver kind hlen blen crc

# the leaf dtype the port ships as uint16 bits, tagged by name
_BF16 = "bfloat16"

# the handler's rejections that cross the wire as their own class
_NATIVE = {cls.__name__: cls for cls in APPLICATION_ERRORS}


def encode_frame(kind: int, header: dict, body: bytes = b"") -> bytes:
    """One wire frame; ``header`` must be JSON-serializable (the socket
    backend never carries live objects: ``carries_objects`` is
    False)."""
    try:
        hbytes = json.dumps(header, separators=(",", ":")).encode()
    except TypeError as e:
        raise TransportError(
            f"socket transport header is not JSON-serializable "
            f"({e}) — live objects cannot cross the wire") from e
    crc = zlib.crc32(body, zlib.crc32(hbytes))
    return _PRELUDE.pack(MAGIC, VERSION, kind, len(hbytes),
                         len(body), crc) + hbytes + body


class FrameReader:
    """Incremental frame parser: :meth:`feed` raw socket bytes in any
    split, get back complete ``(kind, header, body)`` frames.  Every
    malformation — bad magic, bad version, oversized declared length,
    crc mismatch, unparseable header — raises
    :class:`~.base.TransportFrameError` with nothing partially
    delivered; the caller closes the connection."""

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._buf = bytearray()

    def feed(self, data: bytes):
        self._buf.extend(data)
        frames = []
        while len(self._buf) >= _PRELUDE.size:
            magic, ver, kind, hlen, blen, crc = _PRELUDE.unpack_from(
                self._buf)
            if magic != MAGIC:
                raise TransportFrameError(
                    f"bad frame magic {bytes(magic)!r} "
                    f"(expected {MAGIC!r})")
            if ver != VERSION:
                raise TransportFrameError(
                    f"unsupported frame version {ver} "
                    f"(speak version {VERSION})")
            total = hlen + blen
            if total > self.max_frame_bytes:
                raise TransportFrameError(
                    f"frame of {total} bytes exceeds the "
                    f"{self.max_frame_bytes}-byte ceiling — corrupt "
                    f"length field or oversized payload; rejected "
                    f"whole, connection closed")
            if len(self._buf) < _PRELUDE.size + total:
                break                     # wait for more bytes
            start = _PRELUDE.size
            hbytes = bytes(self._buf[start:start + hlen])
            body = bytes(self._buf[start + hlen:start + total])
            del self._buf[:start + total]
            if zlib.crc32(body, zlib.crc32(hbytes)) != crc:
                raise TransportFrameError(
                    "frame crc mismatch — torn in flight; rejected "
                    "whole, nothing ingested")
            try:
                header = json.loads(hbytes)
            except ValueError as e:
                raise TransportFrameError(
                    f"frame header is not JSON ({e})") from e
            frames.append((kind, header, body))
        return frames


def _dtype_tag(arr: np.ndarray, dtype_name: Optional[str]) -> str:
    """Wire tag of a leaf: ``bfloat16`` for a leaf its payload's
    ``dtypes`` names so (uint16 bits) and for an extended-dtype numpy
    array (an ml_dtypes bfloat16 registers as a void record whose
    ``.str`` is ``<V2``), else the numpy byte-order string."""
    if dtype_name == _BF16:
        return _BF16
    dt = arr.dtype
    return dt.str if dt.kind != "V" else dt.name


def _resolve_dtype(tag: str):
    """Inverse of :func:`_dtype_tag`: ``(numpy dtype of the host array,
    dtype name)``.  ``bfloat16`` decodes to uint16 bits; any other name
    tag is a frame error, never a silent void reinterpretation."""
    if tag == _BF16:
        return np.dtype(np.uint16), _BF16
    try:
        dt = np.dtype(tag)
    except TypeError:
        dt = None
    if dt is None or dt.kind == "V":
        raise TransportFrameError(
            f"manifest names unknown leaf dtype {tag!r}; rejected "
            f"whole, nothing ingested")
    return dt, dt.name


def encode_payload(payload: dict):
    """``(header_fields, body)``: the checksummed payload dict (the
    ``export_blocks`` shape) flattened to a leaf manifest and one
    contiguous byte body.  Every leaf rides: K, V and the int8 pool's
    scale sidecars alike."""
    names = payload.get("dtypes") or {}
    manifest, chunks = [], []
    for name in sorted(payload["leaves"]):
        arr = np.asarray(payload["leaves"][name])
        manifest.append([name, _dtype_tag(arr, names.get(name)),
                         list(arr.shape)])
        chunks.append(arr.tobytes())
    fields = {"num_blocks": int(payload["num_blocks"]),
              "block_size": int(payload["block_size"]),
              "manifest": manifest,
              "crc": {k: int(v) for k, v in payload["crc"].items()}}
    if payload.get("block_crc") is not None:
        fields["block_crc"] = {
            name: [int(c) for c in crcs]
            for name, crcs in payload["block_crc"].items()}
    return fields, b"".join(chunks)


def decode_payload(header: dict, body: bytes) -> dict:
    """Rebuild the payload dict from a REQ frame, each leaf's dtype name
    in ``dtypes``.  Leaf byte counts must tile the body exactly: a
    mismatch is a frame error (the crc already matched, so this is a
    corrupt manifest)."""
    leaves, dtypes = {}, {}
    off = 0
    for name, tag, shape in header["manifest"]:
        dt, dtypes[name] = _resolve_dtype(tag)
        count = int(np.prod(shape, dtype=np.int64))
        n = dt.itemsize * count if shape else dt.itemsize
        if off + n > len(body):
            raise TransportFrameError(
                f"manifest overruns frame body at leaf {name!r} "
                f"({off + n} > {len(body)} bytes)")
        leaves[name] = np.frombuffer(
            body, dtype=dt, count=count,
            offset=off).reshape(shape).copy()
        off += n
    if off != len(body):
        raise TransportFrameError(
            f"frame body has {len(body) - off} trailing bytes the "
            f"manifest does not claim")
    out = {"num_blocks": header["num_blocks"],
           "block_size": header["block_size"],
           "leaves": leaves,
           "dtypes": dtypes,
           "crc": {k: int(v) for k, v in header["crc"].items()}}
    if header.get("block_crc") is not None:
        out["block_crc"] = {
            name: [int(c) for c in crcs]
            for name, crcs in header["block_crc"].items()}
    return out


class SocketTransport(KVTransport):
    """Loopback-TCP backend: a stdlib server thread serves the locally
    registered peers; ``send`` opens a one-shot connection (to a routed
    address, or back to its own server for local peers) a transfer.
    The server threads reach shared transport state only through
    :meth:`_dispatch`, which holds the transport lock.  :meth:`close`
    stops the server and joins its threads."""

    backend = "socket"
    carries_objects = False

    def __init__(self, policy: Optional[TransportPolicy] = None, *,
                 host: str = "127.0.0.1",
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        super().__init__(policy)
        self.max_frame_bytes = max_frame_bytes
        self._listener = socket.create_server((host, 0))
        self.address = self._listener.getsockname()
        self._conn_threads: List[threading.Thread] = []
        self._thread = threading.Thread(
            target=self._serve, name="kv-transport-server", daemon=True)
        self._thread.start()

    def register_route(self, name: str, address) -> None:
        """Route ``name`` to another transport's server address (the
        cross-process shape).  The peer gets the whole envelope (breaker,
        ledger) but no local handler."""
        with self._lock:
            self._peers[name] = self._peer_state(name,
                                                 address=tuple(address))

    # -- sender ------------------------------------------------------------

    def _deliver(self, st, tid, meta, payload):
        fields, body = encode_payload(payload)
        header = dict(fields, peer=st.name, tid=tid, meta=meta)
        frame = encode_frame(KIND_REQ, header, body)
        addr = st.address or self.address
        # the per-attempt socket timeout; the envelope's deadline bounds
        # the whole send on top
        timeout = self.policy.deadline_s
        try:
            with socket.create_connection(addr,
                                          timeout=timeout) as conn:
                conn.sendall(frame)
                reader = FrameReader(self.max_frame_bytes)
                frames = []
                while not frames:
                    chunk = conn.recv(1 << 16)
                    if not chunk:
                        raise TransportConnectionError(
                            f"transfer {tid} to {st.name!r}: "
                            f"connection closed before the ack")
                    frames = reader.feed(chunk)
        except socket.timeout as e:
            raise TransportTimeoutError(
                f"transfer {tid} to {st.name!r} stalled past "
                f"{timeout}s") from e
        except TransportError:
            raise
        except OSError as e:
            raise TransportConnectionError(
                f"transfer {tid} to {st.name!r}: {e}") from e
        kind, hdr, _ = frames[0]
        if kind == KIND_ACK:
            return hdr.get("ack")
        if kind == KIND_ERR:
            etype, msg = hdr.get("etype"), hdr.get("message", "")
            # the handler's rejections cross the wire as their native
            # class: consumer degradation paths cannot tell the backends
            # apart
            if etype in _NATIVE:
                raise _NATIVE[etype](msg)
            raise TransportError(
                f"peer {st.name!r} answered {etype}: {msg}")
        raise TransportFrameError(
            f"unexpected frame kind {kind} in ack position")

    # -- server ------------------------------------------------------------

    def _serve(self):
        # holds no shared transport state but the listener: blocking in
        # accept() under the lock would wedge every sender
        listener = self._listener
        while True:
            try:
                conn, _ = listener.accept()
            except OSError:
                return                    # listener closed by close()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            self._conn_threads = [c for c in self._conn_threads
                                  if c.is_alive()] + [t]
            t.start()

    def _serve_conn(self, conn):
        # framing is the connection's own state; shared transport state
        # is reached only through _dispatch, under the transport lock
        reader = FrameReader(self.max_frame_bytes)
        with conn:
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                except OSError:
                    return
                if not chunk:
                    return
                try:
                    frames = reader.feed(chunk)
                except TransportFrameError as e:
                    # a torn or oversized frame: answer a messaged error,
                    # ingest nothing, close the connection
                    try:
                        conn.sendall(encode_frame(
                            KIND_ERR,
                            {"etype": "TransportFrameError",
                             "message": str(e)}))
                    except OSError:
                        pass
                    return
                for kind, header, body in frames:
                    try:
                        conn.sendall(self._dispatch(kind, header, body))
                    except OSError:
                        return

    def _dispatch(self, kind, header, body) -> bytes:
        """One REQ frame -> one ACK or ERR frame, under the transport
        lock (the server threads' only entry into shared state)."""
        with self._lock:
            if kind != KIND_REQ:
                return encode_frame(
                    KIND_ERR, {"etype": "TransportFrameError",
                               "message": f"unexpected frame kind "
                                          f"{kind}"})
            st = self._peers.get(header.get("peer"))
            if st is None or st.handler is None:
                return encode_frame(
                    KIND_ERR,
                    {"etype": "TransportError",
                     "message": f"no local handler for peer "
                                f"{header.get('peer')!r}"})
            try:
                payload = decode_payload(header, body)
                ack = self._ingest(st, int(header["tid"]),
                                   header.get("meta") or {}, payload)
            except Exception as e:   # noqa: BLE001 — the rejections,
                # a transport error, or a handler crash: each answers the
                # sender (who degrades at once) rather than killing this
                # thread and leaving it to wait out its whole deadline
                return encode_frame(
                    KIND_ERR, {"etype": type(e).__name__,
                               "message": str(e)})
            return encode_frame(
                KIND_ACK, {"tid": int(header["tid"]), "ack": ack})

    def close(self) -> None:
        """Stop accepting, and join the server thread and every
        connection thread."""
        try:
            # shutdown wakes the accept() blocked in the server thread
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
        for t in list(self._conn_threads):
            t.join(timeout=2.0)
