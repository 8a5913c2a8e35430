"""The port's KV transport against apex_tpu's.

Twins of ``tests/L0/test_transport.py``:

- the frame codec: split reads reassemble, oversized declared lengths
  and crc mismatches are rejected with nothing ingested;
- the payload codec: the port's export of a fp32, bf16 and int8 pool
  encodes to the same header fields and body as the reference's
  ``encode_payload`` of the JAX engine's export of the same contents,
  and decodes without ml_dtypes (a ``bfloat16`` tag gives uint16 bits
  with ``dtypes`` set);
- the envelope on the in-process backend with injected time: resets
  retry and land once, a reset after dispatch and a duplicate answer
  from the ledger, stalls degrade unretried, the handler's rejections
  (``ValueError``, ``MemoryError`` and the card's
  ``torch.OutOfMemoryError``) re-raise natively, unretried, without
  opening the breaker; retry exhaustion, the deadline, the breaker;
- the socket backend over loopback: every leaf moves bit for bit, the
  native rejections cross the wire, a handler crash answers an error,
  oversized frames close with nothing ingested, duplicates dedup, two
  transports route, a dead endpoint retries then fails; the backends
  move the same bytes; empty transfers;
- the server's offload promote over the socket backend, with a reset
  and a stall injected through the ``chaos`` seam.

A test-local fault plan stands in for the reference's
``_TransportFaultPlan`` (its ``ChaosTransport`` and the router's
cross-replica hand-off come later).  Every ``SocketTransport`` is closed
by a fixture, so no server thread outlives its test.
"""

import socket
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving.transport import sockets as jsockets
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer
from apex_tpu_torch.serving.transport import (
    FrameReader,
    InProcessTransport,
    MAX_FRAME_BYTES,
    ReceiverLedger,
    SocketTransport,
    TransportConnectionError,
    TransportError,
    TransportFrameError,
    TransportPolicy,
    TransportTimeoutError,
    decode_payload,
    encode_frame,
    encode_payload,
)
from apex_tpu_torch.serving.transport.sockets import KIND_ACK, KIND_REQ

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

# the one reference layer the port does not have yet
JAX_FLAGS = dict(enable_program_accounting=False)

OOMS = [MemoryError, torch.OutOfMemoryError]


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


@pytest.fixture
def sockets():
    """``make(...)`` builds a SocketTransport that is closed, its server
    threads joined, when the test ends."""
    made = []

    def make(*args, **kw):
        t = SocketTransport(*args, **kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()
        assert not t._thread.is_alive()


def _payload(seed=0, blocks=3, bs=4):
    """A synthetic export_blocks payload: float leaves plus an int8
    scale sidecar (every leaf must ride), true per-leaf crcs."""
    rng = np.random.RandomState(seed)
    leaves = {
        "k0": rng.rand(2, blocks * bs, 3).astype(np.float32),
        "v0": rng.rand(2, blocks * bs, 3).astype(np.float32),
        "k0_scale": rng.randint(-128, 127, size=(2, blocks * bs),
                                dtype=np.int8),
    }
    return {"num_blocks": blocks, "block_size": bs, "leaves": leaves,
            "crc": {n: zlib.crc32(np.ascontiguousarray(a).tobytes())
                    for n, a in leaves.items()}}


def _crc_checking_handler(calls):
    """The consumer-shaped sink: verifies the payload checksums as
    ``import_blocks`` does, raises ``ValueError`` on a torn payload and
    records each ingested payload in ``calls``."""
    def handler(meta, payload):
        for name, arr in payload["leaves"].items():
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != payload["crc"][name]:
                raise ValueError(
                    f"torn hand-off payload: leaf {name!r}; payload "
                    f"rejected whole")
        calls.append(payload)
        return {"n": int(payload["num_blocks"])}
    return handler


class _Clock:
    """Injected monotonic time: ``sleep`` advances it, nothing waits."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _policy(clock=None, **kw):
    clock = clock or _Clock()
    kw.setdefault("deadline_s", 10.0)
    return TransportPolicy(clock=clock, sleep=clock.sleep, **kw)


class _Plan:
    """One transfer's injected fault, the ``chaos`` seam's contract:
    ``before`` at the top of every attempt (a reset or a stall raises, a
    corruption returns a copy with one byte flipped), ``after`` after a
    delivery (a duplicate delivers the same transfer id again; a reset
    after dispatch raises as if the ack were lost).  Each fires once, so
    a retry sees a healthy wire."""

    def __init__(self, kind, injected):
        self.kind = kind
        self.injected = injected
        self._fired = False

    def before(self, payload):
        if self._fired or self.kind in ("dup", "reset_after"):
            return payload
        self._fired = True
        self.injected[self.kind] += 1
        if self.kind == "reset":
            raise TransportConnectionError("test: reset mid-frame")
        if self.kind == "stall":
            raise TransportTimeoutError("test: stalled past the deadline")
        name = min(payload["leaves"])
        arr = np.asarray(payload["leaves"][name]).copy()
        arr.view(np.uint8).flat[0] ^= 0xFF
        return dict(payload, leaves=dict(payload["leaves"], **{name: arr}))

    def after(self, redeliver):
        if self._fired:
            return
        if self.kind == "dup":
            self._fired = True
            self.injected["dup"] += 1
            redeliver()
        elif self.kind == "reset_after":
            self._fired = True
            self.injected["reset_after"] += 1
            raise TransportConnectionError("test: reset after dispatch")


class _Chaos:
    """Pops one scripted plan a send (None for a send past the script,
    or where the script holds None)."""

    def __init__(self, kinds):
        self.kinds = list(kinds)
        self.injected = {k: 0 for k in ("reset", "reset_after", "stall",
                                        "dup", "corrupt")}

    def plan_send(self, peer):
        if not self.kinds:
            return None
        kind = self.kinds.pop(0)
        return None if kind is None else _Plan(kind, self.injected)


class _Flaky(InProcessTransport):
    """In-process backend whose wire fails ``fail`` times before
    recovering: the transport-level fault."""

    def __init__(self, policy, fail=0, exc=TransportConnectionError):
        super().__init__(policy)
        self.fail = fail
        self.exc = exc

    def _deliver(self, st, tid, meta, payload):
        if self.fail:
            self.fail -= 1
            raise self.exc("injected wire fault")
        return super()._deliver(st, tid, meta, payload)


# -- frame codec -----------------------------------------------------------

def test_frame_roundtrip_split_reads_byte_by_byte():
    frame = encode_frame(KIND_REQ, {"peer": "p", "tid": 0},
                         b"\x01\x02\x03")
    assert frame == jsockets.encode_frame(jsockets.KIND_REQ,
                                          {"peer": "p", "tid": 0},
                                          b"\x01\x02\x03")
    reader = FrameReader()
    for b in frame[:-1]:
        assert reader.feed(bytes([b])) == []
    frames = reader.feed(frame[-1:])
    assert frames == [(KIND_REQ, {"peer": "p", "tid": 0},
                       b"\x01\x02\x03")]


def test_frame_reader_handles_two_frames_one_feed():
    a = encode_frame(KIND_REQ, {"tid": 1}, b"a")
    b = encode_frame(KIND_ACK, {"tid": 1, "ack": None}, b"")
    frames = FrameReader().feed(a + b)
    assert [f[0] for f in frames] == [KIND_REQ, KIND_ACK]
    assert frames[0][2] == b"a"


def test_frame_split_across_frame_boundary():
    a = encode_frame(KIND_REQ, {"tid": 1}, b"aaaa")
    b = encode_frame(KIND_REQ, {"tid": 2}, b"bbbb")
    reader = FrameReader()
    frames = reader.feed(a + b[:7])
    assert [h["tid"] for _, h, _ in frames] == [1]
    frames = reader.feed(b[7:])
    assert [h["tid"] for _, h, _ in frames] == [2]


def test_frame_oversized_rejected_with_messaged_error():
    reader = FrameReader(max_frame_bytes=64)
    frame = encode_frame(KIND_REQ, {"tid": 0}, b"x" * 256)
    with pytest.raises(TransportFrameError) as ei:
        reader.feed(frame)
    msg = str(ei.value)
    assert "64-byte ceiling" in msg
    assert "rejected whole" in msg
    assert MAX_FRAME_BYTES == jsockets.MAX_FRAME_BYTES


def test_frame_crc_mismatch_rejected_whole():
    frame = bytearray(encode_frame(KIND_REQ, {"tid": 0}, b"payload"))
    frame[-1] ^= 0xFF
    with pytest.raises(TransportFrameError, match="crc mismatch"):
        FrameReader().feed(bytes(frame))


def test_frame_bad_magic_and_version_rejected():
    frame = bytearray(encode_frame(KIND_REQ, {"tid": 0}, b""))
    with pytest.raises(TransportFrameError, match="magic"):
        FrameReader().feed(b"XXXX" + bytes(frame)[4:])
    frame[4] = 99                         # version byte
    with pytest.raises(TransportFrameError, match="version"):
        FrameReader().feed(bytes(frame))


def test_frame_header_must_be_json_serializable():
    with pytest.raises(TransportError, match="JSON-serializable"):
        encode_frame(KIND_REQ, {"obj": object()})


# -- payload codec ---------------------------------------------------------

def test_payload_codec_round_trips_every_leaf():
    p = _payload(3)
    fields, body = encode_payload(p)
    assert (fields, body) == jsockets.encode_payload(p)
    back = decode_payload(dict(fields), body)
    assert back["num_blocks"] == p["num_blocks"]
    assert back["block_size"] == p["block_size"]
    assert sorted(back["leaves"]) == sorted(p["leaves"])
    for name, arr in p["leaves"].items():
        assert back["leaves"][name].dtype == arr.dtype
        assert np.array_equal(back["leaves"][name], arr)
    assert back["crc"] == p["crc"]
    assert back["dtypes"] == {"k0": "float32", "v0": "float32",
                              "k0_scale": "int8"}


def test_payload_codec_carries_block_crc_sidecar():
    p = _payload(4)
    p["block_crc"] = {"k0": [1, 2, 3]}
    fields, body = encode_payload(p)
    assert decode_payload(dict(fields), body)["block_crc"] == \
        {"k0": [1, 2, 3]}


def _engines(tiny, mode):
    """A JAX engine and a port engine on the same pool geometry, the JAX
    pool filled by a short generate."""
    cfg, sd, jcfg, jparams = tiny
    dtype = {"float32": (torch.float32, jnp.float32),
             "bfloat16": (torch.bfloat16, jnp.bfloat16),
             "int8": (torch.float32, jnp.float32)}[mode]
    kw = dict(max_batch_size=2, max_context=64, block_size=8,
              kv_quant="int8" if mode == "int8" else "off",
              enable_kv_offload=False)
    jsrv = JaxInferenceServer(jcfg, jparams, cache_dtype=dtype[1],
                              attention_fn=jax_make_flash(causal=True),
                              **kw, **JAX_FLAGS)
    jsrv.generate([list(range(1, 22))], max_new_tokens=6)
    make = lambda: InferenceServer(cfg, sd, device="cpu",  # noqa: E731
                                   cache_dtype=dtype[0], **kw).engine
    return jsrv.engine, make


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_payload_codec_equals_the_reference_on_engine_exports(
        tiny, mode, monkeypatch):
    """The same pool contents: the port's export encodes to the
    reference's header fields and body bytes (a bf16 leaf tagged
    ``bfloat16`` by name), decodes with ml_dtypes unimportable, and
    imports into a fresh port pool to the same bytes."""
    jeng, make = _engines(tiny, mode)
    ids = [1, 2, 3]
    peng = make()
    peng.import_blocks(ids, jeng.export_blocks(ids))
    exported = peng.export_blocks(ids, per_block_crc=True)
    fields, body = encode_payload(exported)
    want = jsockets.encode_payload(jeng.export_blocks(ids,
                                                      per_block_crc=True))
    assert fields == want[0]
    assert body == want[1]
    tags = {row[0]: row[1] for row in fields["manifest"]}
    assert tags["k"] == {"float32": "<f4", "bfloat16": "bfloat16",
                         "int8": "|i1"}[mode]
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    back = decode_payload(dict(fields), body)
    assert back["dtypes"] == exported["dtypes"]
    for name, arr in exported["leaves"].items():
        assert back["leaves"][name].dtype == arr.dtype
        assert back["leaves"][name].tobytes() == arr.tobytes()
    fresh = make()
    fresh.import_blocks(ids, back)
    again = fresh.export_blocks(ids)
    assert again["crc"] == exported["crc"]


def test_payload_unknown_dtype_tag_is_frame_error():
    fields, body = encode_payload(_payload(8, blocks=1))
    fields = dict(fields)
    fields["manifest"] = [list(r) for r in fields["manifest"]]
    fields["manifest"][0][1] = "float7_e9"
    with pytest.raises(TransportFrameError, match="unknown leaf dtype"):
        decode_payload(fields, body)


def test_payload_manifest_overrun_and_trailing_bytes_rejected():
    fields, body = encode_payload(_payload(5))
    with pytest.raises(TransportFrameError, match="overruns"):
        decode_payload(dict(fields), body[:-4])
    with pytest.raises(TransportFrameError, match="trailing"):
        decode_payload(dict(fields), body + b"\x00\x00")


# -- policy envelope (in-process backend, injected time) -------------------

def test_send_delivers_and_counts():
    t = InProcessTransport(_policy())
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    assert t.send("sink", {"op": "test"}, _payload()) == {"n": 3}
    assert len(calls) == 1
    s = t.stats()
    assert s["backend"] == "inprocess"
    assert (s["attempts"], s["delivered"], s["ingested"]) == (1, 1, 1)
    assert s["failures"] == s["rejects"] == s["dedup_hits"] == 0


def test_unknown_peer_is_messaged():
    t = InProcessTransport(_policy())
    t.register_peer("a", lambda m, p: None)
    with pytest.raises(TransportError, match="unknown transport peer"):
        t.send("b", {}, _payload())


def test_reset_is_retried_and_lands_exactly_once():
    t = InProcessTransport(_policy())
    chaos = _Chaos(["reset"])
    t.chaos = chaos
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    assert t.send("sink", {}, _payload()) == {"n": 3}
    assert len(calls) == 1
    assert chaos.injected["reset"] == 1
    s = t.stats()
    assert (s["attempts"], s["retries"], s["delivered"]) == (2, 1, 1)
    assert s["ingested"] == 1 and s["dedup_hits"] == 0


def test_reset_after_dispatch_dedups_on_retry():
    """The handler ran but the ack died: the retry answers from the
    ledger — one ingest, one dedup hit, nothing imported twice."""
    t = InProcessTransport(_policy())
    t.chaos = _Chaos(["reset_after"])
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    assert t.send("sink", {}, _payload()) == {"n": 3}
    assert len(calls) == 1
    s = t.stats()
    assert s["dedup_hits"] == 1
    assert (s["ingested"], s["retries"], s["delivered"]) == (1, 1, 1)


def test_duplicate_delivery_answered_from_ledger():
    t = InProcessTransport(_policy())
    t.chaos = _Chaos(["dup"])
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    assert t.send("sink", {}, _payload()) == {"n": 3}
    assert len(calls) == 1
    s = t.stats()
    assert s["dedup_hits"] == 1 and s["ingested"] == 1
    assert s["retries"] == 0              # a dup is not a retry


def test_stall_degrades_without_retry():
    t = InProcessTransport(_policy())
    t.chaos = _Chaos(["stall"])
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    with pytest.raises(TransportTimeoutError):
        t.send("sink", {}, _payload())
    assert calls == []
    s = t.stats()
    assert (s["attempts"], s["retries"]) == (1, 0)
    assert s["deadline_exceeded"] == 1 and s["failures"] == 1


def test_corrupt_in_flight_rejected_whole_as_native_valueerror():
    t = InProcessTransport(_policy())
    t.chaos = _Chaos(["corrupt"])
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    with pytest.raises(ValueError, match="rejected whole"):
        t.send("sink", {}, _payload())
    assert calls == []
    s = t.stats()
    assert s["rejects"] == 1 and s["failures"] == 0
    assert s["per_peer"]["sink"]["breaker"] == "closed"
    assert t.send("sink", {}, _payload()) == {"n": 3}


@pytest.mark.parametrize("error", OOMS)
def test_oom_reraises_natively_unretried(error):
    """A handler's OOM — the reference's ``MemoryError`` or the card's
    ``torch.OutOfMemoryError`` (a ``RuntimeError``) — comes back as
    itself, unretried, and the breaker stays closed however often."""
    t = InProcessTransport(_policy(breaker_failures=2))

    def full(meta, payload):
        raise error("pool full")

    t.register_peer("sink", full)
    for _ in range(3):
        with pytest.raises(error, match="pool full"):
            t.send("sink", {}, _payload())
    s = t.stats()
    assert (s["attempts"], s["rejects"], s["retries"]) == (3, 3, 0)
    assert s["failures"] == 0
    assert s["per_peer"]["sink"]["breaker"] == "closed"


def test_rejected_transfer_is_not_cached_in_the_ledger():
    t = InProcessTransport(_policy())
    state = {"fail": True}
    calls = []

    def flaky(meta, payload):
        if state["fail"]:
            state["fail"] = False
            raise MemoryError("transient")
        calls.append(payload)
        return "ok"

    t.register_peer("sink", flaky)
    with pytest.raises(MemoryError):
        t.send("sink", {}, _payload())
    assert t.send("sink", {}, _payload()) == "ok"
    assert len(calls) == 1
    assert t.stats()["dedup_hits"] == 0


def test_retry_exhaustion_wraps_as_connection_error():
    t = _Flaky(_policy(attempts=3), fail=99)
    t.register_peer("sink", lambda m, p: "ok")
    with pytest.raises(TransportConnectionError, match="failed"):
        t.send("sink", {}, _payload())
    s = t.stats()
    assert (s["attempts"], s["retries"], s["failures"]) == (3, 2, 1)


def test_deadline_bounds_the_whole_send():
    t = _Flaky(_policy(deadline_s=0.5, attempts=50, backoff=1.0,
                       max_backoff=1.0), fail=99)
    t.register_peer("sink", lambda m, p: "ok")
    with pytest.raises(TransportConnectionError):
        t.send("sink", {}, _payload())
    s = t.stats()
    assert s["attempts"] < 50
    assert s["failures"] == 1


def test_breaker_opens_then_fast_fails_then_recovers():
    clock = _Clock()
    t = _Flaky(_policy(clock, breaker_failures=2, breaker_recovery_s=30.0,
                       attempts=1), fail=2, exc=TransportTimeoutError)
    t.register_peer("sink", lambda m, p: "ok")
    for _ in range(2):
        with pytest.raises(TransportTimeoutError):
            t.send("sink", {}, _payload())
    assert t.stats()["per_peer"]["sink"]["breaker"] == "open"
    with pytest.raises(TransportConnectionError, match="circuit open"):
        t.send("sink", {}, _payload())
    s = t.stats()
    assert s["breaker_fastfail"] == 1
    assert s["attempts"] == 2, "fast-fail must not touch the wire"
    clock.t += 31.0
    assert t.send("sink", {}, _payload()) == "ok"
    assert t.stats()["delivered"] == 1


def test_receiver_ledger_is_bounded():
    led = ReceiverLedger(2)
    for tid in (1, 2, 3):
        led.record(tid, f"ack{tid}")
    assert len(led) == 2
    hit, ack = led.lookup(3)
    assert hit and ack == "ack3" and led.dedup_hits == 1
    hit, _ = led.lookup(1)
    assert not hit and led.dedup_hits == 1


def test_stats_shape_is_pinned():
    t = InProcessTransport(_policy())
    t.register_peer("sink", lambda m, p: None)
    s = t.stats()
    assert set(s) == {
        "backend", "peers", "attempts", "retries", "delivered",
        "rejects", "failures", "deadline_exceeded",
        "breaker_fastfail", "ingested", "dedup_hits", "per_peer"}
    assert set(s["per_peer"]["sink"]) == {
        "attempts", "retries", "delivered", "rejects", "failures",
        "deadline_exceeded", "breaker_fastfail", "ingested",
        "dedup_hits", "breaker"}
    from apex_tpu.serving.transport import InProcessTransport as JaxT
    from apex_tpu.serving.transport import TransportPolicy as JaxPolicy
    j = JaxT(JaxPolicy())
    j.register_peer("sink", lambda m, p: None)
    assert s == j.stats()


# -- socket backend --------------------------------------------------------

def test_socket_roundtrip_moves_every_leaf(sockets):
    t = sockets(_policy())
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    p = _payload(7)
    assert t.send("sink", {"op": "warm"}, p) == {"n": 3}
    assert len(calls) == 1
    for name, arr in p["leaves"].items():
        got = calls[0]["leaves"][name]
        assert got.dtype == arr.dtype
        assert np.array_equal(got, arr)
    s = t.stats()
    assert s["backend"] == "socket"
    assert (s["delivered"], s["ingested"]) == (1, 1)
    assert s["failures"] == 0


def test_socket_native_rejections_cross_the_wire(sockets):
    """``ValueError``, ``MemoryError`` and the card's
    ``torch.OutOfMemoryError`` arrive at the sender as themselves,
    message intact, unretried, the breaker closed."""
    t = sockets(_policy())

    def reject(meta, payload):
        if meta["mode"] == "torn":
            raise ValueError("torn hand-off payload: leaf 'k0'; "
                             "payload rejected whole")
        if meta["mode"] == "card":
            raise torch.OutOfMemoryError("CUDA out of memory (card)")
        raise MemoryError("pool at capacity")

    t.register_peer("sink", reject)
    with pytest.raises(ValueError, match="rejected whole"):
        t.send("sink", {"mode": "torn"}, _payload())
    with pytest.raises(MemoryError, match="at capacity"):
        t.send("sink", {"mode": "oom"}, _payload())
    with pytest.raises(torch.OutOfMemoryError, match="card"):
        t.send("sink", {"mode": "card"}, _payload())
    s = t.stats()
    assert s["rejects"] == 3 and s["failures"] == 0 and s["retries"] == 0
    assert s["per_peer"]["sink"]["breaker"] == "closed"


def test_socket_handler_crash_answers_error_not_silence(sockets):
    t = sockets(_policy())

    def buggy(meta, payload):
        if meta.get("mode") == "crash":
            raise TypeError("a handler bug")
        return {"ok": True}

    t.register_peer("sink", buggy)
    with pytest.raises(TransportError, match="TypeError") as ei:
        t.send("sink", {"mode": "crash"}, _payload())
    assert not isinstance(
        ei.value, (TransportTimeoutError, TransportConnectionError))
    assert t.send("sink", {"mode": "ok"}, _payload()) == {"ok": True}
    s = t.stats()
    assert s["delivered"] == 1 and s["deadline_exceeded"] == 0


def test_socket_moves_bf16_cache_leaves(sockets, monkeypatch):
    """A bf16 leaf (uint16 bits, ``dtypes`` naming it) lands bit for bit
    with its name, without ml_dtypes."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    rng = np.random.RandomState(11)
    bits = torch.from_numpy(rng.randn(3, 2, 8, 4).astype(np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    p = {"num_blocks": 3, "block_size": 8,
         "leaves": {"k0": bits}, "dtypes": {"k0": "bfloat16"},
         "crc": {"k0": zlib.crc32(bits.tobytes())}}
    t = sockets(_policy())
    landed = []
    t.register_peer("sink", lambda m, pl: landed.append(pl)
                    or {"n": pl["num_blocks"]})
    assert t.send("sink", {"op": "handoff"}, p) == {"n": 3}
    got = landed[0]
    assert got["dtypes"] == {"k0": "bfloat16"}
    assert got["leaves"]["k0"].dtype == np.uint16
    assert np.array_equal(got["leaves"]["k0"], bits)


def test_socket_oversized_frame_closes_with_nothing_ingested(sockets):
    t = sockets(_policy(), max_frame_bytes=4096)
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    big = _payload(1, blocks=64, bs=16)
    with pytest.raises(TransportError, match="ceiling") as ei:
        t.send("sink", {}, big)
    assert not isinstance(ei.value, TransportConnectionError)
    assert calls == []
    s = t.stats()
    assert s["ingested"] == 0 and s["failures"] == 1


def test_socket_duplicate_tid_suppressed_over_the_wire(sockets):
    t = sockets(_policy())
    t.chaos = _Chaos(["dup"])
    calls = []
    t.register_peer("sink", _crc_checking_handler(calls))
    assert t.send("sink", {}, _payload()) == {"n": 3}
    assert len(calls) == 1
    assert t.stats()["dedup_hits"] == 1


def test_socket_routes_between_two_transports(sockets):
    a, b = sockets(_policy()), sockets(_policy())
    calls = []
    b.register_peer("sink", _crc_checking_handler(calls))
    a.register_route("sink", b.address)
    assert a.send("sink", {}, _payload(9)) == {"n": 3}
    assert len(calls) == 1
    assert a.stats()["delivered"] == 1
    assert b.stats()["ingested"] == 1


def test_socket_connection_refused_retries_then_fails(sockets):
    dead = socket.create_server(("127.0.0.1", 0))
    addr = dead.getsockname()
    dead.close()
    t = sockets(_policy(attempts=3))
    t.register_route("sink", addr)
    with pytest.raises(TransportConnectionError):
        t.send("sink", {}, _payload())
    s = t.stats()
    assert (s["attempts"], s["retries"], s["failures"]) == (3, 2, 1)


def test_socket_concurrent_senders_each_land_once(sockets):
    """More sender threads than cores, a short switch interval: every
    transfer is ingested exactly once and every counter adds up (the
    server threads and the senders share the registry, ledger and
    counters under the transport lock)."""
    import os
    import threading

    t = sockets(_policy())
    seen, guard = [], threading.Lock()

    def handler(meta, payload):
        with guard:
            seen.append(meta["id"])
        return meta["id"]

    t.register_peer("sink", handler)
    senders, per = 2 * (os.cpu_count() or 2) + 2, 6
    acks = {}

    def send(k):
        for j in range(per):
            acks[(k, j)] = t.send("sink", {"id": k * per + j},
                                  _payload(blocks=1))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=send, args=(k,))
                   for k in range(senders)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    n = senders * per
    assert sorted(seen) == list(range(n))
    assert all(acks[(k, j)] == k * per + j for k, j in acks)
    s = t.stats()
    assert (s["attempts"], s["delivered"], s["ingested"]) == (n, n, n)
    assert s["failures"] == s["retries"] == s["dedup_hits"] == 0


def test_socket_close_joins_its_threads():
    t = SocketTransport(_policy())
    t.register_peer("sink", lambda m, p: "ok")
    assert t.send("sink", {}, _payload()) == "ok"
    t.close()
    assert not t._thread.is_alive()
    assert not any(c.is_alive() for c in t._conn_threads)


# -- backend parity --------------------------------------------------------

def _engine_sink(engine, captured):
    """The consumer-shaped ingest: reserve blocks, run the payload
    through the checksummed ``import_blocks``, re-export, ack the leaf
    crcs (JSON-able, so one handler serves both backends)."""
    def handler(meta, payload):
        ids = engine.allocator.alloc(int(meta["n"]))
        if ids is None:
            raise MemoryError("sink pool at capacity")
        try:
            engine.import_blocks(ids, payload)
            back = engine.export_blocks(ids)
        finally:
            engine.allocator.free(ids)
        captured.append(back)
        return {"crc": {k: int(v) for k, v in back["crc"].items()}}
    return handler


def _port(tiny, **kw):
    cfg, sd, _, _ = tiny
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_context", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("cache_dtype", torch.float32)
    return InferenceServer(cfg, sd, device="cpu", **kw)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_socket_matches_inprocess_byte_parity(tiny, sockets, quant):
    """KV a server decoded, moved through BOTH backends into a second
    server's pool and re-exported: every leaf (the int8 scales too) the
    source's bytes."""
    src = _port(tiny, kv_quant=quant)
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(0, VOCAB, size=12)) for _ in range(4)]
    src.generate(prompts, max_new_tokens=12)
    n = 6
    ids = src.engine.allocator.alloc(n)
    payload = src.engine.export_blocks(ids)
    src.engine.allocator.free(ids)
    landed = {}
    for make in (InProcessTransport, sockets):
        sink = _port(tiny, kv_quant=quant, num_blocks=3 * n)
        captured = []
        t = make(_policy())
        t.register_peer("sink", _engine_sink(sink.engine, captured))
        ack = t.send("sink", {"n": n}, payload)
        assert ack["crc"] == {k: int(v) for k, v in payload["crc"].items()}
        assert t.stats()["failures"] == 0
        landed[t.backend] = captured[0]
    for name, arr in payload["leaves"].items():
        for backend, back in landed.items():
            assert back["leaves"][name].tobytes() == arr.tobytes(), \
                (backend, name)


def test_empty_import_is_a_noop_not_a_zero_shape_launch(tiny):
    server = _port(tiny)
    server.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9]], max_new_tokens=4)
    eng = server.engine
    before = {n: a.clone() for n, a in eng.cache.items()}
    empty = eng.export_blocks([])
    assert empty["num_blocks"] == 0
    eng.import_blocks([], empty)
    assert all(torch.equal(eng.cache[n], a) for n, a in before.items())
    with pytest.raises(ValueError, match="geometry mismatch"):
        eng.import_blocks([], eng.export_blocks([1]))


def test_empty_transfer_through_transport_is_clean(tiny):
    server = _port(tiny)
    server.generate([[1, 2, 3, 4]], max_new_tokens=2)
    t = InProcessTransport(_policy())
    payload = server.engine.export_blocks([])

    def empty_sink(meta, payload):
        server.engine.import_blocks([], payload)
        return {"blocks": 0}

    t.register_peer("empty", empty_sink)
    assert t.send("empty", {"blocks": []}, payload) == {"blocks": 0}
    s = t.stats()
    assert s["failures"] == 0 and s["rejects"] == 0


# -- the server's promote over the socket backend --------------------------

def _sessions(n, seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, VOCAB, size=43)) for _ in range(n)]


def _session_traffic(server, prompts):
    """Two passes of one request at a time, audited every step."""
    outs = []
    for _ in range(2):
        for p in prompts:
            req = server.submit(p, 6)
            while server.has_work:
                server.step()
                server.audit()
            outs.append(list(req.generated))
    return outs


def _offload_server(tiny, **kw):
    return _port(tiny, max_batch_size=2, max_context=128, num_blocks=13,
                 enable_kv_offload=True, **kw)


def test_offload_promote_over_socket_equals_inprocess(tiny, sockets):
    """The session traffic's promotes over loopback TCP: the in-process
    server's tokens and offload counters, one delivery a promote batch,
    no retry; close() closes the transport."""
    prompts = _sessions(4, 7)
    ref = _offload_server(tiny)
    want = _session_traffic(ref, prompts)
    t = sockets(_policy())
    srv = _offload_server(tiny, kv_transport=t)
    got = _session_traffic(srv, prompts)
    assert got == want
    st, rst = srv.stats(), ref.stats()
    assert st["offload"] == rst["offload"] | {"promote_ms":
                                              st["offload"]["promote_ms"]}
    tr = st["transport"]
    assert tr["backend"] == "socket"
    assert tr["delivered"] == st["offload"]["promote_ms"]["count"] > 0
    assert tr["retries"] == 0 and tr["failures"] == 0
    srv.close()
    assert not t._thread.is_alive()


def test_offload_promote_survives_reset_and_stall(tiny, sockets):
    """A reset at the first promote is retried and lands; a stall at the
    second skips it (``transport_skips``), and that session cold
    prefills: every token the in-process server's."""
    prompts = _sessions(4, 7)
    want = _session_traffic(_offload_server(tiny), prompts)
    t = sockets(_policy())
    chaos = _Chaos(["reset", "stall"])
    t.chaos = chaos
    srv = _offload_server(tiny, kv_transport=t)
    got = _session_traffic(srv, prompts)
    assert got == want
    assert chaos.injected["reset"] == chaos.injected["stall"] == 1
    st = srv.stats()
    assert st["offload"]["transport_skips"] == 1
    tr = st["transport"]
    assert tr["retries"] == 1 and tr["deadline_exceeded"] == 1
    assert tr["per_peer"]["offload"]["breaker"] == "closed"
