"""The port's per-token streaming and cancellation against apex_tpu's.

Twins of ``tests/L0/test_streaming.py``:

- the broker alone (:95-153): each scenario runs on the port's
  ``StreamBroker`` and on the reference's, and both give the same
  observations, which are the reference test's; and the port's under
  many consumer threads at once;
- delivery byte identity (:172, :191): every stream equals its
  request's ``generated``, greedy (the JAX server's tokens) and
  counter-keyed stochastic (a replay of the port's own stream: against
  the JAX package the sampled tokens meet a near-tie rule,
  ``tests/test_torch_sampling.py``);
- a bounded queue that overflows and still delivers every token
  (:215), a consumer thread's iterator (:232), the callback (:253), an
  unknown uid and a disabled stream (:266);
- cancellation while queued, between prefill chunks, with a launch in
  flight, of a full pool then refilled, and mid-prefill in a
  disaggregated server's prefill pool (:281-407), each beside the JAX
  server driven the same way, audited every step.

``tests/test_torch_overload.py`` twins the double cancel.  The fleet
streams, SSE and the router's failover wait for the router and the ops
plane.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving.streaming import StreamBroker as JaxStreamBroker
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer, SamplingParams, reasons
from apex_tpu_torch.serving.streaming import StreamBroker

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

# the one reference layer the port does not have yet
JAX_FLAGS = dict(enable_program_accounting=False)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


def _kw(kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_context", 128)
    kw.setdefault("block_size", 8)
    return kw


def _port(tiny, **kw):
    cfg, sd, _, _ = tiny
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           **_kw(kw))


def _jax(tiny, **kw):
    _, _, jcfg, jparams = tiny
    return JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                              attention_fn=jax_make_flash(causal=True),
                              **_kw(kw), **JAX_FLAGS)


def _pair(tiny, **kw):
    """(JAX server, port server) with the same flags."""
    return _jax(tiny, **kw), _port(tiny, **kw)


def _prompts(seed, n, lo=4, hi=12):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, VOCAB, size=int(rng.randint(lo, hi))))
            for _ in range(n)]


def _run_audited(server):
    while server.has_work:
        server.step()
        server.audit()


# -- the broker alone: the port's and the reference's ----------------------


class FakeReq:
    def __init__(self):
        self.generated = []
        self.finished = False
        self.finish_reason = None


def _order_dedup_and_terminal(Broker):
    b = Broker()
    req = FakeReq()
    s = b.open(7, req)
    same = b.open(7, req) is s
    for i, tok in enumerate([10, 11, 12]):
        req.generated.append(tok)
        b.publish(7, i, tok)
    b.publish(7, 0, 10)            # a replay: already fanned out
    b.publish(7, 1, 11)
    first = s.drain()
    published = b.published_tokens
    req.finished, req.finish_reason = True, reasons.LENGTH
    b.finish(7, reasons.LENGTH)
    return same, first, published, s.drain(), s.done, s.finish_reason, \
        b.active


def _bounded_queue(Broker):
    b = Broker(queue_tokens=2)
    req = FakeReq()
    s = b.open(1, req)
    for i in range(6):             # nobody draining: 4 must drop
        req.generated.append(30 + i)
        b.publish(1, i, 30 + i)
    return b.backpressure_drops, s.drops, s.drain()


def _late_open(Broker):
    b = Broker()
    req = FakeReq()
    req.generated = [5, 6, 7]
    req.finished, req.finish_reason = True, reasons.EOS
    s = b.open(3, req)             # opened after the request finished
    return s.drain(), s.finish_reason


def _callback(Broker):
    b = Broker(queue_tokens=1)
    req = FakeReq()
    events = []
    b.open(9, req, callback=lambda kind, v: events.append((kind, v)))
    for i in range(5):
        req.generated.append(40 + i)
        b.publish(9, i, 40 + i)    # delivered inline: the bound bypassed
    req.finished, req.finish_reason = True, reasons.LENGTH
    b.finish(9, reasons.LENGTH)
    return events, b.backpressure_drops


def _close_and_snapshot(Broker):
    b = Broker()
    req = FakeReq()
    s = b.open(4, req)
    req.generated.append(1)
    b.publish(4, 0, 1)
    rows = b.snapshot()
    s.close()
    s.close()                      # idempotent
    active = b.active
    b.publish(4, 1, 2)             # a publish after close: a no-op
    return rows, active, b.published_tokens, b.stats()


BROKER_SCENARIOS = {
    "order_dedup_and_terminal": (
        _order_dedup_and_terminal,
        (True, [10, 11, 12], 3, [], True, reasons.LENGTH, 0)),
    "bounded_queue_drops_oldest_and_backfills": (
        _bounded_queue, (4, 4, [30, 31, 32, 33, 34, 35])),
    "late_open_backfills_everything": (
        _late_open, ([5, 6, 7], reasons.EOS)),
    "callback_streams_never_drop": (
        _callback, ([("token", 40), ("token", 41), ("token", 42),
                     ("token", 43), ("token", 44), ("end", reasons.LENGTH)],
                    0)),
}


@pytest.mark.parametrize("name", sorted(BROKER_SCENARIOS))
def test_broker_matches_the_reference(name):
    scenario, want = BROKER_SCENARIOS[name]
    assert scenario(StreamBroker) == scenario(JaxStreamBroker) == want


def test_broker_close_detaches_and_snapshot_rows():
    got = _close_and_snapshot(StreamBroker)
    assert got == _close_and_snapshot(JaxStreamBroker)
    rows, active, published, _ = got
    assert rows == [{"key": 4, "delivered": 0, "queued": 1, "drops": 0,
                     "terminal": None}]
    assert active == 0 and published == 1


def test_broker_refuses_an_empty_queue():
    for Broker in (StreamBroker, JaxStreamBroker):
        with pytest.raises(ValueError, match="queue_tokens"):
            Broker(queue_tokens=0)


def test_broker_under_contention_delivers_every_token():
    """More consumer threads than cores iterate their streams while the
    publisher fans 100 tokens each through 4-token queues, with the
    interpreter switching threads as often as it can: every stream
    delivers exactly its request's tokens and terminal."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b = StreamBroker(queue_tokens=4, iter_wait_s=5.0)
        reqs = [FakeReq() for _ in range((os.cpu_count() or 1) + 2)]
        streams = [b.open(i, r) for i, r in enumerate(reqs)]
        got = [[] for _ in reqs]
        threads = [threading.Thread(target=g.extend, args=(s,), daemon=True)
                   for s, g in zip(streams, got)]
        for t in threads:
            t.start()
        for tok in range(100):
            for i, r in enumerate(reqs):
                r.generated.append(tok)
                b.publish(i, tok, tok)
        for i, r in enumerate(reqs):
            r.finished, r.finish_reason = True, reasons.LENGTH
            b.finish(i, reasons.LENGTH)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == [list(range(100))] * len(reqs)
    assert all(s.finish_reason == reasons.LENGTH for s in streams)
    assert b.active == 0


# -- one server: delivery byte identity ------------------------------------


def test_stream_byte_identity_greedy(tiny):
    """Six requests streamed and drained after every step: each stream
    is its request's tokens, which are the JAX server's."""
    prompts = _prompts(0, 6)
    jsrv = _jax(tiny)
    jreqs = [jsrv.submit(p, 24) for p in prompts]
    _run_audited(jsrv)
    server = _port(tiny)
    reqs = [server.submit(p, 24) for p in prompts]
    streams = [server.stream(r.uid) for r in reqs]
    got = [[] for _ in reqs]
    while server.has_work:
        server.step()
        server.audit()
        for i, s in enumerate(streams):
            got[i].extend(s.drain())
    for i, (r, jr, s) in enumerate(zip(reqs, jreqs, streams)):
        got[i].extend(s.drain())
        assert got[i] == list(r.generated) == list(jr.generated)
        assert s.finish_reason == r.finish_reason == jr.finish_reason
    assert server.stream_broker.active == 0


def test_stream_byte_identity_stochastic(tiny):
    """Counter-keyed sampling makes each sampled stream a function of
    (prompt, params, seed): streaming a replay delivers the first pass's
    tokens exactly."""
    server = _port(tiny)
    prompts = _prompts(1, 4)
    samp = [SamplingParams(temperature=0.8, top_p=0.9, seed=i + 1)
            for i in range(len(prompts))]
    ref = server.generate(prompts, max_new_tokens=20, sampling=samp)
    reqs = [server.submit(p, 20, sampling=sp)
            for p, sp in zip(prompts, samp)]
    streams = [server.stream(r.uid) for r in reqs]
    got = [[] for _ in reqs]
    while server.has_work:
        server.step()
        server.audit()
        for i, s in enumerate(streams):
            got[i].extend(s.drain())
    for i, (r, s) in enumerate(zip(reqs, streams)):
        got[i].extend(s.drain())
        assert got[i] == list(r.generated) == ref[i]


def test_stream_backpressure_still_byte_identical(tiny):
    """A consumer that reads only at the end overflows a 2-token queue:
    the drops are counted, the drain backfills every token, and the
    streams block equals the JAX server's."""
    jsrv, server = _pair(tiny, stream_queue_tokens=2)
    outs = []
    for srv in (jsrv, server):
        req = srv.submit([1, 2, 3], 24)
        s = srv.stream(req)
        _run_audited(srv)
        assert len(req.generated) > 2
        assert s.drain() == list(req.generated)
        assert s.drops > 0
        st = srv.stats()["streams"]
        assert st["backpressure_drops"] == s.drops
        outs.append((list(req.generated), st))
    assert outs[0] == outs[1]


def test_stream_iterator_surface_from_consumer_thread(tiny):
    server = _port(tiny)
    req = server.submit([3, 1, 4, 1], 16)
    stream = server.stream(req.uid)
    got, done = [], threading.Event()

    def consume():
        for tok in stream:
            got.append(tok)
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    _run_audited(server)
    assert done.wait(timeout=30.0), "the iterator never saw the terminal"
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got == list(req.generated) and len(got) == 16
    assert stream.finish_reason == req.finish_reason


def test_stream_callback_surface(tiny):
    server = _port(tiny)
    req = server.submit([9, 8, 7], 12)
    events = []
    server.stream(req, callback=lambda k, v: events.append((k, v)))
    _run_audited(server)
    assert events[-1] == ("end", req.finish_reason)
    assert [v for k, v in events if k == "token"] == list(req.generated)


def test_stream_unknown_uid_and_disabled(tiny):
    server = _port(tiny)
    with pytest.raises(KeyError):
        server.stream(10**9)
    off = _port(tiny, enable_streaming=False)
    r = off.submit([1, 2], 4)
    with pytest.raises(RuntimeError, match="enable_streaming"):
        off.stream(r.uid)
    _run_audited(off)
    st = off.stats()["streams"]
    assert st == {"enabled": False, "cancelled": 0}


# -- cancellation, beside the JAX server driven the same way ----------------


def _cancel_while_queued(server):
    reqs = [server.submit(p, 16) for p in _prompts(2, 4)]
    server.step()                  # admit 2, leave 2 queued
    server.audit()
    queued = [r for r in reqs if not r.running and not r.finished]
    assert queued, "expected queued overflow"
    victim = queued[0]
    assert not victim.generated
    assert server.cancel(victim.uid) is True
    server.audit()
    _run_audited(server)
    return [(list(r.generated), r.finish_reason) for r in reqs]


def _cancel_between_chunks(server):
    long_prompt = list(np.random.RandomState(3).randint(0, VOCAB, size=40))
    req = server.submit(long_prompt, 8)
    server.step()                  # the first chunk only (40 > 8)
    server.audit()
    assert not req.finished and not req.generated
    assert server.stats()["memory"]["blocks_live"] > 0
    assert server.cancel(req.uid) is True
    server.audit()
    assert server.stats()["memory"]["blocks_live"] == 0
    _run_audited(server)
    return req.finish_reason


def _cancel_in_flight(server):
    req = server.submit([2, 7, 1, 8], 100)
    for _ in range(2):
        server.step()
        server.audit()
    assert not req.finished
    assert server.cancel(req.uid) is True
    server.audit()
    n = len(req.generated)
    _run_audited(server)
    assert len(req.generated) == n, "a token applied after the cancel"
    return list(req.generated), req.finish_reason


def _cancel_reclaims(server):
    first = [server.submit(p, 60) for p in _prompts(4, 2)]
    streams = [server.stream(r) for r in first]
    for _ in range(3):
        server.step()
        server.audit()
    for s, r in zip(streams, first):
        s.close()
        assert server.cancel(r.uid) is True
    server.audit()
    assert server.stats()["memory"]["blocks_live"] == 0
    second = [server.submit(p, 16) for p in _prompts(5, 2)]
    _run_audited(server)
    return [(list(r.generated), r.finish_reason) for r in first + second]


def _cancel_mid_prefill_disagg(server):
    long_prompt = list(np.random.RandomState(6).randint(0, VOCAB, size=40))
    req = server.submit(long_prompt, 8)
    server.step()
    server.audit()
    assert not req.finished
    assert server.stats()["disagg"]["prefill_blocks_live"] > 0
    assert server.cancel(req.uid) is True
    server.audit()
    st = server.stats()
    assert st["memory"]["blocks_live"] == 0
    assert st["disagg"]["prefill_blocks_live"] == 0
    _run_audited(server)
    return req.finish_reason, st["disagg"]


BPS = -(-128 // 8)                 # blocks a full context

CANCELS = {
    "while_queued": (_cancel_while_queued, dict(max_batch_size=2)),
    "between_prefill_chunks": (_cancel_between_chunks,
                               dict(prefill_chunk=8, enable_pipeline=False)),
    "during_inflight_launch": (_cancel_in_flight,
                               dict(enable_pipeline=True)),
    "reclaims_capacity": (_cancel_reclaims,
                          dict(max_batch_size=2, num_blocks=2 * BPS + 1)),
    "mid_prefill_on_disagg_server": (
        _cancel_mid_prefill_disagg,
        dict(enable_disagg=True, prefill_chunk=8, enable_pipeline=False)),
}


@pytest.mark.parametrize("name", sorted(CANCELS))
def test_cancel(tiny, name):
    """Each cancel frees the request's blocks at once and finishes it
    ``"cancelled"``; the others run on to a healthy finish.  The port's
    tokens, reasons and cancellation count are the JAX server's."""
    scenario, kw = CANCELS[name]
    jsrv, server = _pair(tiny, **kw)
    want = scenario(jsrv)
    assert scenario(server) == want
    assert server.stats()["streams"]["cancelled"] == \
        jsrv.stats()["streams"]["cancelled"] >= 1
    ends = {r.finish_reason for r in server.scheduler.finished}
    assert ends <= {reasons.CANCELLED, *reasons.HEALTHY_REASONS}
