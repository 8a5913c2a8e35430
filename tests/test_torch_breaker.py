"""The port's circuit breaker and transient-OOM retry against apex_tpu's.

- ``resilience.CircuitBreaker`` against ``apex_tpu.resilience``'s on
  seeded random event sequences (allow, success, failure with and
  without a backdated ``now``, clock advances, state reads and
  snapshots, ``half_open_backoff`` with a seeded ``rng``): every return
  value, state, snapshot and counter is equal.
- Twins of ``tests/L0/test_overload.py:183, 222, 341``: the transitions
  on an injected clock (run on both classes), the breaker guarding
  ``submit`` and recovering (held against the JAX server's finish
  reasons and breaker counters), and the transient engine OOM retried
  bit for bit, raised as ``MemoryError`` and as
  ``torch.OutOfMemoryError`` in both loops.  The reference injects into
  ``engine.decode``, the logits step its synchronous loop calls; the
  port's synchronous loop samples on the device, so its twins inject
  into ``engine.decode_sampled``, which both of its loops call.
- A failure seen at the pipelined retire is anchored at its launch
  clock, a sustained OOM burst opens the breaker, and an error that is
  not an OOM is not swallowed.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.resilience import CircuitBreaker as JaxCircuitBreaker
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.utils import CounterMeter as JaxCounterMeter
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.resilience import CircuitBreaker
from apex_tpu_torch.serving import InferenceServer, reasons
from apex_tpu_torch.utils.meters import CounterMeter

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
JAX_FLAGS = dict(enable_program_accounting=False)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
GEOMETRY = dict(max_batch_size=2, max_context=64, block_size=8,
                enable_speculation=False)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params, the JAX server's
    undisturbed tokens of ``PROMPTS`` on ``GEOMETRY`` in its
    synchronous loop)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    want = _jax_server(jcfg, jparams, enable_pipeline=False).generate(
        PROMPTS, max_new_tokens=10)
    return cfg, sd, jcfg, jparams, want


def _jax_server(jcfg, jparams, **kw):
    return JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                              attention_fn=jax_make_flash(causal=True),
                              **{**GEOMETRY, **kw}, **JAX_FLAGS)


def _server(tiny, **kw):
    cfg, sd = tiny[:2]
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           **{**GEOMETRY, **kw})


# -- the breaker against the reference's, event by event -----------------

def _pair(seed, clock):
    rng = random.Random(seed)
    recovery = rng.choice([0.0, 1.0, 2.5, 10.0])
    kw = dict(failure_threshold=rng.randint(1, 4), recovery_time=recovery,
              probe_successes=rng.randint(1, 3),
              probe_quota=rng.choice([None, 1, 2, 4]),
              half_open_backoff=rng.choice([None, recovery * 4 + 1.0]))
    return (CircuitBreaker(rng=random.Random(seed), clock=clock,
                           counters=CounterMeter(), **kw),
            JaxCircuitBreaker(rng=random.Random(seed), clock=clock,
                              counters=JaxCounterMeter(), **kw))


@pytest.mark.parametrize("seed", range(8))
def test_breaker_matches_reference_on_seeded_events(seed):
    t = {"now": 0.0}
    mine, ref = _pair(seed, lambda: t["now"])
    rng = random.Random(1000 + seed)
    for i in range(400):
        op = rng.choice(["allow", "allow", "success", "failure", "failure",
                         "failure_at", "advance", "state", "snapshot"])
        if op == "advance":
            t["now"] += rng.choice([0.5, 1.0, 3.0, 12.0])
            continue
        if op == "failure_at":
            at = t["now"] - rng.choice([0.0, 0.5, 2.0])
            got = (mine.record_failure(at), ref.record_failure(at))
        elif op == "state":
            got = (mine.state, ref.state)
        elif op == "snapshot":
            got = (mine.state_snapshot(), ref.state_snapshot())
        else:
            name = {"allow": "allow", "success": "record_success",
                    "failure": "record_failure"}[op]
            got = (getattr(mine, name)(), getattr(ref, name)())
        assert got[0] == got[1], (i, op, got)
        assert mine._state == ref._state, (i, op)
        assert mine.counters.as_dict() == ref.counters.as_dict(), (i, op)
    mine.reset()
    ref.reset()
    assert mine.state_snapshot() == ref.state_snapshot()


def test_breaker_validates_like_reference():
    for kw in (dict(failure_threshold=0), dict(recovery_time=-1.0),
               dict(probe_successes=0),
               dict(recovery_time=5.0, half_open_backoff=1.0)):
        with pytest.raises(ValueError) as mine:
            CircuitBreaker(**kw)
        with pytest.raises(ValueError) as ref:
            JaxCircuitBreaker(**kw)
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("klass", [CircuitBreaker, JaxCircuitBreaker],
                         ids=["port", "jax"])
def test_breaker_transitions_on_injected_clock(klass):
    clock = {"t": 0.0}
    br = klass(failure_threshold=3, recovery_time=10.0, probe_successes=2,
               clock=lambda: clock["t"])
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    br.record_success()               # a success resets the streak
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()               # the third in a row trips it
    assert br.state == "open" and not br.allow()
    clock["t"] = 9.99
    assert br.state == "open"
    clock["t"] = 10.0                 # the cooldown elapsed: probing
    assert br.state == "half_open"
    assert br.allow() and br.allow()  # the quota is probe_successes
    assert not br.allow()
    br.record_success()
    assert br.state == "half_open"
    br.record_success()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    br.record_failure()
    clock["t"] = 20.0
    assert br.state == "half_open" and br.allow()
    br.record_failure()               # a probe failure re-opens at once
    assert br.state == "open"
    clock["t"] = 25.0
    assert br.state == "open"         # the cooldown restarted at 20
    clock["t"] = 30.0
    assert br.state == "half_open"


# -- the breaker in front of submit ---------------------------------------

def _guard_and_recover(server, poison):
    """The reference scenario: three requests go non-finite and open the
    breaker, a submit is fast-rejected, and after the cooldown a
    healthy probe closes it."""
    doomed = [server.submit(p, 6) for p in ([3, 1, 4, 1], [5, 9, 2, 6],
                                            [2, 7, 1, 8])]
    while server.has_work:
        server.step()
    assert all(r.finish_reason == reasons.NONFINITE for r in doomed)
    assert server.breaker.state == "open"
    fast = server.submit([1, 2, 3], 6)
    assert fast.finish_reason == reasons.BREAKER_OPEN
    assert fast.generated == [] and fast.finished_at is not None
    assert server.scheduler.num_waiting == 0
    poison["on"] = False
    return fast


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_breaker_guards_submit_and_recovers(tiny, pipeline):
    cfg, sd, jcfg, jparams, _ = tiny
    ends = []
    for port in (True, False):
        clock = {"t": 0.0}
        kw = dict(failure_threshold=3, recovery_time=10.0,
                  clock=lambda: clock["t"])
        breaker = CircuitBreaker(**kw) if port else JaxCircuitBreaker(**kw)
        poison = {"on": True}
        if port:
            server = _server(tiny, max_batch_size=4, breaker=breaker,
                             enable_pipeline=pipeline,
                             clock=lambda: clock["t"])
            orig = server.engine.decode_sampled

            def decode(*args, **kw):
                ids, fin = orig(*args, **kw)
                return ids, fin & (not poison["on"])

            server.engine.decode_sampled = decode
        else:
            # the reference's own injection: NaN logits out of the
            # logits step of its synchronous loop
            server = _jax_server(jcfg, jparams, max_batch_size=4,
                                 breaker=breaker, enable_pipeline=False,
                                 clock=lambda: clock["t"])
            orig = server.engine.decode

            def decode(tokens, positions, tables):
                out = np.array(orig(tokens, positions, tables))
                if poison["on"]:
                    out[:] = np.nan
                return out

            server.engine.decode = decode
        _guard_and_recover(server, poison)
        clock["t"] = 10.0
        probe = server.submit([1, 2, 3], 6)
        assert not probe.finished
        while server.has_work:
            server.step()
        assert probe.finish_reason == reasons.LENGTH
        assert len(probe.generated) == 6
        assert breaker.state == "closed"
        st = server.stats()
        assert st["breaker_state"] == "closed"
        failed = {k.replace("requests_failed_", ""): v
                  for k, v in st["requests_failed"].items() if v}
        ends.append((failed, st["breaker_events"], probe.generated))
    assert ends[0] == ends[1]
    assert ends[0][0] == {"nonfinite": 3, "breaker_open": 1}
    assert ends[0][1]["breaker_rejections"] == 1
    assert ends[0][1]["breaker_opened"] == 1


def test_default_breaker_counts_into_stats(tiny):
    server = _server(tiny)
    assert isinstance(server.breaker, CircuitBreaker)
    assert server.breaker.counters is server.breaker_events
    server.reset_meters()
    assert server.breaker.counters is server.breaker_events
    own = CounterMeter()
    mine = _server(tiny, breaker=CircuitBreaker(counters=own))
    assert mine.breaker.counters is own
    off = _server(tiny, enable_breaker=False)
    assert off.breaker is None
    st = off.stats()
    assert st["breaker_state"] == "disabled" and st["breaker_events"] == {}


def test_retire_failure_is_anchored_at_launch(tiny):
    """A non-finite row seen at the pipelined retire trips the breaker
    with its cooldown anchored at the launch clock, the trajectory the
    synchronous loop gives."""
    clock = {"t": 0.0}
    opened = []
    for pipeline in (False, True):
        clock["t"] = 0.0
        breaker = CircuitBreaker(failure_threshold=1, recovery_time=10.0,
                                 clock=lambda: clock["t"])
        server = _server(tiny, breaker=breaker, enable_pipeline=pipeline,
                         clock=lambda: clock["t"])
        orig = server.engine.decode_sampled

        def decode(*args, **kw):
            ids, fin = orig(*args, **kw)
            return ids, fin & False

        server.engine.decode_sampled = decode
        server.submit([3, 1, 4, 1], 6)
        while server.has_work:
            server.step()
            clock["t"] += 4.0
        opened.append(breaker.state_snapshot()["transitions"]["opened"])
        # the decode launched at 0.0; the pipelined retire sees its
        # failure at 4.0 and anchors the cooldown at 0.0 all the same
        clock["t"] = 9.9
        assert breaker.state == "open"
        clock["t"] = 10.0
        assert breaker.state == "half_open", pipeline
    assert opened == [1, 1]


# -- the transient-OOM retry ------------------------------------------------

@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("error", [MemoryError, torch.OutOfMemoryError],
                         ids=lambda e: e.__name__)
def test_transient_engine_oom_is_retried_bit_exactly(tiny, error, pipeline):
    want = tiny[4]
    server = _server(tiny, enable_pipeline=pipeline)
    orig = server.engine.decode_sampled
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] in (2, 3):      # a two-iteration burst
            raise error("injected allocation burst")
        return orig(*args, **kw)

    server.engine.decode_sampled = flaky
    assert server.generate(PROMPTS, max_new_tokens=10) == want
    st = server.stats()
    assert st["oom_events"] == 2 and st["requests_failed_total"] == 0
    assert st["breaker_state"] == "closed"
    server.scheduler.audit()


def test_sustained_oom_opens_the_breaker(tiny):
    server = _server(tiny)
    server.submit(PROMPTS[0], 4)

    def oom(*args, **kw):
        raise torch.OutOfMemoryError("injected allocation burst")

    server.engine.decode_sampled = oom
    for _ in range(5):               # the default threshold
        server.step()
    st = server.stats()
    assert st["oom_events"] == 5 and st["breaker_state"] == "open"
    assert server.submit([1, 2, 3], 4).finish_reason == reasons.BREAKER_OPEN


def test_other_errors_are_not_swallowed(tiny):
    server = _server(tiny)
    server.submit(PROMPTS[0], 4)

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    server.engine.decode_sampled = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        for _ in range(3):
            server.step()
    assert server.stats()["oom_events"] == 0
