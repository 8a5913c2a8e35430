"""The port's pipelined serve loop against apex_tpu's.

Twins of ``tests/L0/test_pipeline.py:123-421``: dispatch-ahead must be a
reordering of the synchronous loop, never a different computation.

- The JAX server with the pipeline on (its default; program
  accounting off, the layer the port does not have) runs each
  undisturbed scenario once, in a module fixture: 64 tokens on two
  requests, forced preemption, forced prefix eviction, speculation on
  and off.  The port's pipelined and synchronous loops give its tokens
  byte for byte.  The 64-token run is also held against a full
  recompute of the port's model.
- Each perturbed port run — a mid-stream drain, an OOM at a decode
  launch, a verify launch or a prefill chunk (raised as ``MemoryError``
  and as ``torch.OutOfMemoryError``), a poisoned finite flag — is held
  against the port's own undisturbed run of the same scenario, which
  the first group holds against the JAX server.
- The in-flight hold and ``audit``, the lookahead bound while a window
  is pending, a custom ``sample_fn`` falling back to the synchronous
  loop, and the ``stats()["pipeline"]`` keys and counts.  The flight
  record's half of ``test_pipeline.py:396`` waits for the flight
  recorder, and the compile-count audit (``:428``) has no eager twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving import SamplingParams as JaxSamplingParams
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from apex_tpu_torch.serving import InferenceServer, Request, SamplingParams
from apex_tpu_torch.serving import api as port_api

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

# the reference's layer the port does not have yet; every other layer
# (pipeline and breaker included) stays at the reference's default
JAX_FLAGS = dict(enable_program_accounting=False)

OOMS = (MemoryError, torch.OutOfMemoryError)

_rng = np.random.RandomState(7)
_SHARED = list(_rng.randint(0, VOCAB, size=12))

# name -> (prompts, new tokens, server kwargs): the undisturbed scenarios
SCENARIOS = {
    "two_64": ([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]], 64,
               dict(max_batch_size=2, max_context=128, block_size=8)),
    "preemption": ([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8],
                    [9, 9, 8, 7, 6, 5, 4, 3]], 24,
                   dict(max_batch_size=3, max_context=64, block_size=4,
                        num_blocks=10)),
    "eviction": ([_SHARED + list(_rng.randint(0, VOCAB, size=4))
                  for _ in range(4)], 16,
                 dict(max_batch_size=2, max_context=64, block_size=4,
                      num_blocks=14)),
    "spec_on": ([[1, 2, 3, 1, 2, 3, 1, 2], [5, 9, 2, 6, 5, 3, 5, 8]], 32,
                dict(max_batch_size=2, max_context=128, block_size=8,
                     enable_speculation=True)),
    "spec_off": ([[1, 2, 3, 1, 2, 3, 1, 2], [5, 9, 2, 6, 5, 3, 5, 8]], 32,
                 dict(max_batch_size=2, max_context=128, block_size=8,
                      enable_speculation=False)),
}


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, {scenario: JAX tokens})."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    want = {}
    for name, (prompts, n, kw) in SCENARIOS.items():
        server = JaxInferenceServer(
            jcfg, jparams, cache_dtype=jnp.float32,
            attention_fn=jax_make_flash(causal=True), **kw, **JAX_FLAGS)
        assert server.pipelining
        want[name] = _drive(server, prompts, n,
                            sampling=JaxSamplingParams())
    return cfg, sd, want


def _server(tiny, pipeline=True, **kw):
    cfg, sd, _ = tiny
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           enable_pipeline=pipeline, **kw)


def _drive(server, prompts, n, **kw):
    reqs = [server.submit(p, n, **kw) for p in prompts]
    while server.has_work:
        server.step()
        server.scheduler.audit()
    return [list(r.generated) for r in reqs]


def _run(tiny, name, pipeline=True, **extra):
    """(tokens, server) of the port on scenario ``name``."""
    prompts, n, kw = SCENARIOS[name]
    server = _server(tiny, pipeline, **kw, **extra)
    return _drive(server, prompts, n), server


# -- parity: pipelined == synchronous == the JAX server -------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipelined_and_synchronous_match_jax(tiny, name):
    want = tiny[2][name]
    got, server = _run(tiny, name)
    sync, sync_server = _run(tiny, name, pipeline=False)
    assert got == want, name
    assert sync == want, name
    assert server.pipelining and not sync_server.pipelining
    st = server.stats()
    if name == "preemption":
        assert st["preemptions"] >= 1 and \
            st["preemptions"] == sync_server.stats()["preemptions"]
    if name == "eviction":
        assert st["prefix_evicted_blocks"] >= 1
    if name == "spec_on":
        assert st["verify_steps"] > 0
    if name == "spec_off":
        assert st["verify_steps"] == 0
    for key in ("decode_steps", "verify_steps", "prefill_chunks"):
        assert st[key] == sync_server.stats()[key], key


def test_64_tokens_match_full_recompute(tiny):
    """The 64-token run against the port's model recomputing every
    prefix (greedy argmax of the last position)."""
    cfg, sd, want = tiny
    prompts, n, _ = SCENARIOS["two_64"]
    model = GPTLMHeadModel(cfg, device="cpu", seed=None)
    model.load_state_dict(sd)
    for prompt, got in zip(prompts, want["two_64"]):
        toks = list(prompt)
        with torch.no_grad():
            for _ in range(n):
                logits = model(torch.tensor([toks]))[0, -1]
                toks.append(int(torch.argmax(logits)))
        assert len(got) == n and got == toks[len(prompt):]


def test_stochastic_pipelined_equals_synchronous(tiny):
    """Counter-keyed stochastic streams, speculation on: the pipelined
    loop samples the same rows with the same counters."""
    prompts, n, kw = SCENARIOS["spec_on"]
    samp = [SamplingParams(temperature=0.8, top_k=20, seed=5),
            SamplingParams(temperature=1.0, top_p=0.9, seed=6)]
    outs = []
    for pipeline in (True, False):
        server = _server(tiny, pipeline, **kw)
        reqs = [server.submit(p, n, sampling=s) for p, s in zip(prompts,
                                                                samp)]
        while server.has_work:
            server.step()
        outs.append([list(r.generated) for r in reqs])
    assert outs[0] == outs[1]
    assert outs[0] != tiny[2]["spec_on"]


# -- perturbed runs against the port's undisturbed one ---------------------

def test_midstream_drain_is_bit_exact(tiny):
    prompts, _, kw = SCENARIOS["two_64"]
    want = [w[:24] for w in tiny[2]["two_64"]]
    server = _server(tiny, **kw)
    reqs = [server.submit(p, 24) for p in prompts]
    for _ in range(6):
        server.step()
    assert server.stats()["pipeline"]["pending"] == 1
    server.drain()
    assert all(r.finished for r in reqs)
    assert [list(r.generated) for r in reqs] == want
    st = server.stats()
    assert st["pipeline"]["pending"] == 0 and st["draining"] is True


def _flaky(orig, calls, on):
    def call(*args, **kw):
        calls.append(1)
        if len(calls) in on:
            raise on[len(calls)]("injected allocation burst")
        return orig(*args, **kw)
    return call


@pytest.mark.parametrize("error", OOMS, ids=lambda e: e.__name__)
@pytest.mark.parametrize("site,name", [("decode_sampled", "spec_off"),
                                       ("verify_sampled", "two_64"),
                                       ("chunk_prefill_sampled", "two_64")])
def test_launch_oom_retries_bit_identically(tiny, site, name, error):
    """An OOM at the second and third decode or verify launch, or at
    the first prefill chunk: the call is skipped (a verify's lookahead
    rolls back), the window launched before it retires cleanly, and the
    retry gives the undisturbed tokens."""
    want = tiny[2][name]
    prompts, n, kw = SCENARIOS[name]
    server = _server(tiny, **kw)
    calls = []
    on = {1: error} if site == "chunk_prefill_sampled" else {2: error,
                                                             3: error}
    setattr(server.engine, site, _flaky(getattr(server.engine, site),
                                        calls, on))
    assert _drive(server, prompts, n) == want
    st = server.stats()
    assert st["oom_events"] == len(on) and len(calls) > max(on)
    assert st["requests_failed_total"] == 0
    assert st["breaker_state"] == "closed"
    assert st["pipeline"]["launches"] == st["pipeline"]["retired_behind"]
    assert st["pipeline"]["launches"] == st["decode_steps"] + \
        st["verify_steps"]


def test_oom_classes_are_exactly_memory_and_cuda_allocator_errors():
    assert port_api.OOM_ERRORS == (MemoryError, torch.OutOfMemoryError)
    assert issubclass(torch.OutOfMemoryError, RuntimeError)
    assert not issubclass(torch.OutOfMemoryError, MemoryError)


def test_finite_flag_poison_evicts_only_its_request(tiny):
    """Flipping one slot's finite flag on the third decode launch fails
    exactly that request at retire; the other finishes bit for bit."""
    want = tiny[2]["spec_off"]
    prompts, n, kw = SCENARIOS["spec_off"]
    server = _server(tiny, **kw)
    victim = server.submit(prompts[0], n)
    other = server.submit(prompts[1], n)
    orig = server.engine.decode_sampled
    calls = []

    def poisoned(*args, **kw):
        ids, fin = orig(*args, **kw)
        calls.append(1)
        if len(calls) == 3:
            fin = fin.clone()
            fin[victim.slot] = False
        return ids, fin

    server.engine.decode_sampled = poisoned
    while server.has_work:
        server.step()
        server.scheduler.audit()
    assert victim.finish_reason == "nonfinite"
    # the prefill's token and decode launches 1 and 2
    assert victim.generated == want[0][:3]
    assert other.finish_reason == "length" and other.generated == want[1]
    assert server.stats()["breaker_events"] == {}     # one failure: closed


# -- scheduling-state invariants ------------------------------------------

def test_inflight_hold_pins_window_and_audit_checks_it(tiny):
    server = _server(tiny, max_batch_size=2, max_context=64, block_size=8,
                     enable_speculation=False)
    reqs = [server.submit([1, 2, 3], 8), server.submit([4, 5, 6, 7], 8)]
    sched = server.scheduler
    saw_pending = False
    while server.has_work:
        server.step()
        inf = server._inflight
        if inf is not None:
            saw_pending = True
            assert set(sched.inflight) == {r.uid for r in inf.running}
            victim = sched._preempt_victim(exclude=None)
            assert victim is None or victim.uid not in sched.inflight
        sched.audit()
    assert saw_pending and not sched.inflight
    assert all(r.finish_reason == "length" for r in reqs)
    # audit catches a held request that is no longer running
    held = server.submit([1, 2, 3], 4)
    server.step()
    assert sched.inflight
    sched.inflight[-1] = Request(prompt=[1], max_new_tokens=1)
    with pytest.raises(AssertionError, match="no longer running"):
        sched.audit()
    del sched.inflight[-1]
    with pytest.raises(AssertionError, match="already held"):
        sched.hold_inflight([held])


def test_lookahead_bounded_while_window_pending(tiny):
    server = _server(tiny, max_batch_size=2, block_size=4)
    reqs = [server.submit([3, 1, 4, 1, 5], 32),
            server.submit([2, 7, 1, 8], 32)]
    bs = server.engine.block_size
    slack = -(-(server.spec_tokens + 1) // bs) + 1
    while server.has_work:
        server.step()
        server.scheduler.audit()
        for r in server.scheduler.running.values():
            if not r.prefilling:
                assert len(r.block_table) <= r.num_cached // bs + 1 + slack
    assert all(r.finish_reason == "length" for r in reqs)
    usable = server.engine.cache_cfg.num_blocks - 1
    assert server.engine.allocator.num_free \
        + server.prefix_cache.num_evictable == usable


def test_custom_sample_fn_falls_back_to_synchronous_loop(tiny):
    def sample(logits):
        return np.argmax(np.asarray(logits), axis=-1)

    with pytest.warns(UserWarning, match="custom sample_fn"):
        server = _server(tiny, max_batch_size=2, max_context=64,
                         block_size=8, sample_fn=sample)
    assert server.pipelining is False and server.speculating is False
    st = server.stats()
    assert st["pipeline"]["enabled"] is False and st["pipeline"]["depth"] == 0
    assert st["sampling"]["custom_sample_fn"] is True
    out = server.generate([[1, 2, 3]], max_new_tokens=8)[0]
    greedy = _server(tiny, max_batch_size=2, max_context=64,
                     block_size=8).generate([[1, 2, 3]], max_new_tokens=8)[0]
    assert out == greedy and len(out) == 8
    assert server.stats()["pipeline"]["launches"] == 0


def test_pipeline_stats_keys_and_counts(tiny):
    server = _server(tiny, max_batch_size=2, max_context=64, block_size=8)
    server.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=6)
    st = server.stats()["pipeline"]
    assert set(st) == {"enabled", "depth", "launches", "retired_behind",
                       "pending", "host_stall_ms", "host_plan_ms"}
    assert st["enabled"] is True and st["depth"] == 1
    assert st["launches"] >= 1 and st["retired_behind"] == st["launches"]
    assert st["pending"] == 0
    assert st["host_stall_ms"]["count"] == st["retired_behind"]
    assert st["host_plan_ms"]["count"] >= st["launches"]
    assert set(st["host_plan_ms"]) == {"count", "p50", "p90", "p99", "max"}
    # a window pending at reset_meters keeps its tokens (one token a
    # step: speculation off)
    server = _server(tiny, max_batch_size=2, max_context=64, block_size=8,
                     enable_speculation=False)
    req = server.submit([1, 2, 3], 6)
    server.step()
    server.step()
    assert server.stats()["pipeline"]["pending"] == 1
    before = len(req.generated)
    server.reset_meters()
    while server.has_work:
        server.step()
    st = server.stats()
    assert st["tokens_generated"] == 6 - before
    assert st["pipeline"]["host_stall_ms"]["count"] == \
        st["pipeline"]["retired_behind"]
    top = server.stats()
    assert top["breaker_state"] == "closed" and top["oom_events"] == 0
