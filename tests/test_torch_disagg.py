"""The port's disaggregated prefill/decode on one host against apex_tpu's.

Twins of the same-host tests of ``tests/L0/test_disagg.py`` (:75-259):
the port's ``InferenceServer(enable_disagg=True)`` — every prefill in a
second engine with its own pool, finished prefills' blocks copied into
the decode pool — against the JAX server with the same flags, on the
same tiny ``GPTConfig`` from the same seeds.  Tokens are equal exactly,
and both pools pass ``audit()`` after every step.

- parity with the default stack (and with the port's own monolithic
  server), and at the fast-path corners (pipeline and speculation
  toggled);
- the prefill pool as the warm shared-prefix cache, with a
  whole-context hit's copy-on-write;
- hand-offs deferred under a starved decode pool;
- a decode-pool preemption victim that re-prefills through the prefill
  pool;
- torn and delayed hand-off copies (``MemoryError`` and
  ``torch.OutOfMemoryError``), retried whole;
- a drain begun mid-flight;
- ``stats()["disagg"]``, equal to the JAX server's block (its
  ``latency.itl_ms`` waits for the registry), and ``{"enabled":
  False}`` on a monolithic server;
- the refusals of too small a prefill pool and of
  ``prefill_max_concurrent < 1``.

The cross-replica half (``ingest_handoff``, ``handoff_sink``) and
``evacuate`` come with the router.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
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


def _kw(disagg, kw):
    kw.setdefault("max_batch_size", 3)
    kw.setdefault("max_context", 64)
    kw.setdefault("block_size", 4)
    if disagg:
        kw.setdefault("disagg_prefill_blocks", 20)
    return kw


def _port(tiny, disagg, **kw):
    cfg, sd, _, _ = tiny
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           enable_disagg=disagg, **_kw(disagg, kw))


def _jax(tiny, disagg, **kw):
    _, _, jcfg, jparams = tiny
    return JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                              attention_fn=jax_make_flash(causal=True),
                              enable_disagg=disagg, **_kw(disagg, kw),
                              **JAX_FLAGS)


def _prompts(seed=0, n=6):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, VOCAB, size=int(rng.randint(2, 24))))
            for _ in range(n)]


def _audited_generate(server, prompts, max_new, eos_id=None):
    reqs = [server.submit(p, max_new, eos_id) for p in prompts]
    while server.has_work:
        server.step()
        server.audit()
    return [list(r.generated) for r in reqs]


def test_disagg_parity_vs_jax_and_monolithic(tiny):
    """12 tokens a request through the two pools with the default stack
    (pipelined, speculating), audited every step: the JAX server's
    tokens and the port's monolithic server's, and every surviving
    multi-token request moved pools."""
    prompts = _prompts(0)
    want = _audited_generate(_jax(tiny, True), prompts, 12, eos_id=7)
    srv = _port(tiny, True)
    got = _audited_generate(srv, prompts, 12, eos_id=7)
    assert got == want
    assert _audited_generate(_port(tiny, False), prompts, 12,
                             eos_id=7) == want
    st = srv.stats()["disagg"]
    assert st["enabled"] is True and st["handoff"]["requests"] >= 1
    assert st["handoff"]["pending"] == 0


@pytest.mark.parametrize("pipeline,speculation", [(True, False),
                                                  (False, True),
                                                  (False, False)])
def test_disagg_parity_across_fast_path_corners(tiny, pipeline,
                                                speculation):
    prompts = _prompts(1, n=4)
    kw = dict(enable_pipeline=pipeline, enable_speculation=speculation)
    want = _audited_generate(_jax(tiny, True, **kw), prompts, 10)
    srv = _port(tiny, True, **kw)
    assert _audited_generate(srv, prompts, 10) == want
    assert srv.pipelining is pipeline and srv.speculating is speculation


def test_disagg_shared_prefix_cow_and_cache_retention(tiny):
    """Handed-off blocks stay as evictable holds in the prefill pool; a
    repeat submission hits them, the whole-context hit copies its last
    block; the prefix keys and the disagg block are the JAX server's."""
    shared = list(range(1, 13))          # 3 full blocks at bs=4
    prompts = [shared + [20 + i] for i in range(4)] + [shared, shared]
    jsrv = _jax(tiny, True)
    want = _audited_generate(jsrv, prompts, 8)
    srv = _port(tiny, True)
    assert _audited_generate(srv, prompts, 8) == want
    st, jst = srv.stats(), jsrv.stats()
    assert st["prefix_hit_requests"] >= 1 and st["prefix_cow_blocks"] >= 1
    assert st["disagg"]["prefill_blocks_evictable"] >= 1
    assert st["memory"]["blocks_evictable"] == 0
    for key in ("prefix_hit_tokens", "prefix_miss_tokens",
                "prefix_hit_requests", "prefix_cow_blocks",
                "kv_blocks_cached", "kv_blocks_evictable"):
        assert st[key] == jst[key], key
    assert st["disagg"] == jst["disagg"]


def test_disagg_handoff_defers_until_decode_pool_has_room(tiny):
    """A decode pool of 2 slots and 15 blocks defers hand-offs; the
    queue drains first in first out as slots free, with the JAX
    server's tokens and hand-off counters."""
    prompts = _prompts(2)
    kw = dict(max_batch_size=2, num_blocks=16)
    jsrv = _jax(tiny, True, **kw)
    want = _audited_generate(jsrv, prompts, 10)
    srv = _port(tiny, True, **kw)
    assert _audited_generate(srv, prompts, 10) == want
    handoff = srv.stats()["disagg"]["handoff"]
    assert handoff.get("deferred", 0) >= 1
    assert handoff == jsrv.stats()["disagg"]["handoff"]


def _preempt_mid_stream(server, prompts, max_new):
    """Step until a decode-pool request is mid-stream, preempt it (its
    launched step retired first), and run to the end, audited."""
    reqs = [server.submit(p, max_new) for p in prompts]
    victim = None
    while victim is None:
        server.step()
        server.audit()
        victim = next((r for r in server.scheduler.running.values()
                       if r.generated and not r.prefilling), None)
    if victim.uid in server.scheduler.inflight:
        server._flush_window()
    if victim.running:
        server.scheduler.preempt(victim)
    while server.has_work:
        server.step()
        server.audit()
    return [list(r.generated) for r in reqs], victim


def test_disagg_preempted_decode_request_reprefills(tiny):
    """A decode-pool preemption victim re-enters at the front of the
    prefill pool's queue and resumes with the JAX server's tokens."""
    prompts = _prompts(3, n=4)
    kw = dict(enable_speculation=False)
    want, jvictim = _preempt_mid_stream(_jax(tiny, True, **kw), prompts, 10)
    got, victim = _preempt_mid_stream(_port(tiny, True, **kw), prompts, 10)
    assert got == want
    assert victim.preemptions == jvictim.preemptions >= 1


@pytest.mark.parametrize("error", [MemoryError, torch.OutOfMemoryError])
def test_disagg_torn_and_delayed_handoff_copy_is_bit_stable(tiny, error):
    """A torn copy (half the pairs land, then the OOM) and a delayed one
    (nothing lands) each retry whole next step: the JAX server's tokens,
    four OOMs counted."""
    prompts = _prompts(4, n=4)
    want = _audited_generate(_jax(tiny, True), prompts, 10)
    srv = _port(tiny, True)
    real = srv.engine.copy_blocks_from
    faults = {"torn": 2, "delayed": 2}

    def faulty(src_engine, pairs):
        if faults["torn"] > 0:
            faults["torn"] -= 1
            if len(pairs) > 1:
                real(src_engine, pairs[:len(pairs) // 2])
            raise error("test: torn hand-off")
        if faults["delayed"] > 0:
            faults["delayed"] -= 1
            raise error("test: delayed hand-off")
        return real(src_engine, pairs)

    srv.engine.copy_blocks_from = faulty
    assert _audited_generate(srv, prompts, 10) == want
    assert faults == {"torn": 0, "delayed": 0}
    st = srv.stats()
    assert st["oom_events"] == 4 and st["breaker_state"] == "closed"


def test_disagg_drain_mid_flight(tiny):
    """A drain begun after 3 steps finishes every request with the JAX
    server's undisturbed tokens and leaves both pools audit-clean with
    nothing queued to hand off."""
    prompts = _prompts(5)
    want = _audited_generate(_jax(tiny, True), prompts, 10)
    srv = _port(tiny, True)
    reqs = [srv.submit(p, 10) for p in prompts]
    for _ in range(3):
        srv.step()
    st = srv.drain()
    srv.audit()
    assert [list(r.generated) for r in reqs] == want
    assert not srv._handoff and not srv.has_work and st["draining"]
    assert st["disagg"]["prefill_blocks_live"] == 0


def test_disagg_stats_block(tiny):
    """``{"enabled": False}`` exactly on a monolithic server; on a
    disaggregated one the JAX server's block, key for key and value for
    value."""
    prompts = _prompts(6, n=2)
    mono = _port(tiny, False)
    mono.generate(prompts, max_new_tokens=4)
    assert mono.stats()["disagg"] == {"enabled": False}
    jsrv = _jax(tiny, True)
    jsrv.generate(prompts, max_new_tokens=4)
    srv = _port(tiny, True)
    srv.generate(prompts, max_new_tokens=4)
    st = srv.stats()["disagg"]
    assert not {"enabled", "prefill_max_concurrent",
                "prefill_blocks_usable", "prefill_blocks_free",
                "prefill_blocks_live", "prefill_blocks_live_peak",
                "prefill_blocks_evictable", "prefill_pool_bytes",
                "prefill_backlog_blocks", "handoff",
                "sink_attached"} - st.keys()
    assert st["enabled"] is True and st["sink_attached"] is False
    assert st["handoff"]["requests"] >= 1
    assert st == jsrv.stats()["disagg"]


@pytest.mark.parametrize("kw,match", [
    (dict(disagg_prefill_blocks=16), "cannot hold one full-context"),
    (dict(prefill_max_concurrent=0), "prefill_max_concurrent"),
])
def test_disagg_refuses_too_small_a_prefill_side(tiny, kw, match):
    """At 16 blocks a context, 16 prefill blocks leave no garbage block,
    and a prefill pool needs a slot: both servers refuse."""
    with pytest.raises(ValueError, match=match):
        _jax(tiny, True, **kw)
    with pytest.raises(ValueError, match=match):
        _port(tiny, True, **kw)
