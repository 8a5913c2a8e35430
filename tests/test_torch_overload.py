"""The port's overload control, deadlines, lifecycle and finish-reason
vocabulary against apex_tpu's.

- Twins of ``tests/L0/test_overload.py:76-180, 276-340, 416`` (queue-full
  displacement, the shed order, pool-pressure shedding, the
  priority-aware preemption victim, drain and close, submit-time
  stamps, the prefill backlog in ``pressure``) and of
  ``tests/L0/test_serving_faults.py:104-212`` (deadlines in iterations
  and in wall seconds on an injected clock, for running, waiting and
  preempted requests).  Where a server is involved the JAX server runs
  the same traffic with the reference's default layers (prefix cache,
  speculation where the reference keeps it, overload control, the
  pipelined loop and the breaker) and the rest of the slice's flags off
  (no program accounting); tokens, finish reasons, the failure counts and
  the pressure readings are equal.  The raw-scheduler cases run the
  same calls on the JAX ``Scheduler``.
- ``cancel`` of a running and a waiting request, and a drain that is
  bit for bit.
- The twin of ``tests/L0/test_reasons.py:45-70, 126``: the port's
  vocabulary has the same sets and values as ``apex_tpu.serving.reasons``,
  its module imports nothing, and no finish-reason string literal
  appears at a decision site in ``apex_tpu_torch/``.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving import OverloadPolicy as JaxOverloadPolicy
from apex_tpu.serving import reasons as jax_reasons
from apex_tpu.serving.kv_cache import BlockAllocator as JaxBlockAllocator
from apex_tpu.serving.kv_cache import KVCacheConfig as JaxKVCacheConfig
from apex_tpu.serving.scheduler import Request as JaxRequest
from apex_tpu.serving.scheduler import Scheduler as JaxScheduler
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer, OverloadPolicy, reasons
from apex_tpu_torch.serving.kv_cache import BlockAllocator, KVCacheConfig
from apex_tpu_torch.serving.overload import AdmissionEstimator
from apex_tpu_torch.serving.scheduler import Request, Scheduler

torch.set_num_threads(1)

PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "apex_tpu_torch")

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

JAX_FLAGS = dict(enable_program_accounting=False, mesh=None)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


def _pair(tiny, policy=None, **kw):
    """(port server, JAX server) on the same params, geometry and
    flags; ``policy`` a dict of :class:`OverloadPolicy` fields."""
    cfg, sd, jcfg, jparams = tiny
    port_kw, jax_kw = dict(kw), dict(kw)
    if policy is not None:
        port_kw["overload_policy"] = OverloadPolicy(**policy)
        jax_kw["overload_policy"] = JaxOverloadPolicy(**policy)
    server = InferenceServer(cfg, sd, device="cpu",
                             cache_dtype=torch.float32, **port_kw)
    jserver = JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                                 attention_fn=jax_make_flash(causal=True),
                                 **jax_kw, **JAX_FLAGS)
    return server, jserver


def _run(server):
    while server.scheduler.has_work:
        server.step()
        server.scheduler.audit()


def _failed(server):
    """Failure counts by reason (the JAX server's keys carry the
    ``requests_failed_`` prefix)."""
    st = server.stats()["requests_failed"]
    return {k.replace("requests_failed_", ""): v for k, v in st.items()
            if v}


def _raw_schedulers(overload=None, num_blocks=9, block_size=4,
                    max_batch_size=2, max_context=32, max_waiting=None,
                    chunk_size=None):
    """The port's and the JAX package's scheduler over one geometry."""
    geo = dict(num_layers=1, num_heads=2, head_dim=4, num_blocks=num_blocks,
               block_size=block_size)
    kw = dict(max_batch_size=max_batch_size, block_size=block_size,
              max_context=max_context, max_waiting=max_waiting,
              chunk_size=chunk_size)
    mine = Scheduler(BlockAllocator(KVCacheConfig(dtype=torch.float32,
                                                  **geo)),
                     overload=None if overload is None
                     else OverloadPolicy(**overload), **kw)
    ref = JaxScheduler(JaxBlockAllocator(JaxKVCacheConfig(
        dtype=jnp.float32, **geo)),
        overload=None if overload is None else JaxOverloadPolicy(**overload),
        **kw)
    return (mine, Request), (ref, JaxRequest)


# -- priority shedding: queue pressure ------------------------------------

def test_queue_full_arrival_displaces_lowest_priority_newest(tiny):
    ends = []
    for server in _pair(tiny, policy=dict(shed_threshold=5.0),
                        max_batch_size=1, max_context=64, block_size=8,
                        max_waiting=2):
        a = server.submit([3, 1, 4, 1], 6, priority=0)
        b = server.submit([5, 9, 2, 6], 6, priority=2)
        c = server.submit([2, 7, 1, 8], 6, priority=1)   # displaces b
        assert b.finish_reason == reasons.SHED
        assert b.finished_at is not None and not c.finished
        d = server.submit([9, 8, 7, 6], 6, priority=1)   # outranks nobody
        assert d.finish_reason == reasons.REJECTED
        assert d.finished_at is not None
        _run(server)
        ends.append(([r.finish_reason for r in (a, b, c, d)],
                     [r.generated for r in (a, b, c, d)], _failed(server)))
    assert ends[0] == ends[1]
    assert ends[0][2] == {"shed": 1, "rejected": 1}
    assert ends[0][0][::2] == ["length", "length"]


def test_shed_order_is_worst_priority_then_newest():
    for sched, req in _raw_schedulers(
            overload=dict(shed_threshold=50.0), max_waiting=2):
        old = sched.submit(req(prompt=[1], max_new_tokens=2, priority=2))
        new = sched.submit(req(prompt=[2], max_new_tokens=2, priority=2))
        arrival = sched.submit(req(prompt=[3], max_new_tokens=2,
                                   priority=0))
        assert new.finish_reason == "shed"
        assert not old.finished and not arrival.finished
        assert list(sched.waiting) == [old, arrival]


def test_pool_pressure_sheds_best_effort_worst_first():
    readings = []
    for sched, req in _raw_schedulers(overload=dict()):
        r0 = sched.submit(req(prompt=[1] * 4, max_new_tokens=4, priority=0))
        r1 = sched.submit(req(prompt=[1] * 8, max_new_tokens=8, priority=1))
        r2 = sched.submit(req(prompt=[2] * 8, max_new_tokens=8, priority=2))
        assert (r0.cost_blocks, r1.cost_blocks, r2.cost_blocks) == (2, 4, 4)
        seen = [sched.pressure()]
        assert sched.shed_overload() == [r2] and r2.finish_reason == "shed"
        r3 = sched.submit(req(prompt=[3] * 8, max_new_tokens=8, priority=1))
        assert sched.shed_overload() == [r3] and not r1.finished
        r4 = sched.submit(req(prompt=[4] * 20, max_new_tokens=8,
                              priority=0))
        assert sched.shed_overload() == [r1]
        seen.append(sched.pressure())
        assert seen[-1] >= 0.9 and sched.shed_overload() == []
        assert not r0.finished and not r4.finished
        readings.append(seen)
    assert readings[0] == readings[1]
    assert readings[0][0] == pytest.approx(10 / 8)


def test_preemption_victim_is_worst_priority_then_youngest():
    for sched, req in _raw_schedulers(overload=dict(), num_blocks=7,
                                      max_batch_size=3):
        ra = sched.submit(req(prompt=[1] * 4, max_new_tokens=4, priority=1))
        rb = sched.submit(req(prompt=[2] * 4, max_new_tokens=4, priority=0))
        rc = sched.submit(req(prompt=[3] * 4, max_new_tokens=4, priority=0))
        assert sched.admit() == [ra, rb, rc]
        rb.num_cached = 8                  # rb needs a third block
        assert sched.ensure_decode_capacity(rb)
        assert ra.slot == -1 and ra in sched.waiting and rc.running
        sched.audit()
    # without a policy (uniform priorities) the youngest goes, as before
    (sched, req), _ = _raw_schedulers(num_blocks=7, max_batch_size=3)
    reqs = [sched.submit(req(prompt=[i] * 4, max_new_tokens=4))
            for i in (1, 2, 3)]
    sched.admit()
    reqs[1].num_cached = 8
    assert sched.ensure_decode_capacity(reqs[1])
    assert reqs[2] in sched.waiting and reqs[0].running


def test_pressure_counts_remaining_prefill_backlog():
    readings = []
    for sched, req in _raw_schedulers(num_blocks=33, max_context=32,
                                      chunk_size=4):
        r = sched.submit(req(prompt=[1] * 16, max_new_tokens=4))
        seen = [sched.pressure()]
        assert sched.admit() == [r]
        assert sched.prefill_backlog_blocks() == 4
        while r.prefilling:
            tokens, start, _ = sched.prefill_plan(r)
            assert start == r.num_cached
            sched.chunk_done(r, len(tokens))
            seen.append(sched.pressure())
        assert sched.prefill_backlog_blocks() == 0
        readings.append(seen)
    assert readings[0] == readings[1]
    assert readings[0][0] == pytest.approx(5 / 32)
    assert readings[0][-1] == pytest.approx(5 / 32)
    assert readings[0][1:] == sorted(readings[0][1:], reverse=True)


def test_overload_policy_and_estimator_validate():
    for bad in (dict(shed_threshold=0), dict(best_effort_priority=0),
                dict(admission_min_history=0), dict(admission_margin=0.5)):
        with pytest.raises(ValueError):
            OverloadPolicy(**bad)
    policy = OverloadPolicy()
    assert policy.sheddable(1) and not policy.sheddable(0)
    assert OverloadPolicy.slo_debt_tokens(
        Request(prompt=[1], max_new_tokens=5, generated=[2, 3])) == 3
    est = AdmissionEstimator(min_history=1)
    done = Request(prompt=[1], max_new_tokens=3, submitted_at=0.0,
                   first_token_at=2.0, finished_at=4.0, generated=[1, 2, 3])
    est.observe(done)
    doomed = Request(prompt=[1], max_new_tokens=3, deadline_s=3.0)
    assert est.doomed(doomed) and est.predicted_sheds == 1
    assert not est.doomed(Request(prompt=[1], max_new_tokens=3,
                                  deadline_s=10.0))
    assert est.as_stats()["by_priority"][0]["min_decode_token_s"] == 1.0


# -- deadlines ------------------------------------------------------------

def test_iteration_deadline_times_out_only_that_request(tiny):
    ends = []
    for server in _pair(tiny, max_batch_size=2, max_context=64,
                        block_size=8, enable_speculation=False):
        slow = server.submit([3, 1, 4, 1], 10, deadline_iters=3)
        fast = server.submit([5, 9, 2, 6], 10)
        _run(server)
        assert slow.finish_reason == reasons.TIMEOUT
        assert 0 < len(slow.generated) < 10
        assert fast.finish_reason == reasons.LENGTH
        ends.append((slow.generated, fast.generated, _failed(server)))
    assert ends[0] == ends[1]
    assert ends[0][2] == {"timeout": 1}


def test_wall_deadline_with_injected_clock(tiny):
    clock = {"t": 0.0}
    ends = []
    for server in _pair(tiny, max_batch_size=2, max_context=64,
                        block_size=8, clock=lambda: clock["t"],
                        enable_speculation=False):
        clock["t"] = 0.0
        doomed = server.submit([3, 1, 4, 1], 10, deadline_s=5.0)
        steady = server.submit([5, 9, 2, 6], 10)
        server.step()
        server.step()
        assert not doomed.finished
        clock["t"] = 10.0                  # the budget runs out mid-flight
        _run(server)
        assert doomed.finish_reason == reasons.TIMEOUT
        assert steady.finish_reason == reasons.LENGTH
        assert doomed.finished_at == 10.0 and doomed.submitted_at == 0.0
        ends.append((doomed.generated, steady.generated,
                     doomed.timeline()["ttft_s"]))
    assert ends[0] == ends[1]


def test_waiting_requests_time_out(tiny):
    clock = {"t": 0.0}
    ends = []
    for server in _pair(tiny, max_batch_size=1, max_context=64,
                        block_size=8, clock=lambda: clock["t"]):
        clock["t"] = 0.0
        hog = server.submit([3, 1, 4, 1], 12)
        by_iters = server.submit([5, 9, 2, 6], 12, deadline_iters=2)
        by_wall = server.submit([2, 7, 1, 8], 12, deadline_s=3.0)
        server.step()
        assert not by_wall.finished
        clock["t"] = 10.0                  # the wall budget runs out queued
        server.step()
        _run(server)
        assert hog.finish_reason == reasons.LENGTH
        for r in (by_iters, by_wall):
            assert r.finish_reason == reasons.TIMEOUT
            assert r.generated == [] and r.block_table == []
            assert r.admitted_at is None
            assert "queue_wait_s" not in r.timeline()
        usable = server.engine.cache_cfg.num_blocks - 1
        assert server.engine.allocator.num_free \
            + server.scheduler.prefix_cache.num_evictable == usable
        ends.append((hog.generated, _failed(server)))
    assert ends[0] == ends[1]
    assert ends[0][1] == {"timeout": 2}


def test_iter_deadline_on_request_preempted_at_expiry(tiny):
    ends = []
    for server in _pair(tiny, max_batch_size=2, max_context=64,
                        block_size=8, enable_speculation=False):
        req = server.submit([3, 1, 4, 1], 10, deadline_iters=4)
        for _ in range(4):
            server.step()
        assert req.running and req.generated
        server.scheduler.preempt(req)
        partial = list(req.generated)
        server.step()                      # expiry fires before re-admit
        assert req.finish_reason == reasons.TIMEOUT
        assert req.generated == partial and req.block_table == []
        assert not server.scheduler.has_work
        server.scheduler.audit()
        ends.append(partial)
    assert ends[0] == ends[1]


# -- the lifecycle --------------------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]


def test_drain_is_bit_exact_and_close_is_exactly_once(tiny):
    cfg, sd, _, _ = tiny
    baseline = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                               max_context=64, block_size=8,
                               cache_dtype=torch.float32).generate(PROMPTS,
                                                                   12)
    ends = []
    for server in _pair(tiny, max_batch_size=2, max_context=64,
                        block_size=8, enable_speculation=False):
        reqs = [server.submit(p, 12) for p in PROMPTS]
        for _ in range(4):
            server.step()
        assert any(r.generated for r in reqs) and \
            not any(r.finished for r in reqs)
        stats = server.drain()
        assert [r.generated for r in reqs] == baseline
        assert stats["requests_finished"] == 2 and stats["draining"]
        assert server.draining
        late = server.submit([1, 2, 3], 4)
        assert late.finish_reason == reasons.DRAINING
        assert late.finished_at is not None
        final = server.close()
        assert server.close() is final and server.closed
        with pytest.raises(RuntimeError, match="closed"):
            server.submit([1, 2, 3], 4)
        with pytest.raises(RuntimeError, match="closed"):
            server.end_drain()
        server.scheduler.audit()
        ends.append(_failed(server))
    assert ends[0] == ends[1] == {"draining": 1}


def test_begin_and_end_drain_reopen_admissions(tiny):
    cfg, sd, _, _ = tiny
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                             max_context=64, block_size=8,
                             cache_dtype=torch.float32)
    running = server.submit(PROMPTS[0], 8)
    server.step()
    server.begin_drain()
    assert server.stats()["draining"]
    turned = server.submit(PROMPTS[1], 8)
    assert turned.finish_reason == reasons.DRAINING
    server.end_drain()
    back = server.submit(PROMPTS[1], 8)
    _run(server)
    assert running.finish_reason == back.finish_reason == reasons.LENGTH
    assert not server.stats()["draining"]


def test_submit_time_rejection_is_stamped_at_submit(tiny):
    clock = {"t": 0.0}
    for server in _pair(tiny, max_batch_size=1, max_context=64,
                        block_size=8, max_waiting=1,
                        clock=lambda: clock["t"]):
        clock["t"] = 0.0
        ok = server.submit([3, 1, 4, 1], 4)
        clock["t"] = 5.0
        rejected = server.submit([5, 9, 2, 6], 4)
        assert rejected.finish_reason == reasons.REJECTED
        assert rejected.finished_at == 5.0
        tl = rejected.timeline()
        assert "queue_wait_s" not in tl and "ttft_s" not in tl
        _run(server)
        assert ok.finish_reason == reasons.LENGTH
        assert ok.timeline()["queue_wait_s"] == 5.0     # admitted at 5


def test_cancel_frees_a_running_and_a_waiting_request(tiny):
    cfg, sd, _, _ = tiny
    kw = dict(device="cpu", max_batch_size=1, max_context=64, block_size=8,
              cache_dtype=torch.float32)
    want = InferenceServer(cfg, sd, **kw).generate([PROMPTS[1]], 8)[0]
    ends = []
    for server in _pair(tiny, **{k: v for k, v in kw.items()
                                 if k not in ("device", "cache_dtype")}):
        running = server.submit(PROMPTS[0], 12)
        queued = server.submit(PROMPTS[0][:5], 12)
        other = server.submit(PROMPTS[1], 8)
        server.step()
        server.step()
        assert running.running and running.generated
        assert server.cancel(running.uid) and server.cancel(queued.uid)
        assert not server.cancel(running.uid)        # already finished
        assert not server.cancel(10 ** 9)            # unknown
        assert running.finish_reason == queued.finish_reason == \
            reasons.CANCELLED
        assert queued.generated == [] and running.block_table == []
        server.scheduler.audit()
        _run(server)
        assert other.generated == want
        ends.append((running.generated, _failed(server)))
    assert ends[0] == ends[1]
    assert ends[0][1] == {"cancelled": 2}


def test_burst_ends_every_request_exactly_once(tiny):
    """A burst at priorities 0 and 1 into a bounded queue: each request
    ends with one terminal reason, priority 0 is never shed, and the
    ends and pressure readings equal the JAX server's."""
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(0, VOCAB, size=int(rng.randint(4, 20))))
               for _ in range(24)]
    ends = []
    for server in _pair(tiny, max_batch_size=2, max_context=64,
                        block_size=8, max_waiting=6):
        reqs = [server.submit(p, 6, priority=i % 2)
                for i, p in enumerate(prompts)]
        _run(server)
        assert all(r.finish_reason in reasons.TERMINAL_REASONS
                   for r in reqs)
        assert not any(r.finish_reason == reasons.SHED
                       for r in reqs if r.priority == 0)
        assert len(server.scheduler.finished) == len(reqs)
        st = server.stats()
        ends.append(([(r.finish_reason, r.generated) for r in reqs],
                     st["pressure_peak"], _failed(server)))
    assert ends[0] == ends[1]
    assert ends[0][2]["shed"] > 0 and ends[0][2]["rejected"] > 0


def test_server_defaults_and_names_match_jax():
    """The port's server turns the reference's default layers on with the
    reference's defaults, and exports the same serving names."""
    import inspect
    from apex_tpu import serving as jserving
    from apex_tpu_torch import serving
    mine = inspect.signature(InferenceServer).parameters
    ref = inspect.signature(JaxInferenceServer).parameters
    for name in ("enable_prefix_cache", "enable_speculation", "spec_tokens",
                 "draft_source", "enable_overload", "overload_policy",
                 "max_waiting", "clock", "enable_chunked_prefill",
                 "prefill_chunk"):
        assert mine[name].default == ref[name].default, name
    assert mine["enable_prefix_cache"].default is True
    mine = inspect.signature(InferenceServer.submit).parameters
    ref = inspect.signature(JaxInferenceServer.submit).parameters
    for name in ("priority", "deadline_iters", "deadline_s", "sampling"):
        assert mine[name].default == ref[name].default, name
    for name in ("PrefixCache", "NgramDraft", "DraftSource",
                 "OverloadPolicy"):
        assert name in serving.__all__ and name in jserving.__all__, name
    assert OverloadPolicy() == OverloadPolicy(
        **{f: getattr(JaxOverloadPolicy(), f)
           for f in OverloadPolicy.__dataclass_fields__})


# -- the finish-reason vocabulary -----------------------------------------

CONSTANT_NAMES = [
    "EOS", "LENGTH", "CAPACITY", "TIMEOUT", "NONFINITE", "REJECTED",
    "SHED", "BREAKER_OPEN", "DRAINING", "CANCELLED", "HANDOFF",
    "REPLICA_FAILED",
]
SET_NAMES = ["HEALTHY_REASONS", "TERMINAL_REASONS",
             "ROUTER_TERMINAL_REASONS", "ALL_REASONS"]


def test_reasons_equal_the_reference_vocabulary():
    for name in CONSTANT_NAMES + SET_NAMES:
        assert getattr(reasons, name) == getattr(jax_reasons, name), name
    values = [getattr(reasons, n) for n in CONSTANT_NAMES]
    assert len(set(values)) == len(values)
    assert set(values) == set(reasons.ALL_REASONS)
    assert reasons.HEALTHY_REASONS < reasons.TERMINAL_REASONS \
        < reasons.ROUTER_TERMINAL_REASONS == reasons.ALL_REASONS
    public = {n for n in vars(reasons) if n.isupper()}
    assert public == set(CONSTANT_NAMES + SET_NAMES)


def test_reasons_module_imports_nothing():
    with open(os.path.join(PORT, "serving", "reasons.py")) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))]


def _literal_reason_sites(path):
    """Finish-reason string literals at decision sites:
    ``x.finish_reason = "lit"``, ``x.finish_reason == "lit"`` (or ``in``
    a literal tuple) and ``*.fail(req, "lit")``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)

    def is_fr(node):
        return isinstance(node, ast.Attribute) and \
            node.attr == "finish_reason"

    def strings(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return [s for el in node.elts for s in strings(el)]
        return []

    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(is_fr(t)
                                                for t in node.targets):
            sites += [(node.lineno, s) for s in strings(node.value)]
        elif isinstance(node, ast.Compare) and is_fr(node.left):
            sites += [(node.lineno, s) for c in node.comparators
                      for s in strings(c)]
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "fail":
            sites += [(node.lineno, s) for a in node.args[1:2]
                      for s in strings(a)]
    return sites


def test_no_stray_finish_reason_literals_in_the_port():
    exempt = os.path.join(PORT, "serving", "reasons.py")
    offenders = []
    for root, _dirs, files in os.walk(PORT):
        for fn in sorted(files):
            path = os.path.join(root, fn)
            if fn.endswith(".py") and path != exempt:
                offenders += [f"{path}:{line}: {lit!r}"
                              for line, lit in _literal_reason_sites(path)]
    assert not offenders, "\n".join(offenders)
