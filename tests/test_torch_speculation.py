"""The port's speculative decoding (n-gram drafts, verify, acceptance,
lookahead) against apex_tpu's.

- ``NgramDraft`` proposes what the JAX package's proposes, on random
  histories drawn from a seed and on the reference's unit cases
  (``tests/L0/test_speculative.py:302-320``).
- Greedy parity: the port's server with speculation on (its default)
  against the JAX server with ``enable_speculation=True``, the pipelined
  loop and the breaker on (both packages' defaults) and the rest of the
  slice's flags off (no prefix cache, overload or program
  accounting): tokens, drafted and
  accepted tokens, verify and decode steps, and lookahead blocks
  granted and rolled back are all equal; chunked and unchunked, with a
  pool that preempts.
- An EOS inside a draft, the draft budget, ``spec_tokens`` validation,
  the rollback after every step and a pluggable draft source (a wrong
  one and an out-of-vocabulary one), each against the JAX server.
- Stochastic requests against the JAX server: a token may differ only
  where the top two JAX scores (processed logits + noise) lie within
  ``NEAR_TIE`` (none at these seeds); the rejection counters equal the
  JAX server's.
- The ``stats()["speculation"]`` keys of ``test_speculative.py:423``,
  without ``verify_compiles`` (eager PyTorch traces nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.ops import sampling as jax_sampling
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving import speculation as jax_speculation
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer, SamplingParams
from apex_tpu_torch.serving.speculation import DraftSource, NgramDraft

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

JAX_FLAGS = dict(enable_prefix_cache=False, enable_speculation=True,
                 enable_overload=False, enable_program_accounting=False,
                 mesh=None)
NEAR_TIE = 1e-4

SPEC_KEYS = ("drafted_tokens", "accepted_tokens", "acceptance_rate",
             "verify_steps", "decode_steps", "decode_tokens",
             "tokens_per_engine_step", "spec_tokens", "enabled")
MEMORY_KEYS = ("lookahead_granted_blocks", "lookahead_rolled_back_blocks")

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8],
           [1, 2, 1, 2, 1, 2], [9, 9, 8, 7, 6, 5, 4, 3]]


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


def _geometry(kw):
    return {"max_context": 128, "block_size": 8, "max_batch_size": 2, **kw}


def _jax_server(tiny, **kw):
    _, _, jcfg, jparams = tiny
    flags = {**JAX_FLAGS, **{k: kw.pop(k) for k in list(kw)
                             if k in JAX_FLAGS}}
    kw.setdefault("enable_chunked_prefill", False)
    return JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                              attention_fn=jax_make_flash(causal=True),
                              **_geometry(kw), **flags)


def _server(tiny, **kw):
    cfg, sd, _, _ = tiny
    kw.setdefault("enable_chunked_prefill", False)
    kw.setdefault("enable_prefix_cache", False)
    kw.setdefault("enable_overload", False)
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           **_geometry(kw))


def _drive(server, prompts, max_new, eos_id=None, sampling=None,
           after_step=None):
    per = sampling if sampling is not None else [None] * len(prompts)
    reqs = [server.submit(p, max_new, eos_id, sampling=s)
            for p, s in zip(prompts, per)]
    while server.scheduler.has_work:
        server.step()
        server.scheduler.audit()
        if after_step is not None:
            after_step(server)
    return [list(r.generated) for r in reqs]


def _spec_stats(server):
    st = server.stats()
    return ({k: st["speculation"][k] for k in SPEC_KEYS},
            {k: st["memory"][k] for k in MEMORY_KEYS})


# -- the drafter ----------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_matches_jax_on_random_histories(seed):
    rng = np.random.RandomState(seed)
    configs = [dict(), dict(max_ngram=2, min_ngram=1),
               dict(max_ngram=4, min_ngram=2, history_window=16),
               dict(max_ngram=1, min_ngram=1, history_window=None)]
    for kw in configs:
        mine, ref = NgramDraft(**kw), jax_speculation.NgramDraft(**kw)
        for _ in range(40):
            # a small alphabet makes repeats, and so drafts, common
            hist = list(rng.randint(0, int(rng.randint(2, 9)),
                                    size=int(rng.randint(0, 40))))
            k = int(rng.randint(0, 6))
            assert mine.propose(hist, k) == ref.propose(hist, k), \
                (kw, hist, k)


def test_ngram_draft_reference_cases():
    d = NgramDraft(max_ngram=3, min_ngram=1)
    assert d.propose([7, 8, 7, 8, 7, 8], 4) == [7, 8, 7, 8]
    assert d.propose([5, 5, 5], 3) == [5, 5, 5]
    assert d.propose([1, 2, 3, 4, 5], 4) == [] == d.propose([], 4)
    d2 = NgramDraft(max_ngram=2, min_ngram=1)
    assert d2.propose([1, 2, 9, 3, 2, 4, 1, 2], 1) == [9]
    assert d2.propose([3, 8, 5, 3, 6, 0, 3], 1) == [6]
    narrow = NgramDraft(max_ngram=1, min_ngram=1, history_window=4)
    assert narrow.propose([9, 7, 1, 2, 3, 9], 1) == []
    for bad in (dict(max_ngram=1, min_ngram=2), dict(min_ngram=0),
                dict(history_window=1)):
        with pytest.raises(ValueError):
            NgramDraft(**bad)
    with pytest.raises(NotImplementedError):
        DraftSource().propose([1], 1)


# -- greedy parity --------------------------------------------------------

@pytest.mark.parametrize("geometry", [
    dict(),
    dict(enable_chunked_prefill=True, prefill_chunk=8),
    # 9 usable blocks of 4: the batch outgrows the pool and preempts
    dict(max_batch_size=3, max_context=64, block_size=4, num_blocks=10),
], ids=["monolithic", "chunked", "preempting"])
def test_greedy_speculation_matches_jax_server(tiny, geometry):
    prompts = PROMPTS[:3] if "num_blocks" in geometry else PROMPTS
    jserver = _jax_server(tiny, **dict(geometry))
    want = _drive(jserver, prompts, 24)
    server = _server(tiny, **dict(geometry))
    got = _drive(server, prompts, 24)
    assert got == want
    assert _spec_stats(server) == _spec_stats(jserver)
    sp = server.stats()["speculation"]
    assert sp["accepted_tokens"] > 0 and sp["verify_steps"] > 0
    st = server.stats()
    assert st["preemptions"] == jserver.stats()["preemptions"]
    if "num_blocks" in geometry:
        assert st["preemptions"] > 0
    assert st["memory"]["lookahead_granted_blocks"] > 0
    off = _server(tiny, enable_speculation=False, **dict(geometry))
    assert _drive(off, prompts, 24) == got     # output never moves
    assert off.stats()["speculation"]["verify_steps"] == 0
    assert off.stats()["speculation"]["tokens_per_engine_step"] <= \
        off.engine.max_batch_size


def test_eos_inside_a_draft_matches_jax(tiny):
    prompt = [5, 4, 3, 2, 1]
    ref = _drive(_server(tiny, enable_speculation=False), [prompt], 32)[0]
    eos = ref[20]
    jserver = _jax_server(tiny)
    want = _drive(jserver, [prompt], 32, eos_id=eos)[0]
    server = _server(tiny)
    got = _drive(server, [prompt], 32, eos_id=eos)[0]
    assert got == want == ref[:ref.index(eos) + 1]
    assert server.scheduler.finished[0].finish_reason == "eos"
    assert _spec_stats(server) == _spec_stats(jserver)


def test_draft_budget_and_spec_tokens(tiny):
    server = _server(tiny)
    jserver = _jax_server(tiny)
    prompt = [[1, 2, 1, 2, 1, 2]]
    assert _drive(server, prompt, 5) == _drive(jserver, prompt, 5)
    req = server.scheduler.finished[0]
    assert len(req.generated) == 5 and req.finish_reason == "length"
    assert req.spec_accepted <= req.spec_drafted
    assert _spec_stats(server) == _spec_stats(jserver)
    for k in (1, 2):
        a, b = _server(tiny, spec_tokens=k), _jax_server(tiny, spec_tokens=k)
        assert _drive(a, PROMPTS, 16) == _drive(b, PROMPTS, 16)
        assert _spec_stats(a) == _spec_stats(b)
        assert a.stats()["speculation"]["drafted_per_step"]["max"] <= k
    with pytest.raises(ValueError, match="spec_tokens"):
        _server(tiny, spec_tokens=0)


def test_lookahead_rolls_back_after_every_step(tiny):
    def no_lookahead_kept(server):
        bs = server.engine.block_size
        for r in server.scheduler.running.values():
            if not r.prefilling:
                assert len(r.block_table) <= r.num_cached // bs + 1

    # the synchronous loop, as the reference's twin runs it: the
    # pipelined loop holds the launched window's lookahead until its
    # retire (its bound: tests/test_torch_serving_pipeline.py)
    server = _server(tiny, block_size=4, enable_pipeline=False)
    out = _drive(server, [[3, 1, 4, 1, 5], [2, 7, 1, 8]], 32,
                 after_step=no_lookahead_kept)
    assert all(len(o) == 32 for o in out)
    mem = server.stats()["memory"]
    assert mem["lookahead_granted_blocks"] > 0
    assert server.engine.allocator.num_free == \
        server.engine.cache_cfg.num_blocks - 1


class _WrongDraft:
    """Confidently wrong guesses (a valid DraftSource by duck typing)."""

    def propose(self, tokens, k):
        return [(tokens[-1] + 17) % VOCAB] * k


class _OutOfVocabDraft:
    def propose(self, tokens, k):
        return [VOCAB + 100] * k


def test_pluggable_draft_sources_match_jax(tiny):
    want = _drive(_server(tiny, enable_speculation=False), [[4, 2, 4, 2]],
                  16)
    for source, drafted in ((_WrongDraft, True), (_OutOfVocabDraft, False)):
        server = _server(tiny, draft_source=source())
        jserver = _jax_server(tiny, draft_source=source())
        got = _drive(server, [[4, 2, 4, 2]], 16)
        assert got == _drive(jserver, [[4, 2, 4, 2]], 16) == want
        assert _spec_stats(server) == _spec_stats(jserver)
        sp = server.stats()["speculation"]
        assert (sp["drafted_tokens"] > 0) == drafted
        assert sp["acceptance_rate"] < 1.0


# -- stochastic requests --------------------------------------------------

SAMPLING = [None,
            dict(temperature=0.8, seed=3),
            dict(temperature=0.5, top_k=8, seed=4),
            dict(temperature=0.7, top_p=0.9, seed=5)]


def _first_near_tie(tiny, prompts, got, want, samp):
    """Each stream equals the JAX one until a step whose top two JAX
    scores lie within NEAR_TIE, where its comparison ends; returns the
    count of such steps."""
    _, _, jcfg, jparams = tiny
    model = jax_models.GPTLMHeadModel(jcfg)
    ties = 0
    for p, g, w, s in zip(prompts, got, want, samp):
        for i, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            lg = model.apply({"params": jparams},
                             jnp.asarray([p + w[:i]], jnp.int32))[:, -1]
            s = s or {}
            one = np.ones((1,), np.float32)
            score = np.asarray(jax_sampling.processed_logits(
                lg, one * s.get("temperature", 0.0),
                np.asarray([s.get("top_k") or 0], np.int32),
                one * s.get("top_p", 1.0)))[0] + np.asarray(
                jax_sampling.sampling_noise(
                    jnp.asarray([s.get("seed", 0)], jnp.int32),
                    jnp.asarray([len(p) + i], jnp.int32), lg.shape[-1]))[0]
            top2 = np.sort(score)[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (i, a, b, top2)
            ties += 1
            break
    return ties


def test_stochastic_speculation_matches_jax_server(tiny):
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [7, 7, 7, 7], [4, 5, 4, 5, 4],
               [9, 8, 9, 8, 9, 8]]
    jsamp = [None if s is None else jax_sampling.SamplingParams(**s)
             for s in SAMPLING]
    psamp = [None if s is None else SamplingParams(**s) for s in SAMPLING]
    geometry = dict(max_batch_size=4)
    jserver = _jax_server(tiny, **geometry)
    want = _drive(jserver, prompts, 24, sampling=jsamp)
    server = _server(tiny, **geometry)
    got = _drive(server, prompts, 24, sampling=psamp)
    assert _first_near_tie(tiny, prompts, got, want, SAMPLING) == 0
    assert got == want
    rej, jrej = (s.stats()["sampling"]["rejection"]
                 for s in (server, jserver))
    assert rej == jrej
    assert rej["drafted_tokens"] > 0 and rej["resamples"] > 0
    assert _spec_stats(server) == _spec_stats(jserver)
    # within the port: speculation off and a replay give the same streams
    off = _server(tiny, enable_speculation=False, **geometry)
    assert _drive(off, prompts, 24, sampling=psamp) == got
    assert _drive(_server(tiny, **geometry), prompts, 24,
                  sampling=psamp) == got


def test_speculation_stats_keys_are_pinned(tiny):
    server = _server(tiny)
    server.generate([[1, 2, 1, 2]], max_new_tokens=8)
    sp = server.stats()["speculation"]
    assert set(sp) == {
        "enabled", "spec_tokens", "drafted_tokens", "accepted_tokens",
        "acceptance_rate", "verify_steps", "decode_steps",
        "decode_tokens", "tokens_per_engine_step",
        "drafted_per_step", "accepted_per_step",
    }
    assert sp["accepted_tokens"] <= sp["drafted_tokens"]
    assert sp["decode_tokens"] <= 8
    depths = sp["drafted_per_step"]
    assert set(depths) == {"count", "p50", "p90", "mean", "max"}
    assert depths["count"] >= 1 and depths["max"] <= sp["spec_tokens"]
    assert set(server.stats()["sampling"]["rejection"]) == {
        "drafted_tokens", "accepted_tokens", "acceptance_rate",
        "resamples"}
