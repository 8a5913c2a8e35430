"""The port's InferenceServer with chunked prefill and stochastic
sampling against apex_tpu's.

The JAX server runs the slice's flags of
``tests/test_torch_gpt_serving.py`` (``SLICE_FLAGS``) but with
``enable_chunked_prefill=True`` and the same ``prefill_chunk`` as the
port's server, which chunks by default.  At a chunk of 8 the prompts
cross several chunks and blocks.

- Greedy: tokens identical on the fp32 pool and on the int8 pool (the
  tokens rule of ``tests/test_torch_kv_quant.py``), preemption included.
- The twin of ``tests/L0/test_prefix_cache.py:318``: chunks interleave
  with decode (a running request gains one token every step while a
  long prompt prefills).
- The twin of ``test_prefix_cache.py:397`` with the cache off:
  preempted between chunks, a request resumes at position 0 and ends
  bit for bit as an undisturbed one.
- The default chunk is ``min(256, max_context)``.
- Stochastic traffic of every class against the JAX server: a token may
  differ only where the top two of the JAX processed logits + noise at
  that step are within ``NEAR_TIE`` (that request's comparison ends
  there); at these seeds none does.  The port alone (the twin of
  ``tests/L0/test_sampling.py:352-400``): a replay, a starved pool that
  preempts and chunking off give the same streams bit for bit, and the
  greedy rows of a mixed batch equal an all-greedy run.
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
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer, SamplingParams

torch.set_num_threads(1)

TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

SLICE_FLAGS = dict(enable_prefix_cache=False, enable_speculation=False,
                   enable_pipeline=False, enable_overload=False,
                   enable_breaker=False, enable_streaming=False,
                   enable_program_accounting=False, mesh=None)

CHUNK = 8
# 41 and 30 cross several chunks and blocks of 16
PROMPT_LENS = (5, 41, 30, 9, 17, 3)
NEAR_TIE = 1e-4

SAMPLING = [None,
            dict(temperature=0.8, seed=3),
            dict(temperature=1.0, top_k=40, seed=4),
            dict(temperature=0.7, top_p=0.9, seed=5),
            dict(temperature=0.9, top_k=20, top_p=0.8, seed=6),
            dict(temperature=1.3, seed=7)]


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, TINY["vocab_size"], size=n))
            for n in PROMPT_LENS]


def _jax_server(tiny, **kw):
    _, _, jcfg, jparams = tiny
    kw.setdefault("cache_dtype", jnp.float32)
    kw.setdefault("kv_quant", None)
    return JaxInferenceServer(jcfg, jparams,
                              attention_fn=jax_make_flash(causal=True),
                              enable_chunked_prefill=True,
                              prefill_chunk=CHUNK, **kw, **SLICE_FLAGS)


def _server(tiny, **kw):
    cfg, sd, _, _ = tiny
    kw.setdefault("cache_dtype", torch.float32)
    kw.setdefault("prefill_chunk", CHUNK)
    return InferenceServer(cfg, sd, device="cpu", **kw)


def _drain(server):
    while server.has_work:
        server.step()
        server.scheduler.audit()


@pytest.mark.parametrize("quant,geometry", [
    (None, dict(max_batch_size=4, block_size=16)),
    ("int8", dict(max_batch_size=4, block_size=16)),
    # 11 usable blocks of 8: the batch outgrows the pool
    (None, dict(max_batch_size=3, max_context=96, block_size=8,
                num_blocks=12)),
])
def test_chunked_generate_matches_jax_server(tiny, quant, geometry):
    prompts = _prompts()
    jserver = _jax_server(tiny, kv_quant=quant, **geometry)
    want = jserver.generate(prompts, max_new_tokens=16)
    server = _server(tiny, kv_quant=quant, **geometry)
    assert server.prefill_chunk == CHUNK
    before = launch_counts()
    got = server.generate(prompts, max_new_tokens=16)
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got == want
    st, jst = server.stats(), jserver.stats()
    assert st["prefill_chunks"] == jst["prefill_chunks"]
    assert st["prefill_chunks"] >= sum(-(-n // CHUNK) for n in PROMPT_LENS)
    assert st["prefills"] == 0 and st["chunk_iters_peak"] >= 2
    assert st["preemptions"] == jst["preemptions"]
    assert (st["preemptions"] > 0) == ("num_blocks" in geometry)
    assert st["sampling"] == {"requests": {"greedy": len(prompts)}}
    server.scheduler.audit()
    assert server.engine.allocator.num_free == \
        server.engine.cache_cfg.num_blocks - 1


def test_chunks_interleave_with_decode(tiny):
    srv = _server(tiny, max_batch_size=2, block_size=16)
    short = srv.submit([1, 2, 3], 40)
    for _ in range(3):
        srv.step()
        srv.scheduler.audit()
    long_req = srv.submit(list(np.random.RandomState(0).randint(0, 1024, 60)),
                          4)
    steps = 0
    while long_req.prefilling or not long_req.generated:
        before = len(short.generated)
        srv.step()
        srv.scheduler.audit()
        steps += 1
        assert len(short.generated) == before + 1, \
            "decode stalled during a prefill chunk"
    assert steps == -(-60 // CHUNK)
    _drain(srv)
    assert long_req.finish_reason == "length"
    assert srv.stats()["chunk_iters_peak"] == 1


def test_preemption_between_chunks_resumes_at_the_carried_position(tiny):
    prompt = list(np.random.RandomState(11).randint(0, 1024, 40))
    geometry = dict(max_batch_size=2, max_context=128, block_size=8)
    want = _server(tiny, **geometry).generate([prompt], 8)[0]
    assert want == _jax_server(tiny, **geometry).generate([prompt], 8)[0]
    server = _server(tiny, **geometry)
    req = server.submit(prompt, 8)
    server.step()
    server.scheduler.audit()
    assert req.prefilling and req.num_cached == CHUNK
    server.scheduler.preempt(req)
    server.scheduler.audit()
    assert req.num_cached == 0 and not req.block_table
    server.step()
    server.scheduler.audit()
    assert req.running and req.prefilling and req.num_cached == CHUNK
    _drain(server)
    assert req.generated == want and req.preemptions == 1


def test_default_prefill_chunk(tiny):
    cfg, sd, _, _ = tiny
    assert InferenceServer(cfg, sd, device="cpu").prefill_chunk == 256
    assert InferenceServer(cfg, sd, device="cpu",
                           max_context=64).prefill_chunk == 64
    assert InferenceServer(cfg, sd, device="cpu",
                           enable_chunked_prefill=False).prefill_chunk \
        is None
    with pytest.raises(ValueError, match="chunk_size must be >= 1"):
        InferenceServer(cfg, sd, device="cpu", prefill_chunk=0)
    with pytest.raises(TypeError, match="SamplingParams"):
        InferenceServer(cfg, sd, device="cpu").submit(
            [1, 2], 4, sampling={"temperature": 1.0})


def _port_sampling(n=len(PROMPT_LENS)):
    return [None if s is None else SamplingParams(**s) for s in SAMPLING][:n]


def _check_near_ties(tiny, prompts, got, want, samp):
    """Each request's stream equals the JAX one until a step whose top
    two JAX scores (processed logits + noise) lie within NEAR_TIE, where
    its comparison ends; returns the count of such steps."""
    _, _, jcfg, jparams = tiny
    model = jax_models.GPTLMHeadModel(jcfg)
    ties = 0
    for p, g, w, s in zip(prompts, got, want, samp):
        for i, (a, b) in enumerate(zip(g, w)):
            if a == b:
                continue
            ids = jnp.asarray([p + w[:i]], jnp.int32)
            lg = model.apply({"params": jparams}, ids)[:, -1]
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


def test_stochastic_matches_jax_server_under_the_near_tie_rule(tiny):
    prompts = _prompts(2)
    geometry = dict(max_batch_size=4, block_size=16)
    jsamp = [None if s is None else jax_sampling.SamplingParams(**s)
             for s in SAMPLING]
    want = _jax_server(tiny, **geometry).generate(prompts, 16,
                                                  sampling=jsamp)
    server = _server(tiny, **geometry)
    got = server.generate(prompts, 16, sampling=_port_sampling())
    assert _check_near_ties(tiny, prompts, got, want, SAMPLING) == 0
    assert got == want
    assert server.stats()["sampling"]["requests"] == {
        "greedy": 1, "temperature": 2, "top_k": 1, "top_p": 1,
        "top_k_top_p": 1}


def test_stochastic_streams_are_stable_in_the_port(tiny):
    prompts = _prompts(3)
    samp = _port_sampling()
    ref = _server(tiny, max_batch_size=4, block_size=16).generate(
        prompts, 20, sampling=samp)
    variants = {
        "replay": dict(max_batch_size=4, block_size=16),
        "starved_pool": dict(max_batch_size=3, max_context=96, block_size=8,
                             num_blocks=12),
        "no_chunking": dict(max_batch_size=4, block_size=16,
                            enable_chunked_prefill=False),
        "chunk_5": dict(max_batch_size=2, block_size=16, prefill_chunk=5),
    }
    for name, kw in variants.items():
        server = _server(tiny, **kw)
        assert server.generate(prompts, 20, sampling=samp) == ref, name
        server.scheduler.audit()
        if name == "starved_pool":
            assert server.stats()["preemptions"] > 0
    greedy = _server(tiny, max_batch_size=4, block_size=16).generate(
        prompts, 20)
    for i, s in enumerate(samp):
        assert (ref[i] == greedy[i]) == (s is None), i
