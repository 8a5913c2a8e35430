"""The port's prefix cache (refcounted allocator, block index,
copy-on-write) against apex_tpu's.

- The allocator and index twins of ``tests/L0/test_prefix_cache.py``'s
  unit tests (:80-184), on the port's ``BlockAllocator`` and
  ``PrefixCache``.
- Server parity: the port's ``InferenceServer`` with the prefix cache
  on (its default) against the JAX server with
  ``enable_prefix_cache=True``, the pipelined loop and the breaker on
  (both packages' defaults) and the rest of the slice's flags off (no
  speculation, overload or program accounting), chunked at 8 and unchunked, over shared-prefix traffic,
  a pool that forces preemption, one that forces eviction, a
  whole-context hit (copy-on-write) and the int8 pool.  Tokens are
  identical, ``stats()``'s prefix keys equal the JAX server's, and
  ``audit()`` passes after every step.
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
from apex_tpu_torch.serving.kv_cache import BlockAllocator, KVCacheConfig
from apex_tpu_torch.serving.prefix_cache import ROOT, PrefixCache

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

JAX_FLAGS = dict(enable_prefix_cache=True, enable_speculation=False,
                 enable_overload=False, enable_program_accounting=False,
                 mesh=None)

PREFIX_KEYS = ("prefix_hit_tokens", "prefix_miss_tokens",
               "prefix_hit_requests", "prefix_hit_rate",
               "prefix_evicted_blocks", "prefix_cow_blocks",
               "kv_blocks_cached", "kv_blocks_evictable", "preemptions",
               "prefill_chunks", "tokens_generated")


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


# -- allocator refcounts --------------------------------------------------

def _alloc(num_blocks=8, block_size=4):
    return BlockAllocator(KVCacheConfig(
        num_layers=1, num_heads=2, head_dim=4, num_blocks=num_blocks,
        block_size=block_size, dtype=torch.float32))


def test_refcount_shared_block_survives_first_free():
    alloc = _alloc()
    blocks = alloc.alloc(2)
    alloc.incref(blocks)
    assert all(alloc.refs(b) == 2 for b in blocks)
    alloc.free(blocks)
    assert all(alloc.refs(b) == 1 for b in blocks)
    assert alloc.num_free == 5
    alloc.free(blocks)
    assert alloc.num_free == 7
    assert all(alloc.refs(b) == 0 for b in blocks)


def test_refcount_free_set_mirrors_free_list():
    alloc = _alloc(num_blocks=16)
    a = alloc.alloc(5)
    b = alloc.alloc(4)
    alloc.free(a[1:3])
    alloc.free(b)
    alloc.alloc(3)
    assert set(alloc._free) == alloc._free_set
    assert len(alloc._free) == len(alloc._free_set) == alloc.num_free
    with pytest.raises(ValueError, match="double free"):
        alloc.free([a[1]])
    with pytest.raises(ValueError, match="unallocated"):
        alloc.incref([a[1]])


def test_adopt_and_release_to_free_guard_states():
    alloc = _alloc()
    (blk,) = alloc.alloc(1)
    with pytest.raises(ValueError):
        alloc.adopt(blk)                   # live, not cache-held
    kept = []
    alloc.release_hook = lambda b: kept.append(b) or True
    alloc.free([blk])                      # ref 0 -> the hook holds it
    assert kept == [blk]
    assert alloc.refs(blk) == 0 and blk not in alloc._free_set
    assert alloc.live_peak == 1
    alloc.adopt(blk)
    assert alloc.refs(blk) == 1
    alloc.release_hook = None
    alloc.free([blk])
    with pytest.raises(ValueError):
        alloc.release_to_free(blk)         # already free


def test_reset_fires_the_reset_hooks():
    alloc = _alloc()
    cache = PrefixCache(alloc, 4)
    (blk,) = alloc.alloc(1)
    cache.register(ROOT, (1, 2, 3, 4), blk)
    alloc.free([blk])
    assert cache.num_evictable == 1
    alloc.reset()
    assert cache.num_cached_blocks == cache.num_evictable == 0
    assert alloc.num_free == 7
    cache.audit()


# -- the index ------------------------------------------------------------

def test_match_register_and_lru_reactivation():
    alloc = _alloc(num_blocks=10, block_size=4)
    cache = PrefixCache(alloc, 4)
    toks = list(range(11))                 # 2 full blocks + a tail
    assert cache.match(toks) == []
    blocks = alloc.alloc(3)
    assert cache.register(ROOT, tuple(toks[0:4]), blocks[0])
    assert cache.register(blocks[0], tuple(toks[4:8]), blocks[1])
    got = cache.match(toks)
    assert got == blocks[:2]
    assert alloc.refs(blocks[0]) == 2
    cache.cancel(got)
    alloc.free(blocks)
    assert cache.num_evictable == 2        # held, not freed
    assert alloc.num_free == 9 - 2 - 1 + 1
    got2 = cache.match(toks)               # adopts the holds
    assert got2 == blocks[:2]
    assert cache.num_evictable == 0 and cache.evictable_peak == 2
    assert all(alloc.refs(b) == 1 for b in got2)
    assert cache.held_blocks() == set()
    assert cache.is_registered(blocks[1]) and \
        not cache.is_registered(blocks[2])
    cache.audit()


def test_eviction_cascades_descendants_and_frees():
    alloc = _alloc(num_blocks=10, block_size=4)
    cache = PrefixCache(alloc, 4)
    blocks = alloc.alloc(3)
    chunks = [tuple(range(i * 4, (i + 1) * 4)) for i in range(3)]
    cache.register(ROOT, chunks[0], blocks[0])
    cache.register(blocks[0], chunks[1], blocks[1])
    cache.register(blocks[1], chunks[2], blocks[2])
    alloc.free(blocks)
    assert cache.num_evictable == 3
    assert cache.evict(1) == 3             # the root is oldest: all go
    assert cache.num_cached_blocks == 0
    assert alloc.num_free == 9
    assert cache.counters.count("prefix_evicted_blocks") == 3
    assert cache.evict(1) == 0
    cache.audit()


def test_register_first_wins_on_collision():
    alloc = _alloc(num_blocks=10, block_size=4)
    cache = PrefixCache(alloc, 4)
    a, b = alloc.alloc(2)
    chunk = (1, 2, 3, 4)
    assert cache.register(ROOT, chunk, a) is True
    assert cache.register(ROOT, chunk, b) is False
    assert cache.register(ROOT, (5, 6, 7, 8), a) is False  # one key a block
    assert cache.match([1, 2, 3, 4, 9]) == [a]
    cache.cancel([a])
    with pytest.raises(ValueError, match="full block"):
        cache.register(ROOT, (1, 2), a)


def test_audit_catches_a_registered_free_block():
    alloc = _alloc()
    cache = PrefixCache(alloc, 4)
    (blk,) = alloc.alloc(1)
    cache.register(ROOT, (1, 2, 3, 4), blk)
    alloc.release_hook = None              # the hook unwired: it goes free
    alloc.free([blk])
    with pytest.raises(AssertionError, match="free list"):
        cache.audit()


# -- server parity against the JAX server ---------------------------------

def _shared_prompts():
    prefix = [(7 * i + 3) % VOCAB for i in range(24)]   # 3 full blocks
    return [prefix + [s, s + 1] for s in (5, 11, 17, 23)]


def _waves():
    rng = np.random.RandomState(7)
    return [[list(rng.randint(0, VOCAB, size=20)) for _ in range(2)]
            for _ in range(2)]


COW_PROMPT = [(3 * i + 1) % VOCAB for i in range(16)]   # 2 full blocks

# name -> (server geometry, waves of prompts run one after another, new
# tokens); each wave runs to its end before the next is submitted
SCENARIOS = {
    "shared_prefix": (dict(max_batch_size=2), [_shared_prompts()], 24),
    "preemption": (dict(max_batch_size=3, max_context=64, block_size=4,
                        num_blocks=10),
                   [[[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8],
                     [9, 9, 8, 7, 6, 5, 4, 3]]], 24),
    # 19 usable blocks; a finished request holds ~9, so the second wave
    # evicts, and the first wave again misses in part
    "eviction": (dict(max_batch_size=2, max_context=64, block_size=4,
                      num_blocks=20),
                 [_waves()[0], _waves()[1], _waves()[0]], 16),
    "cow": (dict(max_batch_size=2), [[COW_PROMPT], [COW_PROMPT]], 16),
    "int8": (dict(max_batch_size=2, kv_quant="int8"),
             [_shared_prompts()], 16),
}


def _drive(server, waves, max_new):
    """Each wave submitted and run to its end, ``audit()`` after every
    step; returns the generated tokens, wave by wave."""
    out = []
    for prompts in waves:
        reqs = [server.submit(p, max_new) for p in prompts]
        while server.scheduler.has_work:
            server.step()
            server.scheduler.audit()
        out.append([list(r.generated) for r in reqs])
    return out


@pytest.mark.parametrize("chunk", [8, None])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_parity_with_prefix_cache(tiny, name, chunk):
    cfg, sd, jcfg, jparams = tiny
    geometry, waves, max_new = SCENARIOS[name]
    geometry = {"max_context": 128, "block_size": 8, **geometry}
    geometry.setdefault("kv_quant", None)
    chunked = dict(enable_chunked_prefill=chunk is not None,
                   prefill_chunk=chunk)
    jserver = JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                                 attention_fn=jax_make_flash(causal=True),
                                 **geometry, **chunked, **JAX_FLAGS)
    want = _drive(jserver, waves, max_new)
    server = InferenceServer(cfg, sd, device="cpu",
                             cache_dtype=torch.float32,
                             enable_speculation=False,
                             enable_overload=False, **geometry, **chunked)
    assert server.prefix_cache is server.scheduler.prefix_cache is not None
    got = _drive(server, waves, max_new)
    assert got == want
    st, jst = server.stats(), jserver.stats()
    assert {k: st[k] for k in PREFIX_KEYS} == \
        {k: jst[k] for k in PREFIX_KEYS}
    # under pool pressure a request's holds go to the same pressure that
    # preempted or evicted around it: only the ample pools must hit
    if name in ("shared_prefix", "cow", "int8"):
        assert st["prefix_hit_tokens"] > 0
    if name == "cow":
        assert st["prefix_cow_blocks"] == 1 and got[0] == got[1]
    if name == "eviction":
        assert st["prefix_evicted_blocks"] > 0
    if name == "preemption":
        assert st["preemptions"] > 0
    alloc = server.engine.allocator
    assert alloc.num_live == 0 and alloc.num_free + \
        st["kv_blocks_evictable"] == server.engine.cache_cfg.num_blocks - 1
    assert st["memory"]["blocks_evictable"] == st["kv_blocks_evictable"]
    assert st["memory"]["blocks_evictable_peak"] == \
        jst["memory"]["blocks_evictable_peak"]
    server.audit()


def test_cow_copies_every_leaf_of_the_int8_pool(tiny):
    """A whole-context hit on the int8 pool: the copied block equals its
    source on every leaf (payload and scales) when the copy lands, and
    the tokens equal the first run's."""
    cfg, sd, _, _ = tiny
    server = InferenceServer(cfg, sd, device="cpu",
                             cache_dtype=torch.float32, kv_quant="int8",
                             max_batch_size=2, block_size=8,
                             enable_speculation=False)
    first = server.generate([COW_PROMPT], 8)[0]
    engine, copied = server.engine, []
    copy = engine.copy_blocks

    def probe(pairs):
        copy(pairs)
        for src, dst in pairs:
            copied.append({name: torch.equal(t[:, dst * 8:(dst + 1) * 8],
                                             t[:, src * 8:(src + 1) * 8])
                           for name, t in engine.cache.items()})

    engine.copy_blocks = probe
    assert server.generate([COW_PROMPT], 8)[0] == first
    assert copied == [dict.fromkeys(("k", "k_scale", "v", "v_scale"), True)]
    assert server.stats()["prefix_cow_blocks"] == 1
    server.audit()


def test_opt_out_keeps_the_cacheless_server(tiny):
    cfg, sd, _, _ = tiny
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                             cache_dtype=torch.float32,
                             enable_prefix_cache=False)
    assert server.prefix_cache is None and \
        server.scheduler.prefix_cache is None
    assert server.engine.allocator.release_hook is None
    server.generate(_shared_prompts()[:2], 4)
    st = server.stats()
    assert "prefix_hit_tokens" not in st and "kv_blocks_cached" not in st
    assert server.engine.allocator.num_free == \
        server.engine.cache_cfg.num_blocks - 1


@pytest.mark.parametrize("chunk", [8, None])
def test_default_server_matches_jax_defaults(tiny, chunk):
    """The port's server with its defaults (prefix cache, speculation and
    overload control on) against the JAX server with the same layers
    on: shared-prefix traffic with whole-context hits and repetitive
    prompts, tokens and every listed counter equal."""
    cfg, sd, jcfg, jparams = tiny
    snippet = [4, 9, 4, 9, 2]
    waves = [_shared_prompts()[:2],
             _shared_prompts()[2:] + [_shared_prompts()[0][:24]] * 2
             + [snippet * 3]]
    chunked = dict(enable_chunked_prefill=chunk is not None,
                   prefill_chunk=chunk)
    geometry = dict(max_batch_size=3, max_context=128, block_size=8)
    jserver = JaxInferenceServer(
        jcfg, jparams, cache_dtype=jnp.float32, kv_quant=None,
        attention_fn=jax_make_flash(causal=True),
        enable_program_accounting=False, mesh=None, **geometry, **chunked)
    server = InferenceServer(cfg, sd, device="cpu",
                             cache_dtype=torch.float32, **geometry, **chunked)
    assert server.speculating and server.overload_policy is not None \
        and server.prefix_cache is not None
    assert _drive(server, waves, 20) == _drive(jserver, waves, 20)
    st, jst = server.stats(), jserver.stats()
    assert {k: st[k] for k in PREFIX_KEYS} == \
        {k: jst[k] for k in PREFIX_KEYS}
    for key in ("drafted_tokens", "accepted_tokens", "verify_steps",
                "decode_steps", "decode_tokens"):
        assert st["speculation"][key] == jst["speculation"][key], key
    assert st["prefix_cow_blocks"] == 2 and \
        st["speculation"]["accepted_tokens"] > 0
    assert st["pressure_peak"] == jst["pressure_peak"]
    server.audit()
