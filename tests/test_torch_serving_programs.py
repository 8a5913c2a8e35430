"""The port's serving programs against apex_tpu's: block copies, the
chunk and verify steps, the checksummed export/import and the weight
swap.

- ``copy_blocks``/``copy_blocks_across`` against the JAX functions on
  the same random pools, bit for bit, fp32 and int8 (scale sidecar)
  leaves, a chained batch included (a pair whose source is another's
  destination copies the OLD block);
- ``slot_index`` past the block table lands in the garbage block, and a
  chunk whose padded tail runs past the table writes nothing outside the
  request's blocks and block 0;
- ``DecodeEngine.chunk_prefill`` and ``verify`` against the JAX
  engine's on the tiny GPT of ``tests/test_torch_gpt_serving.py``:
  logits within ``LOGIT_TOL`` scale-aware (max|a-b| / (max|b| + 1)),
  the pool after each call within the same; from the int8 pool the
  byte rule and the logit tolerance of ``tests/test_torch_kv_quant.py``
  (``Q8_LOGIT_TOL``: a byte may sit one quantization step apart where
  the two frameworks' fp32 projections round apart); the sampled twins'
  greedy ids are the argmax of the JAX logits;
- ``export_blocks``' crc32s equal the JAX engine's for the same pool
  contents (fp32, bf16, int8 with its sidecar), the round trip and a
  JAX payload's import bit for bit; torn, re-shaped and empty payloads
  as ``tests/L0/test_disagg.py:267``, ``test_offload.py:250`` and
  ``test_transport.py:781`` hold the JAX engine (those tests are read,
  not edited);
- ``swap_params`` loads new weights into the same tensors.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu.serving.engine import DecodeEngine as JaxDecodeEngine
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from apex_tpu_torch.serving import DecodeEngine, KVCacheConfig, kv_cache

jax_da = importlib.import_module("apex_tpu.ops.decode_attention")

torch.set_num_threads(1)

LOGIT_TOL = 1e-5
Q8_LOGIT_TOL = 1e-4

TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _np(t):
    """A pool leaf as numpy (bf16 as float32 values)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


def _engines(tiny, quant=None, dtype=torch.float32, **kw):
    cfg, sd, jcfg, jparams = tiny
    geometry = dict(max_batch_size=4, block_size=16)
    geometry.update(kw)
    eng = DecodeEngine(cfg, sd, device="cpu", cache_dtype=dtype,
                       kv_quant=quant, **geometry)
    jeng = JaxDecodeEngine(jcfg, jparams, cache_dtype=_JAX_DTYPES[dtype],
                           kv_quant=quant, **geometry)
    return eng, jeng


def _assert_pools_match(eng, jeng):
    for name, got in eng.cache.items():
        want = np.asarray(jeng.cache[name], np.float32)
        if name in ("k", "v") and eng.quantized:
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        else:
            assert rel_err(_np(got), want) <= LOGIT_TOL, name


# -- block copies ---------------------------------------------------------

def _random_pools(quant, seed=0):
    cfg = KVCacheConfig(num_layers=2, num_heads=2, head_dim=4, num_blocks=6,
                        block_size=4, dtype=torch.float32, quantize=quant)
    rng = np.random.RandomState(seed)
    pools = {}
    for name, t in kv_cache.init_kv_cache(cfg, "cpu").items():
        if t.dtype == torch.int8:
            pools[name] = rng.randint(-127, 128, t.shape).astype(np.int8)
        else:
            pools[name] = rng.randn(*t.shape).astype(np.float32)
    return pools


# a chained batch: 2 -> 3 reads the old 2 that 1 -> 2 overwrites, and
# 3 -> 1 the old 3; two (0, 0) pads
PAIRS = [(1, 2), (2, 3), (3, 1), (4, 5), (0, 0), (0, 0)]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_copy_blocks_match_jax_bit_for_bit(quant):
    pools = _random_pools(quant)
    src = np.array([p[0] for p in PAIRS], np.int32)
    dst = np.array([p[1] for p in PAIRS], np.int32)
    want = jax_kv.copy_blocks({k: jnp.asarray(v) for k, v in pools.items()},
                              jnp.asarray(src), jnp.asarray(dst), 4)
    got = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    kv_cache.copy_blocks(got, torch.from_numpy(src), torch.from_numpy(dst),
                         4)
    assert set(got) == set(want)
    for name in got:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), \
            name
    # the chain read the old pool: block 1 now holds block 3's old rows
    np.testing.assert_array_equal(got["k"][:, 4:8].numpy(),
                                  pools["k"][:, 12:16])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_copy_blocks_across_match_jax_bit_for_bit(quant):
    a, b = _random_pools(quant, 1), _random_pools(quant, 2)
    src = np.array([1, 5, 2, 0], np.int32)
    dst = np.array([3, 1, 2, 0], np.int32)
    want = jax_kv.copy_blocks_across(
        {k: jnp.asarray(v) for k, v in b.items()},
        {k: jnp.asarray(v) for k, v in a.items()},
        jnp.asarray(src), jnp.asarray(dst), 4)
    got = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    srcpool = {k: torch.from_numpy(v) for k, v in a.items()}
    kv_cache.copy_blocks_across(got, srcpool, torch.from_numpy(src),
                                torch.from_numpy(dst), 4)
    for name in got:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), \
            name


def test_slot_index_past_the_table_lands_in_the_garbage_block():
    tables = np.array([[3, 7, 2], [5, 0, 0]], np.int32)
    pos = np.array([[0, 5, 9, 11], [3, 4, 12, 23]], np.int32)
    got = kv_cache.slot_index(torch.from_numpy(tables).long(),
                              torch.from_numpy(pos).long(), 4).numpy()
    want = np.asarray(jax_kv.slot_index(jnp.asarray(tables),
                                        jnp.asarray(pos), 4))
    inside = pos < tables.shape[1] * 4
    np.testing.assert_array_equal(got[inside], want[inside])
    # past the table: the garbage block, as an unallocated entry
    np.testing.assert_array_equal(got[~inside], pos[~inside] % 4)
    one = kv_cache.slot_index(torch.from_numpy(tables).long(),
                              torch.tensor([13, 2]), 4)
    assert one.tolist() == [1, 22]


# -- chunk prefill and verify ---------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
def test_chunk_prefill_and_verify_match_jax(tiny, quant):
    eng, jeng = _engines(tiny, quant)
    tol = Q8_LOGIT_TOL if quant else LOGIT_TOL
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, TINY["vocab_size"], n))
               for n in (21, 9, 35)]
    tables = []
    before = launch_counts()
    for p in prompts:
        table = eng.allocator.alloc(-(-(len(p) + 6) // 16))
        assert jeng.allocator.alloc(len(table)) == table
        for start in range(0, len(p), 8):
            chunk = p[start:start + 8]
            got = eng.chunk_prefill(chunk, start, table, pad_to=8)
            want = np.asarray(jeng.chunk_prefill(chunk, start, table,
                                                 pad_to=8))
            assert got.shape == (TINY["vocab_size"],)
            assert rel_err(got.numpy(), want) <= tol
        tables.append(table)
    _assert_pools_match(eng, jeng)
    # verify: each slot's pending token and 3 drafts, slot 3 idle, slot
    # 1 with one valid column
    k = 4
    toks = rng.randint(0, TINY["vocab_size"], (4, k))
    lengths = np.array([4, 1, 4, 0])
    positions = np.array([len(p) for p in prompts] + [0])
    tab = np.zeros((4, eng.blocks_per_seq), np.int64)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    toks[3] = 0
    got = eng.verify(toks, lengths, positions, tab)
    want = np.asarray(jeng.verify(toks, lengths, positions, tab))
    assert got.shape == (4, k, TINY["vocab_size"])
    for i in range(3):
        n = lengths[i]
        assert rel_err(got[i, :n].numpy(), want[i, :n]) <= tol
    _assert_pools_match(eng, jeng)
    assert launch_counts() == before, "the CPU path launched a kernel"


def test_sampled_twins_take_the_argmax(tiny):
    eng, jeng = _engines(tiny)
    p = list(range(3, 30))
    table = eng.allocator.alloc(3)
    jeng.allocator.alloc(3)
    want = np.asarray(jeng.chunk_prefill(p[:16], 0, table, pad_to=16))
    ids, fin = eng.chunk_prefill_sampled(p[:16], 0, table, pad_to=16)
    assert ids.dtype == torch.int32 and bool(fin[0])
    assert int(ids[0]) == int(np.argmax(want))
    tab = np.zeros((4, eng.blocks_per_seq), np.int64)
    tab[0, :3] = table
    toks = np.zeros((4, 3), np.int64)
    toks[0] = [5, 6, 7]
    lengths, positions = np.array([3, 0, 0, 0]), np.array([16, 0, 0, 0])
    want = np.asarray(jeng.verify(toks, lengths, positions, tab))
    ids, fin = eng.verify_sampled(toks, lengths, positions, tab)
    assert ids.shape == fin.shape == (4, 3)
    np.testing.assert_array_equal(ids[0].numpy(), np.argmax(want[0], -1))


def test_chunk_past_the_table_writes_only_its_blocks_and_block_0(tiny):
    """max_context 36 and block 8: a table of 5 blocks (40 slots); the
    last chunk of 16 starts at 32 and its padded tail reaches position
    47, past the table and past the prompt."""
    eng, jeng = _engines(tiny, max_context=36, block_size=8, num_blocks=9)
    p = list(np.random.RandomState(5).randint(0, 1024, 35))
    table = eng.allocator.alloc(5)
    assert jeng.allocator.alloc(5) == table
    for start in (0, 16, 32):
        got = eng.chunk_prefill(p[start:start + 16], start, table, pad_to=16)
        want = np.asarray(jeng.chunk_prefill(p[start:start + 16], start,
                                             table, pad_to=16))
        assert rel_err(got.numpy(), want) <= LOGIT_TOL
    untouched = [b for b in range(1, 9) if b not in table]
    for name, pool in eng.cache.items():
        for b in untouched:
            assert not pool[:, b * 8:(b + 1) * 8].any(), (name, b)
    # the request's 35 tokens are in place (the JAX pool's values)
    slots = eng._block_slots(table, 5)[:35]
    for name, pool in eng.cache.items():
        assert rel_err(pool[:, slots].numpy(),
                       np.asarray(jeng.cache[name])[:, slots]) <= LOGIT_TOL


def test_masked_context_slots_do_not_reach_a_chunk():
    """``tests/L0/test_decode_attention.py:103``'s twin on the port: a
    chunk starting mid-block gathers unwritten slots past ``start``;
    poisoning them changes no bit, and the output equals the JAX op's."""
    from apex_tpu_torch.ops import chunk_cached_attention
    rng = np.random.RandomState(8)
    start, t, c = 13, 24, 5
    q = rng.randn(1, c, 2, 8).astype(np.float32)
    k = rng.randn(1, t + c, 2, 8).astype(np.float32)
    v = rng.randn(1, t + c, 2, 8).astype(np.float32)
    bias = np.full((1, t), -1e9, np.float32)
    bias[0, :start] = 0.0
    ref = chunk_cached_attention(*(torch.from_numpy(x)
                                   for x in (q, k, v, bias)))
    k2, v2 = k.copy(), v.copy()
    k2[:, start:t] = 1e4
    v2[:, start:t] = -1e4
    got = chunk_cached_attention(*(torch.from_numpy(x)
                                   for x in (q, k2, v2, bias)))
    assert torch.equal(ref, got)
    want = np.asarray(jax_da.chunk_cached_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias))))
    assert rel_err(ref.numpy(), want) <= LOGIT_TOL


# -- copies between engines, export and import ----------------------------

def test_copy_blocks_and_copy_blocks_from_between_two_engines(tiny):
    cfg, sd, _, _ = tiny
    kw = dict(device="cpu", max_batch_size=2, block_size=8, max_context=64,
              cache_dtype=torch.float32, kv_quant="int8")
    a, b = DecodeEngine(cfg, sd, **kw), DecodeEngine(cfg, sd, **kw)
    table = a.allocator.alloc(3)
    a.prefill(list(range(1, 20)), table)
    dst = b.allocator.alloc(3)
    b.copy_blocks_from(a, list(zip(table, dst)))
    sa, sb = a._block_slots(table, 3), b._block_slots(dst, 3)
    for name in a.cache:
        assert torch.equal(a.cache[name][:, sa], b.cache[name][:, sb]), name
    # inside one pool: nine pairs, more than the reference's _COPY_WIDTH
    more = b.allocator.alloc(9)
    pairs = [(dst[i % 3], more[i]) for i in range(9)]
    b.copy_blocks(pairs)
    for s, d in pairs:
        for name, pool in b.cache.items():
            assert torch.equal(pool[:, s * 8:(s + 1) * 8],
                               pool[:, d * 8:(d + 1) * 8]), name


def _load_jax_pool(eng, jeng):
    """The JAX engine's pool contents into the port engine's tensors."""
    for name, pool in eng.cache.items():
        src = np.ascontiguousarray(np.asarray(jeng.cache[name]))
        pool.copy_(torch.from_numpy(src.view(np.uint8).copy()).view(
            pool.dtype).reshape(pool.shape))


@pytest.mark.parametrize("dtype,quant", [(torch.float32, None),
                                         (torch.bfloat16, None),
                                         (torch.float32, "int8")])
def test_export_crc_equals_jax_and_import_is_bit_for_bit(tiny, dtype, quant):
    eng, jeng = _engines(tiny, quant, dtype, max_context=64, block_size=8)
    table = jeng.allocator.alloc(3)
    eng.allocator.alloc(3)
    jeng.prefill(list(range(2, 22)), table)
    _load_jax_pool(eng, jeng)
    got = eng.export_blocks(table, per_block_crc=True)
    want = jeng.export_blocks(table, per_block_crc=True)
    assert got["crc"] == want["crc"] and got["block_crc"] == want["block_crc"]
    assert (got["num_blocks"], got["block_size"]) == (3, 8)
    assert got["dtypes"]["k"] == ("int8" if quant else
                                  str(dtype).removeprefix("torch."))
    for name, leaf in got["leaves"].items():
        assert leaf.tobytes() == np.asarray(want["leaves"][name]).tobytes()
        assert zlib.crc32(leaf.tobytes()) == got["crc"][name]
    # the round trip and the JAX payload, each into fresh blocks
    for payload in (got, want):
        dst = eng.allocator.alloc(3)
        eng.import_blocks(dst, payload)
        s, d = eng._block_slots(table, 3), eng._block_slots(dst, 3)
        for name, pool in eng.cache.items():
            assert torch.equal(pool[:, s], pool[:, d]), name


def test_torn_and_mismatched_payloads_are_rejected_whole(tiny):
    cfg, sd, _, _ = tiny
    eng = DecodeEngine(cfg, sd, device="cpu", max_batch_size=2,
                       max_context=64, block_size=8,
                       cache_dtype=torch.float32)
    eng.prefill(list(range(1, 18)), eng.allocator.alloc(3))
    payload = eng.export_blocks([1, 2])
    before = {n: a.clone() for n, a in eng.cache.items()}
    rotten = min(payload["leaves"])
    arr = payload["leaves"][rotten].copy()
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    torn = {**payload, "leaves": {**payload["leaves"], rotten: arr}}
    actual = zlib.crc32(arr.tobytes())
    with pytest.raises(ValueError) as ei:
        eng.import_blocks([4, 5], torn)
    msg = str(ei.value)
    assert f"leaf {rotten!r}" in msg and "[4, 5]" in msg
    assert f"{actual} (actual)" in msg
    assert f"{payload['crc'][rotten]} (expected)" in msg
    assert "rejected whole" in msg and "torn" in msg
    with pytest.raises(ValueError, match="geometry mismatch"):
        eng.import_blocks([4], payload)
    with pytest.raises(ValueError, match="quantization modes"):
        eng.import_blocks([4, 5], {**payload, "leaves": {
            **payload["leaves"], "k_scale": payload["leaves"]["k"]}})
    for name, pool in eng.cache.items():
        assert torch.equal(pool, before[name]), name


def test_empty_import_touches_nothing(tiny):
    cfg, sd, _, _ = tiny
    eng = DecodeEngine(cfg, sd, device="cpu", max_batch_size=2,
                       max_context=64, block_size=8,
                       cache_dtype=torch.float32)
    eng.prefill(list(range(1, 10)), eng.allocator.alloc(2))
    eng.cache["k"][:, :8] = 3.0            # bytes in the garbage block
    before = {n: a.clone() for n, a in eng.cache.items()}
    empty = eng.export_blocks([])
    assert empty["num_blocks"] == 0
    eng.import_blocks([], empty)
    for name, pool in eng.cache.items():
        assert torch.equal(pool, before[name]), name
    with pytest.raises(ValueError, match="geometry mismatch"):
        eng.import_blocks([], eng.export_blocks([1]))


def test_swap_params_loads_into_the_same_tensors(tiny):
    cfg, sd, _, _ = tiny
    other = GPTLMHeadModel(cfg, device="cpu", seed=7).state_dict()
    kw = dict(device="cpu", max_batch_size=2, max_context=64,
              block_size=8, cache_dtype=torch.float32)
    eng = DecodeEngine(cfg, sd, **kw)
    ptrs = {n: p.data_ptr() for n, p in eng.model.state_dict().items()}
    eng.swap_params(other)
    assert {n: p.data_ptr() for n, p in eng.model.state_dict().items()} \
        == ptrs
    fresh = DecodeEngine(cfg, other, **kw)
    p = [4, 8, 15, 16, 23, 42]
    got = eng.prefill(p, eng.allocator.alloc(1))
    assert torch.equal(got, fresh.prefill(p, fresh.allocator.alloc(1)))
