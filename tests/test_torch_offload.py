"""The port's hierarchical KV offload against apex_tpu's.

Twins of ``tests/L0/test_offload.py`` on the same tiny ``GPTConfig``
(vocab 61, hidden 32, 2 layers) from the same seeds: the port's
``serving.offload`` (the host LRU, the disk tier, the payload helpers),
the prefix cache's demote and promote, and the server with
``enable_kv_offload`` against the JAX server with the same flags.  Tokens
are equal exactly, every pool passes ``audit()`` after every step, and
the offload counters are the JAX server's.

- the resolver and the environment twin;
- the store: the LRU byte bound, recency and exclusive takes, the disk
  spill and load, a torn spill, the temporary-directory sweep and the
  adoption of survivors (a spill written by either package loads in the
  other), an oversized payload;
- the payload helpers, and the port's split of its own export against
  the reference's split of the JAX engine's export of the same pool
  contents (fp32, bf16, int8): the same bytes and crcs;
- ``import_blocks``' error; the promote's failure semantics, the import
  OOM as ``MemoryError`` and as ``torch.OutOfMemoryError``;
- the server: greedy, stochastic, through the disk tier, after a corrupt
  spill, the refusal without a prefix cache, and disaggregation's cache
  home; ``_chunk_hash`` and ``stats()["offload"]``'s keys.
"""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving import SamplingParams as JaxSamplingParams
from apex_tpu.serving import offload as joffload
from apex_tpu.serving import prefix_cache as jprefix
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.serving import InferenceServer, SamplingParams
from apex_tpu_torch.serving import prefix_cache as pprefix
from apex_tpu_torch.serving.kv_cache import BlockAllocator, KVCacheConfig
from apex_tpu_torch.serving.offload import (
    KV_OFFLOAD_ENV,
    OffloadStore,
    merge_payloads,
    payload_nbytes,
    resolve_kv_offload,
    split_payload,
    verify_payload,
)
from apex_tpu_torch.serving.prefix_cache import ROOT, PrefixCache
from apex_tpu_torch.utils.meters import CounterMeter

torch.set_num_threads(1)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

# the one reference layer the port does not have yet
JAX_FLAGS = dict(enable_program_accounting=False)

OFFLOAD_COUNTERS = ("demotes", "demote_failed", "promotes_host",
                    "promotes_disk", "spills", "crc_rejects", "disk_torn",
                    "capacity_skips", "transport_skips", "host_dropped")


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, jax cfg, jax params)."""
    jcfg = jax_models.GPTConfig(**TINY)
    jparams = jax_models.GPTLMHeadModel(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return cfg, sd, jcfg, jparams


# -- resolve / env twin ----------------------------------------------------

@pytest.mark.parametrize("value", [None, True, False, "", "0", "off",
                                   "none", "false", "no", "1", "on",
                                   "true", "yes", "ON", " Yes "])
def test_resolve_kv_offload_values(value):
    assert resolve_kv_offload(value) is joffload.resolve_kv_offload(value)


def test_resolve_kv_offload_refuses_a_typo():
    with pytest.raises(ValueError, match="KV offload"):
        resolve_kv_offload("sometimes")
    assert KV_OFFLOAD_ENV == joffload.KV_OFFLOAD_ENV


def test_env_twin_fills_unset_kwarg_only(tiny, monkeypatch):
    cfg, sd, _, _ = tiny
    kw = dict(device="cpu", max_batch_size=2, max_context=64, block_size=8,
              cache_dtype=torch.float32)
    monkeypatch.setenv(KV_OFFLOAD_ENV, "1")
    on = InferenceServer(cfg, sd, **kw)
    assert on.kv_offload is True
    assert on.stats()["offload"]["enabled"] is True
    # a provided kwarg wins over the environment
    off = InferenceServer(cfg, sd, enable_kv_offload=False, **kw)
    assert off.kv_offload is False
    assert off.stats()["offload"]["enabled"] is False


# -- synthetic payloads (store unit tests need no model) -------------------

def _payload(seed, blocks=1, bs=4, rows=2):
    """A fake export_blocks payload: deterministic leaves + true crcs."""
    rng = np.random.RandomState(seed)
    leaves = {name: rng.rand(rows, blocks * bs).astype(np.float32)
              for name in ("k0", "v0")}
    return {
        "num_blocks": blocks,
        "block_size": bs,
        "leaves": leaves,
        "crc": {name: zlib.crc32(a.tobytes())
                for name, a in leaves.items()},
    }


def _key(i):
    return bytes([i]) * 16


def test_store_lru_byte_bound_drops_coldest_without_disk():
    one = payload_nbytes(_payload(0))
    store = OffloadStore(host_bytes=2 * one)
    for i in range(3):
        store.put(_key(i), _payload(i))
    # the coldest entry fell off; no disk tier -> counted as dropped
    assert store.host_entries == 2
    assert _key(0) not in store
    assert store.counters.count("host_dropped") == 1
    assert store.host_used_bytes <= store.host_bytes


def test_store_put_refreshes_recency_and_take_is_exclusive():
    one = payload_nbytes(_payload(0))
    store = OffloadStore(host_bytes=2 * one)
    store.put(_key(0), _payload(0))
    store.put(_key(1), _payload(1))
    store.put(_key(0), _payload(0))      # re-put: key 0 back to hot
    store.put(_key(2), _payload(2))      # key 1 is now the coldest
    assert _key(0) in store and _key(1) not in store
    payload, tier = store.take(_key(0))
    assert tier == "host"
    assert _key(0) not in store          # tiers exclusive: popped
    assert store.take(_key(0)) is None


def test_store_spills_coldest_to_disk_and_loads_back(tmp_path):
    one = payload_nbytes(_payload(0))
    store = OffloadStore(host_bytes=2 * one, spill_dir=str(tmp_path))
    for i in range(3):
        store.put(_key(i), _payload(i))
    assert store.counters.count("spills") == 1
    assert store.disk_entries == 1
    entry = tmp_path / _key(0).hex()
    assert (entry / "manifest.json").is_file()
    payload, tier = store.take(_key(0))
    assert tier == "disk"
    want = _payload(0)
    for name in want["leaves"]:
        np.testing.assert_array_equal(payload["leaves"][name],
                                      want["leaves"][name])
    verify_payload(payload)
    assert not entry.exists()
    assert store.disk_entries == 0


def test_store_torn_spill_reads_as_miss_and_is_deleted(tmp_path):
    one = payload_nbytes(_payload(0))
    store = OffloadStore(host_bytes=one, spill_dir=str(tmp_path))
    store.put(_key(0), _payload(0))
    store.put(_key(1), _payload(1))      # key 0 spills
    entry = tmp_path / _key(0).hex()
    leaf = entry / json.loads(
        (entry / "manifest.json").read_text())["leaves"]["k0"]["file"]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF                      # rot one payload byte
    leaf.write_bytes(bytes(raw))
    assert store.take(_key(0)) is None   # torn -> miss, never garbage
    assert store.counters.count("disk_torn") == 1
    assert not entry.exists()            # deleted whole


def test_store_sweeps_tmp_and_adopts_survivors(tmp_path):
    one = payload_nbytes(_payload(0))
    store = OffloadStore(host_bytes=one, spill_dir=str(tmp_path))
    store.put(_key(0), _payload(0))
    store.put(_key(1), _payload(1))      # key 0 published to disk
    stale = tmp_path / (".tmp-" + _key(9).hex())
    stale.mkdir()
    (stale / "leaf0.npy").write_bytes(b"half a write")
    reborn = OffloadStore(host_bytes=one, spill_dir=str(tmp_path))
    assert not stale.exists()
    assert reborn.disk_entries == 1      # restart keeps the cold tier
    payload, tier = reborn.take(_key(0))
    assert tier == "disk"
    verify_payload(payload)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_spill_format_is_the_reference_one(tmp_path, writer):
    """A spill written by either package is adopted and loaded by the
    other, bytes and crcs intact: the disk tier's format is shared."""
    stores = {"port": OffloadStore, "jax": joffload.OffloadStore}
    src = stores[writer](host_bytes=0, spill_dir=str(tmp_path))
    src.put(_key(3), _payload(3, blocks=2))
    assert src.disk_entries == 1
    other = stores["jax" if writer == "port" else "port"](
        host_bytes=0, spill_dir=str(tmp_path))
    payload, tier = other.take(_key(3))
    assert tier == "disk"
    want = _payload(3, blocks=2)
    assert payload["crc"] == want["crc"]
    for name in want["leaves"]:
        assert payload["leaves"][name].tobytes() == \
            want["leaves"][name].tobytes()


def test_store_oversized_payload_never_wedges_the_lru(tmp_path):
    big = _payload(0, blocks=8)
    store = OffloadStore(host_bytes=payload_nbytes(big) // 2)
    store.put(_key(0), big)
    assert store.host_entries == 0
    assert store.counters.count("host_dropped") == 1
    spilling = OffloadStore(host_bytes=payload_nbytes(big) // 2,
                            spill_dir=str(tmp_path))
    spilling.put(_key(0), big)
    assert spilling.host_entries == 0 and spilling.disk_entries == 1


# -- payload helpers -------------------------------------------------------

def test_verify_payload_names_the_rotten_leaf():
    payload = _payload(3)
    payload["leaves"]["v0"].view(np.uint8).reshape(-1)[0] ^= 0xFF
    with pytest.raises(ValueError, match=r"leaf 'v0'.*rejected whole"):
        verify_payload(payload)
    verify_payload(_payload(3))          # pristine twin passes


def test_merge_then_split_round_trips_per_block():
    parts = [_payload(i) for i in range(3)]
    merged = merge_payloads(parts)
    assert merged["num_blocks"] == 3
    verify_payload(merged)
    back = split_payload(dict(merged, block_crc={
        name: [p["crc"][name] for p in parts]
        for name in merged["leaves"]}))
    for got, want in zip(back, parts):
        for name in want["leaves"]:
            np.testing.assert_array_equal(got["leaves"][name],
                                          want["leaves"][name])
        verify_payload(got)


def test_split_payload_carries_engine_recorded_crcs():
    """Split slices carry the crcs RECORDED at export, never recomputed
    from the slice bytes: a recompute would bless rot after the
    export."""
    parts = [_payload(i) for i in range(2)]
    merged = merge_payloads(parts)
    merged["block_crc"] = {name: [p["crc"][name] for p in parts]
                           for name in merged["leaves"]}
    bs = merged["block_size"]
    merged["leaves"]["k0"].view(np.uint8)[0, bs * 4] ^= 0xFF
    clean, torn = split_payload(merged)
    verify_payload(clean)                # block 0 untouched
    with pytest.raises(ValueError, match="rejected whole"):
        verify_payload(torn)             # block 1 convicted


def _engines(tiny, mode):
    """A JAX server and a port server on the same pool geometry, the
    JAX pool filled by a short generate."""
    cfg, sd, jcfg, jparams = tiny
    dtype = {"float32": (torch.float32, jnp.float32),
             "bfloat16": (torch.bfloat16, jnp.bfloat16),
             "int8": (torch.float32, jnp.float32)}[mode]
    quant = "int8" if mode == "int8" else "off"
    kw = dict(max_batch_size=2, max_context=64, block_size=8,
              kv_quant=quant, enable_kv_offload=False)
    jsrv = JaxInferenceServer(jcfg, jparams, cache_dtype=dtype[1],
                              attention_fn=jax_make_flash(causal=True),
                              **kw, **JAX_FLAGS)
    jsrv.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                    17, 18, 19, 20, 21]], max_new_tokens=6)
    srv = InferenceServer(cfg, sd, device="cpu", cache_dtype=dtype[0],
                          **kw)
    return jsrv.engine, srv.engine


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_split_of_export_equals_the_reference(tiny, mode):
    """The same pool contents (the JAX engine's blocks imported into the
    port's pool): the port's per-block split of its batched export holds
    the bytes and crcs of the reference's split of the JAX export, every
    leaf (the int8 scales too), with the leaf dtypes carried."""
    jeng, peng = _engines(tiny, mode)
    ids = [1, 2, 3]
    peng.import_blocks(ids, jeng.export_blocks(ids))
    want = joffload.split_payload(jeng.export_blocks(ids,
                                                     per_block_crc=True))
    got = split_payload(peng.export_blocks(ids, per_block_crc=True))
    assert len(got) == len(want) == len(ids)
    for g, w in zip(got, want):
        assert sorted(g["leaves"]) == sorted(w["leaves"])
        assert g["crc"] == w["crc"]
        for name in w["leaves"]:
            assert g["leaves"][name].tobytes() == \
                np.asarray(w["leaves"][name]).tobytes()
        verify_payload(g)
        assert g["dtypes"]["k"] == ("int8" if mode == "int8" else mode)
    merged = merge_payloads(got)
    assert merged["dtypes"] == got[0]["dtypes"]
    assert merged["crc"] == joffload.merge_payloads(want)["crc"]


# -- import_blocks checksum rejection --------------------------------------

def test_import_blocks_error_names_leaf_blocks_and_crcs(tiny):
    cfg, sd, _, _ = tiny
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                             max_context=64, block_size=8,
                             cache_dtype=torch.float32,
                             enable_kv_offload=False)
    server.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9]], max_new_tokens=4)
    engine = server.engine
    payload = engine.export_blocks([1, 2])
    rotten = min(payload["leaves"])
    arr = payload["leaves"][rotten].copy()
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    payload["leaves"][rotten] = arr
    actual = zlib.crc32(np.ascontiguousarray(
        payload["leaves"][rotten]).tobytes())
    with pytest.raises(ValueError) as ei:
        engine.import_blocks([1, 2], payload)
    msg = str(ei.value)
    assert f"leaf {rotten!r}" in msg
    assert "[1, 2]" in msg
    assert f"{actual} (actual)" in msg
    assert f"{payload['crc'][rotten]} (expected)" in msg
    assert "rejected whole" in msg


# -- promote failure semantics (unit, fake engine) -------------------------

def test_chunk_hash_equals_the_reference():
    """Random chains: every node's content hash is the reference's bit
    for bit (they key the same store)."""
    rng = np.random.RandomState(5)
    ph, jph = pprefix._ROOT_HASH, jprefix._ROOT_HASH
    assert ph == jph
    for _ in range(64):
        chunk = [int(t) for t in rng.randint(-2**40, 2**40,
                                             size=int(rng.randint(1, 17)))]
        ph, jph = pprefix._chunk_hash(ph, chunk), \
            jprefix._chunk_hash(jph, chunk)
        assert ph == jph


def _chain_fixture(importer=None, alloc_blocks=8):
    """A PrefixCache + real allocator + fake export/import closures: two
    registered chain blocks demoted into the store, ready to promote.
    Returns (cache, allocator, store, counters, tokens)."""
    bs = 4
    alloc = BlockAllocator(KVCacheConfig(
        num_layers=1, num_heads=2, head_dim=4,
        num_blocks=alloc_blocks, block_size=bs, dtype=torch.float32))
    cache = PrefixCache(alloc, bs)
    store = OffloadStore(host_bytes=1 << 20)
    off = CounterMeter()

    def exporter(ids):
        rng = np.random.RandomState(sum(ids))
        leaves = {"k0": rng.rand(2, len(ids) * bs).astype(np.float32)}
        return {
            "num_blocks": len(ids), "block_size": bs, "leaves": leaves,
            "crc": {"k0": zlib.crc32(leaves["k0"].tobytes())},
            "block_crc": {"k0": [
                zlib.crc32(np.ascontiguousarray(
                    leaves["k0"][:, i * bs:(i + 1) * bs]).tobytes())
                for i in range(len(ids))]},
        }

    imports = []
    cache.attach_offload(
        store, exporter,
        importer or (lambda ids, p: imports.append((list(ids), p))),
        counters=off)
    tokens = list(range(2 * bs))
    blocks = alloc.alloc(2)
    assert cache.register(ROOT, tuple(tokens[:bs]), blocks[0])
    assert cache.register(blocks[0], tuple(tokens[bs:]), blocks[1])
    alloc.free(blocks)                   # -> evictable LRU holds
    assert cache.evict(2) == 2           # -> demoted into the store
    assert off.count("demotes") == 2
    assert len(store) == 2
    cache.audit()
    return cache, alloc, store, off, tokens


def test_attach_offload_refuses_after_registration():
    cache, alloc, *_ = _chain_fixture()
    blk = alloc.alloc(1)
    cache.register(ROOT, (9, 9, 9, 9), blk[0])
    with pytest.raises(RuntimeError, match="before any block registers"):
        cache.attach_offload(OffloadStore(), None, None)


def test_promote_at_capacity_puts_every_payload_back():
    cache, alloc, store, off, tokens = _chain_fixture()
    matched = []
    assert cache.promote(tokens, matched, lambda n: None) == 0
    assert matched == []
    assert off.count("capacity_skips") == 1
    assert len(store) == 2               # payloads kept warm
    cache.audit()


@pytest.mark.parametrize("error", [MemoryError, torch.OutOfMemoryError])
def test_promote_import_oom_puts_back_and_frees_fresh_blocks(error):
    def oom_importer(ids, payload):
        raise error("transient scatter OOM")
    cache, alloc, store, off, tokens = _chain_fixture(oom_importer)
    free_before = alloc.num_free
    matched = []
    assert cache.promote(tokens, matched, alloc.alloc) == 0
    assert matched == []
    assert off.count("capacity_skips") == 1
    assert len(store) == 2               # payloads kept warm
    assert alloc.num_free == free_before  # fresh blocks not leaked
    cache.audit()


@pytest.mark.parametrize("error", [MemoryError, torch.OutOfMemoryError])
def test_demote_export_oom_drops_the_batch(error):
    """An export OOM at a demote drops the victims (they die as without
    offload), counted, the index clean."""
    def exporter_oom(ids):
        raise error("transient gather OOM")
    cache, alloc, store, off, tokens = _chain_fixture()
    cache._exporter = exporter_oom
    blocks = alloc.alloc(1)
    assert cache.register(ROOT, (7, 7, 7, 7), blocks[0])
    alloc.free(blocks)
    assert cache.evict(1) == 1
    assert off.count("demote_failed") == 1 and len(store) == 2
    cache.audit()


def test_promote_happy_path_registers_the_whole_run():
    cache, alloc, store, off, tokens = _chain_fixture()
    matched = []
    assert cache.promote(tokens, matched, alloc.alloc) == 2
    assert len(matched) == 2
    assert off.count("promotes_host") == 2
    assert len(store) == 0               # tiers exclusive
    assert all(alloc.refs(b) == 1 for b in matched)
    cache.audit()


def test_promote_rejects_corrupt_payload_whole_and_cold_prefills():
    cache, alloc, store, off, tokens = _chain_fixture()
    for key in list(store._host):
        store._host[key]["leaves"]["k0"].view(
            np.uint8).reshape(-1)[0] ^= 0xFF
    matched = []
    assert cache.promote(tokens, matched, alloc.alloc) == 0
    assert matched == []
    assert off.count("crc_rejects") == 1  # first chunk convicted
    assert len(store) == 1                # corrupt entry discarded
    cache.audit()


def test_promote_with_nothing_to_promote_is_clean():
    """A walk that finds nothing returns 0 without allocating, importing
    or counting a capacity skip."""
    cache, alloc, store, off, tokens = _chain_fixture()
    free_before = alloc.num_free
    cold = [100 + t for t in range(len(tokens))]
    matched = []
    assert cache.promote(cold, matched, alloc.alloc) == 0
    assert matched == []
    assert off.count("capacity_skips") == 0
    assert off.count("crc_rejects") == 0
    assert alloc.num_free == free_before
    full = list(range(len(tokens) // 4))
    assert cache.promote(tokens, full, alloc.alloc) == 0
    assert off.count("capacity_skips") == 0
    assert len(store) == 2
    cache.audit()


# -- server-level parity across tier crossings -----------------------------

def _server_kw(num_blocks, disagg=False, **kw):
    kw.setdefault("kv_offload_host_bytes", 8 << 20)
    kw.update(max_batch_size=2, max_context=128, block_size=8,
              enable_prefix_cache=True, enable_chunked_prefill=True,
              num_blocks=num_blocks)
    if disagg:
        kw.update(enable_disagg=True, disagg_prefill_blocks=num_blocks,
                  num_blocks=None)
    return kw


def _port(tiny, offload, num_blocks, **kw):
    cfg, sd, _, _ = tiny
    return InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                           enable_kv_offload=offload,
                           **_server_kw(num_blocks, **kw))


def _jax(tiny, offload, num_blocks, **kw):
    _, _, jcfg, jparams = tiny
    return JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32,
                              attention_fn=jax_make_flash(causal=True),
                              enable_kv_offload=offload,
                              **_server_kw(num_blocks, **kw), **JAX_FLAGS)


def _sessions(n, rng):
    """n distinct session prompts: 40-token prefix + 3-token tail (5 full
    blocks each at block_size 8)."""
    return [list(rng.randint(0, VOCAB, size=43)) for _ in range(n)]


def _run(server, prompts, sampling=None):
    """One request at a time, every pool audited after every step."""
    outs = []
    for i, p in enumerate(prompts):
        sp = None if sampling is None else sampling(i)
        req = server.submit(p, 6, sampling=sp)
        while server.has_work:
            server.step()
            server.audit()
        outs.append(list(req.generated))
    return outs


def _session_traffic(server, prompts, sampling=None):
    """Two passes; pass 2 resumes every session with its pass-1 prompt,
    so each session's blocks release (and, with offload, demote) before
    the next session needs the pool."""
    return _run(server, prompts, sampling) + _run(server, prompts, sampling)


def _offload_counts(server):
    st = server.stats()["offload"]
    return {key: st[key] for key in OFFLOAD_COUNTERS}


def test_server_parity_greedy_across_demote_promote(tiny):
    prompts = _sessions(4, np.random.RandomState(7))
    # 13 blocks against 4 sessions x 6 blocks: pass 1 demotes every
    # finished session; pass 2 promotes
    jsrv = _jax(tiny, True, 13)
    want = _session_traffic(jsrv, prompts)
    srv = _port(tiny, True, 13)
    got = _session_traffic(srv, prompts)
    assert got == want
    st = srv.stats()["offload"]
    assert st["demotes"] > 0 and st["promotes_host"] > 0
    assert st["crc_rejects"] == 0 and st["promote_ms"]["count"] > 0
    assert _offload_counts(srv) == _offload_counts(jsrv)
    assert srv.stats()["transport"]["delivered"] == \
        jsrv.stats()["transport"]["delivered"] > 0
    # and the port's offload-off server: the same tokens
    assert _session_traffic(_port(tiny, False, 13), prompts) == want


def test_server_parity_stochastic_sampling(tiny):
    """Counter-keyed sampling is as blind to tier crossings as greedy."""
    def params(cls):
        return lambda i: cls(temperature=0.8, top_k=13, top_p=0.9,
                             seed=1000 + i)

    prompts = _sessions(4, np.random.RandomState(11))
    jsrv = _jax(tiny, True, 13)
    want = _session_traffic(jsrv, prompts, params(JaxSamplingParams))
    srv = _port(tiny, True, 13)
    got = _session_traffic(srv, prompts, params(SamplingParams))
    assert got == want
    assert srv.stats()["offload"]["promotes_host"] > 0
    assert _offload_counts(srv) == _offload_counts(jsrv)


def test_server_parity_through_disk_tier(tiny, tmp_path):
    """A host tier too small for one session sends every demote through
    the spill path; promotes come back from disk, tokens exact."""
    prompts = _sessions(4, np.random.RandomState(13))
    kw = dict(kv_offload_host_bytes=8 << 10)
    jsrv = _jax(tiny, True, 13, kv_offload_dir=str(tmp_path / "jax"), **kw)
    want = _session_traffic(jsrv, prompts)
    srv = _port(tiny, True, 13, kv_offload_dir=str(tmp_path / "port"), **kw)
    got = _session_traffic(srv, prompts)
    assert got == want
    st = srv.stats()["offload"]
    assert st["spills"] > 0 and st["promotes_disk"] > 0
    assert _offload_counts(srv) == _offload_counts(jsrv)


def _corrupt_spill_run(server, prompts, spill_dir):
    """Pass 1, demote every evictable chain to disk, rot every spilled
    leaf, pass 2: the promotes become verified misses."""
    got = _run(server, prompts)
    server.prefix_cache.evict(1000)
    assert server.stats()["offload"]["spills"] >= 3 * 5
    for entry in spill_dir.iterdir():
        for f in entry.glob("*.npy"):
            raw = bytearray(f.read_bytes())
            raw[-1] ^= 0xFF
            f.write_bytes(bytes(raw))
    return got + _run(server, prompts)


def test_server_corrupt_spill_cold_prefills_bit_identically(tiny, tmp_path):
    """Every on-disk spill rotted between the passes: pass 2 cold-prefills
    to the JAX server's tokens (and the offload-off server's)."""
    prompts = _sessions(3, np.random.RandomState(17))
    kw = dict(kv_offload_host_bytes=0)
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jsrv = _jax(tiny, True, 13, kv_offload_dir=str(dirs["jax"]), **kw)
    want = _corrupt_spill_run(jsrv, prompts, dirs["jax"])
    srv = _port(tiny, True, 13, kv_offload_dir=str(dirs["port"]), **kw)
    got = _corrupt_spill_run(srv, prompts, dirs["port"])
    assert got == want
    st = srv.stats()["offload"]
    assert st["disk_torn"] > 0 and st["promotes_disk"] == 0
    assert _offload_counts(srv) == _offload_counts(jsrv)
    assert _session_traffic(_port(tiny, False, 13), prompts) == want


def test_server_offload_requires_prefix_cache(tiny):
    cfg, sd, jcfg, jparams = tiny
    kw = dict(max_batch_size=2, max_context=64, block_size=8,
              enable_prefix_cache=False, enable_kv_offload=True)
    with pytest.raises(ValueError, match="prefix cache"):
        InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                        **kw)
    with pytest.raises(ValueError, match="prefix cache"):
        JaxInferenceServer(jcfg, jparams, cache_dtype=jnp.float32, **kw)


def test_server_parity_disagg_prefill_pool_is_cache_home(tiny):
    """Disaggregated: demotes export from and promotes import into the
    PREFILL pool (the cache home), the JAX server's tokens and counters."""
    prompts = _sessions(4, np.random.RandomState(19))
    jsrv = _jax(tiny, True, 17, disagg=True)
    want = _session_traffic(jsrv, prompts)
    srv = _port(tiny, True, 17, disagg=True)
    homes = []
    real = srv.prefill_engine.import_blocks
    srv.prefill_engine.import_blocks = \
        lambda ids, p: homes.append(len(ids)) or real(ids, p)
    got = _session_traffic(srv, prompts)
    assert got == want
    st = srv.stats()["offload"]
    assert st["demotes"] > 0 and st["promotes_host"] > 0
    assert sum(homes) == st["promotes_host"]
    assert _offload_counts(srv) == _offload_counts(jsrv)


def test_offload_stats_keys_equal_the_reference(tiny):
    """``stats()["offload"]`` and ``["transport"]``: the JAX server's
    keys, offload on and off (the in-process transport's counters and
    its ``"offload"`` peer either way)."""
    prompts = _sessions(2, np.random.RandomState(23))
    for offload in (True, False):
        jsrv = _jax(tiny, offload, 13)
        srv = _port(tiny, offload, 13)
        _run(jsrv, prompts)
        _run(srv, prompts)
        st, jst = srv.stats(), jsrv.stats()
        assert st["offload"].keys() == jst["offload"].keys()
        assert st["offload"]["promote_ms"].keys() <= \
            jst["offload"]["promote_ms"].keys()
        assert st["transport"] == jst["transport"]
        assert st["transport"]["backend"] == "inprocess"
        assert st["transport"]["per_peer"].keys() == {"offload"}
        assert st["offload"]["enabled"] is offload
