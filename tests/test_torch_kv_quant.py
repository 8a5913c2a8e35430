"""The port's int8 KV path against apex_tpu's.

``quantize_kv``/``dequantize_kv`` bit for bit; ``cached_attention`` with
scales against the JAX reference and against the JAX package's B8 in
interpret mode (``use_pallas=True, interpret=True``, as
``tests/L0/test_kv_quant.py`` runs it) within rtol 2e-5 / atol 2e-6
(fp32 softmax over sums in another order); the port's plain version on
int8 inputs bit for bit against itself on dequantized ones; the pool's
byte accounting, the cache-dtype resolution under amp, and the quantized
server (pool bytes, logits, tokens, memory stats) against the JAX server
at the tiny configuration of ``tests/test_torch_gpt_serving.py``.
Logits: scale-aware error max|a-b| / (max|b| + 1) <= 1e-4; tokens
identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu import models as jax_models
from apex_tpu.amp._amp_state import _amp_state as jax_amp_state
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu_torch import amp
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from apex_tpu_torch.ops import (
    INT8_QMAX,
    cached_attention,
    chunk_cached_attention,
    dequantize_kv,
    quantize_kv,
)
from apex_tpu_torch.serving import (
    DecodeEngine,
    InferenceServer,
    KVCacheConfig,
    resolve_cache_dtype,
    resolve_kv_quant,
)

jax_da = importlib.import_module("apex_tpu.ops.decode_attention")
jax_q = importlib.import_module("apex_tpu.ops.kv_quant")

torch.set_num_threads(1)

LOGIT_TOL = 1e-4

TINY = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)

SLICE_FLAGS = dict(enable_prefix_cache=False, enable_chunked_prefill=False,
                   enable_speculation=False, enable_pipeline=False,
                   enable_overload=False, enable_breaker=False,
                   enable_streaming=False, enable_program_accounting=False,
                   mesh=None)

PROMPT_LENS = (5, 17, 30, 9, 12, 3)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _jax_params(kw, seed):
    m = jax_models.GPTLMHeadModel(jax_models.GPTConfig(**kw))
    params = m.init(jax.random.PRNGKey(seed),
                    jnp.ones((1, 8), jnp.int32))["params"]
    return m, params


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port state_dict, JAX params, JAX int8 server)."""
    _, jparams = _jax_params(TINY, 0)
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jserver = JaxInferenceServer(
        jax_models.GPTConfig(**TINY), jparams, max_batch_size=4,
        block_size=16, cache_dtype=jnp.float32, kv_quant="int8",
        attention_fn=jax_make_flash(causal=True), **SLICE_FLAGS)
    return cfg, sd, jparams, jserver


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, TINY["vocab_size"], size=n))
            for n in PROMPT_LENS]


def _quant_inputs(seed):
    """(..., 16) vectors with an all-zero one, values on .5 rounding
    boundaries of the int8 grid, and +/- absmax."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(5, 9, 3, 16) * rng.rand(5, 9, 3, 1) * 8).astype(np.float32)
    x[1, 2, 0] = 0.0
    # absmax 127: x / scale = x exactly, so k + 0.5 sits on the boundary
    x[2, 3, 1] = np.arange(-7.5, 8.5, 1.0)
    x[2, 3, 1, 0] = 127.0
    x[3, 4, 2] = -x[3, 4, 2]
    x[3, 4, 2, 5] = -np.abs(x[3, 4, 2]).max() * 1.0
    return x


# -- the quantization primitives --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_jax_bitwise(dtype):
    x = _quant_inputs(0)
    jq, js = jax_q.quantize_kv(jnp.asarray(x).astype(dtype))
    q, s = quantize_kv(_t(x, getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.all(q.numpy()[1, 2, 0] == 0) and s[1, 2, 0] == 0
    assert int(q.abs().max()) == INT8_QMAX
    # .5 boundaries round half to even
    assert list(q.numpy()[2, 3, 1, 1:5]) == [-6, -6, -4, -4]
    for out in ("float32", "bfloat16"):
        want = jax_q.dequantize_kv(jq, js, getattr(jnp, out))
        got = dequantize_kv(q, s, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.all(dequantize_kv(q, s, torch.float32)[1, 2, 0] == 0)


# -- attention with scales --------------------------------------------------

def _attention_inputs(t, seed, b=3, h=2, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, t, h, d).astype(np.float32)
    v = rng.randn(b, t, h, d).astype(np.float32)
    k[0, :, 1] = 0.0                        # zero scales on one head
    bias = np.zeros((b, t), np.float32)
    bias[1, t - 10:] = -1e30                # masked tail
    kq, ks = jax_q.quantize_kv(jnp.asarray(k))
    vq, vs = jax_q.quantize_kv(jnp.asarray(v))
    return q, kq, ks, vq, vs, bias


@pytest.mark.parametrize("t", [37, 160])     # within one / across k blocks
def test_cached_attention_with_scales_matches_jax(t):
    q, kq, ks, vq, vs, bias = _attention_inputs(t, t)
    jargs = (jnp.asarray(q), kq, vq)
    jkw = dict(kv_bias=jnp.asarray(bias), k_scale=ks, v_scale=vs)
    oracle = jax_da.cached_attention(*jargs, use_pallas=False, **jkw)
    kernel = jax_da.cached_attention(*jargs, use_pallas=True, interpret=True,
                                     block_k=128, **jkw)
    before = launch_counts()
    got = cached_attention(_t(q), _t(kq), _t(vq), kv_bias=_t(bias),
                           k_scale=_t(ks), v_scale=_t(vs))
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got.shape == q.shape and got.dtype == torch.float32
    for want in (oracle, kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_with_scales_equals_it_on_dequantized_inputs(dtype):
    q, kq, ks, vq, vs, bias = _attention_inputs(160, 5)
    q, kq, ks, vq, vs = (_t(a) for a in (q, kq, ks, vq, vs))
    q = q.to(dtype)
    got = cached_attention(q, kq, vq, kv_bias=_t(bias), k_scale=ks,
                           v_scale=vs)
    want = cached_attention(q, dequantize_kv(kq, ks, dtype),
                            dequantize_kv(vq, vs, dtype), kv_bias=_t(bias))
    assert got.dtype == dtype and torch.equal(got, want)
    c = 4
    qc = torch.randn(3, c, 2, 16, generator=torch.Generator().manual_seed(1))
    qc = qc.to(dtype)
    kq2, vq2 = (torch.cat([x, x[:, :c]], dim=1) for x in (kq, vq))
    ks2, vs2 = (torch.cat([x, x[:, :c]], dim=1) for x in (ks, vs))
    ctx_bias = _t(bias)
    got = chunk_cached_attention(qc, kq2, vq2, ctx_bias, k_scale=ks2,
                                 v_scale=vs2)
    want = chunk_cached_attention(qc, dequantize_kv(kq2, ks2, dtype),
                                  dequantize_kv(vq2, vs2, dtype), ctx_bias)
    assert torch.equal(got, want)


def test_chunk_cached_attention_with_scales_matches_jax():
    rng = np.random.RandomState(2)
    b, t, c, h, d = 2, 20, 5, 2, 16
    q = rng.randn(b, c, h, d).astype(np.float32)
    kq, ks = jax_q.quantize_kv(jnp.asarray(rng.randn(b, t + c, h, d),
                                           jnp.float32))
    vq, vs = jax_q.quantize_kv(jnp.asarray(rng.randn(b, t + c, h, d),
                                           jnp.float32))
    ctx_bias = np.zeros((b, t), np.float32)
    ctx_bias[0, 12:] = -1e9
    want = jax_da.chunk_cached_attention(jnp.asarray(q), kq, vq,
                                         jnp.asarray(ctx_bias), k_scale=ks,
                                         v_scale=vs)
    got = chunk_cached_attention(_t(q), _t(kq), _t(vq), _t(ctx_bias),
                                 k_scale=_t(ks), v_scale=_t(vs))
    assert rel_err(got.numpy(), want) <= 1e-5


def test_scale_checks_match_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(1, 1, 2, 8).astype(np.float32)
    kq, ks = quantize_kv(_t(rng.randn(1, 8, 2, 8).astype(np.float32)))
    jkq, jks = jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy())
    for fn, args, jargs in (
            (cached_attention, (_t(q), kq, kq), (jnp.asarray(q), jkq, jkq)),
            (chunk_cached_attention, (_t(q), kq, kq, torch.zeros(1, 7)),
             (jnp.asarray(q), jkq, jkq, jnp.zeros((1, 7))))):
        jfn = getattr(jax_da, fn.__name__)
        for kw, match in ((dict(k_scale=0), "together"),
                          (dict(v_scale=0), "together"),
                          (dict(k_scale=1, v_scale=1), "scales must be")):
            port_kw = {key: (ks if val == 0 else ks[:, :4])
                       for key, val in kw.items()}
            jax_kw = {key: (jks if val == 0 else jks[:, :4])
                      for key, val in kw.items()}
            with pytest.raises(ValueError, match=match):
                jfn(*jargs, **jax_kw)
            with pytest.raises(ValueError, match=match):
                fn(*args, **port_kw)


# -- configuration ----------------------------------------------------------

def test_resolve_kv_quant_values_match_jax():
    for value in (None, "", "0", "none", "off", " OFF ", "1", "int8",
                  "INT8"):
        assert resolve_kv_quant(value) == jax_kv.resolve_kv_quant(value)
    for bad in ("fp4", "int4", 8):
        with pytest.raises(ValueError, match="int8"):
            jax_kv.resolve_kv_quant(bad)
        with pytest.raises(ValueError, match="int8"):
            resolve_kv_quant(bad)


@pytest.mark.parametrize("geometry", [
    dict(num_layers=2, num_heads=4, head_dim=64, num_blocks=10,
         block_size=16),
    dict(num_layers=12, num_heads=12, head_dim=64, num_blocks=129,
         block_size=16),
    dict(num_layers=3, num_heads=2, head_dim=16, num_blocks=7,
         block_size=4)])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_byte_accounting_matches_jax(geometry, quantize, dtype):
    port = KVCacheConfig(dtype=getattr(torch, dtype), quantize=quantize,
                         **geometry)
    ref = jax_kv.KVCacheConfig(dtype=getattr(jnp, dtype), quantize=quantize,
                               **geometry)
    for name in ("num_slots", "usable_tokens", "quantized",
                 "scale_bytes_per_block", "bytes_per_block"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.bytes() == ref.bytes()
    assert str(port.storage_dtype()).removeprefix("torch.") == \
        str(ref.storage_dtype())
    if geometry["num_layers"] == 12 and quantize == "int8":
        assert port.bytes_per_block == 313_344      # GPT-2 small, int8
    with pytest.raises(ValueError, match="quantize"):
        KVCacheConfig(quantize="fp8", **geometry)


def test_resolve_cache_dtype_refuses_integer_dtypes():
    for bad in (torch.int8, torch.int32, "int8"):
        with pytest.raises(TypeError, match="quantize='int8'"):
            resolve_cache_dtype(bad)
    with pytest.raises(TypeError, match="quantize='int8'"):
        KVCacheConfig(num_layers=1, num_heads=2, head_dim=8, num_blocks=4,
                      dtype=torch.int8)
    assert resolve_cache_dtype(torch.float16) == torch.float16


def test_cache_dtype_follows_the_amp_policy_in_both_packages():
    """With ``dtype=None`` both packages take the installed amp policy's
    ``cast_model_type``: float32 after O0, bfloat16 after O2; bfloat16
    with no policy."""
    saved = (_amp_state.opt_properties, _amp_state.verbosity,
             jax_amp_state.opt_properties, jax_amp_state.verbosity)
    cfg = GPTConfig(**TINY)
    try:
        for level, want in (("O0", torch.float32), ("O2", torch.bfloat16)):
            amp.initialize(GPTLMHeadModel(cfg, device="cpu", seed=0),
                           opt_level=level, verbosity=0)
            jax_amp.initialize(
                jax_models.GPTLMHeadModel(jax_models.GPTConfig(**TINY)),
                opt_level=level, verbosity=0)
            assert resolve_cache_dtype() == want
            assert str(jax_kv.resolve_cache_dtype()) == \
                str(want).removeprefix("torch.")
            eng = DecodeEngine(cfg, GPTLMHeadModel(cfg, device="cpu",
                                                   seed=0).state_dict(),
                               device="cpu", max_batch_size=1,
                               max_context=32)
            assert eng.cache["k"].dtype == want
        _amp_state.opt_properties = None
        assert resolve_cache_dtype() == torch.bfloat16
    finally:
        (_amp_state.opt_properties, _amp_state.verbosity,
         jax_amp_state.opt_properties, jax_amp_state.verbosity) = saved


# -- the quantized server against the JAX one -------------------------------

def _lockstep(eng, jeng, prompts, steps):
    """Prefill ``prompts`` and decode ``steps`` greedy tokens in both
    engines; returns the (port, jax) logits of every call."""
    tables, lengths, tokens, pairs = [], [], [], []
    for p in prompts:
        need = -(-(len(p) + steps + 1) // eng.block_size)
        table = eng.allocator.alloc(need)
        assert jeng.allocator.alloc(need) == table
        want = np.asarray(jeng.prefill(p, table))
        pairs.append((eng.prefill(p, table).numpy(), want))
        tables.append(table)
        lengths.append(len(p))
        tokens.append(int(np.argmax(want)))
    b = eng.max_batch_size
    for _ in range(steps):                  # the last slot stays empty
        tok = np.zeros(b, np.int64)
        pos = np.zeros(b, np.int64)
        tab = np.zeros((b, eng.blocks_per_seq), np.int64)
        for i, (t, n, table) in enumerate(zip(tokens, lengths, tables)):
            tok[i], pos[i] = t, n
            tab[i, :len(table)] = table
        want = np.asarray(jeng.decode(tok, pos, tab))
        got = eng.decode(tok, pos, tab).numpy()
        pairs.append((got[:len(prompts)], want[:len(prompts)]))
        tokens = [int(t) for t in np.argmax(want[:len(prompts)], axis=-1)]
        lengths = [n + 1 for n in lengths]
    return pairs


def test_engine_logits_and_pool_match_jax_under_int8(tiny):
    cfg, sd, _, jserver = tiny
    jeng = jserver.engine
    jeng.reset_cache()
    eng = DecodeEngine(cfg, sd, device="cpu", max_batch_size=4,
                       block_size=16, cache_dtype=torch.float32,
                       kv_quant="int8")
    assert eng.quantized and set(eng.cache) == set(jeng.cache)
    pairs = _lockstep(eng, jeng, _prompts(seed=4)[:3], steps=5)
    for got, want in pairs:
        assert np.all(np.isfinite(got))
        assert rel_err(got, want) <= LOGIT_TOL
    for name in ("k", "v", "k_scale", "v_scale"):
        got = eng.cache[name].numpy()
        want = np.asarray(jeng.cache[name])
        assert got.dtype == want.dtype, name
        if name in ("k", "v"):
            # the same bytes, but for a value whose fp32 projection sat
            # within an ulp of a rounding boundary of the int8 grid
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    jeng.reset_cache()


@pytest.mark.parametrize("preempt", [False, True])
def test_generate_matches_jax_server_under_int8(tiny, preempt):
    cfg, sd, jparams, jserver = tiny
    prompts = _prompts()
    kw = dict(max_batch_size=4, block_size=16)
    if preempt:         # 5 usable blocks: the batch outgrows the pool
        kw = dict(max_batch_size=3, max_context=64, block_size=4,
                  num_blocks=12)
        prompts = prompts[:3]
        jserver = JaxInferenceServer(
            jax_models.GPTConfig(**TINY), jparams, cache_dtype=jnp.float32,
            kv_quant="int8", attention_fn=jax_make_flash(causal=True),
            **kw, **SLICE_FLAGS)
    want = jserver.generate(prompts, max_new_tokens=24)
    server = InferenceServer(cfg, sd, device="cpu", cache_dtype=torch.float32,
                             kv_quant="int8", enable_chunked_prefill=False,
                             **kw)
    before = launch_counts()
    got = server.generate(prompts, max_new_tokens=24)
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got == want
    st = server.stats()
    assert st["preemptions"] == jserver.stats()["preemptions"]
    assert (st["preemptions"] >= 1) == preempt
    server.scheduler.audit()
    assert server.engine.allocator.num_free == \
        server.engine.cache_cfg.num_blocks - 1


def test_env_twin_and_a_given_kwarg_wins(tiny, monkeypatch):
    cfg, sd, _, _ = tiny
    kw = dict(device="cpu", max_batch_size=2, max_context=64, block_size=8,
              cache_dtype=torch.float32)
    monkeypatch.setenv("APEX_TPU_KV_QUANT", "int8")
    assert InferenceServer(cfg, sd, **kw).engine.quantized
    assert not InferenceServer(cfg, sd, kv_quant="off", **kw).engine.quantized
    monkeypatch.setenv("APEX_TPU_KV_QUANT", "off")
    assert not InferenceServer(cfg, sd, **kw).engine.quantized
    assert InferenceServer(cfg, sd, kv_quant="int8", **kw).engine.quantized
    monkeypatch.setenv("APEX_TPU_KV_QUANT", "fp4")
    with pytest.raises(ValueError, match="int8"):
        InferenceServer(cfg, sd, **kw)
    monkeypatch.delenv("APEX_TPU_KV_QUANT")
    assert not InferenceServer(cfg, sd, **kw).engine.quantized


def test_memory_stats_match_jax(tiny):
    cfg, sd, jparams, _ = tiny
    geometry = dict(max_batch_size=2, max_context=64, block_size=8)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    for quant in ("int8", "off"):
        server = InferenceServer(cfg, sd, device="cpu", kv_quant=quant,
                                 cache_dtype=torch.float32,
                                 enable_chunked_prefill=False, **geometry)
        jsrv = JaxInferenceServer(
            jax_models.GPTConfig(**TINY), jparams, cache_dtype=jnp.float32,
            kv_quant=quant, attention_fn=jax_make_flash(causal=True),
            **geometry, **SLICE_FLAGS)
        assert server.generate(prompts, 6) == jsrv.generate(prompts, 6)
        mem, jmem = server.stats()["memory"], jsrv.stats()["memory"]
        assert set(mem) == {"blocks_usable", "blocks_free", "blocks_live",
                            "blocks_live_peak", "pool_bytes",
                            "pool_bytes_per_device", "bytes_per_block",
                            "cache_dtype", "quantize", "compute_dtype"}
        for key in mem:
            assert mem[key] == jmem[key], key
        assert mem["cache_dtype"] == ("int8" if quant == "int8"
                                      else "float32")
        assert mem["pool_bytes_per_device"] == mem["pool_bytes"] == \
            server.engine.cache_cfg.num_blocks * mem["bytes_per_block"]
        assert mem["blocks_live"] == 0 and mem["blocks_live_peak"] >= 2
