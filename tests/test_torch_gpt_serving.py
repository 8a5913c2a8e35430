"""The port's serving slice as a whole against apex_tpu's.

Weights come from the JAX package's own init and cross over through
``params_from_jax``; the JAX side is the reference serving stack with
the slice's flags (no prefix cache, chunked prefill, speculation,
pipeline, overload, breaker, streaming or program accounting; flash
prefill), run through its normal entry points.  The tiny configuration is
``examples/serving/serve_gpt.py``'s; the preemption case is
``tests/L0/test_serving_engine.py::test_preemption_is_bit_stable``'s.
Scale-aware error max|a-b| / (max|b| + 1) <= 1e-4 for fp32 logits; token
streams must be identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops import make_flash_attention as jax_make_flash
from apex_tpu.serving import InferenceServer as JaxInferenceServer
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, params_from_jax
from apex_tpu_torch.ops import make_flash_attention
from apex_tpu_torch.serving import DecodeEngine, InferenceServer, greedy_sample

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
                   kv_quant=None, mesh=None)

# lengths within the 16- and 32-token buckets: two prefill programs
PROMPT_LENS = (5, 17, 30, 9, 12, 3)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _jax_params(kw, seed):
    m = jax_models.GPTLMHeadModel(jax_models.GPTConfig(**kw))
    params = m.init(jax.random.PRNGKey(seed),
                    jnp.ones((1, 8), jnp.int32))["params"]
    return m, params


@pytest.fixture(scope="module")
def tiny():
    """(jax model, jax params, port cfg, port state_dict, jax server):
    one init and one JAX server (its logits programs compile once) shared
    by the module."""
    jm, jparams = _jax_params(TINY, 0)
    cfg = GPTConfig(**TINY)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    jserver = JaxInferenceServer(
        jax_models.GPTConfig(**TINY), jparams, max_batch_size=4,
        block_size=16, cache_dtype=jnp.float32,
        attention_fn=jax_make_flash(causal=True), **SLICE_FLAGS)
    return jm, jparams, cfg, sd, jserver


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, TINY["vocab_size"], size=n))
            for n in PROMPT_LENS]


def test_params_from_jax_round_trip(tiny):
    _, jparams, cfg, sd, _ = tiny
    model = GPTLMHeadModel(cfg, device="cpu", seed=None)
    model.load_state_dict(sd)          # strict: every key, every shape
    flat = jax.tree_util.tree_leaves(jparams)
    assert sum(int(np.prod(a.shape)) for a in flat) == \
        sum(p.numel() for p in model.parameters())
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    blk = jparams["block_1"]["attention"]
    q_w = model.blocks[1].attention.query.weight.detach().numpy()
    np.testing.assert_array_equal(q_w.T.reshape(h, nh, h // nh),
                                  np.asarray(blk["query"]["kernel"]))
    o_w = model.blocks[1].attention.output.weight.detach().numpy()
    np.testing.assert_array_equal(o_w.T.reshape(nh, h // nh, h),
                                  np.asarray(blk["output"]["kernel"]))
    np.testing.assert_array_equal(
        model.blocks[0].mlp_in.weight.detach().numpy().T,
        np.asarray(jparams["block_0"]["mlp_in"]["kernel"]))
    np.testing.assert_array_equal(model.wte.weight.detach().numpy(),
                                  np.asarray(jparams["wte"]["embedding"]))


def test_seeded_init_follows_reference_distributions():
    cfg = GPTConfig(**TINY)
    a = GPTLMHeadModel(cfg, device="cpu", seed=3).state_dict()
    b = GPTLMHeadModel(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["final_ln.scale"] == 1) and \
        torch.all(a["blocks.0.attention.query.bias"] == 0)
    std = float(a["wte.weight"].std())
    assert abs(std - cfg.initializer_range) < 0.002


@pytest.mark.parametrize("flash", [False, True])
def test_full_forward_logits_match_jax(tiny, flash):
    jm, jparams, cfg, sd, _ = tiny
    rng = np.random.RandomState(2)
    ids = rng.randint(0, cfg.vocab_size, size=(2, 40))
    mask = np.ones((2, 40), np.int32)
    mask[1, 29:] = 0
    want = jm.apply({"params": jparams}, jnp.asarray(ids),
                    attention_mask=jnp.asarray(mask))
    model = GPTLMHeadModel(
        cfg, make_flash_attention(causal=True) if flash else None,
        device="cpu", seed=None)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 1024)
    assert rel_err(got.numpy(), want) <= LOGIT_TOL


def test_engine_prefill_and_decode_logits_match_jax(tiny):
    _, _, cfg, sd, jserver = tiny
    jeng = jserver.engine
    jeng.reset_cache()
    eng = DecodeEngine(cfg, sd, device="cpu", max_batch_size=4,
                       block_size=16, cache_dtype=torch.float32)
    prompts = _prompts(seed=4)[:3]
    tables, lengths, tokens = [], [], []
    for p in prompts:
        need = -(-(len(p) + 6) // 16)
        table = eng.allocator.alloc(need)
        assert jeng.allocator.alloc(need) == table
        want = np.asarray(jeng.prefill(p, table))
        got = eng.prefill(p, table).numpy()
        assert rel_err(got, want) <= LOGIT_TOL
        tables.append(table)
        lengths.append(len(p))
        tokens.append(int(np.argmax(want)))
    for _ in range(5):                 # slot 3 stays an empty slot
        tok = np.zeros(4, np.int64)
        pos = np.zeros(4, np.int64)
        tab = np.zeros((4, eng.blocks_per_seq), np.int64)
        for i, (t, n, table) in enumerate(zip(tokens, lengths, tables)):
            tok[i], pos[i] = t, n
            tab[i, :len(table)] = table
        want = np.asarray(jeng.decode(tok, pos, tab))
        got = eng.decode(tok, pos, tab).numpy()
        assert rel_err(got[:3], want[:3]) <= LOGIT_TOL
        assert np.all(np.isfinite(got))
        tokens = [int(t) for t in np.argmax(want[:3], axis=-1)]
        lengths = [n + 1 for n in lengths]
    jeng.reset_cache()


def test_generate_matches_jax_server_token_for_token(tiny):
    _, _, cfg, sd, jserver = tiny
    prompts = _prompts()
    want = jserver.generate(prompts, max_new_tokens=24)
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=4,
                             block_size=16, cache_dtype=torch.float32,
                             enable_chunked_prefill=False)
    before = launch_counts()
    got = server.generate(prompts, max_new_tokens=24)
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got == want
    st = server.stats()
    assert st["tokens_generated"] == 6 * 24
    assert st["requests_finished"] == 6
    assert st["prefills"] == 6 and st["decode_steps"] >= 24
    assert st["queue_depth_peak"] >= 1 and st["batch_occupancy_avg"] > 0
    assert st["kernel_launches"] == dict.fromkeys(launch_counts(), 0)
    server.scheduler.audit()
    assert server.engine.allocator.num_free == \
        server.engine.cache_cfg.num_blocks - 1


def test_preemption_matches_jax_server():
    kw = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=128, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    _, jparams = _jax_params(kw, 1)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8],
               [9, 9, 8, 7, 6, 5, 4, 3]]
    geometry = dict(max_batch_size=3, max_context=64, block_size=4,
                    num_blocks=10)            # 9 usable blocks = 36 tokens
    jserver = JaxInferenceServer(jax_models.GPTConfig(**kw), jparams,
                                 cache_dtype=jnp.float32, **geometry,
                                 attention_fn=jax_make_flash(causal=True),
                                 **SLICE_FLAGS)
    want = jserver.generate(prompts, max_new_tokens=24)
    cfg = GPTConfig(**kw)
    server = InferenceServer(
        cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg),
        device="cpu", cache_dtype=torch.float32,
        enable_chunked_prefill=False, **geometry)
    got = server.generate(prompts, max_new_tokens=24)
    assert got == want
    st = server.stats()
    assert st["preemptions"] >= 1              # pressure actually hit
    assert st["preemptions"] == jserver.stats()["preemptions"]
    assert st["kv_blocks_free"] == 9
    server.scheduler.audit()


def test_scheduler_edges():
    cfg = GPTConfig(**TINY)
    sd = GPTLMHeadModel(cfg, device="cpu", seed=0).state_dict()
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                             max_context=32, block_size=8, max_waiting=1,
                             cache_dtype=torch.float32,
                             enable_chunked_prefill=False)
    with pytest.raises(ValueError):
        server.submit(list(range(32)), 4)      # no room to generate
    with pytest.raises(ValueError):
        server.submit([], 4)
    req = server.submit(list(range(30)), 100)  # capped to fit
    assert req.max_new_tokens == 2
    rejected = server.submit([1, 2], 4)        # queue of one is full
    assert rejected.finished and rejected.finish_reason == "rejected"
    eos_server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                                 max_context=64, block_size=8,
                                 cache_dtype=torch.float32,
                                 enable_chunked_prefill=False)
    ref = eos_server.generate([[5, 4, 3, 2, 1]], max_new_tokens=12)[0]
    eos = ref[5]
    out = eos_server.generate([[5, 4, 3, 2, 1]], max_new_tokens=12,
                              eos_id=eos)[0]
    assert out == ref[:ref.index(eos) + 1]
    assert eos_server.scheduler.finished[-1].finish_reason == "eos"
    logits = np.array([[0.5, 2.0, 2.0], [1.0, 1.0, 0.0]], np.float32)
    np.testing.assert_array_equal(greedy_sample(logits), [1, 0])
    with pytest.raises(TypeError):
        greedy_sample(np.array([[1, 2]]))


def test_engine_prefill_goes_through_flash(tiny, monkeypatch):
    _, _, cfg, sd, _ = tiny
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs.get("causal"))
        return fa._reference(*args[:3], kwargs.get("kv_mask"),
                             kwargs.get("causal"),
                             1.0 / args[0].shape[-1] ** 0.5)

    monkeypatch.setattr(fa, "flash_attention", counting)
    eng = DecodeEngine(cfg, sd, device="cpu", max_batch_size=2,
                       block_size=16, cache_dtype=torch.float32)
    eng.prefill([1, 2, 3], eng.allocator.alloc(1))
    assert calls == [True] * cfg.num_hidden_layers


def test_stats_count_launches_since_reset_meters(tiny):
    _, _, cfg, sd, _ = tiny
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    server = InferenceServer(cfg, sd, device="cpu", max_batch_size=2,
                             block_size=16, cache_dtype=torch.float32,
                             enable_chunked_prefill=False)
    fa.KERNEL.launches += 3            # launches made before the window
    try:
        server.reset_meters()
        assert server.stats()["kernel_launches"]["flash_fwd"] == 0
        fa.KERNEL.launches += 2
        assert server.stats()["kernel_launches"]["flash_fwd"] == 2
    finally:
        fa.KERNEL.launches -= 5
