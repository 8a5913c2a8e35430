"""apex_tpu_torch decode attention and greedy sampling against apex_tpu.

``cached_attention`` runs against the Pallas decode kernel in interpret
mode (``use_pallas=True, interpret=True``, as
``tests/L0/test_kv_quant.py`` does) at ragged T with masked tails and an
all-masked row; ``chunk_cached_attention`` and the greedy sampling
primitives against their jnp references.  The port's CPU path is its
plain PyTorch version (no CUDA kernel launched).  Scale-aware error
max|a-b| / (max|b| + 1) <= 1e-5 in fp32; token ids exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.ops import (
    cached_attention,
    chunk_cached_attention,
    finite_rows,
    greedy_argmax,
)

jax_da = importlib.import_module("apex_tpu.ops.decode_attention")
jax_sampling = importlib.import_module("apex_tpu.ops.sampling")

torch.set_num_threads(1)

TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


@pytest.mark.parametrize("t", [37, 160])     # within one / across k blocks
def test_cached_attention_matches_jax_kernel(t):
    rng = np.random.RandomState(t)
    b, h, d = 3, 2, 16
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, t, h, d).astype(np.float32)
    v = rng.randn(b, t, h, d).astype(np.float32)
    bias = np.zeros((b, t), np.float32)
    bias[1, t - 9:] = -1e9                   # masked tail (serving's value)
    bias[2, :] = -1e30                       # all masked: zeros
    want = jax_da.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_bias=jnp.asarray(bias), use_pallas=True, interpret=True,
        block_k=128)
    before = launch_counts()
    got = cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           kv_bias=torch.from_numpy(bias))
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert got.shape == (b, 1, h, d)
    assert np.all(got[2].numpy() == 0.0)
    assert rel_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("t", [1, 63, 64, 65, 200])
def test_cached_attention_masks_the_kernel_skips_match_jax(t):
    """The bias patterns the kernel's 64-key tiles meet, against the JAX
    kernel through its own CPU path (interpret mode): the engine's masked
    tail (-1e9 past the context, the self slot live), a row whose only
    live key is the self slot, a row masked at NEG_INF everywhere but two
    keys (whole tiles at or below NEG_INF / 2, which the kernel skips),
    and an all-masked row (zeros)."""
    rng = np.random.RandomState(1000 + t)
    b, h, d = 5, 2, 64
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, t, h, d).astype(np.float32)
    v = rng.randn(b, t, h, d).astype(np.float32)
    bias = np.zeros((b, t), np.float32)
    bias[1, t // 3:] = -1e9                  # the engine's masked tail
    bias[1, t - 1] = 0.0                     # ... and its live self slot
    bias[2, :] = -1e9                        # only the self slot live
    bias[2, t - 1] = 0.0
    bias[3, :] = -1e30                       # NEG_INF tiles, two live keys
    bias[3, [t // 2, t - 1]] = 0.0
    bias[4, :] = -1e30                       # all masked: zeros
    want = jax_da.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_bias=jnp.asarray(bias), use_pallas=True, interpret=True,
        block_k=128)
    before = launch_counts()
    got = cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           kv_bias=torch.from_numpy(bias))
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert np.all(got[4].numpy() == 0.0)
    assert rel_err(got.numpy(), want) <= TOL
    if t > 1:                                # one live key: o is its v
        np.testing.assert_allclose(got[2, 0].numpy(), v[2, t - 1],
                                   rtol=1e-6, atol=1e-6)


def test_cached_attention_without_bias_and_shape_errors():
    rng = np.random.RandomState(0)
    q = rng.randn(2, 1, 2, 16).astype(np.float32)
    k = rng.randn(2, 9, 2, 16).astype(np.float32)
    want = jax_da.cached_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(k), use_pallas=True,
                                   interpret=True)
    got = cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(k))
    assert rel_err(got.numpy(), want) <= TOL
    with pytest.raises(ValueError):
        cached_attention(torch.zeros(2, 2, 2, 16), torch.zeros(2, 9, 2, 16),
                         torch.zeros(2, 9, 2, 16))


@pytest.mark.parametrize("sms", [132, 114])
def test_split_keeps_one_block_an_sm(monkeypatch, sms):
    """The wrapper's split count: no split once half the SMs hold a
    (b, h) (the serve paths' 8 and 16 slots), else as many 64-key
    splits as keep B * H * splits within the SM count; the tiles cover
    T in at most ``_MAX_SPLITS`` splits, none of them empty."""
    da = importlib.import_module("apex_tpu_torch.ops.decode_attention")
    monkeypatch.setattr(da, "_sm_count", lambda device: sms)
    assert da._split(None, 96, 1025) == (17, 1)
    assert da._split(None, 192, 1025) == (17, 1)
    for bh in (1, 2, 12, 18, 40, 66, 67, 200):
        for t in (1, 63, 64, 65, 1025, 3000, 20_000, 100_000):
            tiles, splits = da._split(None, bh, t)
            n_tiles = -(-t // da._TILE)
            assert 1 <= splits <= da._MAX_SPLITS
            assert (splits - 1) * tiles < n_tiles <= splits * tiles
            assert splits == 1 or bh * splits <= sms
            if bh * 2 > sms or n_tiles == 1:
                assert splits == 1
    assert da._split(None, 12, 20_000)[1] == sms // 12


def test_chunk_cached_attention_matches_jax():
    rng = np.random.RandomState(1)
    b, t, c, h, d = 2, 20, 5, 2, 16
    q = rng.randn(b, c, h, d).astype(np.float32)
    k = rng.randn(b, t + c, h, d).astype(np.float32)
    v = rng.randn(b, t + c, h, d).astype(np.float32)
    ctx_bias = np.zeros((b, t), np.float32)
    ctx_bias[0, 12:] = -1e9
    want = jax_da.chunk_cached_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         jnp.asarray(ctx_bias))
    got = chunk_cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(ctx_bias))
    assert rel_err(got.numpy(), want) <= TOL


def test_greedy_argmax_ties_and_nan_rows_match_jax():
    rng = np.random.RandomState(2)
    logits = rng.randint(0, 4, size=(6, 50)).astype(np.float32)  # ties
    logits[3, :] = 1.0                       # all tied: id 0
    logits[4, 7] = np.nan                    # NaN row: clamps to V-1
    logits[5, 9] = np.inf
    want_ids = np.asarray(jax_sampling.greedy_argmax(jnp.asarray(logits)))
    want_fin = np.asarray(jax_sampling.finite_rows(jnp.asarray(logits)))
    ids = greedy_argmax(torch.from_numpy(logits))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(finite_rows(torch.from_numpy(logits))
                                  .numpy(), want_fin)
    np.testing.assert_array_equal(want_ids[:4],
                                  np.argmax(logits[:4], axis=-1))
