"""apex_tpu_torch flash attention against apex_tpu's Pallas flash kernel.

The JAX side runs ``flash_attention(use_pallas=True, interpret=True)``
with 32-wide blocks, as ``tests/L0/test_flash_attention.py`` does, so
ragged lengths cross block edges; the port's CPU path is its plain
PyTorch version (no CUDA kernel launched).  Inputs come from
``numpy.random.RandomState``.  Scale-aware error max|a-b| / (max|b| + 1)
<= 1e-5 in fp32 for the output and the lse.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.ops import (
    bias_to_kv_mask,
    flash_attention,
    make_flash_attention,
)
from apex_tpu_torch.ops.flash_attention import NEG_INF

# the package re-exports a function of the same name as this module
jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _jax(q, k, v, mask, causal):
    return jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        use_pallas=True, interpret=True, block_q=32, block_k=32,
        return_lse=True)


def _port(q, k, v, mask, causal):
    before = launch_counts()
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, return_lse=True)
    assert launch_counts() == before, "the CPU path launched a kernel"
    return out


@pytest.mark.parametrize("s", [32, 33, 70])   # exact, ragged, multi-block
@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_kernel_with_padding_mask(s, causal):
    q, k, v = _inputs(2, s, s, 2, 16, seed=s)
    mask = np.zeros((2, s), np.float32)
    mask[1, s - s // 3:] = -1e9          # the GPT padding mask's value
    jo, jlse = _jax(q, k, v, mask, causal)
    o, lse = _port(q, k, v, mask, causal)
    assert o.shape == (2, s, 2, 16) and lse.shape == (2, 2, s)
    assert rel_err(o.numpy(), jo) <= TOL
    assert rel_err(lse.numpy(), jlse) <= TOL


def test_fully_masked_row_gives_zeros_and_neg_inf_lse():
    q, k, v = _inputs(2, 40, 40, 2, 16, seed=1)
    mask = np.zeros((2, 40), np.float32)
    mask[0, :] = NEG_INF                 # batch row 0 sees no key at all
    jo, jlse = _jax(q, k, v, mask, False)
    o, lse = _port(q, k, v, mask, False)
    assert np.all(o[0].numpy() == 0.0) and np.all(np.asarray(jo)[0] == 0.0)
    assert np.all(lse[0].numpy() == NEG_INF)
    assert np.all(np.asarray(jlse)[0] == NEG_INF)
    assert rel_err(o[1].numpy(), np.asarray(jo)[1]) <= TOL
    assert rel_err(lse[1].numpy(), np.asarray(jlse)[1]) <= TOL


def test_cross_lengths_without_mask():
    q, k, v = _inputs(1, 24, 50, 3, 16, seed=2)
    jo, jlse = _jax(q, k, v, None, False)
    o, lse = _port(q, k, v, None, False)
    assert rel_err(o.numpy(), jo) <= TOL
    assert rel_err(lse.numpy(), jlse) <= TOL


def test_adapter_collapses_bias_and_matches_jax_adapter():
    q, k, v = _inputs(2, 20, 20, 2, 16, seed=3)
    bias = np.zeros((2, 1, 1, 20), np.float32)
    bias[0, ..., 15:] = -1e9
    want = jax_fa.make_flash_attention(causal=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    got = make_flash_attention(causal=True)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias))
    assert rel_err(got.numpy(), want) <= TOL
    assert bias_to_kv_mask(torch.from_numpy(bias)).shape == (2, 20)
    with pytest.raises(ValueError):
        bias_to_kv_mask(torch.zeros(2, 2, 1, 20))


def test_dropout_is_refused():
    q, k, v = (torch.zeros(1, 4, 1, 16) for _ in range(3))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        make_flash_attention(causal=True)(q, k, v, None, lambda p: p)
