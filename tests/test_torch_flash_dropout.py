"""Attention dropout in apex_tpu_torch's flash attention against apex_tpu's.

The keep-mask is the murmur3 hash of the global (batch*head, q, k)
coordinate and the step seed: the port's (``_dropout_keep``,
``keep_from_seed``, ``seed_array``) must equal the JAX package's bit for
bit, over seeds at both ends of the int32 range, coordinates past 2**16,
several rates and non-zero offsets.  With the same mask the forward and
the gradients must match both JAX paths — the plain ``use_pallas=False``
oracle and the interpret-mode Pallas kernel at ``TestDropout``'s sizes
and blocks (``tests/L0/test_flash_attention.py``) — within a
scale-aware error max|a-b| / (max|b| + 1) <= 1e-5 in fp32.  Inputs come
from ``numpy.random.RandomState``; the port runs its plain versions on
the CPU (no kernel launched).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.ops import (
    dropout_params,
    flash_attention,
    keep_from_seed,
    make_flash_attention,
    seed_array,
)

# the packages re-export functions of the same name as these modules
jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")
fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

TOL = 1e-5
B, S, H, D = 2, 64, 2, 32            # TestDropout's sizes
KW = dict(use_pallas=True, interpret=True, block_q=32, block_k=32)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _inputs(seed, n=3):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, H, D).astype(np.float32) for _ in range(n))


def _mask(masked):
    if not masked:
        return None
    mask = np.zeros((B, S), np.float32)
    mask[1, 45:] = -1e9
    return mask


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("offsets", [None, (70001, 65539, 3, 9)])
def test_keep_mask_matches_jax_bitwise(seed, rate, offsets):
    js = jax_fa.seed_array(seed, offsets, num_heads=3)
    ts = seed_array(seed, offsets, num_heads=3)
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rows, cols = np.arange(0, 70, 3), np.arange(65530, 65600)
    want = jax_fa.keep_from_seed(js, 2, 3, jnp.asarray(rows),
                                 jnp.asarray(cols), rate)
    got = keep_from_seed(ts, 2, 3, torch.from_numpy(rows),
                         torch.from_numpy(cols), rate)
    assert got.dtype == torch.bool and got.shape == (2, 3, 24, 70)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_matches_jax_on_raw_coordinates():
    """``_dropout_keep`` on coordinates and batch*head indices up to the
    top of the int32 range, negative seeds included."""
    rng = np.random.RandomState(5)
    rows = rng.randint(0, 2 ** 31 - 1, (64, 1)).astype(np.int32)
    cols = rng.randint(0, 2 ** 31 - 1, (1, 64)).astype(np.int32)
    for seed, bh in ((-12345, 2 ** 31 - 2), (2 ** 31 - 1, 0), (3, 70000)):
        for rate in (0.1, 0.3, 0.5):
            want = jax_fa._dropout_keep(jnp.int32(seed), jnp.int32(bh),
                                        jnp.asarray(rows), jnp.asarray(cols),
                                        rate)
            got = fa._dropout_keep(torch.tensor(seed), torch.tensor(bh),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(cols), rate)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seed_array_takes_a_device_tensor_seed():
    got = seed_array(torch.tensor(41, dtype=torch.int64), (1, 2, 3, 4),
                     num_heads=2)
    assert got.dtype == torch.int32
    assert got.tolist() == [41, 1, 2, 3, 4]
    assert seed_array(5, num_heads=6).tolist() == [5, 0, 0, 0, 6]


def test_drop_fraction_near_rate():
    bh = torch.arange(8)[:, None, None]
    rows = torch.arange(128)[None, :, None]
    cols = torch.arange(128)[None, None, :]
    for rate in (0.1, 0.5):
        keep = fa._dropout_keep(torch.tensor(3), bh, rows, cols, rate)
        assert abs(float(1.0 - keep.float().mean()) - rate) < 0.01


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_forward_and_grads_match_both_jax_paths(causal, masked, rate):
    q, k, v = _inputs(11)
    do = np.random.RandomState(12).randn(B, S, H, D).astype(np.float32)
    mask = _mask(masked)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = launch_counts()
    o, lse = flash_attention(
        qt, kt, vt, kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, return_lse=True, dropout_rate=rate, dropout_seed=7)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert launch_counts() == before, "the CPU path launched a kernel"
    for kw in (dict(use_pallas=False), KW):
        def f(q, k, v):
            return jax_fa.flash_attention(
                q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
                causal=causal, dropout_rate=rate, dropout_seed=7,
                return_lse=True, **kw)
        (jo, jlse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
        assert rel_err(o.detach().numpy(), jo) <= TOL, kw
        assert rel_err(lse.detach().numpy(), jlse) <= TOL, kw
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert rel_err(g.numpy(), w) <= TOL, kw


def test_deterministic_and_seed_varying():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2))
    a = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=5)
    b = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=5)
    c = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_rate_zero_equals_no_dropout():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3))
    a = flash_attention(q, k, v, dropout_rate=0.0, dropout_seed=5)
    assert torch.equal(a, flash_attention(q, k, v))


def test_requires_a_seed_and_a_rate_in_range():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.3)
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match=r"\[0, 1\)"):
            flash_attention(q, k, v, dropout_rate=rate, dropout_seed=1)


def test_make_flash_attention_consumes_the_annotation():
    """The adapter reads ``dropout_fn.rate`` / ``.seed`` (as the BERT
    model attaches them) and matches the JAX adapter on the same
    annotation; a closure without one is refused."""
    q, k, v = _inputs(6)
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[0, ..., 50:] = -1e9

    def jax_drop(p):
        return p
    jax_drop.rate, jax_drop.seed = 0.1, jnp.int32(123)

    def drop(p):
        return p
    drop.rate, drop.seed = 0.1, torch.tensor(123, dtype=torch.int32)
    want = jax_fa.make_flash_attention(**KW)(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias), jax_drop)
    got = make_flash_attention()(*(torch.from_numpy(a) for a in (q, k, v)),
                                 torch.from_numpy(bias), drop)
    assert rel_err(got.numpy(), want) <= TOL
    assert dropout_params(None) == (0.0, None)
    assert dropout_params(drop)[0] == 0.1
    with pytest.raises(NotImplementedError, match="annotation"):
        make_flash_attention()(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), None, lambda p: p)
