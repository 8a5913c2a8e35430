"""apex_tpu_torch's stochastic sampling against apex_tpu's.

Twins of ``tests/L0/test_sampling.py``'s op-level checks (validation
messages, classes, the greedy lane bit for bit, the non-finite flag, the
temperature, top-k and top-p distributions, counter-key determinism,
rejection-sampling exactness) run on the port's
``sample_tokens_host``; then the port against the JAX functions on the
same numpy inputs:

- the row-batched threefry keys and uniform bits bit for bit;
- ``sampling_noise`` within ``NOISE_ULPS`` float32 epsilons of
  max(|x|, 1) (the bits are equal; the two logs of the Gumbel
  transform may round apart);
- ``processed_logits`` equal, masks and values;
- ``sample_tokens`` equal but where the top two of ``processed_logits +
  noise`` lie within ``NEAR_TIE`` of each other; the count of such
  mismatches is 0 at these seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import sampling as jax_sampling
from apex_tpu_torch.ops import sampling, threefry
from apex_tpu_torch.ops.sampling import SamplingParams, sample_tokens_host

torch.set_num_threads(1)

NOISE_ULPS = 4          # |a - b| <= NOISE_ULPS * eps32 * max(|b|, 1)
NEAR_TIE = 1e-4         # top-2 gap of processed logits + noise


def _draw(logits_row, n, *, temperature=1.0, top_k=0, top_p=1.0, seed=0,
          pos0=0):
    """n draws from one logits row, each position its own counter key."""
    v = len(logits_row)
    lg = np.broadcast_to(np.asarray(logits_row, np.float32), (n, v)).copy()
    ids, fin = sample_tokens_host(
        lg, np.full((n,), temperature, np.float32),
        np.full((n,), top_k, np.int32), np.full((n,), top_p, np.float32),
        np.full((n,), seed, np.int32), (pos0 + np.arange(n)).astype(np.int32), device="cpu")
    assert bool(fin.all())
    return ids.numpy()


def _chi2(counts, probs):
    n = counts.sum()
    stat = 0.0
    for o, p in zip(counts, probs):
        if p == 0.0:
            assert o == 0, "sampled a zero-probability token"
            continue
        stat += (o - n * p) ** 2 / (n * p)
    return stat


def test_sampling_params_validation_messages():
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        SamplingParams(temperature=-0.1)
    with pytest.raises(ValueError, match="top_k must be >= 1"):
        SamplingParams(top_k=0)
    with pytest.raises(ValueError, match=r"top_p must be in \(0, 1\]"):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError, match=r"top_p must be in \(0, 1\]"):
        SamplingParams(top_p=1.5)


@pytest.mark.parametrize("kw", [
    {}, {"temperature": 1.0}, {"temperature": 1.0, "top_k": 5},
    {"temperature": 1.0, "top_p": 0.9},
    {"temperature": 1.0, "top_k": 5, "top_p": 0.9},
    {"top_k": 5, "top_p": 0.5}])
def test_sampling_params_classes_match_jax(kw):
    got, want = SamplingParams(**kw), jax_sampling.SamplingParams(**kw)
    assert (got.klass, got.is_greedy) == (want.klass, want.is_greedy)
    assert dataclass_fields(got) == dataclass_fields(want)
    assert sampling.SALT_SAMPLE == jax_sampling.SALT_SAMPLE
    assert sampling._TEMP_FLOOR == jax_sampling._TEMP_FLOOR


def dataclass_fields(obj):
    return {k: getattr(obj, k) for k in ("temperature", "top_k", "top_p",
                                         "seed")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_lane_bit_exact_vs_argmax(dtype):
    rng = np.random.RandomState(1)
    lg = torch.from_numpy(rng.randn(32, 40).astype(np.float32)).to(dtype)
    lg[3, 7] = lg[3, 20]                     # exact ties
    lg[9, 0] = lg[9, 39]
    b = lg.shape[0]
    ids, fin = sample_tokens_host(
        lg, np.zeros(b, np.float32), np.zeros(b, np.int32),
        np.ones(b, np.float32), np.zeros(b, np.int32),
        np.arange(b, dtype=np.int32), device="cpu")
    want = np.argmax(lg.float().numpy(), axis=-1)
    assert np.array_equal(ids.numpy(), want) and bool(fin.all())
    jids, _ = jax_sampling.sample_tokens_host(
        jnp.asarray(lg.float().numpy(), jnp.float32).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        np.zeros(b, np.float32), np.zeros(b, np.int32),
        np.ones(b, np.float32), np.zeros(b, np.int32),
        np.arange(b, dtype=np.int32))
    assert np.array_equal(ids.numpy(), np.asarray(jids))


def test_nonfinite_rows_flagged():
    lg = np.zeros((3, 8), np.float32)
    lg[1, 2] = np.nan
    lg[2, 5] = np.inf
    _, fin = sample_tokens_host(
        lg, np.full(3, 1.0, np.float32), np.zeros(3, np.int32),
        np.ones(3, np.float32), np.zeros(3, np.int32),
        np.arange(3, dtype=np.int32), device="cpu")
    assert fin.tolist() == [True, False, False]


@pytest.mark.parametrize("t", [0.5, 1.0, 2.0])
def test_temperature_scaling_distribution(t):
    lg = np.array([2.0, 1.0, 0.3, -0.5, -1.2], np.float32)
    ids = _draw(lg, 12000, temperature=t, seed=17)
    p = np.exp(lg / t)
    p /= p.sum()
    assert _chi2(np.bincount(ids, minlength=5), p) < 18.5


def test_top_k_mask_exactness():
    lg = np.array([1.5, 3.0, 0.0, 2.0, -1.0, 0.5], np.float32)
    ids = _draw(lg, 8000, top_k=3, seed=5)
    assert set(ids.tolist()) == {1, 3, 0}
    p = np.exp(lg)
    p[[2, 4, 5]] = 0.0
    p /= p.sum()
    assert _chi2(np.bincount(ids, minlength=6), p) < 18.5
    lg_tie = np.array([3.0, 2.0, 2.0, -5.0], np.float32)
    assert set(_draw(lg_tie, 4000, top_k=2, seed=6).tolist()) == {0, 1, 2}


def test_top_p_boundary_inclusion():
    lg = np.array([2.0, 1.0, 0.0, -1.0], np.float32)
    p_full = np.exp(lg) / np.exp(lg).sum()
    ids = _draw(lg, 8000, top_p=0.8, seed=9)
    assert set(ids.tolist()) == {0, 1}
    p = p_full.copy()
    p[2:] = 0.0
    p /= p.sum()
    assert _chi2(np.bincount(ids, minlength=4), p) < 18.5
    assert set(_draw(lg, 1000, top_p=0.1, seed=10).tolist()) == {0}
    assert set(_draw(lg, 12000, top_p=1.0, seed=11).tolist()) == \
        {0, 1, 2, 3}


def test_counter_key_determinism():
    lg = np.array([0.5, 0.4, 0.3, 0.2, 0.1], np.float32)
    a = _draw(lg, 64, seed=3)
    assert np.array_equal(a, _draw(lg, 64, seed=3))
    assert not np.array_equal(a, _draw(lg, 64, seed=4))
    d = _draw(lg, 50, seed=3, pos0=7)[0]
    for _ in range(3):
        assert _draw(lg, 1, seed=3, pos0=7)[0] == d


def test_rejection_sampling_exactness():
    lg = np.array([1.2, 0.6, 0.0, -0.6, -1.2, 0.3], np.float32)
    p = np.exp(lg) / np.exp(lg).sum()
    d, n = 1, 15000
    s = _draw(lg, n, temperature=1.0, seed=23)
    accept = s == d
    assert abs(accept.mean() - p[d]) < 5 * np.sqrt(p[d] * (1 - p[d]) / n)
    residual = p.copy()
    residual[d] = 0.0
    residual /= residual.sum()
    assert _chi2(np.bincount(s[~accept], minlength=6), residual) < 20.5


# -- against the JAX functions ---------------------------------------------

def _params(rng, b, v):
    temp = rng.uniform(0.3, 1.5, b).astype(np.float32)
    temp[0] = 0.0
    tk = rng.choice([0, 1, 5, 40, v], b).astype(np.int32)
    tp = rng.choice([1.0, 0.95, 0.9, 0.5], b).astype(np.float32)
    seed = rng.randint(0, 2 ** 31 - 1, b).astype(np.int32)
    pos = rng.randint(0, 4096, b).astype(np.int32)
    return temp, tk, tp, seed, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_row_keys_and_bits_match_jax(seed):
    rng = np.random.RandomState(seed)
    seeds = rng.randint(0, 2 ** 31 - 1, 6).astype(np.int32)
    pos = rng.randint(0, 4096, 6).astype(np.int32)
    want = np.asarray(jax_sampling._row_keys(
        jnp.asarray(seeds), jnp.asarray(pos), jax_sampling.SALT_SAMPLE))
    keys = threefry.fold_in_rows(threefry.fold_in_rows(
        threefry.key_rows(torch.from_numpy(seeds)), torch.from_numpy(pos)),
        sampling.SALT_SAMPLE)
    assert np.array_equal(keys.numpy().astype(np.uint32), want)
    for i, k in enumerate(want):
        bits = jax.random.bits(jax.random.wrap_key_data(k), (300,),
                               jnp.uint32)
        assert np.array_equal(
            threefry.random_bits_rows(keys, 300)[i].numpy(),
            np.asarray(bits).astype(np.int64))
        u = jax.random.uniform(jax.random.wrap_key_data(k), (300,),
                               jnp.float32, minval=1e-3, maxval=2.0)
        assert np.array_equal(
            threefry.uniform_rows(keys, 300, 1e-3, 2.0)[i].numpy(),
            np.asarray(u))


@pytest.mark.parametrize("vocab", [61, 50257])
def test_sampling_noise_within_ulps_of_jax(vocab):
    rng = np.random.RandomState(vocab)
    seeds = rng.randint(0, 2 ** 31 - 1, (4, 2)).astype(np.int32)
    pos = rng.randint(0, 4096, (4, 2)).astype(np.int32)
    want = np.asarray(jax_sampling.sampling_noise(
        jnp.asarray(seeds), jnp.asarray(pos), vocab))
    got = sampling.sampling_noise(torch.from_numpy(seeds),
                                  torch.from_numpy(pos), vocab).numpy()
    assert got.shape == want.shape == (4, 2, vocab)
    eps = np.finfo(np.float32).eps
    ulps = np.abs(got - want) / (eps * np.maximum(np.abs(want), 1.0))
    assert float(ulps.max()) <= NOISE_ULPS


@pytest.mark.parametrize("vocab", [61, 1024])
def test_processed_logits_match_jax(vocab):
    rng = np.random.RandomState(vocab)
    b = 24
    lg = (rng.randn(b, vocab) * 3).astype(np.float32)
    lg[5, :7] = lg[5].max()                     # ties at the top
    lg[6, 3] = lg[6, 4] = np.sort(lg[6])[-5]    # a tie at the 5th value
    temp, tk, tp, _, _ = _params(rng, b, vocab)
    tk[6] = 5
    want = np.asarray(jax_sampling.processed_logits(
        jnp.asarray(lg), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp)))
    got = sampling.processed_logits(
        torch.from_numpy(lg), torch.from_numpy(temp), torch.from_numpy(tk),
        torch.from_numpy(tp)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got, want)


def near_tie_mismatches(logits, params, got, want):
    """Rows where ``got`` and ``want`` differ: each must be a near-tie of
    the JAX processed logits + noise (else AssertionError); returns their
    count."""
    temp, tk, tp, seed, pos = params
    score = np.asarray(jax_sampling.processed_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp))) + np.asarray(jax_sampling.sampling_noise(
            jnp.asarray(seed), jnp.asarray(pos), logits.shape[-1]))
    bad = np.flatnonzero(got != want)
    for r in bad:
        top2 = np.sort(score[r])[-2:]
        assert temp[r] > 0 and top2[1] - top2[0] < NEAR_TIE, (r, top2)
    return len(bad)


@pytest.mark.parametrize("vocab,seed", [(61, 0), (1024, 1), (50257, 2)])
def test_sample_tokens_match_jax_under_the_near_tie_rule(vocab, seed):
    rng = np.random.RandomState(seed)
    b = 32
    lg = (rng.randn(b, vocab) * 2).astype(np.float32)
    params = _params(rng, b, vocab)
    want, wfin = jax_sampling.sample_tokens_host(lg, *params)
    got, fin = sample_tokens_host(lg, *params, device="cpu")
    assert np.array_equal(fin.numpy(), np.asarray(wfin))
    assert got.dtype == torch.int32
    assert near_tie_mismatches(lg, params, got.numpy(),
                               np.asarray(want)) == 0


def test_sample_tokens_verify_shaped_batch():
    """(B, K, V) logits with (B, K) params, as verify samples every
    column with its own counter: equal to the flattened (B*K, V) call."""
    rng = np.random.RandomState(4)
    lg = rng.randn(3, 4, 61).astype(np.float32)
    flat = _params(rng, 12, 61)
    shaped = tuple(torch.from_numpy(x.reshape(3, 4)) for x in flat)
    ids, fin = sampling.sample_tokens(torch.from_numpy(lg), *shaped)
    want, _ = sample_tokens_host(lg.reshape(12, 61), *flat, device="cpu")
    assert ids.shape == fin.shape == (3, 4)
    assert np.array_equal(ids.numpy().reshape(-1), want.numpy())
