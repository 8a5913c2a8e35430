"""apex_tpu_torch.ops.threefry against jax.random and flax, bit for bit.

The port's copy of JAX's threefry stream (``jax_threefry_partitionable``
pinned to True, the JAX 0.9 default this copy follows) and of flax's
scope folding must give the keys and bits the JAX package's BERT draws
its dropout from: ``PRNGKey``, ``fold_in``, ``split``, ``random_bits``,
``uniform`` and ``bernoulli`` over several keys and shapes (odd and
zero-size ones included), and scalar int32 ``randint``; ``LazyRng`` folding and
``make_rng``'s per-scope counters over a nested path and repeated
calls; and ``dropout`` (its plain version, as on any CPU tensor)
against ``flax.linen.Dropout`` in float32 and bfloat16, forward and
gradient.  Inputs come from ``numpy.random.RandomState``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import LazyRng

from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.ops import threefry as tf

SEEDS = (0, 2 ** 31 - 1, 123456789)
SHAPES = ((), (0,), (1,), (7,), (3, 5), (2, 0, 3), (5, 33, 3))


@pytest.fixture(autouse=True, scope="module")
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_operations_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tf.PRNGKey(seed) == _key(key)
    assert tf.as_key(np.asarray(key)) == _key(key)
    k = tf.PRNGKey(seed)
    for data in (0, 1, 31, 2 ** 31 + 3, 2 ** 32 - 1):
        assert tf.fold_in(k, data) == _key(jax.random.fold_in(key, data))
    for num in (1, 2, 3, 5):
        assert tf.split(k, num) == [_key(x) for x in jax.random.split(key,
                                                                      num)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli_match_jax(shape):
    for seed in SEEDS:
        key, k = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
        bits = tf.random_bits(k, shape, device="cpu")
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        assert bits.shape == want.shape
        np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want)
        u = tf.uniform(k, shape, device="cpu")
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(u.numpy(),
                                      np.asarray(jax.random.uniform(key,
                                                                    shape)))
        for p in (0.9, 1e-3):
            np.testing.assert_array_equal(
                tf.bernoulli(k, p, shape, device="cpu").numpy(),
                np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    int32_max = int(jnp.iinfo(jnp.int32).max)
    key, k = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    for data in range(4):
        kd, kj = tf.fold_in(k, data), jax.random.fold_in(key, data)
        for lo, hi in ((0, int32_max), (-7, 100), (-2 ** 31, int32_max),
                       (5, 5)):
            assert tf.randint(kd, lo, hi) == int(jax.random.randint(
                kj, (), lo, hi, dtype=jnp.int32))


def test_fold_in_static_matches_lazy_rng():
    key = jax.random.PRNGKey(42)
    for data in ((), ("encoder",), ("encoder", "layer_1", "Dropout_0", 2),
                 ("a", 300, "b", 70000), ("attention", 1)):
        want = LazyRng.create(key, *data).as_jax_rng()
        assert tf.fold_in_static(tf.PRNGKey(42), data) == _key(want)


class _Leaf(fnn.Module):
    @fnn.compact
    def __call__(self):
        return [self.make_rng("dropout") for _ in range(2)]


class _Mid(fnn.Module):
    @fnn.compact
    def __call__(self):
        leaf = _Leaf()                      # auto-named _Leaf_0
        out = leaf() + leaf()               # one scope called twice
        return out + [self.make_rng("dropout")] + _Leaf(name="named")()


class _Top(fnn.Module):
    @fnn.compact
    def __call__(self):
        return ([self.make_rng("dropout")] + _Mid(name="encoder")()
                + [self.make_rng("dropout")])


def test_rng_scope_matches_flax_make_rng():
    """A nested path, an auto-named child called twice (its counter
    runs on) and the root drawing before and after its children."""
    key = jax.random.PRNGKey(3)
    want = [_key(k) for k in _Top().apply({}, rngs={"dropout": key})]
    root = tf.RngScope(np.asarray(key))
    mid = root.push("encoder")
    leaf = mid.push("_Leaf_0")
    got = [root.make_rng()]
    got += [leaf.make_rng() for _ in range(4)]
    got += [mid.make_rng()]
    got += [mid.push("named").make_rng() for _ in range(2)]
    got += [root.make_rng()]
    assert got == want
    # a scope pushed again shares its counter, as flax's reused scopes do
    assert root.push("encoder").push("_Leaf_0").make_rng() == \
        tf.fold_in_static(tf.PRNGKey(3), ("encoder", "_Leaf_0", 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rate", [((5, 33, 3), 0.1), ((7,), 0.5),
                                        ((2, 64, 16), 0.3)])
def test_dropout_matches_flax_dropout(dtype, shape, rate):
    """flax's ``nn.Dropout`` at the root of an apply (``make_rng`` count
    1 at path ()) against ``tf.dropout`` on that key: the output and the
    gradient of ``sum(y * w)`` bit for bit."""
    rng = np.random.RandomState(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(11)
    drop = fnn.Dropout(rate, deterministic=False)

    def f(xj):
        return drop.apply({}, xj, rngs={"dropout": key})

    xj = jnp.asarray(x).astype(jdt)
    want = f(xj)
    want_g = jax.grad(lambda a: jnp.sum(f(a).astype(jnp.float32)
                                        * jnp.asarray(w)))(xj)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    k = tf.RngScope(np.asarray(key)).make_rng()
    before = launch_counts()
    got = tf.dropout(xt, rate, k)
    (got.float() * torch.from_numpy(w)).sum().backward()
    assert launch_counts() == before       # CPU tensors: the plain version
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))
    keep = tf.bernoulli(k, 1.0 - rate, shape, device="cpu")
    assert torch.equal(got != 0, keep & (xt != 0))


def test_dropout_rate_edges_and_module():
    x = torch.randn(4, 9)
    assert tf.dropout(x, 0.0, (1, 2)) is x
    assert torch.equal(tf.dropout(x, 1.0, (1, 2)), torch.zeros_like(x))
    mod = tf.Dropout(0.25)
    assert torch.equal(mod(x, (1, 2)), tf.dropout(x, 0.25, (1, 2)))
    assert torch.equal(tf.dropout(x, 0.25, (1, 2)),
                       tf.dropout_plain(x, 0.25, (1, 2)))
    assert not torch.equal(tf.dropout(x, 0.25, (1, 2)),
                           tf.dropout(x, 0.25, (1, 3)))
    with pytest.raises(ValueError):
        tf.as_key((1, 2, 3))


def test_attention_seeds_are_randint_of_each_scope():
    key = jax.random.PRNGKey(9)
    root = tf.RngScope(np.asarray(key))
    scopes = [root.push(f"layer_{i}").push("attention") for i in range(3)]
    seeds = tf.attention_seeds(scopes, "cpu")
    assert seeds.dtype == torch.int32 and seeds.shape == (3,)
    for i, s in enumerate(seeds.tolist()):
        k = LazyRng.create(key, f"layer_{i}", "attention", 1).as_jax_rng()
        assert s == int(jax.random.randint(k, (), 0, jnp.iinfo(jnp.int32).max,
                                           dtype=jnp.int32))
