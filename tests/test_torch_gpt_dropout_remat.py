"""GPT's training dropout and remat in apex_tpu_torch against apex_tpu's.

A tiny GPT (vocab 97, hidden 64, 2 layers, 4 heads, MLP 128, sequence
32) on the JAX model's initial weights (``params_from_jax``), token ids
from ``numpy.random.RandomState``:

- dropout 0.1 hidden and 0.1 attention, ``deterministic=False``, one key
  for both packages (the JAX model's ``rngs={"dropout": key}``, the
  port's ``dropout_key=key``), through the default causal attention
  (the attention's ``Dropout_0`` on the probs) and through the flash
  adapter (the JAX one on its plain path, the port's plain version on
  the CPU): the attention seeds equal, every ``nn.Dropout`` keep mask
  bit for bit (flax's recorded in call order), logits and loss within
  1e-5 scale-aware, and on the flash path every gradient within 1e-4
  (fp32 on both sides, sums in another order);
- remat with dropout on: loss and every gradient bit for bit those
  without remat (the recompute draws the forward's keys);
- the twin of ``tests/L0/test_gpt.py::test_remat_is_numerically_
  identical``: remat changes nothing in the port, and matches the JAX
  model's remat run within 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic as flax_stochastic

from apex_tpu import models as jax_models
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import make_flash_attention
from apex_tpu_torch.ops import threefry as tf

jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")

torch.set_num_threads(1)

TINY = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=32)
B, S = 2, 32
TOL, GRAD_TOL = 1e-5, 1e-4


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"],
                                               (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_models.GPTConfig(**TINY)
    params = jax.jit(jax_models.GPTLMHeadModel(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(_ids()))["params"]
    return jax.tree.map(np.asarray, params)


def _port(params, attention_fn=None, **kw):
    cfg = tg.GPTConfig(**TINY, **kw)
    model = tg.GPTLMHeadModel(cfg, attention_fn=attention_fn, device="cpu",
                              seed=None)
    model.load_state_dict(tg.params_from_jax(params, cfg))
    return model


class _RecordingRandom:
    """``jax.random`` for ``flax.linen.stochastic``: records every keep
    mask ``nn.Dropout`` draws, in call order (an ordered callback, so a
    jitted apply records too)."""

    def __init__(self):
        self.masks = []

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def bernoulli(self, key, p=0.5, shape=None):
        mask = jax.random.bernoulli(key, p=p, shape=shape)
        jax.debug.callback(lambda m: self.masks.append(np.asarray(m)), mask,
                           ordered=True)
        return mask


def _recording(fn, out):
    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        if dropout_fn is None:
            pass
        elif isinstance(dropout_fn.seed, jax.core.Tracer):
            jax.debug.callback(lambda s: out.append(int(s)),
                               dropout_fn.seed, ordered=True)
        else:
            out.append(int(dropout_fn.seed))
        return fn(q, k, v, bias=bias, dropout_fn=dropout_fn)
    return attention_fn


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_dropout_matches_jax_on_the_same_key(jax_init, monkeypatch,
                                             attention):
    kw = dict(TINY, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids = _ids(1)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    flash = attention == "flash"
    jseeds, seeds = [], []
    jattn = _recording(jax_fa.make_flash_attention(causal=True,
                                                   use_pallas=False),
                       jseeds) if flash else None
    jmodel = jax_models.GPTLMHeadModel(jax_models.GPTConfig(**kw),
                                       attention_fn=jattn)
    jparams = jax.tree.map(jnp.asarray, jax_init)
    recorder = _RecordingRandom()
    with monkeypatch.context() as mp:
        mp.setattr(flax_stochastic, "random", recorder)
        jlogits = jax.jit(lambda p: jmodel.apply(
            {"params": p}, jnp.asarray(ids), deterministic=False,
            rngs={"dropout": key}))(jparams)
        jax.effects_barrier()
    jl = jax_models.lm_loss(jlogits, jnp.asarray(ids))

    masks = []
    plain_dropout = tf.dropout

    def recording_dropout(x, rate, k):
        masks.append(tf.bernoulli(k, 1.0 - rate, x.shape,
                                  device="cpu").numpy())
        return plain_dropout(x, rate, k)

    monkeypatch.setattr(tf, "dropout", recording_dropout)
    attn = _recording(make_flash_attention(causal=True), seeds) \
        if flash else None
    model = _port(jax_init, attn, hidden_dropout_prob=0.1,
                  attention_probs_dropout_prob=0.1)
    params = dict(model.named_parameters())
    t_ids = torch.from_numpy(ids)
    logits = model(t_ids, deterministic=False, dropout_key=np.asarray(key))
    loss = tg.lm_loss(logits, t_ids)
    grads = torch.autograd.grad(loss, list(params.values()))

    layers = TINY["num_hidden_layers"]
    assert seeds == jseeds and len(seeds) == (layers if flash else 0)
    # the embeddings' dropout, then per block (the attention probs on
    # the default path) the attention output and the MLP output
    assert len(masks) == len(recorder.masks) == 1 + layers * (2 if flash
                                                              else 3)
    for got, want in zip(masks, recorder.masks):
        np.testing.assert_array_equal(got, want)
    assert rel_err(logits.detach().numpy(), jlogits) <= TOL
    assert abs(float(loss.detach()) - float(jl)) <= TOL * abs(float(jl))
    if flash:   # the gradients through the kernels' dropout branches
        jgrads = jax.jit(jax.grad(lambda p: jax_models.lm_loss(
            jmodel.apply({"params": p}, jnp.asarray(ids),
                         deterministic=False, rngs={"dropout": key}),
            jnp.asarray(ids))))(jparams)
        want = tg.params_from_jax(jax.tree.map(np.asarray, jgrads),
                                  tg.GPTConfig(**TINY))
        for name, g in zip(params, grads):
            assert rel_err(g.numpy(), want[name].numpy()) <= GRAD_TOL, name
    # the dropout is live: another key, other logits; deterministic
    # ignores the key
    other = model(t_ids, deterministic=False, dropout_key=tf.PRNGKey(6))
    assert rel_err(other.detach().numpy(), logits.detach().numpy()) > 1e-3
    with torch.no_grad():
        assert torch.equal(model(t_ids), model(t_ids, dropout_key=key))
    with pytest.raises(ValueError, match="dropout_key"):
        model(t_ids, deterministic=False)


def _loss_and_grads(model, ids, **kw):
    params = list(model.parameters())
    loss = tg.lm_loss(model(ids, **kw), ids)
    return loss.detach(), torch.autograd.grad(loss, params)


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_remat_with_dropout_is_bit_for_bit(jax_init, attention):
    """Dropout on, remat on: the recompute draws the forward's keys (a
    key drawn anew there would drop other positions and give other,
    silently wrong, gradients)."""
    ids = torch.from_numpy(_ids(2))
    attn = make_flash_attention(causal=True) if attention == "flash" \
        else None
    key = tf.fold_in(tf.PRNGKey(3), 7)
    kw = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    l0, g0 = _loss_and_grads(_port(jax_init, attn, **kw), ids,
                             deterministic=False, dropout_key=key)
    l1, g1 = _loss_and_grads(_port(jax_init, attn, remat=True, **kw), ids,
                             deterministic=False, dropout_key=key)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_is_numerically_identical(jax_init):
    """``tests/L0/test_gpt.py::test_remat_is_numerically_identical`` on
    the port (bit for bit there), and the port's remat run against the
    JAX model's."""
    ids = _ids(4)
    jcfg = jax_models.GPTConfig(**TINY, remat=True)
    jmodel = jax_models.GPTLMHeadModel(jcfg)

    def jloss(p):
        return jax_models.lm_loss(jmodel.apply({"params": p},
                                               jnp.asarray(ids)),
                                  jnp.asarray(ids))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, jax_init))
    t_ids = torch.from_numpy(ids)
    model = _port(jax_init, remat=True)
    l1, g1 = _loss_and_grads(model, t_ids)
    l0, g0 = _loss_and_grads(_port(jax_init), t_ids)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert abs(float(l1) - float(jl)) <= TOL * abs(float(jl))
    want = tg.params_from_jax(jax.tree.map(np.asarray, jgrads),
                              tg.GPTConfig(**TINY))
    for name, g in zip(dict(model.named_parameters()), g1):
        assert rel_err(g.numpy(), want[name].numpy()) <= GRAD_TOL, name
    # serving never remats: the KV path runs the blocks as they are
    with torch.no_grad():
        logits, kvs = model(t_ids, return_kv=True)
    assert len(kvs) == TINY["num_hidden_layers"]
    assert dataclasses.replace(model.cfg, remat=False) == tg.GPTConfig(
        **TINY)
