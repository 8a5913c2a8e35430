"""apex_tpu_torch BERT against apex_tpu's BertForPreTraining.

At the tiny configuration of ``examples/bert/main_amp.py`` (vocab 1024,
hidden 128, 2 layers, 4 heads, MLP 256) on the JAX model's initial
weights (``params_from_jax``), with token ids from
``numpy.random.RandomState``:

- deterministic MLM and NSP logits within 1e-4 scale-aware (fp32 on
  both sides, sums in another order), with and without an attention
  mask, through the port's ``dot_product_attention`` and through
  ``make_flash_attention`` (its plain version on the CPU);
- dropout on the same key: attention dropout 0.1 and hidden dropout
  0.1, the JAX model given ``rngs={"dropout": key}`` and the port
  ``dropout_key=key``, through ``make_flash_attention`` (the JAX one on
  its plain path, the port's plain version on the CPU) and through the
  default dot-product attention: the attention seeds equal exactly,
  every ``nn.Dropout`` keep mask bit for bit (flax's recorded in call
  order), logits, loss and every gradient within 1e-4 (fp32);
- hidden dropout: the kept fraction, the identity when deterministic,
  the same masks from the same key;
- the leaves the recipe's ``(bias|_ln)`` regex matches are the same
  leaves on both sides.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import stochastic as flax_stochastic

from apex_tpu import models as jax_models
from apex_tpu_torch.examples import bert_main_amp
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.ops import make_flash_attention
from apex_tpu_torch.ops import threefry as tf

jax_fa = importlib.import_module("apex_tpu.ops.flash_attention")

torch.set_num_threads(1)

TINY = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=512)
B, S = 2, 32
TOL = 1e-4


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, TINY["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 21:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_models.BertConfig(**TINY)
    ids, _ = _batch()
    params = jax_models.BertForPreTraining(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    return jax.tree.map(np.asarray, params)


def _port(cfg, params, attention_fn=None):
    model = tb.BertForPreTraining(cfg, attention_fn=attention_fn,
                                  device="cpu", seed=None)
    model.load_state_dict(tb.params_from_jax(params, cfg))
    return model


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("attention", ["dot", "flash"])
def test_deterministic_logits_match_jax(jax_init, masked, attention):
    ids, mask = _batch()
    mask = mask if masked else None
    want = jax_models.BertForPreTraining(jax_models.BertConfig(**TINY)).apply(
        {"params": jax_init}, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask))
    attn = make_flash_attention() if attention == "flash" else None
    model = _port(tb.BertConfig(**TINY), jax_init, attn)
    got = model(torch.from_numpy(ids),
                None if mask is None else torch.from_numpy(mask))
    assert got[0].shape == (B, S, TINY["vocab_size"]) and got[1].shape == (B,
                                                                            2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert rel_err(g.detach().numpy(), w) <= TOL


def _jax_loss(model, params, ids, mask, labels, weights, nsp, rng):
    import optax
    mlm, nsp_logits = model.apply({"params": params}, ids, mask,
                                  deterministic=False,
                                  rngs={"dropout": rng})
    mlm_l = optax.softmax_cross_entropy_with_integer_labels(mlm, labels)
    loss = jnp.sum(mlm_l * weights) / jnp.maximum(jnp.sum(weights), 1.0)
    loss = loss + optax.softmax_cross_entropy_with_integer_labels(
        nsp_logits, nsp).mean()
    return loss, (mlm, nsp_logits)


class _RecordingRandom:
    """``jax.random`` for ``flax.linen.stochastic``: records every
    dropout keep mask ``nn.Dropout`` draws, in call order."""

    def __init__(self):
        self.masks = []

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def bernoulli(self, key, p=0.5, shape=None):
        mask = jax.random.bernoulli(key, p=p, shape=shape)
        self.masks.append(np.asarray(mask))
        return mask


def _same_key_case(jax_init, monkeypatch, attention):
    """Tiny BERT with attention and hidden dropout 0.1, one key for both
    packages; returns nothing, asserts the seeds, the masks, the logits,
    the loss and every gradient."""
    kw = dict(TINY, attention_probs_dropout_prob=0.1,
              hidden_dropout_prob=0.1)
    cfg = tb.BertConfig(**kw)
    ids, mask = _batch(1)
    rng = np.random.RandomState(2)
    labels = rng.randint(0, kw["vocab_size"], (B, S)).astype(np.int32)
    weights = (rng.rand(B, S) < 0.3).astype(np.float32)
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    # step 1's key under the example's rule, fold_in(PRNGKey(seed), step)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    assert bert_main_amp.step_key(0, 1) == tuple(int(x) for x in
                                                 np.asarray(key))

    jseeds, seeds = [], []

    def recording(fn, out):
        def attention_fn(q, k, v, bias=None, dropout_fn=None):
            if not isinstance(dropout_fn.seed, jax.core.Tracer):
                out.append(int(dropout_fn.seed))
            return fn(q, k, v, bias=bias, dropout_fn=dropout_fn)
        return attention_fn

    flash = attention == "flash"
    jattn = recording(jax_fa.make_flash_attention(use_pallas=False),
                      jseeds) if flash else None
    jmodel = jax_models.BertForPreTraining(jax_models.BertConfig(**kw),
                                           attention_fn=jattn)
    jparams = jax.tree.map(jnp.asarray, jax_init)
    jargs = tuple(jnp.asarray(a) for a in (ids, mask, labels, weights, nsp))
    recorder = _RecordingRandom()
    with monkeypatch.context() as mp:
        mp.setattr(flax_stochastic, "random", recorder)
        jmodel.apply({"params": jparams}, jargs[0], jargs[1],
                     deterministic=False, rngs={"dropout": key})
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, *jargs, key), has_aux=True))(jparams)

    masks = []
    plain_dropout = tf.dropout

    def recording_dropout(x, rate, k):
        masks.append(tf.bernoulli(k, 1.0 - rate, x.shape,
                                  device="cpu").numpy())
        return plain_dropout(x, rate, k)

    monkeypatch.setattr(tf, "dropout", recording_dropout)
    attn = recording(make_flash_attention(), seeds) if flash else None
    model = _port(cfg, jax_init, attn)
    params = dict(model.named_parameters())
    mlm, nsp_logits = model(torch.from_numpy(ids), torch.from_numpy(mask),
                            deterministic=False, dropout_key=np.asarray(key))
    loss = bert_main_amp.batch_loss(mlm, nsp_logits, torch.from_numpy(labels),
                                    torch.from_numpy(weights),
                                    torch.from_numpy(nsp))
    grads = torch.autograd.grad(loss, list(params.values()))

    layers = cfg.num_hidden_layers
    assert seeds == jseeds and len(seeds) == (layers if flash else 0)
    # the embeddings' dropout, then per layer (the attention probs on the
    # default path) the attention output and the MLP output
    assert len(masks) == len(recorder.masks) == 1 + layers * (2 if flash
                                                              else 3)
    for got, want in zip(masks, recorder.masks):
        np.testing.assert_array_equal(got, want)
    for g, w in zip((mlm, nsp_logits), jlogits):
        assert rel_err(g.detach().numpy(), w) <= TOL
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    want = tb.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for name, g in zip(params, grads):
        assert rel_err(g.numpy(), want[name].numpy()) <= TOL, name
    # the dropout is live: another key, other logits
    other = model(torch.from_numpy(ids), torch.from_numpy(mask),
                  deterministic=False, dropout_key=tf.PRNGKey(6))[0]
    assert rel_err(other.detach().numpy(), mlm.detach().numpy()) > 1e-3


def test_attention_dropout_matches_jax_through_injected_seeds(jax_init,
                                                             monkeypatch):
    """Flash attention with both dropouts on, on one key for both
    packages: no seed is injected; the port draws the seeds flax draws
    (``_same_key_case``)."""
    _same_key_case(jax_init, monkeypatch, "flash")


def test_default_attention_dropout_matches_jax_on_the_same_key(jax_init,
                                                              monkeypatch):
    """The default dot-product attention, whose probs dropout is the
    attention's own ``Dropout_0``, on one key for both packages."""
    _same_key_case(jax_init, monkeypatch, "dot")


def test_hidden_dropout_rate_identity_and_repeatability():
    x = torch.ones(100_000)
    y = tf.dropout(x, 0.1, tf.PRNGKey(0))
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 0.005
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0],
                                                  float(np.float32(1 / 0.9))))
    assert tf.dropout(x, 0.0, None) is x
    a = tf.dropout(x, 0.3, tf.PRNGKey(7))
    b = tf.dropout(x, 0.3, tf.PRNGKey(7))
    assert torch.equal(a, b)

    cfg = tb.BertConfig(**TINY)
    model = tb.BertForPreTraining(cfg, device="cpu", seed=0)
    ids = torch.from_numpy(_batch()[0])
    base = model(ids)
    same = model(ids, deterministic=True, dropout_key=tf.PRNGKey(3))
    assert all(torch.equal(p, q) for p, q in zip(base, same))
    d1 = model(ids, deterministic=False, dropout_key=tf.PRNGKey(3))
    d2 = model(ids, deterministic=False, dropout_key=tf.PRNGKey(3))
    assert all(torch.equal(p, q) for p, q in zip(d1, d2))
    assert not torch.equal(d1[0], base[0])
    with pytest.raises(ValueError, match="dropout_key"):
        model(ids, deterministic=False)


def test_no_decay_leaves_are_the_same_leaves(jax_init):
    """Tag every JAX leaf with its index, carry the tree over with
    ``params_from_jax`` and check that ``(bias|_ln)`` picks the same
    tagged tensors by the port's names as by the JAX key paths."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax_init)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, (_, x) in enumerate(flat)])
    rx = re.compile(r"(bias|_ln)")
    want = {i for i, (path, _) in enumerate(flat)
            if rx.search(jax.tree_util.keystr(path))}
    sd = tb.params_from_jax(tagged, tb.BertConfig(**TINY))
    assert len(sd) == len(flat)
    got = {int(t.reshape(-1)[0]) for name, t in sd.items() if rx.search(name)}
    assert got == want
    names = dict(tb.BertForPreTraining(tb.BertConfig(**TINY), device="cpu",
                                       seed=0).named_parameters())
    assert set(names) == set(sd)


def test_configs_match_jax():
    for port, ref in ((tb.bert_base(), jax_models.bert_base()),
                      (tb.bert_large(), jax_models.bert_large())):
        for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                      "num_attention_heads", "intermediate_size",
                      "max_position_embeddings", "type_vocab_size",
                      "hidden_dropout_prob", "attention_probs_dropout_prob",
                      "layer_norm_eps", "initializer_range"):
            assert getattr(port, field) == getattr(ref, field), field
