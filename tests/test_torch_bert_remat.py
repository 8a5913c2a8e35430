"""BERT remat in apex_tpu_torch against apex_tpu's.

At the tiny configuration of ``examples/bert/main_amp.py`` (vocab 1024,
hidden 128, 2 layers, 4 heads, MLP 256) on the JAX model's initial
weights (``params_from_jax``), ids from ``numpy.random.RandomState``:

- the twin of ``tests/L0/test_models.py::test_bert_remat_matches_no_
  remat``: the remat encoder's output and every gradient bit for bit
  those without remat, and the JAX remat encoder's within 1e-5 (output)
  and 1e-4 (gradients) scale-aware (fp32, sums in another order);
- dropout on (0.1 hidden, 0.1 attention), default and flash attention:
  the loss and every gradient under remat bit for bit those without;
- ``bert_main_amp.train(remat=True)`` (O2, flash, dropout, 2 steps)
  bit for bit the run without remat: losses, params and scaler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu_torch.examples import bert_main_amp
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.ops import make_flash_attention
from apex_tpu_torch.ops import threefry as tf

torch.set_num_threads(1)

TINY = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=512)
B, S = 2, 32
TOL, GRAD_TOL = 1e-5, 1e-4


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
    params = jax.jit(jax_models.BertForPreTraining(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    return jax.tree.map(np.asarray, params)


def _port(params, attention_fn=None, **kw):
    cfg = tb.BertConfig(**TINY, **kw)
    model = tb.BertForPreTraining(cfg, attention_fn=attention_fn,
                                  device="cpu", seed=None)
    model.load_state_dict(tb.params_from_jax(params, cfg))
    return model


def _encoder_sum_and_grads(model, ids, mask, **kw):
    params = list(model.encoder.parameters())
    out = model.encoder(ids, mask, **kw)
    return out.detach(), torch.autograd.grad(out.float().sum(), params)


def test_remat_matches_no_remat_and_jax(jax_init):
    ids, mask = _batch(1)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    o0, g0 = _encoder_sum_and_grads(_port(jax_init), t_ids, t_mask)
    model = _port(jax_init, remat=True)
    o1, g1 = _encoder_sum_and_grads(model, t_ids, t_mask)
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)

    jenc = jax_models.BertEncoder(jax_models.BertConfig(**TINY, remat=True))
    jv = {"params": jax.tree.map(jnp.asarray, jax_init["encoder"])}
    args = (jnp.asarray(ids), jnp.asarray(mask))

    def jsum(v):
        out = jenc.apply(v, *args)
        return out.astype(jnp.float32).sum(), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jsum, has_aux=True))(jv)
    jgrads = jgrads["params"]
    assert rel_err(o1.numpy(), jout) <= TOL
    cfg = tb.BertConfig(**TINY)
    full = jax.tree.map(np.asarray, dict(jax_init, encoder=jgrads))
    want = {k[len("encoder."):]: v for k, v in
            tb.params_from_jax(full, cfg).items() if k.startswith("encoder.")}
    names = [n for n, _ in model.encoder.named_parameters()]
    for name, g in zip(names, g1):
        assert rel_err(g.numpy(), want[name].numpy()) <= GRAD_TOL, name


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_remat_with_dropout_is_bit_for_bit(jax_init, attention):
    ids, mask = (torch.from_numpy(a) for a in _batch(2))
    attn = make_flash_attention() if attention == "flash" else None
    key = tf.fold_in(tf.PRNGKey(5), 2)
    out = []
    for remat in (False, True):
        model = _port(jax_init, attn, remat=remat)
        params = list(model.parameters())
        mlm, nsp = model(ids, mask, deterministic=False, dropout_key=key)
        loss = mlm.float().square().mean() + nsp.float().square().mean()
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_example_train_with_remat_is_bit_for_bit():
    cfg = dataclasses.replace(bert_main_amp.get_config("tiny"),
                              num_hidden_layers=1)
    runs = [bert_main_amp.train(cfg, batch=2, seq_len=16, steps=2,
                                device="cpu", deterministic=False,
                                attention_fn=make_flash_attention(),
                                remat=remat)
            for remat in (False, True)]
    assert runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["loss_scale"] == runs[1]["loss_scale"]
    for name, p in runs[0]["params"].items():
        assert torch.equal(p, runs[1]["params"][name]), name
    assert bert_main_amp.parse_args(["--remat"]).remat
