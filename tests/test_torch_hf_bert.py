"""``utils.load_hf_bert`` in apex_tpu_torch against apex_tpu's.

A HuggingFace ``BertForPreTraining``-named ``state_dict`` of a small
BERT (vocab 128, hidden 32, 2 layers, 4 heads, MLP 64, 32 positions),
built in-process from ``numpy.random.RandomState`` with the key names
and (out, in) weight shapes ``tests/L0/test_torch_interop.py::
test_hf_bert_*`` gets from ``transformers``, goes through both
packages' ``load_hf_bert``: every key consumed, each converted tensor
the JAX one carried into the port's layout (``params_from_jax``) bit
for bit, and the MLM and NSP logits of the two models on the same ids,
padding mask and segments within 1e-5 scale-aware (fp32, sums in
another order).  The error cases raise the JAX package's messages: a
checkpoint deeper or shallower than ``num_hidden_layers``, and a
``module.`` prefix is stripped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.utils.torch_interop import load_hf_bert as jax_load_hf_bert
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.utils import load_hf_bert

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=32)
TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def hf_state_dict(cfg, seed=0, tied_bias=True):
    """A HuggingFace ``BertForPreTraining`` state dict of ``cfg``'s
    shapes: normal(0.02) weights, small normal biases and LayerNorm
    shifts, LayerNorm scales around 1."""
    rng = np.random.RandomState(seed)
    h, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    sd = {}

    def lin(name, n_out, n_in):
        sd[f"{name}.weight"] = 0.02 * rng.randn(n_out, n_in)
        sd[f"{name}.bias"] = 0.02 * rng.randn(n_out)

    def ln(name):
        sd[f"{name}.weight"] = 1.0 + 0.1 * rng.randn(h)
        sd[f"{name}.bias"] = 0.1 * rng.randn(h)

    for name, n in (("word_embeddings", v),
                    ("position_embeddings", cfg["max_position_embeddings"]),
                    ("token_type_embeddings", 2)):
        sd[f"bert.embeddings.{name}.weight"] = 0.02 * rng.randn(n, h)
    ln("bert.embeddings.LayerNorm")
    for i in range(cfg["num_hidden_layers"]):
        pre = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{pre}.attention.self.{name}", h, h)
        lin(f"{pre}.attention.output.dense", h, h)
        ln(f"{pre}.attention.output.LayerNorm")
        lin(f"{pre}.intermediate.dense", f, h)
        lin(f"{pre}.output.dense", h, f)
        ln(f"{pre}.output.LayerNorm")
    lin("bert.pooler.dense", h, h)
    lin("cls.predictions.transform.dense", h, h)
    ln("cls.predictions.transform.LayerNorm")
    lin("cls.predictions.decoder", v, h)
    if tied_bias:
        sd["cls.predictions.bias"] = sd["cls.predictions.decoder.bias"]
    else:
        sd["cls.predictions.bias"] = sd.pop("cls.predictions.decoder.bias")
    lin("cls.seq_relationship", 2, h)
    sd = {k: np.asarray(a, np.float32) for k, a in sd.items()}
    sd["bert.embeddings.position_ids"] = np.arange(
        cfg["max_position_embeddings"])[None]
    return sd


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["vocab_size"], (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 12:] = 0
    segs = rng.randint(0, 2, (2, 16)).astype(np.int32)
    return ids, mask, segs


@pytest.mark.parametrize("tied_bias", [True, False])
def test_conversion_and_logits_match_jax(tied_bias):
    sd = hf_state_dict(SMALL, tied_bias=tied_bias)
    jvars = jax_load_hf_bert(sd, 2, 4)
    out = load_hf_bert({k: torch.from_numpy(a) for k, a in sd.items()},
                       num_hidden_layers=2, num_attention_heads=4)
    cfg = tb.BertConfig(**SMALL)
    want = tb.params_from_jax(jax.tree.map(np.asarray, jvars), cfg)
    assert set(out["params"]) == set(want)
    for name, t in out["params"].items():
        assert t.dtype == torch.float32
        assert torch.equal(t, want[name]), name
    model = tb.BertForPreTraining(cfg, device="cpu", seed=None)
    model.load_state_dict(out["params"])     # strict: every name
    ids, mask, segs = _inputs()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (ids, mask, segs)))
    jmlm, jnsp = jax_models.BertForPreTraining(jax_models.BertConfig(
        **SMALL)).apply(jvars, *(jnp.asarray(a) for a in (ids, mask, segs)))
    assert rel_err(got[0].numpy(), jmlm) <= TOL
    assert rel_err(got[1].numpy(), jnsp) <= TOL


def test_module_prefix_is_stripped():
    sd = hf_state_dict(SMALL, seed=1)
    plain = load_hf_bert(sd, 2, 4)["params"]
    wrapped = load_hf_bert({f"module.{k}": v for k, v in sd.items()}, 2,
                           4)["params"]
    assert all(torch.equal(plain[k], wrapped[k]) for k in plain)


@pytest.mark.parametrize("layers", [1, 4])
def test_layer_count_mismatch_raises_the_jax_message(layers):
    sd = hf_state_dict(SMALL, seed=2)
    with pytest.raises(ValueError) as want:
        jax_load_hf_bert(sd, num_hidden_layers=layers,
                         num_attention_heads=4)
    with pytest.raises(ValueError) as got:
        load_hf_bert(sd, num_hidden_layers=layers, num_attention_heads=4)
    assert str(got.value) == str(want.value)
    assert ("wrong layer count" if layers == 1 else "missing") \
        in str(got.value)
