"""apex_tpu_torch FusedLAMB against apex_tpu's FusedLAMB.

The same parameters, gradients and hyperparameters — the BERT recipe of
``examples/bert/main_amp.py`` (no weight decay and no layer adaptation
for ``(bias|_ln)`` leaves) on a tree with BERT's leaf names — go through
both optimizers for five steps, with the global-norm clip active and
idle and with ``trust_clip``: p, m and v agree within 1e-6 relative
(max|a-b| / max|b|; fp32 on both sides, sums in another order).  The
skip step keeps every bit of p, m, v and the step counter; a zero
parameter tensor takes the unit trust ratio; amp O2 around FusedLAMB
halves the scale on an inf gradient.  Inputs come from
``numpy.random.RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu import optimizers as jax_optimizers
from apex_tpu_torch import amp
from apex_tpu_torch.models import BertConfig, BertForPreTraining
from apex_tpu_torch.optimizers import FusedLAMB

torch.set_num_threads(1)

SHAPES = {
    "encoder.word_embeddings.weight": (50, 16),
    "encoder.embeddings_ln.scale": (16,),
    "encoder.embeddings_ln.bias": (16,),
    "encoder.layer_0.attention.query.weight": (16, 16),
    "encoder.layer_0.attention.query.bias": (16,),
    "encoder.layer_0.intermediate.weight": (32, 16),
    "encoder.layer_0.output_ln.scale": (16,),
    "mlm_decoder.bias": (50,),
    "nsp_classifier.weight": (2, 16),
}
GROUPS = [{"match": r"(bias|_ln)", "weight_decay": 0.0}]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _optimizers(**kw):
    kw = dict(lr=1e-2, max_grad_norm=1.0, param_groups=GROUPS, **kw)
    jopt = jax_optimizers.FusedLAMB(
        exclude_from_layer_adaptation=lambda path: any(
            "bias" in str(k) or "_ln" in str(k) for k in path), **kw)
    topt = FusedLAMB(
        exclude_from_layer_adaptation=lambda n: "bias" in n or "_ln" in n,
        **kw)
    return jopt, topt


def _params(rng, zero=()):
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    for k in zero:
        params[k][:] = 0.0
    return params


@pytest.mark.parametrize("grad_scale", [3.0, 0.01])   # clip active, idle
@pytest.mark.parametrize("trust_clip", [None, 0.5])
def test_five_steps_match_jax(grad_scale, trust_clip):
    rng = np.random.RandomState(0)
    params = _params(rng)
    jopt, topt = _optimizers(trust_clip=trust_clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: (grad_scale * rng.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, js = jopt.step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts)
    assert int(ts.step) == int(js.step) == 5
    for k in SHAPES:
        assert tp[k].dtype == torch.float32 and tp[k].requires_grad
        assert _rel(tp[k].detach().numpy(), jp[k]) <= 1e-6, k
        assert _rel(ts.m[k].numpy(), js.m[k]) <= 1e-6, k
        assert _rel(ts.v[k].numpy(), js.v[k]) <= 1e-6, k


def test_zero_tensor_takes_the_unit_ratio():
    """A zero parameter tensor (norm 0) moves by ``-lr * update`` with
    ratio 1.0, as in the JAX package, where the others are scaled."""
    rng = np.random.RandomState(1)
    zero = "encoder.layer_0.intermediate.weight"
    params = _params(rng, zero=(zero,))
    g = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jopt, topt = _optimizers()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jd, _ = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                        jopt.init(jp), jp)
    td, _ = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                        topt.init(tp), tp)
    for k in SHAPES:
        assert _rel(td[k].numpy(), jd[k]) <= 1e-6, k
    # step 1 without weight decay on zeros: update = m_hat/(sqrt(v_hat)
    # + eps) = g/(|g| + eps) of the clipped g, times -lr * 1.0
    assert np.all(np.abs(np.abs(td[zero].numpy()) - 1e-2) < 1e-4)


def test_skip_step_keeps_every_bit():
    rng = np.random.RandomState(2)
    params = _params(rng)
    _, topt = _optimizers()
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    g = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
         for k, s in SHAPES.items()}
    tp, ts = topt.step(tp, g, ts)
    # a -0.0 survives the skip too: a select, not p + 0
    tp["encoder.embeddings_ln.bias"].data[3] = -0.0
    snap = ({k: t.clone() for k, t in tp.items()},
            {k: t.clone() for k, t in ts.m.items()},
            {k: t.clone() for k, t in ts.v.items()}, ts.step.clone())
    bad = {k: t.clone() for k, t in g.items()}
    bad["encoder.layer_0.attention.query.weight"][2, 3] = float("inf")
    bad["mlm_decoder.bias"][7] = float("nan")
    tp2, ts2 = topt.step(tp, bad, ts, skip=torch.tensor(True))
    for k in SHAPES:
        assert torch.equal(tp2[k], snap[0][k]), k
        assert torch.equal(ts2.m[k], snap[1][k]), k
        assert torch.equal(ts2.v[k], snap[2][k]), k
        assert tp2[k].view(torch.int32).equal(snap[0][k].view(torch.int32))
    assert torch.equal(ts2.step, snap[3])
    deltas, ts3 = topt.update(bad, ts, tp, skip=True)
    assert all(torch.equal(d, torch.zeros_like(d)) for d in deltas.values())
    assert torch.equal(ts3.step, snap[3])
    # skip=False is an ordinary step
    tp4, ts4 = topt.step(tp, g, ts, skip=torch.tensor(False))
    tp5, ts5 = topt.step(tp, g, ts)
    assert all(torch.equal(tp4[k], tp5[k]) for k in SHAPES)
    assert int(ts4.step) == int(ts5.step) == 2


def test_unknown_group_key_is_refused():
    with pytest.raises(ValueError, match="weight_deacy"):
        FusedLAMB(param_groups=[{"match": "bias", "weight_deacy": 0.0}])
    with pytest.raises(ValueError, match="no 'match'"):
        FusedLAMB(param_groups=[{"lr": 0.1}])


def test_amp_o2_overflow_halves_the_scale_like_jax():
    """``amp.initialize(..., opt_level="O2")`` around FusedLAMB (the
    tiny BERT as the model): a finite step, then an inf gradient skips
    the update and halves the loss scale on both sides."""
    rng = np.random.RandomState(3)
    params = _params(rng)
    jopt, topt = _optimizers()
    tiny = dict(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32)
    _, jwrap = jamp.initialize(
        jax_models.BertForPreTraining(jax_models.BertConfig(**tiny)), jopt,
        opt_level="O2", verbosity=0)
    _, twrap = amp.initialize(
        BertForPreTraining(BertConfig(**tiny), device="cpu"), topt,
        opt_level="O2", verbosity=0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jwrap.init(jp), twrap.init(tp)
    for bad in (False, True):
        g = {k: (2.0 ** 16 * rng.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if bad:
            g["nsp_classifier.weight"][0, 1] = np.inf
        jp, js = jwrap.step(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js)
        before = {k: t.clone() for k, t in tp.items()}
        tp, ts = twrap.step(tp, {k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts)
        assert float(twrap.loss_scale(ts)) == float(jwrap.loss_scale(js))
        if bad:
            assert all(torch.equal(tp[k], before[k]) for k in SHAPES)
    assert float(twrap.loss_scale(ts)) == 2.0 ** 15
    assert int(ts.skipped_steps) == int(js.skipped_steps) == 1
    assert int(ts.inner.step) == int(js.inner.step) == 1
    for k in SHAPES:
        assert _rel(tp[k].detach().numpy(), jp[k]) <= 1e-6, k
