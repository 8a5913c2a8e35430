"""The port's BERT pretraining step against the JAX example's.

``examples/bert/main_amp.py`` at its tiny configuration (vocab 1024,
hidden 128, 2 layers, 4 heads, MLP 256), batch 4, sequence 32, three
steps of its ``train_step``: MLM + NSP loss on ``synthetic_mlm_batch``
(``RandomState(0)``), dot-product attention, ``deterministic=True``,
and the recipe's ``FusedLAMB(lr=1e-4, max_grad_norm=1.0)`` with the
``(bias|_ln)`` no-decay group and layer-adaptation exclusion, under amp.
The port's side is ``apex_tpu_torch.examples.bert_main_amp`` on the CPU
(the plain versions of its kernels) from the JAX model's initial
weights (``params_from_jax``).

Tolerances as ``test_torch_gpt_training.py``: O0 losses <= 1e-5
relative per step and step-1 grads <= 1e-5 scale-aware (fp32 on both
sides, sums in another order); params after step 3 <= 1e-3 scale-aware;
O2 (bf16 compute) losses within 2e-2 absolute, the loss scale and the
skipped and applied step counts equal.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu import optimizers as jax_optimizers
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.examples import bert_main_amp
from apex_tpu_torch.models.bert import params_from_jax

torch.set_num_threads(1)

B, S, STEPS, LR = 4, 32, 3, 1e-4
EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "bert" / \
    "main_amp.py"


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_bert_main_amp",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_batches_equal_the_jax_example():
    ex = _jax_example()
    args = types.SimpleNamespace(b=B, seq_len=S, mask_prob=0.15)
    rng = np.random.RandomState(0)
    cfg = ex.get_config("tiny")
    port = bert_main_amp.batches(bert_main_amp.get_config("tiny"), B, S)
    for _ in range(3):
        for a, b in zip(next(port), ex.synthetic_mlm_batch(rng, args, cfg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _jax_run(level):
    """The example's train step, three steps; returns the initial params,
    per-step losses, step-1 grads, final params, optimizer and state."""
    ex = _jax_example()
    cfg = ex.get_config("tiny")
    model, optimizer = jamp.initialize(
        jax_models.BertForPreTraining(cfg),
        jax_optimizers.FusedLAMB(
            lr=LR, max_grad_norm=1.0,
            param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
            exclude_from_layer_adaptation=lambda path: any(
                "bias" in str(k) or "_ln" in str(k) for k in path)),
        opt_level=level)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, S), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    opt_state = optimizer.init(params)

    @jax.jit
    def train_step(params, opt_state, ids, labels, weights, nsp):
        def loss_fn(p):
            mlm_logits, nsp_logits = model.apply({"params": p}, ids,
                                                 deterministic=True)
            mlm = optax.softmax_cross_entropy_with_integer_labels(
                mlm_logits, labels)
            loss = jnp.sum(mlm * weights) / jnp.maximum(jnp.sum(weights),
                                                        1.0)
            loss = loss + optax.softmax_cross_entropy_with_integer_labels(
                nsp_logits, nsp).mean()
            with jamp.scale_loss(loss, opt_state) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads

    rng = np.random.RandomState(0)
    args = types.SimpleNamespace(b=B, seq_len=S, mask_prob=0.15)
    losses, grads1 = [], None
    for step in range(STEPS):
        batch = [jnp.asarray(a) for a in ex.synthetic_mlm_batch(rng, args,
                                                                cfg)]
        params, opt_state, loss, grads = train_step(params, opt_state,
                                                    *batch)
        losses.append(float(loss))
        if step == 0:
            grads1 = jax.tree.map(np.asarray, grads)
    return init, losses, grads1, jax.tree.map(np.asarray, params), \
        optimizer, opt_state


def _port_run(level, init):
    cfg = bert_main_amp.get_config("tiny")
    model, optimizer, params, opt_state = bert_main_amp.build(
        cfg, lr=LR, opt_level=level, device="cpu",
        state_dict=params_from_jax(init, cfg))
    data = bert_main_amp.batches(cfg, B, S)
    losses, grads1 = [], None
    before = launch_counts()
    for step in range(STEPS):
        batch = tuple(torch.from_numpy(a) for a in next(data))
        params, opt_state, loss, grads = bert_main_amp.train_step(
            model, optimizer, params, opt_state, batch)
        losses.append(float(loss))
        if step == 0:
            grads1 = grads
    assert launch_counts() == before, "the CPU path launched a kernel"
    return losses, grads1, params, optimizer, opt_state


@pytest.fixture(scope="module")
def o0_runs():
    init, jlosses, jgrads, jparams, _, _ = _jax_run("O0")
    return (jlosses, jgrads, jparams), _port_run("O0", init)


def test_o0_losses_match_jax_every_step(o0_runs):
    (jlosses, _, _), (losses, _, _, _, _) = o0_runs
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-5 * abs(want), (losses, jlosses)


def test_o0_step1_grads_match_jax(o0_runs):
    (_, jgrads, _), (_, grads, _, _, _) = o0_runs
    want = params_from_jax(jgrads, bert_main_amp.get_config("tiny"))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert rel_err(g.numpy(), want[name].numpy()) <= 1e-5, name


def test_o0_params_after_three_steps_match_jax(o0_runs):
    (_, _, jparams), (_, _, params, _, st) = o0_runs
    want = params_from_jax(jparams, bert_main_amp.get_config("tiny"))
    for name, p in params.items():
        assert p.dtype == torch.float32
        assert rel_err(p.detach().numpy(), want[name].numpy()) <= 1e-3, name
    assert int(st.applied_steps) == STEPS and int(st.inner.step) == STEPS


def test_o2_losses_and_scaler_match_jax():
    init, jlosses, _, _, jopt, jst = _jax_run("O2")
    losses, grads, params, opt, st = _port_run("O2", init)
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 2e-2, (losses, jlosses)
    assert float(opt.loss_scale(st)) == float(jopt.loss_scale(jst))
    assert int(st.skipped_steps) == int(jst.skipped_steps)
    assert int(st.applied_steps) == int(jst.applied_steps)
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_train_with_flash_and_dropout_on_the_cpu():
    """``train()`` with the model API's knobs: flash attention with
    in-kernel dropout (its plain version here) and hidden dropout;
    finite losses, scaler state reported, no kernel launched."""
    before = launch_counts()
    cfg = bert_main_amp.get_config("tiny")
    from apex_tpu_torch.ops import make_flash_attention
    out = bert_main_amp.train(cfg, batch=2, seq_len=16, steps=2,
                              opt_level="O2", device="cpu",
                              attention_fn=make_flash_attention(),
                              deterministic=False)
    assert launch_counts() == before
    assert len(out["losses"]) == len(out["step_seconds"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert out["loss_scale"] == 2.0 ** 16
    assert out["skipped_steps"] == 0 and out["applied_steps"] == 2
