"""The port's training slice against the JAX example's train step.

GPT tiny of ``examples/gpt/main_amp.py`` (vocab 997, hidden 128, 2
layers, 4 heads, MLP 256) at batch 2, sequence 64, trained three steps
with ``FusedAdam(lr=1e-4)`` (flat layout) under amp, on the same weights:
the JAX model's initial params carried into the port by
``params_from_jax``, and the same token batches
(``RandomState(0).randint``, as the example makes them).  The JAX step is
the example's ``train_step`` with the causal flash adapter (off the TPU
it routes to the flash reference); the port's is
``apex_tpu_torch.examples.gpt_main_amp.train_step`` on the CPU, i.e. the
plain versions of its kernels.

Tolerances: O0 losses <= 1e-5 relative per step and step-1 grads <= 1e-5
scale-aware (fp32 on both sides, sums in another order); params after
step 3 <= 1e-3 scale-aware (Adam's first steps are ~lr * sign(g), so a
near-zero gradient's rounding flips an update of +-lr = 1e-4).  O2 and
O1 (bf16 compute) losses within 2e-2 absolute; the loss scale and the
skipped and applied step counts equal.  O1 installs both packages'
process-global op policies: ``_no_leaked_o1`` removes them and resets
the port's amp state after every test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu import optimizers as jax_optimizers
from apex_tpu.ops.flash_attention import make_flash_attention as jax_flash
from apex_tpu_torch import amp
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import gpt_main_amp
from apex_tpu_torch.models import GPTConfig, lm_loss, params_from_jax

torch.set_num_threads(1)

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=64)
B, S, STEPS, LR = 2, 64, 3, 1e-4


@pytest.fixture(autouse=True)
def _no_leaked_o1():
    yield
    jamp.remove_o1_patches()
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = None
    _amp_state._amp_state.casts_disabled = False


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _jax_run(level):
    """The example's train step, three steps; returns the initial params,
    per-step losses, step-1 grads, final params and the amp state."""
    cfg = jax_models.GPTConfig(**TINY)
    model, optimizer = jamp.initialize(
        jax_models.GPTLMHeadModel(cfg, attention_fn=jax_flash(causal=True)),
        jax_optimizers.FusedAdam(lr=LR, layout="flat"), opt_level=level,
        verbosity=0)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.ones((1, S), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    opt_state = optimizer.init(params)

    @jax.jit
    def train_step(params, opt_state, ids):
        def loss_fn(p):
            logits = model.apply({"params": p}, ids)
            loss = jax_models.lm_loss(logits, ids)
            with jamp.scale_loss(loss, opt_state) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads

    data = gpt_main_amp.batches(cfg.vocab_size, B, S)
    losses, grads1 = [], None
    for step in range(STEPS):
        params, opt_state, loss, grads = train_step(params, opt_state,
                                                    jnp.asarray(next(data)))
        losses.append(float(loss))
        if step == 0:
            grads1 = jax.tree.map(np.asarray, grads)
    return init, losses, grads1, jax.tree.map(np.asarray, params), \
        optimizer, opt_state


def _port_run(level, init):
    cfg = GPTConfig(**TINY)
    model, optimizer, params, opt_state = gpt_main_amp.build(
        cfg, lr=LR, opt_level=level, device="cpu",
        state_dict=params_from_jax(init, cfg))
    data = gpt_main_amp.batches(cfg.vocab_size, B, S)
    losses, grads1 = [], None
    before = launch_counts()
    for step in range(STEPS):
        ids = torch.from_numpy(next(data))
        params, opt_state, loss, grads = gpt_main_amp.train_step(
            model, optimizer, params, opt_state, ids)
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
    want = params_from_jax(jgrads, GPTConfig(**TINY))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        assert rel_err(g.numpy(), want[name].numpy()) <= 1e-5, name


def test_o0_params_after_three_steps_match_jax(o0_runs):
    (_, _, jparams), (_, _, params, _, st) = o0_runs
    want = params_from_jax(jparams, GPTConfig(**TINY))
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
    # O2: fp32 masters, bf16-rounded gradients arriving as fp32
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(g.dtype == torch.float32 for g in grads.values())


def test_o1_losses_and_scaler_match_jax():
    init, jlosses, _, _, jopt, jst = _jax_run("O1")
    losses, grads, params, opt, st = _port_run("O1", init)
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 2e-2, (losses, jlosses)
    assert float(opt.loss_scale(st)) == float(jopt.loss_scale(jst))
    assert int(st.skipped_steps) == int(jst.skipped_steps)
    assert int(st.applied_steps) == int(jst.applied_steps)
    # O1: fp32 masters and grads; in the compute layout the LayerNorm
    # params stay fp32 (the norm patterns), everything else runs bf16
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(g.dtype == torch.float32 for g in grads.values())
    model = gpt_main_amp.build(GPTConfig(**TINY), opt_level="O1",
                               device="cpu")[0]
    compute = model.compute_variables(params)
    for name, t in compute.items():
        want = torch.float32 if "_ln." in name else torch.bfloat16
        assert t.dtype == want, name
    assert sum("_ln." in n for n in compute) == 2 * (2 * 2 + 1)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 31).astype(np.float32)
    ids = rng.randint(0, 31, (2, 9)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 9), np.int32)
        mask[1, 5:] = 0
    want = jax_models.lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                              None if mask is None else jnp.asarray(mask))
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                  None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_train_returns_losses_times_and_scaler_state():
    cfg = GPTConfig(**dict(TINY, num_hidden_layers=1))
    out = gpt_main_amp.train(cfg, batch=1, seq_len=16, steps=2, lr=LR,
                             opt_level="O2", device="cpu")
    assert len(out["losses"]) == len(out["step_seconds"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert out["loss_scale"] == 2.0 ** 16
    assert out["skipped_steps"] == 0 and out["applied_steps"] == 2
