"""amp's grad-accumulation protocol in the port against the JAX package,
and the BERT twin's ``--grad-accum``.

- ``LossScaler.unscale_with_stashed`` and ``check_overflow`` against the
  JAX scaler's (``tests/L0/test_loss_scaler.py::
  test_unscale_with_stashed_accumulates``), bit for bit: only the
  incoming grads trip the flag;
- ``AmpOptimizer.unscale_grads(stashed=..., update_scale=False)``, one
  ``update_scale`` on the ORed flag and ``apply_gradients``, against the
  JAX ``AmpOptimizer`` (``tests/L0/test_amp_train.py::
  test_grad_accum_defers_scale_update``) fed the same scaled gradients
  (the JAX MLP's, at O2): stash, flags, scaler state, counts and params
  bit for bit;
- BERT-tiny at ``--grad-accum 4`` against ``--grad-accum 1`` on the same
  batches, O0: losses and params within 1e-5 scale-aware;
- an inf in microbatch 2 of 4 (planted in that microbatch's scaled
  grads): the whole step skipped, every param and moment kept, the
  scale halved once; and the JAX example's ``--grad-accum`` checks.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp
import optax

from apex_tpu import amp as jamp
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.models import MLP as JaxMLP
from apex_tpu_torch import amp
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import bert_main_amp as bert
from apex_tpu_torch.models import MLP, mlp_params_from_jax
from apex_tpu_torch.optimizers import transforms


@pytest.fixture(autouse=True)
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def _pair(fill=1.0, bad=None):
    w = np.full((4, 4), fill, np.float32)
    if bad is not None:
        w[0, 0] = bad
    g = {"w": w, "b": np.full((4,), fill, np.float32)}
    return ({k: jnp.asarray(v) for k, v in g.items()},
            {k: torch.from_numpy(v.copy()) for k, v in g.items()})


def _equal(port, jax_tree):
    for k, v in port.items():
        want = np.asarray(jax_tree[k])
        assert v.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_array_equal(v.numpy(), want)


def test_unscale_with_stashed_accumulates():
    js, ts = JaxLossScaler("dynamic", init_scale=2.0), \
        LossScaler("dynamic", init_scale=2.0)
    jst, tst = js.init(), ts.init("cpu")
    for fresh, stash in (((4.0, None), (1.0, None)),
                         ((4.0, None), (1.0, np.inf)),
                         ((4.0, np.inf), (1.0, None)),
                         ((4.0, np.nan), (1.0, np.inf))):
        (jg, tg), (jstash, tstash) = _pair(*fresh), _pair(*stash)
        jout, jovf = js.unscale_with_stashed(jg, jstash, jst)
        tout, tovf = ts.unscale_with_stashed(tg, tstash, tst)
        _equal(tout, jout)
        assert bool(tovf) == bool(jovf) == (fresh[1] is not None)
        assert bool(ts.check_overflow(tstash)) == bool(
            js.check_overflow(jstash)) == (stash[1] is not None)
    np.testing.assert_array_equal(
        tout["b"].numpy(), np.full((4,), 3.0, np.float32))   # 4/2 + 1


def test_grad_accum_defers_scale_update():
    jmodel, jopt = jamp.initialize(JaxMLP(features=(32,)), optax.sgd(0.05),
                                   opt_level="O2", verbosity=0)
    jopt.loss_scaler.scale_window = 2
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.ones((2, 8)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(k1, (16, 8))
    y = jax.random.randint(k2, (16,), 0, 10)

    @jax.jit
    def jgrads(x_in, st):
        def loss_fn(p):
            logits = jmodel.apply(p, x_in).astype(jnp.float32)
            return jamp.scale(optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), st)
        return jax.grad(loss_fn)(jparams)

    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    module = MLP(features=(32,), in_features=8, device="cpu", seed=None)
    module.load_state_dict(mlp_params_from_jax(np_params))
    model, opt = amp.initialize(module, transforms.sgd(0.05),
                                opt_level="O2", verbosity=0)
    opt.loss_scaler.scale_window = 2
    params = model.init()

    def as_port(tree):      # a JAX tree as the port's dotted names
        return {k: v.clone() for k, v in mlp_params_from_jax(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   tree)).items()}

    x_bad = x.at[0, 0].set(jnp.inf)
    for first, second in ((x, x), (x_bad, x), (x, x_bad)):
        jst, tst = jopt.init(jparams), opt.init(params)
        s0 = float(opt.loss_scale(tst))
        jg1 = jgrads(first, jst)
        tg1 = as_port(jg1)
        jg1, jov1, jst = jopt.unscale_grads(jg1, jst, update_scale=False)
        tg1, tov1, tst = opt.unscale_grads(tg1, tst, update_scale=False)
        assert float(opt.loss_scale(tst)) == s0        # not moved
        jg2 = jgrads(second, jst)
        tg2 = as_port(jg2)
        jg, jov2, jst = jopt.unscale_grads(jg2, jst, stashed=jg1,
                                           update_scale=False)
        tg, tov2, tst = opt.unscale_grads(tg2, tst, stashed=tg1,
                                          update_scale=False)
        assert float(opt.loss_scale(tst)) == s0
        _equal_named(tg, jg)
        assert bool(tov1) == bool(jov1) and bool(tov2) == bool(jov2)
        jst = jopt.update_scale(jst, jov1 | jov2)
        tst = opt.update_scale(tst, tov1 | tov2)
        jp2, jst = jopt.apply_gradients(jparams, jg, jst, jov1 | jov2)
        tp2, tst = opt.apply_gradients(params, tg, tst, tov1 | tov2)
        _equal_named(tp2, jp2)
        bad = bool(jov1 | jov2)
        assert bad == (first is x_bad or second is x_bad)
        assert float(opt.loss_scale(tst)) == float(jopt.loss_scale(jst)) \
            == (s0 / 2 if bad else s0)
        assert int(tst.skipped_steps) == int(jst.skipped_steps) == int(bad)
        assert int(tst.applied_steps) == int(jst.applied_steps) \
            == 1 - int(bad)


def _equal_named(port, jax_tree):
    """Port leaves equal the JAX tree's, mapped by name, bit for bit."""
    want = mlp_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jax_tree))
    assert set(port) == set(want)
    for k, v in port.items():     # NaN where the JAX tree has NaN
        np.testing.assert_array_equal(v.detach().float().numpy(),
                                      want[k].numpy(), err_msg=k)


TINY = dict(batch=8, seq_len=32, steps=2, opt_level="O0", device="cpu")


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


def test_bert_grad_accum_equals_the_full_batch():
    cfg = bert.get_config("tiny")
    one = bert.train(cfg, grad_accum=1, **TINY)
    four = bert.train(cfg, grad_accum=4, **TINY)
    assert scale_err(four["losses"], one["losses"]) < 1e-5
    for k in one["params"]:
        assert scale_err(four["params"][k].detach(),
                         one["params"][k].detach()) < 1e-5, k
    assert four["applied_steps"] == 2 and four["loss_scale"] == 1.0


def test_inf_in_one_microbatch_skips_the_step():
    cfg = bert.get_config("tiny")
    model, opt, params, st = bert.build(cfg, opt_level="O2", device="cpu")
    batch = tuple(torch.from_numpy(a) for a in next(bert.batches(cfg, 8,
                                                                 32)))
    calls = []
    unscale = opt.unscale_grads

    def planting(grads, state, loss_id=0, **kw):
        if len(calls) == 2:                       # microbatch 2 of 0-3
            name = "encoder.layer_1.intermediate.weight"
            grads[name][5, 3].fill_(float("inf"))
        calls.append(kw["update_scale"])
        return unscale(grads, state, loss_id, **kw)

    opt.unscale_grads = planting
    snap = ({k: v.detach().clone() for k, v in params.items()},
            pytree.tree_map(torch.clone, st.inner))
    scale0 = float(opt.loss_scale(st))
    params2, st2, loss, _ = bert.train_step(model, opt, params, st, batch,
                                            grad_accum=4)
    assert calls == [False] * 4
    assert all(torch.equal(params2[k], snap[0][k]) for k in params2)
    for a, b in zip(pytree.tree_leaves(st2.inner),
                    pytree.tree_leaves(snap[1])):
        assert torch.equal(a, b)
    assert float(opt.loss_scale(st2)) == scale0 / 2
    assert int(st2.skipped_steps) == 1 and int(st2.applied_steps) == 0
    assert np.isfinite(float(loss))


def test_grad_accum_checks():
    with pytest.raises(SystemExit, match="must divide by --grad-accum 3"):
        bert.check_grad_accum(8, 3)
    with pytest.raises(SystemExit, match="must be >= 1"):
        bert.check_grad_accum(8, 0)
