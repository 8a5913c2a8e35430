"""The port's multi-model, multi-optimizer, multi-loss amp protocol
against ``tests/L0/test_multiple_models_optimizers_losses.py``: its
three tests, each run on the port and on the JAX package from the same
weights (``mlp_params_from_jax``) and data.

Each checks which optimizer skips which step, which scaler halves, and
the params against an fp32 trajectory with the same skips (the JAX
test's bounds, rtol 0.05 and atol 5e-3), and holds the port's params to
the JAX run's, scale-aware: within 1e-5 at O0 (a level the JAX test
does not run, added here for that bound) and within one bf16 step,
2**-8, at O1 and O2.  There the two runs' bf16 arithmetic differs in
one place: XLA reduces a bf16 bias gradient in bf16, PyTorch
accumulates it in fp32, and the two round one bf16 step apart (the
weight gradients agree bit for bit).  Every run uses the dynamic loss
scale, O0's too, so the skip and halving pattern is the JAX test's at
every level.  The functional protocol is the JAX test's: ``amp.scale``
per loss, ``unscale_grads(loss_id)``, ``apply_gradients`` on the ORed
overflow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import flax.linen as nn

from apex_tpu import amp as jamp
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.models import MLP, mlp_params_from_jax
from apex_tpu_torch.optimizers import transforms

D = 8
LR = 0.05
INIT_SCALE = 2.0 ** 16
STEPS = 4
JAX_TOL = {"O0": 1e-5, "O1": 2.0 ** -8, "O2": 2.0 ** -8}


@pytest.fixture(autouse=True)
def _no_leaked_o1():
    """O1's patches are process-global in both packages: remove them and
    the port's policy after every test."""
    saved = _amp_state._amp_state.opt_properties
    yield
    jamp.remove_o1_patches()
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = saved
    _amp_state._amp_state.casts_disabled = False


class Net(nn.Module):
    """The JAX test's regressor."""

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(16)(x)
        x = nn.relu(x)
        return nn.Dense(1)(x)


def _jax_init(seed):
    return jax.tree_util.tree_map(np.asarray, Net().init(
        jax.random.PRNGKey(seed), jnp.ones((1, D))))


def _data():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (np.array(jax.random.normal(k1, (8, D))),
            np.array(jax.random.normal(k2, (8, 1))))


def _bad(x):
    x = x.copy()
    x[0, 0] = np.inf
    return x


def _net(variables):
    m = MLP(features=(16,), num_classes=1, in_features=D, device="cpu",
            seed=None)
    m.load_state_dict(mlp_params_from_jax(variables))
    return m


def _mse(pred, tgt):
    return ((pred.float() - tgt) ** 2).mean()


def _jmse(pred, tgt):
    return jnp.mean((pred.astype(jnp.float32) - tgt) ** 2)


def _grads(loss, tree):
    """d loss / d every leaf of ``tree``; zeros where it does not reach
    (what ``jax.grad`` gives)."""
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return torch.utils._pytree.tree_unflatten(
        [torch.zeros_like(p) if gi is None else gi
         for p, gi in zip(leaves, g)], spec)


def _add(a, b):
    return torch.utils._pytree.tree_map(torch.add, a, b)


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


def _close_to_jax(port, jax_params, opt_level):
    """Every port leaf (``{model: {dotted name: tensor}}``) within
    ``JAX_TOL`` scale-aware of the JAX run's (``{model: flax
    variables}``)."""
    for m, leaves in port.items():
        want = mlp_params_from_jax(jax_params[m])
        for name, t in leaves.items():
            err = scale_err(t.detach().float(), want[name])
            assert err < JAX_TOL[opt_level], (m, name, err)


def _close_to_ref(port, ref):
    for m, leaves in port.items():
        for name, t in leaves.items():
            np.testing.assert_allclose(t.detach().float().numpy(),
                                       ref[m][name].numpy(), rtol=0.05,
                                       atol=5e-3)


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2"])
@pytest.mark.parametrize("inject", [None, (1, 0), (2, 1)])
def test_2models_2losses_1optimizer(opt_level, inject):
    x, tgt = _data()
    init = {"A": _jax_init(1), "B": _jax_init(2)}
    # the JAX test's run
    (jA, jB), jopt = jamp.initialize([Net(), Net()], optax.sgd(LR),
                                     opt_level=opt_level, num_losses=2,
                                     loss_scale="dynamic", verbosity=0)
    jp = init
    js = jopt.init(jp)

    @jax.jit
    def jstep(params, st, x0, x1):
        g0 = jax.grad(lambda p: jamp.scale(
            _jmse(jA.apply(p["A"], x0), tgt), st, loss_id=0))(params)
        g1 = jax.grad(lambda p: jamp.scale(
            _jmse(jB.apply(p["B"], x1), tgt), st, loss_id=1))(params)
        g0, ov0, st = jopt.unscale_grads(g0, st, 0)
        g1, ov1, st = jopt.unscale_grads(g1, st, 1)
        merged = jax.tree_util.tree_map(lambda a, b: a + b, g0, g1)
        return jopt.apply_gradients(params, merged, st, ov0 | ov1)

    # the port's
    (mA, mB), opt = amp.initialize([_net(init["A"]), _net(init["B"])],
                                   transforms.sgd(LR), opt_level=opt_level,
                                   num_losses=2, loss_scale="dynamic",
                                   verbosity=0)
    params = {"A": mA.init(), "B": mB.init()}
    st = opt.init(params)
    tt = torch.from_numpy(tgt)
    ref = {m: {k: v.detach().float().clone() for k, v in p.items()}
           for m, p in params.items()}

    for i in range(STEPS):
        x0 = x1 = x
        if inject is not None and i == inject[0]:
            x0, x1 = (_bad(x), x) if inject[1] == 0 else (x, _bad(x))
        else:    # the fp32 trajectory takes the steps the runs take
            r = {m: {k: v.requires_grad_() for k, v in p.items()}
                 for m, p in ref.items()}
            g0 = _grads(_mse(torch.func.functional_call(
                mA.unwrapped, r["A"], (torch.from_numpy(x),)), tt), r)
            g1 = _grads(_mse(torch.func.functional_call(
                mB.unwrapped, r["B"], (torch.from_numpy(x),)), tt), r)
            ref = {m: {k: (v - LR * (g0[m][k] + g1[m][k])).detach()
                       for k, v in p.items()} for m, p in r.items()}
        jp, js = jstep(jp, js, x0, x1)
        t0, t1 = torch.from_numpy(x0), torch.from_numpy(x1)
        g0 = _grads(amp.scale(_mse(mA.apply(params["A"], t0), tt), st,
                              loss_id=0), params)
        g1 = _grads(amp.scale(_mse(mB.apply(params["B"], t1), tt), st,
                              loss_id=1), params)
        g0, ov0, st = opt.unscale_grads(g0, st, 0)
        g1, ov1, st = opt.unscale_grads(g1, st, 1)
        params, st = opt.apply_gradients(params, _add(g0, g1), st,
                                         ov0 | ov1)

    skipped = 0 if inject is None else 1
    for s in (st, js):
        assert int(s.skipped_steps) == skipped
        assert int(s.applied_steps) == STEPS - skipped
    scales = [float(s.loss_scale) for s in st.loss_scalers]
    assert scales == [float(s.loss_scale) for s in js.loss_scalers]
    if inject is None:
        assert scales == [INIT_SCALE, INIT_SCALE]
    else:
        assert scales[inject[1]] == INIT_SCALE / 2
        assert scales[1 - inject[1]] == INIT_SCALE
    _close_to_ref(params, ref)
    _close_to_jax(params, jax.tree_util.tree_map(np.asarray, jp), opt_level)


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2"])
def test_2models_2losses_2optimizers_independent_skip(opt_level):
    """An inf in loss 0 skips only optimizer 0's step and halves only its
    scaler; optimizer 1 steps."""
    x, tgt = _data()
    iA, iB = _jax_init(1), _jax_init(2)
    (jA, jB), (joA, joB) = jamp.initialize(
        [Net(), Net()], [optax.sgd(LR), optax.sgd(LR)], opt_level=opt_level,
        loss_scale="dynamic", verbosity=0)
    jpA, jpB = iA, iB
    jsA, jsB = joA.init(jpA), joB.init(jpB)

    @jax.jit
    def jstep(pA, pB, sA, sB, x0, x1):
        gA = jax.grad(lambda p: jamp.scale(_jmse(jA.apply(p, x0), tgt),
                                           sA))(pA)
        gB = jax.grad(lambda p: jamp.scale(_jmse(jB.apply(p, x1), tgt),
                                           sB))(pB)
        gA, ovA, sA2 = joA.unscale_grads(gA, sA)
        gB, ovB, sB2 = joB.unscale_grads(gB, sB)
        pA2, sA2 = joA.apply_gradients(pA, gA, sA2, ovA)
        pB2, sB2 = joB.apply_gradients(pB, gB, sB2, ovB)
        return pA2, pB2, sA2, sB2

    (mA, mB), (oA, oB) = amp.initialize(
        [_net(iA), _net(iB)], [transforms.sgd(LR), transforms.sgd(LR)],
        opt_level=opt_level, loss_scale="dynamic", verbosity=0)
    pA, pB = mA.init(), mB.init()
    sA, sB = oA.init(pA), oB.init(pB)
    tt = torch.from_numpy(tgt)
    for i in range(3):
        x0 = _bad(x) if i == 1 else x
        jpA, jpB, jsA, jsB = jstep(jpA, jpB, jsA, jsB, x0, x)
        gA = _grads(amp.scale(_mse(mA.apply(pA, torch.from_numpy(x0)), tt),
                              sA), pA)
        gB = _grads(amp.scale(_mse(mB.apply(pB, torch.from_numpy(x)), tt),
                              sB), pB)
        gA, ovA, sA = oA.unscale_grads(gA, sA)
        gB, ovB, sB = oB.unscale_grads(gB, sB)
        pA, sA = oA.apply_gradients(pA, gA, sA, ovA)
        pB, sB = oB.apply_gradients(pB, gB, sB, ovB)

    for s in (sA, jsA):
        assert int(s.skipped_steps) == 1 and int(s.applied_steps) == 2
        assert float(s.loss_scalers[0].loss_scale) == INIT_SCALE / 2
    for s in (sB, jsB):
        assert int(s.skipped_steps) == 0 and int(s.applied_steps) == 3
        assert float(s.loss_scalers[0].loss_scale) == INIT_SCALE
    _close_to_jax({"A": pA, "B": pB}, {"A": jax.tree_util.tree_map(
        np.asarray, jpA), "B": jax.tree_util.tree_map(np.asarray, jpB)},
        opt_level)


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2"])
def test_3models_2losses_2optimizers_shared_model_coupling(opt_level):
    """Model C is in both losses and belongs to optimizer 0: an inf in
    loss 1 poisons C's gradient too, so both optimizers skip, but only
    scaler slot 1 halves."""
    x, tgt = _data()
    iA, iB, iC = _jax_init(1), _jax_init(2), _jax_init(3)
    (jA, jB, jC), (jo0, jo1) = jamp.initialize(
        [Net(), Net(), Net()], [optax.sgd(LR), optax.sgd(LR)],
        opt_level=opt_level, num_losses=2, loss_scale="dynamic",
        verbosity=0)
    jp0, jp1 = {"A": iA, "C": iC}, {"B": iB}
    js0, js1 = jo0.init(jp0), jo1.init(jp1)

    @jax.jit
    def jstep(p0, p1, s0, s1, x0, x1):
        def loss0(q0):
            out = jA.apply(q0["A"], x0) + jC.apply(q0["C"], x0)
            return jamp.scale(_jmse(out, tgt), s0, loss_id=0)

        def loss1(q0, q1):
            out = jB.apply(q1["B"], x1) + jC.apply(q0["C"], x1)
            return jamp.scale(_jmse(out, tgt), s0, loss_id=1)

        g0_from0 = jax.grad(loss0)(p0)
        g0_from1, g1 = jax.grad(loss1, argnums=(0, 1))(p0, p1)
        u0a, ov0, s0b = jo0.unscale_grads(g0_from0, s0, 0)
        u0b, ov1, s0b = jo0.unscale_grads(g0_from1, s0b, 1)
        g0 = jax.tree_util.tree_map(lambda a, b: a + b, u0a, u0b)
        u1, ov1b, s1b = jo1.unscale_grads(g1, s1, 1)
        p0n, s0b = jo0.apply_gradients(p0, g0, s0b, ov0 | ov1)
        p1n, s1b = jo1.apply_gradients(p1, u1, s1b, ov1b)
        return p0n, p1n, s0b, s1b

    (mA, mB, mC), (o0, o1) = amp.initialize(
        [_net(iA), _net(iB), _net(iC)],
        [transforms.sgd(LR), transforms.sgd(LR)], opt_level=opt_level,
        num_losses=2, loss_scale="dynamic", verbosity=0)
    p0, p1 = {"A": mA.init(), "C": mC.init()}, {"B": mB.init()}
    s0, s1 = o0.init(p0), o1.init(p1)
    tt = torch.from_numpy(tgt)
    for i in range(3):
        x1 = _bad(x) if i == 1 else x
        jp0, jp1, js0, js1 = jstep(jp0, jp1, js0, js1, x, x1)
        t0, t1 = torch.from_numpy(x), torch.from_numpy(x1)
        l0 = amp.scale(_mse(mA.apply(p0["A"], t0) + mC.apply(p0["C"], t0),
                            tt), s0, loss_id=0)
        g0_from0 = _grads(l0, p0)
        l1 = amp.scale(_mse(mB.apply(p1["B"], t1) + mC.apply(p0["C"], t1),
                            tt), s0, loss_id=1)
        g0_from1, g1 = _grads(l1, (p0, p1))
        u0a, ov0, s0b = o0.unscale_grads(g0_from0, s0, 0)
        u0b, ov1, s0b = o0.unscale_grads(g0_from1, s0b, 1)
        u1, ov1b, s1b = o1.unscale_grads(g1, s1, 1)
        p0, s0 = o0.apply_gradients(p0, _add(u0a, u0b), s0b, ov0 | ov1)
        p1, s1 = o1.apply_gradients(p1, u1, s1b, ov1b)

    for s in (s0, s1, js0, js1):
        assert int(s.skipped_steps) == 1 and int(s.applied_steps) == 2
    for a, b in ((s0, js0), (s1, js1)):
        got = [float(t.loss_scale) for t in a.loss_scalers]
        assert got == [float(t.loss_scale) for t in b.loss_scalers]
    assert float(s0.loss_scalers[0].loss_scale) == INIT_SCALE
    assert float(s0.loss_scalers[1].loss_scale) == INIT_SCALE / 2
    assert float(s1.loss_scalers[1].loss_scale) == INIT_SCALE / 2
    assert float(s1.loss_scalers[0].loss_scale) == INIT_SCALE
    _close_to_jax({**p0, **p1}, {k: jax.tree_util.tree_map(np.asarray, v)
                                 for k, v in {**jp0, **jp1}.items()},
                  opt_level)
