"""The port's optax twins (``apex_tpu_torch.optimizers.transforms``)
against optax on the same trees and counts.

Updates within 1e-6 relative (float32 sums of the same operands in the
same order; XLA may fuse a multiply-add that PyTorch rounds twice);
schedule values exact at every boundary and in between, and the
schedule's ``count`` equal; the optimizer's whole state held through
amp's overflow skip bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.optimizers import transforms as T

REL = 1e-6


def _trees(seed, n=3):
    rng = np.random.RandomState(seed)
    shapes = {"conv.weight": (4, 3, 3, 3), "bn.weight": (4,),
              "fc.bias": (10,)}
    return [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n)]


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
    assert err <= rel, err


SCHEDULES = {
    "linear": (lambda m: m.linear_schedule(0.1 / 4, 0.1, 4), range(0, 7)),
    "linear_long": (lambda m: m.linear_schedule(1.0, 0.01, 100),
                    (0, 1, 50, 99, 100, 110)),
    "piecewise": (lambda m: m.piecewise_constant_schedule(
        0.1, {3: 0.1, 5: 0.1}), range(0, 8)),
    "join": (lambda m: m.join_schedules(
        [m.linear_schedule(0.025, 0.1, 4),
         m.piecewise_constant_schedule(0.1, {2: 0.1, 6: 0.1})], [4]),
        range(0, 12)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_equal_optax(name):
    make, counts = SCHEDULES[name]
    ref, port = make(optax), make(T)
    for c in counts:
        want = np.float32(ref(jnp.asarray(c, jnp.int32)))
        got = port(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == want, (c, got.item(), float(want))


def _run(ref_tx, port_tx, steps=5, seed=0):
    params = _trees(seed, 1)[0]
    grads = _trees(seed + 1, steps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = ref_tx.init(jp), port_tx.init(tp)
    for g in grads:
        ju, js = ref_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp)
        tu, ts = port_tx.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp)
        for k in params:
            _close(tu[k].numpy(), np.asarray(ju[k]))
        jp = optax.apply_updates(jp, ju)
        tp = T.apply_updates(tp, tu)
        for k in params:
            _close(tp[k].numpy(), np.asarray(jp[k]))
    return js, ts


def test_sgd_momentum_constant_lr():
    _run(optax.sgd(0.1, momentum=0.9), T.sgd(0.1, momentum=0.9))


def test_sgd_without_momentum():
    _run(optax.sgd(0.05), T.sgd(0.05))


def test_chain_decay_sgd_schedule_and_count():
    def tx(m):
        sched = m.join_schedules([m.linear_schedule(0.025, 0.1, 2),
                                  m.piecewise_constant_schedule(
                                      0.1, {2: 0.1})], [2])
        return m.chain(m.add_decayed_weights(1e-4),
                       m.sgd(sched, momentum=0.9))

    js, ts = _run(tx(optax), tx(T))
    assert isinstance(ts[0], T.EmptyState)
    trace, sched = ts[1]
    assert int(sched.count) == int(js[1][1].count) == 5
    assert sched.count.dtype == torch.int32
    for k in trace.trace:
        _close(trace.trace[k].numpy(), np.asarray(js[1][0].trace[k]))


def test_add_decayed_weights_alone():
    _run(optax.add_decayed_weights(0.01), T.add_decayed_weights(0.01))


def test_softmax_cross_entropy_with_integer_labels():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 11).astype(np.float32) * 4
    labels = rng.randint(0, 11, 6).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels))
    got = T.softmax_cross_entropy_with_integer_labels(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def test_amp_optimizer_skip_keeps_params_state_and_count(restore_amp):
    """The wrapper-level skip: an overflowed step leaves every bit of the
    params and of the optax-style state, the schedule's count included;
    the scale halves; the next clean step moves on."""
    module = torch.nn.Linear(4, 3)
    tx = T.chain(T.add_decayed_weights(1e-4),
                 T.sgd(T.linear_schedule(0.01, 0.1, 4), momentum=0.9))
    model, opt = amp.initialize(module, tx, opt_level="O2", verbosity=0)
    params = model.init()
    st = opt.init(params)
    x = torch.randn(8, 4)

    def grads_of(x):
        out = model.apply(params, x).float().square().mean()
        with amp.scale_loss(out, st) as scaled:
            g = torch.autograd.grad(scaled, list(params.values()))
        return dict(zip(params, g))

    params, st = opt.step(params, grads_of(x), st)
    snap = ({k: v.clone() for k, v in params.items()},
            [t.clone() for t in torch.utils._pytree.tree_leaves(st.inner)])
    scale0 = float(opt.loss_scale(st))
    bad = x.clone()
    bad[0, 0] = float("inf")
    params, st = opt.step(params, grads_of(bad), st)
    assert all(torch.equal(params[k], snap[0][k]) for k in params)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(st.inner), snap[1]))
    assert int(st.inner[1][1].count) == 1
    assert float(opt.loss_scale(st)) == scale0 / 2
    assert int(st.skipped_steps) == 1 and int(st.applied_steps) == 1
    assert all(p.requires_grad for p in params.values())
    params, st = opt.step(params, grads_of(x), st)
    assert int(st.inner[1][1].count) == 2
    assert not torch.equal(params["weight"], snap[0]["weight"])
