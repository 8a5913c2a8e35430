"""apex_tpu_torch FusedAdam against apex_tpu's Pallas FusedAdam (B1).

The JAX side runs ``FusedAdam(use_pallas=True)`` in interpret mode off
the TPU, as ``tests/L0/test_fused_adam.py`` does; the port's CPU path is
the kernel's plain version, and no CUDA kernel is launched.  Parameters
and gradients come from ``numpy.random.RandomState``; the flat buffers
are laid out in different leaf orders (flax sorts dict keys), so the
comparison is per parameter after unflattening.  Parity is <= 1e-5
scale-aware per parameter over 3 steps (``pow`` in the bias correction
may differ by an ulp between XLA and PyTorch); the skipped step is
bitwise on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.optimizers import FusedAdam

torch.set_num_threads(1)

TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(37, 13).astype(np.float32),
            "b": rng.randn(1000).astype(np.float32),
            "s": np.asarray(rng.randn(), np.float32)}


def _both(np_tree):
    return ({k: jnp.asarray(v) for k, v in np_tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in np_tree.items()})


@pytest.mark.parametrize("eps_inside", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_three_steps_match_jax_kernel(eps_inside, wd):
    jp, pp = _both(_params())
    kw = dict(lr=1e-2, eps_inside_sqrt=eps_inside, weight_decay=wd)
    jopt = JaxFusedAdam(use_pallas=True, **kw)
    opt = FusedAdam(**kw)
    jst, st = jopt.init(jp), opt.init(pp)
    rng = np.random.RandomState(1)
    before = launch_counts()
    for step in range(3):
        jg, pg = _both({k: np.asarray(rng.randn(*np.shape(v)), np.float32)
                        for k, v in _params().items()})
        scale = 1.0 if step < 2 else 4.0
        jp, jst = jopt.step(jp, jg, jst, scale=scale)
        pp, st = opt.step(pp, pg, st, scale=scale)
    assert launch_counts() == before, "the CPU path launched a kernel"
    assert int(st.step) == int(jst.step) == 3
    for k in jp:
        assert pp[k].dtype == torch.float32
        assert pp[k].shape == tuple(jp[k].shape)
        assert rel_err(pp[k].detach().numpy(), jp[k]) <= TOL, k
    # the returned params are views of the flat master buffer
    assert pp["w"].data_ptr() == st.p.data_ptr() + 4 * st.spec.offsets[0]
    assert st.p.numel() % 128 == 0 and torch.all(st.p[st.spec.total:] == 0)


def test_skipped_step_is_bitwise_a_no_op_in_both():
    jp, pp = _both(_params(2))
    jopt, opt = JaxFusedAdam(lr=1e-2, use_pallas=True), FusedAdam(lr=1e-2)
    jst, st = jopt.init(jp), opt.init(pp)
    rng = np.random.RandomState(3)
    grads = {k: np.asarray(rng.randn(*np.shape(v)), np.float32)
             for k, v in _params().items()}
    jp, jst = jopt.step(jp, _both(grads)[0], jst)
    pp, st = opt.step(pp, _both(grads)[1], st)
    grads["b"][10] = np.nan
    grads["w"][0, 0] = np.inf
    jg, pg = _both(grads)
    snap = {k: v.detach().clone() for k, v in pp.items()}
    m, v, step = st.m.clone(), st.v.clone(), st.step.clone()
    jsnap = (dict(jp), jst.m, jst.v, jst.step)
    jp, jst = jopt.step(jp, jg, jst, skip=jnp.asarray(True))
    pp, st = opt.step(pp, pg, st, skip=torch.tensor(True))
    for k in pp:
        assert torch.equal(pp[k].detach(), snap[k])
        np.testing.assert_array_equal(np.asarray(jp[k]),
                                      np.asarray(jsnap[0][k]))
    assert torch.equal(st.m, m) and torch.equal(st.v, v)
    assert torch.equal(st.step, step) and int(step) == 1
    np.testing.assert_array_equal(np.asarray(jst.m), np.asarray(jsnap[1]))
    np.testing.assert_array_equal(np.asarray(jst.v), np.asarray(jsnap[2]))
    assert int(jst.step) == int(jsnap[3]) == 1


def test_first_step_skipped_then_taken_matches_jax():
    """A skip at step 0 leaves t = 0 (clamped to 1 in the bias
    correction); the next step is then Adam's first."""
    jp, pp = _both(_params(4))
    jopt, opt = JaxFusedAdam(lr=1e-3, use_pallas=True), FusedAdam(lr=1e-3)
    jst, st = jopt.init(jp), opt.init(pp)
    jg, pg = _both({k: np.full(np.shape(v), 0.5, np.float32)
                    for k, v in _params().items()})
    jp, jst = jopt.step(jp, jg, jst, skip=True)
    pp, st = opt.step(pp, pg, st, skip=True)
    jp, jst = jopt.step(jp, jg, jst, skip=False)
    pp, st = opt.step(pp, pg, st, skip=False)
    assert int(st.step) == int(jst.step) == 1
    for k in jp:
        assert rel_err(pp[k].detach().numpy(), jp[k]) <= TOL


def test_bias_correction_off_and_shape_errors():
    jp, pp = _both(_params(5))
    jopt = JaxFusedAdam(lr=1e-2, bias_correction=False, use_pallas=True)
    opt = FusedAdam(lr=1e-2, bias_correction=False)
    jst, st = jopt.init(jp), opt.init(pp)
    jg, pg = _both({k: np.ones(np.shape(v), np.float32)
                    for k, v in _params().items()})
    jp, jst = jopt.step(jp, jg, jst)
    pp, st = opt.step(pp, pg, st)
    for k in jp:
        assert rel_err(pp[k].detach().numpy(), jp[k]) <= TOL
    with pytest.raises(ValueError):
        opt.step(pp, {"w": pg["w"]}, st)
