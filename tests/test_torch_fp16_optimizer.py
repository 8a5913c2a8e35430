"""The cut-down FP16_Optimizer in apex_tpu_torch against apex_tpu's.

``tests/L0/test_fused_adam.py::test_fp16_optimizer_protocol``'s protocol
on both packages from the same bf16 params and grads (numpy-seeded):
half params in, a flat fp32 master (padded to the inner FusedAdam's
``pad_to``), the dynamic scale at 2^16, a step at that scale, then an
overflowed step that keeps every bit and halves the scale.  FusedAdam
runs its ``jnp`` path on the JAX side and its plain version here.
Tolerances: the master and the grad norm within 1e-6 scale-aware (the
norm's sum runs in another order); the half params equal after the
cast but where the two masters round to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FP16_Optimizer as JaxFP16Optimizer
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.optimizers import FP16_Optimizer, FusedAdam, FusedLAMB

torch.set_num_threads(1)

TOL = 1e-6


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _half(seed):
    rng = np.random.RandomState(seed)
    return {"b": rng.randn(8).astype(np.float32),
            "w": rng.randn(8, 8).astype(np.float32)}


def _both_bf16(tree):
    return ({k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()).to(torch.bfloat16)
             for k, v in tree.items()})


def test_protocol_matches_jax():
    jopt = JaxFP16Optimizer(JaxFusedAdam(lr=0.1, use_pallas=False),
                            dynamic_loss_scale=True)
    opt = FP16_Optimizer(FusedAdam(lr=0.1), dynamic_loss_scale=True)
    jhalf, half = _both_bf16(_half(0))
    jst, st = jopt.init(jhalf), opt.init(half)
    assert st.master.dtype == torch.float32
    assert st.master.shape == tuple(jst.master.shape) == (128,)
    scale0 = float(opt.loss_scale(st))
    assert scale0 == float(jopt.loss_scale(jst)) == 2.0 ** 16

    grads = {k: v * scale0 for k, v in _half(1).items()}
    jg, tg = _both_bf16(grads)
    assert rel_err(opt.compute_grad_norm(tg, st),
                   jopt.compute_grad_norm(jg, jst)) <= TOL
    jnew, jst = jopt.step(jhalf, jg, jst)
    new, st = opt.step(half, tg, st)
    assert new["w"].dtype == torch.bfloat16
    assert not torch.equal(new["w"], half["w"])
    assert rel_err(st.master, jst.master) <= TOL
    for k in new:
        np.testing.assert_allclose(new[k].float().numpy(),
                                   np.asarray(jnew[k], np.float32),
                                   rtol=2 ** -7)

    bad = dict(tg)
    bad["w"] = tg["w"].clone()
    bad["w"][0, 0] = float("inf")
    jbad = dict(jg, w=jg["w"].at[0, 0].set(jnp.inf))
    assert float(opt.compute_grad_norm(bad, st)) == -1.0
    assert float(jopt.compute_grad_norm(jbad, jst)) == -1.0
    master, m, v = st.master.clone(), st.inner.m.clone(), st.inner.v.clone()
    frozen, st = opt.step(new, bad, st)
    jfrozen, jst = jopt.step(jnew, jbad, jst)
    for k in new:
        assert torch.equal(frozen[k], new[k])
    assert torch.equal(st.master, master)
    assert torch.equal(st.inner.m, m) and torch.equal(st.inner.v, v)
    assert int(st.inner.step) == int(jst.inner.step) == 1
    assert float(opt.loss_scale(st)) == float(jopt.loss_scale(jst)) \
        == scale0 / 2


def test_static_scale_and_args():
    opt = FP16_Optimizer(FusedAdam(lr=0.1), static_loss_scale=128.0)
    jopt = JaxFP16Optimizer(JaxFusedAdam(lr=0.1, use_pallas=False),
                            static_loss_scale=128.0)
    jhalf, half = _both_bf16(_half(2))
    st, jst = opt.init(half), jopt.init(jhalf)
    jg, tg = _both_bf16({k: v * 128.0 for k, v in _half(3).items()})
    for _ in range(2):
        half, st = opt.step(half, tg, st)
        jhalf, jst = jopt.step(jhalf, jg, jst)
    assert rel_err(st.master, jst.master) <= TOL
    assert float(opt.loss_scale(st)) == 128.0
    assert float(opt.scale_loss(torch.tensor(2.0), st)) == 256.0
    dyn = FP16_Optimizer(FusedAdam(), dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 8.0})
    assert float(dyn.loss_scale(dyn.init(half))) == 8.0
    assert dyn.loss_scaler.scale_window == 1000


def test_refuses_other_optimizers():
    with pytest.raises(TypeError, match="FusedAdam only"):
        FP16_Optimizer(FusedLAMB())
    with pytest.raises(ValueError, match="flat layout"):
        FP16_Optimizer(FusedAdam(layout="tree"))
