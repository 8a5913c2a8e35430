"""The port's LARC (``apex_tpu_torch.parallel.LARC``) against the JAX
``LARC`` on the same trees: clip and scale modes, zero norms, per-group
overrides, over ``sgd`` (the optax twin against optax) within 1e-6
relative; and the fused overflow skip forwarded to FusedAdam (its plain
version on the CPU) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.parallel import LARC as JLARC
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers import transforms as T
from apex_tpu_torch.parallel import LARC

REL = 1e-6


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"conv": {"weight": rng.randn(4, 3, 3).astype(np.float32)},
            "fc": {"bias": rng.randn(5).astype(np.float32),
                   "weight": rng.randn(5, 4).astype(np.float32)}}


def _leaves(tree):
    return {"conv.weight": tree["conv"]["weight"],
            "fc.bias": tree["fc"]["bias"],
            "fc.weight": tree["fc"]["weight"]}


def _compare(jax_larc, port_larc, params, grads):
    jp = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in params.items()}
    jg = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
          for k, v in grads.items()}
    tp = {k: torch.from_numpy(v) for k, v in _leaves(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _leaves(grads).items()}
    ju, _ = jax_larc.update(jg, jax_larc.init(jp), jp)
    tu, _ = port_larc.update(tg, port_larc.init(tp), tp)
    for k, want in _leaves(ju).items():
        got = tu[k].numpy()
        want = np.asarray(want)
        err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)
        assert err <= REL, (k, err)


@pytest.mark.parametrize("clip", [True, False])
def test_modes_match_jax(clip):
    params, grads = _tree(0), _tree(1)
    grads["fc"]["bias"] *= 1e-3          # a large local rate: clip bites
    kw = dict(trust_coefficient=0.02, clip=clip, weight_decay=0.01,
              base_lr=0.1)
    _compare(JLARC(optax.sgd(0.1, momentum=0.9), **kw),
             LARC(T.sgd(0.1, momentum=0.9), **kw), params, grads)


def test_zero_norms_pass_the_gradient():
    params, grads = _tree(0), _tree(1)
    params["fc"]["bias"] = np.zeros(5, np.float32)
    grads["conv"]["weight"] = np.zeros((4, 3, 3), np.float32)
    kw = dict(base_lr=0.1, weight_decay=0.01)
    _compare(JLARC(optax.sgd(0.1), **kw), LARC(T.sgd(0.1), **kw), params,
             grads)


def test_param_group_overrides_match_jax():
    """A group matching ``bias`` (the JAX key string ``['fc']['bias']``
    and the port's ``fc.bias`` both contain it) with its own trust
    coefficient and no decay."""
    groups = [{"match": "bias", "trust_coefficient": 0.5,
               "weight_decay": 0.0}]
    kw = dict(base_lr=0.1, weight_decay=0.01, param_groups=groups)
    _compare(JLARC(optax.sgd(0.1), **kw), LARC(T.sgd(0.1), **kw), _tree(2),
             _tree(3))


def test_clip_without_base_lr_raises():
    class NoLR:
        def init(self, p):
            return None

    with pytest.raises(ValueError, match="base_lr"):
        LARC(NoLR())


def test_forwards_the_fused_skip_to_fused_adam():
    params = {"w": torch.ones((4, 4))}
    bad = {"w": torch.full((4, 4), float("inf"))}
    larc = LARC(FusedAdam(lr=1e-2))
    assert larc.supports_fused_skip and larc.base_lr == 1e-2
    state = larc.init(params)
    p, s = larc.step(params, bad, state, skip=torch.tensor(True))
    assert torch.equal(p["w"], torch.ones((4, 4)))
    assert int(s.step) == 0
    p, s = larc.step(p, {"w": torch.full((4, 4), 0.1)}, s)
    assert int(s.step) == 1 and not torch.equal(p["w"], torch.ones((4, 4)))
    sgd = LARC(T.sgd(1e-2), base_lr=1e-2)
    assert not sgd.supports_fused_skip
    with pytest.raises(TypeError, match="skip"):
        sgd.step(params, bad, sgd.init(params), skip=torch.tensor(True))
