"""apex_tpu_torch.amp against apex_tpu.amp.

The option tables, the dynamic loss scaler and the model-side cast
policy are host logic copied from the JAX package; these tests hold the
copies to it: the O0/O2/O3 tables option by option, a scripted overflow
sequence step by step (scale, unskipped count and overflow flag exactly
equal), and the canonical and compute dtype of every GPT parameter at
the tiny configuration of ``examples/gpt/main_amp.py``, path by path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB

torch.set_num_threads(1)

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _no_leaked_o1():
    """O1 installs both packages' process-global op policies: remove them
    and reset the port's amp state after every test."""
    yield
    jamp.remove_o1_patches()
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = None
    _amp_state._amp_state.casts_disabled = False


def _dtype_name(x):
    if isinstance(x, torch.dtype):
        return str(x).split(".")[1]
    if x is None or isinstance(x, (bool, str, float, int)):
        return x
    return jnp.dtype(x).name


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_tables_match_jax(level):
    got = amp.opt_levels[level](amp.Properties()).options
    want = jamp.opt_levels[level](jamp.Properties()).options
    assert list(got) == list(want)
    assert {k: _dtype_name(v) for k, v in got.items()} == \
        {k: _dtype_name(v) for k, v in want.items()}


def test_property_validation_matches_jax():
    for props, err in ((amp.Properties(), amp.AmpOptimizationError),
                       (jamp.Properties(), jamp.AmpOptimizationError)):
        amp_level = props.__class__.__module__.startswith("apex_tpu_torch")
        (amp if amp_level else jamp).opt_levels["O2"](props)
        props.keep_batchnorm_fp32 = "False"
        assert props.keep_batchnorm_fp32 is False
        props.loss_scale = 128
        assert props.loss_scale == 128.0 and isinstance(props.loss_scale,
                                                        float)
        props.cast_model_type = "fp16"
        assert _dtype_name(props.cast_model_type) == "float16"
        assert props.patch_torch_functions is False
        with pytest.raises(err):
            props.keep_batchnorm_fp32 = "yes"
        with pytest.raises(err):
            props.cast_model_type = "float8"


# overflow pattern: clean steps grow the scale every window, overflows
# halve it down to the min clamp, long clean runs grow it to the max
SCRIPT = [False, False, False, True, False, True, True, True, True,
          False] + [False] * 12 + [True, False, False, False]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale_window=3, min_loss_scale=2.0 ** 13, max_loss_scale=2.0 ** 17),
    dict(loss_scale=64.0),
])
def test_scaler_trajectory_equals_jax(kw):
    scaler, jscaler = amp.LossScaler(**kw), jamp.LossScaler(**kw)
    st, jst = scaler.init(device="cpu"), jscaler.init()
    assert st.loss_scale.dtype == torch.float32
    assert st.unskipped.dtype == torch.int32
    assert st.overflow.dtype == torch.bool
    for overflow in SCRIPT:
        st = scaler.update(st, torch.tensor(overflow))
        jst = jscaler.update(jst, jnp.asarray(overflow))
        assert float(st.loss_scale) == float(jst.loss_scale)
        assert int(st.unskipped) == int(jst.unskipped)
        assert bool(st.overflow) == bool(jst.overflow)


def test_scaler_state_lies_on_the_card_unless_asked():
    """``LossScaler.init`` defaults to the card like every entry point
    of the port: without CUDA it raises unless the CPU is asked for."""
    scaler = amp.LossScaler()
    assert scaler.init(device="cpu").loss_scale.device.type == "cpu"
    if torch.cuda.is_available():
        assert scaler.init().loss_scale.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaler.init()


def _jax_names(tree, prefix=()):
    """flax param paths -> the port's parameter names."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_jax_names(v, path))
            continue
        parts = []
        for p in path:
            if p.startswith("block_"):
                parts += ["blocks", p[len("block_"):]]
            else:
                parts.append({"embedding": "weight",
                              "kernel": "weight"}.get(p, p))
        out[".".join(parts)] = v
    return out


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_gpt_param_and_compute_dtypes_match_jax(level):
    jmodel = jamp.initialize(jax_models.GPTLMHeadModel(
        jax_models.GPTConfig(**TINY)), opt_level=level, verbosity=0)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.ones((1, 8), jnp.int32))
    jcompute = jmodel.compute_variables(jparams)
    model = amp.initialize(GPTLMHeadModel(GPTConfig(**TINY), device="cpu"),
                           opt_level=level, verbosity=0)
    params = model.init()
    compute = model.compute_variables(params)
    want_c = _jax_names(jparams["params"])
    want_x = _jax_names(jcompute["params"])
    assert set(params) == set(want_c)
    for name, p in params.items():
        assert _dtype_name(p.dtype) == jnp.dtype(want_c[name].dtype).name, \
            name
        assert _dtype_name(compute[name].dtype) == \
            jnp.dtype(want_x[name].dtype).name, name
        assert p.requires_grad and p.is_leaf
    ids = torch.randint(0, TINY["vocab_size"], (2, 16))
    logits = model.apply(params, ids)
    assert logits.dtype == torch.float32 and logits.shape == (2, 16, 997)


def test_o1_is_refused():
    """O1 is ported now: ``initialize`` takes it (and its default opt
    level is O1), installs the op policy, and refuses only unknown opt
    levels."""
    m = GPTLMHeadModel(GPTConfig(**TINY), device="cpu")
    model = amp.initialize(m, opt_level="O1", verbosity=0)
    assert model._properties.opt_level == "O1" and model._properties.cast_ops
    assert hasattr(torch.softmax, "__amp_original__")
    assert amp.initialize(m, verbosity=0)._properties.opt_level == "O1"
    with pytest.raises(RuntimeError, match="optimization level"):
        amp.initialize(m, opt_level="O4", verbosity=0)


def test_initialize_prints_the_reference_option_report(capsys):
    m = GPTLMHeadModel(GPTConfig(**TINY), device="cpu")
    amp.initialize(m, opt_level="O2", loss_scale=128.0)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Selected optimization level O2"
    assert "Processing user overrides (additional kwargs that are not " \
        "None)..." in lines
    assert lines[-1].split() == ["loss_scale", ":", "128.0"]


def test_amp_step_skips_on_overflow_and_halves_the_scale():
    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(5, 3).astype(np.float32)),
              "b": torch.from_numpy(rng.randn(7).astype(np.float32))}
    model_opt = amp.initialize(GPTLMHeadModel(GPTConfig(**TINY),
                                              device="cpu"),
                               FusedAdam(lr=1e-2), opt_level="O2",
                               verbosity=0)
    opt = model_opt[1]
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    params, state = opt.step(params, grads, state)       # a clean step
    before = {k: v.clone() for k, v in params.items()}
    inner = state.inner
    m0, v0, step0 = inner.m.clone(), inner.v.clone(), inner.step.clone()
    grads["b"][3] = float("inf")
    params, state = opt.step(params, grads, state)
    for k in params:
        assert torch.equal(params[k], before[k])
    assert torch.equal(state.inner.m, m0) and torch.equal(state.inner.v, v0)
    assert torch.equal(state.inner.step, step0)
    assert float(opt.loss_scale(state)) == 2.0 ** 15
    assert int(state.skipped_steps) == 1 and int(state.applied_steps) == 1
    with amp.scale_loss(torch.tensor(2.0, dtype=torch.bfloat16),
                        state) as scaled:
        assert scaled.dtype == torch.float32 and float(scaled) == 2.0 ** 16


def test_amp_optimizer_wraps_fused_lamb_tree_state():
    """``AmpOptimizer.init`` takes its device from the inner state's step
    counter, so an optimizer whose moments are trees (FusedLAMB) is
    wrapped as FusedAdam's flat buffers are; the overflow skip keeps
    every bit of its state."""
    rng = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rng.randn(5, 3).astype(np.float32)),
              "w_ln.bias": torch.from_numpy(rng.randn(7).astype(np.float32))}
    opt = amp.AmpOptimizer(FusedLAMB(lr=1e-2), amp.LossScaler("dynamic"))
    state = opt.init(params)
    assert state.loss_scalers[0].loss_scale.device == state.inner.step.device
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    params, state = opt.step(params, grads, state)       # a clean step
    snap = ({k: v.clone() for k, v in params.items()},
            {k: v.clone() for k, v in state.inner.m.items()},
            {k: v.clone() for k, v in state.inner.v.items()},
            state.inner.step.clone())
    grads["w"][1, 2] = float("inf")
    params, state = opt.step(params, grads, state)
    for k in params:
        assert torch.equal(params[k], snap[0][k])
        assert torch.equal(state.inner.m[k], snap[1][k])
        assert torch.equal(state.inner.v[k], snap[2][k])
    assert torch.equal(state.inner.step, snap[3])
    assert float(opt.loss_scale(state)) == 2.0 ** 15
    assert int(state.skipped_steps) == 1 and int(state.applied_steps) == 1
