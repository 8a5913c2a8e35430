"""amp O1 of the port (``apex_tpu_torch.amp``: the op-level cast policy
patched onto the torch namespaces, the policy tables, the decorators and
the legacy handles) against ``apex_tpu.amp``.

The twins of ``tests/L0/test_o1_enforcement.py`` and
``tests/L0/test_amp_lists.py`` run through both packages; dtypes must be
equal, values within 1e-2 scale-aware where one model runs in bf16 on
both sides (two frameworks' bf16 products round apart), and exactly
equal where the arithmetic is the same (the legacy handle's step, the
plain attention with and without the policy).

Both packages' patches are process-global and the tier-1 run shares a
worker between files, so ``_no_leaked_o1`` removes both and resets the
port's amp state after every test (the shared conftest resets only the
JAX package's state); ``test_o1_left_active_on_purpose`` and the test
after it check that it does.
"""

import importlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu.amp import lists as jlists
from apex_tpu.amp import patch as jpatch
from apex_tpu.models import resnet as jr
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp import lists, patch
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.models import MLP
from apex_tpu_torch.models.gpt import causal_dot_product_attention
from apex_tpu_torch.ops import cached_attention
from apex_tpu_torch.optimizers import transforms

torch.set_num_threads(1)

fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

PROBES, JPROBES = {}, {}


@pytest.fixture(autouse=True)
def _no_leaked_o1():
    PROBES.clear()
    JPROBES.clear()
    yield
    jamp.remove_o1_patches()
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = None
    _amp_state._amp_state.casts_disabled = False


def scale_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _dt(x):
    return str(x.dtype).rsplit(".", 1)[-1]


class UserModel(nn.Module):
    """The twin of the JAX test's user model, written with no amp
    awareness: torch.softmax, exp, log and mean on whatever flows."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(8, 16)

    def forward(self, x):
        h = self.Dense_0(x)
        PROBES["dense_out"] = _dt(h)
        s = torch.softmax(h, dim=-1)
        PROBES["softmax_out"] = _dt(s)
        e = torch.exp(h * 1e-2)
        PROBES["exp_out"] = _dt(e)
        lg = torch.log(torch.abs(h) + 1.0)
        PROBES["log_out"] = _dt(lg)
        m = torch.mean(h, dim=-1)
        PROBES["mean_out"] = _dt(m)
        return (s + e + lg).sum(dim=-1) + m


class JaxUserModel(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = fnn.Dense(16)(x)
        JPROBES["dense_out"] = _dt(h)
        s = jax.nn.softmax(h)
        JPROBES["softmax_out"] = _dt(s)
        e = jnp.exp(h * 1e-2)
        JPROBES["exp_out"] = _dt(e)
        lg = jnp.log(jnp.abs(h) + 1.0)
        JPROBES["log_out"] = _dt(lg)
        m = jnp.mean(h, axis=-1)
        JPROBES["mean_out"] = _dt(m)
        return (s + e + lg).sum(axis=-1) + m


def init_o1(module=None):
    return amp.initialize(module if module is not None else UserModel(),
                          transforms.sgd(0.1), opt_level="O1", verbosity=0)


def _user_weights():
    rng = np.random.RandomState(0)
    w = (rng.randn(8, 16) / np.sqrt(8)).astype(np.float32)   # flax (in, out)
    b = (0.1 * rng.randn(16)).astype(np.float32)
    x = rng.randn(4, 8).astype(np.float32)
    return w, b, x


def _port_user_model():
    w, b, x = _user_weights()
    module = UserModel()
    module.load_state_dict({"Dense_0.weight": torch.from_numpy(w.T.copy()),
                            "Dense_0.bias": torch.from_numpy(b)})
    return module, torch.from_numpy(x)


# -- the policy tables and the patched names --------------------------------

def test_policy_tables_equal_jax():
    for name in ("FP16_OPS", "FP32_OPS", "PROMOTE_OPS",
                 "SEQUENCE_PROMOTE_OPS", "BANNED_OPS"):
        assert getattr(lists, name) == getattr(jlists, name), name
    assert lists.FP32_MODULE_PATTERNS == jlists.FP32_MODULE_PATTERNS
    names = (set().union(jlists.FP16_OPS, jlists.FP32_OPS,
                         jlists.PROMOTE_OPS, jlists.SEQUENCE_PROMOTE_OPS,
                         jlists.BANNED_OPS)
             | {"relu", "torch.nn.functional.softmax", "Conv2d"})
    for n in sorted(names):
        assert lists.policy_for(n) == jlists.policy_for(n), n


def test_policy_classification():
    assert lists.policy_for("conv2d") == "half"
    assert lists.policy_for("dot_general") == "half"
    assert lists.policy_for("softmax") == "fp32"
    assert lists.policy_for("layer_norm") == "fp32"
    assert lists.policy_for("add") == "promote"
    assert lists.policy_for("cat") == "sequence_promote"
    assert lists.policy_for("binary_cross_entropy") == "banned"
    assert lists.policy_for("relu") == "passthrough"
    assert lists.policy_for("torch.nn.functional.softmax") == "fp32"


def test_banned_raises():
    for mod in (lists, jlists):
        with pytest.raises(RuntimeError, match="logits"):
            mod.check_banned("binary_cross_entropy")
        mod.check_banned("mse_loss")  # fine


# the torch twins of the JAX package's patch targets, by (module, name)
TWINS = {
    ("jax.numpy", "power"): [("torch", "pow")],
    ("jax.numpy", "arccos"): [("torch", "acos"), ("torch", "arccos")],
    ("jax.numpy", "arcsin"): [("torch", "asin"), ("torch", "arcsin")],
    ("jax.numpy", "arctan"): [("torch", "atan"), ("torch", "arctan")],
    ("jax.numpy.linalg", "norm"): [("torch.linalg", "norm")],
    ("jax.nn", "softmax"): [("torch", "softmax"),
                            ("torch.nn.functional", "softmax")],
    ("jax.nn", "log_softmax"): [("torch", "log_softmax"),
                                ("torch.nn.functional", "log_softmax")],
    # jax.nn.standardize and optax's log_cosh have no torch function
    ("jax.nn", "standardize"): [],
    ("optax", "log_cosh"): [],
    ("optax", "softmax_cross_entropy"): [("torch.nn.functional",
                                          "cross_entropy")],
    ("optax", "softmax_cross_entropy_with_integer_labels"): [
        ("torch.nn.functional", "cross_entropy")],
    ("optax", "sigmoid_binary_cross_entropy"): [
        ("torch.nn.functional", "binary_cross_entropy_with_logits")],
    ("optax", "l2_loss"): [("torch.nn.functional", "mse_loss")],
    ("optax", "huber_loss"): [("torch.nn.functional", "huber_loss")],
    ("optax", "kl_divergence"): [("torch.nn.functional", "kl_div")],
}


def _jax_twins(module, name):
    if module.startswith("optax"):
        module = "optax"
    if module == "jax.scipy.special":
        return [("torch", name), ("torch.special", name)]
    return TWINS.get((module, name), [("torch", name)])


def test_every_jax_target_has_a_torch_twin_with_its_mode():
    port = {(m.__name__, n): mode for m, n, mode in patch._targets()}
    covered = set()
    for mod, name, mode in jpatch._targets():
        for twin in _jax_twins(mod.__name__, name):
            assert port.get(twin) == mode, (mod.__name__, name, twin)
            covered.add(twin)
    # beyond the twins: only the ban that torch's namespace arms
    assert set(port) - covered == {("torch.nn.functional",
                                    "binary_cross_entropy")}
    assert port[("torch.nn.functional", "binary_cross_entropy")] == "banned"
    for mod, name, _ in patch._targets():
        assert callable(getattr(mod, name))


# -- O1 enforcement (twins of test_o1_enforcement.py) ------------------------

def test_fp32_ops_run_fp32_while_matmuls_run_half():
    """The user model on the same numpy weights and input: the probed
    dtypes equal the JAX model's, the output within 1e-2 scale-aware."""
    w, b, x = _user_weights()
    jmodel, _ = jamp.initialize(JaxUserModel(), optax.sgd(0.1),
                                opt_level="O1", verbosity=0)
    want = jmodel.apply({"params": {"Dense_0": {"kernel": w, "bias": b}}},
                        jnp.asarray(x))
    module, tx = _port_user_model()
    model, _ = init_o1(module)
    got = model.apply(model.init(), tx)
    assert PROBES == JPROBES
    assert PROBES == {"dense_out": "bfloat16", "softmax_out": "float32",
                      "exp_out": "float32", "log_out": "float32",
                      "mean_out": "float32"}
    assert _dt(got) == _dt(want) == "float32"
    assert scale_err(got.detach().numpy(), want) <= 1e-2


def test_enforced_inside_autograd():
    model, _ = init_o1()
    params = model.init()
    x = torch.ones(4, 8)
    grads = torch.autograd.grad(model.apply(params, x).sum(),
                                list(params.values()))
    assert PROBES["softmax_out"] == "float32"
    assert PROBES["dense_out"] == "bfloat16"
    # master grads arrive fp32 (the canonical params are fp32)
    assert all(g.dtype == torch.float32 for g in grads)


def test_direct_user_matmul_cast_to_half():
    init_o1()
    a, b = torch.ones(4, 8), torch.ones(8, 4)
    assert torch.matmul(a, b).dtype == torch.bfloat16
    assert torch.einsum("ij,jk->ik", a, b).dtype == torch.bfloat16
    assert torch.tensordot(a, b, dims=1).dtype == torch.bfloat16
    assert torch.inner(a, b.T).dtype == torch.bfloat16
    v = torch.ones(8)
    assert torch.dot(v, v).dtype == torch.bfloat16
    assert torch.vdot(v, v).dtype == torch.bfloat16
    assert jnp.matmul(jnp.ones((4, 8)), jnp.ones((8, 4))).dtype == \
        jnp.float32   # the JAX policy is not installed: only the port's


def test_disable_casts_suspends_policy():
    init_o1()
    h = torch.ones(4, dtype=torch.bfloat16)
    with amp.disable_casts():
        assert torch.exp(h).dtype == torch.bfloat16
        assert _amp_state._amp_state.casts_disabled
    assert torch.exp(h).dtype == torch.float32
    assert not _amp_state._amp_state.casts_disabled


def test_disable_casts_suspends_the_model_casts():
    """``AmpModel`` casts neither params nor inputs under
    ``disable_casts``, as the JAX package's ``compute_variables`` and
    ``cast_inputs`` do not."""
    model, _ = init_o1()
    params = model.init()
    with amp.disable_casts():
        out = model.apply(params, torch.ones(4, 8))
        assert model.compute_variables(params) is params
    assert PROBES["dense_out"] == "float32" and out.dtype == torch.float32


def test_inert_without_o1():
    init_o1()
    amp.initialize(UserModel(), transforms.sgd(0.1), opt_level="O2",
                   verbosity=0)
    h = torch.ones(4, dtype=torch.bfloat16)
    assert torch.exp(h).dtype == torch.bfloat16
    a = torch.ones(4, 8)
    assert torch.matmul(a, a.T).dtype == torch.float32
    _amp_state._amp_state.opt_properties = None
    assert torch.exp(h).dtype == torch.bfloat16


def test_removal_restores_originals():
    originals = {(id(m), n): getattr(m, n) for m, n, _ in patch._targets()}
    assert not any(hasattr(f, "__amp_original__")
                   for f in originals.values())
    init_o1()
    for mod, name, _ in patch._targets():
        assert getattr(mod, name).__amp_original__ is \
            originals[(id(mod), name)], name
    amp.remove_o1_patches()
    for mod, name, _ in patch._targets():
        assert getattr(mod, name) is originals[(id(mod), name)], name
    h = torch.ones(4, dtype=torch.bfloat16)
    assert torch.exp(h).dtype == torch.bfloat16


def test_integer_and_python_args_untouched():
    init_o1()
    labels = torch.zeros(4, dtype=torch.int64)
    logits = torch.ones(4, 8, dtype=torch.bfloat16)
    assert F.cross_entropy(logits, labels).dtype == torch.float32
    assert not torch.sum(torch.ones(3, dtype=torch.int32)).is_floating_point()
    assert torch.cumsum(torch.arange(4), dim=0).dtype == torch.int64
    assert torch.pow(torch.ones(2, dtype=torch.bfloat16), 2).dtype == \
        torch.float32
    assert torch.sum(torch.ones(2, 3, dtype=torch.bfloat16), dim=1,
                     dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_internal_fp32_attention_immune_to_half_patch(dtype):
    """The plain flash forward and backward and the plain decode
    attention, whose fp32 upcasts are deliberate, give the same bits
    under an active O1 policy as without it."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, 2, 64, generator=g).to(dtype)
               for _ in range(3))
    dq = torch.randn(2, 1, 2, 64, generator=g).to(dtype)
    bias = torch.zeros(2, 64)
    bias[1, 40:] = -1e9

    def run():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv, causal=True)
        grads = torch.autograd.grad((o.float() ** 2).sum(), (qq, kk, vv))
        dec = cached_attention(dq, k, v, kv_bias=bias)
        return (o.detach(), *grads, dec)

    ref = run()
    init_o1()
    assert hasattr(torch.einsum, "__amp_original__")
    for got, want in zip(run(), ref):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_default_attention_follows_jax_under_o1():
    """GPT's default (non-flash) attention goes through the patched
    einsum and softmax as its JAX twin goes through jnp's: fp32 q/k/v
    come out bf16 on both sides, within 1e-2 scale-aware."""
    from apex_tpu.models.gpt import causal_dot_product_attention as jattn
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 16, 2, 8).astype(np.float32) for _ in range(3))
    jamp.initialize(JaxUserModel(), optax.sgd(0.1), opt_level="O1",
                    verbosity=0)
    want = jattn(*(jnp.asarray(t) for t in (q, k, v)))
    init_o1()
    got = causal_dot_product_attention(*(torch.from_numpy(t)
                                         for t in (q, k, v)))
    assert _dt(got) == _dt(want) == "bfloat16"
    assert scale_err(got.float().numpy(), np.asarray(want, np.float32)) \
        <= 1e-2


def test_o1_training_trajectory_finite():
    model, opt = init_o1()
    params = model.init()
    state = opt.init(params)
    x = torch.ones(4, 8)
    first = params["Dense_0.weight"].detach().clone()
    for _ in range(3):
        loss = (model.apply(params, x) ** 2).mean()
        with amp.scale_loss(loss, state) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()))
        params, state = opt.step(params, dict(zip(params, grads)), state)
    leaf = params["Dense_0.weight"]
    assert leaf.dtype == torch.float32 and torch.isfinite(leaf).all()
    assert not torch.equal(leaf, first)
    assert int(state.applied_steps) == 3


# -- the decorators and the legacy handles (twins of test_amp_lists.py) ------

def test_legacy_handle_roundtrip():
    with pytest.warns(DeprecationWarning):
        handle = amp.init(enabled=True)
    assert handle.is_active and handle.has_cache
    optimizer = handle.wrap_optimizer(transforms.sgd(0.1))
    params = {"w": torch.ones(4)}
    state = optimizer.init(params)
    with handle.scale_loss(torch.tensor(1.0), state) as scaled:
        assert float(scaled) == float(state.loss_scalers[0].loss_scale)
    g = {"w": torch.ones(4) * float(scaled)}   # "scaled" grads
    params2, state2 = optimizer.step(params, g, state)
    assert torch.allclose(params2["w"], torch.full((4,), 0.9))
    # the JAX handle on the same numbers gives the same bits
    with pytest.warns(DeprecationWarning):
        jhandle = jamp.init(enabled=True)
    jopt = jhandle.wrap_optimizer(optax.sgd(0.1))
    jstate = jopt.init({"w": jnp.ones((4,))})
    jparams, _ = jopt.step({"w": jnp.ones((4,))},
                           {"w": jnp.ones((4,)) * float(scaled)}, jstate)
    np.testing.assert_array_equal(params2["w"].numpy(),
                                  np.asarray(jparams["w"]))
    assert amp.OptimWrapper is amp.AmpOptimizer


def test_register_functions_patch_module():
    mod = types.SimpleNamespace(f=lambda x: x.dtype, g=lambda x: x.dtype,
                                h=lambda x, y: (x.dtype, y.dtype))
    amp.register_half_function(mod, "f")
    amp.register_float_function(mod, "g")
    amp.register_promote_function(mod, "h")
    # inert without an active policy
    assert mod.f(torch.ones(2)) == torch.float32
    _amp_state._amp_state.opt_properties = amp.opt_levels["O2"](
        amp.Properties())
    assert mod.f(torch.ones(2)) == torch.bfloat16
    assert mod.g(torch.ones(2, dtype=torch.bfloat16)) == torch.float32
    assert mod.h(torch.ones(2, dtype=torch.bfloat16), torch.ones(2)) == \
        (torch.float32, torch.float32)
    assert mod.h(torch.ones(2, dtype=torch.bfloat16),
                 torch.ones(2, dtype=torch.float16)) == \
        (torch.float32, torch.float32)      # as jnp.result_type promotes


def test_noop_handle():
    handle = amp.init(enabled=False)
    assert not handle.is_active
    with handle.scale_loss(torch.tensor(2.5), None) as s:
        assert float(s) == 2.5
    opt = handle.wrap_optimizer(transforms.sgd(0.1))
    assert float(opt.loss_scaler._init_scale) == 1.0


def test_banned_enforced_at_registration():
    mod = types.ModuleType("user_losses")
    mod.binary_cross_entropy = lambda p, y: p
    with pytest.raises(RuntimeError, match="with_logits"):
        amp.register_half_function(mod, "binary_cross_entropy")
    with pytest.raises(RuntimeError, match="with_logits"):
        amp.register_float_function(mod, "binary_cross_entropy")


def test_banned_function_raises_only_under_active_amp():
    def binary_cross_entropy(p, y):
        return -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean()

    wrapped = amp.banned_function(binary_cross_entropy)
    p, y = torch.tensor([0.4, 0.9]), torch.tensor([0.0, 1.0])
    assert torch.isfinite(wrapped(p, y))   # amp inactive: passes through
    init_o1(MLP(features=(4,), in_features=8, device="cpu"))
    with pytest.raises(RuntimeError, match="with_logits"):
        wrapped(p, y)
    with amp.disable_casts():
        assert torch.isfinite(wrapped(p, y))


def test_torch_binary_cross_entropy_banned_under_o1():
    """torch ships the probability form of BCE, so the ban the JAX
    package only arms fires here, as in the reference."""
    p, y = torch.tensor([0.4, 0.9]), torch.tensor([0.0, 1.0])
    assert torch.isfinite(F.binary_cross_entropy(p, y))
    init_o1()
    with pytest.raises(RuntimeError, match="with_logits"):
        F.binary_cross_entropy(p, y)
    with amp.disable_casts():
        assert torch.isfinite(F.binary_cross_entropy(p, y))


def test_master_params_and_scale():
    params = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    assert [t.shape for t in amp.master_params(params)] == \
        [(2,), (3,)]
    opt = amp.AmpOptimizer(transforms.sgd(0.1), amp.LossScaler(8.0))
    state = opt.init(params)
    with pytest.raises(TypeError, match="not AmpOptimizerState"):
        list(amp.master_params(state))
    assert float(amp.scale(torch.tensor(2.0), state)) == 16.0


def test_exports_match_jax():
    import apex_tpu.fp16_utils as jfp16
    import apex_tpu_torch.fp16_utils as fp16
    assert sorted(amp.__all__) == sorted(jamp.__all__)
    assert all(hasattr(amp, n) for n in amp.__all__)
    assert sorted(fp16.__all__) == sorted(jfp16.__all__)
    assert all(hasattr(fp16, n) for n in fp16.__all__)


def test_initialize_defaults_to_o1_and_takes_the_reference_alias():
    model = amp.initialize(UserModel(), verbosity=0)
    assert _amp_state._amp_state.opt_properties.opt_level == "O1"
    assert model.keep_fp32_patterns == amp.AmpModel(
        UserModel(), _amp_state._amp_state.opt_properties
    ).keep_fp32_patterns
    assert hasattr(torch.exp, "__amp_original__")
    amp.remove_o1_patches()
    amp.initialize(UserModel(), opt_level="O2", patch_torch_functions=True,
                   verbosity=0)
    assert _amp_state._amp_state.opt_properties.cast_ops is True
    assert torch.exp(torch.ones(1, dtype=torch.bfloat16)).dtype == \
        torch.float32


# -- the kept-fp32 parameters of the other twins under O1 --------------------

def _jax_fp32_markers(jmodel, *init_args, **init_kwargs):
    """The JAX model's compute layout under O1 as a tree of arrays that
    are 1 where the leaf stays fp32 and 0 where it runs half (shapes
    from ``jax.eval_shape``: nothing is computed)."""
    shapes = jax.eval_shape(lambda: jmodel.compute_variables(
        jmodel.init(jax.random.PRNGKey(0), *init_args, **init_kwargs)))
    return jax.tree_util.tree_map(
        lambda s: np.full(s.shape, float(s.dtype == jnp.float32),
                          np.float32), shapes)


def _port_fp32(module):
    model = amp.initialize(module, opt_level="O1", verbosity=0)
    compute = model.compute_variables(model.init())
    return {n for n, t in compute.items() if t.dtype == torch.float32}, \
        set(compute)


def test_bert_kept_fp32_params_match_jax_under_o1():
    kw = dict(vocab_size=50, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=16)
    jmodel = jamp.initialize(jax_models.BertForPreTraining(
        jax_models.BertConfig(**kw)), opt_level="O1", verbosity=0)
    markers = _jax_fp32_markers(jmodel, jnp.zeros((2, 8), jnp.int32))
    cfg = tb.BertConfig(**kw)
    want = {n for n, t in tb.params_from_jax(markers, cfg).items()
            if float(t.flatten()[0]) == 1.0}
    got, names = _port_fp32(tb.BertForPreTraining(cfg, device="cpu"))
    assert names == set(tb.params_from_jax(markers, cfg))
    assert got == want
    assert got and all("ln" in n or "LayerNorm" in n for n in got), got


def test_resnet18_kept_fp32_params_match_jax_under_o1():
    jmodel = jamp.initialize(jr.ResNet18(), opt_level="O1", verbosity=0)
    markers = _jax_fp32_markers(jmodel, jnp.ones((1, 64, 64, 3)),
                                train=False)
    mapped = tr.resnet_params_from_jax(markers)
    got, names = _port_fp32(tr.ResNet18(device="cpu", seed=None))
    want = {n for n in names if float(mapped[n].flatten()[0]) == 1.0}
    assert got == want
    assert len(got) == 2 * 20   # every norm layer's scale and bias
    assert "fc.weight" not in got and "conv_init.weight" not in got


# -- the isolation fixture ----------------------------------------------------

def test_o1_left_active_on_purpose():
    """Leaves the O1 policy installed and active, as a test that forgot
    to clean up would; the next test checks the fixture removed it."""
    init_o1()
    assert hasattr(torch.sum, "__amp_original__")
    assert hasattr(F.softmax, "__amp_original__")
    assert hasattr(torch.einsum, "__amp_original__")
    assert _amp_state._amp_state.opt_properties is not None


def test_fixture_removed_the_leaked_o1():
    for fn in (torch.sum, F.softmax, torch.einsum):
        assert not hasattr(fn, "__amp_original__"), fn
    assert _amp_state._amp_state.opt_properties is None
    assert not _amp_state._amp_state.casts_disabled
    assert torch.sum(torch.ones(2, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
