"""The port's legacy toolkit (``apex_tpu_torch.fp16_utils``) and amp's
loss scaler against the JAX package.

The twins of ``tests/L0/test_fp16util.py`` and
``tests/L0/test_loss_scaler.py`` run on the same numpy inputs through
both packages: the converters keep the same leaves fp32 (names mapped
flax -> torch), the master/model round trips and the legacy scalers'
overflow and growth sequences are exact, the clipping norms agree to
1e-6 relative (fp32 sums in another order), and ``FP16_Optimizer`` over
``sgd`` tracks the JAX one to 1e-5 scale-aware over three steps (bf16
model params cast from the same fp32 masters), keeps every bit on an
overflowed step, and round-trips its ``state_dict``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu import fp16_utils as jfp16
from apex_tpu.amp import LossScaler as JaxAmpScaler
from apex_tpu_torch import fp16_utils as fp16
from apex_tpu_torch.amp import LossScaler as AmpScaler
from apex_tpu_torch.optimizers import transforms

torch.set_num_threads(1)


def scale_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _dt(x):
    return str(x.dtype).rsplit(".", 1)[-1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


class JaxConvBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(8, (3, 3), name="conv1")(x)
        x = fnn.BatchNorm(use_running_average=not train,
                          name="BatchNorm_0")(x)
        x = fnn.relu(x)
        x = x.mean(axis=(1, 2))
        return fnn.Dense(4, name="head")(x)


class ConvBN(nn.Module):
    """The JAX test's model with flax's module names (NCHW)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.BatchNorm_0 = nn.BatchNorm2d(8)
        self.head = nn.Linear(8, 4)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.conv1(x)))
        return self.head(x.mean(dim=(2, 3)))


# flax leaf -> torch name
LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
        ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
        ("batch_stats", "var"): "running_var"}


def _jax_dtypes(tree):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        out[f"{keys[1]}.{LEAF[(keys[0], keys[-1])]}"] = _dt(jnp.asarray(x))
    return out


def _variables():
    jv = JaxConvBN().init(jax.random.PRNGKey(0), jnp.ones((2, 8, 8, 3)))
    sd = ConvBN().state_dict()
    return jv, sd


def _port_dtypes(sd):
    return {n: _dt(t) for n, t in sd.items() if t.is_floating_point()}


# -- conversion helpers ------------------------------------------------------

def test_convert_network_keeps_bn_fp32():
    jv, sd = _variables()
    want = _jax_dtypes(jfp16.convert_network(jv, jnp.bfloat16))
    got = fp16.convert_network(sd, torch.bfloat16)
    assert _port_dtypes(got) == want
    assert got["BatchNorm_0.num_batches_tracked"].dtype == torch.int64
    assert {n for n, d in want.items() if d == "float32"} == {
        "BatchNorm_0.weight", "BatchNorm_0.bias", "BatchNorm_0.running_mean",
        "BatchNorm_0.running_var"}


def test_network_to_half_fp16():
    jv, sd = _variables()
    want = _jax_dtypes(jfp16.network_to_half(jv, jnp.float16))
    got = fp16.network_to_half(sd, torch.float16)
    assert _port_dtypes(got) == want
    assert got["conv1.weight"].dtype == torch.float16


def test_bn_convert_float_restores_bn_only():
    jv, sd = _variables()
    want = _jax_dtypes(jfp16.BN_convert_float(
        jfp16.convert_tree(jv, jnp.bfloat16)))
    got = fp16.BN_convert_float(fp16.convert_tree(sd, torch.bfloat16))
    assert _port_dtypes(got) == want
    assert got["BatchNorm_0.weight"].dtype == torch.float32
    assert got["conv1.weight"].dtype == torch.bfloat16


def test_tofp16_casts_only_floats():
    batch = {"x": torch.ones(2, 3), "y": torch.zeros(2, dtype=torch.int32),
             "name": "b0", "pair": (torch.ones(1), 3)}
    out = fp16.tofp16(batch, torch.bfloat16)
    jout = jfp16.tofp16({"x": jnp.ones((2, 3)),
                         "y": jnp.zeros((2,), jnp.int32), "name": "b0",
                         "pair": (jnp.ones((1,)), 3)}, jnp.bfloat16)
    assert _dt(out["x"]) == _dt(jout["x"]) == "bfloat16"
    assert _dt(out["y"]) == _dt(jout["y"]) == "int32"
    assert out["name"] == jout["name"] == "b0"
    assert _dt(out["pair"][0]) == "bfloat16" and out["pair"][1] == 3


def test_fp16model_wrapper():
    fm = fp16.FP16Model(ConvBN(), torch.bfloat16)
    params = fm.init()
    assert params["conv1.weight"].dtype == torch.bfloat16
    assert params["BatchNorm_0.weight"].dtype == torch.float32
    jfm = jfp16.FP16Model(JaxConvBN(), jnp.bfloat16)
    jdts = _jax_dtypes(jfm.init(jax.random.PRNGKey(0),
                                jnp.ones((2, 8, 8, 3))))
    assert {n: _dt(t) for n, t in params.items()} == \
        {n: d for n, d in jdts.items() if "running" not in n}
    out = fm.apply(params, torch.ones(2, 3, 8, 8))
    assert torch.isfinite(out.float()).all()
    # a norm-free model stays half end to end
    fd = fp16.FP16Model(nn.Linear(3, 4), torch.bfloat16)
    assert fd.apply(fd.init(), torch.ones(2, 3)).dtype == torch.bfloat16


# -- master-param helpers ----------------------------------------------------

def _half_params():
    """bf16 model params (and one fp32 leaf) from numpy, both packages;
    keys sorted so both trees flatten in one order."""
    rng = np.random.RandomState(0)
    raw = {"a_w": rng.randn(3, 4), "b_b": rng.randn(4), "c_s": rng.randn(5)}
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.float32 if k == "c_s" else torch.bfloat16)
        for k, v in raw.items()}
    jp = {k: jnp.asarray(v.astype(np.float32)).astype(
        jnp.float32 if k == "c_s" else jnp.bfloat16) for k, v in raw.items()}
    return tp, jp


def test_prep_param_lists_tree_master():
    tp, jp = _half_params()
    model_p, master_p = fp16.prep_param_lists(tp)
    _, jmaster = jfp16.prep_param_lists(jp)
    assert model_p is tp
    for k in tp:
        assert master_p[k].dtype == torch.float32
        np.testing.assert_array_equal(master_p[k].numpy(),
                                      np.asarray(jmaster[k]))
    master_p["c_s"].add_(1.0)      # a copy, not the model's tensor
    assert not torch.equal(master_p["c_s"], tp["c_s"])


def test_flat_master_roundtrip():
    tp, jp = _half_params()
    model_p, (flat, spec) = fp16.prep_param_lists(tp, flat_master=True)
    _, (jflat, _) = jfp16.prep_param_lists(jp, flat_master=True)
    assert flat.dtype == torch.float32 and flat.ndim == 1
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = fp16.master_params_to_model_params(model_p, (flat, spec),
                                              flat_master=True)
    for k in tp:
        assert back[k].dtype == tp[k].dtype
        assert torch.equal(back[k], tp[k])


def test_model_grads_to_master_grads():
    g = {"w": torch.ones(3, 3, dtype=torch.bfloat16)}
    mg = fp16.model_grads_to_master_grads(g)
    assert mg["w"].dtype == torch.float32
    _, master = fp16.prep_param_lists(g, flat_master=True)
    flat_g = fp16.model_grads_to_master_grads(g, master, flat_master=True)
    jg = {"w": jnp.ones((3, 3), jnp.bfloat16)}
    _, jmaster = jfp16.prep_param_lists(jg, flat_master=True)
    jflat = jfp16.model_grads_to_master_grads(jg, jmaster, flat_master=True)
    assert flat_g.shape == (9,) and flat_g.dtype == torch.float32
    np.testing.assert_array_equal(flat_g.numpy(), np.asarray(jflat))
    with pytest.raises(ValueError, match="flat_master"):
        fp16.model_grads_to_master_grads(g, None, flat_master=True)


def test_master_params_to_model_params_casts_down():
    model_p = {"w": torch.zeros(2, 2, dtype=torch.bfloat16),
               "b": torch.zeros(2)}
    master = {"w": torch.full((2, 2), 1.7), "b": torch.full((2,), 2.5)}
    out = fp16.master_params_to_model_params(model_p, master)
    jout = jfp16.master_params_to_model_params(
        {"w": jnp.zeros((2, 2), jnp.bfloat16), "b": jnp.zeros((2,))},
        {"w": jnp.full((2, 2), 1.7), "b": jnp.full((2,), 2.5)})
    for k in out:
        assert _dt(out[k]) == _dt(jout[k])
        np.testing.assert_array_equal(_np(out[k]), _np(jout[k]))


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 3.0])
@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_grad_norm(norm_type, max_norm):
    rng = np.random.RandomState(1)
    raw = {"a": np.full((4,), 3.0), "b": np.full((4,), 4.0),
           "c": rng.randn(7) * 5}
    tg = {k: torch.from_numpy(v.astype(np.float32)) for k, v in raw.items()}
    tg["c"] = tg["c"].to(torch.bfloat16)
    jg = {k: jnp.asarray(v.astype(np.float32)) for k, v in raw.items()}
    jg["c"] = jg["c"].astype(jnp.bfloat16)
    clipped, total = fp16.clip_grad_norm(tg, max_norm, norm_type)
    jclipped, jtotal = jfp16.clip_grad_norm(jg, max_norm, norm_type)
    assert total.dtype == torch.float32
    assert abs(float(total) - float(jtotal)) <= 1e-6 * float(jtotal)
    for k in tg:
        assert clipped[k].dtype == tg[k].dtype
        assert scale_err(_np(clipped[k]), _np(jclipped[k])) <= 1e-6, k


def test_clip_grad_norm_reference_values():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, total = fp16.clip_grad_norm(g, max_norm=1.0)
    np.testing.assert_allclose(float(total), 10.0, rtol=1e-6)
    _, new_norm = fp16.clip_grad_norm(clipped, max_norm=1e9)
    np.testing.assert_allclose(float(new_norm), 1.0, rtol=1e-4)
    same, _ = fp16.clip_grad_norm(g, max_norm=100.0)
    np.testing.assert_allclose(same["a"].numpy(), 3.0, rtol=1e-6)
    _, inf = fp16.clip_grad_norm({"a": torch.tensor([-5.0, 2.0])}, 1.0,
                                 norm_type=float("inf"))
    assert float(inf) == 5.0


# -- legacy scalers ----------------------------------------------------------

def test_static_scaler_noop():
    s, js = fp16.LossScaler(128.0), jfp16.LossScaler(128.0)
    assert s.loss_scale == js.loss_scale == 128.0
    assert s.has_overflow({"g": torch.tensor([float("inf")])}) is False
    s.update_scale(True)
    assert s.loss_scale == 128.0
    g = s.scale_gradient({"w": torch.ones(2, dtype=torch.bfloat16)})
    assert g["w"].dtype == torch.bfloat16 and float(g["w"][0]) == 128.0
    u = s.unscale_gradient({"w": torch.full((2,), 256.0)})
    assert float(u["w"][0]) == 2.0
    assert float(s.backward(torch.tensor(2.0, dtype=torch.bfloat16))) == \
        float(js.backward(jnp.asarray(2.0, jnp.bfloat16))) == 256.0


def test_dynamic_scaler_legacy_defaults():
    s, js = fp16.DynamicLossScaler(), jfp16.DynamicLossScaler()
    assert s.loss_scale == js.loss_scale == 2.0 ** 32
    assert s.scale_window == js.scale_window == 1000
    assert s.scale_factor == js.scale_factor == 2.0


def test_dynamic_scaler_overflow_and_growth():
    """A scripted sequence: the scale, iteration and last-overflow counts
    equal the JAX scaler's after every update."""
    s = fp16.DynamicLossScaler(init_scale=1024.0, scale_window=2)
    js = jfp16.DynamicLossScaler(init_scale=1024.0, scale_window=2)
    bad, good = torch.tensor([1.0, float("nan")]), torch.tensor([1.0, 2.0])
    assert s.has_overflow({"g": bad}) and not s.has_overflow({"g": good})
    assert js.has_overflow({"g": jnp.asarray([1.0, jnp.nan])})
    for overflow in (True, False, False, True, True, False, False, False,
                     False, True):
        s.update_scale(overflow)
        js.update_scale(overflow)
        assert (s.loss_scale, s.iter, s.last_overflow_iter) == \
            (js.loss_scale, js.iter, js.last_overflow_iter)
    s = fp16.DynamicLossScaler(init_scale=1024.0, scale_window=2)
    s.update_scale(True)
    assert s.loss_scale == 512.0
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 1024.0


def test_dynamic_scaler_scale_gradient():
    s = fp16.DynamicLossScaler(init_scale=4.0)
    g = s.scale_gradient({"w": torch.ones(2)})
    np.testing.assert_array_equal(g["w"].numpy(), 4.0)


# -- general FP16_Optimizer --------------------------------------------------

def _quad(kw, momentum=None):
    params = {"w": torch.full((8,), 2.0).to(torch.bfloat16)}
    opt = fp16.FP16_Optimizer(transforms.sgd(0.1, momentum), **kw)
    jparams = {"w": jnp.full((8,), 2.0, jnp.bfloat16)}
    jopt = jfp16.FP16_Optimizer(optax.sgd(0.1, momentum), **kw)
    return params, opt, opt.init(params), jparams, jopt, jopt.init(jparams)


def _grads(params, opt, state):
    p = params["w"].detach().requires_grad_()
    loss = torch.sum(p.float() ** 2) / 2
    (g,) = torch.autograd.grad(opt.scale_loss(loss, state), [p])
    return {"w": g}


def _jgrads(params, opt, state):
    def loss_fn(p):
        return opt.scale_loss(
            jnp.sum(jnp.square(p["w"].astype(jnp.float32))) / 2, state)
    return jax.grad(loss_fn)(params)


def test_fp16_optimizer_three_sgd_steps_match_jax():
    params, opt, st, jparams, jopt, jst = _quad(
        dict(static_loss_scale=128.0))
    assert st.master["w"].dtype == torch.float32
    for _ in range(3):
        params, st = opt.step(params, _grads(params, opt, st), st)
        jparams, jst = jopt.step(jparams, _jgrads(jparams, jopt, jst), jst)
        assert scale_err(_np(st.master["w"]), jst.master["w"]) <= 1e-5
        assert scale_err(_np(params["w"]), jparams["w"]) <= 1e-5
    assert params["w"].dtype == torch.bfloat16
    ref = 2.0 * 0.9 ** 3
    np.testing.assert_allclose(st.master["w"].numpy(), ref, rtol=1e-2)


def test_fp16_optimizer_skips_on_overflow():
    params, opt, st, jparams, jopt, jst = _quad(
        dict(dynamic_loss_scale=True), momentum=0.9)
    params, st = opt.step(params, _grads(params, opt, st), st)
    jparams, jst = jopt.step(jparams, _jgrads(jparams, jopt, jst), jst)
    assert st.inner[0].trace["w"].abs().sum() > 0
    scale0 = float(opt.loss_scale(st))
    assert scale0 == float(jopt.loss_scale(jst))
    bad = {"w": torch.full((8,), float("inf"), dtype=torch.bfloat16)}
    params2, st2 = opt.step(params, bad, st)
    jparams2, jst2 = jopt.step(
        jparams, {"w": jnp.full((8,), jnp.inf, jnp.bfloat16)}, jst)
    assert torch.equal(params2["w"], params["w"])
    assert torch.equal(st2.master["w"], st.master["w"])
    for a, b in zip(torch.utils._pytree.tree_leaves(st2.inner),
                    torch.utils._pytree.tree_leaves(st.inner)):
        assert torch.equal(a, b)
    assert float(opt.loss_scale(st2)) == scale0 / 2 == \
        float(jopt.loss_scale(jst2))
    np.testing.assert_array_equal(_np(params2["w"]), _np(jparams2["w"]))
    np.testing.assert_array_equal(st2.master["w"].numpy(),
                                  np.asarray(jst2.master["w"]))


def test_fp16_optimizer_grad_clip():
    params, opt, st, jparams, jopt, jst = _quad(dict(static_loss_scale=1.0))
    p2, st2 = opt.step(params, {"w": torch.full(
        (8,), 100.0, dtype=torch.bfloat16)}, st, max_grad_norm=1.0)
    jp2, jst2 = jopt.step(jparams, {"w": jnp.full((8,), 100.0,
                                                  jnp.bfloat16)}, jst,
                          max_grad_norm=1.0)
    assert scale_err(_np(st2.master["w"]), jst2.master["w"]) <= 1e-5
    moved = (p2["w"].float() - params["w"].float()).abs()
    assert torch.all(moved <= 0.1 * (1.0 / np.sqrt(8) + 1e-3) + 1e-2)


def test_fp16_optimizer_state_dict_roundtrip():
    params, opt, st, _, _, _ = _quad(dict(dynamic_loss_scale=True))
    params, st = opt.step(params, _grads(params, opt, st), st)
    d = opt.state_dict(st)
    assert set(d) == {"master_params", "optimizer_state", "loss_scaler"}
    restored = opt.load_state_dict({k: v for k, v in d.items()})
    for a, b in zip(torch.utils._pytree.tree_leaves(st),
                    torch.utils._pytree.tree_leaves(restored)):
        assert torch.equal(a, b)
    assert opt.inspect_master_grad_data({"w": torch.ones(2)})[0].shape == \
        (2,)


def test_fp16_optimizer_dynamic_defaults_match_jax():
    opt = fp16.FP16_Optimizer(transforms.sgd(0.1), static_loss_scale="dynamic")
    jopt = jfp16.FP16_Optimizer(optax.sgd(0.1), static_loss_scale="dynamic")
    st = opt.init({"w": torch.ones(2)})
    jst = jopt.init({"w": jnp.ones((2,))})
    assert float(st.scaler.loss_scale) == float(jst.scaler.loss_scale) == \
        2.0 ** 32
    assert opt.loss_scaler.scale_window == jopt.loss_scaler.scale_window


# -- amp's LossScaler (twins of test_loss_scaler.py) --------------------------

def _grad_tree(fill=1.0, bad=None):
    g = {"w": torch.full((4, 4), fill), "b": torch.full((4,), fill)}
    if bad is not None:
        g["w"][0, 0] = bad
    return g


def _jgrad_tree(fill=1.0, bad=None):
    g = {"w": jnp.full((4, 4), fill, jnp.float32),
         "b": jnp.full((4,), fill, jnp.float32)}
    if bad is not None:
        g["w"] = g["w"].at[0, 0].set(bad)
    return g


def _same_state(st, jst):
    assert float(st.loss_scale) == float(jst.loss_scale)
    assert int(st.unskipped) == int(jst.unskipped)
    assert bool(st.overflow) == bool(jst.overflow)


def test_amp_scaler_dynamic_defaults():
    st = AmpScaler("dynamic").init(device="cpu")
    _same_state(st, JaxAmpScaler("dynamic").init())
    assert float(st.loss_scale) == 2.0 ** 16


@pytest.mark.parametrize("kw,flags", [
    (dict(loss_scale=128.0, scale_window=1), [False, False, False, True]),
    (dict(init_scale=1024.0, scale_window=3), [True, False, False, False]),
    (dict(init_scale=2.0 ** 24, scale_window=1), [False, False]),
    (dict(init_scale=2.0, min_loss_scale=1.0), [True] * 4),
])
def test_amp_scaler_sequences_match_jax(kw, flags):
    """Static never changes; overflow halves and a clean window doubles;
    the max and min clamps: every state equal, step by step."""
    s, js = AmpScaler(**kw), JaxAmpScaler(**kw)
    st, jst = s.init(device="cpu"), js.init()
    for f in flags:
        st = s.update(st, torch.tensor(f))
        jst = js.update(jst, jnp.asarray(f))
        _same_state(st, jst)


def test_amp_scaler_sustained_nonfinite_streak_clamps_then_recovers():
    kw = dict(init_scale=2.0 ** 6, scale_window=2, min_loss_scale=4.0)
    s, js = AmpScaler("dynamic", **kw), JaxAmpScaler("dynamic", **kw)
    st, jst = s.init(device="cpu"), js.init()
    seen = []
    for i in range(24):
        bad = float("nan") if i < 20 else None
        _, overflow = s.unscale(_grad_tree(fill=2.0, bad=bad), st)
        _, joverflow = js.unscale(_jgrad_tree(
            fill=2.0, bad=None if bad is None else jnp.nan), jst)
        assert bool(overflow) == bool(joverflow) == (i < 20)
        st, jst = s.update(st, overflow), js.update(jst, joverflow)
        _same_state(st, jst)
        seen.append(float(st.loss_scale))
    assert seen[:5] == [32.0, 16.0, 8.0, 4.0, 4.0]
    assert seen[-1] == 16.0


def test_amp_scaler_scale_unscale_roundtrip_and_overflow():
    s, js = AmpScaler("dynamic", init_scale=4.0), \
        JaxAmpScaler("dynamic", init_scale=4.0)
    st, jst = s.init(device="cpu"), js.init()
    assert float(s.scale_loss(torch.tensor(2.0), st)) == \
        float(js.scale_loss(jnp.asarray(2.0), jst)) == 8.0
    g, overflow = s.unscale(_grad_tree(fill=4.0), st)
    assert not bool(overflow)
    np.testing.assert_allclose(g["w"].numpy(), 1.0)
    _, overflow = s.unscale(_grad_tree(bad=float("inf")), st)
    assert bool(overflow)


def test_amp_scaler_full_protocol():
    """scale -> backward -> unscale -> update, twice, the second step's
    data non-finite, beside the JAX protocol under jit."""
    s = AmpScaler("dynamic", init_scale=2.0 ** 8, scale_window=2)
    js = JaxAmpScaler("dynamic", init_scale=2.0 ** 8, scale_window=2)

    @jax.jit
    def jstep(st, x):
        g = jax.grad(lambda p: js.scale_loss(jnp.sum(p * x), st))(
            jnp.ones((4,)))
        g, overflow = js.unscale({"p": g}, st)
        return js.update(st, overflow), g["p"]

    def step(st, x):
        p = torch.ones(4, requires_grad=True)
        (g,) = torch.autograd.grad(s.scale_loss(torch.sum(p * x), st), [p])
        g, overflow = s.unscale({"p": g}, st)
        return s.update(st, overflow), g["p"]

    st, jst = s.init(device="cpu"), js.init()
    for fill in (3.0, float("inf")):
        st, g = step(st, torch.full((4,), fill))
        jst, jg = jstep(jst, jnp.full((4,), fill))
        _same_state(st, jst)
    assert bool(st.overflow) and float(st.loss_scale) == 2.0 ** 7
