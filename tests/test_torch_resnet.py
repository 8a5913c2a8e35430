"""The port's ResNet (``apex_tpu_torch.models.resnet``) against the JAX
model on the same weights (``resnet_params_from_jax``) and inputs.

Tolerances (scale-aware, max|a-b| / (max|b| + 1)):
- fp32 logits, train and eval mode: 1e-5 (two float32 conv stacks that
  sum in different orders);
- one norm layer's output and updated running statistics on the same
  input: 1e-6; a network's updated statistics: 1e-6 at the stem's norm,
  1e-5 downstream (the logits' bound: they read the conv stack's
  activations);
- ResNet-50 at 64x64: 1e-4 (53 convs deep);
- amp O2 logits: 2e-2 (bf16 convs on both sides, rounded apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import parallel as jparallel
from apex_tpu.models import resnet as jr
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.parallel import SyncBatchNorm

BLOCKS = {"basic": (jr.BasicBlock, tr.BasicBlock),
          "bottleneck": (jr.Bottleneck, tr.Bottleneck)}


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


def _random_variables(module, x, seed=1, **kw):
    """Variables of ``module``'s shapes (``jax.eval_shape`` of its init:
    nothing is compiled) drawn from numpy: normal kernels scaled by
    fan-in, and scales, biases and running statistics in [0.5, 1.5) so
    no scale is zero and no statistic sits at its init."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 1:
            return (0.5 + rng.rand(*leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _pair(block="basic", norm="bn", stem="conv", width=8, stages=(1, 1),
          num_classes=10, size=32, batch=4, seed=0):
    jb, tb = BLOCKS[block]
    jnorm = jr.default_norm if norm == "bn" else jparallel.SyncBatchNorm
    tnorm = tr.default_norm if norm == "bn" else SyncBatchNorm
    jm = jr.ResNet(stage_sizes=list(stages), block=jb,
                   num_classes=num_classes, width=width, norm=jnorm,
                   stem=stem)
    x = np.random.RandomState(seed).randn(batch, size, size, 3) \
        .astype(np.float32)
    xin = jr.s2d_input_transform(x) if stem == "s2d_pre" else x
    v = _random_variables(jm, xin, seed=seed + 1, train=True)
    tm = tr.ResNet(list(stages), tb, num_classes=num_classes, width=width,
                   norm=tnorm, stem=stem, device="cpu", seed=None)
    tm.load_state_dict(tr.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, v)))
    return jm, v, tm, xin


def _stats(tm):
    return {k: v.numpy() for k, v in tm.state_dict().items()
            if "running" in k}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_train_and_eval_logits_match_jax(block):
    jm, v, tm, x = _pair(block)
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert scale_err(got.detach().numpy(), want) <= 1e-5
    want_eval = jm.apply({"params": v["params"],
                          "batch_stats": upd["batch_stats"]},
                         jnp.asarray(x), train=False)
    got_eval = tm(torch.from_numpy(x), train=False)
    assert scale_err(got_eval.detach().numpy(), want_eval) <= 1e-5


@pytest.mark.parametrize("norm", ["bn", "syncbn"])
def test_norm_layer_stats_and_output_match_jax(norm):
    """One norm layer on the same input: flax's BatchNorm stores the
    biased variance, SyncBatchNorm the unbiased one (n/(n-1) is visible
    at this batch); each twin matches its own reference to 1e-6."""
    x = np.random.RandomState(5).randn(3, 5, 5, 6).astype(np.float32) * 2 \
        + 0.5
    if norm == "bn":
        jl, tl = jr.default_norm(use_running_average=False), \
            tr.default_norm(6, device="cpu")
    else:
        jl, tl = jparallel.SyncBatchNorm(use_running_average=False), \
            SyncBatchNorm(6, device="cpu")
    v = _random_variables(jl, x)
    want, upd = jl.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        tl.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        tl.running_mean.copy_(torch.from_numpy(
            np.array(v["batch_stats"]["mean"])))
        tl.running_var.copy_(torch.from_numpy(
            np.array(v["batch_stats"]["var"])))
    got = tl(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert scale_err(got.permute(0, 2, 3, 1).detach().numpy(), want) <= 1e-6
    assert scale_err(tl.running_mean.numpy(),
                     upd["batch_stats"]["mean"]) <= 1e-6
    assert scale_err(tl.running_var.numpy(),
                     upd["batch_stats"]["var"]) <= 1e-6


@pytest.mark.parametrize("norm", ["bn", "syncbn"])
def test_network_running_stats_match_jax(norm):
    """Every norm's updated statistics after one training forward: the
    stem's norm (one conv upstream) to 1e-6, the rest to the logits'
    1e-5 (their inputs come out of the float32 conv stack)."""
    jm, v, tm, x = _pair("bottleneck", norm=norm)
    _, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm(torch.from_numpy(x), train=True)
    want = tr.resnet_params_from_jax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                               upd["batch_stats"])})
    got = _stats(tm)
    assert set(got) == set(want)
    for k in want:
        tol = 1e-6 if k.startswith("stem_bn.") else 1e-5
        assert scale_err(got[k], want[k].numpy()) <= tol, k


def test_eval_forward_leaves_running_stats():
    _, _, tm, x = _pair()
    before = _stats(tm)
    tm(torch.from_numpy(x), train=False)
    after = _stats(tm)
    assert all(np.array_equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("stem", ["s2d", "s2d_pre"])
def test_s2d_stems_equal_conv_stem_and_jax(stem):
    jm, v, tm, x_conv = _pair("basic", stem="conv")
    conv_logits = tm(torch.from_numpy(x_conv), train=False).detach()
    s2d = tr.ResNet([1, 1], tr.BasicBlock, num_classes=10, width=8,
                    stem=stem, device="cpu", seed=None)
    sd = dict(tm.state_dict())
    sd["stem_conv_s2d.weight"] = tr.stem_to_s2d(sd.pop("stem_conv.weight"))
    s2d.load_state_dict(sd)
    x = tr.s2d_input_transform(x_conv) if stem == "s2d_pre" else x_conv
    got = s2d(torch.from_numpy(x), train=False).detach()
    assert scale_err(got.numpy(), conv_logits.numpy()) <= 1e-5
    # the same folded kernel as the JAX package's, and JAX's s2d model
    k_jax = jr.stem_to_s2d(v["params"]["stem_conv"]["kernel"])
    np.testing.assert_array_equal(
        sd["stem_conv_s2d.weight"].numpy(),
        np.asarray(k_jax).transpose(3, 2, 0, 1))
    jm2 = jr.ResNet(stage_sizes=[1, 1], block=jr.BasicBlock,
                    num_classes=10, width=8, stem=stem)
    p2 = dict(v["params"])
    p2["stem_conv_s2d"] = {"kernel": k_jax}
    del p2["stem_conv"]
    want = jm2.apply({"params": p2, "batch_stats": v["batch_stats"]},
                     jnp.asarray(x), train=False)
    assert scale_err(got.numpy(), want) <= 1e-5


def test_space_to_depth_numpy_and_torch_agree():
    x = np.random.RandomState(2).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jr.s2d_input_transform(x))
    np.testing.assert_array_equal(tr.s2d_input_transform(x), want)
    np.testing.assert_array_equal(
        tr.s2d_input_transform(torch.from_numpy(x)).numpy(), want)


def test_resnet50_logits_match_jax():
    jm = jr.ResNet50(num_classes=10)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    v = _random_variables(jm, x, train=True)
    tm = tr.ResNet50(num_classes=10, device="cpu", seed=None)
    tm.load_state_dict(tr.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, v)))
    want, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    got = tm(torch.from_numpy(x), train=True).detach().numpy()
    assert scale_err(got, want) <= 1e-4


def test_params_from_jax_names_and_layouts():
    jm, v, tm, _ = _pair("bottleneck", norm="syncbn")
    names = jax.tree_util.tree_map(np.asarray, v)
    assert "SyncBatchNorm_0" in names["params"]["Bottleneck_0"]
    sd = tr.resnet_params_from_jax(names)
    assert set(sd) == set(tm.state_dict())
    k = names["params"]["Bottleneck_1"]["Conv_1"]["kernel"]   # HWIO
    np.testing.assert_array_equal(sd["Bottleneck_1.Conv_1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  names["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["Bottleneck_0.BatchNorm_2.running_var"].numpy(),
        names["batch_stats"]["Bottleneck_0"]["SyncBatchNorm_2"]["var"])
    # conv weights live channels_last, as cuDNN takes NHWC
    assert tm.stem_conv.weight.is_contiguous(
        memory_format=torch.channels_last)


@pytest.fixture
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def test_o2_keeps_norms_fp32_and_matches_jax(restore_amp):
    """Under O2 the norms' parameters and statistics stay fp32, the convs
    run in bf16, and the classifier's product runs in fp32 on the
    bf16-rounded fc weights, as the JAX model does."""
    jm, v, tm, x = _pair("bottleneck")
    jmodel, _ = jamp.initialize(jm, __import__("optax").sgd(0.1),
                                opt_level="O2", verbosity=0)
    want, _ = jmodel.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    model, _ = amp.initialize(tm, transforms.sgd(0.1), opt_level="O2",
                              verbosity=0)
    params = model.init()
    compute = model.compute_variables(params)
    assert compute["Bottleneck_0.BatchNorm_0.weight"].dtype == torch.float32
    assert compute["stem_bn.bias"].dtype == torch.float32
    assert compute["Bottleneck_0.Conv_0.weight"].dtype == torch.bfloat16
    assert compute["fc.weight"].dtype == torch.bfloat16
    got = model.apply(params, torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    assert tm.stem_bn.running_var.dtype == torch.float32
    assert scale_err(got.detach().numpy(), np.asarray(want)) <= 2e-2


@pytest.mark.parametrize("arch", ["ResNet18", "ResNet34", "ResNet50",
                                  "ResNet101", "ResNet152"])
def test_full_width_architectures_match_jax(arch):
    """Every parameter and running statistic of the full-width model, by
    name and shape, against the JAX model's variables (their shapes from
    ``jax.eval_shape``: nothing is computed), with SyncBatchNorm too."""
    jm = getattr(jr, arch)(norm=jparallel.SyncBatchNorm)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)), train=True))
    want = {k: tuple(v.shape) for k, v in tr.resnet_params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}
    tm = getattr(tr, arch)(norm=SyncBatchNorm, device="cpu", seed=None)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
