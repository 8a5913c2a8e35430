"""The port's MLP and ``examples/simple`` twin against the JAX package.

``apex_tpu_torch.models.MLP`` on the JAX ``models.MLP``'s weights
(``mlp_params_from_jax``) gives its fp32 logits to 1e-6 scale-aware.
``apex_tpu_torch.examples.simple_main_amp.train`` on the CPU, at a cut
size (512 samples of ``synthetic_data``, 2 epochs of 2 steps), runs the
JAX example's ``train_step`` on the same data, permutations and initial
weights: O0 losses within 1e-5 relative at every step (fp32 on both
sides, sums in another order), O1 within 2e-2 absolute (bf16 matmuls on
both sides), the same loss scale and the same skipped and applied step
counts.

The twin's O1 installs the port's process-global policy, so
``_no_leaked_o1`` removes both packages' patches and resets the port's
amp state after every test; the last two tests check that it does.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu import models as jax_models
from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import simple_main_amp as simple
from apex_tpu_torch.models import MLP, mlp_params_from_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, EPOCHS = 512, 2


@pytest.fixture(autouse=True)
def _no_leaked_o1():
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


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_simple_main_amp", REPO / "examples/simple/main_amp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("features,in_features", [((1024, 1024), 784),
                                                  ((256, 256), 784),
                                                  ((4,), 12)])
def test_mlp_logits_match_jax(features, in_features):
    rng = np.random.RandomState(0)
    x = rng.randn(3, in_features).astype(np.float32)
    jm = jax_models.MLP(features=features)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    model = MLP(features=features, in_features=in_features, device="cpu",
                seed=None)
    model.load_state_dict(mlp_params_from_jax(params))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert scale_err(got.detach().numpy(), want) <= 1e-6
    # (B, 28, 28) images flatten as flax's reshape does
    img = rng.randn(2, 28, 28).astype(np.float32)
    if in_features == 784:
        assert scale_err(model(torch.from_numpy(img)).detach().numpy(),
                         jm.apply(params, jnp.asarray(img))) <= 1e-6


def test_example_model_and_data_are_the_jax_examples():
    jex = _jax_example()
    x, y = simple.synthetic_data(300, 784, 10, seed=3)
    jx, jy = jex.synthetic_data(300, 784, 10, seed=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    shapes = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: jex.MLP().init(jax.random.PRNGKey(0),
                                              jnp.ones((1, 784)))))
    want = {k: tuple(v.shape) for k, v in mlp_params_from_jax(shapes).items()}
    got = {k: tuple(v.shape) for k, v in
           simple.MLP(device="cpu").state_dict().items()}
    assert got == want
    # seeded weights: normal(0, 1/fan_in), zero biases
    w = simple.MLP(device="cpu", seed=0).Dense_1.weight.detach()
    assert abs(float(w.std()) - 256 ** -0.5) < 0.01
    assert not simple.MLP(device="cpu").Dense_2.bias.any()


def _jax_run(level, x, y):
    """The JAX example's loop, cut to ``EPOCHS`` epochs of ``x``."""
    jex = _jax_example()
    model, optimizer = jamp.initialize(jex.MLP(), optax.sgd(0.05),
                                       opt_level=level, verbosity=0)
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, x.shape[1])))
    init = jax.tree_util.tree_map(np.asarray, params)
    opt_state = optimizer.init(params)

    @jax.jit
    def train_step(params, opt_state, x, y):
        def loss_fn(p):
            logits = model.apply(p, x).astype(jnp.float32)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            with jamp.scale_loss(loss, opt_state) as scaled_loss:
                return scaled_loss, loss
        (_, loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss

    losses, steps = [], x.shape[0] // 256
    for epoch in range(EPOCHS):
        perm = np.random.RandomState(epoch).permutation(x.shape[0])
        for i in range(steps):
            idx = perm[i * 256:(i + 1) * 256]
            params, opt_state, loss = train_step(
                params, opt_state, jnp.asarray(x[idx]), jnp.asarray(y[idx]))
            losses.append(float(loss))
    return init, losses, optimizer, opt_state


@pytest.mark.parametrize("level,tol", [("O0", 1e-5), ("O1", 2e-2)])
def test_train_matches_the_jax_example(level, tol):
    x, y = simple.synthetic_data(N, 784, 10)
    init, want, jopt, jst = _jax_run(level, x, y)
    out = simple.train(level, epochs=EPOCHS, data=(x, y),
                       state_dict=mlp_params_from_jax(init), device="cpu")
    assert len(out["losses"]) == len(want) == EPOCHS * (N // 256)
    for got, ref in zip(out["losses"], want):
        err = abs(got - ref) / (abs(ref) if level == "O0" else 1.0)
        assert err <= tol, (level, out["losses"], want)
    assert out["loss_scale"] == float(jopt.loss_scale(jst))
    assert out["skipped_steps"] == int(jst.skipped_steps)
    assert out["applied_steps"] == int(jst.applied_steps)
    assert len(out["epoch_losses"]) == len(out["samples_per_s"]) == EPOCHS
    assert out["losses"][-1] < out["losses"][0]


def test_train_defaults_to_o1_and_prints_the_example_line(capsys):
    x, y = simple.synthetic_data(N, 784, 10)
    out = simple.train(epochs=1, data=(x, y), device="cpu")
    assert _amp_state._amp_state.opt_properties.opt_level == "O1"
    lines = capsys.readouterr().out.splitlines()
    epoch = [ln for ln in lines if ln.startswith("Epoch 0: loss ")]
    assert len(epoch) == 1 and "samples/s  loss_scale 65536" in epoch[0]
    assert np.isfinite(out["losses"]).all()
    args = simple.parse_args([])
    assert (args.opt_level, args.epochs, args.batch_size, args.lr) == \
        ("O1", 5, 256, 0.05)


def test_train_step_runs_the_policy():
    """Under O1 the first Linear runs bf16, F.cross_entropy computes in
    fp32 on bf16 logits, the probability form of BCE is refused."""
    model, optimizer = amp.initialize(simple.MLP(device="cpu"),
                                      simple.transforms.sgd(0.05),
                                      opt_level="O1", verbosity=0)
    seen = {}
    model.module.Dense_0.register_forward_hook(
        lambda m, a, out: seen.update(dense_0=out.dtype))
    params = model.init()
    st = optimizer.init(params)
    x, y = (torch.from_numpy(a) for a in simple.synthetic_data(8, 784, 10))
    params, st, loss = simple.train_step(model, optimizer, params, st, x, y)
    assert seen["dense_0"] == torch.bfloat16
    assert loss.dtype == torch.float32
    assert F.cross_entropy(torch.ones(2, 3, dtype=torch.bfloat16),
                           torch.zeros(2, dtype=torch.int64)).dtype == \
        torch.float32
    with pytest.raises(RuntimeError, match="with_logits"):
        F.binary_cross_entropy(torch.full((2,), 0.5), torch.ones(2))


def test_mnist_npz(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.randint(0, 256, (512, 28, 28), np.uint8),
             y_train=rng.randint(0, 10, 512).astype(np.uint8))
    x, y = simple.load_data(str(path))
    assert x.shape == (512, 784) and x.dtype == np.float32
    assert float(x.max()) <= 1.0 and y.dtype == np.int32
    out = simple.train("O0", epochs=1, data=(x, y), device="cpu")
    assert len(out["losses"]) == 2


def test_o1_left_active_on_purpose():
    """Leaves the twin's O1 policy installed and active; the next test
    checks the fixture removed it."""
    x, y = simple.synthetic_data(256, 784, 10)
    simple.train(epochs=1, data=(x, y), device="cpu")
    assert hasattr(torch.sum, "__amp_original__")
    assert _amp_state._amp_state.opt_properties is not None


def test_fixture_removed_the_leaked_o1():
    for fn in (torch.sum, F.softmax, torch.einsum):
        assert not hasattr(fn, "__amp_original__"), fn
    assert _amp_state._amp_state.opt_properties is None
    assert torch.sum(torch.ones(2, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
