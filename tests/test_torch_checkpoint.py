"""The port's train-state checkpoint (``apex_tpu_torch.utils.checkpoint``)
as ``tests/L0/test_checkpoint.py`` checks the JAX one (its first four
tests), and the ImageNet twin's ``--checkpoint-dir`` and ``--resume``.

- the amp train state (params, ``AmpOptimizerState`` with its scaler,
  the optax-twin state, the epoch) round-trips bit for bit at O2 and at
  O3, whose params are bfloat16 (stored as raw bits);
- training from a restored state equals training on, bit for bit, over
  three steps;
- a target of another structure raises; the leaf-count error names the
  path and both counts, as the JAX package's does;
- the payload is the JAX package's: the same tree saved by both gives
  the same ``leaf_i`` arrays in ``train_state.npz``;
- ResNet-18 at 32 px, 2 epochs of 2 steps: one epoch saved with
  ``--checkpoint-dir``, then ``--resume`` for the second, equals two
  epochs in one run, bit for bit, running statistics, optimizer and
  scaler state, epoch and best prec@1 included.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import imagenet_main_amp as twin
from apex_tpu_torch.models import MLP
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def _train_state(opt_level="O2", steps=3):
    model, optimizer = amp.initialize(
        MLP(features=(32,), in_features=16, device="cpu"),
        transforms.sgd(0.1, momentum=0.9), opt_level=opt_level,
        verbosity=0)
    params = model.init()
    opt_state = optimizer.init(params)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 16, generator=gen)
    y = torch.arange(8) % 10

    def step(params, opt_state):
        logits = model.apply(params, x).float()
        loss = torch.nn.functional.cross_entropy(logits, y)
        with amp.scale_loss(loss, opt_state) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()))
        params, opt_state = optimizer.step(
            params, dict(zip(params, grads)), opt_state)
        return params, opt_state, loss.detach()

    for _ in range(steps):
        params, opt_state, _ = step(params, opt_state)
    return model, optimizer, params, opt_state, step


def _assert_trees_equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for xa, xb in zip(la, lb):
        if isinstance(xa, torch.Tensor):
            assert xa.dtype == xb.dtype and xa.shape == xb.shape
            assert torch.equal(xa, xb)
        else:
            assert xa == xb and type(xa) is type(xb)


@pytest.mark.parametrize("opt_level", ["O2", "O3"])
def test_roundtrip_preserves_amp_state(tmp_path, opt_level):
    model, optimizer, params, opt_state, _ = _train_state(opt_level)
    if opt_level == "O3":
        assert all(p.dtype == torch.bfloat16 for p in params.values())
    checkpoint.save(str(tmp_path / "ckpt"),
                    {"params": params, "opt_state": opt_state, "epoch": 4})
    target = {"params": model.init(), "opt_state": optimizer.init(params),
              "epoch": 0}
    restored = checkpoint.restore(str(tmp_path / "ckpt"), target)
    _assert_trees_equal(restored["params"], params)
    _assert_trees_equal(restored["opt_state"], opt_state)
    assert restored["epoch"] == 4
    scaler = restored["opt_state"].loss_scalers[0]
    assert scaler.overflow.dtype == torch.bool
    assert scaler.unskipped.dtype == torch.int32
    assert all(p.requires_grad for p in restored["params"].values())
    # without a target: nested dicts and lists of the same bits
    plain = checkpoint.restore(str(tmp_path / "ckpt"))
    assert torch.equal(plain["params"]["Dense_0.weight"],
                       params["Dense_0.weight"])
    assert torch.equal(plain["opt_state"]["loss_scalers"][0]["loss_scale"],
                       opt_state.loss_scalers[0].loss_scale)


def test_training_continues_identically(tmp_path):
    model, optimizer, params, opt_state, step = _train_state()
    checkpoint.save(str(tmp_path / "c"),
                    {"params": params, "opt_state": opt_state})
    restored = checkpoint.restore(
        str(tmp_path / "c"),
        {"params": model.init(), "opt_state": optimizer.init(params)})
    p1, s1, p2, s2 = params, opt_state, restored["params"], \
        restored["opt_state"]
    for _ in range(3):
        p1, s1, loss1 = step(p1, s1)
        p2, s2, loss2 = step(p2, s2)
        assert torch.equal(loss1, loss2)
    _assert_trees_equal(p1, p2)
    _assert_trees_equal(s1, s2)


def test_structure_mismatch_raises(tmp_path):
    _, optimizer, params, opt_state, _ = _train_state(steps=1)
    checkpoint.save(str(tmp_path / "c"), {"params": params})
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path / "c"),
                           {"params": params, "extra": opt_state})


def test_leaf_count_mismatch_names_path_and_counts(tmp_path):
    from apex_tpu.utils import checkpoint as jax_checkpoint
    path = str(tmp_path / "c")
    checkpoint.save(path, {"a": torch.ones(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError) as exc:
        checkpoint.restore(path, {"a": torch.ones(3), "b": torch.zeros(2),
                                  "c": torch.zeros(1)})
    msg = str(exc.value)
    assert path in msg and "2 leaves" in msg and "3" in msg
    # the JAX package's message, word for word, on its npz backend
    jpath = str(tmp_path / "j")
    saved = jax_checkpoint._ocp
    jax_checkpoint._ocp = None
    try:
        jax_checkpoint.save(jpath, {"a": np.ones(3), "b": np.zeros(2)})
        with pytest.raises(ValueError) as jexc:
            jax_checkpoint.restore(jpath, {"a": np.ones(3),
                                           "b": np.zeros(2),
                                           "c": np.zeros(1)})
    finally:
        jax_checkpoint._ocp = saved
    assert msg == str(jexc.value).replace(jpath, path)


def test_payload_matches_the_jax_package(tmp_path):
    from apex_tpu.utils import checkpoint as jax_checkpoint
    rng = np.random.RandomState(0)
    tree = {"b": rng.randn(3, 2).astype(np.float32),
            "a": {"x": np.arange(4, dtype=np.int32), "y": np.float32(2.5)}}
    checkpoint.save(str(tmp_path / "p"), pytree.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), tree))
    saved = jax_checkpoint._ocp
    jax_checkpoint._ocp = None
    try:
        jax_checkpoint.save(str(tmp_path / "j"), tree)
    finally:
        jax_checkpoint._ocp = saved
    with np.load(tmp_path / "p" / checkpoint.NPZ_FILE) as got, \
            np.load(tmp_path / "j" / checkpoint.NPZ_FILE) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


ARGV = ["--arch", "resnet18", "--b", "4", "--image-size", "32",
        "--num-classes", "10", "--steps-per-epoch", "2", "--val-steps", "1",
        "--warmup-epochs", "1", "--print-freq", "0"]


def test_imagenet_resume_continues_the_saved_run(tmp_path):
    args = twin.parse_args(ARGV + ["--epochs", "2"])
    data = [b for _, b in zip(range(4), twin.synthetic_batches(args, 2))]
    one = os.path.join(tmp_path, "one")
    two = os.path.join(tmp_path, "two")
    straight = twin.train(twin.parse_args(
        ARGV + ["--epochs", "2", "--checkpoint-dir", one]), device="cpu",
        batches=data)
    first = twin.train(twin.parse_args(
        ARGV + ["--epochs", "1", "--checkpoint-dir", two]), device="cpu",
        batches=data[:2])
    resumed = twin.train(twin.parse_args(
        ARGV + ["--epochs", "2", "--resume", os.path.join(two, "last"),
                "--checkpoint-dir", two]), device="cpu", batches=data[2:])
    assert resumed["start_epoch"] == 1 and first["start_epoch"] == 0
    assert resumed["losses"] == straight["losses"][2:]
    assert first["losses"] == straight["losses"][:2]
    for key in ("params", "opt_state"):
        _assert_trees_equal(resumed[key], straight[key])
    _assert_trees_equal(
        dict(resumed["model"].unwrapped.named_buffers()),
        dict(straight["model"].unwrapped.named_buffers()))
    _assert_trees_equal(checkpoint.restore(os.path.join(two, "last")),
                        checkpoint.restore(os.path.join(one, "last")))
    saved = checkpoint.restore(os.path.join(one, "last"))
    assert saved["epoch"] == 1
    assert saved["best_prec1"] == straight["best_prec1"]
