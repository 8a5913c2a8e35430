"""The port's flagship step (``apex_tpu_torch.examples.imagenet_main_amp``
and ``apex_tpu_torch.entry``) against the JAX step on the CPU.

The JAX step is built as ``examples/imagenet/main_amp.py`` builds its
``train_step``, from ``apex_tpu`` pieces, on a tiny ResNet (stages
[1, 1], BasicBlock, width 8, 10 classes, SyncBatchNorm, 32x32 images),
``chain(add_decayed_weights(1e-4), sgd(lr_schedule, 0.9))`` and the
example's schedule (one warmup epoch of 2 steps, so the 3 steps cross
from the warmup into the decay).  Both sides start from the same
weights (``resnet_params_from_jax``) and take the same synthetic bytes.

- O0, 3 steps: losses within 1e-5 relative (float32 on both sides),
  params and running statistics within 1e-4 scale-aware (three SGD steps
  of float32 gradients that sum in different orders);
- O2, 3 steps: losses within 2e-2 absolute (bf16 convs on both sides);
- the overflow step (an inf in the data): params, optimizer state and
  the schedule's count bit for bit, the scale halved, on both sides;
- ``entry.dryrun(2)`` on 2 gloo ranks against the JAX dry run's
  data-parallel step (``__graft_entry__.py``, up to its ZeRO leg) on a
  2-device mesh, FusedAdam's plain version on both sides: O0 losses
  within 1e-5 relative, O2 within 2e-2 absolute.

Rank functions import no JAX: the spawned processes import this file.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import entry
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import imagenet_main_amp as twin
from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.parallel import SyncBatchNorm

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--arch", "resnet18", "--b", "4", "--image-size", "32",
        "--num-classes", "10", "--sync_bn", "--steps-per-epoch", "2",
        "--warmup-epochs", "1", "--print-freq", "0"]
STEPS = 3


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


@pytest.fixture
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_imagenet_main_amp", REPO / "examples/imagenet/main_amp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_side(args, opt_level):
    """(step, params, batch_stats, opt_state, optimizer) of the JAX
    example's train step on the tiny model."""
    import jax
    import jax.numpy as jnp
    import optax
    from apex_tpu import amp, models, parallel

    jmain = _jax_example()
    module = models.resnet.ResNet(stage_sizes=[1, 1],
                                  block=models.resnet.BasicBlock,
                                  num_classes=10, width=8,
                                  norm=parallel.SyncBatchNorm)
    tx = optax.sgd(jmain.lr_schedule(args, args.steps_per_epoch),
                   momentum=args.momentum)
    tx = optax.chain(optax.add_decayed_weights(args.weight_decay), tx)
    model, optimizer = amp.initialize(module, tx, opt_level=opt_level,
                                      verbosity=0)
    variables = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x,
                                             train=True))(
        jnp.ones((1, 32, 32, 3), jnp.float32))
    mean, std = jnp.asarray(jmain.MEAN), jnp.asarray(jmain.STD)

    @jax.jit
    def train_step(params, batch_stats, opt_state, x, y):
        x = (x.astype(jnp.float32) - mean) / std

        def loss_fn(p):
            logits, updates = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            logits = logits.astype(jnp.float32)
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            with amp.scale_loss(loss, opt_state) as scaled:
                return scaled, (loss, updates["batch_stats"])
        grads, (loss, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, new_stats, opt_state, loss

    params = variables["params"]
    return (train_step, params, variables["batch_stats"],
            optimizer.init(params), optimizer, jmain)


def _port_side(args, variables):
    import jax
    module = tr.ResNet([1, 1], tr.BasicBlock, num_classes=10, width=8,
                       norm=SyncBatchNorm, device="cpu", seed=None)
    module.load_state_dict(tr.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    model, optimizer, ddp, params, opt_state = twin.build(
        module, args, args.steps_per_epoch)
    return model, optimizer, ddp, params, opt_state


def _as_port_state(params, batch_stats):
    import jax
    return tr.resnet_params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": batch_stats}))


def _trajectories(opt_level):
    import jax
    args = twin.parse_args(ARGV + ["--opt-level", opt_level])
    step, jp, js, jst, _, jmain = _jax_side(args, opt_level)
    model, opt, ddp, tp, tst = _port_side(
        args, {"params": jp, "batch_stats": js})
    norm = twin.normalizer("cpu")
    jdata = jmain.synthetic_batches(args, args.steps_per_epoch)
    tdata = twin.synthetic_batches(args, args.steps_per_epoch)
    jl, tl = [], []
    for _ in range(STEPS):
        (xj, yj), (xt, yt) = next(jdata), next(tdata)
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)
        jp, js, jst, loss = step(jp, js, jst, xj, yj)
        jl.append(float(loss))
        tp, tst, loss, _, _ = twin.train_step(
            model, opt, ddp, tp, tst, torch.from_numpy(xt),
            torch.from_numpy(yt), norm)
        tl.append(float(loss))
    want = _as_port_state(jp, js)
    got = {**{k: v.detach() for k, v in tp.items()},
           **{k: v for k, v in model.module.state_dict().items()
              if "running" in k}}
    return jl, tl, want, got


def test_o0_trajectory_matches_jax(restore_amp):
    jl, tl, want, got = _trajectories("O0")
    for a, b in zip(tl, jl):
        assert abs(a - b) / abs(b) <= 1e-5, (tl, jl)
    assert set(got) == set(want)
    for k in want:
        assert scale_err(got[k].numpy(), want[k].numpy()) <= 1e-4, k


def test_o2_trajectory_matches_jax(restore_amp):
    jl, tl, _, got = _trajectories("O2")
    assert max(abs(a - b) for a, b in zip(tl, jl)) <= 2e-2, (tl, jl)
    assert got["stem_bn.running_var"].dtype == torch.float32


def test_overflow_step_keeps_every_bit(restore_amp):
    """An inf in the data: the step is skipped on both sides; params,
    the momentum and the schedule's count keep their bits; the scale
    halves."""
    import jax
    args = twin.parse_args(ARGV + ["--opt-level", "O2"])
    step, jp, js, jst, jopt, _ = _jax_side(args, "O2")
    model, opt, ddp, tp, tst = _port_side(
        args, {"params": jp, "batch_stats": js})
    x, y = next(twin.synthetic_batches(args, 1))
    x = x.astype(np.float32)
    x[1, 3, 4, 2] = np.inf
    jp2, _, jst2, _ = step(jp, js, jst, x, y)
    for a, b in zip(jax.tree_util.tree_leaves((jp, jst.inner)),
                    jax.tree_util.tree_leaves((jp2, jst2.inner))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(jopt.loss_scale(jst2)) == float(jopt.loss_scale(jst)) / 2
    assert int(jst2.inner[1][1].count) == 0

    snap = ({k: v.clone() for k, v in tp.items()},
            [t.clone() for t in torch.utils._pytree.tree_leaves(tst.inner)])
    scale0 = float(opt.loss_scale(tst))
    tp2, tst2, loss, _, _ = twin.train_step(
        model, opt, ddp, tp, tst, torch.from_numpy(x), torch.from_numpy(y),
        twin.normalizer("cpu"))
    assert not np.isfinite(float(loss))
    assert all(torch.equal(tp2[k], snap[0][k]) for k in tp2)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(tst2.inner), snap[1]))
    assert int(tst2.inner[1][1].count) == 0
    assert float(opt.loss_scale(tst2)) == scale0 / 2
    assert int(tst2.skipped_steps) == 1


# -- entry.dryrun(2) over two gloo ranks ---------------------------------------

def _dryrun_rank(rank, world, tmpdir):
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        sd = torch.load(os.path.join(tmpdir, "weights.pt"))
        out = {level: entry.dryrun(world, device="cpu", steps=STEPS,
                                   opt_level=level,
                                   state_dict=sd)["losses"]
               for level in ("O0", "O2")}
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_dryrun_losses(variables, opt_level, n=2):
    """``__graft_entry__.dryrun_multichip``'s data-parallel step, without
    its ZeRO leg: GSPMD over an n-device mesh, the batch of 2n ones
    sharded, FusedAdam's plain version."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp, models, optimizers, parallel

    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    tiny = models.resnet.ResNet(stage_sizes=[1, 1],
                                block=models.resnet.BasicBlock,
                                num_classes=10, width=16,
                                norm=parallel.SyncBatchNorm)
    model, optimizer = amp.initialize(
        tiny, optimizers.FusedAdam(lr=1e-3, use_pallas=False),
        opt_level=opt_level, verbosity=0)
    params = model.canonical_variables(variables)["params"]
    batch_stats = variables["batch_stats"]
    opt_state = optimizer.init(params)
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    params, batch_stats, opt_state = jax.device_put(
        (params, batch_stats, opt_state), repl)
    x = jax.device_put(jnp.ones((2 * n, 32, 32, 3), jnp.float32), shard)
    y = jax.device_put(jnp.zeros((2 * n,), jnp.int32), shard)

    @jax.jit
    def train_step(params, batch_stats, opt_state, x, y):
        def loss_fn(p):
            logits, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), y).mean()
            with amp.scale_loss(loss, opt_state) as scaled:
                return scaled, (loss, mut["batch_stats"])
        grads, (loss, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, new_stats, opt_state, loss

    losses = []
    with mesh:
        for _ in range(STEPS):
            params, batch_stats, opt_state, loss = train_step(
                params, batch_stats, opt_state, x, y)
            losses.append(float(loss))
    return losses


def test_dryrun_two_ranks_matches_jax_dp_step(tmp_path, restore_amp):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models, parallel
    tiny = models.resnet.ResNet(stage_sizes=[1, 1],
                                block=models.resnet.BasicBlock,
                                num_classes=10, width=16,
                                norm=parallel.SyncBatchNorm)
    variables = jax.jit(lambda x: tiny.init(jax.random.PRNGKey(0), x,
                                            train=True))(
        jnp.ones((4, 32, 32, 3), jnp.float32))
    torch.save(tr.resnet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)),
        tmp_path / "weights.pt")
    ctx = torch.multiprocessing.start_processes(
        _dryrun_rank, args=(2, str(tmp_path)), nprocs=2, join=False,
        start_method="spawn")
    want0 = _jax_dryrun_losses(variables, "O0")     # while the ranks run
    want2 = _jax_dryrun_losses(variables, "O2")
    while not ctx.join(timeout=300):
        pass
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert ranks[0] == ranks[1]
    for a, b in zip(ranks[0]["O0"], want0):
        assert abs(a - b) / abs(b) <= 1e-5, (ranks[0]["O0"], want0)
    assert max(abs(a - b) for a, b in zip(ranks[0]["O2"], want2)) <= 2e-2, \
        (ranks[0]["O2"], want2)
    # Adam moved the weights: the three losses differ
    assert len(set(ranks[0]["O0"])) == STEPS


def test_dryrun_one_rank_starts_and_ends_its_group(restore_amp):
    out = entry.dryrun(1, device="cpu", steps=2)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert not dist.is_initialized()
    assert int(out["opt_state"].applied_steps) == 2


def test_unported_options_name_the_later_slice():
    """No option is left to a later slice: ``--zero`` trains (ZeRO-1 over
    the world, here a process alone: the same steps bit for bit as
    without it; two ranks in ``tests/test_torch_zero.py``), and
    ``--resume``, ``--checkpoint-dir`` and ``--torch-weights`` parse
    (``tests/test_torch_checkpoint.py``, ``test_torch_resnet_interop.py``)."""
    runs = [twin.train(twin.parse_args(ARGV + flags), device="cpu",
                       steps=2, module=tr.ResNet([1, 1], tr.BasicBlock,
                                                 num_classes=10, width=8,
                                                 device="cpu"))
            for flags in ([], ["--zero"])]
    assert runs[0]["losses"] == runs[1]["losses"]
    for a, b in zip(runs[0]["params"].values(), runs[1]["params"].values()):
        assert torch.equal(a, b)
    for flags in (["--resume", "x"], ["--checkpoint-dir", "x"],
                  ["--torch-weights", "x.pt"], ["--zero"]):
        args = twin.parse_args(ARGV + flags)
        assert vars(args)[flags[0].lstrip("-").replace("-", "_")] in (
            flags[-1], True)


def test_imagefolder_data_names_the_later_slice(tmp_path):
    """ImageFolder ``--data`` is ported: ``train/`` feeds the image
    folder loader (an epoch is its length over ``--b``) and ``val/`` the
    validation pass, each with a short last batch kept."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for split, n in (("train", 5), ("val", 3)):
        for cls in range(2):
            d = tmp_path / split / f"c{cls}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (40, 36, 3),
                                            dtype=np.uint8)).save(
                    d / f"{i}.jpg")
    args = twin.parse_args(ARGV + ["--data", str(tmp_path), "--workers",
                                   "2"])
    train, make_val, steps = twin.make_loaders(args)
    assert steps == 10 // 4
    x, y = next(train)
    assert x.shape == (4, 32, 32, 3) and x.dtype == np.uint8
    assert y.dtype == np.int32
    assert [x.shape[0] for x, _ in make_val()] == [4, 2]


def test_npz_data_and_prefetch(tmp_path):
    """``--data`` with .npz shards: each rank its own rows, through
    ``prefetch_to_device`` on the CPU."""
    from apex_tpu_torch.data import npz_loader, prefetch_to_device, \
        s2d_batches
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (8, 4, 4, 3), dtype=np.uint8)
    y = np.arange(8, dtype=np.int32)
    np.savez(tmp_path / "a.npz", x=x, y=y)
    seen = [set(), set()]
    for shard in range(2):
        it = npz_loader(str(tmp_path), 2, num_shards=2, shard_index=shard)
        for _, (xb, yb) in zip(range(2), prefetch_to_device(it, device="cpu")):
            assert isinstance(xb, torch.Tensor) and xb.shape == (2, 4, 4, 3)
            seen[shard] |= set(yb.tolist())
    assert not seen[0] & seen[1]
    xs, _ = next(s2d_batches(iter([(x, y)])))
    assert xs.shape == (8, 5, 5, 12)


def test_loaders_give_the_jax_package_bytes(tmp_path):
    """``synthetic_loader``, ``npz_loader`` (per shard) and ``s2d_batches``
    yield the JAX package's batches bit for bit."""
    from apex_tpu import data as jdata
    from apex_tpu_torch import data
    for _, (x, y), (xj, yj) in zip(
            range(2), data.synthetic_loader(3, 16, 10, seed=5),
            jdata.synthetic_loader(3, 16, 10, seed=5)):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
    rng = np.random.RandomState(1)
    for i in range(2):
        np.savez(tmp_path / f"s{i}.npz",
                 x=rng.randint(0, 256, (10, 4, 4, 3), dtype=np.uint8),
                 y=np.arange(10, dtype=np.int32) + 10 * i)
    got = data.npz_loader(str(tmp_path), 2, seed=3, num_shards=2,
                          shard_index=1)
    want = jdata.npz_loader(str(tmp_path), 2, seed=3, native=False,
                            num_shards=2, shard_index=1)
    for _, (x, y), (xj, yj) in zip(range(6), got, want):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
    batch = [(rng.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8),
              np.zeros(2, np.int32))]
    np.testing.assert_array_equal(
        next(data.s2d_batches(iter(batch)))[0],
        next(jdata.loaders.s2d_batches(iter(batch)))[0])


def test_prefetch_raises_the_loader_error():
    from apex_tpu_torch.data import prefetch_to_device

    def bad():
        yield (np.zeros(2),)
        raise ValueError("loader broke")

    it = prefetch_to_device(bad(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="loader broke"):
        next(it)
