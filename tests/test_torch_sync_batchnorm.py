"""The port's SyncBatchNorm (``apex_tpu_torch.parallel.sync_batchnorm``)
against the JAX SyncBatchNorm, across real processes.

Four gloo ranks on the CPU (spawned once for the module, a ``FileStore``
under the test's temporary directory) run three cases, each a forward of
``sum(y ** 3)`` and its backward on their own rows:
- the world of 4 with unequal counts (2, 3, 4 and 5 rows);
- ``create_syncbn_process_group(2)`` groups {0, 1} and {2, 3} with equal
  counts, against the JAX SyncBatchNorm under ``shard_map`` with the same
  process groups on the same shards;
- the same groups with unequal counts (3 and 5, 2 and 6).
The JAX oracle of an unequal case is its SyncBatchNorm on the group's
rows together (statistics over all of them, which is what the merge
computes).  Forward, running statistics, input gradients (of the sum of
every rank's loss) and weight gradients (summed over the group's ranks)
within 1e-5 scale-aware.  ``welford_combine`` and ``merge_stats``
against the JAX package's within 1e-6 relative.

The rank function imports no JAX: the spawned processes import this
file.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.models import resnet as tr
from apex_tpu_torch.parallel import (
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
    merge_stats,
    welford_combine,
)

C = 6
TOL = 1e-5
UNEQUAL = (2, 3, 4, 5)             # the world of 4
GROUPED_EQUAL = (4, 4, 4, 4)       # groups {0, 1}, {2, 3}
GROUPED_UNEQUAL = (3, 5, 2, 6)


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


def _data(counts, seed):
    x = np.random.RandomState(seed).randn(sum(counts), 3, 3, C) \
        .astype(np.float32) * 1.5 + 0.25
    rng = np.random.RandomState(seed + 100)
    scale = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    return x, scale, bias


def _rows(counts, rank):
    start = sum(counts[:rank])
    return slice(start, start + counts[rank])


def _run_case(rank, counts, seed, group):
    x, scale, bias = _data(counts, seed)
    bn = SyncBatchNorm(C, process_group=group, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xr = torch.from_numpy(x[_rows(counts, rank)]).permute(0, 3, 1, 2) \
        .requires_grad_(True)
    y = bn(xr)
    (y ** 3).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": xr.grad.permute(0, 2, 3, 1).numpy(),
            "dscale": bn.weight.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _rank_main(rank, world, tmpdir):
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        out = {"unequal": _run_case(rank, UNEQUAL, 0, None)}
        groups = create_syncbn_process_group(2)
        out["grouped_equal"] = _run_case(rank, GROUPED_EQUAL, 1, groups)
        out["grouped_unequal"] = _run_case(rank, GROUPED_UNEQUAL, 2, groups)
        np.save(os.path.join(tmpdir, f"rank{rank}.npy"), out,
                allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    torch.multiprocessing.start_processes(_rank_main, args=(4, str(tmp)),
                                          nprocs=4, join=True,
                                          start_method="spawn")
    return [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item()
            for r in range(4)]


def _jax_local(x, scale, bias):
    """The JAX SyncBatchNorm on rows ``x`` together: y, the gradients of
    sum(y^3) and the updated running statistics."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.parallel import SyncBatchNorm as JSyncBN
    bn = JSyncBN(use_running_average=False)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]},
                          x, mutable=["batch_stats"])
        return jnp.sum(y ** 3), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "dscale": np.asarray(gp["scale"]), "dbias": np.asarray(gp["bias"]),
            "mean": np.asarray(stats["mean"]), "var": np.asarray(stats["var"])}


def _check_group(ranks, case, members, counts, want):
    for key in ("y", "dx"):
        got = np.concatenate([ranks[r][case][key] for r in members])
        assert scale_err(got, want[key]) <= TOL, (case, key)
    for key in ("dscale", "dbias"):
        got = sum(ranks[r][case][key] for r in members)
        assert scale_err(got, want[key]) <= TOL, (case, key)
    for r in members:
        for key in ("mean", "var"):
            assert scale_err(ranks[r][case][key], want[key]) <= TOL, \
                (case, key, r)


def test_world_of_four_unequal_counts(ranks):
    x, scale, bias = _data(UNEQUAL, 0)
    _check_group(ranks, "unequal", range(4), UNEQUAL,
                 _jax_local(x, scale, bias))


def test_groups_of_two_unequal_counts(ranks):
    x, scale, bias = _data(GROUPED_UNEQUAL, 2)
    for members in ((0, 1), (2, 3)):
        rows = slice(sum(GROUPED_UNEQUAL[:members[0]]),
                     sum(GROUPED_UNEQUAL[:members[1] + 1]))
        _check_group(ranks, "grouped_unequal", members, GROUPED_UNEQUAL,
                     _jax_local(x[rows], scale, bias))


def test_groups_of_two_match_jax_shard_map(ranks):
    """The JAX SyncBatchNorm with ``create_process_group("data", 2)`` under
    ``shard_map`` over 4 devices, the rows sharded as the ranks hold
    them (the pattern of ``tests/distributed/test_syncbn.py``)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu.parallel import SyncBatchNorm as JSyncBN
    from apex_tpu.parallel import create_process_group

    x, scale, bias = _data(GROUPED_EQUAL, 1)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    pg = create_process_group("data", group_size=2, world_size=4)
    bn = JSyncBN(use_running_average=False, axis_name="data",
                 process_group=pg)
    v = JSyncBN(use_running_average=False).init(jax.random.PRNGKey(0),
                                                jnp.asarray(x))
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(), P("data")),
                       out_specs=(P(), P("data"), P("data")))
    def sharded(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]},
                          x, mutable=["batch_stats"])
        loss = jax.lax.psum(jnp.sum(y ** 3), "data")
        st = upd["batch_stats"]
        return loss, y, jnp.stack([st["mean"], st["var"]])[None]

    def loss_fn(p, x):
        loss, y, st = sharded(p, x)
        return loss, (y, st)

    (_, (y, st)), (gp, gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    got_y = np.concatenate([ranks[r]["grouped_equal"]["y"]
                            for r in range(4)])
    got_dx = np.concatenate([ranks[r]["grouped_equal"]["dx"]
                             for r in range(4)])
    assert scale_err(got_y, y) <= TOL
    assert scale_err(got_dx, gx) <= TOL
    # the JAX weight gradient sums the whole world's losses
    for key, want in (("dscale", gp["scale"]), ("dbias", gp["bias"])):
        got = sum(ranks[r]["grouped_equal"][key] for r in range(4))
        assert scale_err(got, want) <= TOL, key
    for r in range(4):
        assert scale_err(ranks[r]["grouped_equal"]["mean"],
                         np.asarray(st)[r, 0]) <= TOL
        assert scale_err(ranks[r]["grouped_equal"]["var"],
                         np.asarray(st)[r, 1]) <= TOL


def test_welford_combine_matches_jax():
    import jax.numpy as jnp
    from apex_tpu.parallel import welford_combine as jwc
    rng = np.random.RandomState(1)
    a, b = rng.randn(40, 3), rng.randn(24, 3)
    args = (a.mean(0), a.var(0) * len(a), float(len(a)),
            b.mean(0), b.var(0) * len(b), float(len(b)))
    want = jwc(*(jnp.asarray(np.float32(v)) for v in args))
    got = welford_combine(*(torch.tensor(np.float32(v)) for v in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    full = np.concatenate([a, b])
    np.testing.assert_allclose(got[0].numpy(), full.mean(0), rtol=1e-5)


def test_merge_stats_matches_jax():
    import jax.numpy as jnp
    from apex_tpu.parallel import merge_stats as jms
    rng = np.random.RandomState(2)
    chunks = [rng.randn(10 + 3 * i, 5) for i in range(8)]
    means = np.stack([c.mean(0) for c in chunks]).astype(np.float32)
    variances = np.stack([c.var(0) for c in chunks]).astype(np.float32)
    counts = np.array([float(len(c)) for c in chunks], np.float32)
    want = jms(jnp.asarray(means), jnp.asarray(variances),
               jnp.asarray(counts))
    got = merge_stats(torch.from_numpy(means), torch.from_numpy(variances),
                      torch.from_numpy(counts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert float(got[2].max()) == sum(len(c) for c in chunks)


def test_world_of_one_is_local():
    """No process group: the statistics are this process's, as the JAX
    SyncBatchNorm's with ``axis_name=None``."""
    x, scale, bias = _data((7,), 3)
    got = _run_case(0, (7,), 3, None)
    want = _jax_local(x, scale, bias)
    for key in want:
        assert scale_err(got[key], want[key]) <= TOL, key


def test_convert_syncbn_model_module_tree():
    """Surgery on a module tree: torch BatchNorm2d and the port's
    flax-like BatchNorm become SyncBatchNorm with their parameters,
    statistics and momentum (torch convention)."""
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4, momentum=0.2),
        torch.nn.Sequential(tr.BatchNorm(4, momentum=0.9, device="cpu")))
    with torch.no_grad():
        net[1].weight.fill_(2.0)
        net[1].running_mean.fill_(0.5)
        net[2][0].bias.fill_(-1.0)
    out = convert_syncbn_model(net)
    assert out is net
    assert isinstance(net[1], SyncBatchNorm) and net[1].momentum == 0.2
    assert isinstance(net[2][0], SyncBatchNorm)
    assert net[2][0].momentum == pytest.approx(0.1)
    assert torch.all(net[1].weight == 2.0)
    assert torch.all(net[1].running_mean == 0.5)
    assert torch.all(net[2][0].bias == -1.0)
    y = net(torch.randn(2, 3, 5, 5))
    assert y.shape == (2, 4, 3, 3)


def test_convert_syncbn_model_norm_factory():
    """A ResNet built with ``default_norm`` (flax momentum 0.9): every norm
    is converted, and its ``norm`` factory makes SyncBatchNorm at torch
    momentum 0.1, as the JAX conversion of the factory does."""
    model = tr.ResNet([1, 1], tr.BasicBlock, num_classes=10, width=8,
                      device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 16, 3)
                         .astype(np.float32))
    want = model(x, train=False)
    convert_syncbn_model(model)
    norms = [m for m in model.modules()
             if isinstance(m, (SyncBatchNorm, tr.BatchNorm))]
    assert norms and all(isinstance(m, SyncBatchNorm) for m in norms)
    assert all(m.momentum == pytest.approx(0.1) for m in norms)
    made = model.norm(4, device="cpu")
    assert isinstance(made, SyncBatchNorm)
    assert made.momentum == pytest.approx(0.1)
    assert "BasicBlock_0.BatchNorm_0.weight" in dict(
        model.named_parameters())
    # eval mode reads the carried running statistics: the same function
    got = model(x, train=False)
    assert scale_err(got.detach().numpy(), want.detach().numpy()) <= 1e-6
