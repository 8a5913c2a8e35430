"""The port's data-parallel reduction (``apex_tpu_torch.parallel``)
against the closed forms of ``tests/distributed/test_ddp.py`` and the
JAX ``DistributedDataParallel`` on a 4-device mesh, across real
processes.

Four gloo ranks on the CPU (spawned once for the module, a ``FileStore``
under the test's temporary directory).  Rank r's gradient is r + 1
everywhere, so over 4 ranks the mean is 2.5 and the sum 10.0 (the JAX
test's 4.5 and 36.0 are its 8 devices' values); every result is exact.
Also: bf16 gradients reduced in fp32 and returned in bf16, buckets
smaller than the tree (``message_size``) giving the leaf-by-leaf
result, ``Reducer``, ``broadcast_params`` from rank 0, groups of 2
(means 1.5 and 3.5), a bad group size raising, ``all_gather_tree``;
and the launcher and ``initialize_distributed``.

The rank function imports no JAX: the spawned processes import this
file.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
WORLD = 4


def _grads(rank, dtype=torch.float32):
    return {"w": torch.full((4,), rank + 1.0, dtype=dtype),
            "b": torch.full((3, 2), rank + 1.0, dtype=dtype)}


def _rank_main(rank, world, tmpdir):
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        g = _grads(rank)
        out = {
            "mean": parallel.DistributedDataParallel().reduce_gradients(g),
            "sum": parallel.DistributedDataParallel(
                gradient_average=False).reduce_gradients(g),
            "predivide": parallel.DistributedDataParallel(
                gradient_predivide_factor=4.0).reduce_gradients(g),
            "predivide_sum": parallel.DistributedDataParallel(
                gradient_predivide_factor=4.0,
                gradient_average=False).reduce_gradients(g),
            "small_buckets": parallel.DistributedDataParallel(
                message_size=5).reduce_gradients(g),
            "reducer": parallel.Reducer().reduce(g),
            "broadcast": parallel.broadcast_params(
                {"w": torch.arange(3.0) + 10.0 * rank}),
            "gather": parallel.all_gather_tree({"w": torch.tensor([rank])}),
            "gather_tiled": parallel.all_gather_tree(
                {"w": torch.tensor([rank, -rank])}, tiled=True),
        }
        bf16 = _grads(rank, torch.bfloat16)
        bf16["w"] = bf16["w"] * 1.001
        out["bf16_fp32"] = parallel.DistributedDataParallel(
            allreduce_always_fp32=True).reduce_gradients(bf16)
        groups = parallel.create_syncbn_process_group(2)
        out["groups"] = parallel.DistributedDataParallel(
            process_group=groups).reduce_gradients(g)
        out["group_broadcast"] = parallel.broadcast_params(
            {"w": torch.tensor([float(rank)])}, groups, src=1)
        try:
            parallel.create_process_group(3)
            out["bad_group"] = "no error"
        except ValueError as e:
            out["bad_group"] = str(e)
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    torch.multiprocessing.start_processes(_rank_main,
                                          args=(WORLD, str(tmp)),
                                          nprocs=WORLD, join=True,
                                          start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _all(ranks, case, key, value):
    for r in range(WORLD):
        t = ranks[r][case][key]
        assert torch.equal(t, torch.full_like(t, value)), (case, r, t)


def _jax_reduce(values, **kw):
    """The JAX DDP's ``reduce_gradients`` over 4 devices on per-device
    scalars ``values``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    ddp = JDDP(process_group="data", **kw)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    f = jax.shard_map(lambda g: ddp.reduce_gradients({"w": g[0]})["w"],
                      mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    return np.asarray(f(jnp.asarray(values).reshape(WORLD, 1)))


def test_mean(ranks):
    _all(ranks, "mean", "w", 2.5)
    _all(ranks, "mean", "b", 2.5)
    np.testing.assert_array_equal(_jax_reduce(np.arange(1.0, 5.0)), 2.5)


def test_sum(ranks):
    _all(ranks, "sum", "w", 10.0)
    np.testing.assert_array_equal(
        _jax_reduce(np.arange(1.0, 5.0), gradient_average=False), 10.0)


def test_predivide_keeps_the_mean(ranks):
    _all(ranks, "predivide", "w", 2.5)
    _all(ranks, "predivide_sum", "w", 2.5)   # sum of (r + 1) / 4, no post
    np.testing.assert_array_equal(
        _jax_reduce(np.arange(1.0, 5.0), gradient_predivide_factor=4.0,
                    gradient_average=False), 2.5)


def test_buckets_equal_leaf_by_leaf(ranks):
    for r in range(WORLD):
        for k in ("w", "b"):
            assert torch.equal(ranks[r]["small_buckets"][k],
                               ranks[r]["mean"][k])


def test_bf16_reduced_in_fp32(ranks):
    """The fp32 mean of the four bf16 values, rounded to bf16 once."""
    vals = [(torch.tensor(q + 1.0, dtype=torch.bfloat16) * 1.001).float()
            for q in range(WORLD)]
    expect = (sum(vals) * (1.0 / WORLD)).bfloat16()
    for r in range(WORLD):
        w = ranks[r]["bf16_fp32"]["w"]
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, torch.full_like(w, expect))


def test_reducer(ranks):
    _all(ranks, "reducer", "w", 2.5)


def test_broadcast_from_rank0(ranks):
    for r in range(WORLD):
        assert torch.equal(ranks[r]["broadcast"]["w"], torch.arange(3.0))


def test_groups_of_two(ranks):
    """Groups {0, 1} and {2, 3}: means 1.5 and 3.5."""
    for r in range(WORLD):
        w = ranks[r]["groups"]["w"]
        assert torch.equal(w, torch.full_like(w, 1.5 if r < 2 else 3.5))
    # src=1 within each group: ranks 1 and 3 broadcast
    for r in range(WORLD):
        want = 1.0 if r < 2 else 3.0
        assert ranks[r]["group_broadcast"]["w"].item() == want


def test_bad_group_size_raises(ranks):
    for r in range(WORLD):
        assert "must evenly divide" in ranks[r]["bad_group"]
    with pytest.raises(ValueError, match="evenly divide"):
        parallel.create_process_group(3, world_size=8)


def test_all_gather_tree(ranks):
    for r in range(WORLD):
        assert torch.equal(ranks[r]["gather"]["w"],
                           torch.arange(WORLD).reshape(WORLD, 1))
        assert torch.equal(ranks[r]["gather_tiled"]["w"],
                           torch.tensor([0, 0, 1, -1, 2, -2, 3, -3]))


def test_world_of_one_without_a_group():
    """No process group: a world of one, the identity reduction."""
    g = {"w": torch.full((2,), 3.0)}
    out = parallel.DistributedDataParallel(
        gradient_predivide_factor=2.0).reduce_gradients(g)
    assert torch.equal(out["w"], g["w"])


def test_ddp_simple_example_trains_on_the_cpu():
    from apex_tpu_torch.examples import ddp_simple
    args = ddp_simple.parse_args(["--iters", "4", "--b", "16",
                                  "--allreduce-always-fp32",
                                  "--gradient-predivide-factor", "2"])
    losses = ddp_simple.run(args, device="cpu")
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    # --zero2 trains too (a process alone here; two ranks in
    # tests/test_torch_zero.py)
    zero2 = ddp_simple.run(ddp_simple.parse_args(
        ["--iters", "4", "--b", "16", "--zero2"]), device="cpu")
    assert len(zero2) == 4 and np.all(np.isfinite(zero2))
    assert zero2[0] == losses[0] and zero2[1:] != losses[1:]


def test_initialize_distributed_refuses_a_world_without_address(
        monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multiproc.initialize_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multiproc.initialize_distributed("cpu") == 0
    assert not dist.is_initialized()


def test_launcher_runs_two_ranks_over_gloo(tmp_path):
    """``python -m apex_tpu_torch.parallel.multiproc script``: two ranks
    bootstrap from the environment and all-reduce."""
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import torch, torch.distributed as dist
        from apex_tpu_torch.parallel import initialize_distributed, psum_g
        rank = initialize_distributed("cpu")
        total = psum_g(torch.tensor([rank + 1.0]))
        print("sum", int(total.item()), "of", dist.get_world_size())
        dist.destroy_process_group()
    """))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(multiproc.free_port()),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         str(script)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "sum 3 of 2" in out.stdout
    assert "sum 3 of 2" in (tmp_path / "PROC_1.log").read_text()

