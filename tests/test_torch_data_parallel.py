"""The BERT and GPT twins' data-parallel steps: two gloo ranks on the
CPU, each with half of a global batch, against one process on the
whole batch, at O0.

- BERT-tiny, 2 steps, each rank 4 rows at ``--grad-accum 2`` (the
  stash reduced once a step, the MLM divisor the global mask count):
  params within 2e-5 scale-aware of one process's plain step on all 8
  rows, the ranks' mean loss equal to its loss within 2e-5;
- GPT-tiny, 2 steps, each rank 2 rows: the same against one process on
  4 rows.

The ranks are spawned once for the module (a ``FileStore`` under the
test's temporary directory).  The rank function imports no JAX: the
spawned processes import this file.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.examples import bert_main_amp as bert
from apex_tpu_torch.examples import gpt_main_amp as gpt

WORLD = 2
STEPS = 2
BERT_ROWS, GPT_ROWS, SEQ = 8, 4, 32


def _global_batches():
    """The global batches, the same on every rank and in the test."""
    bcfg, gcfg = bert.get_config("tiny"), gpt.config("tiny", SEQ)
    b = bert.batches(bcfg, BERT_ROWS, SEQ)
    g = gpt.batches(gcfg.vocab_size, GPT_ROWS, SEQ)
    return ([next(b) for _ in range(STEPS)], [next(g) for _ in range(STEPS)],
            bcfg, gcfg)


def _shard(batches, rank):
    """Rank ``rank``'s contiguous rows of each global batch."""
    def cut(a):
        n = a.shape[0] // WORLD
        return a[rank * n:(rank + 1) * n]
    return iter([tuple(cut(a) for a in b) if isinstance(b, tuple) else cut(b)
                 for b in batches])


def _rank_main(rank, world, tmpdir):
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        bb, gb, bcfg, gcfg = _global_batches()
        out_b = bert.train(bcfg, batch=BERT_ROWS // world, seq_len=SEQ,
                           steps=STEPS, opt_level="O0", device="cpu",
                           grad_accum=2, ddp=True, data=_shard(bb, rank))
        out_g = gpt.train(gcfg, batch=GPT_ROWS // world, seq_len=SEQ,
                          steps=STEPS, opt_level="O0", device="cpu",
                          ddp=True, data=_shard(gb, rank))
        torch.save({name: {"losses": o["losses"],
                           "params": {k: v.detach().clone()
                                      for k, v in o["params"].items()}}
                    for name, o in (("bert", out_b), ("gpt", out_g))},
                   f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    torch.multiprocessing.start_processes(_rank_main,
                                          args=(WORLD, str(tmp)),
                                          nprocs=WORLD, join=True,
                                          start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    bb, gb, bcfg, gcfg = _global_batches()
    return {"bert": bert.train(bcfg, batch=BERT_ROWS, seq_len=SEQ,
                               steps=STEPS, opt_level="O0", device="cpu",
                               data=iter(bb)),
            "gpt": gpt.train(gcfg, batch=GPT_ROWS, seq_len=SEQ, steps=STEPS,
                             opt_level="O0", device="cpu", data=iter(gb))}


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1))


@pytest.mark.parametrize("name", ["bert", "gpt"])
def test_two_ranks_equal_one_process_on_the_whole_batch(ranks, single, name):
    want = single[name]
    mean_loss = np.mean([r[name]["losses"] for r in ranks], axis=0)
    assert scale_err(mean_loss, want["losses"]) < 2e-5
    for k, v in want["params"].items():
        for r in ranks:
            assert scale_err(r[name]["params"][k], v.detach()) < 2e-5, k
    # the ranks hold the same params, bit for bit
    for k in want["params"]:
        assert torch.equal(ranks[0][name]["params"][k],
                           ranks[1][name]["params"][k])
