"""PipelinedGPT in apex_tpu_torch against apex_tpu's.

GPT-tiny with 4 layers (vocab 256, hidden 128, 4 heads, MLP 256),
batch 8, sequence 16, 2 microbatches, run by gloo ranks, one stage a
rank, at pp 2 and at (dp 2, pp 2), against the JAX ``PipelinedGPT`` on
the conftest's CPU mesh of the same shape, from the JAX model's initial
params (``params_from_jax(..., rank=r)``), fp32 within 1e-5
scale-aware:

- GPipe (``forward``): the logits;
- 1F1B (``loss_and_grad_1f1b``) without a mask: the loss and every
  gradient, the tied ``wte``'s the sum of its lookup's and the LM
  head's;
- 1F1B with a heavily skewed padding mask (valid lengths 15, 2, 9, 5,
  16, 1, 12, 3, the JAX oracle's
  ``test_pipelined_gpt_1f1b_mask_skewed_padding_exact``): each
  microbatch's masked sum over the global denominator ``total_keep / (M
  * n_dp)`` gives the global masked mean exactly, at pp 2 and with the
  data axis (a data index's loss and gradients, meaned over the data
  group by ``DistributedDataParallel``), where the mean of the
  microbatches' own masked means is off by more than the tolerance.

The ranks are spawned once for each mesh (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.models import gpt as tg

B, S, M, PP = 8, 16, 2, 2
TOL = 1e-5
SPAWN_LIMIT = 120.0
LENS = [15, 2, 9, 5, 16, 1, 12, 3]


def _cfg():
    return tg.GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=4,
                        num_attention_heads=4, intermediate_size=256,
                        max_position_embeddings=S, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)


def _batch():
    ids = np.random.RandomState(0).randint(0, 256, (B, S)).astype(np.int32)
    mask = np.stack([np.pad(np.ones(n, np.int32), (0, S - n))
                     for n in LENS])
    return ids, mask


def rel_err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


# -- the ranks ---------------------------------------------------------------

def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        dp = world // PP
        mesh = parallel.create_mesh(pp=PP)
        d, r = mesh.index("data"), mesh.index("pipe")
        model = tg.PipelinedGPT(_cfg(), mesh, PP, M,
                                batch_axis="data" if dp > 1 else None,
                                device="cpu", seed=None)
        model.load_state_dict(torch.load(f"{tmpdir}/init.pt")[r])
        ids, mask = _batch()
        n = B // dp
        ids = torch.from_numpy(ids[d * n:(d + 1) * n])
        mask = torch.from_numpy(mask[d * n:(d + 1) * n])
        out = {}
        if dp == 1:
            out["logits"] = model(ids).detach()
            out["plain"] = model.loss_and_grad_1f1b(ids, ids)
        loss, grads = model.loss_and_grad_1f1b(ids, ids,
                                               attention_mask=mask)
        # the data index's loss and grads, meaned over the data group as
        # the JAX method returns them
        mean = parallel.DistributedDataParallel(
            process_group=mesh.group("data")).reduce_gradients(
                {"loss": loss.reshape(1), **grads})
        out["masked"] = (mean.pop("loss")[0], mean)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jcfg():
    from apex_tpu import models as jm
    c = _cfg()
    return jm.GPTConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})


def _jmodel(world):
    import jax
    from apex_tpu import models as jm
    from jax.sharding import Mesh
    dp = world // PP
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(dp, PP),
                ("data", "pipe"))
    return jm.PipelinedGPT(_jcfg(), mesh, pp=PP, num_microbatches=M,
                           batch_axis="data" if dp > 1 else None), mesh


@pytest.fixture(scope="module")
def jax_init():
    import jax
    pg, _ = _jmodel(PP)
    v = pg.init(jax.random.PRNGKey(1), _batch()[0])
    return jax.tree.map(np.asarray, v["params"])


_RANKS = {}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    def get(world):
        if world in _RANKS:
            return _RANKS[world]
        tmp = tmp_path_factory.mktemp(f"pg{world}")
        torch.save([tg.params_from_jax(jax_init, _cfg(), rank=r)
                    for r in range(PP)], tmp / "init.pt")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, str(tmp)), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + SPAWN_LIMIT
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {world} ranks did not finish in time")
        _RANKS[world] = [torch.load(tmp / f"rank{r}.pt")
                         for r in range(world)]
        return _RANKS[world]
    return get


def _check_grads(got, jax_grads, r, label):
    import jax
    want = tg.params_from_jax(jax.tree.map(np.asarray, jax_grads), _cfg(),
                              rank=r)
    assert set(got) == set(want), label
    for k in want:
        err = rel_err(got[k], want[k])
        assert err <= TOL, f"{label} {k}: {err:.3g}"


def test_gpipe_logits_match_jax(spawned, jax_init):
    import jax
    pg, mesh = _jmodel(PP)
    with mesh:
        want = jax.jit(lambda p, i: pg.apply({"params": p}, i))(
            jax_init, _batch()[0])
    for r, o in enumerate(spawned(PP)):
        assert rel_err(o["logits"], want) <= TOL, r


def test_onef1b_tied_wte_matches_jax(spawned, jax_init):
    import jax
    pg, mesh = _jmodel(PP)
    ids = _batch()[0]
    with mesh:
        loss, g = jax.jit(lambda v, i: pg.loss_and_grad_1f1b(v, i, i))(
            {"params": jax_init}, ids)
    for r, o in enumerate(spawned(PP)):
        got_loss, got = o["plain"]
        assert rel_err(got_loss, loss) <= TOL
        _check_grads(got, g, r, f"rank {r}")


@pytest.mark.parametrize("world", [2, 4], ids=["pp2", "dp2pp2"])
def test_onef1b_skewed_padding_matches_jax(spawned, jax_init, world):
    import jax
    from apex_tpu import models as jm
    pg, mesh = _jmodel(world)
    ids, mask = _batch()
    with mesh:
        loss, g = jax.jit(lambda v, i, m: pg.loss_and_grad_1f1b(
            v, i, i, attention_mask=m))({"params": jax_init}, ids, mask)
    for rank, o in enumerate(spawned(world)):
        got_loss, got = o["masked"]
        assert rel_err(got_loss, loss) <= TOL
        _check_grads(got, g, rank % PP, f"rank {rank}")
    # teeth: the mean of the microbatches' own masked means is off
    mono = {"wte": jax_init["embed"]["wte"], "wpe": jax_init["embed"]["wpe"],
            "final_ln": jax_init["head"]}
    lps = _cfg().num_hidden_layers // PP
    for st in range(PP):
        for li in range(lps):
            mono[f"block_{st * lps + li}"] = jax.tree.map(
                lambda a, st=st: a[st], jax_init["stages"][f"block_{li}"])
    logits = jm.GPTLMHeadModel(_jcfg()).apply({"params": mono}, ids, mask)
    rows = B // (M * (world // PP))
    naive = np.mean([float(jm.lm_loss(logits[i:i + rows], ids[i:i + rows],
                                      mask[i:i + rows]))
                     for i in range(0, B, rows)])
    assert abs(naive - float(loss)) > 10 * TOL * (abs(float(loss)) + 1.0)
