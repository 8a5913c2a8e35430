"""ZeRO-1 over tensor-parallel moments (``like_params``) against apex_tpu.

GPT-tiny (vocab 997 padded to 1024, hidden 128, 2 layers, 4 heads, MLP
256, sequence 32) on a world of 4 gloo ranks as a (dp 2, tp 2) mesh:

- ``gpt_main_amp``'s ``--tp`` step with ZeRO-1 over the tree layout's
  moments (``FusedAdam.with_zero(..., like_params=model.tp_places())``,
  the moments cut by ``shard_optimizer_state`` with the same places)
  equals the step with the moments whole bit for bit, params and amp's
  scaler state, over 2 O2 steps from the JAX model's weights; the
  moments gathered back (``unshard_optimizer_state``) equal the whole
  ones bit for bit;
- each rank's moment shards are the JAX placement's device shards:
  the moments of every leaf filled with its elements' indices in the
  JAX layout, cut by the port on rank (d, m), equal the shard that
  ``apex_tpu.parallel.shard_optimizer_state(like_params=params)`` on a
  (2, 2) CPU mesh places on device (d, m), element for element (the
  port's shard is the JAX layout's slice as it is: a ``Linear``'s
  weight read transposed, a dim of heads as (heads, head_dim));
- the shards hold about half of the whole moments' bytes (the leaves
  under ``2 * 128`` elements stay whole, as in the JAX package);
- an inf planted in one rank's reduced gradient skips the step on all
  four ranks (the overflow flag is taken over the data group as well as
  the model group: data peers gather each other's shards), every bit
  kept;
- ZeRO-2 over the tree layout and ZeRO over FusedLAMB are still refused
  (ZeRO-2: a flat-layout FusedAdam only).

The ranks are spawned once for the module (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.examples import gpt_main_amp as gpt
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import vocab_parallel_lm_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import tensor_parallel as tpar

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=32)
DP, TP, B, S, STEPS, LR = 2, 2, 2, 32, 2, 1e-3
WORLD = DP * TP
VOCAB = tg.padded_vocab(TINY["vocab_size"], TP)
SPAWN_LIMIT = 240.0


def _cfg(**kw):
    return tg.GPTConfig(**{**TINY, **kw})


def _batches():
    rng = np.random.RandomState(0)
    return np.stack([rng.randint(0, TINY["vocab_size"], (DP * B, S))
                     .astype(np.int32) for _ in range(STEPS)])


def _run(sd, rows, mesh, zero):
    model, opt, params, st = gpt.build(_cfg(vocab_size=VOCAB), lr=LR,
                                       opt_level="O2", device="cpu",
                                       state_dict=sd, mesh=mesh, zero=zero)
    ddp = parallel.DistributedDataParallel(model,
                                           process_group=mesh.group("data"))
    for ids in rows:
        params, st = gpt.train_step(model, opt, params, st,
                                    torch.from_numpy(ids), ddp, mesh=mesh,
                                    true_vocab=TINY["vocab_size"])[:2]
    return model, params, st


def _overflow(sd, rows, mesh, rank):
    """One O2 ZeRO-1 step with an inf in rank 1's reduced gradient."""
    model, opt, params, st = gpt.build(_cfg(vocab_size=VOCAB), lr=LR,
                                       opt_level="O2", device="cpu",
                                       state_dict=sd, mesh=mesh)
    ids = torch.from_numpy(rows)
    hidden = model.apply(params, ids, return_hidden=True)
    loss = vocab_parallel_lm_loss(hidden, params["wte.weight"], ids, mesh,
                                  true_vocab=TINY["vocab_size"])
    with amp.scale_loss(loss, st) as scaled:
        grads = dict(zip(params, torch.autograd.grad(
            scaled, list(params.values()))))
    grads = parallel.DistributedDataParallel(
        model, process_group=mesh.group("data")).reduce_gradients(grads)
    if rank == 1:
        grads["blocks.0.mlp_in.weight"].fill_(float("inf"))
    before = {k: v.detach().clone() for k, v in params.items()}
    scale0 = float(opt.loss_scale(st))
    params, st = opt.step(params, grads, st)
    return {"kept": all(torch.equal(before[k], params[k]) for k in params),
            "scale0": scale0, "scale": float(opt.loss_scale(st)),
            "skipped": int(st.skipped_steps)}


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        sd = torch.load(f"{tmpdir}/init.pt")
        mesh = parallel.create_mesh(tp=TP)
        d = mesh.index("data")
        rows = [b[d * B:(d + 1) * B] for b in _batches()]
        out = {}
        model, whole_p, whole_st = _run(sd, rows, mesh, zero=False)
        _, zero_p, zero_st = _run(sd, rows, mesh, zero=True)
        places = model.unwrapped.tp_places()
        out["params_bitwise"] = all(torch.equal(zero_p[k], whole_p[k])
                                    for k in whole_p)
        out["scaler"] = [(float(st.loss_scalers[0].loss_scale),
                          int(st.skipped_steps), int(st.applied_steps))
                         for st in (whole_st, zero_st)]
        out["step"] = [int(st.inner.step) for st in (whole_st, zero_st)]
        gathered = parallel.unshard_optimizer_state(
            zero_st.inner, mesh.group("data"), whole_st.inner,
            like_params=places)
        out["moments_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(
                torch.utils._pytree.tree_leaves((gathered.m, gathered.v)),
                torch.utils._pytree.tree_leaves((whole_st.inner.m,
                                                 whole_st.inner.v))))
        nbytes = [sum(t.numel() * 4 for t in torch.utils._pytree.tree_leaves(
            (st.inner.m, st.inner.v))) for st in (whole_st, zero_st)]
        out["moment_bytes"] = nbytes
        # the placement: index-filled moments cut by the places
        index = torch.load(f"{tmpdir}/index.pt")
        local = tpar.shard_params(index, mesh, tpar.gpt_tp_rules(),
                                  num_heads=TINY["num_attention_heads"])
        state = FusedAdam(layout="tree").init(local)
        state = state._replace(m=local)
        cut = parallel.shard_optimizer_state(state, mesh.group("data"),
                                             like_params=places)
        out["index_shards"] = cut.m
        out["overflow"] = _overflow(sd, rows[0], mesh, rank)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    cfg = jm.GPTConfig(**{**TINY, "vocab_size": VOCAB})
    params = jax.jit(jm.GPTLMHeadModel(cfg).init)(
        jax.random.PRNGKey(0), jnp.ones((DP, S), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _index_tree(jax_init):
    """Every leaf filled with its elements' row-major indices (fp32, exact
    below 2**24), in the JAX layout."""
    import jax
    return jax.tree.map(lambda a: np.arange(a.size, dtype=np.float32)
                        .reshape(a.shape), jax_init)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("zero_tp")
    cfg = _cfg(vocab_size=VOCAB)
    torch.save(tg.params_from_jax(jax_init, cfg), tmp / "init.pt")
    torch.save(tg.params_from_jax(_index_tree(jax_init), cfg),
               tmp / "index.pt")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(WORLD, str(tmp)), nprocs=WORLD, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in time")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def test_zero1_over_tp_moments_equals_the_whole_moments(ranks):
    for out in ranks:
        assert out["params_bitwise"]
        whole, zero = out["scaler"]
        assert whole == zero
        assert out["step"] == [STEPS, STEPS]
        assert out["moments_bitwise"]
        full, shard = out["moment_bytes"]
        assert 0.5 * full <= shard <= 0.52 * full, out["moment_bytes"]


def test_overflow_on_one_rank_skips_every_data_and_model_peer(ranks):
    # the shards of data peers are gathered into every rank's params: a
    # skip on one rank must be a skip on its data group too
    for out in ranks:
        o = out["overflow"]
        assert o["kept"] and o["skipped"] == 1
        assert o["scale"] == o["scale0"] / 2


def test_moment_shards_are_the_jax_placement(ranks, jax_init):
    import jax
    from jax.sharding import Mesh, NamedSharding
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    from apex_tpu.utils.paths import path_str
    jmesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(DP, TP),
                 ("data", "model"))
    specs = jpar.param_specs(jax_init, jmesh, jpar.gpt_tp_rules("model"))
    placed = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(jmesh, s)), jax_init, specs)
    state = jopt.FusedAdam(layout="tree").init(placed)
    state = state._replace(m=jax.tree.map(
        lambda a, p: jax.device_put(a, p.sharding), _index_tree(jax_init),
        placed))
    cut = jpar.shard_optimizer_state(state, jmesh, axis="data",
                                     like_params=placed)
    leaves = {path_str(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(cut.m)}
    sharded_on_data = 0
    for r, out in enumerate(ranks):
        device = jmesh.devices[r // TP, r % TP]
        for path, leaf in leaves.items():
            name = path.replace("/", ".").replace("block_", "blocks.")
            name = name.replace(".kernel", ".weight").replace(
                ".embedding", ".weight")
            want = np.asarray(next(s.data for s in leaf.addressable_shards
                                   if s.device == device))
            got = out["index_shards"][name].numpy()
            if got.shape != want.shape:     # a leaf the port keeps whole
                got = got.T.reshape(want.shape) if got.ndim == 2 \
                    else got.reshape(want.shape)
            np.testing.assert_array_equal(got, want, err_msg=name)
            sharded_on_data += "data" in str(leaf.sharding.spec)
    assert sharded_on_data > 0


def test_zero_refusals():
    params = {"w": torch.zeros(8, 8)}
    tree = FusedAdam(layout="tree")
    with pytest.raises(ValueError, match="flat-layout FusedAdam"):
        parallel.zero2_update(tree, params, params, tree.init(params),
                              parallel.mesh.WORLD)
