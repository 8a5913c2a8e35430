"""BERT under sequence parallelism in apex_tpu_torch against apex_tpu's.

BERT-tiny (vocab 1024, hidden 128, 2 layers, 4 heads, MLP 256), batch 2,
sequence 32, at (dp 1, sp 2) on two gloo ranks through
``bert_main_amp.train_step`` with a sequence-parallel mesh, ring and
Ulysses, one O0 step of the recipe's ``FusedLAMB`` on the example's
first synthetic batch with padding (the last 3 keys of row 0 masked,
and in row 1 every key of sequence rank 1's shard, so that rank's own
block is fully masked there), against the JAX example's ``--ring-attention
2`` step (the attention under ``shard_map`` on a (1, 2) mesh; the
oracle ``tests/distributed/test_sequence_parallel.py`` builds the
sharded encoder the same way) on the same weights and batch: the loss
within 1e-5 relative, the step-1 gradients (summed over the sequence
group) and the params after the step within 2e-5 scale-aware.  Each
rank embeds its token slice at its position offset, its key mask
travels with its K/V (ring) or is gathered (Ulysses), MLM sums its
masked positions over the global count, and the NSP term is taken on
sequence rank 0 alone, where the pooled ``[CLS]`` token lives.

The ranks are spawned once for the module (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.examples import bert_main_amp as bert
from apex_tpu_torch.models.bert import params_from_jax

B, S, SP, LR = 2, 32, 2, 1e-4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 2e-5, 2e-5
SPAWN_LIMIT = 240.0


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _batch():
    """The example's first synthetic batch and a padding mask."""
    cfg = bert.get_config("tiny")
    ids, labels, weights, nsp = next(bert.batches(cfg, B, S))
    mask = np.ones((B, S), np.int32)
    mask[0, S - 3:] = 0
    mask[1, S // 2:] = 0          # row 1: every key of the last shard
    weights = weights * mask
    return ids, labels, weights.astype(np.float32), nsp, mask


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        cfg = bert.get_config("tiny")
        sd = torch.load(f"{tmpdir}/init.pt")
        batch = tuple(torch.from_numpy(a) for a in _batch())
        out = {}
        for pattern in ("ring", "ulysses"):
            mesh = parallel.create_mesh(sp=SP)
            model, opt, params, st = bert.build(
                cfg, lr=LR, opt_level="O0", device="cpu", state_dict=sd,
                mesh=mesh, sp_attention=pattern)
            ddp = parallel.DistributedDataParallel(
                model, process_group=parallel.mesh.WORLD)
            scale = float(opt.loss_scale(st))
            params, st, loss, grads = bert.train_step(
                model, opt, params, st, batch, ddp=ddp, mesh=mesh)
            out[pattern] = {
                "loss": float(loss),
                "grads": {k: v.detach() / scale for k, v in grads.items()},
                "params": {k: v.detach().clone() for k, v in params.items()}}
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_optimizer():
    from apex_tpu import optimizers as jopt
    return jopt.FusedLAMB(
        lr=LR, max_grad_norm=1.0,
        param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
        exclude_from_layer_adaptation=lambda path: any(
            "bias" in str(k) or "_ln" in str(k) for k in path))


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    cfg = jm.BertConfig(vocab_size=1024, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=256, max_position_embeddings=512)
    params = jm.BertForPreTraining(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("bert_sp")
    torch.save(params_from_jax(jax_init, bert.get_config("tiny")),
               tmp / "init.pt")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(SP, str(tmp)), nprocs=SP, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in time")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(SP)]


def _jax_step(jax_init, pattern):
    """The JAX example's ``--ring-attention 2`` step at O0 on a (1, 2)
    mesh, the padding mask passed to the model: loss, grads, params."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    mesh = Mesh(np.array(jax.devices()[:SP]).reshape(1, SP), ("data", "sp"))
    sp_fn = (jpar.make_ulysses_attention("sp") if pattern == "ulysses"
             else jpar.make_ring_attention("sp"))

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        if bias is None:
            bias = jnp.zeros((q.shape[0], 1, 1, q.shape[1]), jnp.float32)
        f = jax.shard_map(
            lambda q, k, v, bias: sp_fn(q, k, v, bias=bias,
                                        dropout_fn=dropout_fn),
            mesh=mesh,
            in_specs=(P("data", "sp"), P("data", "sp"), P("data", "sp"),
                      P("data", None, None, "sp")),
            out_specs=P("data", "sp"))
        return f(q, k, v, bias)

    cfg = jm.BertConfig(vocab_size=1024, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=256, max_position_embeddings=512)
    model, optimizer = jamp.initialize(
        jm.BertForPreTraining(cfg, attention_fn=attention_fn),
        _jax_optimizer(), opt_level="O0", verbosity=0)
    repl = NamedSharding(mesh, P())
    params = jax.device_put(jax.tree.map(jnp.asarray, jax_init), repl)
    opt_state = jax.device_put(optimizer.init(params), repl)

    @jax.jit
    def train_step(params, opt_state, ids, labels, weights, nsp, mask):
        def loss_fn(p):
            mlm_logits, nsp_logits = model.apply({"params": p}, ids, mask,
                                                 deterministic=True)
            mlm = optax.softmax_cross_entropy_with_integer_labels(
                mlm_logits, labels)
            loss = jnp.sum(mlm * weights) / jnp.maximum(jnp.sum(weights),
                                                        1.0)
            loss = loss + optax.softmax_cross_entropy_with_integer_labels(
                nsp_logits, nsp).mean()
            with jamp.scale_loss(loss, opt_state) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads

    shard = NamedSharding(mesh, P("data"))
    with mesh:
        params, _, loss, grads = train_step(
            params, opt_state,
            *(jax.device_put(jnp.asarray(a), shard) for a in _batch()))
    return float(loss), jax.tree.map(np.asarray, grads), \
        jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("pattern", ["ring", "ulysses"])
def test_sp_step_matches_the_jax_example(ranks, jax_init, pattern):
    cfg = bert.get_config("tiny")
    want_loss, want_grads, want_params = _jax_step(jax_init, pattern)
    grads = params_from_jax(want_grads, cfg)
    params = params_from_jax(want_params, cfg)
    for out in ranks:
        got = out[pattern]
        assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss), \
            (got["loss"], want_loss)
        for name, g in got["grads"].items():
            assert rel_err(g.numpy(), grads[name].numpy()) <= GRAD_TOL, name
        for name, p in got["params"].items():
            assert rel_err(p.numpy(), params[name].numpy()) <= PARAM_TOL, \
                name


def test_padding_reaches_the_step(ranks, jax_init):
    """The same step without the mask takes other gradients: the masked
    keys and positions matter, so the test above holds them."""
    ids, labels, weights, nsp, _ = _batch()
    cfg = bert.get_config("tiny")
    model, _, params, _ = bert.build(cfg, opt_level="O0", device="cpu",
                                     state_dict=params_from_jax(jax_init,
                                                                cfg))
    mlm, nsp_logits = model.apply(params, torch.from_numpy(ids))
    loss = bert.batch_loss(mlm, nsp_logits, torch.from_numpy(labels),
                           torch.from_numpy(weights), torch.from_numpy(nsp))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    got = ranks[0]["ring"]["grads"]
    assert max(rel_err(got[k].numpy(), grads[k].numpy()) for k in grads) \
        > 100 * GRAD_TOL


def test_refusals():
    cfg = bert.get_config("tiny")
    with pytest.raises(SystemExit, match=r"SP=2 x PP=2 must divide "
                       r"devices \(1\)"):
        bert.main(["--config", "tiny", "--pp", "2", "--ring-attention",
                   "2"])
    with pytest.raises(ValueError, match="must divide seq_len"):
        bert.train(cfg, batch=4, seq_len=S + 1, steps=1, device="cpu", sp=2,
                   grad_accum=2)
