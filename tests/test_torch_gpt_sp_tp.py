"""GPT under sequence and tensor parallelism together in apex_tpu_torch
against apex_tpu's.

GPT-tiny (vocab 997 padded to 1024, hidden 128, 2 layers, 4 heads, MLP
256, sequence 32, batch 2 a data index) trained at O0 by
``gpt_main_amp.train(sp=2, tp=2)`` on gloo ranks as a (dp, sp 2, tp 2)
mesh at dp 1 and dp 2, ring and Ulysses, against the JAX example's
``--sp 2 --tp 2`` step (``examples/gpt/main_amp.py``: the attention
under ``shard_map`` over (data, sp), ``gpt_tp_rules`` placement,
``FusedAdam(layout="tree")``, the moments sharded over the data axis
with ``like_params``, ``vocab_parallel_lm_loss``, which the JAX example
takes at O0 on the CPU) from the same weights and batches, 2 steps at lr
1e-3:

- losses within 1e-5 relative (a data index's loss is its rows'; their
  mean is the JAX loss);
- params within 2e-5 scale-aware on each rank's tensor-parallel slice
  (the attention key biases, whose gradient is rounding noise in both
  packages, within Adam's 2 lr a step);
- the step-1 gradients, reduced over the (data x sp) ranks of each
  model index (the mesh's ``"data_sp"`` group), within 2e-5 scale-aware
  of the JAX gradients' slices (Adam's step is nearly blind to a
  gradient's scale, so the params alone would not see a wrong
  reduction);
- dropout 0.1 (hidden and attention) at dp 1, ring and Ulysses: the
  loss of the sequence group's ``vocab_parallel_lm_loss_shard`` sums
  equals the JAX dense model's under the same key within 1e-5 (the
  hidden masks the rank's window of the dense stream, the attention
  masks hashed at the global token and head coordinates);
- the mesh's ``"data_sp"`` group holds the ranks of one model index.

The ranks are spawned once for each world (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.examples import gpt_main_amp as gpt
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import threefry, vocab_parallel_lm_loss_shard
from apex_tpu_torch.parallel import tensor_parallel as tpar

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=32)
SP, TP, B, S, STEPS, LR = 2, 2, 2, 32, 2, 1e-3
VOCAB = tg.padded_vocab(TINY["vocab_size"], TP)
LOSS_TOL, PARAM_TOL, GRAD_TOL, DROP_TOL = 1e-5, 2e-5, 2e-5, 1e-5
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
PATTERNS = ("ring", "ulysses")
SPAWN_LIMIT = 240.0


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _cfg(**kw):
    return tg.GPTConfig(**{**TINY, **kw})


def _batches(dp):
    """The JAX example's global batches: ``RandomState(0)`` ids from the
    true vocab, ``dp * B`` rows a step, data index d's rows ``[d * B, (d
    + 1) * B)``."""
    rng = np.random.RandomState(0)
    return np.stack([rng.randint(0, TINY["vocab_size"], (dp * B, S))
                     .astype(np.int32) for _ in range(STEPS)])


def _key():
    return threefry.fold_in(threefry.PRNGKey(0), 1)


# -- the ranks -------------------------------------------------------------

def _step1_grads(sd, rows, pattern):
    """One O0 step of the example's ``train_step``: the reduced
    gradients it hands the optimizer (loss scale 1)."""
    mesh = parallel.create_mesh(sp=SP, tp=TP)
    model, opt, params, st = gpt.build(_cfg(vocab_size=VOCAB), lr=LR,
                                       opt_level="O0", device="cpu",
                                       state_dict=sd, mesh=mesh,
                                       sp_attention=pattern)
    ddp = parallel.DistributedDataParallel(
        model, process_group=mesh.group("data_sp"))
    grads = gpt.train_step(model, opt, params, st, torch.from_numpy(rows),
                           ddp, mesh=mesh,
                           true_vocab=TINY["vocab_size"])[3]
    return {k: v.detach() / float(opt.loss_scale(st))
            for k, v in grads.items()}


def _dropout_loss(sd, rows, pattern):
    """The data index's loss with dropout on: the sequence group's sum
    of the ranks' ``vocab_parallel_lm_loss_shard`` over ``B * (S -
    1)``."""
    mesh = parallel.create_mesh(sp=SP, tp=TP)
    cfg = _cfg(vocab_size=VOCAB, **DROPOUT)
    make = (parallel.make_ulysses_attention if pattern == "ulysses"
            else parallel.make_ring_attention)
    model = tg.GPTLMHeadModel(
        cfg, attention_fn=make(mesh.group("sp"), causal=True), device="cpu",
        seed=None, tp=mesh.group("model"), sp=mesh.group("sp"))
    model.load_state_dict(tpar.shard_params(
        sd, mesh, tpar.gpt_tp_rules(), num_heads=cfg.num_attention_heads))
    r, sl = mesh.index("sp"), S // SP
    ids = torch.from_numpy(rows)
    with torch.no_grad():
        hidden = model(ids[:, r * sl:(r + 1) * sl], deterministic=False,
                       dropout_key=_key(), return_hidden=True)
        shard = vocab_parallel_lm_loss_shard(
            hidden, model.wte.weight, ids, mesh,
            true_vocab=TINY["vocab_size"])
        return float(parallel.psum_g(shard, mesh.group("sp"))
                     / (B * (S - 1)))


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        sd = torch.load(f"{tmpdir}/init.pt")
        dp = world // (SP * TP)
        data = _batches(dp)
        mesh = parallel.create_mesh(sp=SP, tp=TP)
        d = mesh.index("data")
        rows = [b[d * B:(d + 1) * B] for b in data]
        out = {"coords": (d, mesh.index("sp"), mesh.index("model")),
               "data_sp": mesh.group("data_sp").members(), "runs": {}}
        for pattern in PATTERNS:
            run = gpt.train(_cfg(), batch=B, seq_len=S, steps=STEPS, lr=LR,
                            opt_level="O0", device="cpu", state_dict=sd,
                            tp=TP, sp=SP, sp_attention=pattern,
                            data=iter(rows))
            out["runs"][pattern] = {
                "losses": run["losses"],
                "params": {k: v.detach().clone()
                           for k, v in run["params"].items()},
                "grads": _step1_grads(sd, rows[0], pattern)}
            if dp == 1:
                out["runs"][pattern]["dropout"] = _dropout_loss(
                    sd, rows[0], pattern)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    params = jax.jit(jm.GPTLMHeadModel(jm.GPTConfig(
        **{**TINY, "vocab_size": VOCAB})).init)(
            jax.random.PRNGKey(0), jnp.ones((1, S), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


_RANKS = {}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    def get(world):
        if world not in _RANKS:
            tmp = tmp_path_factory.mktemp(f"gpt_sp_tp{world}")
            torch.save(tg.params_from_jax(jax_init, _cfg(vocab_size=VOCAB)),
                       tmp / "init.pt")
            ctx = torch.multiprocessing.start_processes(
                _rank_main, args=(world, str(tmp)), nprocs=world,
                join=False, start_method="spawn")
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


_JAX = {}


def _jax_run(jax_init, pattern, dp):
    """The JAX example's ``--sp 2 --tp 2`` steps on a (dp, 2, 2) mesh at
    O0: losses, params after ``STEPS`` steps, the first step's grads."""
    if (pattern, dp) in _JAX:
        return _JAX[(pattern, dp)]
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import ops as jops
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    mesh = Mesh(np.asarray(jax.devices()[:dp * SP * TP]).reshape(dp, SP, TP),
                ("data", "sp", "model"))
    make = (jpar.make_ulysses_attention if pattern == "ulysses"
            else jpar.make_ring_attention)
    sp_fn = make("sp", causal=True)

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        if bias is None:
            bias = jnp.zeros((q.shape[0], 1, 1, q.shape[1]), jnp.float32)
        f = jax.shard_map(
            lambda q, k, v, b: sp_fn(q, k, v, bias=b,
                                     dropout_fn=dropout_fn),
            mesh=mesh,
            in_specs=(P("data", "sp"),) * 3
            + (P("data", None, None, "sp"),),
            out_specs=P("data", "sp"))
        return f(q, k, v, bias)

    model, optimizer = jamp.initialize(
        jm.GPTLMHeadModel(jm.GPTConfig(**{**TINY, "vocab_size": VOCAB}),
                          attention_fn=attention_fn),
        jopt.FusedAdam(lr=LR, layout="tree"), opt_level="O0", verbosity=0)
    params = jax.tree.map(jnp.asarray, jax_init)
    opt_state = optimizer.init(params)
    specs = jpar.param_specs(params, mesh, jpar.gpt_tp_rules("model"))
    params = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh, s)), params, specs)
    opt_state = jpar.shard_optimizer_state(opt_state, mesh, axis="data",
                                           like_params=params)

    @jax.jit
    def train_step(params, opt_state, ids):
        def loss_fn(p):
            hidden = model.apply({"params": p}, ids, return_hidden=True)
            loss = jops.vocab_parallel_lm_loss(
                hidden, p["wte"]["embedding"], ids, mesh,
                true_vocab=TINY["vocab_size"])
            with jamp.scale_loss(loss, opt_state) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        grads = jax.tree.map(lambda g, s: jax.lax.with_sharding_constraint(
            g, NamedSharding(mesh, s)), grads, specs)
        new, opt_state = optimizer.step(params, grads, opt_state)
        return new, opt_state, loss, grads

    losses, first = [], None
    with mesh:
        for ids in _batches(dp):
            params, opt_state, loss, grads = train_step(
                params, opt_state,
                jax.device_put(ids, NamedSharding(mesh, P("data"))))
            losses.append(float(loss))
            if first is None:
                first = jax.tree.map(np.asarray, grads)
    _JAX[(pattern, dp)] = (losses, jax.tree.map(np.asarray, params), first)
    return _JAX[(pattern, dp)]


def _slices(tree, coords):
    """A JAX tree of the padded model as this rank's tensor-parallel
    slices, by the port's names."""
    full = tg.params_from_jax(tree, _cfg(vocab_size=VOCAB))
    mesh = tpar.Mesh({"model": TP})
    specs = tpar.param_specs(full, mesh, tpar.gpt_tp_rules(),
                             num_heads=TINY["num_attention_heads"])
    return {k: tpar.local_slice(v, specs[k], mesh.shape,
                                {"model": coords[2]})
            for k, v in full.items()}


@pytest.mark.parametrize("world", [4, 8], ids=["dp1", "dp2"])
def test_data_sp_group(spawned, world):
    grid = np.arange(world).reshape(world // (SP * TP), SP, TP)
    for r, out in enumerate(spawned(world)):
        d, s, m = out["coords"]
        assert grid[d, s, m] == r
        assert out["data_sp"] == tuple(grid[:, :, m].reshape(-1))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("world", [4, 8], ids=["dp1", "dp2"])
def test_sp_tp_training_matches_the_jax_example(spawned, jax_init, world,
                                                pattern):
    dp = world // (SP * TP)
    ranks = spawned(world)
    want_losses, want_params, want_grads = _jax_run(jax_init, pattern, dp)
    got = np.mean([ranks[d * SP * TP]["runs"][pattern]["losses"]
                   for d in range(dp)], axis=0)
    for got_l, want_l in zip(got, want_losses):
        assert abs(got_l - want_l) <= LOSS_TOL * abs(want_l), \
            (got, want_losses)
    for r, out in enumerate(ranks):
        run = out["runs"][pattern]
        d = out["coords"][0]
        assert run["losses"] == ranks[d * SP * TP]["runs"][pattern][
            "losses"]
        params, grads = (_slices(t, out["coords"])
                         for t in (want_params, want_grads))
        start = _slices(jax_init, out["coords"])
        for name, p in run["params"].items():
            assert p.shape == params[name].shape, name
            if "attention.key.bias" in name:
                assert np.max(np.abs(p.numpy() - params[name].numpy())) \
                    <= 2 * LR * STEPS, name
            else:
                assert rel_err(p.numpy(), params[name].numpy()) \
                    <= PARAM_TOL, (r, name)
            if "wte" not in name:
                assert not torch.equal(p, start[name]), name
        for name, g in run["grads"].items():
            if "attention.key.bias" in name:
                continue
            assert rel_err(g.numpy(), grads[name].numpy()) <= GRAD_TOL, \
                (r, pattern, name)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_sp_tp_dropout_matches_the_dense_jax_model(spawned, jax_init,
                                                   pattern):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu.ops.flash_attention import make_flash_attention
    model = jm.GPTLMHeadModel(
        jm.GPTConfig(**{**TINY, "vocab_size": VOCAB}, **DROPOUT),
        attention_fn=make_flash_attention(causal=True, use_pallas=False))
    ids = jnp.asarray(_batches(1)[0])
    logits = model.apply({"params": jax.tree.map(jnp.asarray, jax_init)},
                         ids, deterministic=False,
                         rngs={"dropout": jax.random.fold_in(
                             jax.random.PRNGKey(0), 1)})
    # the padding rows take no probability, as vocab_parallel_lm_loss's
    # true_vocab masking
    want = float(jm.lm_loss(logits[..., :TINY["vocab_size"]], ids))
    for out in spawned(SP * TP):
        got = out["runs"][pattern]["dropout"]
        assert abs(got - want) <= DROP_TOL * abs(want), (got, want)
