"""GPT under sequence parallelism in apex_tpu_torch against apex_tpu's.

- GPT-tiny (vocab 997, hidden 128, 2 layers, 4 heads, MLP 256, sequence
  32) trained at O0 on a world of 4 gloo ranks as a (dp 2, sp 2) mesh by
  ``gpt_main_amp.train(sp=2)``, ring and Ulysses, against the JAX
  example's ``--sp`` step (the attention under ``shard_map`` on a (2, 2)
  mesh, ``FusedAdam`` flat, ``lm_loss``; ``tests/distributed/
  test_gpt_sp.py`` builds it the same way) from the same weights and
  batches, 2 steps at lr 1e-3: losses within 1e-5 relative, params
  within 2e-5 scale-aware (the attention key biases, whose gradient is
  rounding noise in both packages, within Adam's 2 lr), and the step-1
  gradients, summed over the sequence group and averaged over the data
  group, within 2e-5 scale-aware of the JAX gradients (Adam's step is
  nearly blind to a gradient's scale, so the params alone would not see
  a wrong reduction).
- Dropout (0.1 hidden, 0.1 attention, deterministic=False, one key):
  a (dp 2, sp 2) rank's loss equals the JAX dense model's under the same
  key within 1e-5 (the hidden masks are the rank's window of the dense
  stream, the attention masks hashed at global coordinates), and a
  window of ``threefry.dropout`` equals the slice of the whole tensor's
  call bit for bit.
- An inf planted in sequence rank 1's reduced gradients skips the step
  on both ranks of its sequence group (the overflow flag taken over
  it), and on no other rank.
- Ulysses at sp 4 with 4 heads (one head a rank): each rank's logits
  equal its slice of the JAX dense model's within 1e-5.

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
from apex_tpu_torch.ops import threefry

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=32)
DP, SP, B, S, STEPS, LR = 2, 2, 2, 32, 2, 1e-3
WORLD = DP * SP
LOSS_TOL, PARAM_TOL, GRAD_TOL, FWD_TOL = 1e-5, 2e-5, 2e-5, 1e-5
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
SPAWN_LIMIT = 300.0


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _cfg(**kw):
    return tg.GPTConfig(**{**TINY, **kw})


def _batches():
    """The JAX example's global batches: ``RandomState(0)`` ids, ``DP *
    B`` rows a step, data index d's rows ``[d * B, (d + 1) * B)``."""
    rng = np.random.RandomState(0)
    return np.stack([rng.randint(0, TINY["vocab_size"], (DP * B, S))
                     .astype(np.int32) for _ in range(STEPS)])


def _key():
    return threefry.fold_in(threefry.PRNGKey(0), 1)


# -- the ranks -------------------------------------------------------------

def _step1_grads(sd, rows, pattern):
    """One O0 step of the example's ``train_step``: the gradients it
    hands the optimizer, unscaled."""
    mesh = parallel.create_mesh(sp=SP)
    model, opt, params, st = gpt.build(_cfg(), lr=LR, opt_level="O0",
                                       device="cpu", state_dict=sd,
                                       mesh=mesh, sp_attention=pattern)
    ddp = parallel.DistributedDataParallel(model,
                                           process_group=parallel.mesh.WORLD)
    scale = float(opt.loss_scale(st))
    grads = gpt.train_step(model, opt, params, st, torch.from_numpy(rows),
                           ddp, mesh=mesh)[3]
    return {k: v.detach() / scale for k, v in grads.items()}


def _overflow(sd, rows, rank):
    """One O2 step with an inf in sequence rank 1's reduced gradients of
    data index 0 (global rank 1)."""
    mesh = parallel.create_mesh(sp=SP)
    model, opt, params, st = gpt.build(_cfg(), lr=LR, opt_level="O2",
                                       device="cpu", state_dict=sd,
                                       mesh=mesh, sp_attention="ring")
    r, sl = mesh.index("sp"), S // SP
    ids = torch.from_numpy(rows)
    logits = model.apply(params, ids[:, r * sl:(r + 1) * sl])
    shard = tg.lm_loss_shard(logits, ids, r, SP) * (SP / (B * (S - 1)))
    with amp.scale_loss(shard, st) as scaled:
        grads = dict(zip(params, torch.autograd.grad(
            scaled, list(params.values()))))
    grads = parallel.DistributedDataParallel(
        model, process_group=parallel.mesh.WORLD).reduce_gradients(grads)
    if rank == 1:
        grads["blocks.0.mlp_in.weight"].fill_(float("inf"))
    before = {k: v.detach().clone() for k, v in params.items()}
    scale0 = float(opt.loss_scale(st))
    params, st = opt.step(params, grads, st)
    return {"kept": all(torch.equal(before[k], params[k]) for k in params),
            "scale0": scale0, "scale": float(opt.loss_scale(st)),
            "skipped": int(st.skipped_steps)}


def _dropout_loss(sd, rows):
    """A (dp 2, sp 2) rank's data-index loss with dropout on."""
    mesh = parallel.create_mesh(sp=SP)
    r, sl = mesh.index("sp"), S // SP
    model = tg.GPTLMHeadModel(
        _cfg(**DROPOUT), attention_fn=parallel.make_ring_attention(
            mesh.group("sp"), causal=True), device="cpu", seed=None,
        sp=mesh.group("sp"))
    model.load_state_dict(sd)
    ids = torch.from_numpy(rows)
    with torch.no_grad():
        logits = model(ids[:, r * sl:(r + 1) * sl], deterministic=False,
                       dropout_key=_key())
        shard = tg.lm_loss_shard(logits, ids, r, SP)
        return float(parallel.psum_g(shard, mesh.group("sp"))
                     / (B * (S - 1)))


def _ulysses_sp4(sd, rows):
    """This rank's logits at sp 4 (one head a rank)."""
    mesh = parallel.create_mesh(sp=WORLD)
    r, sl = mesh.index("sp"), S // WORLD
    model = tg.GPTLMHeadModel(
        _cfg(), attention_fn=parallel.make_ulysses_attention(
            mesh.group("sp"), causal=True), device="cpu", seed=None,
        sp=mesh.group("sp"))
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.from_numpy(rows[:, r * sl:(r + 1) * sl]))


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        sd = torch.load(f"{tmpdir}/init.pt")
        data = _batches()
        mesh = parallel.create_mesh(sp=SP)
        d = mesh.index("data")
        rows = [b[d * B:(d + 1) * B] for b in data]
        out = {"data": mesh.group("data").members(),
               "sp": mesh.group("sp").members(), "runs": {}}
        for pattern in ("ring", "ulysses"):
            t0 = time.perf_counter()
            run = gpt.train(_cfg(), batch=B, seq_len=S, steps=STEPS, lr=LR,
                            opt_level="O0", device="cpu", state_dict=sd,
                            sp=SP, sp_attention=pattern, data=iter(rows))
            out["runs"][pattern] = {
                "losses": run["losses"], "seconds": time.perf_counter() - t0,
                "params": {k: v.detach().clone()
                           for k, v in run["params"].items()},
                "grads": _step1_grads(sd, rows[0], pattern)}
        out["overflow"] = _overflow(sd, rows[0], rank)
        out["dropout"] = _dropout_loss(sd, rows[0])
        out["sp4"] = _ulysses_sp4(sd, data[0][:B])
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    params = jax.jit(jm.GPTLMHeadModel(jm.GPTConfig(**TINY)).init)(
        jax.random.PRNGKey(0), jnp.ones((DP, S), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("gpt_sp")
    torch.save(tg.params_from_jax(jax_init, _cfg()), tmp / "init.pt")
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


def _jax_sp_run(jax_init, pattern):
    """The JAX example's ``--sp 2`` step on a (2, 2) mesh at O0: losses,
    params after ``STEPS`` steps and the first step's gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(DP, SP),
                ("data", "sp"))
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
        jm.GPTLMHeadModel(jm.GPTConfig(**TINY), attention_fn=attention_fn),
        jopt.FusedAdam(lr=LR), opt_level="O0", verbosity=0)
    repl = NamedSharding(mesh, P())
    params = jax.device_put(jax.tree.map(jnp.asarray, jax_init), repl)
    opt_state = jax.device_put(optimizer.init(params), repl)

    def loss_fn(p, ids, st):
        loss = jm.lm_loss(model.apply({"params": p}, ids), ids)
        with jamp.scale_loss(loss, st) as scaled:
            return scaled, loss

    @jax.jit
    def train_step(params, opt_state, ids):
        grads, loss = jax.grad(loss_fn, has_aux=True)(params, ids,
                                                      opt_state)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads

    losses, first = [], None
    with mesh:
        for ids in _batches():
            params, opt_state, loss, grads = train_step(
                params, opt_state,
                jax.device_put(ids, NamedSharding(mesh, P("data"))))
            losses.append(float(loss))
            if first is None:
                first = jax.tree.map(np.asarray, grads)
    return losses, jax.tree.map(np.asarray, params), first


def test_mesh_groups(ranks):
    for r, out in enumerate(ranks):
        assert out["sp"] == (r // SP * SP, r // SP * SP + 1)
        assert out["data"] == (r % SP, r % SP + SP)


@pytest.mark.parametrize("pattern", ["ring", "ulysses"])
def test_sp_training_matches_the_jax_example(ranks, jax_init, pattern):
    want_losses, want_params, want_grads = _jax_sp_run(jax_init, pattern)
    want = tg.params_from_jax(want_params, _cfg())
    init = tg.params_from_jax(jax_init, _cfg())
    grads = tg.params_from_jax(want_grads, _cfg())
    # a rank's loss is its data index's batch; the JAX loss the global
    # batch's: the mean over the data indices
    got = np.mean([ranks[d * SP]["runs"][pattern]["losses"]
                   for d in range(DP)], axis=0)
    for got_l, want_l in zip(got, want_losses):
        assert abs(got_l - want_l) <= LOSS_TOL * abs(want_l), \
            (got, want_losses)
    for r, out in enumerate(ranks):
        run = out["runs"][pattern]
        assert run["losses"] == ranks[r // SP * SP]["runs"][pattern][
            "losses"]
        for name, p in run["params"].items():
            if "attention.key.bias" in name:
                assert np.max(np.abs(p.numpy() - want[name].numpy())) \
                    <= 2 * LR * STEPS, name
            else:
                assert rel_err(p.numpy(), want[name].numpy()) \
                    <= PARAM_TOL, name
            assert not torch.equal(p, init[name]), name
        for name, g in run["grads"].items():
            if "attention.key.bias" in name:
                continue
            assert rel_err(g.numpy(), grads[name].numpy()) <= GRAD_TOL, \
                (pattern, name)


def test_sp_dropout_matches_the_dense_jax_model(ranks, jax_init):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu.ops.flash_attention import make_flash_attention
    model = jm.GPTLMHeadModel(
        jm.GPTConfig(**TINY, **DROPOUT),
        attention_fn=make_flash_attention(causal=True, use_pallas=False))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    for d in range(DP):
        ids = jnp.asarray(_batches()[0][d * B:(d + 1) * B])
        logits = model.apply({"params": jax.tree.map(jnp.asarray, jax_init)},
                             ids, deterministic=False,
                             rngs={"dropout": key})
        want = float(jm.lm_loss(logits, ids))
        for out in ranks[d * SP:(d + 1) * SP]:
            assert abs(out["dropout"] - want) <= LOSS_TOL * abs(want)


def test_dropout_window_is_the_dense_slice():
    x = torch.randn(3, 32, 24)
    key = _key()
    full = threefry.dropout(x, 0.3, key)
    for n in (2, 4):
        sl = 32 // n
        for r in range(n):
            part = x[:, r * sl:(r + 1) * sl]
            got = threefry.dropout(part, 0.3, key, threefry.window(
                x.shape, 1, r * sl, sl))
            assert torch.equal(got, full[:, r * sl:(r + 1) * sl])
    one = x[:1]     # one row: the window is one run of counters
    got = threefry.dropout(one[:, 8:24], 0.3, key,
                           threefry.window(one.shape, 1, 8, 16))
    assert torch.equal(got, threefry.dropout(one, 0.3, key)[:, 8:24])


def test_overflow_on_one_sp_rank_skips_its_group(ranks):
    for r, out in enumerate(ranks):
        o = out["overflow"]
        if r < SP:      # rank 1's sequence group
            assert o["kept"] and o["skipped"] == 1
            assert o["scale"] == o["scale0"] / 2
        else:
            assert not o["kept"] and o["skipped"] == 0
            assert o["scale"] == o["scale0"]


def test_ulysses_one_head_a_rank_matches_the_dense_model(ranks, jax_init):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    ids = jnp.asarray(_batches()[0][:B])
    want = np.asarray(jm.GPTLMHeadModel(jm.GPTConfig(**TINY)).apply(
        {"params": jax.tree.map(jnp.asarray, jax_init)}, ids))
    got = np.concatenate([out["sp4"].numpy() for out in ranks], axis=1)
    assert rel_err(got, want) <= FWD_TOL


def test_sp_with_tp_is_refused():
    """Ulysses over tensor-parallel heads: GPT-tiny's 4 heads over --tp 2
    leave 2 a rank, which do not split over --sp 4."""
    with pytest.raises(ValueError, match=r"heads / --tp 2 to divide by "
                       r"--sp 4"):
        gpt.train(_cfg(), batch=B, seq_len=S, steps=1, device="cpu", tp=2,
                  sp=4)
    with pytest.raises(SystemExit, match=r"heads / --tp 2 to divide by "
                       r"--sp 4"):
        gpt.main(["--config", "tiny", "--sp", "4", "--tp", "2"])
