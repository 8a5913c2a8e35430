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
- ZeRO-1 over ``FusedLAMB`` (``AmpOptimizer.with_zero``, O0, 3 steps)
  against the replicated-state run: over BERT's tensor-parallel model at
  (dp 2, tp 2) (``like_params=model.tp_places()``; the trust-ratio norms
  of a leaf cut over model and data ranks summed over both) and over a
  ``PipelinedBert`` at (dp 2, pp 2), the twin of
  ``test_zero_x_pipeline_fusedlamb`` (``like_params=pb.tp_places()``):
  the losses within 1e-6 relative and the params within 1e-6
  scale-aware each step; each moment shard holds as many elements as
  the JAX placement's device shard (the stage cut and the data cut), the
  state a rank under ``1 / 1.8`` of the replicated one, as the reference
  asks; ``unshard_optimizer_state`` gives the replicated moments back
  (within 1e-6) and sharding that again gives the shards bit for bit;
- both port runs of ZeRO over FusedLAMB, the replicated state's and
  ZeRO-1's, against the JAX package's own O0 FusedLAMB steps on the
  dense model from the same init and batch: losses within 1e-5
  relative, each rank's params (its TP slice or its stage) within 1e-5
  scale-aware after every step;
- ZeRO-2 over the tree layout is still refused (a flat-layout FusedAdam
  only).

The ranks are spawned once for the module (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.examples import gpt_main_amp as gpt
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import vocab_parallel_lm_loss
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
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


LAMB_STEPS, LAMB_TOL, LAMB_JAX_TOL = 3, 1e-6, 1e-5
LAMB_PP = 2


def _lamb_cfg(layers=2):
    return tb.BertConfig(vocab_size=128, hidden_size=32,
                         num_hidden_layers=layers, num_attention_heads=4,
                         intermediate_size=64, max_position_embeddings=16,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)


def _lamb_batch(d):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 128, (DP * B, 16))
    tgt = {"mlm": rng.randint(0, 128, (DP * B, 16)),
           "nsp": rng.randint(0, 2, (DP * B,))}
    return (torch.from_numpy(ids[d * B:(d + 1) * B]),
            {k: torch.from_numpy(v[d * B:(d + 1) * B])
             for k, v in tgt.items()})


def _pretrain_loss(mlm, nsp, t):
    v = mlm.shape[-1]
    return torch.nn.functional.cross_entropy(
        mlm.float().reshape(-1, v), t["mlm"].reshape(-1)) \
        + torch.nn.functional.cross_entropy(nsp.float(), t["nsp"])


def _lamb_runs(make, loss_and_grads, mesh):
    """LAMB_STEPS O0 FusedLAMB steps under amp with the moments whole and
    with ZeRO-1 over the data group: the losses and params of each step,
    both final states, the places."""
    data = mesh.group("data")
    ddp = parallel.DistributedDataParallel(process_group=data)
    runs = {}
    for zero in (False, True):
        module, lamb = make()
        places = module.tp_places()
        model, opt = amp.initialize(module, lamb, opt_level="O0",
                                    verbosity=0)
        params = model.init()
        state = opt.init(params)
        if zero:
            opt = opt.with_zero(data, like_params=places)
            state = parallel.shard_optimizer_state(state, data,
                                                   like_params=places)
        losses, steps = [], []
        for _ in range(LAMB_STEPS):
            loss, grads = loss_and_grads(model, params, opt, state)
            grads = ddp.reduce_gradients({"loss": loss.reshape(1), **grads})
            losses.append(float(grads.pop("loss")[0]))
            params, state = opt.step(params, grads, state)
            steps.append({k: v.detach().clone() for k, v in params.items()})
        runs[zero] = {"losses": losses, "steps": steps, "state": state,
                      "places": places}
    whole, cut = runs[False], runs[True]
    out = {"loss_err": max(abs(a - b) / abs(b) for a, b in zip(
        cut["losses"], whole["losses"])),
        "param_err": max(
            float((a[k] - b[k]).abs().max()) / (float(b[k].abs().max()) + 1)
            for a, b in zip(cut["steps"], whole["steps"]) for k in b)}
    places = cut["places"]
    gathered = parallel.unshard_optimizer_state(
        cut["state"].inner, data, whole["state"].inner, like_params=places)
    pairs = list(zip(
        torch.utils._pytree.tree_leaves((gathered.m, gathered.v)),
        torch.utils._pytree.tree_leaves((whole["state"].inner.m,
                                         whole["state"].inner.v))))
    out["unshard_err"] = max(float((a - b).abs().max()) /
                             (float(b.abs().max()) + 1) for a, b in pairs)
    again = parallel.shard_optimizer_state(gathered, data,
                                           like_params=places)
    out["reshard_bitwise"] = all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves((again.m, again.v)),
        torch.utils._pytree.tree_leaves((cut["state"].inner.m,
                                         cut["state"].inner.v))))
    out["trajectory"] = {name: {"losses": run["losses"],
                                "steps": run["steps"]}
                         for name, run in (("replicated", whole),
                                           ("zero", cut))}
    out["shard_numel"] = {k: v.numel()
                          for k, v in cut["state"].inner.m.items()}
    out["param_numel"] = {k: v.numel() for k, v in cut["steps"][0].items()}
    out["state_bytes"] = [sum(t.numel() * 4 for t in
                              torch.utils._pytree.tree_leaves((r.m, r.v)))
                          for r in (whole["state"].inner,
                                    cut["state"].inner)]
    return out


def _lamb_over_tp(mesh, sd):
    """ZeRO over FusedLAMB on BERT's TP model, (dp 2, tp 2)."""
    group = mesh.group("model")
    ids, tgt = _lamb_batch(mesh.index("data"))

    def make():
        module = tb.BertForPreTraining(_lamb_cfg(), device="cpu", seed=None,
                                       tp=group)
        module.load_state_dict(tpar.tp_slice(
            sd, tpar.bert_tp_rules(), _lamb_cfg().num_attention_heads, TP,
            mesh.index("model")))
        split = {k: bool(v) for k, v in module.tp_specs().items()}
        return module, FusedLAMB(lr=1e-2).with_tensor_parallel(group, split)

    def step(model, params, opt, state):
        mlm, nsp = model.apply(params, ids)
        loss = _pretrain_loss(mlm, nsp, tgt)
        return loss.detach(), dict(zip(params, torch.autograd.grad(
            loss * opt.loss_scale(state), list(params.values()))))

    out = _lamb_runs(make, step, mesh)
    out["coords"] = (mesh.index("data"), mesh.index("model"))
    return out


def _lamb_over_pipeline(sd):
    """ZeRO over FusedLAMB on a PipelinedBert, (dp 2, pp 2): the twin of
    test_zero_x_pipeline_fusedlamb."""
    mesh = parallel.create_mesh(pp=LAMB_PP)
    pipe = mesh.index("pipe")
    ids, tgt = _lamb_batch(mesh.index("data"))
    cfg = _lamb_cfg(4)

    def make():
        module = tb.PipelinedBert(cfg, mesh, LAMB_PP, 2, batch_axis="data",
                                  device="cpu", seed=None)
        module.load_state_dict(tb.dense_to_rank(sd, cfg, LAMB_PP, pipe))
        stage = {k: k.startswith("stages.")
                 for k, _ in module.named_parameters()}
        return module, FusedLAMB(lr=1e-2).with_model_parallel(
            mesh.group("pipe"), stage)

    def step(model, params, opt, state):
        return model.loss_and_grad_1f1b(params, ids, _pretrain_loss, tgt)

    out = _lamb_runs(make, step, mesh)
    out["coords"] = (mesh.index("data"), pipe)
    return out


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
        lamb = torch.load(f"{tmpdir}/lamb.pt")
        out["lamb_tp"] = _lamb_over_tp(mesh, lamb["tp"])
        out["lamb_pp"] = _lamb_over_pipeline(lamb["pp"])
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


def _jax_bert(layers):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    c = _lamb_cfg(layers)
    cfg = jm.BertConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})
    return jax.tree.map(np.asarray, jm.BertForPreTraining(cfg).init(
        jax.random.PRNGKey(1), jnp.ones((2, 16), jnp.int32))["params"])


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
    torch.save({k: tb.params_from_jax(_jax_bert(layers), _lamb_cfg(layers))
                for k, layers in (("tp", 2), ("pp", 4))}, tmp / "lamb.pt")
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


@pytest.mark.parametrize("case", ["lamb_tp", "lamb_pp"])
def test_zero_over_lamb_matches_the_replicated_state(ranks, case):
    for out in ranks:
        got = out[case]
        assert got["loss_err"] <= LAMB_TOL, got["loss_err"]
        assert got["param_err"] <= LAMB_TOL, got["param_err"]
        assert got["unshard_err"] <= LAMB_TOL, got["unshard_err"]
        assert got["reshard_bitwise"]
        full, shard = got["state_bytes"]
        assert shard < full / 1.8, got["state_bytes"]


def _jax_lamb_trajectory(layers):
    """The JAX package's O0 FusedLAMB run from the port's init
    (``_jax_bert``) over the whole batch of both data ranks: the loss of
    each step and the params after it, as the dense model's state
    dicts."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    c = _lamb_cfg(layers)
    model, opt = jamp.initialize(jm.BertForPreTraining(jm.BertConfig(**{
        f: getattr(c, f) for f in (
            "vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size",
            "max_position_embeddings", "hidden_dropout_prob",
            "attention_probs_dropout_prob")})), jopt.FusedLAMB(lr=1e-2),
        opt_level="O0", verbosity=0)
    rng = np.random.RandomState(3)
    ids = jnp.asarray(rng.randint(0, 128, (DP * B, 16)))
    mlm_t = jax.nn.one_hot(rng.randint(0, 128, (DP * B, 16)), 128)
    nsp_t = jax.nn.one_hot(rng.randint(0, 2, (DP * B,)), 2)

    @jax.jit
    def step(params, state):
        def loss_fn(p):
            mlm, nsp = model.apply({"params": p}, ids, deterministic=True)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(mlm) * mlm_t, -1)) \
                - jnp.mean(jnp.sum(jax.nn.log_softmax(nsp) * nsp_t, -1))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return opt.step(params, grads, state) + (loss,)

    params = jax.tree.map(jnp.asarray, _jax_bert(layers))
    state = opt.init(params)
    losses, steps = [], []
    for _ in range(LAMB_STEPS):
        params, state, loss = step(params, state)
        losses.append(float(loss))
        steps.append(tb.params_from_jax(jax.tree.map(np.asarray, params),
                                        c))
    return losses, steps


@pytest.mark.parametrize("case", ["lamb_tp", "lamb_pp"])
def test_zero_over_lamb_matches_jax(ranks, case):
    """Both port runs of ZeRO over FusedLAMB, the replicated state's and
    ZeRO-1's, against the JAX package's FusedLAMB on the dense model
    from the same init and batch: each step's loss within
    ``LAMB_JAX_TOL`` relative, each rank's params (its TP slice, or its
    stage) within ``LAMB_JAX_TOL`` scale-aware of the JAX params cut
    the same way."""
    layers = 2 if case == "lamb_tp" else 4
    losses, steps = _jax_lamb_trajectory(layers)
    assert losses[-1] < losses[0]
    c = _lamb_cfg(layers)
    for out in ranks:
        got = out[case]
        _, r = got["coords"]
        wants = [tpar.tp_slice(sd, tpar.bert_tp_rules(),
                               c.num_attention_heads, TP, r)
                 if case == "lamb_tp"
                 else tb.dense_to_rank(sd, c, LAMB_PP, r) for sd in steps]
        for run in ("replicated", "zero"):
            traj = got["trajectory"][run]
            for a, b in zip(traj["losses"], losses):
                assert abs(a - b) <= LAMB_JAX_TOL * abs(b), (
                    run, traj["losses"], losses)
            for mine, want in zip(traj["steps"], wants):
                assert set(mine) == set(want)
                for k, w in want.items():
                    err = float((mine[k] - w).abs().max()) / (
                        float(w.abs().max()) + 1.0)
                    assert err <= LAMB_JAX_TOL, (run, k, err)


def test_zero_over_lamb_shards_are_the_jax_placement(ranks):
    """Each rank's moment shard of a PipelinedBert leaf holds as many
    elements as the JAX placement's device shard of
    ``test_zero_x_pipeline_fusedlamb``'s ``like_params`` layout (here on
    a (data 2, pipe 2) mesh): the stage cut and the data cut."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    c = _lamb_cfg(4)
    jmesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(DP, LAMB_PP),
                 ("data", "pipe"))
    pb = jm.PipelinedBert(jm.BertConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")}), jmesh, pp=LAMB_PP,
        num_microbatches=2, batch_axis="data")
    params = pb.shard_variables(pb.init(
        jax.random.PRNGKey(1), jnp.ones((4, 16), jnp.int32)))["params"]
    cut = jpar.shard_optimizer_state(jopt.FusedLAMB(lr=1e-2).init(params),
                                     jmesh, axis="data", like_params=params)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(cut.m):
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        name = re.sub(r"\.(kernel|embedding)$", ".weight", name)
        want[name] = int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
    staged = 0
    for out in ranks:
        got = out["lamb_pp"]["shard_numel"]
        assert set(got) == set(want)
        for name, n in want.items():
            assert got[name] == n, name
            # a stage leaf: this rank's stage alone, cut over the data
            staged += name.startswith("stages.") and \
                n * DP == out["lamb_pp"]["param_numel"][name]
    assert staged > 0


def test_zero_refusals():
    params = {"w": torch.zeros(8, 8)}
    tree = FusedAdam(layout="tree")
    with pytest.raises(ValueError, match="flat-layout FusedAdam"):
        parallel.zero2_update(tree, params, params, tree.init(params),
                              parallel.mesh.WORLD)
