"""``bert_main_amp --pp`` in apex_tpu_torch against the JAX example's step.

BERT-tiny (vocab 1024, hidden 128, 2 layers, 4 heads, MLP 256), batch 8,
sequence 32, at (dp 1, pp 2) on two gloo ranks through
``bert_main_amp.build(..., pp_microbatches=2)`` and ``train_step(...,
schedule=)``: one O0 step of the recipe's ``FusedLAMB`` (its clipping
norm over the pipe group) on the example's first synthetic batch under
``--pp-schedule gpipe`` and ``1f1b``, each with ``--grad-accum`` 1 and
2, against the JAX example's steps of the same name
(``examples/bert/main_amp.py``: ``train_step``, the 1F1B step with its
per-microbatch ``amp.scale`` and MLM factor ``n_mb * dp``, and
``make_accum_step``) on a (1, 2) mesh from the same weights: the loss
within 1e-5 relative and each rank's params after the step within 2e-5
scale-aware.  At (dp 2, pp 2) on four ranks, each data index stepping on
its half of a 16-row batch, the gradients averaged over the data group
by the example's one ``DistributedDataParallel.reduce_gradients``:
GPipe, 1F1B and 1F1B under ``--grad-accum 2`` against the JAX
example's step on the whole batch, the losses' data mean within 1e-5
relative and the params within 2e-5.  ``train()`` with ``pp=2`` runs both schedules to the same
losses, with ``remat=True`` too (each stage's layers rematerialized).
The CLI's refusals: ``--moe`` with a sequence axis under
``--pp-schedule 1f1b`` raises ``PipelinedBert``'s message before any
rank starts, and ``--pp-schedule 1f1b`` with ring attention,
``--pp-schedule 1f1b`` without ``--pp`` and a layer count ``--pp`` does
not divide raise the JAX example's messages.

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

B, S, PP, M, LR = 8, 32, 2, 2, 1e-4
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5
SPAWN_LIMIT = 120.0
CASES = [("gpipe", 1), ("gpipe", 2), ("1f1b", 1), ("1f1b", 2)]
DP_CASES = [("gpipe", 1), ("1f1b", 1), ("1f1b", 2)]


def rel_err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        cfg = bert.get_config("tiny")
        sd = torch.load(f"{tmpdir}/init.pt")[rank]
        batch = tuple(torch.from_numpy(a)
                      for a in next(bert.batches(cfg, B, S)))
        out = {}
        for schedule, accum in CASES:
            mesh = parallel.create_mesh(pp=PP)
            model, opt, params, st = bert.build(
                cfg, lr=LR, opt_level="O0", device="cpu", state_dict=sd,
                mesh=mesh, pp_microbatches=M)
            ddp = parallel.DistributedDataParallel(
                model, process_group=mesh.group("data"))
            params, st, loss, _ = bert.train_step(
                model, opt, params, st, batch, grad_accum=accum, ddp=ddp,
                mesh=mesh, schedule=schedule)
            out[(schedule, accum)] = {
                "loss": float(loss),
                "params": {k: v.detach().clone() for k, v in params.items()}}
        out["train"] = {(s, remat): bert.train(
            cfg, batch=B, seq_len=S, steps=2, opt_level="O0", device="cpu",
            pp=PP, pp_schedule=s, pp_microbatches=M, remat=remat)["losses"]
            for s in ("gpipe", "1f1b") for remat in (False, True)}
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dp_rank_main(rank, world, tmpdir):
    """(dp 2, pp 2): data index d steps on rows ``d * B:(d + 1) * B`` of
    the example's first 16-row batch."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        cfg = bert.get_config("tiny")
        mesh = parallel.create_mesh(pp=PP)
        d = mesh.index("data")
        sd = torch.load(f"{tmpdir}/init.pt")[mesh.index("pipe")]
        batch = tuple(torch.from_numpy(a[d * B:(d + 1) * B])
                      for a in next(bert.batches(cfg, 2 * B, S)))
        out = {}
        for schedule, accum in DP_CASES:
            model, opt, params, st = bert.build(
                cfg, lr=LR, opt_level="O0", device="cpu", state_dict=sd,
                mesh=mesh, pp_microbatches=M)
            ddp = parallel.DistributedDataParallel(
                model, process_group=mesh.group("data"))
            params, st, loss, _ = bert.train_step(
                model, opt, params, st, batch, grad_accum=accum, ddp=ddp,
                mesh=mesh, schedule=schedule)
            out[(schedule, accum)] = {
                "loss": float(loss),
                "params": {k: v.detach().clone() for k, v in params.items()}}
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_setup():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    mesh = Mesh(np.asarray(jax.devices()[:PP]).reshape(1, PP),
                ("data", "pipe"))
    cfg = jm.BertConfig(vocab_size=1024, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=256, max_position_embeddings=512)
    model_def = jm.PipelinedBert(cfg, mesh, pp=PP, num_microbatches=M,
                                 batch_axis="data")
    opt_def = jopt.FusedLAMB(
        lr=LR, max_grad_norm=1.0,
        param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
        exclude_from_layer_adaptation=lambda path: any(
            "bias" in str(k) or "_ln" in str(k) for k in path),
        per_slice_trust_ratio=lambda path: any("stages" in str(k)
                                               for k in path))
    model, optimizer = jamp.initialize(model_def, opt_def, opt_level="O0",
                                       verbosity=0)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, S), jnp.int32))["params"]
    return mesh, model, optimizer, params


def _jax_step(setup, schedule, accum, batch):
    """The JAX example's step for ``schedule`` and ``--grad-accum``."""
    import jax
    import jax.numpy as jnp
    import optax
    from apex_tpu import amp as jamp
    mesh, model, optimizer, params = setup
    opt_state = optimizer.init(params)
    ids, labels, weights, nsp = (jnp.asarray(a) for a in batch)
    dp = 1

    def batch_loss(p, ids, labels, weights, nsp, denom, div):
        mlm_logits, nsp_logits = model.apply({"params": p}, ids,
                                             deterministic=True)
        mlm = optax.softmax_cross_entropy_with_integer_labels(
            mlm_logits, labels)
        return (jnp.sum(mlm * weights) / denom
                + optax.softmax_cross_entropy_with_integer_labels(
                    nsp_logits, nsp).mean() / div)

    def onef1b_slice(p, st, ids_j, labels_j, weights_j, nsp_j, denom, div):
        def mb_loss(mlm_logits, nsp_logits, tgt):
            mlm = jnp.sum(optax.softmax_cross_entropy_with_integer_labels(
                mlm_logits, tgt["labels"]) * tgt["weights"]) \
                * (M * dp) / denom
            nsp_l = optax.softmax_cross_entropy_with_integer_labels(
                nsp_logits, tgt["nsp"]).mean() / div
            return jamp.scale(mlm + nsp_l, st)
        return model.loss_and_grad_1f1b(
            {"params": p}, ids_j, mb_loss,
            {"labels": labels_j, "weights": weights_j, "nsp": nsp_j})

    def slice_grads(p, st, ids_j, labels_j, weights_j, nsp_j, denom, div):
        if schedule == "1f1b":
            loss_s, grads = onef1b_slice(p, st, ids_j, labels_j, weights_j,
                                         nsp_j, denom, div)
            return loss_s / optimizer.loss_scale(st), grads

        def loss_fn(p):
            loss = batch_loss(p, ids_j, labels_j, weights_j, nsp_j, denom,
                              div)
            with jamp.scale_loss(loss, st) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(p)
        return loss, grads

    @jax.jit
    def step(params, opt_state):
        denom = jnp.maximum(jnp.sum(weights), 1.0)
        if accum == 1:
            loss, grads = slice_grads(params, opt_state, ids, labels,
                                      weights, nsp, denom, 1.0)
            params, opt_state = optimizer.step(params, grads, opt_state)
            return params, loss
        mb = lambda a: jnp.stack([a[j::accum] for j in range(accum)])
        ids_m, labels_m, weights_m, nsp_m = map(mb, (ids, labels, weights,
                                                    nsp))
        stashed, overflow, st, total = None, jnp.asarray(False), opt_state, 0
        for j in range(accum):
            loss_j, grads = slice_grads(params, st, ids_m[j], labels_m[j],
                                        weights_m[j], nsp_m[j], denom,
                                        float(accum))
            grads, ovf, st = optimizer.unscale_grads(
                grads, st, 0, stashed=stashed, update_scale=False)
            stashed, overflow, total = grads, overflow | ovf, total + loss_j
        st = optimizer.update_scale(st, overflow, 0)
        params, st = optimizer.apply_gradients(params, stashed, st, overflow)
        return params, total

    with mesh:
        return step(params, opt_state)


@pytest.fixture(scope="module")
def setup():
    return _jax_setup()


def _spawn(fn, world, tmp_path_factory, setup):
    import jax
    tmp = tmp_path_factory.mktemp("bert_pp")
    init = jax.tree.map(np.asarray, setup[3])
    cfg = bert.get_config("tiny")
    torch.save([params_from_jax(init, cfg, rank=r) for r in range(PP)],
               tmp / "init.pt")
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in time")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, setup):
    return _spawn(_rank_main, PP, tmp_path_factory, setup)


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory, setup):
    return _spawn(_dp_rank_main, 2 * PP, tmp_path_factory, setup)


@pytest.mark.parametrize("schedule,accum", CASES)
def test_step_matches_jax_example(ranks, setup, schedule, accum):
    import jax
    cfg = bert.get_config("tiny")
    batch = next(bert.batches(cfg, B, S))
    params, loss = _jax_step(setup, schedule, accum, batch)
    params = jax.tree.map(np.asarray, params)
    for r, o in enumerate(ranks):
        got = o[(schedule, accum)]
        assert abs(got["loss"] - float(loss)) <= LOSS_TOL * abs(float(loss))
        want = params_from_jax(params, cfg, rank=r)
        for k, v in want.items():
            assert rel_err(got["params"][k], v) <= PARAM_TOL, (r, k)


@pytest.mark.parametrize("schedule,accum", DP_CASES)
def test_dp_step_matches_jax_example(dp_ranks, setup, schedule, accum):
    """Each data index's loss is its own; their mean is the JAX step's on
    the whole batch, and the params after the step are its."""
    import jax
    cfg = bert.get_config("tiny")
    batch = next(bert.batches(cfg, 2 * B, S))
    params, loss = _jax_step(setup, schedule, accum, batch)
    params = jax.tree.map(np.asarray, params)
    mean = np.mean([dp_ranks[d * PP][(schedule, accum)]["loss"]
                    for d in range(2)])
    assert abs(mean - float(loss)) <= LOSS_TOL * abs(float(loss))
    for rank, o in enumerate(dp_ranks):
        got = o[(schedule, accum)]
        want = params_from_jax(params, cfg, rank=rank % PP)
        for k, v in want.items():
            assert rel_err(got["params"][k], v) <= PARAM_TOL, (rank, k)


def test_train_runs_both_schedules_and_remat(ranks):
    for o in ranks:
        gpipe = o["train"][("gpipe", False)]
        assert len(gpipe) == 2 and np.all(np.isfinite(gpipe))
        for key, losses in o["train"].items():
            np.testing.assert_allclose(losses, gpipe, rtol=LOSS_TOL,
                                       err_msg=str(key))


@pytest.mark.parametrize("argv,phrase", [
    (["--pp", "1", "--ring-attention", "1", "--pp-schedule", "1f1b"],
     "--pp-schedule 1f1b cannot host ring attention"),
    (["--moe", "4", "--pp", "1", "--ring-attention", "1",
      "--sp-attention", "ulysses", "--pp-schedule", "1f1b"],
     r"seq_axis \+ MoE under 1F1B"),
    (["--pp-schedule", "1f1b"], "--pp-schedule 1f1b needs --pp S"),
    (["--config", "tiny", "--pp", "4"],
     r"PP=4 must divide devices \(1\) and layers \(2\)"),
])
def test_cli_refusals(argv, phrase):
    with pytest.raises(SystemExit, match=phrase):
        bert.main(argv)
