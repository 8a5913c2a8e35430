"""PipelinedBert and FusedLAMB's pipeline options in apex_tpu_torch
against apex_tpu's.

BERT-tiny with 4 layers (vocab 1024, hidden 128, 4 heads, MLP 256),
batch 4, sequence 16 with the last 4 keys padded, 2 microbatches, run
by gloo ranks, one stage a rank, at pp 2 and at (dp 2, pp 2), against
the JAX ``PipelinedBert`` on the conftest's CPU mesh of the same shape,
from the JAX model's initial params (``params_from_jax(..., rank=r)``):

- GPipe (``forward``): the MLM and NSP logits, and the gradients of a
  pretraining loss through it (the data mean taken by
  ``DistributedDataParallel`` over the data group), fp32 within 1e-5
  scale-aware;
- 1F1B (``loss_and_grad_1f1b``): loss and every gradient, the embeddings
  through the pipeline's input gradient and the heads as the schedule's
  loss params (a data index's, meaned over the data group by
  ``DistributedDataParallel`` as the JAX method returns them), within
  1e-5;
- dropout 0.1 (hidden and attention) at pp 2: 1F1B's loss and
  gradients within 1e-5 of the JAX model's at the same key (so every
  mask is the JAX model's), GPipe's autodiff within 1e-5 of 1F1B's
  (the rematerialized forward draws the forward's masks), and the stage
  key chain equal to ``jax.random.fold_in``'s bit for bit;
- ``AmpModel.loss_and_grad_1f1b`` under O2: within 2e-2 of the JAX amp
  passthrough, the gradients in the fp32 masters' dtype;
- ``FusedLAMB.with_model_parallel`` over the pipe group: one update of
  a rank's leaves (lr 1, eps 1, every ratio 1, so each delta is about
  ``-g / clip``) equals the JAX optimizer's update over the whole tree
  within 1e-5 of the deltas' size, the clipping norm taken over both
  stages (a norm per rank is off by the other stage's share);
- ``FusedLAMB(per_slice_trust_ratio=...)`` on a stacked leaf equals the
  JAX optimizer's, and the port's per-tensor ratios on rank r equal the
  JAX per-slice ratios of stage r; ``add_param_group`` carries the
  moments over by name as the JAX optimizer's does;
- ``tp_axis`` builds (TP inside the pipeline; its parity is
  ``tests/test_torch_tp_pp.py``): on a model axis of one rank the model
  is whole and its spec tree is the JAX ``pipeline_param_specs``' (the
  pipe axis on the stage leaves, the model axis where a rule applies);
  a model axis of more ranks needs an initialized process group;
  ``seq_axis`` without an ``attention_fn`` the reference's
  ``ValueError``.

The ranks are spawned once for each mesh (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.optimizers import FusedLAMB

B, S, M, PP = 4, 16, 2, 2
TOL, O2_TOL = 1e-5, 2e-2
SPAWN_LIMIT = 120.0
KEY = (0, 7)            # jax.random.PRNGKey(7)


def _cfg(dropout=0.0):
    return tb.BertConfig(vocab_size=1024, hidden_size=128,
                         num_hidden_layers=4, num_attention_heads=4,
                         intermediate_size=256, max_position_embeddings=64,
                         hidden_dropout_prob=dropout,
                         attention_probs_dropout_prob=dropout)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int32)
    mask = np.pad(np.ones((B, S - 4), np.int32), ((0, 0), (0, 4)))
    mlm = rng.randint(0, 1024, (B, S)).astype(np.int32)
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, mask, {"mlm": mlm, "nsp": nsp}


def rel_err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _loss(mlm, nsp, tgt):
    """The JAX test's pretraining objective (mean over rows)."""
    v = mlm.shape[-1]
    return F.cross_entropy(mlm.float().reshape(-1, v),
                           tgt["mlm"].reshape(-1).long()) \
        + F.cross_entropy(nsp.float(), tgt["nsp"].long())


# -- the ranks ---------------------------------------------------------------

def _model(cfg, mesh, sd, dp):
    model = tb.PipelinedBert(cfg, mesh, PP, M,
                             batch_axis="data" if dp > 1 else None,
                             device="cpu", seed=None)
    model.load_state_dict(sd)
    return model


def _rows(a, d, dp):
    n = a.shape[0] // dp
    return torch.from_numpy(np.asarray(a[d * n:(d + 1) * n]))


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        dp = world // PP
        mesh = parallel.create_mesh(pp=PP)
        d, r = mesh.index("data"), mesh.index("pipe")
        init = torch.load(f"{tmpdir}/init.pt")
        ids, mask, tgt = _batch()
        ids, mask = _rows(ids, d, dp), _rows(mask, d, dp)
        tgt = {k: _rows(v, d, dp) for k, v in tgt.items()}
        out = {}
        model = _model(_cfg(), mesh, init[r], dp)
        params = dict(model.named_parameters())
        mlm, nsp = model(ids, mask)
        grads = torch.autograd.grad(_loss(mlm, nsp, tgt),
                                    list(params.values()))
        ddp = parallel.DistributedDataParallel(
            process_group=mesh.group("data"))
        out["gpipe"] = {"mlm": mlm.detach(), "nsp": nsp.detach(),
                        "grads": ddp.reduce_gradients(
                            dict(zip(params, grads)))}
        loss, grads = model.loss_and_grad_1f1b(ids, _loss, tgt,
                                               attention_mask=mask)
        # the data index's loss and grads, meaned over the data group as
        # the JAX method returns them
        mean = ddp.reduce_gradients({"loss": loss.reshape(1), **grads})
        out["1f1b"] = {"loss": mean.pop("loss")[0], "grads": mean}
        if dp == 1:
            drop = _model(_cfg(0.1), mesh, init[r], dp)
            params = dict(drop.named_parameters())
            mlm, nsp = drop(ids, mask, deterministic=False,
                            dropout_key=KEY)
            gloss = _loss(mlm, nsp, tgt)
            ggrads = torch.autograd.grad(gloss, list(params.values()))
            loss, grads = drop.loss_and_grad_1f1b(
                ids, _loss, tgt, attention_mask=mask, deterministic=False,
                dropout_key=KEY)
            out["drop"] = {"gpipe_loss": gloss.detach(),
                           "gpipe_grads": dict(zip(params, ggrads)),
                           "loss": loss, "grads": grads,
                           "keys": [drop._stage_dropout_key(KEY, j)
                                    for j in range(M)]}
            o2 = amp.initialize(_model(_cfg(), mesh, init[r], dp), None,
                                opt_level="O2", verbosity=0)
            p32 = o2.init()
            loss, grads = o2.loss_and_grad_1f1b(p32, ids, _loss, tgt,
                                                attention_mask=mask)
            out["o2"] = {"loss": loss, "grads": grads,
                         "dtypes": {k: g.dtype for k, g in grads.items()}}
            out["lamb"] = _lamb_step(mesh, init[r])
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _lamb_grads(sd, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) for k, v in sd.items()}


LAMB = dict(lr=1.0, eps=1.0, max_grad_norm=0.1, weight_decay=0.0)


def _lamb_step(mesh, sd):
    """One update with every ratio 1, lr 1 and eps 1, where each delta is
    about -g / clip: the clip's norm shows in every leaf."""
    from apex_tpu_torch.parallel.pipeline import _place
    r = _place(mesh.group("pipe"))[0]
    # the JAX test's grads: each stage's leaves drawn with the stage's
    # seed, the replicated ones with one seed on every rank
    grads = _lamb_grads(sd, 5)
    grads.update({k: v for k, v in _lamb_grads(sd, 10 + r).items()
                  if k.startswith("stages.")})
    opt = FusedLAMB(exclude_from_layer_adaptation=lambda n: True, **LAMB)
    opt = opt.with_model_parallel(mesh.group("pipe"), {
        k: k.startswith("stages.") for k in sd})
    params = {k: v.clone() for k, v in sd.items()}
    return opt.update(grads, opt.init(params), params)[0]


@pytest.fixture(scope="module")
def jax_init():
    import jax
    from apex_tpu import models as jm
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:PP]), ("pipe",))
    pb = jm.PipelinedBert(_jcfg(), mesh, pp=PP, num_microbatches=M)
    ids, mask, _ = _batch()
    variables = pb.init(jax.random.PRNGKey(1), ids, mask)
    return jax.tree.map(np.asarray, variables["params"])


def _jcfg(dropout=0.0):
    from apex_tpu import models as jm
    c = _cfg(dropout)
    return jm.BertConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})


def _spawn(world, tmp, jax_init):
    torch.save([tb.params_from_jax(jax_init, _cfg(), rank=r)
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
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


_RANKS = {}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    """``spawned(world)``: the ranks' results at (world / 2, 2), spawned
    once for each world."""
    def get(world):
        if world not in _RANKS:
            _RANKS[world] = _spawn(world, tmp_path_factory.mktemp(
                f"pb{world}"), jax_init)
        return _RANKS[world]
    return get


# -- the JAX side ------------------------------------------------------------

def _jloss(mlm, nsp, tgt):
    import jax
    import jax.numpy as jnp
    oh = jax.nn.one_hot(tgt["mlm"], mlm.shape[-1])
    l1 = -jnp.mean(jnp.sum(jax.nn.log_softmax(mlm) * oh, -1))
    oh2 = jax.nn.one_hot(tgt["nsp"], 2)
    l2 = -jnp.mean(jnp.sum(jax.nn.log_softmax(nsp) * oh2, -1))
    return l1 + l2


def _jmodel(world, dropout=0.0):
    import jax
    from apex_tpu import models as jm
    from jax.sharding import Mesh
    dp = world // PP
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(dp, PP),
                ("data", "pipe"))
    return jm.PipelinedBert(_jcfg(dropout), mesh, pp=PP, num_microbatches=M,
                            batch_axis="data" if dp > 1 else None), mesh


_JAX = {}


def _jax_runs(world, jax_init):
    """The JAX model's GPipe and 1F1B (and at pp 2 its dropout and amp
    O2 runs) on the same batch; cached by world."""
    if world in _JAX:
        return _JAX[world]
    import jax
    from apex_tpu import amp as jamp
    ids, mask, tgt = _batch()
    pb, mesh = _jmodel(world)
    v = {"params": jax_init}

    def gpipe_loss(p, rngs=None, model=pb):
        mlm, nsp = model.apply({"params": p}, ids, mask,
                               deterministic=rngs is None, rngs=rngs)
        return _jloss(mlm, nsp, tgt), (mlm, nsp)

    with mesh:
        (_, (mlm, nsp)), g = jax.jit(jax.value_and_grad(
            gpipe_loss, has_aux=True))(jax_init)
        loss1, g1 = jax.jit(lambda v: pb.loss_and_grad_1f1b(
            v, ids, _jloss, tgt, attention_mask=mask))(v)
    out = {"gpipe": (mlm, nsp, g), "1f1b": (loss1, g1)}
    if world == PP:
        pd, mesh = _jmodel(world, 0.1)
        rngs = {"dropout": jax.random.PRNGKey(7)}
        model = jamp.initialize(pb, None, opt_level="O2", verbosity=0)
        with mesh:
            loss_d, g_d = jax.jit(lambda v: pd.loss_and_grad_1f1b(
                v, ids, _jloss, tgt, attention_mask=mask,
                deterministic=False, rngs=rngs))(v)
            loss_o2, g_o2 = jax.jit(lambda v: model.loss_and_grad_1f1b(
                v, ids, _jloss, tgt, attention_mask=mask))(v)
        out["drop"] = (loss_d, g_d)
        out["o2"] = (loss_o2, g_o2)
    _JAX[world] = out
    return out


def _port_grads(jax_grads, r):
    """The JAX gradient tree as rank r's named gradients."""
    import jax
    return tb.params_from_jax(jax.tree.map(np.asarray, jax_grads), _cfg(),
                              rank=r)


def _check_grads(got, want, tol, label):
    assert set(got) == set(want), label
    for k in want:
        err = rel_err(got[k].float(), want[k])
        assert err <= tol, f"{label} {k}: {err:.3g}"


@pytest.mark.parametrize("world", [2, 4], ids=["pp2", "dp2pp2"])
def test_gpipe_matches_jax(spawned, jax_init, world):
    outs = spawned(world)
    dp = world // PP
    mlm, nsp, g = _jax_runs(world, jax_init)["gpipe"]
    for rank, o in enumerate(outs):
        d, r = divmod(rank, PP)
        n = B // dp
        assert rel_err(o["gpipe"]["mlm"], np.asarray(mlm)[d * n:(d + 1) * n]
                       ) <= TOL
        assert rel_err(o["gpipe"]["nsp"], np.asarray(nsp)[d * n:(d + 1) * n]
                       ) <= TOL
        _check_grads(o["gpipe"]["grads"], _port_grads(g, r), TOL,
                     f"rank {rank} GPipe")


@pytest.mark.parametrize("world", [2, 4], ids=["pp2", "dp2pp2"])
def test_onef1b_matches_jax(spawned, jax_init, world):
    outs = spawned(world)
    loss, g = _jax_runs(world, jax_init)["1f1b"]
    for rank, o in enumerate(outs):
        r = rank % PP
        assert rel_err(o["1f1b"]["loss"], loss) <= TOL
        _check_grads(o["1f1b"]["grads"], _port_grads(g, r), TOL,
                     f"rank {rank} 1F1B")


def test_dropout_matches_jax(spawned, jax_init):
    """1F1B against the JAX model's at the same key, and the port's GPipe
    autodiff against its 1F1B (the JAX oracle's
    ``test_bert_1f1b_dropout_matches_gpipe_autodiff``)."""
    import jax
    outs = spawned(PP)
    loss, g = _jax_runs(PP, jax_init)["drop"]
    for r, o in enumerate(outs):
        got = o["drop"]
        assert rel_err(got["loss"], loss) <= TOL
        _check_grads(got["grads"], _port_grads(g, r), TOL, f"rank {r}")
        assert rel_err(got["gpipe_loss"], loss) <= TOL
        _check_grads(got["gpipe_grads"], got["grads"], TOL,
                     f"rank {r} GPipe")
        for j, key in enumerate(got["keys"]):
            want = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(7), j), r)
            assert tuple(int(x) for x in np.asarray(want)) == key


def test_amp_o2_matches_jax(spawned, jax_init):
    import jax
    outs = spawned(PP)
    loss, g = _jax_runs(PP, jax_init)["o2"]
    for r, o in enumerate(outs):
        got = o["o2"]
        assert rel_err(got["loss"], loss) <= O2_TOL
        assert set(got["dtypes"].values()) == {torch.float32}
        _check_grads(got["grads"], _port_grads(
            jax.tree.map(lambda a: np.asarray(a, np.float32), g), r),
            O2_TOL, f"rank {r} O2")


def test_lamb_norm_over_the_pipe_group(spawned, jax_init):
    import jax
    from apex_tpu import optimizers as jopt
    outs = spawned(PP)
    # the whole tree: the replicated leaves once, each stage's leaves
    full = {}
    stage_grads = {}
    for r in range(PP):
        sd = tb.params_from_jax(jax_init, _cfg(), rank=r)
        g = _lamb_grads(sd, 5)
        g.update({k: v for k, v in _lamb_grads(sd, 10 + r).items()
                  if k.startswith("stages.")})
        for k, v in sd.items():
            name = k if not k.startswith("stages.") else f"{r}.{k}"
            full[name] = v.numpy()
            stage_grads[name] = g[k].numpy()
    opt = jopt.FusedLAMB(exclude_from_layer_adaptation=lambda p: True,
                         **LAMB)
    deltas, _ = jax.jit(lambda p, g: opt.update(g, opt.init(p), p))(
        full, stage_grads)
    for r, o in enumerate(outs):
        for k, v in o["lamb"].items():
            name = k if not k.startswith("stages.") else f"{r}.{k}"
            want = np.asarray(deltas[name])
            # relative to the deltas themselves (each about -g / clip)
            err = float(np.max(np.abs(v.numpy() - want))
                        / np.max(np.abs(want)))
            assert err <= TOL, (r, k, err)


def test_lamb_per_slice_and_add_param_group():
    from apex_tpu import optimizers as jopt
    rng = np.random.RandomState(0)
    w = rng.standard_normal((4, 8, 8)).astype(np.float32)
    g = rng.standard_normal((4, 8, 8)).astype(np.float32)
    jo = jopt.FusedLAMB(lr=1e-2, per_slice_trust_ratio=lambda p: True)
    want, _ = jo.step({"stages": {"w": w}}, {"stages": {"w": g}},
                      jo.init({"stages": {"w": w}}))
    po = FusedLAMB(lr=1e-2, per_slice_trust_ratio=lambda n: True)
    p = {"stages.w": torch.from_numpy(w)}
    got, _ = po.step(p, {"stages.w": torch.from_numpy(g)}, po.init(p))
    assert rel_err(got["stages.w"], want["stages"]["w"]) <= TOL
    # the port's per-tensor leaves on "rank" r: the JAX stage-r slices
    pu = FusedLAMB(lr=1e-2)
    for r in range(4):
        leaf = {"stages.w": torch.from_numpy(w[r])}
        mine, _ = pu.step(leaf, {"stages.w": torch.from_numpy(g[r])},
                          pu.init(leaf))
        assert rel_err(mine["stages.w"], want["stages"]["w"][r]) <= TOL
    # add_param_group: moments carried by name, the new group first
    params = {"a": w[0], "b": w[1]}
    grads = {"a": g[0], "b": g[1]}
    jo = jopt.FusedLAMB(lr=1e-2)
    jst = jo.step(params, grads, jo.init(params))[1]
    jo2, jst2 = jo.add_param_group(jst, params, "b", lr=1e-3,
                                   weight_decay=0.0)
    want = jo2.step(params, grads, jst2)[0]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    po = FusedLAMB(lr=1e-2)
    pst = po.step(tp, tg, po.init(tp))[1]
    po2, pst2 = po.add_param_group(pst, tp, "b", lr=1e-3, weight_decay=0.0)
    got = po2.step(tp, tg, pst2)[0]
    for k in params:
        assert rel_err(got[k], want[k]) <= TOL, k
    assert po2.param_groups[0]["match"] == "b"


def test_unported_axes_raise():
    mesh = parallel.Mesh({"pipe": 1, "model": 1}, {})
    pb = tb.PipelinedBert(_cfg(), mesh, 1, 1, device="cpu", tp_axis="model")
    specs = pb.param_spec_tree()
    assert specs["stages.layer_0.attention.query.weight"] == (
        "pipe", "model", None)
    assert specs["stages.layer_0.output_ln.scale"] == ("pipe",)
    assert specs["embed.word_embeddings.weight"] == ("model", None)
    assert specs["heads.pooler.weight"] == ()
    full = tb.BertForPreTraining(_cfg(), device="cpu", seed=0)
    assert {k: v.shape for k, v in pb.state_dict().items()} == {
        k: v.shape for k, v in tb.dense_to_rank(full.state_dict(), _cfg(),
                                                1, 0).items()}
    with pytest.raises(RuntimeError, match="initialized process group"):
        tb.PipelinedBert(_cfg(), parallel.Mesh({"pipe": 1, "model": 2}, {}),
                         1, 1, device="cpu", tp_axis="model")
    # the reference's check: a sequence axis takes a sequence-parallel
    # attention_fn
    with pytest.raises(ValueError, match="seq_axis requires"):
        tb.PipelinedBert(_cfg(), mesh, 1, 1, device="cpu", seq_axis="sp")
