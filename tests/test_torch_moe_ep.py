"""Expert parallelism and MoE inside the pipeline in apex_tpu_torch
against apex_tpu's, on gloo ranks.

Two worlds, each spawned once for the module; the rank functions import
no JAX, the JAX side runs the reference's calls on this process's eight
CPU devices.  fp32 but where a step says O2.

Eight ranks:

- EP on the world as one ``("expert",)`` group of 8 with E 8 (the
  reference's mesh; ``test_ep_placement_matches_replicated``), both
  dispatches, B 4, S 16, H 32, F 64: each rank's experts cut by
  ``shard_params(..., EP_RULES)``; out within rtol 1e-5 / atol 1e-6 and
  aux rtol 1e-6 of the JAX replicated module, the gradients of x, the
  router and the rank's expert of a weighted sum of out and aux within
  1e-5 scale-aware (the router's and x's whole on every rank); a rank
  holds 1/8 of the expert bytes;
- O2 EP train steps (``test_capacity_ep_train_step``,
  ``test_ep_amp_train_step_keeps_sharding``,
  ``test_bert_moe_ep_train_step``, the port's optax ``adam``): finite
  losses that fall, equal on every rank, each rank's expert slice kept;
  BERT's EP forward at O0 equal to the replicated model's from the same
  seed;
- ``PipelinedBert`` with MoE at dp 2 x pp 4 (``test_pipeline.py:976``)
  and dp 2 x tp 2 x pp 2 (``:1024``), both dispatches: GPipe's ``(mlm,
  nsp, aux)`` against the JAX pipelined model's ``apply`` (1e-5; the
  ``:387`` relation, the aux the data group's mean), 1F1B with
  ``moe_aux_weight`` 0.01 against GPipe autograd and against the JAX
  model's ``loss_and_grad_1f1b``: the loss within 1e-5 relative, every
  gradient within rtol 3e-4 / atol 1e-5, every stage's router gradient
  nonzero;
- ``bert_main_amp --moe 4 --pp 2 --ring-attention 2`` at dp 2 (GPipe, the
  example's tiny config): one O0 step's data-mean loss within 1e-5
  relative and its gradients within 1e-5 scale-aware of the JAX
  example's step on the (data, sp, pipe) mesh.

Two ranks: ``bert_main_amp`` with ``--config tiny --moe 4`` at dp 2 (the
aux's token fractions averaged over the data group) against the JAX
example's step on a two-device data mesh, plain and with ``--grad-accum
2``, and at ``--ring-attention 2`` (dp 1: the fractions averaged over
the (data x sp) ranks, each rank's share its aux over SP) against the
JAX example's step on the whole batch, 3 O0 steps, in dense and in
capacity dispatch (factor 0.5, so tokens drop: the cap and the arrival
order are the whole batch's): the data group's mean loss (under SP the
data index's) within 1e-5 relative and the step-1 gradients and the
params after step 3 within 1e-5 scale-aware.  Without the average (each
rank's own token fractions) the routers' step-1 gradients miss the JAX
ones by more than 1e-3 of their largest element.  One capacity layer
over the two ranks, each a block of the batch's rows or positions,
gives the JAX layer's outputs on the whole batch, where each rank's own
cap and order would drop other tokens.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.examples import bert_main_amp
from apex_tpu_torch.models import EP_RULES, MoEMlp, moe_params_from_jax
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.models.moe import EXPERT_LEAVES
from apex_tpu_torch.optimizers import transforms

B, S, H, FF, E = 4, 16, 32, 64, 8
OUT_RTOL, OUT_ATOL, AUX_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-6, 1e-5
FWD_TOL, LOSS_TOL, RTOL, ATOL = 1e-5, 1e-5, 3e-4, 1e-5
W = 0.01
TRAIN_STEPS, BERT_STEPS = 6, 3
EX_ROWS, EX_S, EX_E, EX_STEPS = 8, 32, 4, 3
EX_CF = 0.5               # the capacity cases' factor: tokens drop
SPAWN_LIMIT = 240.0
PIPES = {"pp4": dict(pp=4, tp=1, layers=4, heads=4),
         "tp_pp": dict(pp=2, tp=2, layers=2, heads=2)}


def rel_err(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                + 1.0)


def _close(got, want, rtol, atol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def _pcfg(name, dispatch):
    c = PIPES[name]
    return tb.BertConfig(vocab_size=64, hidden_size=32,
                         num_hidden_layers=c["layers"],
                         num_attention_heads=c["heads"],
                         intermediate_size=64, max_position_embeddings=16,
                         hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, moe_experts=4,
                         moe_dispatch=dispatch)


def _ep_bert_cfg():
    return tb.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=16, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, moe_experts=E)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (B, S)).astype(np.int32)
    mask = np.pad(np.ones((B, S - 4), np.int32), ((0, 0), (0, 4)))
    tgt = {"mlm": rng.randint(0, 64, (B, S)).astype(np.int32),
           "nsp": rng.randint(0, 2, (B,)).astype(np.int32)}
    return ids, mask, tgt


def _loss(mlm, nsp, tgt):
    """The reference tests' pretraining objective (mean over rows)."""
    v = mlm.shape[-1]
    return F.cross_entropy(mlm.float().reshape(-1, v),
                           tgt["mlm"].reshape(-1).long()) \
        + F.cross_entropy(nsp.float(), tgt["nsp"].long())


def _weighted(out, aux, w):
    return (out * w).sum() + 0.37 * aux


def _ex_cfg(dispatch="dense"):
    import dataclasses
    return dataclasses.replace(bert_main_amp.get_config("tiny"),
                               moe_experts=EX_E, moe_dispatch=dispatch,
                               moe_capacity_factor=EX_CF)


def _ex_batches():
    data = bert_main_amp.batches(bert_main_amp.get_config("tiny"), EX_ROWS,
                                 EX_S)
    return [next(data) for _ in range(EX_STEPS)]


# -- the ranks ---------------------------------------------------------------

def _rows(a, d, dp):
    n = a.shape[0] // dp
    return torch.from_numpy(np.asarray(a[d * n:(d + 1) * n]))


def _data_mean(mesh, tree):
    return parallel.DistributedDataParallel(
        process_group=mesh.group("data")).reduce_gradients(tree)


def _expert_bytes(module):
    return sum(p.numel() * p.element_size()
               for n, p in module.named_parameters()
               if n.rsplit(".", 1)[-1] in EXPERT_LEAVES)


def _ep(init, out):
    """EP over the world: forward and gradients, the O2 train steps."""
    group = parallel.ProcessGroup()
    mesh = parallel.Mesh({"expert": dist.get_world_size()},
                         {"expert": group})
    x, w = init["x"], init["w"]
    for dispatch in ("dense", "capacity"):
        moe = MoEMlp(E, H, FF, dispatch, device="cpu", ep=group)
        moe.load_state_dict(parallel.shard_params(init["moe"], mesh,
                                                  EP_RULES))
        xg = x.clone().requires_grad_()
        o, a = moe(xg)
        names = [n for n, _ in moe.named_parameters()]
        g = torch.autograd.grad(_weighted(o, a, w),
                                [xg] + list(moe.parameters()))
        out[f"ep_{dispatch}"] = {
            "out": o.detach(), "aux": float(a), "gx": g[0],
            "grads": dict(zip(names, g[1:])),
            "expert_bytes": _expert_bytes(moe),
            "rank": group.rank()}
    for name, kw in (("capacity_train", dict(dispatch="capacity",
                                             capacity_factor=2.0)),
                     ("dense_train", {})):
        moe = MoEMlp(E, H, FF, device="cpu", ep=group, **kw)
        moe.load_state_dict(parallel.shard_params(init[name], mesh,
                                                  EP_RULES))
        model, opt = amp.initialize(moe, transforms.adam(1e-3),
                                    opt_level="O2", verbosity=0)
        params = model.init()
        st = opt.init(params)
        xt, tgt = init[f"{name}_x"], init[f"{name}_tgt"]
        losses = []
        for _ in range(TRAIN_STEPS):
            o, a = model.apply(params, xt)
            loss = torch.mean((o.float() - tgt) ** 2) + 0.01 * a
            with amp.scale_loss(loss, st) as scaled:
                grads = torch.autograd.grad(scaled, list(params.values()))
            params, st = opt.step(params, dict(zip(params, grads)), st)
            losses.append(float(loss))
        out[name] = {"losses": losses,
                     "shape": tuple(params["experts_in"].shape)}
    # BERT with MoE layers under EP: the O0 forward against the replicated
    # model from the same seed, then 3 O2 steps
    cfg = _ep_bert_cfg()
    ids = torch.ones((2, 8), dtype=torch.int64)
    labels = torch.zeros((2, 8), dtype=torch.int64)
    ep_model = tb.BertForPreTraining(cfg, device="cpu", seed=0, ep=group)
    whole = tb.BertForPreTraining(cfg, device="cpu", seed=0)
    with torch.no_grad():
        got, want = ep_model(ids), whole(ids)
    out["bert_fwd"] = {"err": max(rel_err(a, b.numpy())
                                  for a, b in zip(got, want)),
                       "aux": (float(got[2]), float(want[2]))}
    model, opt = amp.initialize(ep_model, transforms.adam(1e-3),
                                opt_level="O2", verbosity=0)
    params = model.init()
    st = opt.init(params)
    losses = []
    for _ in range(BERT_STEPS):
        mlm, _, aux = model.apply(params, ids)
        loss = F.cross_entropy(mlm.float().reshape(-1, mlm.shape[-1]),
                               labels.reshape(-1)) + 0.01 * aux
        with amp.scale_loss(loss, st) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        params, st = opt.step(params, grads, st)
        losses.append(float(loss))
    out["bert_train"] = {
        "losses": losses,
        "shape": tuple(params["encoder.layer_0.moe.experts_in"].shape)}


def _pipelined(name, init, out):
    """PipelinedBert with MoE on this pipe world's mesh, both dispatches:
    GPipe's outputs, its autograd gradients and 1F1B's, each the data
    group's mean."""
    c = PIPES[name]
    mesh = parallel.create_mesh(pp=c["pp"], tp=c["tp"])
    dp = mesh.shape["data"]
    d, pipe, m = mesh.index("data"), mesh.index("pipe"), mesh.index("model")
    ids, mask, tgt = _batch()
    ids, mask = _rows(ids, d, dp), _rows(mask, d, dp)
    tgt = {k: _rows(v, d, dp) for k, v in tgt.items()}
    res = {"coords": (d, pipe, m)}
    for dispatch in ("dense", "capacity"):
        pb = tb.PipelinedBert(_pcfg(name, dispatch), mesh, c["pp"], 2,
                              batch_axis="data",
                              tp_axis="model" if c["tp"] > 1 else None,
                              device="cpu", seed=None)
        pb.load_state_dict(init[name][(pipe, m)])
        params = dict(pb.named_parameters())
        mlm, nsp, aux = pb(ids, mask)
        total = _loss(mlm, nsp, tgt) + W * aux
        g = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
        gpipe = _data_mean(mesh, {"loss": total.detach().reshape(1),
                                  "aux": aux.detach().reshape(1), **g})
        loss, grads = pb.loss_and_grad_1f1b(ids, _loss, tgt,
                                            attention_mask=mask,
                                            moe_aux_weight=W)
        onef1b = _data_mean(mesh, {"loss": loss.detach().reshape(1),
                                   **pb.constrain_grads(grads)})
        res[dispatch] = {"mlm": mlm.detach(), "nsp": nsp.detach(),
                         "gpipe": gpipe, "1f1b": onef1b}
    out[name] = res


def _example_pp_sp(init, out):
    """``bert_main_amp --moe 4 --pp 2 --ring-attention 2`` at dp 2, one
    GPipe step at O0 through ``build``/``train_step``: the data index's
    loss and the gradients the (data x sp) ranks' DDP gives."""
    mesh = parallel.create_mesh(sp=2, pp=2)
    d, r, pipe = mesh.index("data"), mesh.index("sp"), mesh.index("pipe")
    model, opt, params, st = bert_main_amp.build(
        _ex_cfg(), opt_level="O0", device="cpu",
        state_dict=init["pp_sp"][pipe], mesh=mesh, sp_attention="ring",
        pp_microbatches=2)
    ddp = parallel.DistributedDataParallel(
        model, process_group=mesh.group("data_sp"))
    batch = tuple(_rows(a, d, 2) for a in _ex_batches()[0])
    params, st, loss, grads = bert_main_amp.train_step(
        model, opt, params, st, batch, ddp=ddp, mesh=mesh,
        schedule="gpipe")
    out["pp_sp"] = {"loss": float(loss), "grads": grads,
                    "coords": (d, r, pipe)}


def _rank8(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        init = torch.load(f"{tmpdir}/init.pt")
        out = {}
        _ep(init, out)
        for name in PIPES:
            _pipelined(name, init, out)
        _example_pp_sp(init, out)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _whole_batch_capacity(init, out):
    """One capacity MoE layer (factor ``EX_CF``) over the world's ranks,
    each holding a block of the batch: its rows (``"data"``) or its
    positions (``"seq"``), with the world as ``aux_group`` and, for
    comparison, without it (each rank its own cap and order)."""
    group, r = parallel.ProcessGroup(), dist.get_rank()
    x = init["cap_x"]
    for layout, shards in (("data", 1), ("seq", 2)):
        n = x.shape[0 if layout == "data" else 1] // dist.get_world_size()
        xl = x[r * n:(r + 1) * n] if layout == "data" \
            else x[:, r * n:(r + 1) * n]
        for rule, aux_group in (("batch", group), ("local", None)):
            moe = MoEMlp(E, H, FF, "capacity", EX_CF, device="cpu",
                         aux_group=aux_group, seq_shards=shards)
            moe.load_state_dict(init["cap_moe"])
            with torch.no_grad():
                o, a = moe(xl)
            out[f"cap_{layout}_{rule}"] = {"out": o, "aux": float(a)}


def _rank2(rank, world, tmpdir):
    """The example's dp 2 steps, each rank its half of every global batch,
    the token fractions averaged over the data group, and again without;
    dense and capacity dispatch."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        init = torch.load(f"{tmpdir}/init.pt")
        out = {}
        _whole_batch_capacity(init, out)
        world_group = parallel.ProcessGroup()
        for case, accum, group in (("plain", 1, world_group),
                                   ("grad_accum", 2, world_group),
                                   ("local_aux", 1, None), ("ring", 1, None),
                                   ("cap_plain", 1, world_group),
                                   ("cap_grad_accum", 2, world_group),
                                   ("cap_ring", 1, None)):
            cfg = _ex_cfg("capacity" if case.startswith("cap_") else "dense")
            mesh = parallel.create_mesh(sp=2) if case.endswith("ring") \
                else None
            model, opt, params, st = bert_main_amp.build(
                cfg, opt_level="O0", device="cpu",
                state_dict=init["example"], moe_aux_group=group, mesh=mesh)
            ddp = parallel.DistributedDataParallel(
                model, process_group=None if mesh is None
                else mesh.group("data_sp"))
            losses, grads1 = [], None
            for host in _ex_batches():
                # --ring-attention: each rank takes its data index's whole
                # batch and runs its half of the tokens
                batch = tuple(torch.from_numpy(a) if mesh is not None
                              else _rows(a, rank, world) for a in host)
                params, st, loss, grads = bert_main_amp.train_step(
                    model, opt, params, st, batch, grad_accum=accum,
                    ddp=ddp, mesh=mesh)
                losses.append(float(loss))
                grads1 = grads if grads1 is None else grads1
            out[case] = {"losses": losses, "grads1": grads1,
                         "params": {k: v.detach() for k, v in
                                    params.items()}}
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- the JAX side ------------------------------------------------------------

def _jcfg(cfg):
    import dataclasses
    from apex_tpu import models as jm
    return jm.BertConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _jmesh(name):
    import jax
    from jax.sharding import Mesh
    c = PIPES[name]
    devs = np.asarray(jax.devices()[:8])
    if c["tp"] > 1:
        return Mesh(devs.reshape(2, c["tp"], c["pp"]),
                    ("data", "model", "pipe"))
    return Mesh(devs.reshape(2, c["pp"]), ("data", "pipe"))


def _jpipe(name, dispatch):
    from apex_tpu import models as jm
    c = PIPES[name]
    return jm.PipelinedBert(_jcfg(_pcfg(name, dispatch)), _jmesh(name),
                            pp=c["pp"], num_microbatches=2,
                            batch_axis="data",
                            tp_axis="model" if c["tp"] > 1 else None)


def _jpretrain(mlm, nsp, t):
    import jax
    import jax.numpy as jnp
    oh = jax.nn.one_hot(t["mlm"], mlm.shape[-1])
    l1 = -jnp.mean(jnp.sum(jax.nn.log_softmax(mlm) * oh, -1))
    oh2 = jax.nn.one_hot(t["nsp"], 2)
    return l1 - jnp.mean(jnp.sum(jax.nn.log_softmax(nsp) * oh2, -1))


def _jmoe(seed, **kw):
    """The reference's ``_setup`` (and its train tests' inits)."""
    import jax
    from apex_tpu import models as jm
    moe = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=FF, **kw)
    x = jax.random.normal(jax.random.PRNGKey(seed), (B, S, H))
    params = moe.init(jax.random.PRNGKey(seed + 1), x)["params"]
    return moe, params, x


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    ids, mask, _ = (jax.tree.map(jnp.asarray, a) for a in _batch())
    out = {"moe": _jmoe(0), "capacity_train": _jmoe(13, dispatch="capacity",
                                                    capacity_factor=2.0),
           "dense_train": _jmoe(5),
           "w": jax.random.normal(jax.random.PRNGKey(9), (B, S, H)),
           "tgt": {"capacity_train": jax.random.normal(
                       jax.random.PRNGKey(15), (B, S, H)),
                   "dense_train": jax.random.normal(jax.random.PRNGKey(6),
                                                    (B, S, H))}}
    for name in PIPES:
        # one init a world: the dispatch does not change the parameters
        out[name] = jax.tree.map(np.asarray, _jpipe(name, "dense").init(
            jax.random.PRNGKey(1), ids, mask)["params"])
    out["pp_sp"] = _jax_pp_sp()
    return out


def _jax_pp_sp():
    """The JAX example's GPipe step with ``--moe 4 --pp 2
    --ring-attention 2`` on a (2, 2, 2) (data, sp, pipe) mesh at O0:
    its initial params (stacked stages), loss and gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("data", "sp", "pipe"))
    model_def = jm.PipelinedBert(_jcfg(_ex_cfg()), mesh, pp=2,
                                 num_microbatches=2, batch_axis="data",
                                 seq_axis="sp",
                                 attention_fn=jpar.make_ring_attention("sp"))
    model, optimizer = jamp.initialize(
        model_def, jopt.FusedLAMB(
            lr=1e-4, max_grad_norm=1.0,
            param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
            exclude_from_layer_adaptation=lambda path: any(
                "bias" in str(k) or "_ln" in str(k) for k in path),
            per_slice_trust_ratio=lambda path: any(
                "stages" in str(k) for k in path)),
        opt_level="O0", verbosity=0)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, EX_S), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    params = model_def.shard_variables({"params": params})["params"]
    opt_state = optimizer.init(params)
    ids, labels, weights, nsp = (jax.device_put(
        jnp.asarray(a), NamedSharding(mesh, P("data")))
        for a in _ex_batches()[0])

    def loss_fn(p):
        mlm_logits, nsp_logits, aux = model.apply({"params": p}, ids,
                                                  deterministic=True)
        mlm = optax.softmax_cross_entropy_with_integer_labels(mlm_logits,
                                                              labels)
        loss = jnp.sum(mlm * weights) / jnp.maximum(jnp.sum(weights), 1.0)
        loss = loss + optax.softmax_cross_entropy_with_integer_labels(
            nsp_logits, nsp).mean() + 0.01 * aux
        with jamp.scale_loss(loss, opt_state) as scaled:
            return scaled, loss

    with mesh:
        (_, loss), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return {"init": init, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def _t(a):
    return torch.from_numpy(np.array(a))


_RANKS = {}


def _spawn(world, tmp, payload, fn):
    torch.save(payload, tmp / "init.pt")
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish in time")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory, jax_init):
    import jax
    if 8 not in _RANKS:
        j = jax_init
        payload = {
            "moe": moe_params_from_jax(jax.tree.map(np.asarray,
                                                    j["moe"][1])),
            "x": _t(j["moe"][2]), "w": _t(j["w"])}
        for name in ("capacity_train", "dense_train"):
            payload[name] = moe_params_from_jax(
                jax.tree.map(np.asarray, j[name][1]))
            payload[f"{name}_x"] = _t(j[name][2])
            payload[f"{name}_tgt"] = _t(j["tgt"][name])
        for name, c in PIPES.items():
            cfg = _pcfg(name, "dense")
            payload[name] = {
                (r, m): tb.params_from_jax(j[name], cfg, rank=r, tp=c["tp"],
                                           tp_rank=m)
                for r in range(c["pp"]) for m in range(c["tp"])}
        payload["pp_sp"] = {r: tb.params_from_jax(j["pp_sp"]["init"],
                                                  _ex_cfg(), rank=r)
                            for r in range(2)}
        _RANKS[8] = _spawn(8, tmp_path_factory.mktemp("moe8"), payload,
                           _rank8)
    return _RANKS[8]


_JAX_EX = {}


def _jax_example(case):
    """The JAX example's steps on a two-device data mesh (the helper of
    ``test_torch_moe.py``), cached a case; a ``cap_`` case in capacity
    dispatch."""
    if case not in _JAX_EX:
        import jax
        from jax.sharding import Mesh
        from test_torch_moe import jax_example_run
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
        base = case.removeprefix("cap_")
        _JAX_EX[case] = jax_example_run(
            _jcfg(_ex_cfg("capacity" if base != case else "dense")),
            _ex_batches(), accum=2 if base == "grad_accum" else 1,
            mesh=None if base == "ring" else mesh)
    return _JAX_EX[case]


def _jax_capacity_layer():
    """(params, x, out, aux): ``_jmoe(0)``'s module in capacity dispatch
    at factor ``EX_CF`` on the whole batch."""
    from apex_tpu import models as jm
    _, params, x = _jmoe(0)
    moe = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=FF,
                    dispatch="capacity", capacity_factor=EX_CF)
    out, aux = moe.apply({"params": params}, x)
    return params, x, np.asarray(out), float(aux)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    import jax
    if 2 not in _RANKS:
        init = _jax_example("plain")[0]
        params, x, _, _ = _jax_capacity_layer()
        _RANKS[2] = _spawn(2, tmp_path_factory.mktemp("moe2"), {
            "example": tb.params_from_jax(init, _ex_cfg()),
            "cap_moe": moe_params_from_jax(jax.tree.map(np.asarray, params)),
            "cap_x": _t(x)}, _rank2)
    return _RANKS[2]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_ep_matches_replicated_jax(ranks8, jax_init, dispatch):
    import jax
    from apex_tpu import models as jm
    moe0, params, x = jax_init["moe"]
    moe = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=FF,
                    dispatch=dispatch)
    w = jax_init["w"]
    out, aux = moe.apply({"params": params}, x)

    def f(p, x):
        o, a = moe.apply({"params": p}, x)
        return _weighted(o, a, w)

    gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
    gflat = moe_params_from_jax(jax.tree.map(np.asarray, gp))
    full_bytes = sum(gflat[k].numel() * 4 for k in EXPERT_LEAVES)
    for res in ranks8:
        got = res[f"ep_{dispatch}"]
        r = got["rank"]
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(out),
                                   rtol=OUT_RTOL, atol=OUT_ATOL)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=AUX_RTOL)
        assert rel_err(got["gx"], gx) < GRAD_TOL
        for k, g in got["grads"].items():
            want = gflat[k][r:r + 1] if k in EXPERT_LEAVES else gflat[k]
            assert rel_err(g, want) < GRAD_TOL, (k, r)
        assert float(got["grads"]["router.weight"].abs().max()) > 0
        assert got["expert_bytes"] * 8 == full_bytes


@pytest.mark.parametrize("name", ["capacity_train", "dense_train",
                                  "bert_train"])
def test_ep_o2_train_step_learns_and_keeps_the_slice(ranks8, name):
    losses = [res[name]["losses"] for res in ranks8]
    assert all(np.isfinite(losses[0]))
    if name != "bert_train":
        assert losses[0][-1] < losses[0][0]
    # the loss is replicated: every rank's the same
    for other in losses[1:]:
        assert other == losses[0]
    want = (1, 32, 64) if name == "bert_train" else (1, H, FF)
    assert all(res[name]["shape"] == want for res in ranks8)


def test_bert_ep_forward_equals_replicated(ranks8):
    for res in ranks8:
        assert res["bert_fwd"]["err"] < FWD_TOL
        got, want = res["bert_fwd"]["aux"]
        np.testing.assert_allclose(got, want, rtol=AUX_RTOL)


def _jax_pipe_runs(name, dispatch, jax_init):
    import jax
    import jax.numpy as jnp
    pb = _jpipe(name, dispatch)
    ids, mask, tgt = (jax.tree.map(jnp.asarray, a) for a in _batch())
    v = {"params": jax_init[name]}
    if PIPES[name]["tp"] > 1:
        v = pb.shard_variables(v)
    with _jmesh(name):
        mlm, nsp, aux = jax.jit(lambda v, i, m: pb.apply(v, i, m))(
            v, ids, mask)
        loss, grads = jax.jit(lambda v, i, m, t: pb.loss_and_grad_1f1b(
            v, i, _jpretrain, t, attention_mask=m, moe_aux_weight=W))(
                v, ids, mask, tgt)
    return (np.asarray(mlm), np.asarray(nsp), float(aux), float(loss),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("name", list(PIPES))
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_pipelined_moe_matches_jax(ranks8, jax_init, name, dispatch):
    c = PIPES[name]
    cfg = _pcfg(name, dispatch)
    mlm, nsp, aux, loss, grads = _jax_pipe_runs(name, dispatch, jax_init)
    b = B // 2
    for res in ranks8:
        d, pipe, m = res[name]["coords"]
        got = res[name][dispatch]
        # GPipe's (mlm, nsp, aux): the data index's rows, aux the data
        # group's mean of its estimates
        assert rel_err(got["mlm"], mlm[d * b:(d + 1) * b]) <= FWD_TOL
        assert rel_err(got["nsp"], nsp[d * b:(d + 1) * b]) <= FWD_TOL
        np.testing.assert_allclose(float(got["gpipe"]["aux"][0]), aux,
                                   rtol=FWD_TOL)
        want = tb.params_from_jax(grads, cfg, rank=pipe, tp=c["tp"],
                                  tp_rank=m)
        one = got["1f1b"]
        assert abs(float(one["loss"][0]) - loss) / abs(loss) <= LOSS_TOL
        assert abs(float(got["gpipe"]["loss"][0]) - loss) / abs(loss) \
            <= LOSS_TOL
        for k, w in want.items():
            assert _close(one[k], w, RTOL, ATOL), (name, dispatch, k)
            assert _close(one[k], got["gpipe"][k], RTOL, ATOL), k
        # every stage's routers learn: their gradients reach the early
        # stages only through the aux leaf's hops
        routers = [k for k in want if k.endswith("moe.router.weight")]
        assert routers
        for k in routers:
            assert float(one[k].abs().max()) > 0, (pipe, k)
            assert float(got["gpipe"][k].abs().max()) > 0, (pipe, k)


@pytest.mark.parametrize("case", ["plain", "grad_accum", "ring",
                                  "cap_plain", "cap_grad_accum", "cap_ring"])
def test_example_dp2_matches_jax(ranks2, case):
    """Dense and (``cap_``) capacity dispatch: under capacity the cap and
    each token's arrival order are the whole batch's, as GSPMD's cumsum
    over the JAX example's global batch, so the same tokens drop."""
    init, want, want_g, want_params = _jax_example(case)
    cfg = _ex_cfg()
    # the ranks start from the plain case's init
    plain = tb.params_from_jax(_jax_example("plain")[0], cfg)
    for k, v in tb.params_from_jax(init, cfg).items():
        assert torch.equal(v, plain[k]), k
    mean = np.mean([r[case]["losses"] for r in ranks2], axis=0)
    for a, b in zip(mean, want):
        assert abs(a - b) / abs(b) <= LOSS_TOL, (mean, want)
    grads = tb.params_from_jax(want_g, cfg)
    flat = tb.params_from_jax(want_params, cfg)
    for res in ranks2:
        for k, g in res[case]["grads1"].items():
            assert rel_err(g, grads[k]) <= GRAD_TOL, k
        for k, v in res[case]["params"].items():
            assert rel_err(v, flat[k]) <= 1e-5, k


@pytest.mark.parametrize("layout", ["data", "seq"])
def test_capacity_over_ranks_is_the_whole_batchs(ranks2, layout):
    """A capacity layer (factor 0.5) over two ranks, each a block of the
    batch's rows or positions: with the world as ``aux_group`` its
    outputs, put together, are the JAX layer's on the whole batch (the
    same tokens dropped) and the ranks' mean aux the JAX aux; each rank's
    own cap and order drop other tokens."""
    _, _, want, want_aux = _jax_capacity_layer()
    dim = 0 if layout == "data" else 1

    def whole(rule):
        return torch.cat([r[f"cap_{layout}_{rule}"]["out"] for r in ranks2],
                         dim=dim).numpy()

    np.testing.assert_allclose(whole("batch"), want, rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    aux = np.mean([r[f"cap_{layout}_batch"]["aux"] for r in ranks2])
    np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL)
    dropped = np.all(want == 0, axis=-1)
    assert 0 < dropped.sum() < dropped.size
    assert not np.array_equal(np.all(whole("local") == 0, axis=-1), dropped)


def _router_miss(grads, want):
    """The largest router-gradient error over the largest router
    gradient."""
    keys = [k for k in grads if k.endswith("moe.router.weight")]
    return max(float((grads[k] - want[k]).abs().max())
               / float(want[k].abs().max()) for k in keys)


def test_example_dp2_needs_the_global_aux(ranks2):
    """Each rank's own token fractions give the routers other gradients:
    the JAX example's aux is the global batch's statistic."""
    _, _, want_g, _ = _jax_example("plain")
    want = tb.params_from_jax(want_g, _ex_cfg())
    assert _router_miss(ranks2[0]["plain"]["grads1"], want) < 1e-4
    assert _router_miss(ranks2[0]["local_aux"]["grads1"], want) > 1e-3


def test_example_pp_sp_matches_jax(ranks8, jax_init):
    """``--moe --pp 2 --ring-attention 2`` (GPipe) at dp 2: the pipeline's
    aux is the sequence group's mean (``pmean_g``), taken once on
    sequence rank 0's objective; the data group's mean loss and the
    step's gradients against the JAX example's step."""
    want = jax_init["pp_sp"]
    losses = {}
    for res in ranks8:
        d, r, pipe = res["pp_sp"]["coords"]
        losses.setdefault(d, res["pp_sp"]["loss"])
        grads = tb.params_from_jax(want["grads"], _ex_cfg(), rank=pipe)
        for k, g in res["pp_sp"]["grads"].items():
            assert rel_err(g, grads[k]) <= GRAD_TOL, (d, r, pipe, k)
        routers = [k for k in grads if k.endswith("moe.router.weight")]
        assert routers and all(
            float(res["pp_sp"]["grads"][k].abs().max()) > 0 for k in routers)
    mean = float(np.mean([losses[d] for d in sorted(losses)]))
    assert abs(mean - want["loss"]) / abs(want["loss"]) <= LOSS_TOL
