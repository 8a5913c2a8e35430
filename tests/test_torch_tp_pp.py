"""Tensor parallelism inside the pipeline in apex_tpu_torch against
apex_tpu's.

The reference tests' tiny models on gloo ranks, one stage a rank, one
model slice a rank, fp32, spawned once for each world: (dp, tp, pp) =
(1, 2, 2) on four ranks and (2, 2, 2), the reference's own mesh, on
eight.  The JAX side runs the reference's calls on this process's eight
CPU devices; the rank functions import no JAX.

- ``create_mesh(pp=2, tp=2)`` (and ``sp=2`` beside them): each rank's
  groups are the formula's, ``"data_sp"`` the (data x sp) ranks of one
  (pipe, model) coordinate;
- BERT's dense tensor-parallel forward (``BertForPreTraining(tp=)``) on
  the (data 2, model 4) mesh of ``test_tp_forward_matches_replicated``:
  the logits within 1e-5 of the JAX model's under ``BERT_TP_RULES``; at
  2 heads over 4 ranks the attention stays whole, as
  ``test_indivisible_dim_falls_back_replicated`` pins, and the logits
  still match;
- one O0 ``FusedLAMB`` step over dp 2 x tp 4 against
  ``test_dp_x_tp_amp_train_step``'s replicated step (run at O0): each
  leaf's update within 2e-3 of the JAX one relative to its largest
  element, the trust ratios over whole leaves; the same step with
  rank-local norms misses by more than 1e-2;
- ``PipelinedBert(tp_axis="model")`` GPipe: the logits within 2e-5 of
  the JAX pipelined model's (``test_pipelined_bert_dp_tp_pp``), each
  rank's parameters the JAX placement's device shard, the spec tree
  ``("pipe", model split)`` on the stage leaves;
- its training (``test_pipelined_bert_dp_tp_pp_trains``): 5 FusedLAMB
  steps, the losses within 1e-5 relative and the params within 1e-5
  scale-aware of the JAX run (the JAX optimizer with
  ``per_slice_trust_ratio`` on the stacked stages, as the JAX BERT
  example sets it: a port rank's stage leaves are one tensor a layer);
- 1F1B (``test_bert_1f1b_dp_tp_pp_matches_monolithic``): the loss within
  1e-5 relative and every gradient within rtol 2e-4 / atol 1e-5 of the
  JAX pipelined model's;
- with a sequence axis too, dp 1 x sp 2 x tp 2 x pp 2 (the JAX model on
  its (data, sp, model, pipe) mesh), GPipe with ring attention: each
  rank's (B, S/2, V) logits within 2e-5 of the JAX model's, the
  gradients of its share of the objective summed over sp within rtol
  2e-4 / atol 1e-5 of the JAX dense model's;
- ``PipelinedGPT(tp_axis="model")`` 1F1B
  (``test_pipelined_gpt_1f1b_dp_tp_pp_matches_monolithic``): the loss
  within 1e-5 relative, the tied ``wte``'s and the stages' gradients
  within rtol 3e-4 / atol 2e-5;
- dropout 0.1 under TP: the 1F1B loss and gradients within 1e-5 of the
  JAX pipelined model's under the same key (every model rank draws the
  dense masks, the attention's on its heads), with the default
  attention and with the flash adapter (its hash at the rank's global
  head offsets, against the JAX adapter's plain path).
"""

import importlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import make_flash_attention
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.parallel import tensor_parallel as tpar

B, S, M, PP, TP = 4, 16, 2, 2, 2
FWD_TOL, LOSS_TOL, DENSE_TOL = 2e-5, 1e-5, 1e-5
RTOL, ATOL = 2e-4, 1e-5          # :1145's gradient tolerances
GPT_RTOL, GPT_ATOL = 3e-4, 2e-5  # test_gpt_pipeline.py:181's
DROP_TOL = 1e-5
TRAIN_STEPS, TRAIN_LOSS_TOL, TRAIN_PARAM_TOL = 5, 1e-5, 1e-5
DELTA_TOL, LOCAL_MISS = 2e-3, 1e-2
KEY = (0, 7)                     # jax.random.PRNGKey(7)
DENSE_TP, DENSE_DP = 4, 2        # test_tensor_parallel.py's mesh
SPAWN_LIMIT = 240.0


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


def _bert_slice(state_dict, cfg, tp, m):
    return tpar.tp_slice(state_dict, tpar.bert_tp_rules(),
                         cfg.num_attention_heads, tp, m)


def _bcfg(dropout=0.0, **kw):
    args = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=S, hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout)
    args.update(kw)
    return tb.BertConfig(**args)


def _tcfg(heads=4):
    """``test_tensor_parallel.py``'s ``_bert()``."""
    return _bcfg(vocab_size=128, num_attention_heads=heads,
                 max_position_embeddings=32)


def _gcfg():
    return tg.GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=S, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)


def _batch(rows=B):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (rows, S)).astype(np.int32)
    mask = np.pad(np.ones((rows, S - 4), np.int32), ((0, 0), (0, 4)))
    tgt = {"mlm": rng.randint(0, 64, (rows, S)).astype(np.int32),
           "nsp": rng.randint(0, 2, (rows,)).astype(np.int32)}
    return ids, mask, tgt


def _loss(mlm, nsp, tgt):
    """The reference tests' pretraining objective (mean over rows)."""
    v = mlm.shape[-1]
    return F.cross_entropy(mlm.float().reshape(-1, v),
                           tgt["mlm"].reshape(-1).long()) \
        + F.cross_entropy(nsp.float(), tgt["nsp"].long())


def _mlm_loss(mlm, labels):
    v = mlm.shape[-1]
    return F.cross_entropy(mlm.float().reshape(-1, v),
                           labels.reshape(-1).long())


# -- the ranks ---------------------------------------------------------------

def _rows(a, d, dp):
    n = a.shape[0] // dp
    return torch.from_numpy(np.asarray(a[d * n:(d + 1) * n]))


def _data_mean(mesh, loss, grads):
    mean = parallel.DistributedDataParallel(
        process_group=mesh.group("data")).reduce_gradients(
            {"loss": loss.detach().reshape(1), **grads})
    return {"loss": mean.pop("loss")[0], "grads": mean}


def _tp_split(model):
    return {name: "model" in spec
            for name, spec in model.param_spec_tree().items()}


def _lamb(model, mesh, **kw):
    stage = {name: name.startswith("stages.")
             for name, _ in model.named_parameters()}
    return FusedLAMB(**kw).with_model_parallel(
        mesh.group("pipe"), stage).with_tensor_parallel(
            mesh.group("model"), _tp_split(model))


def _pipelined(mesh, init, d, dp, out):
    """GPipe, 1F1B and the placement of PipelinedBert, PipelinedGPT's
    1F1B; at dp 2 the training run and dropout."""
    pipe, m = mesh.index("pipe"), mesh.index("model")
    batch_axis = "data" if dp > 1 else None
    ids, mask, tgt = _batch()
    ids, mask = _rows(ids, d, dp), _rows(mask, d, dp)
    tgt = {k: _rows(v, d, dp) for k, v in tgt.items()}
    kw = dict(batch_axis=batch_axis, tp_axis="model", device="cpu",
              seed=None)
    pb = tb.PipelinedBert(_bcfg(), mesh, PP, M, **kw)
    pb.load_state_dict(init["bert"][(pipe, m)])
    with torch.no_grad():
        mlm, nsp = pb(ids)
    specs = pb.param_spec_tree()
    out["gpipe"] = {"mlm": mlm, "nsp": nsp,
                    "shapes": {k: tuple(v.shape)
                               for k, v in pb.state_dict().items()},
                    "specs": {k: specs[k] for k in (
                        "stages.layer_0.attention.query.weight",
                        "stages.layer_0.intermediate.weight",
                        "stages.layer_0.output_ln.scale",
                        "embed.word_embeddings.weight",
                        "heads.mlm_decoder.weight", "heads.pooler.weight")}}
    loss, grads = pb.loss_and_grad_1f1b(ids, _loss, tgt, attention_mask=mask)
    out["1f1b"] = _data_mean(mesh, loss, pb.constrain_grads(grads))
    pg = tg.PipelinedGPT(_gcfg(), mesh, PP, M, **kw)
    pg.load_state_dict(init["gpt"][(pipe, m)])
    loss, grads = pg.loss_and_grad_1f1b(ids, ids)
    out["gpt"] = _data_mean(mesh, loss, grads)
    if dp == 1:
        return
    drop = tb.PipelinedBert(_bcfg(0.1), mesh, PP, M, **kw)
    drop.load_state_dict(init["bert"][(pipe, m)])
    loss, grads = drop.loss_and_grad_1f1b(
        ids, _loss, tgt, attention_mask=mask, deterministic=False,
        dropout_key=KEY)
    out["drop_default"] = _data_mean(mesh, loss, grads)
    # the flash kernels' dropout: the rank's heads hashed at their global
    # index (dropout_fn.offsets)
    drop = tb.PipelinedBert(_bcfg(0.1), mesh, PP, M,
                            attention_fn=make_flash_attention(), **kw)
    drop.load_state_dict(init["bert"][(pipe, m)])
    loss, grads = drop.loss_and_grad_1f1b(
        ids, _loss, tgt, attention_mask=mask, deterministic=False,
        dropout_key=KEY)
    out["drop_flash"] = _data_mean(mesh, loss, grads)
    # :549's training: 5 FusedLAMB steps on GPipe's autograd
    ids, labels = (_rows(a, d, dp) for a in _train_batch())
    pb.load_state_dict(init["bert"][(pipe, m)])
    opt = _lamb(pb, mesh, lr=1e-3)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in pb.named_parameters()}
    state, losses = opt.init(params), []
    ddp = parallel.DistributedDataParallel(process_group=mesh.group("data"))
    for _ in range(TRAIN_STEPS):
        mlm, _ = torch.func.functional_call(pb, params, (ids,))
        loss = _mlm_loss(mlm, labels)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        # the NSP head takes no part: zero gradients, as jax.grad's
        g = {k: torch.zeros_like(p) if a is None else a
             for (k, p), a in zip(params.items(), got)}
        g = ddp.reduce_gradients({"loss": loss.detach().reshape(1), **g})
        losses.append(float(g.pop("loss")[0]))
        params, state = opt.step(params, g, state)
    out["train"] = {"losses": losses,
                    "params": {k: v.detach() for k, v in params.items()}}


def _with_seq(init, out):
    """dp 1 x sp 2 x tp 2 x pp 2, GPipe with ring attention: the rank's
    logits and the gradients of its share of the objective (its tokens'
    MLM sum over B * S, the NSP term on sequence rank 0), summed over
    the sequence group."""
    mesh = parallel.create_mesh(sp=2, pp=PP, tp=TP)
    out["seq_members"] = {axis: mesh.group(axis).members()
                          for axis in ("data", "sp", "pipe", "model",
                                       "data_sp")}
    pipe, m, r = mesh.index("pipe"), mesh.index("model"), mesh.index("sp")
    ids, _, tgt = _batch()
    ids = torch.from_numpy(ids)
    tgt = {k: torch.from_numpy(v) for k, v in tgt.items()}
    pb = tb.PipelinedBert(
        _bcfg(), mesh, PP, M, seq_axis="sp", tp_axis="model",
        attention_fn=parallel.make_ring_attention(mesh.group("sp")),
        device="cpu", seed=None)
    pb.load_state_dict(init["bert"][(pipe, m)])
    params = dict(pb.named_parameters())
    mlm, nsp = pb(ids)
    sl = S // 2
    share = F.cross_entropy(
        mlm.reshape(-1, mlm.shape[-1]),
        tgt["mlm"][:, r * sl:(r + 1) * sl].reshape(-1).long(),
        reduction="sum") / (B * S)
    share = share + (F.cross_entropy(nsp, tgt["nsp"].long()) if r == 0
                     else 0.0 * nsp.sum())
    g = dict(zip(params, torch.autograd.grad(share, list(params.values()))))
    g = parallel.DistributedDataParallel(
        process_group=mesh.group("sp"), gradient_average=False
    ).reduce_gradients(g)
    out["seq"] = {"mlm": mlm.detach(), "nsp": nsp.detach(), "grads": g,
                  "coords": (r, pipe, m)}


def _dense_tp(init, out):
    """(data 2, model 4): the dense TP forward, its fallback at 2 heads,
    and one O0 FusedLAMB step with whole-leaf and with rank-local
    norms."""
    mesh = parallel.create_mesh(dp=DENSE_DP, tp=DENSE_TP)
    group, d, m = mesh.group("model"), mesh.index("data"), mesh.index("model")
    ids = torch.full((4, 16), 3, dtype=torch.int32)
    model = tb.BertForPreTraining(_tcfg(), device="cpu", seed=None, tp=group)
    model.load_state_dict(init["dense_tp"][m])
    with torch.no_grad():
        out["dense_fwd"] = model(ids)
    fall = tb.BertForPreTraining(_tcfg(heads=2), device="cpu", seed=None,
                                 tp=group)
    fall.load_state_dict(_bert_slice(init["dense_2heads"], _tcfg(heads=2),
                                     DENSE_TP, m))
    with torch.no_grad():
        out["fallback_fwd"] = fall(ids)
    out["fallback_shapes"] = {k: tuple(v.shape)
                              for k, v in fall.state_dict().items()}
    ids = torch.full((2, 16), 5, dtype=torch.int32)
    labels = torch.zeros((2, 16), dtype=torch.int32)
    split = {name: bool(spec) for name, spec in model.tp_specs().items()}
    ddp = parallel.DistributedDataParallel(process_group=mesh.group("data"))
    for label, lamb in (("whole", FusedLAMB(lr=1e-3).with_tensor_parallel(
                             group, split)),
                        ("local", FusedLAMB(lr=1e-3))):
        model.load_state_dict(init["dense_tp"][m])
        amp_model, opt = amp.initialize(model, lamb, opt_level="O0",
                                        verbosity=0)
        params = amp_model.init()
        before = {k: v.detach().clone() for k, v in params.items()}
        state = opt.init(params)
        mlm, _ = amp_model.apply(params, ids)
        loss = _mlm_loss(mlm, labels) * opt.loss_scale(state)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        g = {k: torch.zeros_like(p) if a is None else a
             for (k, p), a in zip(params.items(), got)}
        params, state = opt.step(params, ddp.reduce_gradients(g), state)
        out[f"lamb_{label}"] = {
            "loss": float(loss), "before": before,
            "after": {k: v.detach() for k, v in params.items()}}
    out["dense_coords"] = (d, m)


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        dp = world // (PP * TP)
        mesh = parallel.create_mesh(pp=PP, tp=TP)
        d = mesh.index("data")
        init = torch.load(f"{tmpdir}/init.pt")
        out = {"coords": (d, mesh.index("pipe"), mesh.index("model")),
               "members": {axis: mesh.group(axis).members()
                           for axis in ("data", "sp", "pipe", "model",
                                        "data_sp")}}
        _pipelined(mesh, init, d, dp, out)
        if world == 8:
            _with_seq(init, out)
            _dense_tp(init, out)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- the JAX side ------------------------------------------------------------

def _train_batch():
    rng = np.random.RandomState(1)
    return (rng.randint(0, 64, (8, S)).astype(np.int32),
            rng.randint(0, 64, (8, S)).astype(np.int32))


def _jcfg(cfg):
    from apex_tpu import models as jm
    cls = jm.BertConfig if isinstance(cfg, tb.BertConfig) else jm.GPTConfig
    return cls(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})


def _jmesh(shape=(2, 2, 2), axes=("data", "model", "pipe")):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), axes)


def _jbert(dropout=0.0, mesh=None, **kw):
    from apex_tpu import models as jm
    return jm.PipelinedBert(_jcfg(_bcfg(dropout)), mesh or _jmesh(), pp=PP,
                            num_microbatches=M, batch_axis="data",
                            tp_axis="model", **kw)


def _jgpt():
    from apex_tpu import models as jm
    return jm.PipelinedGPT(_jcfg(_gcfg()), _jmesh(), pp=PP,
                           num_microbatches=M, batch_axis="data",
                           tp_axis="model")


def _jpretrain(mlm, nsp, t):
    import jax
    import jax.numpy as jnp
    oh = jax.nn.one_hot(t["mlm"], mlm.shape[-1])
    l1 = -jnp.mean(jnp.sum(jax.nn.log_softmax(mlm) * oh, -1))
    oh2 = jax.nn.one_hot(t["nsp"], 2)
    return l1 - jnp.mean(jnp.sum(jax.nn.log_softmax(nsp) * oh2, -1))


def _jmlm(mlm, labels):
    import jax
    import jax.numpy as jnp
    oh = jax.nn.one_hot(labels, mlm.shape[-1])
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(
        mlm.astype(jnp.float32)) * oh, -1))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX models' initial params: the pipelined BERT and GPT (the
    reference tests' keys), test_tensor_parallel.py's BERT (4 and 2
    heads)."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    ids = jnp.asarray(_batch()[0])
    pb, pg = _jbert(), _jgpt()
    tids = jnp.ones((4, 16), jnp.int32) * 3
    return {
        "bert": jax.tree.map(np.asarray, pb.init(
            jax.random.PRNGKey(1), ids)["params"]),
        "gpt": jax.tree.map(np.asarray, pg.init(
            jax.random.PRNGKey(1), ids)["params"]),
        "dense_tp": jax.tree.map(np.asarray, jm.BertForPreTraining(
            _jcfg(_tcfg())).init(jax.random.PRNGKey(0), tids)["params"]),
        "dense_2heads": jax.tree.map(np.asarray, jm.BertForPreTraining(
            _jcfg(_tcfg(heads=2))).init(jax.random.PRNGKey(0),
                                        tids)["params"])}


_RANKS = {}


def _spawn(world, tmp, jax_init):
    torch.save({
        "bert": {(r, m): tb.params_from_jax(jax_init["bert"], _bcfg(),
                                            rank=r, tp=TP, tp_rank=m)
                 for r in range(PP) for m in range(TP)},
        "gpt": {(r, m): tg.params_from_jax(jax_init["gpt"], _gcfg(), rank=r,
                                           tp=TP, tp_rank=m)
                for r in range(PP) for m in range(TP)},
        "dense_tp": {m: tb.params_from_jax(jax_init["dense_tp"], _tcfg(),
                                           tp=DENSE_TP, tp_rank=m)
                     for m in range(DENSE_TP)},
        "dense_2heads": tb.params_from_jax(jax_init["dense_2heads"],
                                           _tcfg(heads=2))},
        tmp / "init.pt")
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


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_init):
    """``spawned(world)``: the ranks' results at (world / 4, 2, 2),
    spawned once for each world."""
    def get(world):
        if world not in _RANKS:
            _RANKS[world] = _spawn(world, tmp_path_factory.mktemp(
                f"tppp{world}"), jax_init)
        return _RANKS[world]
    return get


_JAX = {}


def _jax_runs(jax_init):
    """The JAX pipelined models' GPipe logits, 1F1B loss and gradients
    (BERT, BERT with dropout, GPT), their placement, and the JAX dense
    BERT's logits and gradients for the sequence case."""
    if _JAX:
        return _JAX
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    ids, mask, tgt = (jax.tree.map(jnp.asarray, x) for x in _batch())
    mesh = _jmesh()
    pb = _jbert()
    v = pb.shard_variables({"params": jax_init["bert"]})
    with mesh:
        _JAX["gpipe"] = jax.tree.map(np.asarray, jax.jit(
            lambda v, i: pb.apply(v, i))(v, ids))
        _JAX["placed"] = v["params"]
        loss, grads = jax.jit(lambda v, i, m, t: pb.loss_and_grad_1f1b(
            v, i, _jpretrain, t, attention_mask=m))(v, ids, mask, tgt)
        _JAX["1f1b"] = (float(loss), jax.tree.map(np.asarray, grads))
        jfa = importlib.import_module("apex_tpu.ops.flash_attention")
        for attention, fn in (("default", None), ("flash", (
                jfa.make_flash_attention(use_pallas=False)))):
            pd = _jbert(0.1, attention_fn=fn)
            loss, grads = jax.jit(lambda v, i, m, t: pd.loss_and_grad_1f1b(
                v, i, _jpretrain, t, attention_mask=m, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(7)}))(v, ids, mask, tgt)
            _JAX[f"drop_{attention}"] = (float(loss),
                                         jax.tree.map(np.asarray, grads))
        pg = _jgpt()
        gv = pg.shard_variables({"params": jax_init["gpt"]})
        loss, grads = jax.jit(lambda v, i: pg.loss_and_grad_1f1b(v, i, i))(
            gv, ids)
        _JAX["gpt"] = (float(loss), jax.tree.map(np.asarray, grads))
    smesh = _jmesh((1, 2, 2, 2), ("data", "sp", "model", "pipe"))
    ps = _jbert(mesh=smesh, seq_axis="sp",
                attention_fn=jpar.make_ring_attention("sp"))
    with smesh:
        _JAX["seq"] = jax.tree.map(np.asarray, jax.jit(
            lambda v, i: ps.apply(v, i))(
                ps.shard_variables({"params": jax_init["bert"]}), ids))
    mono = _mono_bert(jax_init["bert"])

    def mono_loss(p):
        mlm, nsp = jm.BertForPreTraining(_jcfg(_bcfg())).apply(
            {"params": p}, ids, deterministic=True)
        return _jpretrain(mlm, nsp, tgt)

    _JAX["seq_grads"] = jax.tree.map(np.asarray,
                                     jax.grad(mono_loss)(mono))
    return _JAX


def _mono_bert(p):
    enc = dict(p["embed"])
    for st in range(PP):
        enc[f"layer_{st}"] = {k: v for k, v in _stage_row(
            p["stages"]["layer_0"], st).items()}
    return {"encoder": enc, **p["heads"]}


def _stage_row(tree, st):
    import jax
    return jax.tree.map(lambda a: np.asarray(a)[st], tree)


def _rank_grads(jgrads, pipe, m, gpt=False):
    if gpt:
        return tg.params_from_jax(jgrads, _gcfg(), rank=pipe, tp=TP,
                                  tp_rank=m)
    return tb.params_from_jax(jgrads, _bcfg(), rank=pipe, tp=TP, tp_rank=m)


# -- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("world", [4, 8])
def test_mesh_groups(spawned, world):
    for r, out in enumerate(spawned(world)):
        d, pipe, m = r // (PP * TP), (r // TP) % PP, r % TP
        assert out["coords"] == (d, pipe, m)
        want = {"model": tuple(d * 4 + pipe * TP + k for k in range(TP)),
                "pipe": tuple(d * 4 + q * TP + m for q in range(PP)),
                "data": tuple(range(r % 4, world, 4)), "sp": (r,)}
        want["data_sp"] = want["data"]
        assert out["members"] == want, (r, out["members"])
        if world == 8:
            sp, pipe = (r // 4) % 2, (r // 2) % 2
            seq = out["seq_members"]
            assert seq["sp"] == (pipe * 2 + m, 4 + pipe * 2 + m)
            assert seq["pipe"] == (sp * 4 + m, sp * 4 + 2 + m)
            assert seq["model"] == (sp * 4 + pipe * 2, sp * 4 + pipe * 2 + 1)
            assert seq["data"] == (r,) and seq["data_sp"] == seq["sp"]


def test_dense_tp_forward_matches_jax(spawned, jax_init):
    """``test_tp_forward_matches_replicated`` on the (2, 4) mesh, and the
    2-head model whose attention stays whole at 4 ranks."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    ids = jnp.ones((4, 16), jnp.int32) * 3
    mesh = _jmesh((2, 4), ("data", "model"))
    jmodel = jm.BertForPreTraining(_jcfg(_tcfg()))
    tp = jpar.shard_params(jax_init["dense_tp"], mesh, jpar.BERT_TP_RULES)
    with mesh:
        mlm, nsp = jax.jit(lambda p: jmodel.apply(
            {"params": p}, ids, deterministic=True))(tp)
    fmlm, fnsp = jm.BertForPreTraining(_jcfg(_tcfg(heads=2))).apply(
        {"params": jax_init["dense_2heads"]}, ids, deterministic=True)
    for out in spawned(8):
        got_mlm, got_nsp = out["dense_fwd"]
        assert rel_err(got_mlm, mlm) <= DENSE_TOL
        assert rel_err(got_nsp, nsp) <= DENSE_TOL
        assert rel_err(out["fallback_fwd"][0], fmlm) <= DENSE_TOL
        assert rel_err(out["fallback_fwd"][1], fnsp) <= DENSE_TOL
        shapes = out["fallback_shapes"]
        # 2 heads do not divide over 4 ranks: q/k/v and the attention
        # output whole; the MLP and the vocabulary still split
        assert shapes["encoder.layer_0.attention.query.weight"] == (32, 32)
        assert shapes["encoder.layer_0.attention.output.weight"] == (32, 32)
        assert shapes["encoder.layer_0.intermediate.weight"] == (16, 32)
        assert shapes["encoder.word_embeddings.weight"] == (32, 32)
        assert shapes["mlm_decoder.weight"] == (32, 32)


def test_lamb_step_uses_whole_leaf_norms(spawned, jax_init):
    """``test_dp_x_tp_amp_train_step``'s replicated step, at O0: each
    leaf's update against the JAX one; rank-local trust and clipping
    norms miss."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    model, opt = jamp.initialize(jm.BertForPreTraining(_jcfg(_tcfg())),
                                 jopt.FusedLAMB(lr=1e-3), opt_level="O0",
                                 verbosity=0)
    params = jax.tree.map(jnp.asarray, jax_init["dense_tp"])
    ids = jnp.ones((4, 16), jnp.int32) * 5
    labels = jnp.zeros((4, 16), jnp.int32)
    state = opt.init(params)

    def loss_fn(p):
        mlm, _ = model.apply({"params": p}, ids, deterministic=True)
        return _jmlm(mlm, labels)

    grads = jax.grad(loss_fn)(params)
    new, _ = opt.step(params, grads, state)
    want_new = tb.params_from_jax(jax.tree.map(np.asarray, new), _tcfg())
    want_old = tb.params_from_jax(jax_init["dense_tp"], _tcfg())
    # a leaf whose gradient is rounding noise (the key bias: softmax
    # ignores a shift shared by every key) takes a noise step in both
    # frameworks: it is held to the largest update's scale instead
    gmax = {k: float(v.abs().max()) for k, v in tb.params_from_jax(
        jax.tree.map(np.asarray, grads), _tcfg()).items()}
    noise = {k for k, g in gmax.items()
             if 0 < g <= 1e-6 * max(gmax.values())}
    assert noise == {f"encoder.layer_{i}.attention.key.bias"
                     for i in range(2)}, noise
    top = max(float((want_new[k] - want_old[k]).abs().max())
              for k in want_new)
    worst_local = 0.0
    for out in spawned(8):
        m = out["dense_coords"][1]
        new_m = _bert_slice(want_new, _tcfg(), DENSE_TP, m)
        old_m = _bert_slice(want_old, _tcfg(), DENSE_TP, m)
        for label in ("whole", "local"):
            run = out[f"lamb_{label}"]
            errs = {}
            for k, after in run["after"].items():
                want = (new_m[k] - old_m[k]).numpy()
                got = (after - run["before"][k]).numpy()
                # a leaf with no gradient and zero weights (the NSP
                # head's biases) stays where it was in both: scale 1e-12
                scale = top if k in noise else max(
                    float(np.max(np.abs(want))), 1e-12)
                errs[k] = float(np.max(np.abs(got - want))) / scale
            if label == "whole":
                assert max(errs.values()) <= DELTA_TOL, errs
            else:
                worst_local = max(worst_local, max(errs.values()))
    assert worst_local > LOCAL_MISS, worst_local


@pytest.mark.parametrize("world", [4, 8])
def test_gpipe_logits_and_placement_match_jax(spawned, jax_init, world):
    """``test_pipelined_bert_dp_tp_pp``: the logits, each rank's leaves
    the JAX placement's device shard, the spec tree."""
    jx = _jax_runs(jax_init)
    mlm, nsp = jx["gpipe"]
    dp = world // (PP * TP)
    n = B // dp
    for out in spawned(world):
        d, pipe, m = out["coords"]
        got = out["gpipe"]
        assert rel_err(got["mlm"], mlm[d * n:(d + 1) * n]) <= FWD_TOL
        assert rel_err(got["nsp"], nsp[d * n:(d + 1) * n]) <= FWD_TOL
        assert got["specs"] == {
            "stages.layer_0.attention.query.weight": ("pipe", "model", None),
            "stages.layer_0.intermediate.weight": ("pipe", "model", None),
            "stages.layer_0.output_ln.scale": ("pipe",),
            "embed.word_embeddings.weight": ("model", None),
            "heads.mlm_decoder.weight": ("model", None),
            "heads.pooler.weight": ()}
        want = _rank_grads(jax_init["bert"], pipe, m)
        assert got["shapes"] == {k: tuple(v.shape) for k, v in want.items()}
    # the port's slices are the JAX placement's device shards
    import jax
    placed = _JAX["placed"]
    devices = _jmesh().devices
    for pipe in range(PP):
        for m in range(TP):
            mine = tb.params_from_jax(jax_init["bert"], _bcfg(), rank=pipe,
                                      tp=TP, tp_rank=m)
            dev = devices[0, m, pipe]
            shard = jax.tree.map(
                lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                          if s.device == dev)), placed)
            rows = {"embed": shard["embed"], "heads": shard["heads"],
                    "stages": shard["stages"]}
            q = rows["stages"]["layer_0"]["attention"]["query"]["kernel"][0]
            np.testing.assert_array_equal(
                mine["stages.layer_0.attention.query.weight"].numpy(),
                q.reshape(q.shape[0], -1).T)
            k = rows["stages"]["layer_0"]["intermediate"]["kernel"][0]
            np.testing.assert_array_equal(
                mine["stages.layer_0.intermediate.weight"].numpy(), k.T)
            np.testing.assert_array_equal(
                mine["embed.word_embeddings.weight"].numpy(),
                rows["embed"]["word_embeddings"]["embedding"])


@pytest.mark.parametrize("world", [4, 8])
def test_onef1b_matches_jax(spawned, jax_init, world):
    """``test_bert_1f1b_dp_tp_pp_matches_monolithic``."""
    jx = _jax_runs(jax_init)
    loss, grads = jx["1f1b"]
    for out in spawned(world):
        _, pipe, m = out["coords"]
        got = out["1f1b"]
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        want = _rank_grads(grads, pipe, m)
        assert set(got["grads"]) == set(want)
        for k, w in want.items():
            assert _close(got["grads"][k], w, RTOL, ATOL), k


def test_training_matches_jax(spawned, jax_init):
    """``test_pipelined_bert_dp_tp_pp_trains``: 5 FusedLAMB steps."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from apex_tpu import optimizers as jopt
    mesh = _jmesh()
    pb = _jbert()
    opt = jopt.FusedLAMB(
        lr=1e-3, per_slice_trust_ratio=lambda path: any(
            "stages" in str(k) for k in path))
    ids, labels = (jax.device_put(jnp.asarray(a),
                                  NamedSharding(mesh, P("data")))
                   for a in _train_batch())
    params = pb.shard_variables({"params": jax_init["bert"]})["params"]
    state = opt.init(params)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, state, ids, labels):
        def loss_fn(p):
            mlm, _ = pb.apply({"params": p}, ids)
            return _jmlm(mlm, labels)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, state = opt.step(params, grads, state)
        return params, state, loss

    losses = []
    with mesh:
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, ids, labels)
            losses.append(float(loss))
    assert losses[-1] < losses[0]
    final = jax.tree.map(np.asarray, params)
    for out in spawned(8):
        _, pipe, m = out["coords"]
        got = out["train"]
        for a, b in zip(got["losses"], losses):
            assert abs(a - b) <= TRAIN_LOSS_TOL * abs(b), (got["losses"],
                                                          losses)
        want = _rank_grads(final, pipe, m)
        for k, w in want.items():
            assert rel_err(got["params"][k], w) <= TRAIN_PARAM_TOL, k


def test_with_sequence_axis_matches_jax(spawned, jax_init):
    """dp 1 x sp 2 x tp 2 x pp 2, GPipe with ring attention, against the
    JAX model on its (data, sp, model, pipe) mesh (logits) and the JAX
    dense model (gradients)."""
    jx = _jax_runs(jax_init)
    mlm, nsp = jx["seq"]
    sl = S // 2
    for out in spawned(8):
        got = out["seq"]
        r, pipe, m = got["coords"]
        assert rel_err(got["mlm"], mlm[:, r * sl:(r + 1) * sl]) <= FWD_TOL
        if r == 0:
            assert rel_err(got["nsp"], nsp) <= FWD_TOL
        want = tb.dense_to_rank(tb.params_from_jax(jx["seq_grads"], _bcfg()),
                                _bcfg(), PP, pipe, tp=TP, tp_rank=m)
        for k, w in want.items():
            assert _close(got["grads"][k], w, RTOL, ATOL), k


@pytest.mark.parametrize("world", [4, 8])
def test_gpt_onef1b_matches_jax(spawned, jax_init, world):
    """``test_pipelined_gpt_1f1b_dp_tp_pp_matches_monolithic``: the
    vocab-sharded tied ``wte``'s gradient is its lookup's plus the
    column-parallel head's."""
    jx = _jax_runs(jax_init)
    loss, grads = jx["gpt"]
    for out in spawned(world):
        _, pipe, m = out["coords"]
        got = out["gpt"]
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
        want = _rank_grads(grads, pipe, m, gpt=True)
        assert got["grads"]["embed.wte.weight"].shape == (32, 32)
        for k, w in want.items():
            assert _close(got["grads"][k], w, GPT_RTOL, GPT_ATOL), k


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_dropout_matches_jax(spawned, jax_init, attention):
    """Dropout 0.1 under TP: the 1F1B loss and gradients against the JAX
    pipelined model's under the same key, with the default attention
    (the whole mask drawn, the rank's heads kept) and with the flash
    kernels' hash (the JAX adapter's plain path), the rank's heads at
    their global index."""
    jx = _jax_runs(jax_init)
    loss, grads = jx[f"drop_{attention}"]
    for out in spawned(8):
        _, pipe, m = out["coords"]
        got = out[f"drop_{attention}"]
        assert abs(float(got["loss"]) - loss) <= DROP_TOL * abs(loss)
        for k, w in _rank_grads(grads, pipe, m).items():
            assert rel_err(got["grads"][k], w) <= DROP_TOL, k
