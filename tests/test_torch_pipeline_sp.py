"""Sequence parallelism inside the pipeline in apex_tpu_torch against
apex_tpu's.

The reference tests' tiny models (hidden 32, 2 layers, 2 heads, MLP 64,
vocab 64, sequence 16, batch 4, 2 microbatches; BERT's last 4 keys
padded) on gloo ranks, one stage a rank, on a (data, sp, pipe) mesh of
(1, 2, 2) and (2, 2, 2) (the reference's own), from the JAX pipelined
models' initial params, fp32:

- the mesh: each rank's (data, sp, pipe) coordinates and its groups'
  members are the JAX example's ``reshape(dp, sp, pp)``;
- ``PipelinedBert`` GPipe with ring attention: each rank's (B, S/sp, V)
  MLM logits, and on sequence rank 0 the NSP logits, within 2e-4 of the
  JAX dense model's (``test_pipelined_bert_dp_sp_pp``);
- ``PipelinedBert.loss_and_grad_1f1b`` with Ulysses: the loss within
  1e-5 relative and every gradient within rtol 5e-4 / atol 2e-5 of the
  JAX dense model's autodiff
  (``test_bert_1f1b_ulysses_dp_sp_pp_matches_monolithic``); 1F1B with
  ring raises the reference's ``NotImplementedError``
  (``test_bert_1f1b_ring_rejected``);
- ``PipelinedGPT``: GPipe with causal ring, the logits within 3e-4;
  1F1B with causal Ulysses, the loss within 1e-5 and the tied ``wte``'s
  and the stages' gradients within rtol 3e-4 / atol 2e-5; 1F1B with
  ring refused (``tests/distributed/test_gpt_pipeline.py:318, 355,
  371``);
- dropout 0.1 with Ulysses: the 1F1B loss and gradients, and GPipe's
  (its gradients summed over the sequence group), meaned over the data
  group, within 1e-5 of the JAX ``PipelinedBert``'s 1F1B under the same
  key (the stage masks drawn at each shard's local shape from its
  sp-folded key, the embeddings' from the whole global batch's stream,
  at the rank's sequence offset and data rows);
- ``bert_main_amp`` (BERT-tiny, batch 8 a data index, sequence 32) at
  (1, 2, 2) and (2, 2, 2): one O0 step with ``--pp 2 --ring-attention
  2`` under GPipe with ring, 1F1B with Ulysses, and GPipe with ring
  under ``--grad-accum 2`` (the data indices' mean loss), and at (dp 2,
  sp 2) the dense ``--ring-attention 2 --grad-accum 2`` step,
  each against the JAX example's step of the same flags: the loss
  within 1e-5 relative, the step's gradients (reduced as the example
  reduces them) and the params after it within 2e-5 scale-aware.

The ranks are spawned once for each world (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import parallel
from apex_tpu_torch.examples import bert_main_amp as bert
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.models import gpt as tg

B, S, M, SP, PP = 4, 16, 2, 2, 2
FWD_TOL, LOSS_TOL, DROP_TOL = 2e-4, 1e-5, 1e-5
GPT_FWD_TOL = 3e-4
RTOL, ATOL = 5e-4, 2e-5          # the reference's gradient tolerances
GPT_RTOL = 3e-4
EX_B, EX_S, LR = 8, 32, 1e-4     # the example's steps
PARAM_TOL, GRAD_TOL = 2e-5, 2e-5
KEY = (0, 7)                     # jax.random.PRNGKey(7)
SPAWN_LIMIT = 180.0
EXAMPLE_CASES = [("gpipe", "ring", 1), ("1f1b", "ulysses", 1),
                 ("gpipe", "ring", 2)]
RING_ONEF1B = "onef1b_compatible"


def rel_err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _close(got, want, rtol, atol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def _bcfg(dropout=0.0):
    return tb.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=S,
                         hidden_dropout_prob=dropout,
                         attention_probs_dropout_prob=dropout)


def _gcfg():
    return tg.GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=S, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)


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


def _example_batch(rows=EX_B):
    return next(bert.batches(bert.get_config("tiny"), rows, EX_S))


# -- the ranks ---------------------------------------------------------------

def _rows(a, d, dp):
    n = a.shape[0] // dp
    return torch.from_numpy(np.asarray(a[d * n:(d + 1) * n]))


def _bert_runs(mesh, init, d, dp, out):
    """GPipe with ring, 1F1B with Ulysses and 1F1B with ring."""
    group = mesh.group("sp")
    ids, mask, tgt = _batch()
    ids, mask = _rows(ids, d, dp), _rows(mask, d, dp)
    tgt = {k: _rows(v, d, dp) for k, v in tgt.items()}
    kw = dict(batch_axis="data" if dp > 1 else None, seq_axis="sp",
              device="cpu", seed=None)
    ring = tb.PipelinedBert(_bcfg(), mesh, PP, M,
                            attention_fn=parallel.make_ring_attention(group),
                            **kw)
    ring.load_state_dict(init)
    with torch.no_grad():
        mlm, nsp = ring(ids, mask)
    out["bert_gpipe"] = {"mlm": mlm, "nsp": nsp}
    try:
        ring.loss_and_grad_1f1b(ids, _loss, tgt, attention_mask=mask)
        out["bert_ring_1f1b"] = None
    except NotImplementedError as e:
        out["bert_ring_1f1b"] = str(e)
    uly = tb.PipelinedBert(
        _bcfg(), mesh, PP, M,
        attention_fn=parallel.make_ulysses_attention(group), **kw)
    uly.load_state_dict(init)
    loss, grads = uly.loss_and_grad_1f1b(ids, _loss, tgt,
                                         attention_mask=mask)
    mean = parallel.DistributedDataParallel(
        process_group=mesh.group("data")).reduce_gradients(
            {"loss": loss.reshape(1), **grads})
    out["bert_1f1b"] = {"loss": mean.pop("loss")[0], "grads": mean}


def _bert_dropout(mesh, init, d, dp, out):
    """Dropout 0.1 with Ulysses: 1F1B, and GPipe's autodiff of the
    rank's share of the objective, summed over the sequence group; both
    meaned over the data group."""
    group = mesh.group("sp")
    ids, mask, tgt = _batch()
    ids, mask = _rows(ids, d, dp), _rows(mask, d, dp)
    tgt = {k: _rows(v, d, dp) for k, v in tgt.items()}
    model = tb.PipelinedBert(
        _bcfg(0.1), mesh, PP, M,
        attention_fn=parallel.make_ulysses_attention(group), seq_axis="sp",
        batch_axis="data" if dp > 1 else None, device="cpu", seed=None)
    model.load_state_dict(init)
    loss, grads = model.loss_and_grad_1f1b(
        ids, _loss, tgt, attention_mask=mask, deterministic=False,
        dropout_key=KEY)
    params = dict(model.named_parameters())
    mlm, nsp = model(ids, mask, deterministic=False, dropout_key=KEY)
    r, sl = mesh.index("sp"), S // SP
    v = mlm.shape[-1]
    share = F.cross_entropy(
        mlm.reshape(-1, v), tgt["mlm"][:, r * sl:(r + 1) * sl].reshape(-1)
        .long(), reduction="sum") / (ids.shape[0] * S)
    # the pooled [CLS] token lives on sequence rank 0
    share = share + (F.cross_entropy(nsp, tgt["nsp"].long()) if r == 0
                     else 0.0 * nsp.sum())
    g = dict(zip(params, torch.autograd.grad(share, list(params.values()))))
    g = parallel.DistributedDataParallel(
        process_group=group, gradient_average=False).reduce_gradients(
            {"loss": share.detach().reshape(1), **g})
    data = parallel.DistributedDataParallel(process_group=mesh.group("data"))
    g = data.reduce_gradients(g)
    mean = data.reduce_gradients({"loss": loss.reshape(1), **grads})
    out["drop"] = {"loss": mean.pop("loss")[0], "grads": mean,
                   "gpipe_loss": g.pop("loss")[0], "gpipe_grads": g}


def _gpt_runs(mesh, init, d, dp, out):
    group = mesh.group("sp")
    ids = _rows(_batch()[0], d, dp)
    kw = dict(batch_axis="data" if dp > 1 else None, seq_axis="sp",
              device="cpu", seed=None)
    ring = tg.PipelinedGPT(_gcfg(), mesh, PP, M,
                           attention_fn=parallel.make_ring_attention(
                               group, causal=True), **kw)
    ring.load_state_dict(init)
    with torch.no_grad():
        out["gpt_gpipe"] = ring(ids)
    try:
        ring.loss_and_grad_1f1b(ids, ids)
        out["gpt_ring_1f1b"] = None
    except NotImplementedError as e:
        out["gpt_ring_1f1b"] = str(e)
    uly = tg.PipelinedGPT(_gcfg(), mesh, PP, M,
                          attention_fn=parallel.make_ulysses_attention(
                              group, causal=True), **kw)
    uly.load_state_dict(init)
    loss, grads = uly.loss_and_grad_1f1b(ids, ids)
    mean = parallel.DistributedDataParallel(
        process_group=mesh.group("data")).reduce_gradients(
            {"loss": loss.reshape(1), **grads})
    out["gpt_1f1b"] = {"loss": mean.pop("loss")[0], "grads": mean}


def _example_steps(sd, d, dp, out):
    """``bert_main_amp``'s O0 steps: ``--pp 2 --ring-attention 2`` on data
    index d's ``EX_B`` rows of the global batch, then, at dp 1, the
    dense ``--ring-attention 2 --grad-accum 2`` at (2, 2)."""
    cfg = bert.get_config("tiny")
    mine = tuple(torch.from_numpy(a[d * EX_B:(d + 1) * EX_B])
                 for a in _example_batch(dp * EX_B))
    for schedule, pattern, accum in EXAMPLE_CASES:
        mesh = parallel.create_mesh(sp=SP, pp=PP)
        model, opt, params, st = bert.build(
            cfg, lr=LR, opt_level="O0", device="cpu",
            state_dict=sd[mesh.index("pipe")], mesh=mesh,
            sp_attention=pattern, pp_microbatches=M)
        group = "data" if schedule == "1f1b" else "data_sp"
        ddp = parallel.DistributedDataParallel(
            model, process_group=mesh.group(group))
        scale = float(opt.loss_scale(st))
        params, st, loss, grads = bert.train_step(
            model, opt, params, st, mine, grad_accum=accum, ddp=ddp,
            mesh=mesh, schedule=schedule)
        out[("pp", schedule, pattern, accum)] = {
            "loss": float(loss),
            "grads": {k: v.detach() / (scale if accum == 1 else 1.0)
                      for k, v in grads.items()},
            "params": {k: v.detach().clone() for k, v in params.items()}}
    if dp > 1:
        return
    mesh = parallel.create_mesh(sp=SP)
    d = mesh.index("data")
    batch = tuple(a[d * EX_B // 2:(d + 1) * EX_B // 2] for a in mine)
    model, opt, params, st = bert.build(
        cfg, lr=LR, opt_level="O0", device="cpu", state_dict=sd["dense"],
        mesh=mesh, sp_attention="ring")
    ddp = parallel.DistributedDataParallel(
        model, process_group=mesh.group("data_sp"))
    params, st, loss, grads = bert.train_step(
        model, opt, params, st, batch, grad_accum=2, ddp=ddp, mesh=mesh)
    out["dense_accum"] = {
        "loss": float(loss),
        "grads": {k: v.detach() for k, v in grads.items()},
        "params": {k: v.detach().clone() for k, v in params.items()}}


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        dp = world // (SP * PP)
        mesh = parallel.create_mesh(sp=SP, pp=PP)
        d, r = mesh.index("data"), mesh.index("pipe")
        init = torch.load(f"{tmpdir}/init.pt")
        out = {"coords": (d, mesh.index("sp"), r),
               "members": {axis: mesh.group(axis).members()
                           for axis in ("data", "sp", "pipe", "data_sp")}}
        _bert_runs(mesh, init["bert"][r], d, dp, out)
        _gpt_runs(mesh, init["gpt"][r], d, dp, out)
        _bert_dropout(mesh, init["bert"][r], d, dp, out)
        _example_steps(init["example"], d, dp, out)
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- the JAX side ------------------------------------------------------------

def _jbcfg(dropout=0.0):
    from apex_tpu import models as jm
    c = _bcfg(dropout)
    return jm.BertConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})


def _jgcfg():
    from apex_tpu import models as jm
    c = _gcfg()
    return jm.GPTConfig(**{f: getattr(c, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})


def _jmesh(world):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:world]).reshape(
        world // (SP * PP), SP, PP), ("data", "sp", "pipe"))


def _stage_rows(stages, st):
    import jax
    return jax.tree.map(lambda a: np.asarray(a)[st], stages)


def _mono_bert(p):
    """A JAX ``PipelinedBert`` tree as the dense model's (one layer a
    stage)."""
    enc = dict(p["embed"])
    for st in range(PP):
        enc[f"layer_{st}"] = _stage_rows(p["stages"]["layer_0"], st)
    return {"encoder": enc, **p["heads"]}


def _mono_gpt(p):
    mono = {"wte": p["embed"]["wte"], "wpe": p["embed"]["wpe"],
            "final_ln": p["head"]}
    for st in range(PP):
        mono[f"block_{st}"] = _stage_rows(p["stages"]["block_0"], st)
    return mono


@pytest.fixture(scope="module")
def jax_init():
    """The JAX pipelined models' initial params and the example's."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    mesh = _jmesh(SP * PP)
    ids, mask, _ = _batch()
    pb = jm.PipelinedBert(_jbcfg(), mesh, pp=PP, num_microbatches=M,
                          seq_axis="sp",
                          attention_fn=jpar.make_ulysses_attention("sp"))
    pg = jm.PipelinedGPT(_jgcfg(), mesh, pp=PP, num_microbatches=M,
                         seq_axis="sp",
                         attention_fn=jpar.make_ulysses_attention(
                             "sp", causal=True))
    ex = _example_setup()
    return {"bert": jax.tree.map(np.asarray, pb.init(
                jax.random.PRNGKey(1), ids, mask)["params"]),
            "gpt": jax.tree.map(np.asarray, pg.init(
                jax.random.PRNGKey(1), ids)["params"]),
            "example": jax.tree.map(np.asarray, ex[2].init(
                jax.random.PRNGKey(0),
                jnp.zeros((1, EX_S), jnp.int32))["params"])}


_RANKS = {}


def _spawn(world, tmp, jax_init):
    ex_cfg = bert.get_config("tiny")
    torch.save({
        "bert": [tb.params_from_jax(jax_init["bert"], _bcfg(), rank=r)
                 for r in range(PP)],
        "gpt": [tg.params_from_jax(jax_init["gpt"], _gcfg(), rank=r)
                for r in range(PP)],
        "example": {**{r: tb.params_from_jax(jax_init["example"], ex_cfg,
                                             rank=r) for r in range(PP)},
                    "dense": tb.params_from_jax(
                        _mono_bert(jax_init["example"]), ex_cfg)}},
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
                f"ppsp{world}"), jax_init)
        return _RANKS[world]
    return get


_JAX = {}


def _jloss(mlm, nsp, tgt):
    import jax
    import jax.numpy as jnp
    oh = jax.nn.one_hot(tgt["mlm"], mlm.shape[-1])
    l1 = -jnp.mean(jnp.sum(jax.nn.log_softmax(mlm) * oh, -1))
    oh2 = jax.nn.one_hot(tgt["nsp"], 2)
    l2 = -jnp.mean(jnp.sum(jax.nn.log_softmax(nsp) * oh2, -1))
    return l1 + l2


def _jax_dense(jax_init):
    """The JAX dense models on the whole batch: BERT's logits, loss and
    gradients, GPT's logits, loss and gradients."""
    if "dense" in _JAX:
        return _JAX["dense"]
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    ids, mask, tgt = _batch()
    bp = jax.tree.map(jnp.asarray, _mono_bert(jax_init["bert"]))

    def bert_loss(p):
        mlm, nsp = jm.BertForPreTraining(_jbcfg()).apply(
            {"params": p}, ids, mask, deterministic=True)
        return _jloss(mlm, nsp, tgt), (mlm, nsp)

    (bl, (mlm, nsp)), bg = jax.jit(jax.value_and_grad(
        bert_loss, has_aux=True))(bp)
    gp = jax.tree.map(jnp.asarray, _mono_gpt(jax_init["gpt"]))

    def gpt_loss(p):
        logits = jm.GPTLMHeadModel(_jgcfg()).apply({"params": p}, ids)
        return jm.lm_loss(logits, ids), logits

    (gl, logits), gg = jax.jit(jax.value_and_grad(
        gpt_loss, has_aux=True))(gp)
    _JAX["dense"] = {
        "mlm": np.asarray(mlm), "nsp": np.asarray(nsp), "bert_loss":
        float(bl), "bert_grads": tb.params_from_jax(
            jax.tree.map(np.asarray, bg), _bcfg()),
        "logits": np.asarray(logits), "gpt_loss": float(gl),
        "gpt_grads": tg.params_from_jax(jax.tree.map(np.asarray, gg),
                                        _gcfg())}
    return _JAX["dense"]


def _jax_dropout(jax_init, world):
    """The JAX ``PipelinedBert``'s 1F1B with Ulysses and dropout 0.1 at
    (world / 4, 2, 2) under ``PRNGKey(7)``."""
    if ("drop", world) in _JAX:
        return _JAX[("drop", world)]
    import jax
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    ids, mask, tgt = _batch()
    mesh = _jmesh(world)
    pb = jm.PipelinedBert(_jbcfg(0.1), mesh, pp=PP, num_microbatches=M,
                          seq_axis="sp",
                          batch_axis="data" if world > SP * PP else None,
                          attention_fn=jpar.make_ulysses_attention("sp"))
    with mesh:
        loss, grads = jax.jit(lambda v: pb.loss_and_grad_1f1b(
            v, ids, _jloss, tgt, attention_mask=mask, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)}))(
                {"params": jax_init["bert"]})
    _JAX[("drop", world)] = (float(loss), jax.tree.map(np.asarray, grads))
    return _JAX[("drop", world)]


def _example_setup(world=SP * PP):
    """The JAX example's ``--pp 2 --ring-attention 2`` model pieces on a
    (world / 4, 2, 2) mesh: ``(mesh, optimizer_def, model_def, model_def
    factory, cfg)``."""
    from apex_tpu import models as jm
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    mesh = _jmesh(world)
    cfg = jm.BertConfig(vocab_size=1024, hidden_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=256, max_position_embeddings=512)

    def opt_def(pp):
        return jopt.FusedLAMB(
            lr=LR, max_grad_norm=1.0,
            param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
            exclude_from_layer_adaptation=lambda path: any(
                "bias" in str(k) or "_ln" in str(k) for k in path),
            per_slice_trust_ratio=(
                (lambda path: any("stages" in str(k) for k in path))
                if pp else None))

    def model_def(pattern):
        make = (jpar.make_ulysses_attention if pattern == "ulysses"
                else jpar.make_ring_attention)
        return jm.PipelinedBert(cfg, mesh, pp=PP, num_microbatches=M,
                                batch_axis="data", seq_axis="sp",
                                attention_fn=make("sp"))
    return mesh, opt_def, model_def("ring"), model_def, cfg


def _accum_step_fn(optimizer, slice_grads, accum, batch):
    """The JAX example's ``make_accum_step`` body (grads returned)."""
    import jax.numpy as jnp

    def step(params, opt_state):
        ids, labels, weights, nsp = batch
        denom = jnp.maximum(jnp.sum(weights), 1.0)
        if accum == 1:
            loss, grads = slice_grads(params, opt_state, ids, labels,
                                      weights, nsp, denom, 1.0)
            params, opt_state = optimizer.step(params, grads, opt_state)
            return params, loss, grads
        mb = lambda a: jnp.stack([a[j::accum] for j in range(accum)])
        parts = [mb(a) for a in batch]
        stashed, overflow, st, total = None, jnp.asarray(False), \
            opt_state, 0
        for j in range(accum):
            loss_j, grads = slice_grads(params, st, *(p[j] for p in parts),
                                        denom, float(accum))
            grads, ovf, st = optimizer.unscale_grads(
                grads, st, 0, stashed=stashed, update_scale=False)
            stashed, overflow, total = grads, overflow | ovf, total + loss_j
        st = optimizer.update_scale(st, overflow, 0)
        params, st = optimizer.apply_gradients(params, stashed, st,
                                               overflow)
        return params, total, stashed
    return step


def _jax_example_step(jax_init, schedule, pattern, accum, world=SP * PP):
    """The JAX example's step for ``--pp 2 --ring-attention 2`` on a
    (world / 4, 2, 2) mesh and ``world / 4 * EX_B`` rows (or, with
    ``schedule`` None, the dense ``--ring-attention 2`` at (dp 2, sp 2)
    on ``EX_B``), its ``--sp-attention`` and ``--grad-accum``."""
    key = (schedule, pattern, accum, world)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import parallel as jpar
    mesh, opt_def, _, model_def, cfg = _example_setup(world)
    params = jax_init["example"]
    if schedule is None:
        mesh = Mesh(np.asarray(jax.devices()[:SP * PP]).reshape(2, SP),
                    ("data", "sp"))
        ring_fn = jpar.make_ring_attention("sp")

        def attention_fn(q, k, v, bias=None, dropout_fn=None):
            if bias is None:
                bias = jnp.zeros((q.shape[0], 1, 1, q.shape[1]),
                                 jnp.float32)
            f = jax.shard_map(
                lambda q, k, v, bias: ring_fn(q, k, v, bias=bias,
                                              dropout_fn=dropout_fn),
                mesh=mesh,
                in_specs=(P("data", "sp"),) * 3
                + (P("data", None, None, "sp"),),
                out_specs=P("data", "sp"))
            return f(q, k, v, bias)
        mdef = jm.BertForPreTraining(cfg, attention_fn=attention_fn)
        params = _mono_bert(params)
    else:
        mdef = model_def(pattern)
    model, optimizer = jamp.initialize(mdef, opt_def(schedule is not None),
                                       opt_level="O0", verbosity=0)
    params = jax.tree.map(jnp.asarray, params)
    opt_state = optimizer.init(params)
    dp = world // (SP * PP) if schedule is not None else 2

    def batch_loss(p, ids, labels, weights, nsp, denom, div):
        mlm_logits, nsp_logits = model.apply({"params": p}, ids,
                                             deterministic=True)
        mlm = optax.softmax_cross_entropy_with_integer_labels(
            mlm_logits, labels)
        return (jnp.sum(mlm * weights) / denom
                + optax.softmax_cross_entropy_with_integer_labels(
                    nsp_logits, nsp).mean() / div)

    def slice_grads(p, st, ids, labels, weights, nsp, denom, div):
        if schedule == "1f1b":
            def mb_loss(mlm_logits, nsp_logits, tgt):
                mlm = jnp.sum(
                    optax.softmax_cross_entropy_with_integer_labels(
                        mlm_logits, tgt["labels"]) * tgt["weights"]) \
                    * (M * dp) / denom
                nsp_l = optax.softmax_cross_entropy_with_integer_labels(
                    nsp_logits, tgt["nsp"]).mean() / div
                return jamp.scale(mlm + nsp_l, st)
            loss_s, grads = model.loss_and_grad_1f1b(
                {"params": p}, ids, mb_loss,
                {"labels": labels, "weights": weights, "nsp": nsp})
            return loss_s / optimizer.loss_scale(st), grads

        def loss_fn(p):
            loss = batch_loss(p, ids, labels, weights, nsp, denom, div)
            with jamp.scale_loss(loss, st) as scaled:
                return scaled, loss
        grads, loss = jax.grad(loss_fn, has_aux=True)(p)
        return loss, grads

    batch = tuple(jnp.asarray(a) for a in _example_batch(
        EX_B if schedule is None else dp * EX_B))
    with mesh:
        params, loss, grads = jax.jit(_accum_step_fn(
            optimizer, slice_grads, accum, batch))(params, opt_state)
    _JAX[key] = (float(loss), jax.tree.map(np.asarray, grads),
                 jax.tree.map(np.asarray, params))
    return _JAX[key]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_mesh_coordinates(spawned, world):
    dp = world // (SP * PP)
    grid = np.arange(world).reshape(dp, SP, PP)
    for rank, o in enumerate(spawned(world)):
        d, s, p = o["coords"]
        assert grid[d, s, p] == rank
        m = o["members"]
        assert m["data"] == tuple(grid[:, s, p])
        assert m["sp"] == tuple(grid[d, :, p])
        assert m["pipe"] == tuple(grid[d, s, :])
        assert m["data_sp"] == tuple(grid[:, :, p].reshape(-1))


@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_pipelined_bert_dp_sp_pp(spawned, jax_init, world):
    """GPipe with ring attention against the JAX dense model."""
    want = _jax_dense(jax_init)
    dp, sl = world // (SP * PP), S // SP
    n = B // dp
    for o in spawned(world):
        d, s, _ = o["coords"]
        got = o["bert_gpipe"]
        assert rel_err(got["mlm"], want["mlm"][d * n:(d + 1) * n,
                                                s * sl:(s + 1) * sl]) \
            <= FWD_TOL
        if s == 0:
            assert rel_err(got["nsp"], want["nsp"][d * n:(d + 1) * n]) \
                <= FWD_TOL


@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_bert_1f1b_ulysses_dp_sp_pp_matches_monolithic(spawned, jax_init,
                                                        world):
    want = _jax_dense(jax_init)
    for o in spawned(world):
        got = o["bert_1f1b"]
        assert abs(float(got["loss"]) - want["bert_loss"]) \
            <= LOSS_TOL * abs(want["bert_loss"])
        ref = tb.dense_to_rank(want["bert_grads"], _bcfg(), PP,
                               o["coords"][2])
        assert set(got["grads"]) == set(ref)
        for k, g in got["grads"].items():
            assert _close(g, ref[k], RTOL, ATOL), (o["coords"], k)


@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_1f1b_ring_rejected(spawned, family):
    for o in spawned(SP * PP):
        msg = o[f"{family}_ring_1f1b"]
        assert msg is not None and RING_ONEF1B in msg and "ring" in msg


@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_pipelined_gpt_gpipe_ring_sp_forward(spawned, jax_init, world):
    want = _jax_dense(jax_init)["logits"]
    dp, sl = world // (SP * PP), S // SP
    n = B // dp
    for o in spawned(world):
        d, s, _ = o["coords"]
        assert rel_err(o["gpt_gpipe"], want[d * n:(d + 1) * n,
                                            s * sl:(s + 1) * sl]) \
            <= GPT_FWD_TOL


@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_pipelined_gpt_1f1b_ulysses_dp_sp_pp_matches_monolithic(
        spawned, jax_init, world):
    want = _jax_dense(jax_init)
    for o in spawned(world):
        got = o["gpt_1f1b"]
        assert abs(float(got["loss"]) - want["gpt_loss"]) \
            <= LOSS_TOL * abs(want["gpt_loss"])
        ref = tg.dense_to_rank(want["gpt_grads"], _gcfg(), PP,
                               o["coords"][2])
        assert set(got["grads"]) == set(ref)
        for k, g in got["grads"].items():
            assert _close(g, ref[k], GPT_RTOL, ATOL), (o["coords"], k)


@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_dropout_matches_the_jax_pipelined_bert(spawned, jax_init, world):
    loss, grads = _jax_dropout(jax_init, world)
    for o in spawned(world):
        got = o["drop"]
        ref = tb.params_from_jax(grads, _bcfg(), rank=o["coords"][2])
        for lval, g in ((got["loss"], got["grads"]),
                        (got["gpipe_loss"], got["gpipe_grads"])):
            assert abs(float(lval) - loss) <= DROP_TOL * abs(loss)
            assert set(g) == set(ref)
            for k, v in g.items():
                assert rel_err(v, ref[k]) <= DROP_TOL, (o["coords"], k)


def _check_example(got, want, rank_of):
    loss, grads, params = want
    assert abs(got["loss"] - loss) <= LOSS_TOL * abs(loss), \
        (got["loss"], loss)
    g_ref, p_ref = rank_of(grads), rank_of(params)
    assert set(got["grads"]) == set(g_ref)
    for k, g in got["grads"].items():
        assert rel_err(g, g_ref[k]) <= GRAD_TOL, k
    for k, p in got["params"].items():
        assert rel_err(p, p_ref[k]) <= PARAM_TOL, k


@pytest.mark.parametrize("schedule,pattern,accum", EXAMPLE_CASES)
@pytest.mark.parametrize("world", [4, 8], ids=["1x2x2", "2x2x2"])
def test_pp_ring_attention_step_matches_the_jax_example(
        spawned, jax_init, world, schedule, pattern, accum):
    cfg = bert.get_config("tiny")
    want = _jax_example_step(jax_init, schedule, pattern, accum, world)
    outs = spawned(world)
    case = ("pp", schedule, pattern, accum)
    # a data index's loss is its rows'; their mean is the JAX step's
    mean = np.mean([o[case]["loss"] for o in outs if o["coords"][1:] ==
                    (0, 0)])
    for o in outs:
        _check_example({**o[case], "loss": mean}, want,
                       lambda tree, r=o["coords"][2]:
                       tb.params_from_jax(tree, cfg, rank=r))


def test_dense_ring_attention_grad_accum_matches_the_jax_example(
        spawned, jax_init):
    cfg = bert.get_config("tiny")
    loss, grads, params = _jax_example_step(jax_init, None, "ring", 2)
    outs = spawned(SP * PP)
    # a data index's loss is its half of the batch's: their mean
    for d in range(2):
        for o in outs[d * SP:(d + 1) * SP]:
            assert o["dense_accum"]["loss"] == outs[d * SP][
                "dense_accum"]["loss"]
    mean = {"loss": np.mean([outs[d * SP]["dense_accum"]["loss"]
                             for d in range(2)])}
    for o in outs:
        _check_example({**o["dense_accum"], **mean}, (loss, grads, params),
                       lambda tree: tb.params_from_jax(tree, cfg))


def test_cli_takes_pp_with_ring_attention():
    """The JAX example's checks, in its order: the mesh, then 1F1B with
    ring attention."""
    with pytest.raises(SystemExit, match=r"SP=2 x PP=2 must divide "
                       r"devices \(1\), SP the seq len \(128\), PP the "
                       r"layers \(2\)"):
        bert.main(["--config", "tiny", "--pp", "2", "--ring-attention",
                   "2"])
    with pytest.raises(SystemExit, match="cannot host ring attention"):
        bert.main(["--config", "tiny", "--pp", "1", "--ring-attention",
                   "1", "--pp-schedule", "1f1b"])
