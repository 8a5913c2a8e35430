"""Megatron tensor parallelism in apex_tpu_torch against apex_tpu's.

- The rules: on GPT-tiny and BERT-tiny the port's ``param_specs`` splits
  every parameter on the dim that corresponds to the JAX ``param_specs``
  pick (the port's ``nn.Linear`` is (out, in) and its q/k/v flatten the
  JAX kernel's heads), the indivisible fallback included, and each
  rank's ``local_slice`` under those specs (what ``shard_params`` cuts)
  is the JAX placement's shard; a rule of more dims
  than its parameter, or naming a missing axis, raises.
- GPT-tiny (vocab 997 padded to 1024, hidden 128, 2 layers, 4 heads, MLP
  256, sequence 32) trained at O0 on a world of 4 gloo ranks as a (dp 2,
  tp 2) mesh by ``gpt_main_amp.train(tp=2, ddp=True)``, against the JAX
  example's ``--tp`` step (``shard_params(gpt_tp_rules)``,
  ``FusedAdam(layout="tree")``, ``vocab_parallel_lm_loss`` on a (2, 2)
  mesh) from the same weights and batches, 2 steps at lr 1e-3: losses
  within 1e-5 relative, params within 2e-5 scale-aware.  The attention
  key biases are the exception: the softmax is invariant to them, their
  gradient is rounding noise in both packages, and Adam's first step is
  lr * sign(g), so they may differ by 2 lr.
- TP peers draw the same default batches (seeded by the data index);
  an inf planted in one rank's gradients skips the step on every rank
  of its model group (params keep their bits, the scale halves); the
  ``max_grad_norm`` norm counts replicated leaves once
  (``FusedAdam.with_model_parallel``, against the dense model's step).
- Dropout under TP: with the default attention and with the flash
  adapter (the plain versions on the CPU), the TP loss equals the JAX
  model's under the same key within 1e-5, and the flash kernels' keep
  masks (seed and head offsets as the adapter receives them) equal the
  JAX model's masks for this rank's heads bit for bit.

The ranks are spawned once for the module (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import importlib
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, parallel
from apex_tpu_torch.examples import gpt_main_amp as gpt
from apex_tpu_torch.models import gpt as tg
from apex_tpu_torch.ops import keep_from_seed, make_flash_attention, \
    seed_array, threefry, vocab_parallel_lm_loss
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import tensor_parallel as tpar

TINY = dict(vocab_size=997, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=32)
DP, TP, B, S, STEPS, LR = 2, 2, 2, 32, 2, 1e-3
WORLD = DP * TP
VOCAB = tg.padded_vocab(TINY["vocab_size"], TP)
LOSS_TOL, PARAM_TOL, DROP_TOL = 1e-5, 2e-5, 1e-5
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
NORM_ADAM = dict(lr=LR, eps=1e-2, max_grad_norm=0.05)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _cfg(**kw):
    return tg.GPTConfig(**{**TINY, **kw})


def _batches():
    """The JAX example's global batches: ``RandomState(0)`` ids from the
    true vocab, ``DP * B`` rows a step, data index d's rows
    ``[d * B, (d + 1) * B)``."""
    rng = np.random.RandomState(0)
    return np.stack([rng.randint(0, TINY["vocab_size"], (DP * B, S))
                     .astype(np.int32) for _ in range(STEPS)])


def _step_grads(model, params, ids, mesh, scaled_state=None):
    hidden = model.apply(params, ids, return_hidden=True)
    loss = vocab_parallel_lm_loss(hidden, params["wte.weight"], ids, mesh,
                                  true_vocab=TINY["vocab_size"])
    if scaled_state is not None:
        with amp.scale_loss(loss, scaled_state) as scaled:
            loss = scaled
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params.keys(), grads))


def _overflow(sd, rows, mesh, rank):
    """One O2 step with an inf in rank 1's gradient of a sharded leaf
    (the moments whole: with ZeRO-1 over the data group the flag is
    taken over it too, ``tests/test_torch_zero_tp.py``)."""
    model, opt, params, st = gpt.build(_cfg(vocab_size=VOCAB), lr=LR,
                                       opt_level="O2", device="cpu",
                                       state_dict=sd, mesh=mesh, zero=False)
    grads = _step_grads(model, params, torch.from_numpy(rows), mesh, st)
    if rank == 1:
        grads["blocks.0.mlp_in.weight"].fill_(float("inf"))
    before = {k: v.detach().clone() for k, v in params.items()}
    scale0 = float(opt.loss_scale(st))
    params, st = opt.step(params, grads, st)
    return {"kept": all(torch.equal(before[k], params[k]) for k in params),
            "scale0": scale0, "scale": float(opt.loss_scale(st)),
            "skipped": int(st.skipped_steps)}


def _grad_norm(sd, rows, mesh):
    """The tree step with ``max_grad_norm`` and the model's norm, and
    without it, each against the dense model's step, on this rank's
    slices."""
    cfg = _cfg(vocab_size=VOCAB)
    ids = torch.from_numpy(rows)
    tp_model = tg.GPTLMHeadModel(cfg, device="cpu", seed=None,
                                 tp=mesh.group("model"))
    tp_model.load_state_dict(tpar.shard_params(
        sd, mesh, tpar.gpt_tp_rules(), num_heads=cfg.num_attention_heads))
    specs = tp_model.tp_specs()
    params = dict(tp_model.named_parameters())
    grads = _step_grads(_Bare(tp_model), params, ids, mesh)
    dense = tg.GPTLMHeadModel(cfg, device="cpu", seed=None)
    dense.load_state_dict(sd)
    dparams = dict(dense.named_parameters())
    logits = dense(ids)[..., :TINY["vocab_size"]]
    dgrads = dict(zip(dparams, torch.autograd.grad(
        tg.lm_loss(logits, ids), list(dparams.values()))))
    adam = FusedAdam(layout="tree", **NORM_ADAM)
    want, _ = adam.step({k: v.detach().clone() for k, v in dparams.items()},
                        dgrads, adam.init(dparams))
    coords = {"model": mesh.index("model")}
    want = {k: tpar.local_slice(v, specs.get(k, ()), {"model": TP}, coords)
            for k, v in want.items()}
    out = {}
    for label, opt in (("model_norm", adam.with_model_parallel(
            mesh.group("model"), {k: bool(v) for k, v in specs.items()})),
                       ("local_norm", adam)):
        got, _ = opt.step({k: v.detach().clone() for k, v in params.items()},
                          grads, opt.init(params))
        out[label] = max(rel_err(got[k].numpy(), want[k].numpy())
                         for k in got)
    return out


class _Bare:
    """A module called as amp's ``apply`` is (params given by name)."""

    def __init__(self, module):
        self.module = module

    def apply(self, params, *args, **kwargs):
        return torch.func.functional_call(self.module, params, args, kwargs)


def _dropout(sd, rows, mesh, key):
    """The TP forward with dropout: the default attention's loss, and
    the flash adapter's loss with the seeds and offsets it received."""
    out = {}
    for attention in ("default", "flash"):
        received = []
        fn = None
        if attention == "flash":
            flash = make_flash_attention(causal=True)

            def fn(q, k, v, bias=None, dropout_fn=None):
                received.append((int(dropout_fn.seed),
                                 tuple(dropout_fn.offsets)))
                return flash(q, k, v, bias=bias, dropout_fn=dropout_fn)
        cfg = _cfg(vocab_size=VOCAB, **DROPOUT)
        model = tg.GPTLMHeadModel(cfg, attention_fn=fn, device="cpu",
                                  seed=None, tp=mesh.group("model"))
        model.load_state_dict(tpar.shard_params(
            sd, mesh, tpar.gpt_tp_rules(),
            num_heads=cfg.num_attention_heads))
        ids = torch.from_numpy(rows)
        with torch.no_grad():
            hidden = model(ids, deterministic=False, dropout_key=key,
                           return_hidden=True)
            loss = vocab_parallel_lm_loss(hidden, model.wte.weight, ids,
                                          mesh,
                                          true_vocab=TINY["vocab_size"])
        out[attention] = {"loss": float(loss), "received": received}
    return out


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        sd = torch.load(f"{tmpdir}/init.pt")
        data = _batches()
        mesh = parallel.create_mesh(tp=TP)
        d = mesh.index("data")
        rows = [b[d * B:(d + 1) * B] for b in data]
        out = {"data": mesh.group("data").members(),
               "model": mesh.group("model").members()}
        run = gpt.train(_cfg(), batch=B, seq_len=S, steps=STEPS, lr=LR,
                        opt_level="O0", device="cpu", state_dict=sd,
                        ddp=True, tp=TP, data=iter(rows))
        out["losses"] = run["losses"]
        out["params"] = {k: v.detach().clone()
                         for k, v in run["params"].items()}
        out["default_losses"] = gpt.train(
            _cfg(), batch=B, seq_len=S, steps=1, lr=LR, opt_level="O0",
            device="cpu", ddp=True, tp=TP)["losses"]
        # what the data index's batch gives the dense model of the same
        # seed (a TP forward on ids that differ between the peers would
        # give another loss, the same on both peers)
        dense = tg.GPTLMHeadModel(_cfg(vocab_size=VOCAB),
                                  attention_fn=make_flash_attention(
                                      causal=True), device="cpu", seed=0)
        ids = torch.from_numpy(next(gpt.batches(TINY["vocab_size"], B, S,
                                                seed=d)))
        with torch.no_grad():
            out["default_want"] = float(tg.lm_loss(
                dense(ids)[..., :TINY["vocab_size"]], ids))
        out["overflow"] = _overflow(sd, rows[0], mesh, rank)
        out["grad_norm"] = _grad_norm(sd, rows[0], mesh)
        out["dropout"] = _dropout(sd, rows[0], mesh,
                                  threefry.fold_in(threefry.PRNGKey(0), 1))
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("tp")
    torch.save(tg.params_from_jax(jax_init, _cfg(vocab_size=VOCAB)),
               tmp / "init.pt")
    torch.multiprocessing.start_processes(_rank_main,
                                          args=(WORLD, str(tmp)),
                                          nprocs=WORLD, join=True,
                                          start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _jax_tp_run(jax_init):
    """The JAX example's ``--tp 2`` step on a (2, 2) mesh at O0."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import amp as jamp
    from apex_tpu import models as jm
    from apex_tpu import ops as jops
    from apex_tpu import optimizers as jopt
    from apex_tpu import parallel as jpar
    from apex_tpu.ops.flash_attention import make_flash_attention as jflash
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(DP, TP),
                ("data", "model"))
    cfg = jm.GPTConfig(**{**TINY, "vocab_size": VOCAB})
    model, optimizer = jamp.initialize(
        jm.GPTLMHeadModel(cfg, attention_fn=jflash(causal=True)),
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
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss

    losses = []
    with mesh:
        for ids in _batches():
            params, opt_state, loss = train_step(
                params, opt_state,
                jax.device_put(ids, NamedSharding(mesh, P("data"))))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def test_mesh_groups(ranks):
    for r, out in enumerate(ranks):
        assert out["model"] == tuple(range(r // TP * TP, r // TP * TP + TP))
        assert out["data"] == tuple(range(r % TP, WORLD, TP))


def test_tp_training_matches_the_jax_example(ranks, jax_init):
    want_losses, want_params = _jax_tp_run(jax_init)
    want = tg.params_from_jax(want_params, _cfg(vocab_size=VOCAB))
    init = tg.params_from_jax(jax_init, _cfg(vocab_size=VOCAB))
    mesh = tpar.Mesh({"data": DP, "model": TP})
    # a rank's loss is its data index's rows; the JAX loss the global
    # batch's: the mean over the data indices
    got = np.mean([ranks[d * TP]["losses"] for d in range(DP)], axis=0)
    for got_l, want_l in zip(got, want_losses):
        assert abs(got_l - want_l) <= LOSS_TOL * abs(want_l), \
            (got, want_losses)
    for r, out in enumerate(ranks):
        assert out["losses"] == ranks[r // TP * TP]["losses"]
        coords = {"data": r // TP, "model": r % TP}
        specs = tpar.param_specs(want, mesh, tpar.gpt_tp_rules(),
                                 num_heads=TINY["num_attention_heads"])
        mine = {k: tpar.local_slice(v, specs[k], mesh.shape, coords)
                for k, v in want.items()}
        start = {k: tpar.local_slice(v, specs[k], mesh.shape, coords)
                 for k, v in init.items()}
        for name, p in out["params"].items():
            assert p.shape == mine[name].shape, name
            err = rel_err(p.numpy(), mine[name].numpy())
            if "attention.key.bias" in name:
                assert np.max(np.abs(p.numpy() - mine[name].numpy())) \
                    <= 2 * LR * STEPS, name
            else:
                assert err <= PARAM_TOL, (name, err)
            # the step moved every trained leaf
            if "wte" not in name:
                assert not torch.equal(p, start[name]), name


def test_tp_peers_draw_the_same_batch(ranks):
    losses = [out["default_losses"][0] for out in ranks]
    assert losses[0] == losses[1] and losses[2] == losses[3]
    assert losses[0] != losses[2]
    for out in ranks:
        want = out["default_want"]
        assert abs(out["default_losses"][0] - want) <= LOSS_TOL * want


def test_overflow_on_one_rank_skips_its_model_group(ranks):
    for r, out in enumerate(ranks):
        o = out["overflow"]
        if r < TP:      # rank 1's group
            assert o["kept"] and o["skipped"] == 1
            assert o["scale"] == o["scale0"] / 2
        else:
            assert not o["kept"] and o["skipped"] == 0
            assert o["scale"] == o["scale0"]


def test_grad_norm_counts_replicated_leaves_once(ranks):
    for out in ranks:
        norm = out["grad_norm"]
        assert norm["model_norm"] <= 1e-6, norm
        # the rank's own norm clips by another factor: the check sees it
        assert norm["local_norm"] > 100 * max(norm["model_norm"], 1e-8), norm


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_tp_dropout_matches_jax(ranks, jax_init, attention):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    jfa = importlib.import_module("apex_tpu.ops.flash_attention")
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    seeds = []

    def recording(fn):
        def attention_fn(q, k, v, bias=None, dropout_fn=None):
            if dropout_fn is not None:
                jax.debug.callback(lambda s: seeds.append(int(s)),
                                   dropout_fn.seed, ordered=True)
            return fn(q, k, v, bias=bias, dropout_fn=dropout_fn)
        return attention_fn

    jattn = recording(jfa.make_flash_attention(causal=True,
                                               use_pallas=False)) \
        if attention == "flash" else None
    model = jm.GPTLMHeadModel(
        jm.GPTConfig(**{**TINY, "vocab_size": VOCAB}, **DROPOUT),
        attention_fn=jattn)
    ids = jnp.asarray(_batches()[0][:B])
    logits = jax.jit(lambda p: model.apply(
        {"params": p}, ids, deterministic=False, rngs={"dropout": key}))(
        jax.tree.map(jnp.asarray, jax_init))
    jax.effects_barrier()
    want = float(jm.lm_loss(logits[..., :TINY["vocab_size"]], ids))
    heads = TINY["num_attention_heads"]
    hl = heads // TP
    rows = torch.arange(S)
    for r, out in enumerate(ranks[:TP]):    # data index 0
        got = out["dropout"][attention]
        assert abs(got["loss"] - want) <= DROP_TOL * abs(want)
        if attention == "default":
            continue
        assert [s for s, _ in got["received"]] == seeds
        for (seed, offsets), jseed in zip(got["received"], seeds):
            assert offsets == (0, 0, r * hl, heads)
            mine = keep_from_seed(seed_array(seed, offsets, num_heads=hl),
                                  B, hl, rows, rows, 0.1).numpy()
            full = np.asarray(jfa.keep_from_seed(
                jfa.seed_array(jseed, num_heads=heads), B, heads,
                jnp.arange(S), jnp.arange(S), 0.1))
            np.testing.assert_array_equal(mine,
                                          full[:, r * hl:(r + 1) * hl])
    # dropout is live: another loss than the deterministic forward's
    det = float(jm.lm_loss(model.apply(
        {"params": jax.tree.map(jnp.asarray, jax_init)}, ids)
        [..., :TINY["vocab_size"]], ids))
    assert abs(det - want) > 1e-4


def _jax_params(kind, heads):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models as jm
    from apex_tpu_torch import models as tm
    if kind == "gpt":
        cfg = jm.GPTConfig(**{**TINY, "num_attention_heads": heads})
        p = jm.GPTLMHeadModel(cfg).init(jax.random.PRNGKey(0),
                                        jnp.ones((1, 8), jnp.int32))
        p = jax.tree.map(np.asarray, p["params"])
        return p, tg.params_from_jax(p, _cfg(num_attention_heads=heads))
    kw = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1,
              num_attention_heads=heads, intermediate_size=64,
              max_position_embeddings=32)
    p = jm.BertForPreTraining(jm.BertConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.ones((2, 16), jnp.int32))
    p = jax.tree.map(np.asarray, p["params"])
    return p, tm.bert_params_from_jax(p, tm.BertConfig(**kw))


def _port_dim(jax_shape, jax_spec, port_name):
    """The port dim of a JAX pick: kernels transpose into (out, in), the
    q/k/v kernel (H, heads, hd) becomes (heads * hd, H), the attention
    output (heads, hd, H) becomes (H, heads * hd)."""
    picked = [d for d, e in enumerate(jax_spec) if e is not None]
    if not picked:
        return None
    d = picked[0]
    if port_name.endswith("bias") or "embeddings" in port_name \
            or port_name.startswith("wte") or len(jax_shape) == 1:
        return 0
    if len(jax_shape) == 3:
        return 0 if d == 1 else 1
    return 1 - d


def _jax_names(tree):
    from apex_tpu.utils.paths import path_str
    import jax
    return {path_str(path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def _port_name(jax_path):
    name = jax_path.replace("/", ".").replace("block_", "blocks.")
    return re.sub(r"\.(kernel|embedding)$", ".weight", name)


@pytest.mark.parametrize("kind,heads,tp", [("gpt", 4, 2), ("gpt", 4, 4),
                                           ("bert", 4, 4), ("bert", 2, 4)])
def test_rules_pick_the_jax_dims(kind, heads, tp):
    import jax
    from jax.sharding import Mesh
    from apex_tpu import parallel as jpar
    jparams, sd = _jax_params(kind, heads)
    jmesh = Mesh(np.asarray(jax.devices()[:2 * tp]).reshape(2, tp),
                 ("data", "model"))
    jrules = jpar.gpt_tp_rules() if kind == "gpt" else jpar.BERT_TP_RULES
    rules = tpar.gpt_tp_rules() if kind == "gpt" else tpar.BERT_TP_RULES
    jspecs = _jax_names(jpar.param_specs(jparams, jmesh, jrules))
    shapes = {k: np.shape(v) for k, v in _jax_names(jparams).items()}
    specs = tpar.param_specs(sd, tpar.Mesh({"data": 2, "model": tp}), rules,
                             num_heads=heads)
    assert len(jspecs) == len(specs)
    sharded = 0
    for path, jspec in jspecs.items():
        name = _port_name(path)
        assert name in specs, (path, name)
        want = _port_dim(shapes[path], tuple(jspec), name)
        got = specs[name].index("model") if "model" in specs[name] \
            else None
        assert got == want, (name, specs[name], tuple(jspec))
        sharded += got is not None
    assert sharded > 0
    if kind == "bert" and heads == 2:   # heads do not divide: replicated
        assert specs["encoder.layer_0.attention.query.weight"] == ()
        assert specs["encoder.layer_0.intermediate.weight"] == ("model",
                                                                None)


def test_shard_params_cuts_the_jax_shards():
    import jax
    from jax.sharding import Mesh
    from apex_tpu import parallel as jpar
    jparams, sd = _jax_params("gpt", 4)
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))
    placed = jpar.shard_params(jparams, jmesh, jpar.gpt_tp_rules())
    want = tg.params_from_jax(jax.tree.map(np.asarray, placed), _cfg())
    mesh = tpar.Mesh({"data": 2, "model": 2})
    for m in range(2):
        device = jmesh.devices[0, m]
        local = {}
        for path, leaf in _jax_names(placed).items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == device)
            local[path] = np.asarray(shard.data)
        specs = tpar.param_specs(sd, mesh, tpar.gpt_tp_rules(), num_heads=4)
        got = {k: tpar.local_slice(v, specs[k], mesh.shape,
                                   {"data": 0, "model": m})
               for k, v in sd.items()}
        # the JAX shard of wte is this rank's vocab rows
        np.testing.assert_array_equal(got["wte.weight"].numpy(),
                                      local["wte/embedding"])
        np.testing.assert_array_equal(
            got["blocks.0.mlp_in.weight"].numpy(),
            local["block_0/mlp_in/kernel"].T)
        q = local["block_0/attention/query/kernel"]     # (H, heads/2, hd)
        np.testing.assert_array_equal(
            got["blocks.0.attention.query.weight"].numpy(),
            q.reshape(q.shape[0], -1).T)
        assert got["wpe.weight"].shape == want["wpe.weight"].shape


def test_rule_errors():
    sd = {"blocks.0.mlp_in.weight": torch.zeros(8, 4)}
    mesh = tpar.Mesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="3-dim spec"):
        tpar.param_specs(sd, mesh, [(r"mlp_in\.weight$",
                                     ("model", None, None))])
    with pytest.raises(ValueError, match="mesh only has axes"):
        tpar.param_specs(sd, mesh, [(r"mlp_in\.weight$", ("tensor", None))])
    with pytest.raises(ValueError, match="num_heads"):
        tpar.param_specs({"attention.query.weight": torch.zeros(8, 8)}, mesh,
                         tpar.gpt_tp_rules())
    with pytest.raises(RuntimeError, match="initialized process group"):
        tg.GPTLMHeadModel(_cfg(), device="cpu",
                          tp=parallel.ProcessGroup(((0, 1),), None))
    # the first matching rule decides, even where it does not divide
    got = tpar.param_specs(sd, mesh, [(r"mlp_in", (None, "model")),
                                      (r"weight", ("model", None))])
    assert got == {"blocks.0.mlp_in.weight": (None, "model")}
    odd = tpar.param_specs({"mlp_in.weight": torch.zeros(8, 3)}, mesh,
                           [(r"mlp_in", (None, "model"))])
    assert odd == {"mlp_in.weight": ()}
