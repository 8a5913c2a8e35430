"""Switch-MoE in apex_tpu_torch against apex_tpu's, in one process.

The reference tests' sizes (``tests/distributed/test_moe_ep.py``: B 4,
S 16, H 32, F 64, E 8), fp32 on the CPU, the JAX module's weights
carried over with ``models.moe_params_from_jax``:

- ``MoEMlp`` dense and capacity against the JAX ``MoEMlp``: out within
  rtol 1e-5 / atol 1e-6, aux rtol 1e-6, and the gradients of x and of
  every leaf of a weighted sum of out and aux within 1e-5 scale-aware;
- capacity at factor E equals dense (``test_capacity_matches_dense_no_
  drop``); at factor 0.25 the zero rows are exactly the tokens past
  their expert's capacity, from the fp64 router
  (``test_capacity_drops_overflow_tokens``);
- under the port's amp O2 the router stays fp32 and ``experts_in`` is
  bf16 (``test_router_kernel_stays_fp32_under_amp``), and a bf16 input
  still routes as its fp32 copy does; a fresh router balances
  (``test_router_routes_and_balances``: 0.9 < aux < 2.5, >= 3 experts);
- ``BertForPreTraining`` with MoE layers: the logits and aux against
  the JAX model's ``mutable=["losses"]`` sum, both dispatches (logits
  1e-5 scale-aware, aux rtol 1e-6); ``bert_tp_rules`` match no MoE leaf
  and an MoE model has no ``"mlp"`` TP split;
- ``bert_main_amp`` with ``--config tiny --moe 4``: 3 O0 steps against
  the JAX example's ``train_step`` (its ``batch_loss`` with the aux,
  FusedLAMB as the recipe), losses within 1e-5 relative, step-1
  gradients and the params after step 3 within 1e-5 scale-aware, also under
  ``--grad-accum 2`` (the example's ``make_accum_step``) and
  ``--remat``; the CLI takes the flags;
- the refusals and the warning, with the reference's messages.
"""

import dataclasses
import importlib.util
import math
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import models as jm
from apex_tpu import optimizers as joptimizers
from apex_tpu_torch import amp, parallel
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.examples import bert_main_amp
from apex_tpu_torch.models import EP_RULES, MoEMlp, moe_params_from_jax
from apex_tpu_torch.models import bert as tb
from apex_tpu_torch.optimizers import transforms

torch.set_num_threads(1)

B, S, H, F, E = 4, 16, 32, 64, 8
OUT_RTOL, OUT_ATOL, AUX_RTOL = 1e-5, 1e-6, 1e-6
GRAD_TOL, LOGIT_TOL, LOSS_TOL = 1e-5, 1e-5, 1e-5
EX_B, EX_S, EX_E, EX_STEPS = 4, 32, 4, 3
EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / "bert" / \
    "main_amp.py"


@pytest.fixture(autouse=True)
def restore_amp():
    saved = _amp_state._amp_state.opt_properties
    yield
    _amp_state._amp_state.opt_properties = saved


def rel_err(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                + 1.0)


def _setup(seed=0, **kw):
    """The reference's ``_setup``: the JAX module, its params and x, and
    the port's module with the same weights."""
    moe = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=F,
                    **kw)
    x = jax.random.normal(jax.random.PRNGKey(seed), (B, S, H))
    params = moe.init(jax.random.PRNGKey(seed + 1), x)["params"]
    port = MoEMlp(E, H, F, device="cpu", **kw)
    port.load_state_dict(moe_params_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    return moe, params, x, port, torch.from_numpy(np.asarray(x))


def _weighted(out, aux, w):
    return (out * w).sum() + 0.37 * aux


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_matches_jax(dispatch):
    moe, params, x, port, xt = _setup(3, dispatch=dispatch)
    out, aux = moe.apply({"params": params}, x)
    w = jax.random.normal(jax.random.PRNGKey(9), (B, S, H))

    def f(p, x):
        o, a = moe.apply({"params": p}, x)
        return _weighted(o, a, w)

    gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
    xt.requires_grad_(True)
    got, got_aux = port(xt)
    assert got.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=AUX_RTOL)
    loss = _weighted(got, got_aux, torch.from_numpy(np.asarray(w)))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, [xt] + [p for _, p in
                                              port.named_parameters()])
    assert rel_err(grads[0], gx) < GRAD_TOL
    want = moe_params_from_jax(jax.tree.map(np.asarray, gp))
    for name, g in zip(names, grads[1:]):
        assert rel_err(g, want[name]) < GRAD_TOL, name
    assert float(grads[names.index("router.weight") + 1].abs().max()) > 0


def test_capacity_matches_dense_no_drop():
    moe, params, x, dense, xt = _setup(7)
    sparse = MoEMlp(E, H, F, dispatch="capacity", capacity_factor=float(E),
                    device="cpu")
    sparse.load_state_dict(dense.state_dict())
    out_d, aux_d = dense(xt)
    out_c, aux_c = sparse(xt)
    np.testing.assert_allclose(out_c.detach().numpy(),
                               out_d.detach().numpy(), rtol=OUT_RTOL,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(float(aux_c), float(aux_d), rtol=AUX_RTOL)
    jsparse = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=F,
                        dispatch="capacity", capacity_factor=float(E))
    want, _ = jsparse.apply({"params": params}, x)
    np.testing.assert_allclose(out_c.detach().numpy(), np.asarray(want),
                               rtol=OUT_RTOL, atol=OUT_ATOL)


def test_capacity_drops_overflow_tokens():
    _, params, x, _, xt = _setup(11)
    sparse = MoEMlp(E, H, F, dispatch="capacity", capacity_factor=0.25,
                    device="cpu")
    sparse.load_state_dict(moe_params_from_jax(jax.tree.map(np.asarray,
                                                            params)))
    out, _ = sparse(xt)
    out = out.detach().numpy().reshape(-1, H)
    assert np.all(np.isfinite(out))
    logits = np.asarray(x, np.float64) @ \
        np.asarray(params["router"]["kernel"], np.float64) + \
        np.asarray(params["router"]["bias"], np.float64)
    top1 = logits.reshape(-1, E).argmax(-1)
    cap = int(np.ceil(0.25 * top1.shape[0] / E))
    seen, kept = {e: 0 for e in range(E)}, []
    for ei in top1:
        kept.append(seen[ei] < cap)
        seen[ei] += 1
    kept = np.asarray(kept)
    assert 0 < kept.sum() < top1.shape[0]
    np.testing.assert_array_equal(np.abs(out).max(-1) < 1e-30, ~kept)
    # a dropped token's row is exactly zero
    assert np.all(out[~kept] == 0.0)


def test_router_kernel_stays_fp32_under_amp():
    _, _, _, port, xt = _setup(17)
    model, _ = amp.initialize(port, transforms.adam(1e-3), opt_level="O2",
                              verbosity=0)
    compute = model.compute_variables(model.init())
    assert compute["router.weight"].dtype == torch.float32
    assert compute["router.bias"].dtype == torch.float32
    assert compute["experts_in"].dtype == torch.bfloat16
    # the router reads x in fp32: a bf16 input routes as its fp32 copy
    xb = xt.to(torch.bfloat16)
    out, aux = model.apply(model.init(), xb)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    gate, top1, _ = port._route(xb)
    _, top1_f, _ = port._route(xb.float())
    assert gate.dtype == torch.float32
    assert torch.equal(top1, top1_f)


def test_router_routes_and_balances():
    _, params, x, port, xt = _setup(3)
    out, aux = port(xt)
    assert out.shape == (B, S, H)
    assert 0.9 < float(aux) < 2.5
    picks = np.asarray(jnp.argmax(x.astype(jnp.float32) @
                                  params["router"]["kernel"]
                                  + params["router"]["bias"], -1)).ravel()
    assert len(set(picks.tolist())) >= 3
    _, top1, _ = port._route(xt)
    np.testing.assert_array_equal(top1.numpy().ravel(), picks)


def test_argmax_ties_go_to_the_first_expert():
    port = MoEMlp(4, 2, 4, device="cpu", seed=0)
    with torch.no_grad():
        port.router.weight.zero_()
        port.router.bias.copy_(torch.tensor([0.0, 1.0, 1.0, 0.5]))
    _, top1, _ = port._route(torch.randn(1, 3, 2))
    assert top1.tolist() == [[1, 1, 1]]
    assert int(jnp.argmax(jnp.asarray([0.0, 1.0, 1.0, 0.5]))) == 1


def _bcfg(dispatch="dense", experts=E):
    return tb.BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=16, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0,
                         moe_experts=experts, moe_dispatch=dispatch)


def _jcfg(cfg):
    return jm.BertConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _jaux(mut):
    return sum(jnp.sum(leaf) for leaf in
               jax.tree_util.tree_leaves(mut["losses"]))


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_bert_moe_logits_and_aux_match_jax(dispatch):
    cfg = _bcfg(dispatch)
    ids = jax.random.randint(jax.random.PRNGKey(0), (4, 16), 0, 64)
    jmodel = jm.BertForPreTraining(_jcfg(cfg))
    params = jmodel.init(jax.random.PRNGKey(1), ids)["params"]
    (mlm, nsp), mut = jmodel.apply({"params": params}, ids,
                                   deterministic=True, mutable=["losses"])
    model = tb.BertForPreTraining(cfg, device="cpu", seed=None)
    model.load_state_dict(tb.params_from_jax(jax.tree.map(np.asarray,
                                                          params), cfg))
    got_mlm, got_nsp, aux = model(torch.from_numpy(np.asarray(ids)))
    assert rel_err(got_mlm, mlm) < LOGIT_TOL
    assert rel_err(got_nsp, nsp) < LOGIT_TOL
    np.testing.assert_allclose(float(aux), float(_jaux(mut)),
                               rtol=AUX_RTOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0


def test_tp_rules_match_no_moe_leaf():
    cfg = _bcfg()
    full = tb.BertForPreTraining(cfg, device="meta", seed=None)
    names = dict(full.named_parameters())
    specs = parallel.param_specs(names, parallel.Mesh({"model": 2}),
                                 parallel.bert_tp_rules(), num_heads=4)
    moe = [n for n in names if ".moe." in n]
    assert len(moe) == 2 * 6
    assert all(specs[n] == () for n in moe)
    assert tb.tp_splits(cfg, 2) == {"heads": True, "mlp": False,
                                    "vocab": True}
    # EP_RULES split the four stacked leaves, nothing else
    ep = parallel.param_specs(names, parallel.Mesh({"expert": 2}),
                              EP_RULES)
    assert {n for n, s in ep.items() if s} == {
        n for n in moe if "router" not in n}


def test_bert_moe_seeded_init():
    """``seed`` draws the dense model's weights in the JAX distributions:
    the expert kernels and the router normal, the expert biases zero."""
    model = tb.BertForPreTraining(_bcfg(), device="cpu", seed=0)
    moe = model.encoder.layer_1.moe
    assert float(moe.experts_bias_in.abs().max()) == 0.0
    assert float(moe.experts_bias_out.abs().max()) == 0.0
    assert float(moe.router.bias.abs().max()) == 0.0
    assert 0.015 < float(moe.experts_in.std()) < 0.025
    assert 0.015 < float(moe.router.weight.std()) < 0.025


# -- the example ------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_bert_main_amp",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recipe():
    return joptimizers.FusedLAMB(
        lr=1e-4, max_grad_norm=1.0,
        param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
        exclude_from_layer_adaptation=lambda path: any(
            "bias" in str(k) or "_ln" in str(k) for k in path))


def jax_example_run(cfg, batches, accum=1, mesh=None):
    """The JAX example's ``train_step`` (``accum`` 1) or its
    ``make_accum_step`` step with ``--moe``, at O0, on ``batches`` (the
    global batch each step; on ``mesh``'s data axis when given): the
    initial params, the losses, the step-1 gradients (the accumulated
    stash under ``accum``) and the final params."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    model, optimizer = jamp.initialize(jm.BertForPreTraining(cfg),
                                       _recipe(), opt_level="O0",
                                       verbosity=0)
    dp = 1 if mesh is None else mesh.devices.size
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((dp, EX_S), jnp.int32))["params"]
    init = jax.tree.map(np.asarray, params)
    opt_state = optimizer.init(params)

    def batch_loss(p, ids, labels, weights, nsp, mlm_denom, div):
        (mlm_logits, nsp_logits), mut = model.apply(
            {"params": p}, ids, deterministic=True, mutable=["losses"])
        mlm_losses = optax.softmax_cross_entropy_with_integer_labels(
            mlm_logits, labels)
        mlm_loss = jnp.sum(mlm_losses * weights) / mlm_denom
        nsp_loss = optax.softmax_cross_entropy_with_integer_labels(
            nsp_logits, nsp).mean() / div
        return mlm_loss + nsp_loss + 0.01 * _jaux(mut) / div

    @jax.jit
    def plain_step(params, opt_state, ids, labels, weights, nsp):
        def loss_fn(p):
            loss = batch_loss(p, ids, labels, weights, nsp,
                              jnp.maximum(jnp.sum(weights), 1.0), 1.0)
            with jamp.scale_loss(loss, opt_state) as scaled:
                return scaled, loss
        (_, loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads

    @jax.jit
    def accum_step(params, opt_state, ids, labels, weights, nsp):
        mb = lambda a: jnp.stack([a[j::accum] for j in range(accum)])
        ids_m, labels_m, weights_m, nsp_m = (mb(a) for a in
                                             (ids, labels, weights, nsp))
        denom = jnp.maximum(jnp.sum(weights), 1.0)
        stashed, overflow, st, total = None, jnp.asarray(False), \
            opt_state, 0.0
        for j in range(accum):
            def loss_fn(p):
                loss = batch_loss(p, ids_m[j], labels_m[j], weights_m[j],
                                  nsp_m[j], denom, float(accum))
                with jamp.scale_loss(loss, st) as scaled:
                    return scaled, loss
            (_, loss_j), grads = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(params)
            grads, ovf, st = optimizer.unscale_grads(
                grads, st, 0, stashed=stashed, update_scale=False)
            stashed, overflow = grads, overflow | ovf
            total = total + loss_j
        st = optimizer.update_scale(st, overflow, 0)
        params2, st = optimizer.apply_gradients(params, stashed, st,
                                                overflow)
        return params2, st, total, stashed

    step = plain_step if accum == 1 else accum_step
    losses, grads1 = [], None
    for host in batches:
        batch = [jnp.asarray(a) for a in host]
        if mesh is not None:
            batch = [jax.device_put(a, NamedSharding(mesh, P("data")))
                     for a in batch]
        params, opt_state, loss, grads = step(params, opt_state, *batch)
        losses.append(float(loss))
        if grads1 is None:
            grads1 = jax.tree.map(np.asarray, grads)
    return init, losses, grads1, jax.tree.map(np.asarray, params)


def example_cfg(dispatch="dense", remat=False):
    return dataclasses.replace(bert_main_amp.get_config("tiny"),
                               moe_experts=EX_E, moe_dispatch=dispatch,
                               remat=remat)


def example_batches(rows, steps=EX_STEPS):
    data = bert_main_amp.batches(bert_main_amp.get_config("tiny"), rows,
                                 EX_S)
    return [next(data) for _ in range(steps)]


def port_example_run(cfg, batches, init, accum=1):
    model, opt, params, st = bert_main_amp.build(
        cfg, opt_level="O0", device="cpu",
        state_dict=tb.params_from_jax(init, cfg))
    losses, grads1 = [], None
    for host in batches:
        batch = tuple(torch.from_numpy(a) for a in host)
        params, st, loss, grads = bert_main_amp.train_step(
            model, opt, params, st, batch, grad_accum=accum)
        losses.append(float(loss))
        grads1 = grads if grads1 is None else grads1
    return losses, grads1, params


@pytest.mark.parametrize("case", ["plain", "grad_accum", "remat",
                                  "capacity"])
def test_example_moe_steps_match_jax(case):
    cfg = example_cfg("capacity" if case == "capacity" else "dense",
                      remat=case == "remat")
    accum = 2 if case == "grad_accum" else 1
    batches = example_batches(EX_B)
    init, want, want_g, want_params = jax_example_run(_jcfg(cfg), batches,
                                                      accum)
    got, grads, params = port_example_run(cfg, batches, init, accum)
    for a, b in zip(got, want):
        assert abs(a - b) / abs(b) < LOSS_TOL, (got, want)
    flat = tb.params_from_jax(want_g, cfg)
    for k, g in grads.items():
        assert rel_err(g, flat[k]) < GRAD_TOL, k
    assert float(grads["encoder.layer_0.moe.router.weight"].abs().max()) > 0
    flat = tb.params_from_jax(want_params, cfg)
    for k, v in params.items():
        assert rel_err(v, flat[k]) < 1e-5, k


def test_example_train_runs_moe():
    """``train()`` with an MoE config: finite losses, the experts'
    stacked layout kept."""
    out = bert_main_amp.train(example_cfg(), batch=EX_B, seq_len=EX_S,
                              steps=2, opt_level="O0", device="cpu")
    assert all(math.isfinite(v) for v in out["losses"])
    assert out["params"]["encoder.layer_0.moe.experts_in"].shape == \
        (EX_E, 128, 256)


def test_cli_takes_the_moe_flags():
    args = bert_main_amp.parse_args(["--config", "tiny", "--moe", "8",
                                     "--moe-dispatch", "capacity",
                                     "--moe-capacity-factor", "2.0"])
    assert (args.moe, args.moe_dispatch, args.moe_capacity_factor) == \
        (8, "capacity", 2.0)
    assert bert_main_amp.parse_args([]).moe_dispatch == "dense"
    with pytest.raises(SystemExit):
        bert_main_amp.parse_args(["--moe-dispatch", "topk"])


# -- the refusals -----------------------------------------------------------

def test_bad_dispatch_refused():
    with pytest.raises(ValueError, match="MoEMlp dispatch must be 'dense' "
                       "or 'capacity', got 'sparse'"):
        MoEMlp(E, H, F, dispatch="sparse", device="cpu")
    jmoe = jm.MoEMlp(num_experts=E, hidden_size=H, intermediate_size=F,
                     dispatch="sparse")
    with pytest.raises(ValueError, match="got 'sparse'"):
        jmoe.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, H)))


def _pipelined(seq_axis=None, attention_fn=None):
    mesh = parallel.Mesh({"data": 1, "sp": 1, "pipe": 1, "model": 1})
    return tb.PipelinedBert(_bcfg(experts=4), mesh, 1, 2,
                            seq_axis=seq_axis, attention_fn=attention_fn,
                            device="cpu", seed=0)


def _mb_loss(mlm, nsp, tgt):
    return torch.nn.functional.cross_entropy(
        mlm.reshape(-1, mlm.shape[-1]), tgt["mlm"].reshape(-1).long())


def test_onef1b_refuses_seq_axis_with_moe():
    ulysses = parallel.make_ulysses_attention(None)
    model = _pipelined("sp", ulysses)
    ids = torch.zeros((2, 16), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="seq_axis \\+ MoE under "
                       "1F1B: the sp-local aux estimate breaks the loss/grad "
                       "reduction algebra; use the GPipe apply\\(\\) path"):
        model.loss_and_grad_1f1b(ids, _mb_loss, {"mlm": ids},
                                 moe_aux_weight=0.01)


def test_onef1b_warns_on_zero_aux_weight():
    model = _pipelined()
    ids = torch.zeros((2, 16), dtype=torch.int64)
    with pytest.warns(UserWarning, match="moe_aux_weight=0: the "
                      "load-balance aux term is dropped"):
        model.loss_and_grad_1f1b(ids, _mb_loss, {"mlm": ids})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loss, grads = model.loss_and_grad_1f1b(ids, _mb_loss, {"mlm": ids},
                                               moe_aux_weight=0.01)
    assert float(grads["stages.layer_0.moe.router.weight"].abs().max()) > 0


def test_pipelined_world_of_one_equals_the_dense_model():
    """At pp 1 the pipelined MoE model is the dense one: (mlm, nsp, aux)
    bit for bit in fp32 order, and 1F1B's loss with the aux term equal
    to the dense model's."""
    model = _pipelined()
    dense = tb.BertForPreTraining(_bcfg(experts=4), device="cpu", seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, (4, 16)))
    with torch.no_grad():
        mlm, nsp, aux = model(ids)
        dmlm, dnsp, daux = dense(ids)
    assert rel_err(mlm, dmlm.numpy()) < LOGIT_TOL
    # M 2: the mean of the two microbatches' estimates, near the whole
    # batch's (the reference's rtol 0.2)
    np.testing.assert_allclose(float(aux), float(daux), rtol=0.2)
    loss, _ = model.loss_and_grad_1f1b(ids, _mb_loss, {"mlm": ids},
                                       moe_aux_weight=0.5)
    want = []
    with torch.no_grad():
        for j in range(2):
            rows = ids[j * 2:(j + 1) * 2]
            dmlm, dnsp, daux = dense(rows)
            want.append(float(_mb_loss(dmlm, dnsp, {"mlm": rows})
                              + 0.5 * daux))
    np.testing.assert_allclose(float(loss), np.mean(want), rtol=1e-6)


# -- FusedLAMB's memory ------------------------------------------------------

class _LiveBytes:
    """The peak bytes of the new tensors that the ops run inside the mode
    make and keep alive (a tensor counts until its Python object dies;
    an op's output that shares an input's storage is no new tensor)."""

    def __init__(self):
        import weakref
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils import _pytree as pytree
        outer = self
        self.live = self.peak = 0

        def free(n):
            outer.live -= n

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ins = {t.untyped_storage().data_ptr() for t in
                       pytree.tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)}
                for t in pytree.tree_leaves(out):
                    if not isinstance(t, torch.Tensor):
                        continue
                    n = t.untyped_storage().nbytes()
                    if n and t.untyped_storage().data_ptr() not in ins:
                        outer.live += n
                        outer.peak = max(outer.peak, outer.live)
                        weakref.finalize(t, free, n)
                return out

        self.mode = Mode()


def test_fused_lamb_step_holds_few_parameter_copies(monkeypatch):
    """One amp-style FusedLAMB step (the skip select on) allocates at
    most 3.6 parameter-sized copies at once beyond its inputs (the new m,
    v and params, and one group of leaves' temporaries): BERT-large with
    8 experts a layer (1.78B parameters, masters, gradients and moments
    of 28 GB) then steps on an 80 GB card, where the chain's out-of-place
    form over every leaf held eight."""
    from apex_tpu_torch.optimizers import FusedLAMB, fused_lamb
    monkeypatch.setattr(fused_lamb, "CHUNK_ELEMENTS", 64 * 64,
                        raising=False)
    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 64)] * 8 + [(64,)]
    params = {f"p{i}": torch.randn(s, generator=gen)
              for i, s in enumerate(shapes)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    nbytes = sum(v.numel() * 4 for v in params.values())
    lamb = FusedLAMB(lr=1e-3, max_grad_norm=1.0,
                     param_groups=[{"match": r"p8", "weight_decay": 0.0}])
    state = lamb.init(params)
    want, want_state = lamb.step(params, grads, state,
                                 skip=torch.tensor(False))
    probe = _LiveBytes()
    with probe.mode:
        got, got_state = lamb.step(params, grads, state,
                                   skip=torch.tensor(False))
    assert probe.peak <= 3.6 * nbytes, probe.peak / nbytes
    for k in params:
        assert torch.equal(got[k], want[k])
        assert torch.equal(got_state.m[k], want_state.m[k])
        assert torch.equal(got_state.v[k], want_state.v[k])
