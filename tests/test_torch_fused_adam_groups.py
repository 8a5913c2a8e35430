"""The rest of FusedAdam in apex_tpu_torch against apex_tpu's.

``flatten_grouped``, the param-group helpers and FusedAdam's
``max_grad_norm``, grouped flat layout, tree layout, ``update``,
``add_param_group``, ``output_params_dtype`` and skip step, each on the
same numpy-seeded params and grads as the JAX package's FusedAdam on
its ``jnp`` path (``use_pallas=False``, as
``tests/L0/test_fused_adam.py``'s tree-layout tests run it).  Mirrors
``tests/L0/test_fused_adam.py::test_tree_layout_*`` and
``tests/L0/test_param_groups.py``.

The dicts hold their keys sorted, the order flax's trees flatten in, so
both packages lay the flat buffers out alike, and the group regexes
match the same leaves in the port's names (``u``) and in the JAX
package's key strings (``['u']``).  Tolerances: fp32 within
1e-6 scale-aware (max |a - b| / (max |b| + 1)) (``pow`` in the bias correction and the norms' sums round
apart between XLA and PyTorch by an ulp); the port's tree and flat
layouts bit for bit (same arithmetic, element by element), and every
skipped step bit for bit.  On the CPU every launch is the plain version:
no kernel runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import models as jax_models
from apex_tpu.ops.flatten import flatten_grouped as jax_flatten_grouped
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.optimizers import param_groups as jpg
from apex_tpu_torch._kernels import launch_counts
from apex_tpu_torch.models import GPTConfig, params_from_jax
from apex_tpu_torch.ops import flatten_grouped, flatten_like, unflatten
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers import param_groups as pg
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.optimizers.fused_adam import _chunk_table, \
    _segment_rows

torch.set_num_threads(1)

TOL = 1e-6
GROUPS = [{"match": r"bias", "weight_decay": 0.0, "lr": 1e-3},
          {"match": r"u", "max_grad_norm": 0.5}]


def rel_err(got, want):
    """Scale-aware: max |got - want| / (max |want| + 1)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    shapes = {"bias": (37,), "s": (), "u": (5, 3), "w": (13, 11)}
    return {k: np.asarray(scale * rng.randn(*s), np.float32)
            for k, s in sorted(shapes.items())}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _run(layout, groups=None, max_grad_norm=0.0, steps=3, scale=2.0,
         skip_at=None, grad_norm=None):
    """Three steps of both packages from the same params and grads;
    returns (port params, port state, JAX params, JAX state)."""
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=max_grad_norm,
              param_groups=groups, layout=layout)
    jopt, opt = JaxFusedAdam(use_pallas=False, **kw), FusedAdam(**kw)
    jp, pp = _both(_tree(0))
    jst, st = jopt.init(jp), opt.init(pp)
    for i in range(steps):
        grads = _tree(10 + i, scale=3.0)
        if i == skip_at:
            grads["w"][0, 0] = np.inf
        jg, tg = _both(grads)
        skip = None if skip_at is None else (i == skip_at)
        jp, jst = jopt.step(jp, jg, jst, scale=scale, skip=skip,
                            grad_norm=grad_norm)
        pp, st = opt.step(pp, tg, st, scale=scale, skip=skip,
                          grad_norm=grad_norm)
    return pp, st, jp, jst


def _close(pp, jp, tol=TOL):
    for k in jp:
        assert tuple(pp[k].shape) == tuple(jp[k].shape), k
        assert rel_err(pp[k].detach().numpy(), jp[k]) <= tol, k


# -- flatten_grouped and the param-group helpers --------------------------

@pytest.mark.parametrize("pad_to", [1, 128])
def test_flatten_grouped_spec_equals_jax(pad_to):
    tree = _tree(1)
    ids = (2, 0, 2, 0)   # bias, s, u, w: group 1 empty
    jflat, jspec = jax_flatten_grouped({k: jnp.asarray(v)
                                        for k, v in tree.items()}, ids,
                                       pad_to=pad_to)
    tt = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    flat, spec = flatten_grouped(tt, ids, pad_to=pad_to)
    assert spec.offsets == jspec.offsets and spec.total == jspec.total
    assert spec.perm == jspec.perm
    assert spec.group_bounds == jspec.group_bounds
    assert spec.shapes == jspec.shapes
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    # flatten_like honours the layout, unflatten inverts it with views
    np.testing.assert_array_equal(flatten_like(tt, spec, pad_to=pad_to),
                                  flat)
    back = unflatten(flat, spec)
    for k in tt:
        assert torch.equal(back[k], tt[k])
        assert back[k].data_ptr() == flat.data_ptr() + 4 * spec.offsets[
            list(tt).index(k)]


@pytest.fixture(scope="module")
def gpt_trees():
    """A tiny GPT's JAX param tree with each leaf tagged by its index,
    and the port's state dict of the same tags."""
    cfg = jax_models.GPTConfig(vocab_size=97, hidden_size=32,
                               num_hidden_layers=2, num_attention_heads=2,
                               intermediate_size=64,
                               max_position_embeddings=16)
    params = jax.eval_shape(jax_models.GPTLMHeadModel(cfg).init,
                            jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32))["params"]
    flat, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32)
                  for i, x in enumerate(flat)])
    port = params_from_jax(tagged, GPTConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=16))
    return tagged, port


SPECS = [{"match": r"(bias|_ln)", "weight_decay": 0.0},
         {"match": r"wte", "lr": 1e-4}]


def test_group_ids_labels_masks_match_jax_on_gpt(gpt_trees):
    tagged, port = gpt_trees
    jids = jpg.resolve_group_ids(tagged, SPECS)
    ids = pg.resolve_group_ids(port, SPECS)
    tag = [int(t.reshape(-1)[0]) for t in port.values()]
    assert sorted(tag) == list(range(len(jids)))
    assert [jids[t] for t in tag] == list(ids)
    assert pg.leaf_paths(port) == tuple(port)
    labels = pg.labels(port, SPECS)
    assert [labels[n] for n in port] == [f"group{i}" for i in ids]
    masks = pg.masks(port, SPECS)
    jmasks = jpg.masks(tagged, SPECS)
    assert len(masks) == len(jmasks) == 3
    for g, (mask, jmask) in enumerate(zip(masks, jmasks)):
        jflat = jax.tree_util.tree_leaves(jmask)
        assert [mask[n] for n in port] == [jflat[t] for t in tag]
        assert sum(mask.values()) == sum(i == g for i in ids)
    want = jpg.group_hparams({"lr": 1.0, "weight_decay": 0.1}, SPECS)
    assert pg.group_hparams({"lr": 1.0, "weight_decay": 0.1}, SPECS) == want


def test_multi_transform_matches_optax():
    tree = _tree(2)
    specs = [{"match": r"bias", "learning_rate": 0.0},
             {"match": r"w", "learning_rate": 0.3}]
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    jopt = jpg.multi_transform(optax.adam, {"learning_rate": 0.1}, specs, jt)
    opt = pg.multi_transform(transforms.adam, {"learning_rate": 0.1}, specs,
                             {k: torch.from_numpy(v.copy())
                              for k, v in tree.items()})
    jst = jopt.init(jt)
    st = opt.init({k: torch.from_numpy(v.copy()) for k, v in tree.items()})
    for i in range(2):
        grads = _tree(20 + i)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                              jst, jt)
        u, st = opt.update({k: torch.from_numpy(v) for k, v in grads.items()},
                           st)
        _close(u, ju)
    assert float(torch.abs(u["bias"]).max()) == 0.0


def test_adam_multi_refuses_what_the_kernel_does_not_take():
    from apex_tpu_torch.optimizers.fused_adam import adam_multi
    p = torch.zeros(8)
    scalars = torch.ones(1, 7)
    with pytest.raises(ValueError, match="no scalars"):
        adam_multi([(p, p, p, p, 1)], scalars, False)
    with pytest.raises(ValueError, match="one length"):
        adam_multi([(p, p, p, p[:4], 0)], scalars, False)
    with pytest.raises(ValueError, match="contiguous"):
        adam_multi([(p[::2],) * 4 + (0,)], scalars, False)
    with pytest.raises(ValueError, match="float32"):
        adam_multi([(p.double(),) * 4 + (0,)], scalars, False)


def test_validate_specs_refuses_unknown_keys():
    with pytest.raises(ValueError, match="unsupported keys"):
        FusedAdam(param_groups=[{"match": "b", "weight_deacy": 0.0}])
    with pytest.raises(ValueError, match="layout"):
        FusedAdam(layout="rows")


# -- FusedAdam: max_grad_norm, groups, layouts ---------------------------

@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("groups", [None, GROUPS])
@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0])
def test_three_steps_match_jax(layout, groups, max_grad_norm):
    before = launch_counts()
    pp, st, jp, jst = _run(layout, groups, max_grad_norm)
    assert launch_counts() == before, "the CPU path launched a kernel"
    _close(pp, jp)
    assert int(st.step) == int(jst.step) == 3
    if layout == "tree":
        assert set(st.m) == set(jp) and st.p is None


def test_max_grad_norm_clips_as_a_scale():
    """Clipping folds into the combined scale: a step at max_grad_norm M
    on grads of norm N > M equals a step at scale N / M, no clipping
    (``test_fused_adam.py::test_max_grad_norm_clips``)."""
    for layout in ("flat", "tree"):
        outs = []
        for kw, scale in ((dict(max_grad_norm=1.0), 1.0), ({}, 200.0)):
            opt = FusedAdam(lr=0.1, bias_correction=False, layout=layout,
                            **kw)
            p = {"w": torch.ones(4)}
            st = opt.init(p)
            p, _ = opt.step(p, {"w": torch.full((4,), 100.0)}, st,
                            scale=scale)
            outs.append(p["w"].detach())
        assert rel_err(outs[0], outs[1]) <= TOL


@pytest.mark.parametrize("groups", [None, GROUPS])
def test_tree_layout_equals_flat_bit_for_bit(groups):
    """Without a norm the two layouts compute the same thing element by
    element; with ``max_grad_norm`` a group's norm is one sum over its
    slice in one and the sum of per-leaf sums in the other, 1e-6."""
    flat = _run("flat", groups)[0]
    tree = _run("tree", groups)[0]
    for k in flat:
        assert torch.equal(flat[k], tree[k]), k
    flat = _run("flat", groups, 1.0)[0]
    tree = _run("tree", groups, 1.0)[0]
    for k in flat:
        assert rel_err(tree[k].detach(), flat[k].detach()) <= TOL, k


def test_given_grad_norm_matches_jax():
    pp, _, jp, _ = _run("flat", GROUPS, 1.0, grad_norm=7.5)
    _close(pp, jp)
    tp, _, _, _ = _run("tree", GROUPS, 1.0, grad_norm=7.5)
    for k in pp:
        assert torch.equal(pp[k], tp[k]), k


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("groups", [None, GROUPS])
def test_skip_step_keeps_every_bit(layout, groups):
    """Step 1 (an inf in the grads) skipped: the params, the moments
    and the clock keep their bits in both packages, and the run goes on
    to equal the JAX one."""
    pp, st, jp, jst = _run(layout, groups, 1.0, steps=2, skip_at=1)
    ref, rst, _, _ = _run(layout, groups, 1.0, steps=1)
    for k in pp:
        assert torch.equal(pp[k], ref[k]), k
    if layout == "tree":
        for k in pp:
            assert torch.equal(st.m[k], rst.m[k])
            assert torch.equal(st.v[k], rst.v[k])
    else:
        assert torch.equal(st.m, rst.m) and torch.equal(st.v, rst.v)
    assert int(st.step) == int(jst.step) == 1
    _close(pp, jp)


def test_tree_layout_under_amp_optimizer():
    """``test_fused_adam.py::test_tree_layout_skip_step``'s second half:
    ``AmpOptimizer`` hands the tree layout its overflow flag; a clean
    step moves the params (the masters, updated in place) as the JAX
    one does, an inf skips the step and halves the scale."""
    from apex_tpu.amp.optimizer import AmpOptimizer as JaxAmpOptimizer
    from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
    from apex_tpu_torch import amp

    jp, pp = _both(_tree(0))
    jopt = JaxAmpOptimizer(JaxFusedAdam(lr=1e-2, layout="tree",
                                        use_pallas=False),
                           JaxLossScaler(init_scale=4.0))
    opt = amp.AmpOptimizer(FusedAdam(lr=1e-2, layout="tree"),
                           amp.LossScaler(init_scale=4.0))
    jst, st = jopt.init(jp), opt.init(pp)
    jg, tg = _both(_tree(9, scale=4.0))
    jp, jst = jopt.step(jp, jg, jst)
    masters = {k: v.data_ptr() for k, v in pp.items()}
    pp, st = opt.step(pp, tg, st)
    assert {k: v.data_ptr() for k, v in pp.items()} == masters
    _close(pp, jp)
    bad = dict(tg, w=torch.full_like(tg["w"], float("inf")))
    snap = {k: v.clone() for k, v in pp.items()}
    pp, st = opt.step(pp, bad, st)
    for k in pp:
        assert torch.equal(pp[k], snap[k])
    assert int(st.skipped_steps) == 1 and int(st.applied_steps) == 1
    assert float(opt.loss_scale(st)) == 2.0


def test_state_with_groups_on_an_optimizer_without():
    """The "state has groups, optimizer has none" rule: every group takes
    the defaults, as in the JAX package."""
    jgrouped = JaxFusedAdam(lr=1e-2, use_pallas=False, param_groups=GROUPS)
    grouped = FusedAdam(lr=1e-2, param_groups=GROUPS)
    jp, pp = _both(_tree(0))
    jst, st = jgrouped.init(jp), grouped.init(pp)
    jg, tg = _both(_tree(5))
    jp, _ = JaxFusedAdam(lr=1e-2, use_pallas=False).step(jp, jg, jst)
    pp, st = FusedAdam(lr=1e-2).step(pp, tg, st)
    _close(pp, jp)
    with pytest.raises(ValueError, match="groups"):
        FusedAdam(param_groups=GROUPS[:1]).step(pp, tg, st)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_add_param_group_keeps_moments(layout):
    """``test_param_groups.py::TestAddParamGroup`` and
    ``test_fused_adam.py::test_tree_layout_add_param_group``: a new group
    mid-training with a new leaf; every old leaf keeps m and v, the new
    one starts at zero, and the next step equals the JAX one."""
    kw = dict(lr=1e-2, layout=layout)
    jopt, opt = JaxFusedAdam(use_pallas=False, **kw), FusedAdam(**kw)
    jp, pp = _both(_tree(0))
    jst, st = jopt.init(jp), opt.init(pp)
    jg, tg = _both(_tree(3))
    jp, jst = jopt.step(jp, jg, jst)
    pp, st = opt.step(pp, tg, st)
    old_m = {k: v.clone() for k, v in (
        st.m.items() if layout == "tree" else
        unflatten(st.m, st.spec, cast_back=False).items())}
    extra = np.zeros((5, 5), np.float32)
    jbig = dict(jp, x_extra=jnp.asarray(extra))
    pbig = dict({k: v.detach() for k, v in pp.items()},
                x_extra=torch.from_numpy(extra.copy()))
    jopt2, jst2 = jopt.add_param_group(jst, jbig, match=r"extra|u",
                                       lr=1e-4)
    opt2, st2 = opt.add_param_group(st, pbig, match=r"extra|u", lr=1e-4)
    new_m = st2.m if layout == "tree" else unflatten(st2.m, st2.spec,
                                                     cast_back=False)
    for k in old_m:
        assert torch.equal(new_m[k], old_m[k]), k
    assert torch.equal(new_m["x_extra"], torch.zeros(5, 5))
    assert int(st2.step) == 1
    grads = dict(_tree(4), x_extra=np.ones((5, 5), np.float32))
    jg2, tg2 = _both(grads)
    jp2, _ = jopt2.step(jbig, jg2, jst2)
    pp2, _ = opt2.step(pbig, tg2, st2)
    _close(pp2, jp2)
    assert float(pp2["x_extra"].detach().abs().max()) > 0


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_update_and_output_params_dtype(layout):
    """optax-style ``update``: the same updates as the JAX package's, the
    caller's params untouched; ``output_params_dtype`` casts the
    returned params."""
    kw = dict(lr=1e-2, weight_decay=0.01, param_groups=GROUPS, layout=layout)
    jopt, opt = JaxFusedAdam(use_pallas=False, **kw), FusedAdam(**kw)
    jp, pp = _both(_tree(0))
    jst, st = jopt.init(jp), opt.init(pp)
    jg, tg = _both(_tree(6))
    snap = {k: v.clone() for k, v in pp.items()}
    ju, _ = jopt.update(jg, jst, jp, scale=2.0)
    u, st = opt.update(tg, st, pp, scale=2.0)
    for k in pp:
        assert torch.equal(pp[k], snap[k])
    _close(u, ju)
    # update's params + updates, and step from the same state
    st = opt.init(pp)
    u, _ = opt.update(tg, st, pp)
    st = opt.init(pp)
    stepped, _ = opt.step({k: v.clone() for k, v in pp.items()}, tg, st)
    for k in pp:
        assert torch.equal(u[k], stepped[k] - snap[k]), k
    st = opt.init(pp)
    half, _ = opt.step(pp, tg, st, output_params_dtype=torch.bfloat16)
    jst = jopt.init(jp)
    jhalf, _ = jopt.step(jp, jg, jst, output_params_dtype=jnp.bfloat16)
    for k in pp:
        assert half[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(half[k].float().numpy(),
                                      np.asarray(jhalf[k], np.float32))


def test_chunk_table_cuts_segments():
    """The multi-tensor kernel's table: pieces of at most ``_CHUNK``
    elements, pointers advanced by 4 bytes an element, empty segments
    dropped."""
    from apex_tpu_torch.optimizers import fused_adam
    big = torch.zeros(2 * fused_adam._CHUNK + 5)
    small = torch.zeros(7)
    empty = torch.zeros(0)
    table = _chunk_table(_segment_rows(
        [(big, big, big, big, 2), (empty,) * 4 + (0,),
         (small, small, small, small, 1)], -1))
    assert table.shape == (4, 6)
    assert list(table[:, 4]) == [fused_adam._CHUNK, fused_adam._CHUNK, 5, 7]
    assert list(table[:, 5]) == [2, 2, 2, 1]
    base = big.data_ptr()
    assert list(table[:3, 0]) == [base, base + 4 * fused_adam._CHUNK,
                                  base + 8 * fused_adam._CHUNK]
    assert table[3, 3] == small.data_ptr()
