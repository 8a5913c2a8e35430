"""ZeRO-1 and ZeRO-2 in apex_tpu_torch, against the port's replicated
step bit for bit and against apex_tpu's ``zero2_update``.

Two gloo ranks, spawned once for the module (a ``FileStore`` under the
test's temporary directory; the rank function imports no JAX), each
with half of a 16-row batch of a 784 -> 32 -> 32 -> 10 MLP:

- ZeRO-1, ``FusedAdam.with_zero`` with ``shard_optimizer_state``: flat,
  and grouped (bias without weight decay, ``max_grad_norm`` 0.5), 3
  steps after DDP's all-reduce: params bit for bit the replicated
  step's, each rank's m and v its half of the replicated buffers;
- ZeRO-2, ``zero2_update`` on the local gradients: bit for bit DDP plus
  ``FusedAdam.step`` (a reduced element is one sum of two addends);
- ``max_grad_norm`` 0.5 on the flat layout: ZeRO-1 bit for bit the
  replicated step; ZeRO-2, whose norm sums its shards' squares over the
  ranks (another order of the same sum), within 1e-6 scale-aware of it,
  and the clip taken (the params differ from the unclipped run's);
- ZeRO-2 under amp (``AmpOptimizer.zero2_step``, O2) with an inf in rank
  1's data only: both ranks skip, params, m and v keep every bit, the
  scale halves;
- ``unshard_optimizer_state`` gives back the state
  ``shard_optimizer_state`` cut, flat and per leaf; a checkpoint of the
  unsharded state restores and shards to the same bits;
- the JAX MLP's weights: 3 steps of ``zero2_update`` within 2e-5
  (scale-aware) of the JAX package's ``zero2_update`` on a 2-device mesh;
- the per-leaf shard dims: a conv and a dense moment shard on the dim
  the JAX ``shard_optimizer_state`` picks, a bias stays replicated;
- the entry points at a world of two: ``entry.dryrun(2)`` (its ZeRO-1
  and ZeRO-2 legs raise unless bit for bit), ``ddp_simple --zero2``,
  and ``imagenet_main_amp --zero`` (bit for bit the run without, and a
  run resumed from its own checkpoint bit for bit the run straight
  through).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, entry, models, parallel
from apex_tpu_torch.examples import ddp_simple
from apex_tpu_torch.examples import imagenet_main_amp as im
from apex_tpu_torch.optimizers import FusedAdam, transforms
from apex_tpu_torch.parallel import zero
from apex_tpu_torch.parallel.mesh import WORLD as GROUP
from apex_tpu_torch.utils import checkpoint

WORLD, ROWS, STEPS, LR = 2, 16, 3, 1e-2
JAX_TOL = 2e-5
CLIP_TOL = 1e-6              # ZeRO-2's norm: the same sum in another order
GROUPS = [{"match": "bias", "weight_decay": 0.0}]
CONV = (3, 3, 3, 128)        # the JAX test's conv moment (HWIO)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(STEPS, ROWS, 784).astype(np.float32)
    y = rng.randint(0, 10, (STEPS, ROWS)).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(y)


def _half(t, rank):
    n = t.shape[0] // WORLD
    return t[rank * n:(rank + 1) * n]


def _mlp(sd=None):
    m = models.MLP(features=(32, 32), device="cpu", seed=None if sd else 0)
    if sd is not None:
        m.load_state_dict(sd)
    return m


def _grads(module, params, x, y):
    logits = torch.func.functional_call(module, params, (x,))
    loss = transforms.softmax_cross_entropy_with_integer_labels(
        logits, y).mean()
    return dict(zip(params, torch.autograd.grad(loss,
                                                list(params.values()))))


def _clone(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


def _same(a, b):
    """Two trees equal leaf for leaf, tensors bit for bit."""
    la, lb = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _leaves(module):
    """The module's parameters as fresh leaves that take gradients."""
    return {k: v.detach().clone().requires_grad_()
            for k, v in module.named_parameters()}


def _fused_runs(rank, opt_kw):
    """Replicated (DDP + step), ZeRO-1 and, flat only, ZeRO-2: params and
    moments after each run."""
    x, y = _data()
    module = _mlp()
    ddp = parallel.DistributedDataParallel()
    out = {}
    legs = ("ddp", "zero1") + (("zero2",) if "param_groups" not in opt_kw
                               else ())
    for leg in legs:
        opt = FusedAdam(lr=LR, **opt_kw)
        params = _leaves(module)
        state = opt.init(params)
        if leg != "ddp":
            state = parallel.shard_optimizer_state(state, GROUP)
        if leg == "zero1":
            opt = opt.with_zero(GROUP)
        for s in range(STEPS):
            g = _grads(module, params, _half(x[s], rank), _half(y[s], rank))
            if leg == "zero2":
                params, state = parallel.zero2_update(opt, params, g, state,
                                                      GROUP)
            else:
                params, state = opt.step(params, ddp.reduce_gradients(g),
                                         state)
        out[leg] = {"params": _clone(params), "m": state.m.clone(),
                    "v": state.v.clone()}
    return out


def _skip(rank):
    """ZeRO-2 under amp O2: a clean step, then an inf in rank 1's data."""
    x, y = _data()
    model, opt = amp.initialize(_mlp(), FusedAdam(lr=LR), opt_level="O2",
                                verbosity=0)
    params = model.init()
    state = opt.init(params)
    state = parallel.shard_optimizer_state(state, GROUP)
    out = {}
    for s in range(2):
        xs = _half(x[s], rank).clone()
        if s == 1 and rank == 1:
            xs[0, 0] = float("inf")
        logits = model.apply(params, xs).float()
        loss = transforms.softmax_cross_entropy_with_integer_labels(
            logits, _half(y[s], rank)).mean()
        with amp.scale_loss(loss, state) as scaled:
            g = torch.autograd.grad(scaled, list(params.values()))
        before = (_clone(params), state.inner.m.clone(),
                  state.inner.v.clone(), float(opt.loss_scale(state)))
        params, state = opt.zero2_step(params, dict(zip(params, g)), state,
                                       GROUP)
        out[s] = {"kept": all(torch.equal(before[0][k], params[k])
                              for k in params)
                  and torch.equal(before[1], state.inner.m)
                  and torch.equal(before[2], state.inner.v),
                  "scale0": before[3], "scale": float(opt.loss_scale(state)),
                  "skipped": int(state.skipped_steps),
                  "step": int(state.inner.step)}
    return out


def _round_trips(rank, tmpdir):
    module = _mlp()
    params = _clone(dict(module.named_parameters()))
    params["conv"] = torch.randn(CONV, generator=torch.Generator()
                                 .manual_seed(1))
    adam = FusedAdam(lr=LR)
    full = adam.init({k: v for k, v in params.items() if k != "conv"})
    full.m.normal_(generator=torch.Generator().manual_seed(2))
    sgd = transforms.sgd(0.1, momentum=0.9)
    tree = sgd.init(params)
    for leaf in tree[0].trace.values():
        leaf.normal_(generator=torch.Generator().manual_seed(3))
    out = {}
    for name, st in (("flat", full), ("tree", tree)):
        sharded = parallel.shard_optimizer_state(st, GROUP)
        back = parallel.unshard_optimizer_state(sharded, GROUP, st)
        out[name] = _same(back, st)
    out["shapes"] = {k: tuple(v.shape) for k, v in parallel
                     .shard_optimizer_state(tree, GROUP)[0].trace.items()}
    # a checkpoint holds the unsharded state and shards back to the bits
    sharded = parallel.shard_optimizer_state(tree, GROUP)
    whole = parallel.unshard_optimizer_state(sharded, GROUP, tree)
    if rank == 0:
        checkpoint.save(f"{tmpdir}/ckpt", {"opt_state": whole})
    dist.barrier()
    restored = checkpoint.restore(f"{tmpdir}/ckpt", {"opt_state": tree})
    again = parallel.shard_optimizer_state(restored["opt_state"], GROUP)
    out["checkpoint"] = _same(again, sharded)
    return out


def _jax_trajectory(rank, sd):
    x, y = _data()
    module = _mlp(sd)
    opt = FusedAdam(lr=LR)
    params = _leaves(module)
    state = parallel.shard_optimizer_state(opt.init(params), GROUP)
    for s in range(STEPS):
        g = _grads(module, params, _half(x[s], rank), _half(y[s], rank))
        params, state = parallel.zero2_update(opt, params, g, state, GROUP)
    return _clone(params)


def _tiny_resnet():
    return models.ResNet([1, 1], models.BasicBlock, num_classes=10, width=8,
                         norm=parallel.SyncBatchNorm, device="cpu")


IM_ARGV = ["--b", "2", "--image-size", "32", "--num-classes", "10",
           "--sync_bn", "--print-freq", "0", "--steps-per-epoch", "2",
           "--val-steps", "1", "--warmup-epochs", "1"]


def _imagenet(rank, tmpdir):
    args = im.parse_args(IM_ARGV)
    data = [b for _, b in zip(range(4), im.synthetic_batches(args, 2,
                                                             seed=rank))]

    def run(batches, *extra, steps=None):
        out = im.train(im.parse_args(IM_ARGV + list(extra)), device="cpu",
                       steps=steps, module=_tiny_resnet(), batches=batches)
        return _clone(out["params"])

    plain = run(data[:3], steps=3)
    zeroed = run(data[:3], "--zero", steps=3)
    straight = run(data, "--zero", "--epochs", "2", "--checkpoint-dir",
                   f"{tmpdir}/a")
    run(data[:2], "--zero", "--epochs", "1", "--checkpoint-dir",
        f"{tmpdir}/b")
    resumed = run(data[2:], "--zero", "--epochs", "2", "--resume",
                  f"{tmpdir}/b/last")

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)

    return {"zero_is_plain": same(plain, zeroed),
            "resume_is_straight": same(straight, resumed),
            "moved": not same(straight, _clone(dict(
                _tiny_resnet().named_parameters())))}


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        out = {"flat": _fused_runs(rank, {}),
               "grouped": _fused_runs(rank, {"param_groups": GROUPS,
                                             "weight_decay": 0.01,
                                             "max_grad_norm": 0.5}),
               "clipped": _fused_runs(rank, {"max_grad_norm": 0.5}),
               "skip": _skip(rank),
               "round_trips": _round_trips(rank, tmpdir),
               "jax": _jax_trajectory(rank,
                                      torch.load(f"{tmpdir}/jax_init.pt"))}
        amp_props = amp._amp_state._amp_state.opt_properties
        dry = entry.dryrun(world, "cpu", steps=2)
        out["dryrun"] = {"losses": dry["losses"],
                         "zero1": dry["zero1"]["losses"],
                         "zero2": dry["zero2"]["losses"]}
        out["ddp_simple"] = ddp_simple.run(ddp_simple.parse_args(
            ["--iters", "3", "--b", "16", "--zero2"]), device="cpu")
        out["imagenet"] = _imagenet(rank, tmpdir)
        amp._amp_state._amp_state.opt_properties = amp_props
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mlp():
    import jax
    from apex_tpu.models import MLP
    params = MLP(features=(32, 32)).init(
        jax.random.PRNGKey(2), np.zeros((1, 784), np.float32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_mlp):
    tmp = tmp_path_factory.mktemp("zero")
    torch.save(models.mlp_params_from_jax(jax_mlp), tmp / "jax_init.pt")
    torch.multiprocessing.start_processes(_rank_main,
                                          args=(WORLD, str(tmp)),
                                          nprocs=WORLD, join=True,
                                          start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def _check_zero_runs(ranks, runs):
    for r, out in enumerate(ranks):
        want = out[runs]["ddp"]
        for leg in out[runs]:
            got = out[runs][leg]
            for k in want["params"]:
                assert torch.equal(got["params"][k], want["params"][k]), \
                    (runs, leg, k)
            if leg != "ddp":
                assert torch.equal(got["m"], _half(want["m"], r))
                assert torch.equal(got["v"], _half(want["v"], r))
    first = ranks[0][runs]["ddp"]["params"]
    assert not torch.equal(first["Dense_0.weight"],
                           _mlp().Dense_0.weight.detach())


def test_with_zero_flat_is_the_replicated_step(ranks):
    _check_zero_runs(ranks, "flat")
    assert set(ranks[0]["flat"]) == {"ddp", "zero1", "zero2"}


def test_with_zero_grouped_is_the_replicated_step(ranks):
    _check_zero_runs(ranks, "grouped")
    assert set(ranks[0]["grouped"]) == {"ddp", "zero1"}


def test_zero_clips_by_the_reduced_gradient_norm(ranks):
    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    for r, out in enumerate(ranks):
        runs = out["clipped"]
        want = runs["ddp"]["params"]
        for k in want:
            assert torch.equal(runs["zero1"]["params"][k], want[k]), k
            assert err(runs["zero2"]["params"][k], want[k]) <= CLIP_TOL, k
            assert not torch.equal(want[k], out["flat"]["ddp"]["params"][k])
        for moment in ("m", "v"):
            assert torch.equal(runs["zero1"][moment],
                               _half(runs["ddp"][moment], r))
            assert err(runs["zero2"][moment],
                       _half(runs["ddp"][moment], r)) <= CLIP_TOL


def test_zero2_skip_step_keeps_bits_and_halves_the_scale(ranks):
    for out in ranks:
        clean, bad = out["skip"][0], out["skip"][1]
        assert not clean["kept"] and clean["skipped"] == 0
        assert clean["scale"] == clean["scale0"] and clean["step"] == 1
        assert bad["kept"] and bad["skipped"] == 1 and bad["step"] == 1
        assert bad["scale"] == bad["scale0"] / 2


def test_refusals():
    params = dict(_mlp().named_parameters())
    g = {k: torch.zeros_like(v) for k, v in params.items()}
    tree = FusedAdam(layout="tree")
    with pytest.raises(ValueError, match="flat-layout FusedAdam"):
        parallel.zero2_update(tree, params, g, tree.init(params), GROUP)
    grouped = FusedAdam(param_groups=GROUPS)
    with pytest.raises(NotImplementedError, match="param_groups"):
        parallel.zero2_update(grouped, params, g, grouped.init(params),
                              GROUP)
    flat = FusedAdam()
    with pytest.raises(ValueError, match="already shard-local"):
        parallel.zero2_update(flat.with_zero(GROUP), params, g,
                              flat.init(params), GROUP)
    # the tree layout shards now (ZeRO-1 over its moments, like_params);
    # without a process group every leaf stays whole
    whole = tree.init(params)
    cut = parallel.shard_optimizer_state(whole, GROUP)
    assert all(a.shape == b.shape for a, b in zip(
        torch.utils._pytree.tree_leaves(cut.m),
        torch.utils._pytree.tree_leaves(whole.m)))
    assert tree.with_zero(GROUP)._zero is not None
    # ZeRO over FusedLAMB passes through to its own with_zero (parity:
    # tests/test_torch_zero_tp.py)
    _, lamb = amp.initialize(_mlp(), __import__(
        "apex_tpu_torch.optimizers", fromlist=["FusedLAMB"]).FusedLAMB(),
        opt_level="O0", verbosity=0)
    assert lamb.with_zero(GROUP).inner._zero[0] is GROUP


def test_shard_unshard_round_trip(ranks):
    for out in ranks:
        assert out["round_trips"]["flat"] and out["round_trips"]["tree"]


def test_checkpoint_round_trip(ranks):
    for out in ranks:
        assert out["round_trips"]["checkpoint"]


def test_zero2_matches_jax(ranks, jax_mlp):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from apex_tpu import parallel as jpar
    from apex_tpu.models import MLP
    from apex_tpu.optimizers import FusedAdam as JaxAdam
    from apex_tpu.optimizers.fused_adam import FusedAdamState
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    model = MLP(features=(32, 32))
    opt = JaxAdam(lr=LR, use_pallas=False)
    params = jax.tree.map(jnp.asarray, jax_mlp)
    state = opt.init(params)
    spec = state.spec

    def per_device(params, m, v, c, x, y):
        def loss_fn(p):
            logits = model.apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), y).mean()
        g = jax.grad(loss_fn)(params)
        st = FusedAdamState(step=c, m=m, v=v, spec=spec)
        p2, s2 = jpar.zero2_update(opt, params, g, st, "data")
        return p2, s2.m, s2.v, s2.step

    step = jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P(), P("data"), P("data")),
        out_specs=(P(), P("data"), P("data"), P()), check_vma=False))
    shard = NamedSharding(mesh, P("data"))
    m = jax.device_put(state.m, shard)
    v = jax.device_put(state.v, shard)
    c = state.step
    x, y = _data()
    for s in range(STEPS):
        params, m, v, c = step(params, m, v, c,
                               jax.device_put(x[s].numpy(), shard),
                               jax.device_put(y[s].numpy().astype(np.int32),
                                              shard))
    want = models.mlp_params_from_jax(jax.tree.map(np.asarray, params))
    for out in ranks:
        for k, got in out["jax"].items():
            err = float((got - want[k]).abs().max()) \
                / (float(want[k].abs().max()) + 1.0)
            assert err <= JAX_TOL, (k, err)


def test_per_leaf_shard_dims_match_jax(ranks):
    import jax
    import optax
    from jax.sharding import Mesh
    from apex_tpu import parallel as jpar
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    shapes = {"conv": CONV, "Dense_0.weight": (32, 784),
              "Dense_0.bias": (32,), "Dense_2.weight": (10, 32)}
    jstate = jpar.shard_optimizer_state(
        optax.sgd(0.1, momentum=0.9).init(
            {k: np.zeros(s, np.float32) for k, s in shapes.items()}), mesh)
    for name, shape in shapes.items():
        spec = tuple(jstate[0].trace[name].sharding.spec)
        want = next((d for d, e in enumerate(spec) if e == "data"), None)
        got = zero.leaf_shard_dim(shape, WORLD, WORLD * 128)
        assert got == want, (name, got, spec)
        local = ranks[0]["round_trips"]["shapes"].get(name)
        if local is not None:
            expect = list(shape)
            if want is not None:
                expect[want] //= WORLD
            assert local == tuple(expect), (name, local)
    assert zero.leaf_shard_dim(CONV, WORLD, WORLD * 128) == 3


def test_entry_points_at_a_world_of_two(ranks):
    for out in ranks:
        dry = out["dryrun"]
        assert dry["zero1"] == dry["losses"] == dry["zero2"]
        assert len(out["ddp_simple"]) == 3
        assert np.all(np.isfinite(out["ddp_simple"]))
    assert ranks[0]["ddp_simple"] == ranks[1]["ddp_simple"]


def test_imagenet_zero_is_bit_for_bit_and_resumes(ranks):
    for out in ranks:
        assert out["imagenet"] == {"zero_is_plain": True,
                                   "resume_is_straight": True,
                                   "moved": True}


def test_unaligned_shards_take_the_replicated_update():
    """A flat buffer whose slices would not be whole float4s (B1's
    16-byte accesses) stays whole in ``shard_optimizer_state`` and takes
    ``with_zero``'s replicated update, the same bits as without it."""
    assert zero.flat_shard_len(6, 1, 0) is None
    assert zero.flat_shard_len(1024, 2, 256) == 512
    assert zero.flat_shard_len(1004, 2, 256) is None      # 502 % 4
    params = {"a": torch.arange(3.0), "b": torch.arange(3.0, 6.0)}
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    opt = FusedAdam(lr=LR, pad_to=2)
    state = parallel.shard_optimizer_state(opt.init(params), GROUP,
                                           min_shard_elems=0)
    assert state.m.numel() == 6
    want, _ = opt.step(_clone(params), grads, opt.init(params))
    got, _ = opt.with_zero(GROUP, min_shard_elems=0).step(
        _clone(params), grads, state)
    for k in want:
        assert torch.equal(got[k], want[k])
