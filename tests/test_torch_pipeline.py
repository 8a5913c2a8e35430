"""Pipeline schedules in apex_tpu_torch against apex_tpu's.

The port's ``parallel.pipeline`` (GPipe as one autograd node with the
reverse ticks written out, 1F1B's eager tick loop) run by gloo ranks,
one stage a rank, at pp 2 and pp 4, against the JAX functions
(``pipeline_apply``, ``onef1b_loss_and_grad``) under ``shard_map`` on
the conftest's CPU mesh at the same pp, from the same numpy inputs: the
residual MLP stage of ``tests/distributed/test_pipeline.py`` (B 16, F
12), fp32, within 1e-5 scale-aware (``tools/kernel_parity.py``'s
measure):

- GPipe's output and the gradients of its stage params and its input
  of ``mean((y - t)**2)``, for m in {1, 2, 4}, and its stage params'
  gradients when the input needs none (the reference's
  ``test_gradients_match_sequential`` call);
- 1F1B's loss, stage grads and ``dx`` for m in {1, 2, 4}, with
  ``loss_params`` (their gradient the fourth output), and with pytree
  activations: a float side leaf (its ``dx`` too) and an int32 leaf
  (zero gradients of its own dtype);
- at pp 4 on a (2, 2) (data, pipe) mesh: GPipe per data index (its
  output, and its params' grads meaned over the data group with an
  input that needs no gradient), and 1F1B's grads meaned over the data
  group, against the JAX composition;
- 1F1B's saved stage inputs: never more than S on a rank (stage s at
  most S - s), whatever M;
- the hop ``shift_g``: the pairs ``(i, i + 1)`` with no wrap-around, its
  backward the reverse hop;
- every rank's schedules finish within ``SPAWN_LIMIT`` (the ranks are
  spawned under a deadline, so a hop one rank skips fails instead of
  hanging);
- the errors of the shared prologue (one stage a rank, a shared batch
  dim, ``b % m``) and 1F1B's target check, as the JAX functions raise
  them.

The ranks are spawned once for each pp (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import pipeline as pl

B, F = 16, 12
MS = (1, 2, 4)
TOL = 1e-5
SPAWN_LIMIT = 120.0


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _inputs(s, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((s, F, F)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((s, F)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, F)).astype(np.float32)
    t = rng.standard_normal((B, F)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((B, F))).astype(np.float32)
    head = (rng.standard_normal((F, F)) * 0.3).astype(np.float32)
    ids = rng.randint(0, 5, (B,)).astype(np.int32)
    return dict(w=w, b=b, x=x, t=t, bias=bias, head=head, ids=ids)


# -- the stage functions, one body for both frameworks (`ops` is torch or
# jax.numpy)

def _stage(ops):
    def stage_fn(p, x):
        return x + ops.tanh(x @ p["w"] + p["b"])
    return stage_fn


def _stage_side(ops):
    def stage_fn(p, xb):
        h, bias = xb
        return (h + ops.tanh(h @ p["w"] + p["b"] + bias), bias)
    return stage_fn


def _stage_int(ops):
    def stage_fn(p, xb):
        h, ids = xb
        scale = 1.0 + (ids[:, None].float() if ops is torch
                       else ids[:, None].astype(ops.float32))
        return (h + ops.tanh(h @ p["w"] + p["b"]) * scale, ids)
    return stage_fn


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _mse_side(yb, t):
    return ((yb[0] - t) ** 2).mean()


def _mse_head(y, t, lp):
    return ((y @ lp["w"] - t) ** 2).mean()


# -- the ranks ---------------------------------------------------------------

def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rank_cases(mesh, arr):
    s = mesh.shape["pipe"]
    r = mesh.index("pipe")
    out = {}
    stage = _stage(torch)
    for m in MS:
        params = {"w": _t(arr["w"], True), "b": _t(arr["b"], True)}
        x = _t(arr["x"], True)
        y = pl.pipeline_apply(mesh, "pipe", stage, params, x, m)
        _mse(y, _t(arr["t"])).backward()
        out[("gpipe", m)] = {"y": y.detach(), "w": params["w"].grad[r],
                             "b": params["b"].grad[r], "dx": x.grad}
        stats = {}
        run = pl.onef1b_spmd(stage, _mse, mesh.group("pipe"), m)
        loss, g, dx = run({"w": _t(arr["w"][r:r + 1]),
                           "b": _t(arr["b"][r:r + 1])}, _t(arr["x"]),
                          _t(arr["t"]), stats=stats)
        out[("1f1b", m)] = {"loss": loss, "w": g["w"][0], "b": g["b"][0],
                            "dx": dx, "live": stats["max_live_inputs"]}
        loss, g, dx, dlp = pl.onef1b_loss_and_grad(
            mesh, "pipe", stage, _mse_head,
            {"w": _t(arr["w"]), "b": _t(arr["b"])}, _t(arr["x"]),
            _t(arr["t"]), m, {"w": _t(arr["head"])})
        out[("1f1b_lp", m)] = {"loss": loss, "w": g["w"][0], "b": g["b"][0],
                               "dx": dx, "lp": dlp["w"]}
    params = {"w": _t(arr["w"], True), "b": _t(arr["b"], True)}
    y = pl.pipeline_apply(mesh, "pipe", stage, params, _t(arr["x"]), 4)
    _mse(y, _t(arr["t"])).backward()
    out["gpipe_params_only"] = {"w": params["w"].grad[r],
                                "b": params["b"].grad[r]}
    loss, g, dx = pl.onef1b_loss_and_grad(
        mesh, "pipe", _stage_side(torch), _mse_side,
        {"w": _t(arr["w"]), "b": _t(arr["b"])},
        (_t(arr["x"]), _t(arr["bias"])), _t(arr["t"]), 4)
    out["side"] = {"loss": loss, "w": g["w"][0], "b": g["b"][0],
                   "dh": dx[0], "dbias": dx[1]}
    loss, g, dx = pl.onef1b_loss_and_grad(
        mesh, "pipe", _stage_int(torch), _mse_side,
        {"w": _t(arr["w"]), "b": _t(arr["b"])},
        (_t(arr["x"]), _t(arr["ids"])), _t(arr["t"]), 4)
    out["int"] = {"loss": loss, "w": g["w"][0], "b": g["b"][0],
                  "dh": dx[0], "dids": dx[1]}
    stats = {}
    pl.onef1b_spmd(stage, _mse, mesh.group("pipe"), 8)(
        {"w": _t(arr["w"][r:r + 1]), "b": _t(arr["b"][r:r + 1])},
        _t(np.tile(arr["x"], (2, 1))), _t(np.tile(arr["t"], (2, 1))),
        stats=stats)
    out["live8"] = stats["max_live_inputs"]
    x = torch.full((3,), r + 1.0, requires_grad=True)
    y = parallel.shift_g(x, mesh.group("pipe"), 1)
    (y * (r + 1)).sum().backward()
    out["shift"] = (y.detach(), x.grad)
    assert s == dist.get_world_size()
    return out


def _dp_cases(mesh, arr):
    """A (2, 2) mesh: each data index runs its half of the rows."""
    d, r = mesh.index("data"), mesh.index("pipe")
    rows = slice(d * B // 2, (d + 1) * B // 2)
    stage = _stage(torch)
    ddp = parallel.DistributedDataParallel(process_group=mesh.group("data"))
    p = {"w": _t(arr["w"][r:r + 1], True), "b": _t(arr["b"][r:r + 1], True)}
    y = pl.gpipe_spmd(stage, mesh.group("pipe"), 2)(p, _t(arr["x"][rows]))
    _mse(y, _t(arr["t"][rows])).backward()
    gp = ddp.reduce_gradients({k: v.grad for k, v in p.items()})
    loss, g, _ = pl.onef1b_spmd(stage, _mse, mesh.group("pipe"), 2)(
        {"w": _t(arr["w"][r:r + 1]), "b": _t(arr["b"][r:r + 1])},
        _t(arr["x"][rows]), _t(arr["t"][rows]))
    g = ddp.reduce_gradients({"loss": loss.reshape(1), **g})
    return {"y": y.detach(), "loss": g["loss"][0], "w": g["w"][0],
            "b": g["b"][0], "gpipe_w": gp["w"][0], "gpipe_b": gp["b"][0]}


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _rank_cases(parallel.create_mesh(pp=world),
                          _inputs(world))
        if world == 4:
            out["dp"] = _dp_cases(parallel.create_mesh(pp=2), _inputs(2, 1))
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp, limit=SPAWN_LIMIT):
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish in {limit} s "
                        "(a hop one rank skipped?)")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


_RANKS = {}
WORLDS = pytest.mark.parametrize("world", [2, 4], ids=["pp2", "pp4"])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: the ranks' results, spawned once a world."""
    def get(world):
        if world not in _RANKS:
            _RANKS[world] = _spawn(_rank_main, world,
                                   tmp_path_factory.mktemp(f"pp{world}"))
        return world, _RANKS[world]
    return get


@pytest.fixture
def ranks(spawned, world):
    return spawned(world)


# -- the JAX side ------------------------------------------------------------

def _jax_mesh(s, axes=("pipe",), shape=None):
    import jax
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:int(np.prod(shape or (s,)))])
    return Mesh(devs.reshape(shape or (s,)), axes)


def _jax_gpipe(s, arr, m, params_only=False):
    """``pipeline_apply``'s output and gradients; ``params_only``: the
    gradients of the params alone, x a constant (``jax.grad`` over the
    params, as the reference's ``test_gradients_match_sequential``)."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import parallel as jpar
    mesh = _jax_mesh(s)
    params = {"w": jnp.asarray(arr["w"]), "b": jnp.asarray(arr["b"])}
    x, t = jnp.asarray(arr["x"]), jnp.asarray(arr["t"])

    def loss(p, x):
        y = jpar.pipeline_apply(mesh, "pipe", _stage(jnp), p, x,
                                num_microbatches=m)
        return _mse(y, t), y

    if params_only:
        g = jax.jit(jax.grad(lambda p: loss(p, x)[0]))(params)
        return {"w": g["w"], "b": g["b"]}
    (_, y), (g, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    return {"y": y, "w": g["w"], "b": g["b"], "dx": dx}


def _jax_1f1b(s, arr, m, stage, loss_fn, x, lp=None):
    import jax.numpy as jnp
    from apex_tpu import parallel as jpar
    import jax
    mesh = _jax_mesh(s)
    params = {"w": jnp.asarray(arr["w"]), "b": jnp.asarray(arr["b"])}
    return jax.jit(lambda p, x, t, lp: jpar.onef1b_loss_and_grad(
        mesh, "pipe", stage, loss_fn, p, x, t, num_microbatches=m,
        loss_params=lp))(params, x, jnp.asarray(arr["t"]), lp)


def _check(got, want, label):
    err = rel_err(np.asarray(got), np.asarray(want))
    assert err <= TOL, f"{label}: {err:.3g}"


@WORLDS
@pytest.mark.parametrize("m", MS)
def test_gpipe_matches_jax(ranks, m):
    s, outs = ranks
    want = _jax_gpipe(s, _inputs(s), m)
    for r, o in enumerate(outs):
        got = o[("gpipe", m)]
        _check(got["y"], want["y"], f"rank {r} y")
        _check(got["w"], want["w"][r], f"rank {r} dw")
        _check(got["b"], want["b"][r], f"rank {r} db")
        _check(got["dx"], want["dx"], f"rank {r} dx")


@WORLDS
def test_gpipe_params_only_grads_match_jax(ranks):
    """x needs no gradient: every stage's params still get theirs (the
    gradient hops run whenever a stage param is differentiated)."""
    s, outs = ranks
    want = _jax_gpipe(s, _inputs(s), 4, params_only=True)
    for r, o in enumerate(outs):
        got = o["gpipe_params_only"]
        _check(got["w"], want["w"][r], f"rank {r} dw")
        _check(got["b"], want["b"][r], f"rank {r} db")


@WORLDS
@pytest.mark.parametrize("m", MS)
def test_onef1b_matches_jax(ranks, m):
    import jax.numpy as jnp
    s, outs = ranks
    arr = _inputs(s)
    loss, g, dx = _jax_1f1b(s, arr, m, _stage(jnp), _mse,
                            jnp.asarray(arr["x"]))
    for r, o in enumerate(outs):
        got = o[("1f1b", m)]
        _check(got["loss"], loss, f"rank {r} loss")
        _check(got["w"], g["w"][r], f"rank {r} dw")
        _check(got["b"], g["b"][r], f"rank {r} db")
        _check(got["dx"], dx, f"rank {r} dx")


@WORLDS
@pytest.mark.parametrize("m", MS)
def test_onef1b_loss_params_match_jax(ranks, m):
    import jax.numpy as jnp
    s, outs = ranks
    arr = _inputs(s)
    loss, g, dx, dlp = _jax_1f1b(s, arr, m, _stage(jnp), _mse_head,
                                 jnp.asarray(arr["x"]),
                                 {"w": jnp.asarray(arr["head"])})
    for r, o in enumerate(outs):
        got = o[("1f1b_lp", m)]
        _check(got["loss"], loss, f"rank {r} loss")
        _check(got["w"], g["w"][r], f"rank {r} dw")
        _check(got["dx"], dx, f"rank {r} dx")
        _check(got["lp"], dlp["w"], f"rank {r} dlp")


@WORLDS
def test_onef1b_pytree_activations_match_jax(ranks):
    import jax.numpy as jnp
    s, outs = ranks
    arr = _inputs(s)
    loss, g, dx = _jax_1f1b(s, arr, 4, _stage_side(jnp), _mse_side,
                            (jnp.asarray(arr["x"]), jnp.asarray(arr["bias"])))
    iloss, ig, idx = _jax_1f1b(s, arr, 4, _stage_int(jnp), _mse_side,
                               (jnp.asarray(arr["x"]),
                                jnp.asarray(arr["ids"])))
    for r, o in enumerate(outs):
        side, ints = o["side"], o["int"]
        _check(side["loss"], loss, f"rank {r} loss")
        _check(side["w"], g["w"][r], f"rank {r} dw")
        _check(side["dh"], dx[0], f"rank {r} dh")
        _check(side["dbias"], dx[1], f"rank {r} dbias")
        _check(ints["loss"], iloss, f"rank {r} int loss")
        _check(ints["w"], ig["w"][r], f"rank {r} int dw")
        _check(ints["dh"], idx[0], f"rank {r} int dh")
        assert ints["dids"].dtype == torch.int32
        assert not ints["dids"].any()
        assert np.asarray(idx[1]).dtype == np.int32 and not np.any(idx[1])


@WORLDS
def test_onef1b_live_inputs_bounded(ranks):
    """Stage s holds at most S - s saved inputs (S on stage 0), at M 4
    and at M 8: the memory bound does not grow with M."""
    s, outs = ranks
    for r, o in enumerate(outs):
        assert o[("1f1b", 1)]["live"] == 1
        assert o[("1f1b", 4)]["live"] == min(s - r, 4)
        assert o["live8"] == s - r <= s


def test_dp_x_pp_matches_jax(spawned):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu import parallel as jpar
    s, outs = spawned(4)
    arr = _inputs(2, 1)
    mesh = _jax_mesh(4, ("data", "pipe"), (2, 2))
    params = {"w": jnp.asarray(arr["w"]), "b": jnp.asarray(arr["b"])}
    spec = {"w": P("pipe"), "b": P("pipe")}
    y = jax.jit(jax.shard_map(jpar.gpipe_spmd(_stage(jnp), "pipe", 2),
                              mesh=mesh, in_specs=(spec, P("data")),
                              out_specs=P("data")))(
        params, jnp.asarray(arr["x"]))
    run = jpar.onef1b_spmd(_stage(jnp), _mse, "pipe", 2)

    def spmd(p, x, t):
        loss, g, _ = run(p, x, t)
        return (jax.lax.pmean(loss, "data"),
                jax.tree.map(lambda a: jax.lax.pmean(a, "data"), g))

    loss, g = jax.jit(jax.shard_map(spmd, mesh=mesh,
                                    in_specs=(spec, P("data"), P("data")),
                                    out_specs=(P(), spec)))(
        params, jnp.asarray(arr["x"]), jnp.asarray(arr["t"]))
    gpipe = jax.jit(jax.shard_map(jpar.gpipe_spmd(_stage(jnp), "pipe", 2),
                                  mesh=mesh, in_specs=(spec, P("data")),
                                  out_specs=P("data")))
    x, t = jnp.asarray(arr["x"]), jnp.asarray(arr["t"])
    gg = jax.jit(jax.grad(lambda p: _mse(gpipe(p, x), t)))(params)
    for rank, o in enumerate(outs):
        d, r = divmod(rank, 2)
        got = o["dp"]
        _check(got["y"], np.asarray(y)[d * B // 2:(d + 1) * B // 2],
               f"rank {rank} y")
        _check(got["loss"], loss, f"rank {rank} loss")
        _check(got["w"], g["w"][r], f"rank {rank} dw")
        _check(got["b"], g["b"][r], f"rank {rank} db")
        _check(got["gpipe_w"], gg["w"][r], f"rank {rank} gpipe dw")
        _check(got["gpipe_b"], gg["b"][r], f"rank {rank} gpipe db")


@WORLDS
def test_shift_hop_and_its_backward(ranks):
    """``shift_g``: rank r gets rank r - 1's tensor (rank 0 zeros, no
    wrap-around) and its gradient is the next rank's, sent back (the last
    rank's zero)."""
    s, outs = ranks
    for r, o in enumerate(outs):
        y, grad = o["shift"]
        assert torch.equal(y, torch.full((3,), float(r)))
        assert torch.equal(grad, torch.full((3,), float(r + 2)
                                             if r + 1 < s else 0.0))


@WORLDS
def test_ranks_finish_in_time(ranks):
    s, outs = ranks
    assert all(o["seconds"] < SPAWN_LIMIT for o in outs)


def test_errors_match_jax():
    """Without a process group the port runs as one stage; the JAX
    functions at one stage on one device raise the same errors."""
    import jax.numpy as jnp
    from apex_tpu import parallel as jpar
    mesh_j = _jax_mesh(1)
    arr = _inputs(2)
    two = {"w": arr["w"], "b": arr["b"]}
    cases = [
        ("stage count must equal", ValueError, two, arr["x"], 4, None),
        ("must share the batch dim", ValueError,
         {k: v[:1] for k, v in two.items()}, (arr["x"], arr["x"][:8]), 4,
         None),
        ("must divide into 3 microbatches", AssertionError,
         {k: v[:1] for k, v in two.items()}, arr["x"], 3, None),
        ("must share the activations' batch dim", ValueError,
         {k: v[:1] for k, v in two.items()}, arr["x"], 4, arr["t"][:8]),
    ]
    stage = _stage(torch)
    for phrase, kind, p, x, m, tgt in cases:
        def port():
            xt = tuple(map(_t, x)) if isinstance(x, tuple) else _t(x)
            if tgt is None:
                pl.pipeline_apply(parallel.Mesh({"pipe": 1}, {}), "pipe",
                                  stage, {k: _t(v) for k, v in p.items()},
                                  xt, m)
            else:
                pl.onef1b_loss_and_grad(
                    parallel.Mesh({"pipe": 1}, {}), "pipe", stage, _mse,
                    {k: _t(v) for k, v in p.items()}, xt, _t(tgt), m)

        def ref():
            pj = {k: jnp.asarray(v) for k, v in p.items()}
            xj = tuple(map(jnp.asarray, x)) if isinstance(x, tuple) \
                else jnp.asarray(x)
            if tgt is None:
                jpar.pipeline_apply(mesh_j, "pipe", _stage(jnp), pj, xj,
                                    num_microbatches=m)
            else:
                jpar.onef1b_loss_and_grad(mesh_j, "pipe", _stage(jnp), _mse,
                                          pj, xj, jnp.asarray(tgt),
                                          num_microbatches=m)

        with pytest.raises(kind, match=phrase):
            ref()
        with pytest.raises(kind, match=phrase):
            port()
