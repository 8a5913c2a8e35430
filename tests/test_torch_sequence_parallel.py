"""Sequence parallelism in apex_tpu_torch against apex_tpu's.

The port's ``ring_attention`` (its flash path, one ``flash_attention`` a
hop with the lse merge, and its fp32 online-softmax blocks) and
``ulysses_attention`` (flash and the exact fp32 softmax), run by gloo
ranks at sp 2 and sp 4 (B 2, S 32, H 4, D 16), against the JAX
functions under ``shard_map`` on the conftest's CPU mesh at the same sp
(the JAX flash path through its plain reference), from the same numpy
inputs:

- forward and the gradients of q, k and v of ``sum(o**2)``, causal and
  not, with a key padding mask (and the causal ring without one): fp32
  within 1e-5 scale-aware (``tools/kernel_parity.py``'s measure);
- a batch row whose every key is masked gives zeros on every path;
- bf16 inputs: within 2e-2 of the JAX function on the same bf16 inputs;
- dropout (rate 0.3, seed 17): outputs and gradients within 1e-5 of the
  JAX call's, and the keep masks the hops draw, read from the plain
  versions as they run and laid out at their global coordinates, equal
  the one-device mask bit for bit and cover every live (q, k) pair;
- the causal ring's forward and backward finish within
  ``BACKWARD_LIMIT`` seconds a rank at sp 2 and at sp 4 (the ranks are
  spawned under a deadline, so a deadlock fails instead of hanging);
- the adapters' ``onef1b_compatible`` marks and the ValueErrors the JAX
  functions raise.

The ranks are spawned once for each sp (a ``FileStore`` under the
test's temporary directory); the rank function imports no JAX.
"""

import importlib
import time
from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.parallel import sequence as sq

B, S, H, D = 2, 32, 4, 16
NEG_INF = -1e30
RATE, SEED = 0.3, 17
TOL, BF16_TOL = 1e-5, 2e-2
BACKWARD_LIMIT = 30.0     # seconds a rank for a causal ring fwd + bwd
SPAWN_LIMIT = 240.0       # seconds for all of one world's cases
IMPLS = ("ring", "ulysses")
PATHS = ("flash", "plain")
# (impl, path, causal, masked)
CASES = [(i, p, c, True) for i in IMPLS for p in PATHS
         for c in (False, True)] + [("ring", "flash", True, False)]
DROP_CASES = [("ring", "flash", True), ("ring", "flash", False),
              ("ring", "plain", True), ("ulysses", "flash", False),
              ("ulysses", "plain", True)]


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _pad_mask():
    mask = np.zeros((B, S), np.float32)
    mask[:, S - 9:] = NEG_INF
    return mask


def _dead_row_mask():
    mask = np.zeros((B, S), np.float32)
    mask[1] = NEG_INF
    return mask


def _port_fn(impl, path):
    fn = sq.ring_attention if impl == "ring" else sq.ulysses_attention
    return partial(fn, use_flash=path == "flash")


# -- the ranks -------------------------------------------------------------

def _run(group, fn, arrays, mask, causal, dtype=torch.float32, grads=True,
         **kw):
    """This rank's output and q/k/v gradients of ``sum(o**2)``."""
    r, n = group.rank(), group.size()
    sl = S // n
    q, k, v = (torch.from_numpy(a[:, r * sl:(r + 1) * sl]).to(dtype)
               .requires_grad_(grads) for a in arrays)
    m = None if mask is None else torch.from_numpy(mask[:, r * sl:(r + 1)
                                                        * sl])
    o = fn(q, k, v, group=group, kv_mask=m, causal=causal, **kw)
    if not grads:
        return {"o": o.detach().float()}
    (o.float() ** 2).sum().backward()
    return {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _capture(record):
    """Wrap the plain versions' keep-mask draws: each ``(seed array,
    mask)`` a hop draws goes to ``record``."""
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    fa_keep, sq_keep = fa._keep_mask, sq.keep_from_seed

    def keep_mask(seed, q, k, rate):
        out = fa_keep(seed, q, k, rate)
        record.append((seed.clone(), out.clone()))
        return out

    def keep_from_seed(seed, *args):
        out = sq_keep(seed, *args)
        record.append((seed.clone(), out.clone()))
        return out

    fa._keep_mask, sq.keep_from_seed = keep_mask, keep_from_seed
    return lambda: (setattr(fa, "_keep_mask", fa_keep),
                    setattr(sq, "keep_from_seed", sq_keep))


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        group = parallel.create_mesh(sp=world).group("sp")
        out = {"cases": {}, "drop": {}}
        arrays, pad = _inputs(0), _pad_mask()
        for impl, path, causal, masked in CASES:
            t0 = time.perf_counter()
            out["cases"][(impl, path, causal, masked)] = _run(
                group, _port_fn(impl, path), arrays,
                pad if masked else None, causal)
            if impl == "ring" and causal:
                out.setdefault("seconds", []).append(
                    time.perf_counter() - t0)
        dead = _dead_row_mask()
        out["dead"] = {(impl, path): _run(group, _port_fn(impl, path),
                                          _inputs(1), dead, False,
                                          grads=False)["o"]
                       for impl in IMPLS for path in PATHS}
        out["bf16"] = {impl: _run(group, _port_fn(impl, "flash"),
                                  _inputs(2), pad, False,
                                  dtype=torch.bfloat16, grads=False)["o"]
                       for impl in IMPLS}
        for impl, path, causal in DROP_CASES:
            record = []
            undo = _capture(record)
            try:
                res = _run(group, _port_fn(impl, path), _inputs(3), None,
                           causal, dropout_rate=RATE, dropout_seed=SEED)
            finally:
                undo()
            res["masks"] = record
            out["drop"][(impl, path, causal)] = res
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp):
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, str(tmp)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the sp {world} ranks did not finish in "
                        f"{SPAWN_LIMIT} s (a deadlocked collective?)")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"sp{world}"))


def _gather(ranks_out, get):
    return np.concatenate([np.asarray(get(o).float()) for o in ranks_out],
                          axis=1)


# -- the JAX side ------------------------------------------------------------

def _jax_run(impl, path, n, arrays, mask, causal, grads=True, dtype=None,
             **kw):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from apex_tpu.parallel import ring_attention, ulysses_attention
    fn = ring_attention if impl == "ring" else ulysses_attention
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    extra = dict(kw, use_flash=path == "flash", causal=causal)
    if mask is None:
        f = shard_map(lambda q, k, v: fn(q, k, v, axis_name="seq", **extra),
                      mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                      out_specs=P(None, "seq"), check_vma=False)
        call = f
    else:
        f = shard_map(lambda q, k, v, m: fn(q, k, v, axis_name="seq",
                                            kv_mask=m, **extra),
                      mesh=mesh, in_specs=(P(None, "seq"),) * 4,
                      out_specs=P(None, "seq"), check_vma=False)
        call = lambda q, k, v: f(q, k, v, jnp.asarray(mask))
    q, k, v = (jnp.asarray(a, dtype) if dtype else jnp.asarray(a)
               for a in arrays)
    if not grads:
        return {"o": np.asarray(jax.jit(call)(q, k, v), np.float32)}

    def loss(q, k, v):
        o = call(q, k, v)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return {"o": np.asarray(o), "dq": np.asarray(g[0]),
            "dk": np.asarray(g[1]), "dv": np.asarray(g[2])}


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_forward_and_grads_match_jax(ranks, case):
    n, outs = ranks
    impl, path, causal, masked = case
    want = _jax_run(impl, path, n, _inputs(0),
                    _pad_mask() if masked else None, causal)
    for key in ("o", "dq", "dk", "dv"):
        got = _gather(outs, lambda o: o["cases"][case][key])
        assert rel_err(got, want[key]) <= TOL, (case, key)


def test_fully_masked_rows_give_zeros(ranks):
    n, outs = ranks
    for impl in IMPLS:
        for path in PATHS:
            got = _gather(outs, lambda o: o["dead"][(impl, path)])
            assert np.all(got[1] == 0.0), (impl, path)
            want = _jax_run(impl, path, n, _inputs(1), _dead_row_mask(),
                            False, grads=False)["o"]
            assert rel_err(got, want) <= TOL, (impl, path)


def test_bf16_inputs(ranks):
    import jax.numpy as jnp
    n, outs = ranks
    for impl in IMPLS:
        got = _gather(outs, lambda o: o["bf16"][impl])
        want = _jax_run(impl, "flash", n, _inputs(2), _pad_mask(), False,
                        grads=False, dtype=jnp.bfloat16)["o"]
        assert rel_err(got, want) <= BF16_TOL, impl


@pytest.mark.parametrize("case", DROP_CASES,
                         ids=["-".join(map(str, c)) for c in DROP_CASES])
def test_dropout_matches_jax_and_the_one_device_masks(ranks, case):
    import jax.numpy as jnp
    from apex_tpu.ops.flash_attention import keep_from_seed, seed_array
    n, outs = ranks
    impl, path, causal = case
    want = _jax_run(impl, path, n, _inputs(3), None, causal,
                    dropout_rate=RATE, dropout_seed=SEED)
    for key in ("o", "dq", "dk", "dv"):
        got = _gather(outs, lambda o: o["drop"][case][key])
        assert rel_err(got, want[key]) <= TOL, (case, key)
    dense = np.asarray(keep_from_seed(seed_array(SEED, num_heads=H), B, H,
                                      jnp.arange(S), jnp.arange(S), RATE))
    laid = np.full((B, H, S, S), -1, np.int8)
    for out in outs:
        for seed, mask in out["drop"][case]["masks"]:
            s = seed.numpy()
            assert s[0] == SEED and s[4] == H
            _, hl, sq_len, sk_len = mask.shape
            block = laid[:, s[3]:s[3] + hl, s[1]:s[1] + sq_len,
                         s[2]:s[2] + sk_len]
            new = mask.numpy().astype(np.int8)
            assert np.all((block == -1) | (block == new))
            block[...] = new
    live = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    assert np.all(laid[:, :, live] >= 0), "a live (q, k) pair drew no mask"
    drawn = laid >= 0
    assert np.array_equal(laid[drawn].astype(bool), dense[drawn])


def test_causal_ring_backward_within_its_limit(ranks):
    n, outs = ranks
    for out in outs:
        assert len(out["seconds"]) == 3
        assert max(out["seconds"]) <= BACKWARD_LIMIT, (n, out["seconds"])


def test_adapters_and_refusals():
    ring = sq.make_ring_attention(None, causal=True)
    uly = sq.make_ulysses_attention(None)
    assert ring.onef1b_compatible is False and uly.onef1b_compatible is True
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="dropout_seed"):
        sq.ring_attention(q, q, q, dropout_rate=0.3)
    with pytest.raises(ValueError, match="dropout_seed"):
        sq.ulysses_attention(q, q, q, dropout_rate=0.3)
    with pytest.raises(ValueError, match="flash_kwargs"):
        sq.ring_attention(q, q, q, flash_kwargs=dict(dropout_rate=0.1))
    with pytest.raises(ValueError, match="flash_kwargs"):
        sq.ulysses_attention(q, q, q, flash_kwargs=dict(dropout_rate=0.1))
    with pytest.raises(ValueError, match="mutually exclusive"):
        sq.ulysses_attention(q, q, q, attention_impl=lambda *a, **k: a[0],
                             dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sq.ulysses_attention(q, q, q, attention_impl=lambda *a, **k: a[0],
                             scale=0.5)
    # a world of one is the one-device call
    want = sq.ring_attention(q + 1.0, q, q + 2.0, use_flash=False)
    for fn in (ring, uly):
        got = fn(q + 1.0, q, q + 2.0)
        assert got.shape == q.shape
    assert torch.allclose(uly(q + 1.0, q, q + 2.0), want, atol=1e-6)
