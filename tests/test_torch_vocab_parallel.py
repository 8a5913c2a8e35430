"""``ops.vocab_parallel_lm_loss`` against the JAX package's dense loss.

The twin of ``tests/distributed/test_tensor_parallel.py:142-236``:
hidden (4, 16, 32), a tied embedding of 64 rows, ids and an optional
padding mask made from ``numpy.random.RandomState``; the embedding split
over 2 gloo ranks (each its 32 rows).  The loss and its gradients for
``hidden`` and for each rank's ``wte`` rows equal the JAX dense loss
(``einsum`` logits, ``models.lm_loss``) and its ``jax.grad``: the loss
within 1e-6 relative, the gradients within 1e-5 scale-aware, with and
without the mask.  With 16 rows of large garbage appended (80 rows, 40 a
rank) and ``true_vocab=64``, the loss and the gradients of the real
rows are still the true vocabulary's and the padding rows get none.  In
one process (no process group) the function is the dense loss.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch import parallel
from apex_tpu_torch.models import lm_loss
from apex_tpu_torch.ops import vocab_parallel_lm_loss

B, S, H, V, VP = 4, 16, 32, 64, 80
WORLD = 2
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


def _inputs():
    rng = np.random.RandomState(0)
    hidden = rng.randn(B, S, H).astype(np.float32)
    wte = (rng.randn(V, H) * 0.1).astype(np.float32)
    ids = rng.randint(0, V, (B, S)).astype(np.int64)
    mask = np.pad(np.ones((B, 12), np.int64), ((0, 0), (0, S - 12)))
    pad = (7.0 * rng.randn(VP - V, H)).astype(np.float32)
    return hidden, wte, ids, mask, pad


def _case(hidden, wte, ids, mask, mesh, true_vocab=None):
    n = wte.shape[0] // WORLD
    r = mesh.index("model")
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(wte[r * n:(r + 1) * n].copy()).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    loss = vocab_parallel_lm_loss(h, w, torch.from_numpy(ids), mesh,
                                  attention_mask=m, true_vocab=true_vocab)
    gh, gw = torch.autograd.grad(loss, [h, w])
    return {"loss": float(loss), "hidden": gh, "wte": gw}


def _rank_main(rank, world, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmpdir}/store",
                            rank=rank, world_size=world)
    try:
        mesh = parallel.create_mesh(tp=world)
        hidden, wte, ids, mask, pad = _inputs()
        out = {"plain": _case(hidden, wte, ids, None, mesh),
               "mask": _case(hidden, wte, ids, mask, mesh),
               "padded": _case(hidden, np.concatenate([wte, pad]), ids,
                               None, mesh, true_vocab=V)}
        torch.save(out, f"{tmpdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vp")
    torch.multiprocessing.start_processes(_rank_main,
                                          args=(WORLD, str(tmp)),
                                          nprocs=WORLD, join=True,
                                          start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want)))
                                                 + 1.0)


def _jax_dense(hidden, wte, ids, mask):
    import jax
    import jax.numpy as jnp
    from apex_tpu import models

    def dense(h, w):
        logits = jnp.einsum("bsh,vh->bsv", h, w).astype(jnp.float32)
        return models.lm_loss(logits, jnp.asarray(ids),
                              None if mask is None else jnp.asarray(mask))

    loss, (gh, gw) = jax.value_and_grad(dense, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(wte))
    return float(loss), np.asarray(gh), np.asarray(gw)


@pytest.mark.parametrize("case", ["plain", "mask", "padded"])
def test_loss_and_grads_match_the_jax_dense_loss(ranks, case):
    hidden, wte, ids, mask, _ = _inputs()
    want, wh, ww = _jax_dense(hidden, wte, ids,
                              mask if case == "mask" else None)
    n = (VP if case == "padded" else V) // WORLD
    rows = torch.cat([r[case]["wte"] for r in ranks]).numpy()
    for r in ranks:
        got = r[case]
        assert abs(got["loss"] - want) <= LOSS_TOL * abs(want)
        # hidden's gradient is summed over the ranks (copy_to_group)
        assert rel_err(got["hidden"], wh) <= GRAD_TOL
    assert rows.shape[0] == WORLD * n
    assert rel_err(rows[:V], ww) <= GRAD_TOL
    if case == "padded":
        assert not np.any(rows[V:])
    # the two ranks agree on the loss bit for bit
    assert ranks[0][case]["loss"] == ranks[1][case]["loss"]


def test_one_process_is_the_dense_loss():
    hidden, wte, ids, mask, _ = _inputs()
    mesh = parallel.Mesh({"model": 1},
                         {"model": parallel.ProcessGroup()})
    assert not dist.is_initialized()
    for m in (None, mask):
        mt = None if m is None else torch.from_numpy(m)
        got = vocab_parallel_lm_loss(torch.from_numpy(hidden),
                                     torch.from_numpy(wte),
                                     torch.from_numpy(ids), mesh,
                                     attention_mask=mt)
        logits = torch.einsum("bsh,vh->bsv", torch.from_numpy(hidden),
                              torch.from_numpy(wte))
        want = lm_loss(logits, torch.from_numpy(ids), mt)
        assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
