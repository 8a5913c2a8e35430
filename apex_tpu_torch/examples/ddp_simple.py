"""Minimal DistributedDataParallel usage, explicit-collectives style.

Twin of ``examples/simple/distributed/distributed_data_parallel.py``
(reference ``examples/simple/distributed/distributed_data_parallel.py``):
each rank computes gradients on its batch, ``ddp.reduce_gradients``
gives every rank the world-averaged gradient with the apex options
(``--allreduce-always-fp32``, ``--gradient-predivide-factor``), and
amp's optimizer steps ``sgd(0.05)``.  The model is the JAX example's
``models.MLP(features=(256, 256))`` (784 -> 256 -> 256 -> 10, ReLU).

One process per GPU (``python -m apex_tpu_torch.parallel.multiproc``);
``--b`` is the global batch, split evenly over the ranks, rank r taking
rows ``r::world`` of each batch from ``np.random.RandomState(0)``.

    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.ddp_simple --allreduce-always-fp32

``--zero2`` is the JAX example's ZeRO-2 variant: no DDP all-reduce;
``parallel.zero2_update`` reduce-scatters each rank's local gradients
into its shard of a flat ``FusedAdam(lr=1e-3)`` state (B1 on the card),
updates that shard and all-gathers the params.  As there, the loss is
not scaled (fp32 optimizer arithmetic; the forward follows
``--opt-level``).

    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.ddp_simple --zero2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, parallel
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import MLP
from apex_tpu_torch.optimizers import FusedAdam, transforms
from apex_tpu_torch.parallel.mesh import WORLD


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--b", type=int, default=256, help="global batch size")
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--allreduce-always-fp32", action="store_true")
    p.add_argument("--gradient-predivide-factor", type=float, default=1.0)
    p.add_argument("--zero2", action="store_true")
    return p.parse_args(argv)


def _batch(rng, args, rank, world, dev):
    x = rng.randn(args.b, 784).astype(np.float32)[rank::world]
    y = rng.randint(0, 10, args.b).astype(np.int64)[rank::world]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def run_zero2(args, model, params, rank, world, dev) -> list:
    """``--zero2``: ``--iters`` steps of ``parallel.zero2_update`` over
    the world with ``FusedAdam(lr=1e-3)``; the world-mean loss of each
    step."""
    opt = FusedAdam(lr=1e-3)
    state = parallel.shard_optimizer_state(opt.init(params), WORLD)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(args.iters):
        x, y = _batch(rng, args, rank, world, dev)
        loss = transforms.softmax_cross_entropy_with_integer_labels(
            model.apply(params, x).float(), y).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        params, state = parallel.zero2_update(
            opt, params, dict(zip(params.keys(), grads)), state, WORLD)
        losses.append(float(parallel.all_reduce_tree(loss.detach(),
                                                     average=True)))
        if i % 5 == 0 and rank == 0:
            print(f"iter {i}: loss {losses[-1]:.4f}  [zero-2: m/v "
                  f"{state.m.numel()} of {state.p.numel()} a rank]")
    return losses


def run(args, device="cuda") -> list:
    """Train ``--iters`` steps on this rank; returns the world-mean loss
    of each step."""
    dev = resolve_device(device)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    if args.b % world:
        raise SystemExit(f"global batch {args.b} must divide by {world} "
                         "ranks")
    model, optimizer = amp.initialize(
        MLP(features=(256, 256), device=dev), transforms.sgd(0.05),
        opt_level=args.opt_level,
        verbosity=0)
    ddp = parallel.DistributedDataParallel(
        model, allreduce_always_fp32=args.allreduce_always_fp32,
        gradient_predivide_factor=args.gradient_predivide_factor)
    params = ddp.broadcast_params(ddp.init())
    if args.zero2:
        return run_zero2(args, model, params, rank, world, dev)
    opt_state = optimizer.init(params)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(args.iters):
        x, y = _batch(rng, args, rank, world, dev)
        logits = ddp.apply(params, x).float()
        loss = transforms.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        with amp.scale_loss(loss, opt_state) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()))
        # the DDP contract: world-averaged grads on every rank
        grads = ddp.reduce_gradients(dict(zip(params.keys(), grads)))
        params, opt_state = optimizer.step(params, grads, opt_state)
        mean_loss = parallel.all_reduce_tree(loss.detach(), average=True)
        losses.append(float(mean_loss))
        if i % 5 == 0 and rank == 0:
            print(f"iter {i}: loss {losses[-1]:.4f}  loss_scale "
                  f"{float(optimizer.loss_scale(opt_state)):.0f}")
    return losses


def main(argv=None):
    args = parse_args(argv)
    parallel.initialize_distributed("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(f"world size: {world}")
    run(args)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
