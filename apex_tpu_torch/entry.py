"""Entry points: a ResNet-50 forward and the flagship data-parallel step.

Twin of ``__graft_entry__.py``.  ``entry()`` returns the ResNet-50 amp O2
forward at batch 8, 224x224, with its arguments.  ``dryrun(n)`` runs
the data-parallel training step of the JAX ``dryrun_multichip`` on this
rank of ``n``: a tiny BasicBlock ResNet (stages [1, 1], width 16, 10
classes) with ``SyncBatchNorm``, amp O2, ``FusedAdam(lr=1e-3)`` (kernel
B1 on the card) and ``DistributedDataParallel``, on ``2 * n`` images of
ones at 32x32 split over the ranks.  Then, as the JAX dry run, the same
step under ZeRO-1 (``parallel.shard_optimizer_state`` plus
``optimizer.with_zero`` over the world, ``__graft_entry__.py:112-118``)
and under ZeRO-2 (``parallel.zero2_update`` through
``AmpOptimizer.zero2_step``: the gradients reduce-scattered into each
rank's shard, the overflow flag taken over the world).  The JAX dry
run's ZeRO-2 leg steps a linear model in fp32 (``:545-599``); here it
is the flagship step itself, so amp's skip protocol is in it.  Each
ZeRO run must end with the plain run's params bit for bit, so the runs
take deterministic cuDNN algorithms (benchmark off).  The tensor,
sequence, pipeline and expert-parallel legs of the JAX dry run are not
here.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch import amp, models, parallel
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.optimizers import FusedAdam, transforms
from apex_tpu_torch.parallel.multiproc import free_port

DRYRUN_IMAGE = 32


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is ResNet-50's amp O2 forward
    (inference mode) on a batch of 8 224x224 images of ones."""
    dev = resolve_device(device)
    model, _ = amp.initialize(models.ResNet50(device=dev),
                              transforms.sgd(0.1), opt_level="O2",
                              verbosity=0)
    x = torch.ones((8, 224, 224, 3), dtype=torch.float32, device=dev)
    params = model.init()

    def forward(params, x):
        with torch.no_grad():
            return model.apply(params, x, train=False)

    return forward, (params, x)


def dryrun_model(device="cuda", seed: Optional[int] = 0):
    """The dry run's model: ResNet(stages [1, 1], BasicBlock, 10 classes,
    width 16, SyncBatchNorm)."""
    return models.ResNet([1, 1], models.BasicBlock, num_classes=10,
                         width=16, norm=parallel.SyncBatchNorm,
                         device=device, seed=seed)


def flagship_setup(device="cuda", *, opt_level: str = "O2", optimizer=None,
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   zero: Optional[str] = None):
    """The dry run's step as it starts on this rank of an initialized
    process group: ``(model, optimizer, ddp, params, opt_state, x, y)``.
    ``zero``: None (DDP), ``"zero1"`` (the state sharded over the world,
    the optimizer ``with_zero``) or ``"zero2"`` (the state sharded)."""
    dev = resolve_device(device)
    module = dryrun_model(dev, seed=None if state_dict else 0)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    model, opt = amp.initialize(
        module, optimizer if optimizer is not None else FusedAdam(
            lr=1e-3), opt_level=opt_level, verbosity=0)
    ddp = parallel.DistributedDataParallel(model)
    params = model.init()
    opt_state = opt.init(params)
    if zero is not None:
        opt_state = parallel.shard_optimizer_state(opt_state,
                                                   parallel.mesh.WORLD)
    if zero == "zero1":
        opt = opt.with_zero(parallel.mesh.WORLD)
    x = torch.ones((2, DRYRUN_IMAGE, DRYRUN_IMAGE, 3), device=dev)
    y = torch.zeros((2,), dtype=torch.int64, device=dev)
    return model, opt, ddp, params, opt_state, x, y


def flagship_step(model, opt, ddp, params, opt_state, x, y,
                  zero: Optional[str] = None):
    """One step of the dry run: returns ``(params, opt_state, loss)``,
    the loss this rank's, on the device (nothing is read back)."""
    logits = model.apply(params, x, train=True).float()
    loss = transforms.softmax_cross_entropy_with_integer_labels(
        logits, y).mean()
    with amp.scale_loss(loss, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    grads = dict(zip(params.keys(), grads))
    if zero == "zero2":
        params, opt_state = opt.zero2_step(params, grads, opt_state,
                                           parallel.mesh.WORLD)
    else:
        grads = ddp.reduce_gradients(grads)
        params, opt_state = opt.step(params, grads, opt_state)
    return params, opt_state, loss.detach()


def _flagship_run(dev, steps, opt_level, optimizer, state_dict, zero):
    """``steps`` of the dry run's step on this rank; returns the
    world-mean losses, params, optimizer state and model."""
    model, opt, ddp, params, opt_state, x, y = flagship_setup(
        dev, opt_level=opt_level, optimizer=optimizer,
        state_dict=state_dict, zero=zero)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = flagship_step(model, opt, ddp, params,
                                                opt_state, x, y, zero)
        losses.append(parallel.all_reduce_tree(loss, average=True))
    losses = [float(v) for v in losses]
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"dryrun {zero or 'ddp'}: loss {losses}")
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "model": model}


def dryrun(n_ranks: int, device="cuda", *, steps: int = 1,
           opt_level: str = "O2", optimizer=None,
           state_dict: Optional[Mapping[str, torch.Tensor]] = None
           ) -> dict:
    """The flagship data-parallel step on this rank of ``n_ranks``, then
    its ZeRO-1 and ZeRO-2 runs.

    Call it on every rank of an initialized process group of ``n_ranks``;
    with none and ``n_ranks == 1`` it starts a one-rank group itself
    (NCCL on the card, gloo on the CPU; the address is a free localhost
    port) and ends it after.  ``steps`` repeats the step on the same
    batch; ``optimizer`` replaces ``FusedAdam(lr=1e-3)`` (ZeRO-2 needs a
    flat FusedAdam: another optimizer runs ZeRO-1 only) and
    ``state_dict`` (e.g. ``models.resnet_params_from_jax``) the weights
    from seed 0.  Returns the world-mean ``losses`` and the final
    ``params``, ``opt_state`` and ``model`` of the DDP run, and
    ``"zero1"`` / ``"zero2"`` the same of each ZeRO run; a ZeRO run
    whose params differ from the DDP run's in any bit raises."""
    dev = resolve_device(device)
    own_group = not dist.is_initialized()
    if own_group:
        if n_ranks != 1:
            raise RuntimeError(f"dryrun({n_ranks}) needs an initialized "
                               f"process group of {n_ranks} ranks")
        parallel.initialize_distributed(
            dev, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    try:
        # the ZeRO runs are held to the DDP run's bits: cuDNN's benchmark
        # may pick a convolution algorithm whose sums run in no fixed order
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=False,
                deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            world, rank = dist.get_world_size(), dist.get_rank()
            if world != n_ranks:
                raise RuntimeError(f"dryrun({n_ranks}) on a world of "
                                   f"{world}")
            out = _flagship_run(dev, steps, opt_level, optimizer,
                                state_dict, None)
            legs = ["zero1"]
            if optimizer is None or (isinstance(optimizer, FusedAdam)
                                     and optimizer.layout == "flat"):
                legs.append("zero2")
            for leg in legs:
                got = _flagship_run(dev, steps, opt_level, optimizer,
                                    state_dict, leg)
                same = all(torch.equal(a, b) for a, b in zip(
                    got["params"].values(), out["params"].values()))
                if not same:
                    raise AssertionError(f"dryrun({n_ranks}) {leg}: params "
                                         "differ from the DDP run's")
                out[leg] = got
            if rank == 0:
                print(f"dryrun({n_ranks}) dp + SyncBN + FusedAdam "
                      f"({opt_level}): ok, loss={out['losses'][-1]:.4f}"
                      + "".join(f"; {leg} bit for bit" for leg in legs))
            return out
    finally:
        if own_group:
            dist.destroy_process_group()
