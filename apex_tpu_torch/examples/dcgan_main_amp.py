"""DCGAN under amp: two models, two optimizers, three losses.

Twin of ``examples/dcgan/main_amp.py``: ``amp.initialize([G, D],
[optG, optD], num_losses=3)`` with ``adam(lr, b1=0.5, b2=0.999)``
(``optimizers.transforms``, the optax twin) for each model, O1 by
default, and the JAX example's CLI and defaults (``--b 64``,
``--image-size 64``, ``--nz 100``, ``--iters 20``).  A step
(:func:`train_step`) is the JAX example's ``train_step``:

- D's loss on the real batch (loss_id 0) and on ``G(z).detach()``
  (loss_id 1), each scaled and unscaled by its own scaler; the second
  unscale is stashed into the first (``unscale_grads(stashed=...)``),
  and one ``apply_gradients`` runs on the ORed overflow;
- G's loss through the updated D (loss_id 2), one ``optG.step``.

Running statistics keep exactly the JAX step's updates: D's from its
real pass, then its fake pass; G's from one pass over ``z`` from the
pre-step statistics.  The JAX step runs G twice on the same params and
noise and keeps the second pass's update, which equals the first's, so
the twin runs G once and differentiates the G loss through that pass;
D's pass inside the G loss runs in training mode and its statistics
update is discarded (:func:`_kept_buffers`), as the JAX step discards
it.

``--ddp`` wraps each model in ``parallel.DistributedDataParallel``: a
loss's gradients are averaged over the ranks before their unscale, so
every rank sees the same overflow.  On a world of one the averaging is
the identity, and the run equals the run without the flag bit for bit.

The data: real batches ``rand(b, 64, 64, 3) * 2 - 1`` from
``RandomState(seed)`` as the JAX example makes them; the noise is
``standard_normal((b, nz))`` from ``RandomState(seed + 1)`` (the JAX
example draws it from ``jax.random.normal``, whose bits the port does
not copy).

    python -m apex_tpu_torch.examples.dcgan_main_amp            # O1
    python -m apex_tpu_torch.examples.dcgan_main_amp --opt-level O0

:func:`train` is the loop as a function; ``device="cpu"`` runs it on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, models
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.parallel import DistributedDataParallel, \
    broadcast_params
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.utils import AverageMeter, maybe_print


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DCGAN amp example "
                                "(PyTorch/CUDA port)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--b", "--batch-size", type=int, default=64, dest="b",
                   help="batch of each rank")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--print-freq", type=int, default=5)
    p.add_argument("--ddp", action="store_true",
                   help="average each loss's gradients over the ranks "
                   "(parallel.DistributedDataParallel)")
    return p.parse_args(argv)


def synthetic_batches(args, seed: int = 0) \
        -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless ``(real, z)``: real NHWC float32 images in [-1, 1) from
    ``RandomState(seed)``, noise ``(b, nz)`` from ``RandomState(seed +
    1)``."""
    rng = np.random.RandomState(seed)
    noise = np.random.RandomState(seed + 1)
    while True:
        real = rng.rand(args.b, args.image_size, args.image_size,
                        3).astype(np.float32) * 2 - 1
        z = noise.standard_normal((args.b, args.nz)).astype(np.float32)
        yield real, z


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build(args, *, device="cuda", base_features: int = 64, seed: int = 0,
          state_dicts: Optional[Tuple[Mapping, Mapping]] = None):
    """``(G, D, optG, optD, pG, pD, sG, sD)``: the models under
    ``amp.initialize`` with ``num_losses=3``, their parameters and
    optimizer states.  Weights from ``seed`` (G) and ``seed + 1`` (D),
    or ``state_dicts`` (G's, D's; e.g. from
    ``models.dcgan_params_from_jax``); on a world of several ranks the
    parameters start as rank 0's."""
    dev = resolve_device(device)
    given = state_dicts is not None
    netG = models.Generator(z_dim=args.nz, base_features=base_features,
                            device=dev, seed=None if given else seed)
    netD = models.Discriminator(base_features=base_features, device=dev,
                                seed=None if given else seed + 1)
    if given:
        netG.load_state_dict(state_dicts[0])
        netD.load_state_dict(state_dicts[1])

    def adam():
        return transforms.adam(args.lr, b1=args.beta1, b2=0.999)

    [G, D], [optG, optD] = amp.initialize(
        [netG, netD], [adam(), adam()], opt_level=args.opt_level,
        loss_scale=args.loss_scale, num_losses=3)
    pG, pD = G.init(), D.init()
    if _world()[1] > 1:
        pG, pD = broadcast_params(pG), broadcast_params(pD)
    return G, D, optG, optD, pG, pD, optG.init(pG), optD.init(pD)


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """The mean sigmoid cross entropy against a constant label."""
    return transforms.sigmoid_binary_cross_entropy(
        logits, torch.full_like(logits, target)).mean()


@contextlib.contextmanager
def _kept_buffers(module: torch.nn.Module):
    """Running statistics as they were on entry, whatever the forwards
    inside update."""
    saved = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)


def _grads(scaled, params):
    return dict(zip(params, torch.autograd.grad(scaled,
                                                list(params.values()))))


def train_step(G, D, optG, optD, pG, pD, sG, sD, real, z, ddp=None):
    """One step of the JAX example's ``train_step``.  ``ddp`` is
    ``(ddpG, ddpD)`` or None.  Returns ``(pG, pD, sG, sD, errD, errG)``,
    the losses unscaled device scalars."""
    reduce_g = ddp[0].reduce_gradients if ddp else (lambda g: g)
    reduce_d = ddp[1].reduce_gradients if ddp else (lambda g: g)
    # D: the real and the fake loss, each with its own scaler
    errD_real = bce_logits(D.apply(pD, real, train=True), 1.0)
    with amp.scale_loss(errD_real, sD, loss_id=0) as scaled:
        gDr = reduce_d(_grads(scaled, pD))
    fake = G.apply(pG, z, train=True)
    errD_fake = bce_logits(D.apply(pD, fake.detach(), train=True), 0.0)
    with amp.scale_loss(errD_fake, sD, loss_id=1) as scaled:
        gDf = reduce_d(_grads(scaled, pD))
    gDr, ovfr, sD = optD.unscale_grads(gDr, sD, loss_id=0)
    gD, ovff, sD = optD.unscale_grads(gDf, sD, loss_id=1, stashed=gDr)
    pD_new, sD = optD.apply_gradients(pD, gD, sD, ovfr | ovff)
    # G: its loss through the updated D, whose statistics stay as they are
    with _kept_buffers(D.unwrapped):
        errG = bce_logits(D.apply(pD_new, fake, train=True), 1.0)
    with amp.scale_loss(errG, sG, loss_id=2) as scaled:
        gG = reduce_g(_grads(scaled, pG))
    pG_new, sG = optG.step(pG, gG, sG, loss_id=2)
    return (pG_new, pD_new, sG, sD, (errD_real + errD_fake).detach(),
            errG.detach())


def train(args, *, device="cuda", base_features: int = 64, seed: int = 0,
          state_dicts=None, batches=None) -> dict:
    """``--epochs`` of ``--iters`` steps on this rank.  ``batches``
    (``(real, z)`` numpy pairs) defaults to :func:`synthetic_batches`
    from ``seed + rank``.  Returns per-step ``loss_d`` and ``loss_g``,
    ``step_seconds`` (on the card: CUDA events between the steps'
    starts, read at the end; on the CPU the host clock) and
    ``images_per_s`` (this rank's), each optimizer's state and the
    three scales, and what the step takes."""
    dev = resolve_device(device)
    rank, world = _world()
    G, D, optG, optD, pG, pD, sG, sD = build(
        args, device=dev, base_features=base_features, seed=seed,
        state_dicts=state_dicts)
    ddp = (DistributedDataParallel(G), DistributedDataParallel(D)) \
        if args.ddp else None
    data = synthetic_batches(args, seed + rank) if batches is None \
        else iter(batches)
    cuda = dev.type == "cuda"
    marks, loss_d, loss_g = [], [], []
    meterD, meterG = AverageMeter(), AverageMeter()

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    for epoch in range(args.epochs):
        for i in range(args.iters):
            real, z = (torch.from_numpy(a).to(dev) for a in next(data))
            mark()
            pG, pD, sG, sD, errD, errG = train_step(
                G, D, optG, optD, pG, pD, sG, sD, real, z, ddp)
            loss_d.append(errD)
            loss_g.append(errG)
            if args.print_freq and i % args.print_freq == 0:
                meterD.update(float(errD))
                meterG.update(float(errG))
                maybe_print(
                    f"[{epoch}][{i}/{args.iters}] Loss_D {meterD.val:.4f} "
                    f"Loss_G {meterG.val:.4f} scales "
                    f"{float(optD.loss_scale(sD, 0)):.0f}/"
                    f"{float(optD.loss_scale(sD, 1)):.0f}/"
                    f"{float(optG.loss_scale(sG, 2)):.0f}", rank0=True)
    mark()
    if cuda:
        torch.cuda.synchronize(dev)
        seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        seconds = [b - a for a, b in zip(marks, marks[1:])]
    return {"loss_d": torch.stack(loss_d).tolist(),
            "loss_g": torch.stack(loss_g).tolist(),
            "step_seconds": seconds,
            "images_per_s": [args.b / s for s in seconds],
            "loss_scales": [float(optD.loss_scale(sD, 0)),
                            float(optD.loss_scale(sD, 1)),
                            float(optG.loss_scale(sG, 2))],
            "G": G, "D": D, "optG": optG, "optD": optD, "pG": pG, "pD": pD,
            "sG": sG, "sD": sD}


def main(argv=None):
    args = parse_args(argv)
    if args.ddp:
        initialize_distributed("cuda")
    dev = resolve_device("cuda")
    rank, world = _world()
    maybe_print(f"device: {torch.cuda.get_device_name(dev)}, world size "
                f"{world}, batch {args.b} per rank", rank0=True)
    out = train(args, device=dev)
    meter = AverageMeter()
    for v in out["images_per_s"][1:]:       # the first step warms up
        meter.update(v)
    maybe_print(f"final: Loss_D {out['loss_d'][-1]:.4f} Loss_G "
                f"{out['loss_g'][-1]:.4f}, avg {meter.avg * world:.1f} "
                f"images/s over {world} rank(s)", rank0=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
