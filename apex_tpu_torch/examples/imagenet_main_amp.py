"""ImageNet training with amp + DDP + SyncBN: the flagship workload.

Twin of ``examples/imagenet/main_amp.py`` (reference
``examples/imagenet/main_amp.py``): a ResNet under amp, data-parallel,
optionally with ``SyncBatchNorm`` (``--sync_bn``), trained by
``sgd(lr_schedule, momentum)`` after ``add_decayed_weights`` (the optax
twins of ``optimizers.transforms``), with the same CLI and defaults,
the same synthetic bytes (``np.random.RandomState(seed)``) and the
same schedule (linear warmup, then x0.1 at epochs 30, 60 and 80).

One process per GPU, as the reference runs: ``--b`` is the batch of
each rank, ``DistributedDataParallel.reduce_gradients`` averages the
gradients after the backward, and SyncBatchNorm merges statistics over
the ranks (NCCL on the card; gloo on the CPU).  Start the ranks with
``python -m apex_tpu_torch.parallel.multiproc``; alone, the process is
a world of one.  Rank r draws synthetic batches from seed r.

    python -m apex_tpu_torch.examples.imagenet_main_amp --sync_bn
    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.imagenet_main_amp --sync_bn

:func:`train` is the loop as a function; ``device="cpu"`` runs it on
the CPU.  ``--data`` takes a torchvision ImageFolder tree (``train/``
and, for validation, ``val/``; each rank decodes its shard with
``--workers`` threads) or ``.npz`` shards (``x`` NHWC uint8, ``y``
int).  ``--torch-weights`` starts from a torchvision-format checkpoint
(``utils.load_torch_resnet``); ``--checkpoint-dir`` saves the whole
train state (params, running statistics, optimizer and scaler state,
epoch, best prec@1) to ``last/`` after each epoch's validation and to
``best/`` on a new best prec@1, from rank 0 (``utils.checkpoint``);
``--resume`` restores one and starts at the epoch after it.  ``--zero``
is ZeRO-1 over the ranks: the SGD momentum's large leaves hold this
rank's slice (``parallel.shard_optimizer_state``), the update runs on
those slices and gathers the params (``AmpOptimizer.with_zero``), and a
checkpoint saves the state unsharded (``unshard_optimizer_state``, as
the JAX example does), so any world size resumes from it.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp, models, parallel
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.data import image_folder_loader, npz_loader, \
    prefetch_to_device
from apex_tpu_torch.data.loaders import _list_image_folder
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.parallel import DistributedDataParallel, SyncBatchNorm
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.utils import AverageMeter, checkpoint, \
    load_torch_resnet, maybe_print

ARCHS = {
    "resnet18": models.ResNet18, "resnet34": models.ResNet34,
    "resnet50": models.ResNet50, "resnet101": models.ResNet101,
    "resnet152": models.ResNet152,
}

MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ImageNet training with apex_tpu_torch amp (GPU)")
    p.add_argument("--data", default=None,
                   help="dataset dir: an ImageFolder tree (train/<class>/"
                   "*.jpg [+ val/<class>/*.jpg]) or .npz shards (x: NHWC "
                   "uint8, y: int); synthetic when omitted")
    p.add_argument("--arch", "-a", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("--stem", default="conv", choices=["conv", "s2d"])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--b", "--batch-size", type=int, default=256, dest="b",
                   help="batch size of each rank (global batch = b * "
                   "world size, the reference's convention)")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--val-steps", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--workers", type=int, default=8,
                   help="decode threads of the ImageFolder loader")
    p.add_argument("--deterministic", action="store_true",
                   help="TF32 off in cuDNN and cuBLAS, deterministic "
                   "cuDNN algorithms")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--prof", type=int, default=None,
                   help="profile N iterations then exit")
    p.add_argument("--sync_bn", action="store_true",
                   help="use apex_tpu_torch.parallel.SyncBatchNorm")
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--keep-batchnorm-fp32", default=None)
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir to resume from")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save last/ and best/ checkpoints when set")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1: shard the optimizer state over the ranks "
                   "(parallel.shard_optimizer_state)")
    p.add_argument("--torch-weights", default=None, metavar="PT",
                   help="initialize from a torchvision-format checkpoint "
                   "(.pt state_dict, 'module.' prefixes stripped)")
    return p.parse_args(argv)


def synthetic_batches(args, steps, seed=0):
    """Endless NHWC uint8 batches of ``args.b`` images and int32 labels
    from ``np.random.RandomState(seed)``: pixels, normalized on the
    device by the step."""
    rng = np.random.RandomState(seed)
    while True:
        for _ in range(steps):
            x = rng.randint(0, 256, (args.b, args.image_size,
                                     args.image_size, 3), dtype=np.uint8)
            y = rng.randint(0, args.num_classes, (args.b,), dtype=np.int32)
            yield x, y


def make_loaders(args, rank: int = 0, world: int = 1):
    """``(train_iter, make_val_iter or None, steps_per_epoch)`` for
    ``--data``: synthetic batches without it (rank r from seed r, the
    validation set from seed 1234 + r); an ImageFolder tree (rank r
    decodes shard r of ``train/``, an epoch its length over ``--b``,
    and validates on ``val/`` when there is one); else ``.npz`` shards,
    each rank its own rows."""
    if args.data is None:
        train = synthetic_batches(args, args.steps_per_epoch, seed=rank)

        def make_val():
            return iter([b for _, b in zip(
                range(args.val_steps),
                synthetic_batches(args, args.val_steps, seed=1234 + rank))])

        return train, make_val, args.steps_per_epoch
    train_dir = os.path.join(args.data, "train")
    if os.path.isdir(train_dir):
        samples = _list_image_folder(train_dir)[0]
        steps = max(1, len(samples) // world // args.b)
        train = image_folder_loader(
            train_dir, args.b, image_size=args.image_size, train=True,
            num_workers=args.workers, samples=samples, num_shards=world,
            shard_index=rank)
        val_dir = os.path.join(args.data, "val")
        make_val = None
        if os.path.isdir(val_dir):
            def make_val():
                return image_folder_loader(
                    val_dir, args.b, image_size=args.image_size,
                    train=False, num_workers=args.workers, loop=False,
                    num_shards=world, shard_index=rank)
        return train, make_val, steps
    if glob.glob(os.path.join(args.data, "*.npz")):
        return (npz_loader(args.data, args.b, num_shards=world,
                           shard_index=rank), None, args.steps_per_epoch)
    raise SystemExit(f"--data {args.data}: neither train/ subdir nor .npz "
                     "shards found")


def lr_schedule(args, steps_per_epoch):
    """The reference's schedule: linear warmup over ``--warmup-epochs``,
    then x0.1 at absolute epochs 30, 60 and 80 (``join_schedules``
    counts the decay from the end of the warmup)."""
    warmup = args.warmup_epochs * steps_per_epoch
    decay = transforms.piecewise_constant_schedule(
        args.lr, {max(e * steps_per_epoch - warmup, 1): 0.1
                  for e in (30, 60, 80)})
    if warmup == 0:
        return decay
    return transforms.join_schedules(
        [transforms.linear_schedule(args.lr / max(warmup, 1), args.lr,
                                    warmup), decay], [warmup])


def make_optimizer(args, steps_per_epoch):
    """``sgd(lr_schedule, momentum)``, after ``add_decayed_weights`` when
    ``--weight-decay`` is set."""
    tx = transforms.sgd(lr_schedule(args, steps_per_epoch),
                        momentum=args.momentum)
    if args.weight_decay:
        tx = transforms.chain(
            transforms.add_decayed_weights(args.weight_decay), tx)
    return tx


def make_model(args, device="cuda", seed: int = 0):
    norm = SyncBatchNorm if args.sync_bn else models.default_norm
    return ARCHS[args.arch](num_classes=args.num_classes, norm=norm,
                            stem=args.stem, device=device, seed=seed)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def load_torch_weights(module, args) -> None:
    """``--torch-weights``: a torchvision-format checkpoint (a state dict,
    or a full checkpoint dict holding one under ``state_dict``) loaded
    into ``module``'s parameters and running statistics."""
    sd = torch.load(args.torch_weights, map_location="cpu")
    sd = sd.get("state_dict", sd)
    converted = load_torch_resnet(
        sd, arch=args.arch,
        norm_name="SyncBatchNorm" if args.sync_bn else "BatchNorm",
        stem=args.stem)
    module.load_state_dict({**converted["params"],
                            **converted["batch_stats"]})
    maybe_print(f"loaded torch weights from {args.torch_weights}",
                rank0=True)


def batch_stats(module) -> dict:
    """The running statistics: the module's buffers, by name (the JAX
    model's ``batch_stats`` collection)."""
    return dict(module.named_buffers())


def train_state(model, params, opt_state, epoch: int,
                best_prec1: float) -> dict:
    """The whole train state a checkpoint holds."""
    return {"params": params, "batch_stats": batch_stats(model.unwrapped),
            "opt_state": opt_state, "epoch": epoch,
            "best_prec1": best_prec1}


def resume(path: str, model, params, opt_state):
    """``(params, opt_state, start_epoch, best_prec1)`` from the
    checkpoint at ``path``; the running statistics go back into the
    model's buffers."""
    state = checkpoint.restore(path, train_state(model, params, opt_state,
                                                 0, 0.0))
    with torch.no_grad():
        for name, buf in batch_stats(model.unwrapped).items():
            buf.copy_(state["batch_stats"][name])
    start_epoch = int(state["epoch"]) + 1
    best_prec1 = float(state["best_prec1"])
    maybe_print(f"resumed from {path} at epoch {start_epoch} (best prec@1 "
                f"{best_prec1:.2f})", rank0=True)
    return state["params"], state["opt_state"], start_epoch, best_prec1


def zero_shard(optimizer, opt_state):
    """``--zero``: the optimizer and its state sharded over the world."""
    group = parallel.mesh.WORLD
    return (optimizer.with_zero(group),
            parallel.shard_optimizer_state(opt_state, group))


def full_opt_state(optimizer, params, opt_state, zero: bool):
    """The optimizer state as a checkpoint holds it: gathered from the
    ranks under ``--zero`` (every rank must call it), else as it is."""
    if not zero:
        return opt_state
    like = optimizer.init({k: torch.empty_like(v, device="meta")
                           for k, v in params.items()})
    return parallel.unshard_optimizer_state(opt_state, parallel.mesh.WORLD,
                                            like)


def save_checkpoint(args, model, params, opt_state, epoch: int, prec1,
                    best_prec1: float, optimizer=None) -> float:
    """``--checkpoint-dir``: ``last/`` after every epoch, ``best/`` too on
    a new best prec@1, written by rank 0 (under ``--zero`` every rank
    first takes part in gathering the state: ``optimizer`` is needed);
    returns the best prec@1."""
    is_best = prec1 is not None and prec1 > best_prec1
    if is_best:
        best_prec1 = prec1
    opt_state = full_opt_state(optimizer, params, opt_state, args.zero)
    if _world()[0] == 0:
        state = train_state(model, params, opt_state, epoch, best_prec1)
        checkpoint.save(os.path.join(args.checkpoint_dir, "last"), state)
        if is_best:
            checkpoint.save(os.path.join(args.checkpoint_dir, "best"), state)
    maybe_print(f"saved checkpoint for epoch {epoch}"
                + (f" (new best prec@1 {best_prec1:.2f})" if is_best else ""),
                rank0=True)
    return best_prec1


def build(module, args, steps_per_epoch: int):
    """``(model, optimizer, ddp, params, opt_state)``: ``module`` under
    ``amp.initialize`` with :func:`make_optimizer`'s optimizer, wrapped
    in ``DistributedDataParallel``; on a world of several ranks the
    parameters start as rank 0's."""
    model, optimizer = amp.initialize(
        module, make_optimizer(args, steps_per_epoch),
        opt_level=args.opt_level,
        keep_batchnorm_fp32=args.keep_batchnorm_fp32,
        loss_scale=args.loss_scale)
    ddp = DistributedDataParallel(model)
    params = model.init()
    if _world()[1] > 1:
        params = ddp.broadcast_params(params)
    return model, optimizer, ddp, params, optimizer.init(params)


def normalizer(device):
    """The per-channel MEAN and STD tensors on ``device``."""
    return (torch.from_numpy(MEAN).to(device),
            torch.from_numpy(STD).to(device))


def _precision(logits, y):
    top5 = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    hit1 = top5[:, 0] == y
    hit5 = (top5 == y[:, None]).any(dim=1)
    return hit1, hit5


def train_step(model, optimizer, ddp, params, opt_state, x, y, norm):
    """One step of the JAX example's ``train_step``: ``(x - MEAN) / STD``
    on the device, forward, cross entropy, scaled gradients,
    ``reduce_gradients``, ``optimizer.step``.  Returns ``(params,
    opt_state, loss, prec1, prec5)``, the last three device scalars (this
    rank's batch).  The running statistics update in the model's
    buffers."""
    mean, std = norm
    x = (x.float() - mean) / std
    logits = model.apply(params, x, train=True).float()
    loss = transforms.softmax_cross_entropy_with_integer_labels(
        logits, y).mean()
    with amp.scale_loss(loss, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    grads = ddp.reduce_gradients(dict(zip(params.keys(), grads)))
    params, opt_state = optimizer.step(params, grads, opt_state)
    hit1, hit5 = _precision(logits.detach(), y)
    return (params, opt_state, loss.detach(), hit1.float().mean() * 100,
            hit5.float().mean() * 100)


@torch.no_grad()
def eval_step(model, params, x, y, norm):
    """Counts ``(top-1 hits, top-5 hits, valid rows)`` of a batch (rows
    with ``y < 0`` are padding), summed over the ranks."""
    mean, std = norm
    logits = model.apply(params, (x.float() - mean) / std,
                         train=False).float()
    valid = y >= 0
    hit1, hit5 = _precision(logits, y)
    counts = torch.stack([(hit1 & valid).sum(), (hit5 & valid).sum(),
                          valid.sum()])
    if _world()[1] > 1:
        dist.all_reduce(counts)
    return counts


def validate(model, params, make_val, args, device, norm):
    """prec@1 and prec@5 over the validation set (the reference's
    ``validate()``), padding a short last batch to ``--b`` rows."""
    if make_val is None:
        return None, None
    total = torch.zeros(3, dtype=torch.int64, device=device)
    batch_time, end = AverageMeter(), time.time()
    for x, y in make_val():
        if x.shape[0] < args.b:
            pad = args.b - x.shape[0]
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.full((pad,), -1, y.dtype)])
        total += eval_step(model, params, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device), norm)
        batch_time.update(time.time() - end)
        end = time.time()
    c1, c5, n = (int(v) for v in total.cpu())
    if n == 0:
        maybe_print("validate: no validation batches; skipping metrics",
                    rank0=True)
        return None, None
    prec1, prec5 = 100.0 * c1 / n, 100.0 * c5 / n
    maybe_print(f" * Prec@1 {prec1:.3f} Prec@5 {prec5:.3f} ({n} images, "
                f"{batch_time.avg:.3f}s/batch)", rank0=True)
    return prec1, prec5


def _configure_backends(args, device) -> None:
    if device.type != "cuda":
        return
    if args.deterministic:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.backends.cudnn.benchmark = True


def train(args, *, device="cuda", module=None, steps: Optional[int] = None,
          batches=None) -> dict:
    """The example's loop on this rank.  ``module`` defaults to
    ``--arch`` from seed 0; ``batches`` (``(x, y)`` numpy pairs)
    defaults to ``--data``'s.  With ``steps`` it trains that many steps
    and skips validation and checkpoints; else the epochs from
    ``--resume``'s next (or 0) to ``--epochs`` of ``--steps-per-epoch``,
    validating after each (and saving with ``--checkpoint-dir``).

    Returns per-step ``losses``, ``prec1``, ``prec5`` (this rank's batch)
    and ``step_seconds`` (on the card: CUDA events between the steps'
    starts, read at the end, so the loop syncs only at ``--print-freq``;
    on the CPU the host clock), ``images_per_s`` per step (this rank's),
    the final scaler state, ``start_epoch`` and ``best_prec1``, and what
    the step takes (``model``, ``optimizer``, ``ddp``, ``params``,
    ``opt_state``, ``norm``)."""
    dev = resolve_device(device)
    _configure_backends(args, dev)
    rank, world = _world()
    if module is None:
        module = make_model(args, dev)
    if args.torch_weights:
        load_torch_weights(module, args)
    train_iter, make_val, steps_per_epoch = make_loaders(args, rank, world)
    if batches is not None:
        train_iter = batches
    model, optimizer, ddp, params, opt_state = build(module, args,
                                                     steps_per_epoch)
    start_epoch, best_prec1 = 0, 0.0
    if args.resume:
        params, opt_state, start_epoch, best_prec1 = resume(
            args.resume, model, params, opt_state)
    if args.zero:
        optimizer, opt_state = zero_shard(optimizer, opt_state)
    norm = normalizer(dev)
    if args.evaluate:
        if make_val is None:
            raise SystemExit("--evaluate needs a validation source: an "
                             "ImageFolder --data dir with a val/ subdir, "
                             "or synthetic data (no --data)")
        prec1, prec5 = validate(model, params, make_val, args, dev, norm)
        return {"prec1": prec1, "prec5": prec5}
    if args.prof:
        return profile(args, model, optimizer, ddp, params, opt_state,
                       train_iter, dev, norm)

    total = steps if steps is not None \
        else max(args.epochs - start_epoch, 0) * steps_per_epoch
    per_epoch = total if steps is not None else steps_per_epoch
    data = prefetch_to_device(train_iter, device=dev)
    cuda = dev.type == "cuda"
    marks, losses, p1s, p5s = [], [], [], []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    try:
        for i in range(total):
            x, y = next(data)
            mark()
            params, opt_state, loss, p1, p5 = train_step(
                model, optimizer, ddp, params, opt_state, x, y, norm)
            losses.append(loss)
            p1s.append(p1)
            p5s.append(p5)
            if not cuda:
                float(loss)
            epoch = start_epoch + i // per_epoch
            if args.print_freq and i % args.print_freq == 0:
                maybe_print(f"Epoch: [{epoch}][{i % per_epoch}/"
                            f"{per_epoch}]\tLoss {float(loss):.4f}\t"
                            f"Prec@1 {float(p1):.2f}\tPrec@5 {float(p5):.2f}",
                            rank0=True)
            if steps is None and (i + 1) % per_epoch == 0:
                prec1, _ = validate(model, params, make_val, args, dev,
                                    norm)
                if args.checkpoint_dir:
                    best_prec1 = save_checkpoint(args, model, params,
                                                 opt_state, epoch, prec1,
                                                 best_prec1, optimizer)
        mark()
    finally:
        data.close()
    if cuda:
        torch.cuda.synchronize(dev)
        seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        seconds = [b - a for a, b in zip(marks, marks[1:])]
    return {"losses": [float(v) for v in losses],
            "prec1": [float(v) for v in p1s],
            "prec5": [float(v) for v in p5s],
            "step_seconds": seconds,
            "images_per_s": [args.b / s for s in seconds],
            "loss_scale": float(optimizer.loss_scale(opt_state)),
            "skipped_steps": int(opt_state.skipped_steps),
            "applied_steps": int(opt_state.applied_steps),
            "start_epoch": start_epoch, "best_prec1": best_prec1,
            "model": model, "optimizer": optimizer, "ddp": ddp,
            "params": params, "opt_state": opt_state, "norm": norm}


def profile(args, model, optimizer, ddp, params, opt_state, batches, device,
            norm):
    """``--prof N``: N steps, each in a ``torch.profiler``
    ``record_function`` range (the reference's nvtx ranges), then
    exit."""
    loss = None
    for i in range(args.prof):
        x, y = next(batches)
        with torch.profiler.record_function(f"iter_{i}"):
            params, opt_state, loss, _, _ = train_step(
                model, optimizer, ddp, params, opt_state,
                torch.from_numpy(x).to(device), torch.from_numpy(y)
                .to(device), norm)
        float(loss)
    maybe_print(f"profiled {args.prof} iterations; loss={float(loss):.4f}",
                rank0=True)
    return {"loss": float(loss)}


def main(argv=None):
    args = parse_args(argv)
    initialize_distributed("cuda")
    dev = resolve_device("cuda")
    rank, world = _world()
    maybe_print(f"device: {torch.cuda.get_device_name(dev)}, world size "
                f"{world}, arch {args.arch}, batch {args.b} per rank",
                rank0=True)
    out = train(args, device=dev)
    if "images_per_s" in out:
        meter = AverageMeter()
        for v in out["images_per_s"][1:]:
            meter.update(v)
        maybe_print(f"final: loss {out['losses'][-1]:.4f}, avg "
                    f"{meter.avg * world:.1f} images/s over {world} "
                    f"rank(s)", rank0=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
