"""Minimal amp example: an MLP classifier under O0-O3 (O1 by default).

Twin of ``examples/simple/main_amp.py``: build the model,
``amp.initialize`` it with ``sgd(lr)`` (``optimizers.transforms``, the
optax twin), train with the ``scale_loss`` protocol.  The data is the
JAX example's synthetic gaussian clusters (``synthetic_data(8192, 784,
10)``), or a local MNIST ``.npz`` with ``--mnist-npz``; each epoch walks
a ``RandomState(epoch)`` permutation in batches of 256 and prints the
JAX example's line.

    python -m apex_tpu_torch.examples.simple_main_amp            # O1
    python -m apex_tpu_torch.examples.simple_main_amp --opt-level O2

:func:`train` is the same loop as a function; it takes ``device="cpu"``
for a run on the CPU.  The data goes to the device once; each step
gathers its batch there, and the losses are read back once an epoch.
"""

from __future__ import annotations

import argparse
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import MLP as _MLP
from apex_tpu_torch.optimizers import transforms
from apex_tpu_torch.utils import maybe_print


def MLP(hidden: int = 256, n_classes: int = 10, in_features: int = 784, *,
        device="cuda", seed: Optional[int] = 0):
    """The example's model: ``Dense_0`` (-> ``hidden``), ReLU,
    ``Dense_1`` (-> ``hidden``), ReLU, ``Dense_2`` (-> ``n_classes``),
    the JAX example's module names."""
    return _MLP(features=(hidden, hidden), num_classes=n_classes,
                in_features=in_features, device=device, seed=seed)


def synthetic_data(n, d, n_classes, seed=0):
    """The JAX example's data: ``n`` points of width ``d`` around
    ``n_classes`` gaussian centres (a copy, bit for bit)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, d) * 3
    y = rng.randint(0, n_classes, n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def load_data(mnist_npz: Optional[str] = None) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """``(x, y)``: MNIST's training split from ``mnist_npz`` (pixels
    scaled to [0, 1], flattened), else ``synthetic_data(8192, 784, 10)``."""
    if mnist_npz is None:
        return synthetic_data(8192, 784, 10)
    with np.load(mnist_npz) as z:
        x = z["x_train"].astype(np.float32) / 255.0
        y = z["y_train"].astype(np.int32)
    return x.reshape(x.shape[0], -1), y


def train_step(model, optimizer, params, opt_state, x, y):
    """The JAX example's ``train_step``: fp32 logits, the mean softmax
    cross entropy, scaled gradients, ``optimizer.step``.  Returns
    ``(params, opt_state, loss)`` with the loss unscaled."""
    logits = model.apply(params, x).float()
    loss = F.cross_entropy(logits, y.long())
    with amp.scale_loss(loss, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    params, opt_state = optimizer.step(params, dict(zip(params, grads)),
                                       opt_state)
    return params, opt_state, loss.detach()


def train(opt_level: str = "O1", *, epochs: int = 5, batch_size: int = 256,
          lr: float = 0.05, loss_scale=None,
          data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          seed: int = 0, device="cuda") -> dict:
    """Train ``epochs`` epochs on ``data`` (default: the synthetic data);
    weights from ``seed`` or, when given, ``state_dict`` (e.g. from
    ``models.mlp_params_from_jax``).  Returns the per-step and per-epoch
    ``losses``, each epoch's ``seconds`` and ``samples_per_s`` (host
    clock, ended by reading the epoch's losses), and the final scaler
    state (``loss_scale``, ``skipped_steps``, ``applied_steps``)."""
    dev = resolve_device(device)
    x_np, y_np = load_data() if data is None else data
    n, d = x_np.shape[0], int(np.prod(x_np.shape[1:]))
    module = MLP(in_features=d, device=dev,
                 seed=None if state_dict is not None else seed)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    model, optimizer = amp.initialize(
        module, transforms.sgd(lr), opt_level=opt_level,
        loss_scale=loss_scale)
    params = model.init()
    opt_state = optimizer.init(params)
    x_all = torch.from_numpy(x_np.reshape(n, d)).to(dev)
    y_all = torch.from_numpy(y_np).to(dev)
    steps = n // batch_size
    step_losses, epoch_losses, seconds = [], [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        perm = torch.from_numpy(
            np.random.RandomState(epoch).permutation(n)).to(dev)
        losses = []
        for i in range(steps):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            params, opt_state, loss = train_step(
                model, optimizer, params, opt_state, x_all[idx], y_all[idx])
            losses.append(loss)
        losses = torch.stack(losses).tolist()   # waits for the epoch
        seconds.append(time.perf_counter() - t0)
        step_losses += losses
        epoch_losses.append(sum(losses) / steps)
        maybe_print(f"Epoch {epoch}: loss {epoch_losses[-1]:.4f}  Speed "
                    f"{steps * batch_size / seconds[-1]:.1f} samples/s  "
                    f"loss_scale "
                    f"{float(optimizer.loss_scale(opt_state)):.0f}",
                    rank0=True)
    return {"losses": step_losses, "epoch_losses": epoch_losses,
            "seconds": seconds,
            "samples_per_s": [steps * batch_size / s for s in seconds],
            "loss_scale": float(optimizer.loss_scale(opt_state)),
            "skipped_steps": int(opt_state.skipped_steps),
            "applied_steps": int(opt_state.applied_steps)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MLP classifier under amp "
                                "(PyTorch/CUDA port)")
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None,
                   help="'dynamic' or a float (string, passed through like "
                   "the reference examples)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--mnist-npz", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    train(args.opt_level, epochs=args.epochs, batch_size=args.batch_size,
          lr=args.lr, loss_scale=args.loss_scale,
          data=load_data(args.mnist_npz))


if __name__ == "__main__":
    main()
