"""BERT pretraining: BertForPreTraining + FusedLAMB + FusedLayerNorm + amp.

Twin of ``examples/bert/main_amp.py`` on one device: masked-LM + NSP
loss on the example's synthetic batches (``synthetic_mlm_batch``, from
``numpy.random.RandomState(0)``), amp O0-O3 with the dynamic loss
scale, and the BERT recipe's ``FusedLAMB``: no weight decay and no layer
adaptation for bias and LayerNorm parameters.  The CLI trains as the
JAX example does, ``deterministic=True`` with dot-product attention::

    python -m apex_tpu_torch.examples.bert_main_amp --config large \\
        --b 32 --seq-len 128 --steps 30

:func:`train` is the same loop as a function, with the model API's own
knobs besides: ``attention_fn`` (``make_flash_attention()`` for the
fused kernels) and ``deterministic=False`` for dropout (attention
dropout inside the flash kernels, hidden dropout through the threefry
dropout kernel, both keyed as flax keys them); ``device="cpu"`` runs
the plain PyTorch versions of the kernels.

Step keys: the JAX example trains deterministically and passes no
dropout rng (``examples/bert/main_amp.py``), so it fixes no rule for
one.  Here step ``i`` takes ``fold_in(PRNGKey(seed), i)``
(:func:`step_key`), the key a JAX caller would pass as
``rngs={"dropout": ...}`` to reproduce the step's dropout.

Not here: ``--ring-attention``/``--sp-attention``, ``--remat``,
``--moe``, ``--grad-accum``, ``--pp`` and the data-parallel mesh.
"""

from __future__ import annotations

import argparse
import time
import types
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import BertConfig, BertForPreTraining, \
    bert_base, bert_large
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.utils import AverageMeter, maybe_print


def get_config(name: str) -> BertConfig:
    """``--config`` as the JAX example reads it."""
    if name == "base":
        return bert_base()
    if name == "large":
        return bert_large()
    return BertConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=256,
                      max_position_embeddings=512)


def synthetic_mlm_batch(rng, args, cfg):
    """ids + mask positions + labels, the standard MLM setup (``args``
    carries ``b``, ``seq_len`` and ``mask_prob``)."""
    ids = rng.randint(4, cfg.vocab_size, (args.b, args.seq_len))
    labels = ids.copy()
    mask = rng.rand(args.b, args.seq_len) < args.mask_prob
    ids[mask] = 3  # [MASK]
    weights = mask.astype(np.float32)
    nsp = rng.randint(0, 2, (args.b,))
    return (ids.astype(np.int32), labels.astype(np.int32), weights,
            nsp.astype(np.int32))


def batch_loss(mlm_logits, nsp_logits, labels, weights, nsp):
    """MLM cross entropy weighted by the mask positions over their count
    (at least 1), plus the mean NSP cross entropy, in fp32."""
    v = mlm_logits.shape[-1]
    mlm = F.cross_entropy(mlm_logits.float().reshape(-1, v),
                          labels.reshape(-1).long(), reduction="none")
    denom = weights.sum().clamp_min(1.0)
    mlm_loss = (mlm * weights.reshape(-1)).sum() / denom
    nsp_loss = F.cross_entropy(nsp_logits.float(), nsp.long())
    return mlm_loss + nsp_loss


def _no_lamb_adaptation(name: str) -> bool:
    return "bias" in name or "_ln" in name


def make_optimizer(lr: float = 1e-4, max_grad_norm: float = 1.0):
    """The BERT recipe: bias/LayerNorm params take no weight decay (a
    param group) and no layer adaptation (trust ratio 1.0)."""
    return FusedLAMB(
        lr=lr, max_grad_norm=max_grad_norm,
        param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
        exclude_from_layer_adaptation=_no_lamb_adaptation)


def build(cfg: BertConfig, *, lr: float = 1e-4, max_grad_norm: float = 1.0,
          opt_level: str = "O2", loss_scale=None,
          attention_fn: Optional[Callable] = None, device="cuda",
          seed: int = 0,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None):
    """(model, optimizer, params, opt_state): BertForPreTraining under
    ``amp.initialize`` with the recipe's FusedLAMB; weights from
    ``seed`` or, when given, ``state_dict`` (e.g. from
    ``models.bert.params_from_jax``)."""
    dev = resolve_device(device)
    module = BertForPreTraining(
        cfg, attention_fn=attention_fn, device=dev,
        seed=None if state_dict is not None else seed)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    # amp's default verbosity, as the JAX example: the option report
    model, optimizer = amp.initialize(
        module, make_optimizer(lr, max_grad_norm), opt_level=opt_level,
        loss_scale=loss_scale)
    params = model.init()
    return model, optimizer, params, optimizer.init(params)


def step_key(seed: int, step: int) -> threefry.Key:
    """Step ``step``'s dropout key: ``fold_in(PRNGKey(seed), step)``."""
    return threefry.fold_in(threefry.PRNGKey(seed), step)


def train_step(model, optimizer, params: Dict[str, torch.Tensor], opt_state,
               batch, *, deterministic: bool = True, dropout_key=None):
    """One step of the JAX example's ``train_step``: loss, scaled
    gradients, ``optimizer.step``.  ``batch`` is ``(ids, labels,
    weights, nsp)`` on the device; ``dropout_key`` (a threefry key, e.g.
    :func:`step_key`) keys the step's dropout when ``deterministic`` is
    False.  Returns ``(params, opt_state, loss, grads)``, the loss
    unscaled and the grads as autograd gave them (scaled)."""
    ids, labels, weights, nsp = batch
    mlm_logits, nsp_logits = model.apply(params, ids,
                                         deterministic=deterministic,
                                         dropout_key=dropout_key)
    loss = batch_loss(mlm_logits, nsp_logits, labels, weights, nsp)
    with amp.scale_loss(loss, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    grads = dict(zip(params.keys(), grads))
    params, opt_state = optimizer.step(params, grads, opt_state)
    return params, opt_state, loss.detach(), grads


def batches(cfg: BertConfig, batch: int, seq_len: int,
            mask_prob: float = 0.15):
    """The example's batch stream: ``synthetic_mlm_batch`` on
    ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    args = types.SimpleNamespace(b=batch, seq_len=seq_len,
                                 mask_prob=mask_prob)
    while True:
        yield synthetic_mlm_batch(rng, args, cfg)


def train(cfg: BertConfig, *, batch: int = 32, seq_len: int = 128,
          steps: int = 30, lr: float = 1e-4, max_grad_norm: float = 1.0,
          opt_level: str = "O2", loss_scale=None, mask_prob: float = 0.15,
          attention_fn: Optional[Callable] = None,
          deterministic: bool = True, seed: int = 0, device="cuda",
          print_freq: int = 0) -> dict:
    """Train ``steps`` steps; returns per-step ``losses`` and
    ``step_seconds`` (host clock around each step, ended by reading the
    loss), ``tokens_per_s`` per step, and the final scaler state
    (``loss_scale``, ``skipped_steps``, ``applied_steps``).  Dropout
    (``deterministic=False``) takes step i's key from
    :func:`step_key` ``(seed, i)``."""
    dev = resolve_device(device)
    model, optimizer, params, opt_state = build(
        cfg, lr=lr, max_grad_norm=max_grad_norm, opt_level=opt_level,
        loss_scale=loss_scale, attention_fn=attention_fn, device=dev,
        seed=seed)
    losses, seconds = [], []
    meter = AverageMeter()
    data = batches(cfg, batch, seq_len, mask_prob)
    for step in range(steps):
        host = next(data)
        t0 = time.perf_counter()
        tensors = tuple(torch.from_numpy(a).to(dev) for a in host)
        params, opt_state, loss, _ = train_step(
            model, optimizer, params, opt_state, tensors,
            deterministic=deterministic,
            dropout_key=None if deterministic else step_key(seed, step))
        losses.append(float(loss))      # waits for the step to finish
        seconds.append(time.perf_counter() - t0)
        meter.update(losses[-1])
        if print_freq and (step % print_freq == 0 or step == steps - 1):
            maybe_print(
                f"step {step}/{steps}  Loss {losses[-1]:.4f} "
                f"({meter.avg:.4f})  Speed {batch / seconds[-1]:.1f} seq/s"
                f"  scale {float(optimizer.loss_scale(opt_state)):.0f}",
                rank0=True)
    return {"losses": losses, "step_seconds": seconds,
            "tokens_per_s": [batch * seq_len / s for s in seconds],
            "loss_scale": float(optimizer.loss_scale(opt_state)),
            "skipped_steps": int(opt_state.skipped_steps),
            "applied_steps": int(opt_state.applied_steps)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BERT pretraining "
                                "(PyTorch/CUDA port)")
    p.add_argument("--config", default="base", choices=["base", "large",
                                                        "tiny"])
    p.add_argument("--b", "--batch-size", type=int, default=32, dest="b")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--print-freq", type=int, default=5)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.config)
    dev = resolve_device("cuda")
    maybe_print(f"device: {torch.cuda.get_device_name(dev)}, config: "
                f"{args.config}", rank0=True)
    out = train(cfg, batch=args.b, seq_len=args.seq_len, steps=args.steps,
                lr=args.lr, max_grad_norm=args.max_grad_norm,
                opt_level=args.opt_level, loss_scale=args.loss_scale,
                mask_prob=args.mask_prob, print_freq=args.print_freq)
    meter = AverageMeter()
    for tps in out["tokens_per_s"][1:]:     # the first step warms up
        meter.update(tps)
    maybe_print(f"final: loss {out['losses'][-1]:.4f}, avg {meter.avg:.1f} "
                f"tok/s", rank0=True)


if __name__ == "__main__":
    main()
