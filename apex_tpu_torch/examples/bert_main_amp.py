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

``--grad-accum A`` splits a step's batch into A strided microbatches
(microbatch j is ``a[j::A]``): each one's scaled gradients are
unscaled into the stash (``unscale_grads(stashed=...,
update_scale=False)``), the scale is updated once from the ORed
overflow, and one ``apply_gradients`` runs, so an overflow in any
microbatch skips the whole step.  Microbatch j's dropout key is
``fold_in(step key, j)``.

Data parallel: one process per GPU, as the ImageNet twin, ``--b`` the
batch of each rank (the JAX example's ``--b`` is the global batch of
its mesh).  ``DistributedDataParallel.reduce_gradients`` averages the
gradients once a step (the stash under ``--grad-accum``, whose
overflow flag is ORed over the ranks too).  The MLM term divides by
the mask count of the whole global batch (all-reduced) times the world
size, so the average over the ranks is the loss of the global batch.
Start the ranks with ``python -m apex_tpu_torch.parallel.multiproc``;
rank r draws its batches from ``RandomState(r)``.

``--remat`` rematerialises each encoder layer in the backward
(``BertConfig.remat``), as the JAX example's flag does.

``--ring-attention SP`` (``--sp-attention {ring, ulysses}``, ring by
default as in the JAX example): sequence parallelism on a (world / SP,
SP) rank mesh.  Each rank of a sequence group holds S/SP of its data
index's tokens through the whole model (``BertForPreTraining(...,
sp=<sp group>)`` with ``parallel.make_ring_attention`` or
``make_ulysses_attention``).  Its objective is its positions' MLM sum
over the global batch's mask count (all-reduced over the data group)
over dp, plus, on sequence rank 0 alone, where the pooled ``[CLS]``
token lives, the NSP term; the loss of the batch is the objectives'
sum over the sequence group.  The params are replicated over the
sequence group: their gradients are summed over it and averaged over
the data group, as one ``DistributedDataParallel`` mean over the whole
world of each rank's objective times SP, and the overflow flag is
taken over the sequence group too.  A batch may carry a fifth array,
the (B, S) {0, 1} attention mask (the example's synthetic batches have
none).  Under ``--grad-accum A`` each slice's MLM term is over the mask
count of the whole batch (summed over the data group), as the JAX
example's ``make_accum_step`` divides it.

    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.bert_main_amp --ring-attention 2

``--pp S`` (``--pp-schedule {gpipe,1f1b}``, ``--pp-microbatches M``,
4 by default): the encoder pipelined over S ranks of a (world / S, S)
(data, pipe) mesh, ``models.PipelinedBert`` with one stage a rank and
the embeddings and heads on every rank; ``--b`` is the batch of each
data index, every rank of its pipe group draws it.  GPipe trains as the
dense step does (autograd through the pipeline).  1F1B takes
``loss_and_grad_1f1b``: each microbatch's loss is its MLM sum times ``M
* dp`` over the global mask count plus its mean NSP term over the
accumulation count, scaled by amp inside the schedule.  Under either
schedule one ``DistributedDataParallel.reduce_gradients`` averages the
data index's gradients over the data group.  Both run under
``--grad-accum`` and ``--remat``.  The recipe's ``FusedLAMB`` clips by
the norm over the whole model (``with_model_parallel`` over the pipe
group: each stage's leaves once, the replicated ones once) and amp's
overflow flag is taken over the pipe group.

``--pp S --ring-attention SP``: a (world / (SP * S), SP, S) (data, sp,
pipe) mesh, the JAX example's ``reshape(dp, sp, pp)``, and
``PipelinedBert(seq_axis="sp")`` with the sequence group's ring or
Ulysses attention: each rank of a (sp, pipe) group runs its S/SP tokens
through its stage.  GPipe's objective is the dense ``--ring-attention``
one (its positions' MLM sum, NSP on sequence rank 0), reduced by one
``DistributedDataParallel`` over the (data x sp) ranks of its pipe
index (the mesh's ``"data_sp"`` group); 1F1B (Ulysses only: ``--pp-schedule
1f1b`` with ring attention exits with the JAX example's message) gathers
each microbatch's hidden states over the sequence group before the
loss, and ``loss_and_grad_1f1b`` returns the gradients summed over it,
for the data group's mean.  The overflow flag is taken over the pipe
group alone, and so is the clipping norm: both read gradients already
whole on every sequence and data rank.

    WORLD_SIZE=4 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.bert_main_amp --pp 2 \\
        --ring-attention 2 --sp-attention ulysses --pp-schedule 1f1b

``--moe E`` (``--moe-dispatch {dense,capacity}``,
``--moe-capacity-factor``): each layer's MLP a Switch-MoE of E experts
(``models.MoEMlp``), the objective ``mlm + nsp/div + 0.01 * aux/div``
as the JAX example's, aux the model's sum of the layers' load-balance
aux.  It composes with dp, ``--grad-accum``, ``--remat``, ``--pp``
(under 1F1B the aux joins each microbatch's loss at the last stage with
the weight ``(0.01/div) * loss scale``: it never reaches amp's scaling
of the microbatch loss) and ``--ring-attention`` (under ``--pp`` GPipe
only; ``PipelinedBert`` refuses sequence parallelism with MoE under
1F1B, as the JAX model does).  The aux is the whole batch's statistic
as the JAX example's is (its mean over the data-sharded global batch):
the dense model averages each layer's token fractions over the ranks
that share the step (the data group, under ``--ring-attention`` the
(data x sp) ranks; ``moe_aux_group``), so the ranks' mean aux is the
global one, value and gradient; a sequence rank's share of it is its
aux over SP.  The capacity dispatch's cap and arrival order are the
whole batch's over the same ranks, as GSPMD's cumsum over the global
batch gives them.  A pipelined model keeps the JAX pipeline's rule, the
mean of per-(data index, microbatch) estimates (the capacity
dispatch's cap and order per (data index, microbatch) too), averaged over the sequence group under ``--ring-attention``
(GPipe: sequence rank 0's objective takes the term, as it takes NSP).

    python -m apex_tpu_torch.examples.bert_main_amp --config large \\
        --moe 8 --moe-dispatch capacity --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import types
from functools import partial
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models import BertConfig, BertForPreTraining, \
    PipelinedBert, bert_base, bert_large
from apex_tpu_torch.ops import threefry
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.parallel import DistributedDataParallel, ProcessGroup, \
    create_mesh, make_ring_attention, make_ulysses_attention, psum_g
from apex_tpu_torch.parallel.multiproc import initialize_distributed
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


def batch_loss(mlm_logits, nsp_logits, labels, weights, nsp, denom=None,
               nsp_div: float = 1.0):
    """MLM cross entropy weighted by the mask positions over ``denom``
    (default: their count, at least 1), plus the mean NSP cross entropy
    over ``nsp_div``, in fp32."""
    v = mlm_logits.shape[-1]
    mlm = F.cross_entropy(mlm_logits.float().reshape(-1, v),
                          labels.reshape(-1).long(), reduction="none")
    if denom is None:
        denom = weights.sum().clamp_min(1.0)
    mlm_loss = (mlm * weights.reshape(-1)).sum() / denom
    nsp_loss = F.cross_entropy(nsp_logits.float(), nsp.long())
    if nsp_div != 1.0:
        nsp_loss = nsp_loss / nsp_div
    return mlm_loss + nsp_loss


#: the load-balance aux's weight in the objective (the JAX example's)
AUX_WEIGHT = 0.01


def _outputs(out):
    """``(mlm, nsp, aux)`` of a model's forward (aux 0 without MoE
    layers)."""
    return out if len(out) == 3 else (*out, 0.0)


def _world(ddp) -> int:
    if ddp is None or not dist.is_initialized():
        return 1
    return ddp.process_group.size()


def mlm_denom(weights, ddp=None):
    """This rank's MLM divisor: the global batch's mask count (at least
    1) over the world size, so the ranks' average loss is the global
    batch's."""
    count = weights.sum()
    world = _world(ddp)
    if world > 1:
        dist.all_reduce(count, group=ddp.process_group.handle)
    denom = count.clamp_min(1.0)
    return denom / world if world > 1 else denom


def _any_rank(flag, ddp):
    """``flag`` ORed over the ranks (a device bool; no host sync)."""
    if _world(ddp) == 1:
        return flag
    count = flag.to(torch.int32)
    dist.all_reduce(count, group=ddp.process_group.handle)
    return count > 0


def _no_lamb_adaptation(name: str) -> bool:
    return "bias" in name or "_ln" in name


def make_optimizer(lr: float = 1e-4, max_grad_norm: float = 1.0):
    """The BERT recipe: bias/LayerNorm params take no weight decay (a
    param group) and no layer adaptation (trust ratio 1.0)."""
    return FusedLAMB(
        lr=lr, max_grad_norm=max_grad_norm,
        param_groups=[{"match": r"(bias|_ln)", "weight_decay": 0.0}],
        exclude_from_layer_adaptation=_no_lamb_adaptation)


def _sp(mesh) -> int:
    return mesh.shape["sp"] if mesh is not None else 1


def build(cfg: BertConfig, *, lr: float = 1e-4, max_grad_norm: float = 1.0,
          opt_level: str = "O2", loss_scale=None,
          attention_fn: Optional[Callable] = None, device="cuda",
          seed: int = 0,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          mesh=None, sp_attention: str = "ring",
          pp_microbatches: Optional[int] = None,
          moe_aux_group: Optional[ProcessGroup] = None):
    """(model, optimizer, params, opt_state): BertForPreTraining under
    ``amp.initialize`` with the recipe's FusedLAMB; weights from
    ``seed`` or, when given, ``state_dict`` (e.g. from
    ``models.bert.params_from_jax``).  ``mesh`` (a ``parallel.Mesh``)
    whose sequence axis is above 1 builds the sequence-parallel model
    with ``sp_attention`` (``"ring"`` or ``"ulysses"``, in place of
    ``attention_fn``) and takes the overflow flag over the sequence
    group.  ``pp_microbatches`` builds this rank's ``PipelinedBert`` on
    ``mesh``'s pipe axis (``state_dict`` then this rank's, e.g. from
    ``models.bert.dense_to_rank``; ``seed`` gives the dense model's
    weights, this rank's part), the optimizer's clipping norm and
    overflow flag over the pipe group; with a sequence axis above 1 as
    well, ``seq_axis="sp"`` with ``sp_attention``.  ``moe_aux_group``:
    the dense model's MoE token fractions averaged over it (the ranks
    that share a step; module docstring); under a sequence axis above 1
    it defaults to the mesh's ``"data_sp"`` group."""
    dev = resolve_device(device)
    sp = _sp(mesh) > 1
    if sp:
        make = {"ring": make_ring_attention,
                "ulysses": make_ulysses_attention}[sp_attention]
        attention_fn = make(mesh.group("sp"))
    if pp_microbatches is not None:
        return _build_pipelined(cfg, lr, max_grad_norm, opt_level,
                                loss_scale, attention_fn, dev, seed,
                                state_dict, mesh, pp_microbatches, sp)
    if sp and moe_aux_group is None:
        moe_aux_group = mesh.group("data_sp")
    module = BertForPreTraining(
        cfg, attention_fn=attention_fn, device=dev,
        seed=None if state_dict is not None else seed,
        sp=mesh.group("sp") if sp else None, moe_aux_group=moe_aux_group)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    # amp's default verbosity, as the JAX example: the option report
    model, optimizer = amp.initialize(
        module, make_optimizer(lr, max_grad_norm), opt_level=opt_level,
        loss_scale=loss_scale)
    if sp:
        optimizer = optimizer.with_overflow_groups(mesh.group("sp"))
    params = model.init()
    return model, optimizer, params, optimizer.init(params)


def _build_pipelined(cfg, lr, max_grad_norm, opt_level, loss_scale,
                     attention_fn, dev, seed, state_dict, mesh, microbatches,
                     sp):
    pp = mesh.shape["pipe"]
    module = PipelinedBert(cfg, mesh, pp, microbatches, batch_axis="data",
                           seq_axis="sp" if sp else None,
                           attention_fn=attention_fn, device=dev,
                           seed=None if state_dict is not None else seed)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    pipe = mesh.group("pipe")
    lamb = make_optimizer(lr, max_grad_norm).with_model_parallel(
        pipe, {name: name.startswith("stages.")
               for name, _ in module.named_parameters()})
    model, optimizer = amp.initialize(module, lamb, opt_level=opt_level,
                                      loss_scale=loss_scale)
    # only the pipe group: the flag is read from gradients that are
    # already equal over sp and data (reduced over data_sp under GPipe;
    # summed over sp inside loss_and_grad_1f1b, then meaned over data,
    # under 1F1B), and _accum_step ORs its flag over the ddp group
    optimizer = optimizer.with_overflow_groups(pipe)
    params = model.init()
    return model, optimizer, params, optimizer.init(params)


def step_key(seed: int, step: int) -> threefry.Key:
    """Step ``step``'s dropout key: ``fold_in(PRNGKey(seed), step)``."""
    return threefry.fold_in(threefry.PRNGKey(seed), step)


def _sp_objective(model, params, batch, mesh, deterministic, dropout_key,
                  denom, nsp_div: float = 1.0):
    """A sequence-parallel rank's objective (module docstring) on its
    slice of the data index's whole ``batch``: its positions' MLM sum
    over ``denom`` (:func:`mlm_denom`: the global batch's mask count
    over dp) plus, on sequence rank 0, the NSP term over ``nsp_div``.  A
    pipelined model takes the whole batch and slices its tokens
    itself.  With MoE layers the aux term over ``nsp_div``: a dense
    rank's aux over SP, a pipelined model's (the sequence group's mean)
    on sequence rank 0."""
    ids, labels, weights, nsp, *mask = batch
    n_sp, r = _sp(mesh), mesh.index("sp")
    s_local = ids.shape[1] // n_sp

    def mine(a):
        return a[:, r * s_local:(r + 1) * s_local]

    whole = mesh.shape["pipe"] > 1
    mlm_logits, nsp_logits, aux = _outputs(model.apply(
        params, ids if whole else mine(ids),
        (mask[0] if whole else mine(mask[0])) if mask else None,
        deterministic=deterministic, dropout_key=dropout_key))
    v = mlm_logits.shape[-1]
    mlm = F.cross_entropy(mlm_logits.float().reshape(-1, v),
                          mine(labels).reshape(-1).long(), reduction="none")
    objective = (mlm * mine(weights).reshape(-1)).sum() / denom
    aux = AUX_WEIGHT * aux / nsp_div
    if not whole:
        # a dense rank's aux is its share of the global statistic
        objective, aux = objective + aux / n_sp, 0.0
    if r == 0:
        # the pooled [CLS] token lives on sequence rank 0; a pipelined
        # model's aux (the sequence group's mean) counts there, once
        return objective + aux + F.cross_entropy(nsp_logits.float(),
                                                 nsp.long()) / nsp_div
    return objective + 0.0 * nsp_logits.sum() + 0.0 * aux


def _sp_grads(model, params, opt_state, batch, denom, nsp_div,
              deterministic, dropout_key, *, mesh):
    """The sequence-parallel step's loss and gradients on ``batch`` (a
    grad-accumulation slice, or the whole batch): the data index's loss
    (the shards' sum over the sequence group, unscaled) and the scaled
    gradients of the rank's objective times the group's size (``ddp``
    then averages them over the (data x sp) ranks)."""
    shard = _sp_objective(model, params, batch, mesh, deterministic,
                          dropout_key, denom, nsp_div)
    with amp.scale_loss(shard * _sp(mesh), opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    with torch.no_grad():
        loss = psum_g(shard.detach(), mesh.group("sp"))
    return loss, dict(zip(params.keys(), grads))


def train_step(model, optimizer, params: Dict[str, torch.Tensor], opt_state,
               batch, *, deterministic: bool = True, dropout_key=None,
               grad_accum: int = 1, ddp=None, mesh=None,
               schedule: Optional[str] = None):
    """One step of the JAX example's ``train_step`` (``grad_accum`` 1) or
    of its grad-accumulation step: loss, scaled gradients, the optimizer.
    ``batch`` is ``(ids, labels, weights, nsp)`` on the device, or with a
    fifth array, the (B, S) attention mask; ``dropout_key`` (a threefry
    key, e.g. :func:`step_key`) keys the step's dropout when
    ``deterministic`` is False; ``ddp`` (a ``DistributedDataParallel``)
    averages the gradients over the ranks.  With a sequence-parallel
    ``mesh`` the batch is the data index's whole batch and ``ddp`` must
    average over the mesh's ``"data_sp"`` group (module docstring; the
    data group under 1F1B).  Returns
    ``(params, opt_state, loss, grads)``: the loss unscaled (this rank's;
    under SP the data index's), the grads as autograd gave them (scaled)
    for ``grad_accum`` 1, else the unscaled stash.  ``schedule`` (a
    pipelined model's ``"gpipe"`` or ``"1f1b"``): ``ddp`` averages over
    the data group; GPipe steps as above, 1F1B through
    ``loss_and_grad_1f1b`` (module docstring)."""
    if schedule == "1f1b":
        slice_grads = partial(_onef1b_grads, optimizer=optimizer)
        if grad_accum > 1:
            return _accum_step(model, optimizer, params, opt_state, batch,
                               grad_accum, deterministic, dropout_key, ddp,
                               slice_grads)
        ids, labels, weights, nsp, *mask = batch
        loss, grads = slice_grads(model, params, opt_state, batch,
                                  mlm_denom(weights, ddp), 1.0,
                                  deterministic, dropout_key)
        if ddp is not None:
            grads = ddp.reduce_gradients(grads)
        params, opt_state = optimizer.step(params, grads, opt_state)
        return params, opt_state, loss, grads
    if grad_accum > 1:
        return _accum_step(model, optimizer, params, opt_state, batch,
                           grad_accum, deterministic, dropout_key, ddp,
                           partial(_sp_grads, mesh=mesh)
                           if _sp(mesh) > 1 else None)
    if _sp(mesh) > 1:
        loss, grads = _sp_grads(model, params, opt_state, batch,
                                mlm_denom(batch[2], ddp), 1.0, deterministic,
                                dropout_key, mesh=mesh)
    else:
        ids, labels, weights, nsp, *mask = batch
        mlm_logits, nsp_logits, aux = _outputs(model.apply(
            params, ids, mask[0] if mask else None,
            deterministic=deterministic, dropout_key=dropout_key))
        denom = None if ddp is None else mlm_denom(weights, ddp)
        loss = batch_loss(mlm_logits, nsp_logits, labels, weights, nsp,
                          denom) + AUX_WEIGHT * aux
        with amp.scale_loss(loss, opt_state) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()))
        grads = dict(zip(params.keys(), grads))
    if ddp is not None:
        grads = ddp.reduce_gradients(grads)
    params, opt_state = optimizer.step(params, grads, opt_state)
    return params, opt_state, loss.detach(), grads


def _autodiff_grads(model, params, opt_state, batch, denom, nsp_div,
                    deterministic, dropout_key):
    """One microbatch's loss (unscaled) and scaled gradients through
    autograd."""
    ids, labels, w, nsp = batch[:4]
    mlm_logits, nsp_logits, aux = _outputs(model.apply(
        params, ids, deterministic=deterministic, dropout_key=dropout_key))
    loss = batch_loss(mlm_logits, nsp_logits, labels, w, nsp, denom,
                      nsp_div) + AUX_WEIGHT * aux / nsp_div
    with amp.scale_loss(loss, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    return loss.detach(), dict(zip(params.keys(), grads))


def _onef1b_grads(model, params, opt_state, batch, denom, nsp_div,
                  deterministic, dropout_key, *, optimizer):
    """A pipelined model's 1F1B pass over ``batch``: each microbatch's
    MLM sum times M over ``denom`` (this rank's divisor, the global mask
    count over dp) plus its mean NSP term over ``nsp_div``, scaled by
    amp; with MoE layers the aux joins at the last stage weighted
    ``(0.01 / nsp_div) * loss scale`` (amp's scaling never reaches it);
    returns this data index's loss (unscaled) and scaled gradients."""
    ids, labels, weights, nsp, *mask = batch
    m = model.module.num_microbatches

    def mb_loss(mlm_logits, nsp_logits, tgt):
        v = mlm_logits.shape[-1]
        ce = F.cross_entropy(mlm_logits.float().reshape(-1, v),
                             tgt["labels"].reshape(-1).long(),
                             reduction="none")
        mlm = (ce * tgt["weights"].reshape(-1)).sum() * m / denom
        nsp_loss = F.cross_entropy(nsp_logits.float(), tgt["nsp"].long())
        if nsp_div != 1.0:
            nsp_loss = nsp_loss / nsp_div
        return amp.scale(mlm + nsp_loss, opt_state)

    aux_w = 0.0
    if model.module.cfg.moe_experts:
        aux_w = (AUX_WEIGHT / nsp_div) * optimizer.loss_scale(opt_state)
    loss, grads = model.loss_and_grad_1f1b(
        params, ids, mb_loss, {"labels": labels, "weights": weights,
                               "nsp": nsp},
        attention_mask=mask[0] if mask else None,
        deterministic=deterministic, dropout_key=dropout_key,
        moe_aux_weight=aux_w)
    return loss / optimizer.loss_scale(opt_state), grads


def _accum_step(model, optimizer, params, opt_state, batch, accum,
                deterministic, dropout_key, ddp, slice_grads=None):
    """The grad-accumulation step: microbatch j is ``a[j::accum]``, its
    MLM term over the whole batch's divisor and its NSP term over
    ``accum``; each microbatch's grads are unscaled into the stash with
    the scale held, then the stash is reduced over the ranks, the scale
    updated once from the ORed overflow and one update applied.
    ``slice_grads`` (1F1B's) gives a microbatch's loss and grads in
    place of autograd's."""
    weights = batch[2]
    # the whole batch's mask count (over the ranks), every slice's divisor
    denom = mlm_denom(weights, ddp)
    stashed, overflow, total = None, None, None
    for j in range(accum):
        key = None if dropout_key is None \
            else threefry.fold_in(dropout_key, j)
        loss, grads = (slice_grads or _autodiff_grads)(
            model, params, opt_state, tuple(a[j::accum] for a in batch),
            denom, float(accum), deterministic, key)
        stashed, ovf, opt_state = optimizer.unscale_grads(
            grads, opt_state, stashed=stashed, update_scale=False)
        overflow = ovf if overflow is None else overflow | ovf
        total = loss if total is None else total + loss
    if ddp is not None:
        stashed = ddp.reduce_gradients(stashed)
        overflow = _any_rank(overflow, ddp)
    opt_state = optimizer.update_scale(opt_state, overflow)
    params, opt_state = optimizer.apply_gradients(params, stashed, opt_state,
                                                  overflow)
    return params, opt_state, total, stashed


def batches(cfg: BertConfig, batch: int, seq_len: int,
            mask_prob: float = 0.15, seed: int = 0):
    """The example's batch stream: ``synthetic_mlm_batch`` on
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    args = types.SimpleNamespace(b=batch, seq_len=seq_len,
                                 mask_prob=mask_prob)
    while True:
        yield synthetic_mlm_batch(rng, args, cfg)


def check_grad_accum(batch: int, accum: int) -> None:
    """The JAX example's checks of ``--grad-accum``."""
    if accum < 1:
        raise SystemExit(f"--grad-accum must be >= 1, got {accum}")
    if batch % accum:
        raise SystemExit(f"batch {batch} must divide by --grad-accum "
                         f"{accum}")


def check_pipeline(cfg: BertConfig, batch: int, accum: int, pp: int,
                   schedule: str, microbatches: int, sp: int,
                   world: int, seq_len: int, sp_attention: str) -> None:
    """The JAX example's checks of ``--pp`` (with ``--ring-attention``
    ``sp``), in its order and with its messages, the world size in
    place of its device count; and, before any rank starts, the refusal
    ``PipelinedBert.loss_and_grad_1f1b`` gives MoE with a sequence
    axis."""
    if pp and sp:
        if world % (sp * pp) or seq_len % sp or \
                cfg.num_hidden_layers % pp:
            raise SystemExit(
                f"SP={sp} x PP={pp} must divide devices ({world}), SP "
                f"the seq len ({seq_len}), PP the layers "
                f"({cfg.num_hidden_layers})")
    elif pp and (world % pp or cfg.num_hidden_layers % pp):
        raise SystemExit(f"PP={pp} must divide devices ({world}) and "
                         f"layers ({cfg.num_hidden_layers})")
    if schedule == "1f1b" and not pp:
        raise SystemExit("--pp-schedule 1f1b needs --pp S")
    if pp and schedule == "1f1b" and sp and sp_attention == "ring":
        raise SystemExit(
            "--pp-schedule 1f1b cannot host ring attention (its "
            "collective-carrying scan miscompiles in the schedule's "
            "branches — tools/repro_ring_1f1b.py); use "
            "--sp-attention ulysses or the gpipe schedule")
    if pp and schedule == "1f1b" and sp and cfg.moe_experts:
        # the JAX example meets PipelinedBert's refusal at its first step
        raise SystemExit(
            "seq_axis + MoE under 1F1B: the sp-local aux estimate breaks "
            "the loss/grad reduction algebra; use the GPipe apply() path")
    if not pp:
        return
    per_call = batch // max(accum, 1)
    if per_call % microbatches:
        raise SystemExit(
            f"per-data-shard batch {per_call} (b/grad_accum) must divide "
            f"into --pp-microbatches {microbatches}")


def train(cfg: BertConfig, *, batch: int = 32, seq_len: int = 128,
          steps: int = 30, lr: float = 1e-4, max_grad_norm: float = 1.0,
          opt_level: str = "O2", loss_scale=None, mask_prob: float = 0.15,
          attention_fn: Optional[Callable] = None,
          deterministic: bool = True, seed: int = 0, device="cuda",
          print_freq: int = 0, grad_accum: int = 1, ddp: bool = False,
          data: Optional[Iterator] = None, remat: bool = False,
          sp: int = 0, sp_attention: str = "ring", pp: int = 0,
          pp_schedule: str = "gpipe", pp_microbatches: int = 4) -> dict:
    """Train ``steps`` steps of ``batch`` rows on this rank; returns
    per-step ``losses`` (this rank's) and ``step_seconds`` (host clock
    around each step, ended by reading the loss), ``tokens_per_s`` per
    step (this rank's), the final scaler state (``loss_scale``,
    ``skipped_steps``, ``applied_steps``) and ``params``.  Dropout
    (``deterministic=False``) takes step i's key from :func:`step_key`
    ``(seed, i)``.  ``ddp`` averages the gradients over the ranks of the
    default process group (parameters start as rank 0's); ``data``
    (host batches) defaults to :func:`batches` from ``RandomState(rank)``.
    ``remat`` rematerialises each encoder layer in the backward.
    ``sp`` above 1: sequence parallelism over ``sp`` ranks of the
    initialized world with ``sp_attention`` (module docstring); each
    rank takes its data index's whole batch (``data`` defaults to
    ``RandomState(data index)``), the gradients always go through
    ``DistributedDataParallel`` (over the mesh's ``"data_sp"`` group),
    and ``tokens_per_s`` counts the batch's tokens.  ``pp`` above 0: the
    encoder pipelined over ``pp`` ranks of the initialized world with
    ``pp_schedule`` and ``pp_microbatches`` (module docstring), with
    ``sp`` inside it when both are given; each pipe group takes its
    data index's batch (``data`` as under ``sp``), ``losses`` are the
    data index's and ``tokens_per_s`` counts its batch's tokens.  A
    ``cfg`` with ``moe_experts`` trains the MoE model (module
    docstring); under ``ddp`` its aux's token fractions are averaged
    over the default group."""
    dev = resolve_device(device)
    check_grad_accum(batch, grad_accum)
    check_pipeline(cfg, batch, grad_accum, pp, pp_schedule, pp_microbatches,
                   sp, dist.get_world_size() if dist.is_initialized() else 1,
                   seq_len, sp_attention)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
    mesh = None
    if sp > 1 and seq_len % sp:
        raise ValueError(f"sp {sp} must divide seq_len {seq_len}")
    if pp or sp > 1:
        mesh = create_mesh(sp=max(sp, 1), pp=max(pp, 1))
    aux_group = None
    if mesh is None and ddp and dist.is_initialized():
        aux_group = ProcessGroup()
    model, optimizer, params, opt_state = build(
        cfg, lr=lr, max_grad_norm=max_grad_norm, opt_level=opt_level,
        loss_scale=loss_scale, attention_fn=attention_fn, device=dev,
        seed=seed, mesh=mesh, sp_attention=sp_attention,
        pp_microbatches=pp_microbatches if pp else None,
        moe_aux_group=aux_group)
    schedule = pp_schedule if pp else None
    if mesh is not None:
        # the pipe and sequence groups' ranks hold one data index's batch;
        # DDP averages over the data group (replicated parts already
        # agree, 1F1B's gradients come summed over the sequence group),
        # else over the (data x sp) ranks, of each rank's objective
        # times sp
        group = "data" if sp <= 1 or schedule == "1f1b" else "data_sp"
        wrapper = DistributedDataParallel(model,
                                          process_group=mesh.group(group))
        rank = mesh.index("data")
    else:
        wrapper = DistributedDataParallel(model) if ddp else None
        rank = dist.get_rank() if dist.is_initialized() else 0
    if wrapper is not None and _world(wrapper) > 1:
        params = wrapper.broadcast_params(params)
    losses, seconds = [], []
    meter = AverageMeter()
    if data is None:
        data = batches(cfg, batch, seq_len, mask_prob, seed=rank)
    for step in range(steps):
        host = next(data)
        t0 = time.perf_counter()
        tensors = tuple(torch.from_numpy(a).to(dev) for a in host)
        params, opt_state, loss, _ = train_step(
            model, optimizer, params, opt_state, tensors,
            deterministic=deterministic,
            dropout_key=None if deterministic else step_key(seed, step),
            grad_accum=grad_accum, ddp=wrapper, mesh=mesh,
            schedule=schedule)
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
            "applied_steps": int(opt_state.applied_steps),
            "params": params}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BERT pretraining "
                                "(PyTorch/CUDA port)")
    p.add_argument("--config", default="base", choices=["base", "large",
                                                        "tiny"])
    p.add_argument("--b", "--batch-size", type=int, default=32, dest="b",
                   help="batch of each rank")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--print-freq", type=int, default=5)
    p.add_argument("--grad-accum", type=int, default=1, metavar="A",
                   help="accumulate grads over A microbatches a step (amp's "
                   "unscale-with-stashed protocol; an overflow in any "
                   "microbatch skips the whole update)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder layers in the backward")
    p.add_argument("--ring-attention", type=int, default=0, metavar="SP",
                   help="sequence parallelism over SP ranks (a (world / "
                   "SP, SP) mesh; SP must divide the world and --seq-len)")
    p.add_argument("--sp-attention", default="ring",
                   choices=("ring", "ulysses"),
                   help="the sequence-parallel attention under "
                   "--ring-attention: ring (K/V rotation) or ulysses "
                   "(all-to-all head scatter)")
    p.add_argument("--moe", type=int, default=0, metavar="E",
                   help="replace each layer's MLP with a Switch-MoE of E "
                   "experts (the load-balance aux joins the loss)")
    p.add_argument("--moe-dispatch", default="dense",
                   choices=["dense", "capacity"],
                   help="MoE dispatch: dense (exact, E x FLOPs) or "
                   "capacity (Switch capacity-factor gather/scatter; "
                   "tokens past capacity ride the residual)")
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--pp", type=int, default=0, metavar="S",
                   help="pipeline the encoder over S stages on a (data, "
                   "pipe) mesh (models.PipelinedBert); S must divide the "
                   "world size and the layer count")
    p.add_argument("--pp-schedule", default="gpipe",
                   choices=("gpipe", "1f1b"),
                   help="pipeline schedule under --pp: gpipe (autograd "
                   "through the ticks) or 1f1b (interleaved forward and "
                   "backward, saved stage inputs bounded by the stage "
                   "count)")
    p.add_argument("--pp-microbatches", type=int, default=4, metavar="M",
                   help="microbatches a step under --pp (bubble fraction "
                   "(S-1)/(M+S-1))")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    check_grad_accum(args.b, args.grad_accum)
    cfg = dataclasses.replace(get_config(args.config), moe_experts=args.moe,
                              moe_dispatch=args.moe_dispatch,
                              moe_capacity_factor=args.moe_capacity_factor)
    check_pipeline(cfg, args.b, args.grad_accum, args.pp, args.pp_schedule,
                   args.pp_microbatches, args.ring_attention,
                   int(os.environ.get("WORLD_SIZE", "1")), args.seq_len,
                   args.sp_attention)
    initialize_distributed("cuda")
    dev = resolve_device("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    sp = max(args.ring_attention, 1)
    if world % sp or args.seq_len % sp:
        raise SystemExit(f"SP={sp} must divide the world size ({world}) "
                         f"and --seq-len ({args.seq_len})")
    dp = world // (sp * max(args.pp, 1))
    maybe_print(f"device: {torch.cuda.get_device_name(dev)}, config: "
                f"{args.config}, world size {world} (dp={dp}, sp={sp}, "
                f"pp={max(args.pp, 1)}), batch {args.b} per data index, "
                f"grad-accum {args.grad_accum}, remat {args.remat}, moe "
                f"{args.moe}",
                rank0=True)
    out = train(cfg, batch=args.b, seq_len=args.seq_len, steps=args.steps,
                lr=args.lr, max_grad_norm=args.max_grad_norm,
                opt_level=args.opt_level, loss_scale=args.loss_scale,
                mask_prob=args.mask_prob, print_freq=args.print_freq,
                grad_accum=args.grad_accum, ddp=world > 1,
                remat=args.remat, sp=sp, sp_attention=args.sp_attention,
                pp=args.pp, pp_schedule=args.pp_schedule,
                pp_microbatches=args.pp_microbatches)
    meter = AverageMeter()
    for tps in out["tokens_per_s"][1:]:     # the first step warms up
        meter.update(tps)
    maybe_print(f"final: loss {out['losses'][-1]:.4f}, avg "
                f"{meter.avg * dp:.1f} tok/s over {world} rank(s)",
                rank0=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
