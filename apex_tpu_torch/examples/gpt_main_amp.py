"""Causal-LM training: GPT + causal flash attention + amp + FusedAdam.

Twin of ``examples/gpt/main_amp.py`` at its ``--flash`` path on one
device: next-token loss on synthetic token streams (uniform random ids
from ``numpy.random.RandomState(0)``, as the JAX example makes them),
attention through ``make_flash_attention(causal=True)``, amp O0-O3
with the dynamic loss scale, ``FusedAdam`` with the flat layout.  The
step is the JAX example's ``train_step`` with ``deterministic=True``
(no dropout); ``--remat`` rematerialises each block in the backward
(``GPTConfig.remat``), as the JAX example's flag does.

    python -m apex_tpu_torch.examples.gpt_main_amp --config small
    python -m apex_tpu_torch.examples.gpt_main_amp --config tiny \\
        --b 2 --seq-len 64 --steps 3          # needs a card as well

:func:`train` is the same loop as a function; it takes ``device="cpu"``
for a run on the plain PyTorch versions of the kernels, and
``deterministic=False`` for the model's dropout (0.1 hidden and 0.1
attention at GPT-2's configurations, attention dropout inside the
flash kernels), step i keyed ``fold_in(PRNGKey(seed), i)``
(``bert_main_amp.step_key``: the JAX example trains deterministically
and fixes no rule).

Data parallel: one process per GPU, as the ImageNet twin, ``--b`` the
batch of each rank (the JAX example's ``--b`` is the global batch of
its mesh); ``DistributedDataParallel.reduce_gradients`` averages the
gradients before ``optimizer.step``.  Start the ranks with ``python -m
apex_tpu_torch.parallel.multiproc``; the ranks of data index d draw
their batches from ``RandomState(d)``.

``--tp TP``: Megatron tensor parallelism on a (world / TP, TP) rank
mesh (``parallel.create_mesh``): the model's params split by
``parallel.gpt_tp_rules`` (``GPTLMHeadModel(..., tp=<model group>)``),
``FusedAdam(layout="tree")`` (B1-multi over the rank's leaves), the
vocab padded to a multiple of ``128 * TP`` (``models.padded_vocab``,
ids drawn from the true vocab) and ``ops.vocab_parallel_lm_loss``.
The JAX example takes the vocab-parallel loss only on the TPU or at
O0 (``examples/gpt/main_amp.py:60-66``: a half-precision limit of
XLA's CPU backend); the port has no such limit, so ``--tp`` always
takes it.  TP peers draw the same batches (seeded by the data index);
DDP averages over the data group only, and amp's overflow flag is
taken over the model group.  Each rank's ``--b`` rows are its data
index's batch.  At dp > 1 the moments are sharded over the data group
as the JAX example's ``shard_optimizer_state(like_params=params)``
places them (ZeRO-1 over the tree layout: ``FusedAdam.with_zero(...,
like_params=model.tp_places())``; ``build(zero=False)`` keeps them
whole).  ``main()`` runs NCCL (one rank a GPU); :func:`train` takes
whatever process group is initialized.

    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.gpt_main_amp --tp 2

``--sp SP`` (``--sp-attention {ring, ulysses}``, Ulysses by default as
in the JAX example): sequence parallelism on a (world / SP, SP) rank
mesh.  Each rank of a sequence group holds S/SP of its data index's
tokens through the whole model (``GPTLMHeadModel(..., sp=<sp group>)``
with ``parallel.make_ring_attention`` or ``make_ulysses_attention``,
causal); its loss is the sum of its positions' cross entropy
(``models.gpt.lm_loss_shard``: the next shard's first token labels its
last position) over ``B * (S - 1)``.  The params are replicated over
the sequence group: their gradients are summed over it and averaged
over the data group, as one ``DistributedDataParallel`` mean over the
whole (data x sp) world of each rank's loss times SP; the overflow flag
is taken over the sequence group too.  Positions grow to ``--seq-len``
(``config``).

``--sp SP --tp TP`` compose on one (world / (SP * TP), SP, TP) mesh, as
the JAX example's: each rank runs its H/TP heads over its S/SP tokens
(``GPTLMHeadModel(..., tp=, sp=)``; Ulysses needs ``(H / TP) % SP ==
0``), and its loss is ``ops.vocab_parallel_lm_loss_shard``, the sum of
its positions' cross entropy from its (B, S/SP, V/TP) logits, over ``B *
(S - 1)``.  The gradients of a model index's ranks are reduced over the
(data x sp) ranks of that model index (the mesh's ``"data_sp"`` group),
never over the world, whose other model indices hold other shards; the
overflow flag is taken over the sequence and model groups, and at dp > 1
the moments are ZeRO-1 sharded over the data group as under ``--tp``.

    WORLD_SIZE=2 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.gpt_main_amp --sp 2
    WORLD_SIZE=4 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.gpt_main_amp --sp 2 --tp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.examples.bert_main_amp import step_key
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, gpt_medium, \
    gpt_small, lm_loss
from apex_tpu_torch.models.gpt import lm_loss_shard, padded_vocab
from apex_tpu_torch.ops import make_flash_attention, \
    vocab_parallel_lm_loss, vocab_parallel_lm_loss_shard
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import DistributedDataParallel, create_mesh, \
    gpt_tp_rules, make_ring_attention, make_ulysses_attention, psum_g, \
    shard_optimizer_state, shard_params
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.utils import AverageMeter, maybe_print


def config(name: str, seq_len: int) -> GPTConfig:
    """``--config`` as the JAX example reads it; positions grow to
    ``seq_len`` where the configuration has fewer."""
    cfg = {"small": gpt_small(), "medium": gpt_medium(),
           "tiny": GPTConfig(vocab_size=997, hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             intermediate_size=256,
                             max_position_embeddings=seq_len)}[name]
    if cfg.max_position_embeddings < seq_len:
        cfg = dataclasses.replace(cfg, max_position_embeddings=seq_len)
    return cfg


def batches(vocab: int, batch: int, seq_len: int,
            seed: int = 0) -> Iterator[np.ndarray]:
    rng = np.random.RandomState(seed)
    while True:
        yield rng.randint(0, vocab, (batch, seq_len)).astype(np.int32)


def _sp(mesh) -> int:
    return mesh.shape["sp"] if mesh is not None else 1


def build(cfg: GPTConfig, *, lr: float = 3e-4, opt_level: str = "O2",
          loss_scale=None, device="cuda", seed: int = 0,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          mesh=None, zero: bool = True, sp_attention: str = "ulysses"):
    """(model, optimizer, params, opt_state): the GPT with causal flash
    attention under ``amp.initialize`` with ``FusedAdam(lr)``; weights
    from ``seed`` or, when given, ``state_dict`` (e.g. from
    ``models.params_from_jax``; the full model's under TP, cut to this
    rank's part here).  ``mesh`` (a ``parallel.Mesh``) whose model axis
    is above 1 builds the tensor-parallel model, with
    ``FusedAdam(layout="tree")`` whose clipping norm is the model's and
    amp's overflow flag taken over the model group; its moments are
    sharded over a data axis above 1 unless ``zero`` is False (the flag
    then taken over the data group as well).  A sequence axis above 1
    builds the sequence-parallel model with ``sp_attention`` (``"ring"``
    or ``"ulysses"``) and the overflow flag taken over the sequence
    group."""
    dev = resolve_device(device)
    tp = mesh is not None and mesh.shape["model"] > 1
    sp = _sp(mesh) > 1
    if sp:
        make = {"ring": make_ring_attention,
                "ulysses": make_ulysses_attention}[sp_attention]
        attention_fn = make(mesh.group("sp"), causal=True)
    else:
        attention_fn = make_flash_attention(causal=True)
    module = GPTLMHeadModel(cfg, attention_fn=attention_fn, device=dev,
                            seed=None if state_dict is not None else seed,
                            tp=mesh.group("model") if tp else None,
                            sp=mesh.group("sp") if sp else None)
    if state_dict is not None:
        if tp:
            state_dict = shard_params(state_dict, mesh, gpt_tp_rules(),
                                      num_heads=cfg.num_attention_heads)
        module.load_state_dict(state_dict)
    inner = FusedAdam(lr=lr, layout="tree" if tp else "flat")
    if tp:
        inner = inner.with_model_parallel(
            mesh.group("model"),
            {name: bool(spec) for name, spec in module.tp_specs().items()})
    # amp's default verbosity, as the JAX example: the option report,
    # and maybe_print's step lines after it
    model, optimizer = amp.initialize(module, inner, opt_level=opt_level,
                                      loss_scale=loss_scale)
    if tp:
        optimizer = optimizer.with_overflow_groups(mesh.group("model"))
    if sp:
        optimizer = optimizer.with_overflow_groups(mesh.group("sp"))
    params = model.init()
    opt_state = optimizer.init(params)
    if tp and zero and mesh.shape["data"] > 1:
        # the shards of data peers must skip together: the flag over the
        # data group too (the JAX package's flag is global)
        places = module.tp_places()
        optimizer = optimizer.with_overflow_groups(
            mesh.group("data")).with_zero(mesh.group("data"),
                                          like_params=places)
        opt_state = opt_state._replace(inner=shard_optimizer_state(
            opt_state.inner, mesh.group("data"), like_params=places))
    return model, optimizer, params, opt_state


def train_step(model, optimizer, params: Dict[str, torch.Tensor], opt_state,
               ids: torch.Tensor, ddp=None, *, deterministic: bool = True,
               dropout_key=None, mesh=None, true_vocab=None):
    """One step of the JAX example's ``train_step``: loss, scaled
    gradients (averaged over the ranks by ``ddp``, a
    ``DistributedDataParallel``, when given), ``optimizer.step``;
    ``dropout_key`` (a threefry key) keys the dropout when
    ``deterministic`` is False.  With a tensor-parallel ``mesh`` the
    loss is ``ops.vocab_parallel_lm_loss`` over the model's final hidden
    states and its ``wte`` rows (``true_vocab`` the unpadded vocab).
    With a sequence-parallel one, ``ids`` is the data index's whole (B,
    S) batch: the model runs on this rank's tokens, the gradient is of
    its loss shard times the sequence group's size over ``B * (S - 1)``
    (``ddp``, over the mesh's ``"data_sp"`` group, averages them; under
    TP too the shard is ``ops.vocab_parallel_lm_loss_shard``'s) and the
    loss is the shards' sum over the group.  Returns ``(params,
    opt_state, loss, grads)`` with the loss unscaled (this rank's; under
    SP the batch's) and the grads as autograd gave them (scaled)."""
    n_sp = _sp(mesh)
    if n_sp > 1:
        r, s_local = mesh.index("sp"), ids.shape[1] // n_sp
        tp = mesh.shape["model"] > 1
        out = model.apply(params, ids[:, r * s_local:(r + 1) * s_local],
                          deterministic=deterministic,
                          dropout_key=dropout_key, return_hidden=tp)
        total = ids.shape[0] * (ids.shape[1] - 1)
        if tp:
            shard = vocab_parallel_lm_loss_shard(
                out, params["wte.weight"], ids, mesh, true_vocab=true_vocab)
        else:
            shard = lm_loss_shard(out, ids, r, n_sp)
        objective = shard * (n_sp / total)
        with torch.no_grad():
            loss = psum_g(shard.detach(), mesh.group("sp")) / total
    elif mesh is not None and mesh.shape["model"] > 1:
        hidden = model.apply(params, ids, deterministic=deterministic,
                             dropout_key=dropout_key, return_hidden=True)
        loss = objective = vocab_parallel_lm_loss(
            hidden, params["wte.weight"], ids, mesh, true_vocab=true_vocab)
    else:
        logits = model.apply(params, ids, deterministic=deterministic,
                             dropout_key=dropout_key)
        loss = objective = lm_loss(logits, ids)
    with amp.scale_loss(objective, opt_state) as scaled:
        grads = torch.autograd.grad(scaled, list(params.values()))
    grads = dict(zip(params.keys(), grads))
    if ddp is not None:
        grads = ddp.reduce_gradients(grads)
    params, opt_state = optimizer.step(params, grads, opt_state)
    return params, opt_state, loss.detach(), grads


def train(cfg: GPTConfig, *, batch: int = 8, seq_len: int = 1024,
          steps: int = 30, lr: float = 3e-4, opt_level: str = "O2",
          loss_scale=None, device="cuda", seed: int = 0,
          state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          print_freq: int = 0, ddp: bool = False,
          data: Optional[Iterator[np.ndarray]] = None, remat: bool = False,
          deterministic: bool = True, tp: int = 0, sp: int = 0,
          sp_attention: str = "ulysses") -> dict:
    """Train ``steps`` steps of ``batch`` rows on this rank; returns
    per-step ``losses`` (this rank's) and ``step_seconds`` (host clock
    around each step, ended by reading the loss), ``tokens_per_s`` per
    step (this rank's), the final scaler state (``loss_scale``,
    ``skipped_steps``, ``applied_steps``) and ``params``.  ``ddp``
    averages the gradients over the ranks of the default process group
    (parameters start as rank 0's); ``data`` (host batches of ids)
    defaults to :func:`batches` from ``RandomState(data index)``.
    ``remat`` rematerialises each block in the backward;
    ``deterministic=False`` trains with the model's dropout, step i keyed
    ``step_key(seed, i)``.  ``tp`` above 1: tensor parallelism over
    ``tp`` ranks of the initialized world (module docstring; with
    ``ddp`` the data group averages, the moments sharded over it at dp
    > 1), ``cfg`` the unpadded model and ``state_dict`` the full padded
    one.  ``sp`` above 1: sequence parallelism over ``sp``
    ranks with ``sp_attention`` (module docstring), beside ``tp`` or
    not; each rank takes its data index's whole batch and runs its
    tokens, the gradients always go through ``DistributedDataParallel``
    over the mesh's ``"data_sp"`` group (the world without ``tp``) and
    ``tokens_per_s`` counts the batch's tokens."""
    dev = resolve_device(device)
    if remat:
        cfg = dataclasses.replace(cfg, remat=True)
    check_sp_tp(cfg, max(tp, 1), max(sp, 1), sp_attention, ValueError)
    true_vocab, mesh, data_index = cfg.vocab_size, None, 0
    if tp > 1 or sp > 1:
        mesh = create_mesh(tp=max(tp, 1), sp=max(sp, 1))
        data_index = mesh.index("data")
    if sp > 1 and seq_len % sp:
        raise ValueError(f"sp {sp} must divide seq_len {seq_len}")
    if tp > 1:
        cfg = dataclasses.replace(cfg,
                                  vocab_size=padded_vocab(cfg.vocab_size, tp))
    elif mesh is None and dist.is_initialized():
        data_index = dist.get_rank()
    model, optimizer, params, opt_state = build(
        cfg, lr=lr, opt_level=opt_level, loss_scale=loss_scale, device=dev,
        seed=seed, state_dict=state_dict, mesh=mesh,
        sp_attention=sp_attention)
    wrapper = None
    if sp > 1:
        # each rank's loss times sp, averaged over the (data x sp) ranks
        # of its model index
        wrapper = DistributedDataParallel(
            model, process_group=mesh.group("data_sp"))
    elif ddp:
        wrapper = DistributedDataParallel(
            model, process_group=mesh.group("data") if mesh else None)
    if wrapper is not None and dist.is_initialized() \
            and wrapper.process_group.size() > 1:
        params = wrapper.broadcast_params(params)
    losses, seconds = [], []
    if data is None:
        data = batches(true_vocab, batch, seq_len, seed=data_index)
    for step in range(steps):
        ids = torch.from_numpy(next(data)).to(dev)
        t0 = time.perf_counter()
        params, opt_state, loss, _ = train_step(
            model, optimizer, params, opt_state, ids, wrapper,
            deterministic=deterministic,
            dropout_key=None if deterministic else step_key(seed, step),
            mesh=mesh, true_vocab=true_vocab)
        losses.append(float(loss))      # waits for the step to finish
        seconds.append(time.perf_counter() - t0)
        if print_freq and (step % print_freq == 0 or step == steps - 1):
            maybe_print(f"step {step:4d} loss {losses[-1]:8.4f} "
                        f"tok/s {batch * seq_len / seconds[-1]:12.1f}",
                        rank0=True)
    return {"losses": losses, "step_seconds": seconds,
            "tokens_per_s": [batch * seq_len / s for s in seconds],
            "loss_scale": float(optimizer.loss_scale(opt_state)),
            "skipped_steps": int(opt_state.skipped_steps),
            "applied_steps": int(opt_state.applied_steps),
            "params": params}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GPT causal-LM training "
                                "(PyTorch/CUDA port)")
    p.add_argument("--config", default="small",
                   choices=["small", "medium", "tiny"])
    p.add_argument("--b", "--batch-size", type=int, default=8, dest="b",
                   help="batch of each rank")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None)
    p.add_argument("--print-freq", type=int, default=5)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize each block in the backward")
    p.add_argument("--tp", type=int, default=0, metavar="TP",
                   help="Megatron tensor parallelism over TP-way model "
                   "groups (parallel.gpt_tp_rules, vocab-parallel loss)")
    p.add_argument("--sp", type=int, default=0, metavar="SP",
                   help="shard the sequence over SP-way sequence "
                   "parallelism (a (world / SP, SP) rank mesh)")
    p.add_argument("--sp-attention", default="ulysses",
                   choices=("ring", "ulysses"))
    return p.parse_args(argv)


def check_sp_tp(cfg: GPTConfig, tp: int, sp: int, sp_attention: str,
                error=SystemExit) -> None:
    """Ulysses over tensor-parallel heads: each of the ``tp`` ranks'
    ``H / tp`` heads must split over the ``sp`` ranks."""
    if sp > 1 and sp_attention == "ulysses" and \
            (cfg.num_attention_heads // tp) % sp:
        raise error(
            f"--sp-attention ulysses needs the {cfg.num_attention_heads} "
            f"heads / --tp {tp} to divide by --sp {sp} (a tensor-parallel "
            f"rank's {cfg.num_attention_heads // tp} heads are split over "
            "the sequence ranks)")


def main(argv=None):
    args = parse_args(argv)
    tp, sp = max(args.tp, 1), max(args.sp, 1)
    cfg = config(args.config, args.seq_len)
    check_sp_tp(cfg, tp, sp, args.sp_attention)
    initialize_distributed("cuda")
    dev = resolve_device("cuda")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % (tp * sp):
        raise SystemExit(f"--sp {args.sp} x --tp {args.tp} must divide the "
                         f"world size ({world})")
    if args.seq_len % sp:
        raise SystemExit(f"--sp {sp} must divide --seq-len "
                         f"({args.seq_len})")
    dp = world // (tp * sp)
    maybe_print(f"device: {torch.cuda.get_device_name(dev)}, config: "
                f"{args.config}, seq: {args.seq_len}, flash: True, remat: "
                f"{args.remat}, world size {world} (dp={dp}, sp={sp}, "
                f"tp={tp}), batch {args.b} per data index", rank0=True)
    out = train(cfg, batch=args.b, seq_len=args.seq_len, steps=args.steps,
                lr=args.lr, opt_level=args.opt_level,
                loss_scale=args.loss_scale, print_freq=args.print_freq,
                ddp=dp > 1, remat=args.remat, tp=tp, sp=sp,
                sp_attention=args.sp_attention)
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
