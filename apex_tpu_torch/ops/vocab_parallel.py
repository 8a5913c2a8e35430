"""The vocab-parallel LM loss for a vocab-sharded tied head.

Twin of ``apex_tpu/ops/vocab_parallel.py``'s
:func:`vocab_parallel_lm_loss` (Megatron-LM's
``vocab_parallel_cross_entropy``).  Under ``parallel.gpt_tp_rules`` each
model rank holds the rows ``[m * V/n, (m + 1) * V/n)`` of the tied
``wte`` and computes only its (B, S, V/n) slice of the fp32 logits;
three (B, S) reductions over the model group give the loss, and the
full (B, S, V) logits are never built:

- the global max over the vocab (``parallel.pmax_g`` of the local max,
  detached: the stabilizer carries no gradient);
- the global exp-sum (``parallel.reduce_from_group`` of the local one);
- the target's logit (``reduce_from_group`` of the owning rank's pick).

Loss per token = log(exp-sum) + max - target logit.  The gradients
follow from autograd through the same pieces: ``hidden`` enters through
``parallel.copy_to_group``, so its gradient is summed over the group,
and the local ``wte`` slice gets its own.  The reductions are Megatron's
``g`` (sum forward, identity backward), not ``psum_g``: every rank
computes the same loss from replicated (B, S) values, and a psum in the
backward would multiply the gradients by n.

:func:`vocab_parallel_lm_loss_shard` is the same loss over a sequence
shard (``--sp`` with ``--tp``): the sum over the rank's positions, for
the caller to sum over the sequence group.

The samplers in the JAX file (``vocab_parallel_sample``,
``vocab_parallel_argmax``) belong to tensor-parallel serving and are
not here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

# the logit of a padding row: low enough that exp() of it minus any
# real max is 0, as in the JAX function
PAD_LOGIT = -1e9


def vocab_parallel_lm_loss(hidden: torch.Tensor, wte: torch.Tensor,
                           input_ids: torch.Tensor, mesh,
                           axis: str = "model", attention_mask=None,
                           true_vocab: Optional[int] = None,
                           logits_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Next-token LM loss from the final hidden states and this rank's
    vocab rows of the tied embedding, without the full logits.

    Args:
      hidden: (B, S) x H final-LN output, replicated over the model group
        (``GPTLMHeadModel(..., return_hidden=True)``).
      wte: this rank's (V / n, H) rows of the tied embedding (the master
        parameter; cast to ``hidden``'s dtype for the product, as the
        dense head computes in the compute dtype).
      input_ids: (B, S) ids; the shift of ``models.lm_loss``: predict
        t+1 from the prefix up to t.
      mesh / axis: a ``parallel.Mesh`` and its model axis (the group
        the vocab is split over).
      attention_mask: optional (B, S) 1/0; positions whose target is
        padding are dropped, mean over the kept positions.
      true_vocab: the real vocabulary when ``wte`` was padded
        (``models.padded_vocab``): the padding rows' logits are set to
        -1e9, so the loss is the true vocabulary's.

    Returns the 0-d loss in ``logits_dtype``, the same on every rank of
    the group; gradients flow to ``hidden`` and ``wte``.
    """
    per_tok = _per_token(hidden, wte, input_ids[:, 1:], mesh, axis,
                         true_vocab, logits_dtype)
    if attention_mask is None:
        return per_tok.mean()
    keep = attention_mask[:, 1:].to(per_tok.dtype)
    return (per_tok * keep).sum() / keep.sum().clamp_min(1.0)


def _per_token(hidden, wte, labels, mesh, axis, true_vocab, logits_dtype):
    """The (B, n) cross entropy of the first n = ``labels.shape[1]``
    positions of ``hidden`` against ``labels``, from this rank's vocab
    rows (the three reductions of the module docstring)."""
    # imported here: parallel imports ops (a module-level import would
    # be circular)
    from apex_tpu_torch.parallel.collectives import copy_to_group, \
        pmax_g, reduce_from_group
    group = mesh.group(axis)
    n = mesh.shape[axis]
    index = mesh.index(axis) if dist.is_initialized() else 0
    vshard = wte.shape[0]
    h = copy_to_group(hidden, group)
    lg = F.linear(h, wte.to(h.dtype)).to(logits_dtype)
    if true_vocab is not None and true_vocab < vshard * n:
        vids = index * vshard + torch.arange(vshard, device=lg.device)
        lg = torch.where(vids < true_vocab, lg, PAD_LOGIT)
    lg = lg[:, :labels.shape[1]]
    tgt = labels.long()
    gmax = pmax_g(lg.detach().amax(dim=-1), group)
    z = torch.exp(lg - gmax[..., None])
    lse = torch.log(reduce_from_group(z.sum(dim=-1), group)) + gmax
    local_t = tgt - index * vshard
    owned = (local_t >= 0) & (local_t < vshard)
    picked = torch.gather(lg, -1, local_t.clamp(0, vshard - 1)[..., None])
    tgt_logit = reduce_from_group(
        torch.where(owned, picked[..., 0], 0.0), group)
    return lse - tgt_logit


def vocab_parallel_lm_loss_shard(hidden: torch.Tensor, wte: torch.Tensor,
                                 input_ids: torch.Tensor, mesh,
                                 true_vocab: Optional[int] = None
                                 ) -> torch.Tensor:
    """A sequence-parallel rank's part of :func:`vocab_parallel_lm_loss`:
    the SUM of the next-token cross entropy over its positions, from its
    (B, S/sp, H) ``hidden`` (its sequence shard, replicated over the
    model group) and its vocab rows of ``wte``; ``input_ids`` is the
    batch's whole (B, S).  As ``models.gpt.lm_loss_shard``: the next
    shard's first token labels this rank's last position, and the last
    sequence rank drops its final position, which has none.  The loss of
    the batch is the sum over the sequence group divided by ``B * (S -
    1)``, in fp32; the vocab is split over the mesh's ``"model"`` axis
    and the sequence over its ``"sp"`` axis."""
    s_local = hidden.shape[1]
    start = (mesh.index("sp") if dist.is_initialized() else 0) * s_local
    labels = input_ids[:, start + 1:start + s_local + 1]
    return _per_token(hidden, wte, labels, mesh, "model", true_vocab,
                      torch.float32).sum()
