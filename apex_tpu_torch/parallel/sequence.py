"""Sequence parallelism: ring attention and Ulysses all-to-all.

Twin of ``apex_tpu/parallel/sequence.py``.  Every function takes this
rank's shard of the sequence, (B, S_local, H, D), the global sequence
being the shards in the order of ``group``'s ranks (a
``parallel.ProcessGroup``, the mesh's ``"sp"`` group, where the JAX
package names a mesh axis).  Without an initialized process group the
group is a world of one.

- :func:`ring_attention`: the K/V shards rotate around the group
  (``parallel.ppermute_g``, one neighbour hop a step).  The flash path
  (the default; ``use_flash=False`` for the fp32 online-softmax blocks)
  runs one ``flash_attention(..., return_lse=True)`` a hop, B4 on CUDA
  tensors, and merges the hops with the exact log-sum-exp rule; under
  causal masking the diagonal hop is causal, a hop from an earlier rank
  unmasked and a hop from a later rank skipped.  Each hop's backward
  runs B5/B6 with the lse cotangent the merge gives it.
- :func:`ulysses_attention`: ``parallel.all_to_all_g`` swaps the split
  from the sequence to the heads, each rank attends over the whole
  sequence for H/n heads (``flash_attention``, or the exact fp32
  softmax, or ``attention_impl``), and swaps back.
- :func:`make_ring_attention`, :func:`make_ulysses_attention`: adapters
  with the models' ``attention_fn(q, k, v, bias, dropout_fn)``
  signature.

Attention dropout takes global coordinates: the ring's hop from rank
``src`` hashes ``(my * S_local, src * S_local, 0, H)``, Ulysses' rank
``(0, 0, my * H/n, H)``, so every (q, k) pair drops as the one-device
call drops it at the same seed.  ``dropout_heads=(h0, H_total)`` places
the H local heads at ``h0`` of the whole model's ``H_total`` (a
tensor-parallel rank's; the adapters read it from the ``dropout_fn``'s
``.offsets``, which the tensor-parallel models set).

Eager autograd has no SPMD program: every rank's backward must issue
the same collectives in the same order.  The ring rotates K and V as
one stacked tensor, only between hops (never after the last), and a
skipped hop still adds 0 times an element of the block it skipped, so
the backward of every rotation runs on every rank, in one chain from
the last rotation to the first.  Ulysses swaps q, k and v as one stacked
tensor: two collectives forward, two backward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.flash_attention import _divisor, bias_to_kv_mask, \
    dropout_params, flash_attention, keep_from_seed, seed_array
from apex_tpu_torch.ops.unpatched import unpatched
from apex_tpu_torch.parallel.collectives import all_gather_g, all_to_all_g, \
    ppermute_g
from apex_tpu_torch.parallel.mesh import ProcessGroup

NEG_INF = -1e30  # large-negative fp32 (not -inf: keeps exp/where NaN-free)

# fp32-accumulation einsum, immune to amp O1's half-list patch
_einsum = unpatched(torch.einsum)


def _place(group: Optional[ProcessGroup]):
    """``(n, rank)`` of this rank in ``group``; ``(1, 0)`` without a
    process group."""
    if group is None or not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return group.size(), group.rank()


def _online_block_update(m, den, acc, scores, v, keep=None,
                         dropout_rate=0.0):
    """One online-softmax accumulation step, all fp32: ``m`` (B, H, Sq)
    the running max, ``den`` (B, H, Sq) the running denominator,
    ``acc`` (B, Sq, H, D) the running numerator, ``scores`` (B, H, Sq,
    Sk) this block's logits, ``v`` (B, Sk, H, D) its values.  ``keep``
    (B, H, Sq, Sk): the dropout keep-mask, on the numerator only (the
    flash kernels' convention)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    den = den * correction + p.sum(dim=-1)
    p_v = p if keep is None else torch.where(
        keep, p / _divisor(dropout_rate, p.device), 0.0)
    acc = acc * correction.permute(0, 2, 1)[..., None] \
        + _einsum("bhqk,bkhd->bqhd", p_v, v.float())
    return m_new, den, acc


def _check_dropout(name, dropout_rate, dropout_seed, flash_kwargs):
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError(f"{name}(dropout_rate>0) requires dropout_seed")
    if flash_kwargs and any(k.startswith("dropout") for k in flash_kwargs):
        raise ValueError(
            f"pass dropout_rate/dropout_seed to {name} itself, not via "
            "flash_kwargs: the masks need global coordinate offsets, "
            "which only the outer call can supply")


def _stacked_ring(k, v, kv_mask, group, n):
    """The hops' blocks: ``(step, kv, mask)`` for step 0..n-1, ``kv``
    the stacked (2, B, S_local, H, D) K/V block held at that step, each
    rotated from the last (no rotation after the last hop)."""
    kv, mask = torch.stack([k, v]), kv_mask
    for step in range(n):
        if step:
            kv = ppermute_g(kv, group)
            if mask is not None:
                mask = ppermute_g(mask, group)
        yield step, kv, mask


def ring_attention(q, k, v, *, group: Optional[ProcessGroup] = None,
                   kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: Optional[bool] = None,
                   flash_kwargs: Optional[dict] = None,
                   dropout_rate: float = 0.0, dropout_seed=None,
                   dropout_heads: Optional[Tuple[int, int]] = None):
    """Exact attention over a sequence sharded on ``group``.

    ``q``, ``k``, ``v``: this rank's (B, S_local, H, D) shards;
    ``kv_mask``: the (B, S_local) additive mask of this shard's keys
    (0 keep, large-negative drop), which travels the ring with its
    block; ``causal``: causal masking on global positions; ``scale``:
    default 1/sqrt(D); ``use_flash``: None or True for one
    ``flash_attention`` a hop (the kernels on CUDA tensors, their plain
    versions on the CPU), False for the fp32 online-softmax blocks;
    ``flash_kwargs``: passed to ``flash_attention``;
    ``dropout_rate``/``dropout_seed``: attention dropout in global
    coordinates (``dropout_heads``: module docstring).  Returns (B,
    S_local, H, D) in q's dtype; rows with no live key give zeros.
    Differentiable in q, k and v."""
    _check_dropout("ring_attention", dropout_rate, dropout_seed,
                   flash_kwargs)
    if use_flash is None or use_flash:
        return _ring_attention_flash(q, k, v, group=group, kv_mask=kv_mask,
                                     causal=causal, scale=scale,
                                     flash_kwargs=flash_kwargs or {},
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed,
                                     dropout_heads=dropout_heads)
    n, my = _place(group)
    b, s_local, h, d = q.shape
    h0, h_total = dropout_heads or (0, h)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q32 = q.float() * scale
    if kv_mask is not None:
        kv_mask = kv_mask.float()
    dev = q.device
    local = torch.arange(s_local, device=dev)
    q_pos = my * s_local + local
    m = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, s_local), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=dev)
    for step, kv, mask in _stacked_ring(k, v, kv_mask, group, n):
        src = (my - step) % n
        scores = _einsum("bqhd,bkhd->bhqk", q32, kv[0].float())
        if mask is not None:
            scores = scores + mask[:, None, None, :]
        if causal:
            k_pos = src * s_local + local
            allowed = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(allowed[None, None], scores, NEG_INF)
        keep = None
        if dropout_rate > 0.0:
            keep = keep_from_seed(
                seed_array(dropout_seed,
                           (my * s_local, src * s_local, h0, h_total),
                           num_heads=h_total, device=dev),
                b, h, local, local, dropout_rate)
        m, den, acc = _online_block_update(m, den, acc, scores, kv[1], keep,
                                           dropout_rate)
    # a row whose every key is masked never saw a score above ~NEG_INF
    valid = (m > NEG_INF / 2).permute(0, 2, 1)[..., None]
    den = den.permute(0, 2, 1)[..., None]
    out = torch.where(valid, acc / den.clamp_min(1e-30), 0.0)
    return out.to(q.dtype)


def _ring_attention_flash(q, k, v, *, group, kv_mask, causal, scale,
                          flash_kwargs, dropout_rate=0.0, dropout_seed=None,
                          dropout_heads=None):
    """Ring attention with ``flash_attention(return_lse=True)`` a hop and
    the exact merge ``out = sum_i o_i * exp(lse_i - LSE)``; under causal
    masking the diagonal hop is causal, a hop from ``src < my``
    unmasked, and a hop from ``src > my`` skipped (its block joins the
    graph times 0, see the module docstring)."""
    n, my = _place(group)
    b, s_local, h, d = q.shape
    h0, h_total = dropout_heads or (0, h)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_mask is not None:
        kv_mask = kv_mask.float()

    def flash(k_blk, v_blk, mask_blk, is_causal, src):
        extra = {}
        if dropout_rate > 0.0:
            extra = dict(dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed,
                         dropout_offsets=(my * s_local, src * s_local, h0,
                                          h_total))
        return flash_attention(q, k_blk, v_blk, kv_mask=mask_blk,
                               causal=is_causal, scale=scale,
                               return_lse=True, **extra, **flash_kwargs)

    acc = acc_lse = None
    for step, kv, mask in _stacked_ring(k, v, kv_mask, group, n):
        src = (my - step) % n
        if step == 0:
            # the local diagonal block, the only causal-masked hop
            o0, acc_lse = flash(k, v, kv_mask, causal, my)
            acc = o0.float()
            continue
        if causal and src > my:
            # every key is in this query shard's future
            acc = acc + 0.0 * kv.reshape(-1)[0].float()
            continue
        o_blk, lse_blk = flash(kv[0], kv[1], mask, False, src)
        new_lse = torch.logaddexp(acc_lse, lse_blk)       # (B, H, Sq)
        w_a = torch.exp(acc_lse - new_lse).permute(0, 2, 1)[..., None]
        w_b = torch.exp(lse_blk - new_lse).permute(0, 2, 1)[..., None]
        acc = acc * w_a + o_blk.float() * w_b
        acc_lse = new_lse
    valid = (acc_lse > NEG_INF / 2).permute(0, 2, 1)[..., None]
    return torch.where(valid, acc, 0.0).to(q.dtype)


def ulysses_attention(q, k, v, *, group: Optional[ProcessGroup] = None,
                      kv_mask: Optional[torch.Tensor] = None,
                      causal: bool = False, scale: Optional[float] = None,
                      attention_impl: Optional[Callable] = None,
                      use_flash: Optional[bool] = None,
                      flash_kwargs: Optional[dict] = None,
                      dropout_rate: float = 0.0, dropout_seed=None,
                      dropout_heads: Optional[Tuple[int, int]] = None):
    """All-to-all sequence parallelism (the "Ulysses" pattern).

    Shards (B, S_local, H, D) with H divisible by the group's size are
    swapped to (B, S, H/n, D) (``all_to_all_g``), attended over the
    whole sequence and swapped back.  ``use_flash`` None or True (with
    no ``attention_impl``): ``flash_attention``; False: the exact fp32
    softmax; ``attention_impl(q, k, v, bias=)``: the caller's attention
    over the additive (B, 1, S or 1, S) bias.  ``kv_mask`` is this
    shard's (B, S_local) key mask, all-gathered over the group;
    ``dropout_heads``: module docstring."""
    n, my = _place(group)
    b, s_local, h, d = q.shape
    h0, h_total = dropout_heads or (0, h)
    _check_dropout("ulysses_attention", dropout_rate, dropout_seed,
                   flash_kwargs)
    if dropout_rate > 0.0 and attention_impl is not None:
        raise ValueError(
            "dropout_rate and attention_impl are mutually exclusive: a "
            "custom attention_impl owns its own dropout")
    if attention_impl is not None and scale is not None:
        raise ValueError(
            "scale and attention_impl are mutually exclusive: a custom "
            "attention_impl owns its own logit scaling")
    if h % n:
        raise ValueError(f"ulysses_attention: {h} heads do not divide "
                         f"over {n} ranks")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if use_flash is None:
        use_flash = attention_impl is None

    # (3, B, S_local, H, D) -> (3, B, S, H/n, D): this rank's heads
    qg, kg, vg = all_to_all_g(torch.stack([q, k, v]), group, split_dim=3,
                              concat_dim=2).unbind(0)
    s_global = s_local * n

    def to_seq(x):
        return all_to_all_g(x, group, split_dim=1, concat_dim=2)

    mask_g = None
    if kv_mask is not None:
        mask_g = all_gather_g(kv_mask.float(), group, axis=1, tiled=True)

    h_loc = h // n
    if attention_impl is None and use_flash:
        extra = {}
        if dropout_rate > 0.0:
            # this rank holds heads [my * h/n, (my + 1) * h/n) of the H
            extra = dict(dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed,
                         dropout_offsets=(0, 0, h0 + my * h_loc, h_total))
        out = flash_attention(qg, kg, vg, kv_mask=mask_g, causal=causal,
                              scale=scale, **extra, **(flash_kwargs or {}))
        return to_seq(out)

    bias = mask_g[:, None, None, :] if mask_g is not None else None
    if causal:
        pos = torch.arange(s_global, device=q.device)
        cmask = torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)
        bias = cmask[None, None] if bias is None \
            else bias + cmask[None, None]

    if attention_impl is not None:
        return to_seq(attention_impl(qg, kg, vg, bias=bias))
    scores = _einsum("bqhd,bkhd->bhqk", qg.float() * scale, kg.float())
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        pos = torch.arange(s_global, device=q.device)
        keep = keep_from_seed(
            seed_array(dropout_seed, (0, 0, h0 + my * h_loc, h_total),
                       num_heads=h_total, device=q.device),
            b, h_loc, pos, pos, dropout_rate)
        probs = torch.where(keep, probs / _divisor(dropout_rate, q.device),
                            0.0)
    out = _einsum("bhqk,bkhd->bqhd", probs, vg.float())
    # fully masked rows give zeros, as flash_attention and the ring do
    valid = scores.amax(dim=-1) > NEG_INF / 2                # (B, H, Sq)
    out = torch.where(valid.permute(0, 2, 1)[..., None], out, 0.0)
    return to_seq(out.to(q.dtype))


def _dropout_heads(dropout_fn):
    """``(head_offset, heads_total)`` from a tensor-parallel model's
    ``dropout_fn.offsets``; None without them."""
    offsets = getattr(dropout_fn, "offsets", None)
    return None if offsets is None else (offsets[2], offsets[3])


def make_ring_attention(group: Optional[ProcessGroup] = None, *,
                        causal: bool = False) -> Callable:
    """Adapter with the models' ``attention_fn(q, k, v, bias,
    dropout_fn)`` signature over :func:`ring_attention`: ``bias`` must
    be key-position-only (this shard's padding mask), attention dropout
    runs from the ``dropout_fn``'s rate and seed
    (``ops.flash_attention.dropout_params``)."""

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        rate, seed = dropout_params(dropout_fn)
        return ring_attention(q, k, v, group=group,
                              kv_mask=bias_to_kv_mask(bias), causal=causal,
                              dropout_rate=rate, dropout_seed=seed,
                              dropout_heads=_dropout_heads(dropout_fn))

    # the JAX ring's collective-carrying scan miscomputes in the 1F1B
    # schedule's branches; the mark travels with the adapter
    attention_fn.onef1b_compatible = False
    return attention_fn


def make_ulysses_attention(group: Optional[ProcessGroup] = None, *,
                           causal: bool = False) -> Callable:
    """Like :func:`make_ring_attention` over :func:`ulysses_attention`."""

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        rate, seed = dropout_params(dropout_fn)
        return ulysses_attention(q, k, v, group=group,
                                 kv_mask=bias_to_kv_mask(bias),
                                 causal=causal, dropout_rate=rate,
                                 dropout_seed=seed,
                                 dropout_heads=_dropout_heads(dropout_fn))

    attention_fn.onef1b_compatible = True
    return attention_fn
