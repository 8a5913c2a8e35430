"""Flash attention through hand-written CUDA kernels, forward and backward.

Twin of ``apex_tpu/ops/flash_attention.py``: exact attention over
(B, S, H, D) operands with an additive (B, Sk) key mask and optional
causal masking on global positions, fp32 softmax, no (Sq, Sk) score
tensor in device memory.  :func:`flash_attention` is a
``torch.autograd.Function`` on both devices, as the JAX function is a
``custom_vjp``, differentiable in the output and the lse:

- forward: ``csrc/flash_fwd.cu`` (B4) on CUDA tensors, :func:`_reference`
  on CPU tensors; it saves q, k, v, o, the fp32 lse and the mask;
- backward: ``delta = rowsum(do * o)`` in fp32, minus the lse cotangent
  when the lse output has one (``_bwd_pallas``), then
  ``csrc/flash_bwd.cu`` (B5 for dq, B6 for dk/dv) on CUDA tensors and
  :func:`_bwd_dq_reference` / :func:`_bwd_dkv_reference` on CPU
  tensors.

Not here yet: in-kernel attention dropout (the murmur3 keep-mask, B4's
dropout branch).  There is no short-sequence gate either: the TPU's
XLA/Pallas crossover (``FLASH_AUTO_MIN_SEQ``) was a v5e measurement and
is not inherited.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch._kernels.build import (
    Kernel,
    check_dtype,
    plain_path,
    stream_handle,
)

NEG_INF = -1e30

_HEAD_DIMS = (64,)   # the head dims csrc/flash_*.cu are built for

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = Kernel("flash_fwd", "apex_flash_fwd",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I,
                 _P])
BWD_DQ_KERNEL = Kernel("flash_bwd_dq", "apex_flash_bwd_dq",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P, _F, _I, _I, _P])
BWD_DKV_KERNEL = Kernel("flash_bwd_dkv", "apex_flash_bwd_dkv",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _P, _F, _I, _I, _P])


def _scores(q, k, kv_mask, causal, scale):
    """(B, H, Sq, Sk) fp32 logits with the key mask and causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s + kv_mask[:, None, None, :].float()
    if causal:
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        s = torch.where((pos_q[:, None] >= pos_k[None, :])[None, None],
                        s, NEG_INF)
    return s


def _reference(q, k, v, kv_mask, causal, scale, return_lse: bool = False):
    """Plain PyTorch version of the forward (fp32 softmax), shapes
    (B, S, H, D).  With ``return_lse`` also returns the per-row
    log-sum-exp (B, H, Sq) fp32, NEG_INF for fully-masked rows."""
    s = _scores(q, k, kv_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    valid = m > NEG_INF / 2
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    probs = p / den.clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out * valid.permute(0, 2, 1, 3).to(out.dtype)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(valid[..., 0],
                      m[..., 0] + torch.log(den[..., 0].clamp_min(1e-30)),
                      NEG_INF)
    return out, lse


def _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """p recomputed from the saved lse (0 on fully-masked rows) and
    ``ds = p * (do.v - delta)``, (B, H, Sq, Sk) fp32."""
    s = _scores(q, k, kv_mask, causal, scale)
    lse4 = lse[..., None]
    p = torch.where(lse4 > NEG_INF / 2, torch.exp(s - lse4),
                    torch.zeros((), device=q.device))
    dov = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dov - delta[..., None])


def _bwd_dq_reference(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """Plain PyTorch version of B5: ``dq = ds @ k * scale`` in q's
    dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(
        q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """Plain PyTorch version of B6: ``dk = ds^T @ q * scale`` and
    ``dv = p^T @ do`` in q's dtype."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _check_operands(name, q, k, v, kv_mask):
    b, _, _, d = q.shape
    code = check_dtype(name, q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {n} needs unit stride on head_dim")
    if kv_mask is not None:
        if kv_mask.shape != (b, k.shape[1]):
            raise ValueError(f"kv_mask must be ({b}, {k.shape[1]}); got "
                             f"{tuple(kv_mask.shape)}")
        kv_mask = kv_mask.float().contiguous()
    return code, kv_mask


def _flash_cuda(q, k, v, kv_mask, causal, scale):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code, kv_mask = _check_operands("flash_attention", q, k, v, kv_mask)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2))
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if kv_mask is None else kv_mask.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
                  ctypes.addressof(strides), float(scale), int(causal), code,
                  stream_handle(q.device))
    return o, lse


def _bwd_launch_args(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """Checks the backward's operands and returns the pointer and scalar
    arguments B5 and B6 share (the strides array is kept alive beside
    them)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code, kv_mask = _check_operands("flash_attention backward", q, k, v,
                                    kv_mask)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} in {q.dtype}; got "
                         f"{tuple(do.shape)} in {do.dtype}")
    for n, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{n} must be ({b}, {h}, {sq}) float32")
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse = lse.contiguous()
    delta = delta.contiguous()
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    common = (b, h, sq, sk, d, ctypes.addressof(strides), float(scale),
              int(causal), code, stream_handle(q.device))
    # the tensors made here must outlive the launch
    keep = (strides, do, lse, delta, kv_mask)
    return ptrs, common, keep


def _check_bwd_devices(q, k, v, do, lse, delta, kv_mask):
    mask_t = () if kv_mask is None else (kv_mask,)
    return plain_path(q, k, v, do, lse, delta, *mask_t)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """dq (B, Sq, H, D) given the output gradient ``do``, the forward's
    lse and ``delta = rowsum(do * o) - dlse`` (B, H, Sq) fp32: the kernel
    B5 for CUDA tensors, the plain version for CPU tensors."""
    if _check_bwd_devices(q, k, v, do, lse, delta, kv_mask):
        return _bwd_dq_reference(q, k, v, do, lse, delta, kv_mask, causal,
                                 scale)
    ptrs, common, _keep = _bwd_launch_args(q, k, v, do, lse, delta, kv_mask,
                                           causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        BWD_DQ_KERNEL.launch(*ptrs, dq.data_ptr(), *common)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask, causal,
                            scale):
    """(dk, dv) (B, Sk, H, D), from the same operands as
    :func:`flash_attention_bwd_dq`: the kernel B6 for CUDA tensors, the
    plain version for CPU tensors."""
    if _check_bwd_devices(q, k, v, do, lse, delta, kv_mask):
        return _bwd_dkv_reference(q, k, v, do, lse, delta, kv_mask, causal,
                                  scale)
    ptrs, common, _keep = _bwd_launch_args(q, k, v, do, lse, delta, kv_mask,
                                           causal, scale)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        BWD_DKV_KERNEL.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *common)
    return dk, dv


def flash_attention_fwd(q, k, v, kv_mask, causal, scale):
    """(o, lse) without autograd: the kernel B4 for CUDA tensors, the
    plain version for CPU tensors."""
    mask_t = () if kv_mask is None else (kv_mask,)
    if plain_path(q, k, v, *mask_t):
        return _reference(q, k, v, kv_mask, causal, scale, return_lse=True)
    return _flash_cuda(q, k, v, kv_mask, causal, scale)


def flash_attention_bwd(q, k, v, do, lse, delta, kv_mask, causal, scale):
    """(dq, dk, dv): B5 then B6 (or their plain versions)."""
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask, causal,
                                scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask,
                                     causal, scale)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.to(q.dtype)
        # delta in the (B, H, Sq) layout of lse; the lse cotangent folds
        # into it: d lse / d s = p, so ds = p * (dov - delta + dlse)
        delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse,
                                         delta.contiguous(), kv_mask,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False, dropout_rate: float = 0.0):
    """Exact attention without materialising the score matrix.

    Args:
      q, k, v: (B, S, H, D); q and k/v sequence lengths may differ.
      kv_mask: optional (B, Sk) additive key mask (0 keep / NEG_INF drop).
      causal: causal masking on global positions.
      scale: logit scale, default 1/sqrt(D).
      return_lse: also return the per-row log-sum-exp (B, H, Sq) fp32
        (NEG_INF for fully-masked rows).
      dropout_rate: must be 0; in-kernel attention dropout is not ported
        yet.

    Returns (B, Sq, H, D) in q's dtype (and the lse).  Fully-masked rows
    give zeros.  Differentiable in q, k, v through both outputs (the
    mask gets no gradient).
    """
    if dropout_rate != 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout is not ported yet; "
            "dropout_rate must be 0")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q/k/v must be (B, S, H, D) with matching B, H, "
                         f"D; got q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _FlashFn.apply(q, k, v, kv_mask, bool(causal), float(scale))
    return (o, lse) if return_lse else o


def bias_to_kv_mask(bias):
    """Collapse a (B, 1, 1, Sk) additive key-position bias (padding
    masks) to (B, Sk) fp32.  Rejects query- or head-dependent biases."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        raise ValueError(
            "fused-attention adapters support key-position-only biases "
            f"of shape (B, 1, 1, Sk); got {tuple(bias.shape)}. Query-/"
            "head-dependent biases need the explicit attention API (use "
            "`causal=` for causal masking).")
    return bias[:, 0, 0, :].float()


def make_flash_attention(*, causal: bool = False, **kwargs):
    """Adapter with the ``attention_fn(q, k, v, bias, dropout_fn)``
    signature the models take; ``bias`` must be a key-position-only
    (B, 1, 1, Sk) additive mask.  A ``dropout_fn`` is refused: attention
    dropout is not ported yet."""

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        if dropout_fn is not None:
            raise NotImplementedError(
                "flash attention_fn: attention dropout is not ported yet")
        return flash_attention(q, k, v, kv_mask=bias_to_kv_mask(bias),
                               causal=causal, **kwargs)

    return attention_fn
