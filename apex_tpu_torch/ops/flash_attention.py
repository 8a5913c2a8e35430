"""Flash attention forward through a hand-written CUDA kernel.

Twin of ``apex_tpu/ops/flash_attention.py`` for the serving prefill:
exact attention over (B, S, H, D) operands with an additive (B, Sk) key
mask and optional causal masking on global positions, fp32 softmax, no
(Sq, Sk) score tensor in device memory.  On CUDA tensors
``csrc/flash_fwd.cu`` computes it; on CPU tensors :func:`_reference`
(the plain PyTorch version, also the kernel's reference on the card).

Not here yet: the backward kernels and in-kernel attention dropout
(the murmur3 keep-mask), which come with the training path.  There is
no short-sequence gate either: the TPU's XLA/Pallas crossover
(``FLASH_AUTO_MIN_SEQ``) was a v5e measurement and is not inherited.
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

_HEAD_DIMS = (64,)   # the head dims csrc/flash_fwd.cu is built for

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("flash_fwd", "apex_flash_fwd",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                 ctypes.c_float, _I, _I, _P])


def _reference(q, k, v, kv_mask, causal, scale, return_lse: bool = False):
    """Plain PyTorch version (fp32 softmax), shapes (B, S, H, D).  With
    ``return_lse`` also returns the per-row log-sum-exp (B, H, Sq) fp32,
    NEG_INF for fully-masked rows."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s + kv_mask[:, None, None, :].float()
    if causal:
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        s = torch.where((pos_q[:, None] >= pos_k[None, :])[None, None],
                        s, NEG_INF)
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


def _flash_cuda(q, k, v, kv_mask, causal, scale):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code = check_dtype("flash_attention", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride "
                             "on head_dim")
    if kv_mask is not None:
        if kv_mask.shape != (b, sk):
            raise ValueError(f"kv_mask must be ({b}, {sk}); got "
                             f"{tuple(kv_mask.shape)}")
        kv_mask = kv_mask.float().contiguous()
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
        yet (it arrives with the training kernels).

    Returns (B, Sq, H, D) in q's dtype (and the lse).  Fully-masked rows
    give zeros.  Inference only: no gradient flows through the kernel.
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
    mask_t = () if kv_mask is None else (kv_mask,)
    if plain_path(q, k, v, *mask_t):
        return _reference(q, k, v, kv_mask, causal, scale,
                          return_lse=return_lse)
    o, lse = _flash_cuda(q, k, v, kv_mask, causal, scale)
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
