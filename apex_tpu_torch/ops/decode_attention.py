"""Cached (single-token) attention — the decode half of serving.

Twin of ``apex_tpu/ops/decode_attention.py`` without the int8 KV path.
One new query token per sequence attends T gathered cache positions:
Sq == 1, no causality (the cache holds only the past), an additive fp32
(B, T) bias that masks unwritten slots, fp32 softmax.  On CUDA tensors
``csrc/decode_attention.cu`` computes it, reading K/V in the (B, T, H, D)
layout through strides; on CPU tensors :func:`_reference` does.

:func:`chunk_cached_attention` (multi-token chunks over a cached
context) is plain PyTorch here, as it is plain jnp in the reference.
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

_HEAD_DIMS = (64,)   # the head dims csrc/decode_attention.cu is built for
# the kernel keeps the (T,) score row in shared memory
_MAX_T = (227 * 1024) // 4 - 128 - 256

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("decode_attention", "apex_decode_attention",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_float,
                 _I, _P])


def _reference(q, k, v, kv_bias, scale):
    """Plain PyTorch version: fp32 scores and softmax, output in q's
    dtype; fully-masked rows give zeros."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    valid = m > NEG_INF / 2
    p = torch.exp(s - torch.where(valid, m, torch.zeros_like(m)))
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out.to(q.dtype)


def _decode_cuda(q, k, v, kv_bias, scale):
    b, t, h, d = k.shape
    code = check_dtype("cached_attention", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cached_attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"cached_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    if t > _MAX_T:
        raise ValueError(f"cached_attention: T={t} exceeds the kernel's "
                         f"shared-memory score row ({_MAX_T})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"cached_attention: {name} needs unit stride "
                             "on head_dim")
    if kv_bias is not None:
        if kv_bias.shape != (b, t):
            raise ValueError(f"kv_bias must be ({b}, {t}); got "
                             f"{tuple(kv_bias.shape)}")
        kv_bias = kv_bias.float().contiguous()
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or t == 0:
        return o.zero_()
    strides = (ctypes.c_int64 * 10)(
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(2))
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if kv_bias is None else kv_bias.data_ptr(),
                  o.data_ptr(), b, h, t, d, ctypes.addressof(strides),
                  float(scale), code, stream_handle(q.device))
    return o


def cached_attention(q, k, v, *, kv_bias: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None):
    """Single-new-token attention over a gathered KV-cache context.

    Args:
      q: (B, 1, H, D) — the new token's queries.
      k, v: (B, T, H, D) in q's dtype — the gathered context, the new
        token's own k/v included.
      kv_bias: optional (B, T) additive fp32 mask (0 keep / NEG_INF
        drop); unwritten slots MUST be masked by the caller.
      scale: logit scale, default 1/sqrt(D).

    Returns (B, 1, H, D) in q's dtype.  Inference only: the kernel has
    no backward (neither has the JAX one), so on CUDA tensors it raises
    when grad mode is on and an input requires grad, rather than return
    an output cut from the graph.
    """
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D); got {tuple(q.shape)}")
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"k/v must be (B, T, H, D) matching q; got q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    bias_t = () if kv_bias is None else (kv_bias,)
    if plain_path(q, k, v, *bias_t):
        return _reference(q, k, v, kv_bias, scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *bias_t)):
        raise RuntimeError(
            "cached_attention: the decode kernel has no backward; call it "
            "under torch.no_grad() or on inputs that do not require grad")
    return _decode_cuda(q, k, v, kv_bias, scale)


def chunk_cached_attention(q, k, v, ctx_bias,
                           scale: Optional[float] = None):
    """Multi-token (chunked-prefill) attention over gathered cache
    context plus the chunk itself.

    Args:
      q: (B, C, H, D) — one prefill chunk's queries.
      k, v: (B, T + C, H, D) — the first T positions are the gathered
        cache context (masked by ``ctx_bias``), the last C the chunk's
        own fresh K/V, attended causally within the chunk.
      ctx_bias: (B, T) additive fp32 context mask.
      scale: logit scale, default 1/sqrt(D).

    Plain PyTorch with the same fp32 numeric policy as
    :func:`cached_attention`'s reference.
    """
    b, c, _, d = q.shape
    t = k.shape[1] - c
    if t < 0 or v.shape != k.shape:
        raise ValueError(
            f"k/v must be (B, T + C, H, D) with T >= 0; got "
            f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    idx = torch.arange(c, device=q.device)
    causal = torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_INF)
    bias = torch.cat(
        [ctx_bias.float()[:, None, :].expand(b, c, t),
         causal[None].expand(b, c, c)], dim=-1)
    s = s + bias[:, None]                              # (B, H, C, T+C)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out.to(q.dtype)
