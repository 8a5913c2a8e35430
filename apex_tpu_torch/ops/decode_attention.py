"""Cached (single-token) attention — the decode half of serving.

Twin of ``apex_tpu/ops/decode_attention.py``.  One new query token per
sequence attends T gathered cache positions: Sq == 1, no causality (the
cache holds only the past), an additive fp32 (B, T) bias that masks
unwritten slots, fp32 softmax.  On CUDA tensors
``csrc/decode_attention.cu`` computes it, split across the context in
64-key tiles (a key masked at or below NEG_INF / 2 reads no K or V),
reading K/V in the (B, T, H, D) layout through strides; on CPU tensors
:func:`_reference` does.

Quantized KV: with the pool's (B, T, H) fp32 scale sidecar
(``k_scale``/``v_scale``) K and V are int8 and widen to q's dtype at
read, by :func:`ops.kv_quant.dequantize_kv`'s rule (one fp32 multiply,
one cast): inside the kernel on CUDA (B8, counted apart as
``decode_attention_q8``), before the scores in the plain version.

:func:`chunk_cached_attention` (multi-token chunks over a cached
context) is plain PyTorch here, as it is plain jnp in the reference.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from apex_tpu_torch._kernels.build import (
    Kernel,
    check_dtype,
    plain_path,
    stream_handle,
)
from apex_tpu_torch.ops.flash_attention import _meets_16_byte_rule
from apex_tpu_torch.ops.kv_quant import dequantize_kv
from apex_tpu_torch.ops.unpatched import unpatched

NEG_INF = -1e30

# the plain version's einsum, immune to amp O1's half-list patch (as in
# ops.flash_attention)
_einsum = unpatched(torch.einsum)

_HEAD_DIMS = (64,)   # the head dims csrc/decode_attention.cu is built for
_TILE = 64           # keys of a kernel tile
_MAX_SPLITS = 32     # splits of a (b, h) the kernel combines

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("decode_attention", "apex_decode_attention",
                [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                 ctypes.c_float, _I, _P])
KERNEL_Q8 = Kernel("decode_attention_q8", "apex_decode_attention_q8",
                   [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _P, ctypes.c_float, _I, _P])

# the kernel's per-(b, h) split counters, by (device, stream): zeros that
# every launch leaves zero; launches on one stream run in order, so they
# share a set
_COUNTERS = {}



def _reference(q, k, v, kv_bias, scale, k_scale=None, v_scale=None):
    """Plain PyTorch version: fp32 scores and softmax, output in q's
    dtype; fully-masked rows give zeros.  With scales, k/v are int8 and
    widen to q's dtype first."""
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
    s = _einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    valid = m > NEG_INF / 2
    p = torch.exp(s - torch.where(valid, m, torch.zeros_like(m)))
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = _einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out.to(q.dtype)


def _check_scales(k, k_scale, v_scale, what):
    """Both scales or neither, shaped like k without its head_dim."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            f"{what}: k_scale and v_scale must be passed together")
    if k_scale is not None and (k_scale.shape != k.shape[:3]
                                or v_scale.shape != k.shape[:3]):
        raise ValueError(
            f"{what}: scales must be (B, T, H) matching k; got "
            f"k={tuple(k.shape)} k_scale={tuple(k_scale.shape)} "
            f"v_scale={tuple(v_scale.shape)}")


def _counters(device, stream, n):
    """At least ``n`` int32 zeros for the split counters on this stream."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split(device, bh, t):
    """(tiles a split, splits): the context's 64-key tiles cut into as
    many splits as keep B * H * splits within one block an SM (at most
    ``_MAX_SPLITS``).  A block takes a split; above half as many (b, h)
    as SMs the context is not split.  On the H100 one split was the fastest
    count at B * H 96 and 192 (T 1025), and this rule's 11 splits at
    B * H 12, T 20,000 were 4-7x faster than one (``chip_smoke.py``'s
    ``split_ms``).  It depends on B * H and T only, so B7 and B8 split a
    context alike."""
    n_tiles = -(-t // _TILE)
    splits = max(1, min(_MAX_SPLITS, n_tiles, _sm_count(device) // bh))
    tiles = -(-n_tiles // splits)
    return tiles, -(-n_tiles // tiles)


def _decode_cuda(q, k, v, kv_bias, scale, k_scale, v_scale):
    b, t, h, d = k.shape
    code = check_dtype("cached_attention", q)
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(
            f"cached_attention: k/v must be {kv_dtype} "
            f"{'with scales' if quantized else 'like q'}; got "
            f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError(f"cached_attention: scales must be float32; got "
                        f"{k_scale.dtype}, {v_scale.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"cached_attention: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"cached_attention: B * H = {b * h} exceeds the "
                         "kernel's grid (65535)")
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
    # the kernel copies 16-byte chunks of every (b, t, h) row
    k, v = (x if _meets_16_byte_rule(x)
            else x.clone(memory_format=torch.contiguous_format)
            for x in (k, v))
    strides = [q.stride(0), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2),
               o.stride(0), o.stride(2)]
    stream = stream_handle(q.device)
    tiles, splits = _split(q.device, b * h, t)
    scratch = counters = None
    if splits > 1:
        # (m, l) and acc[d] of every split, fp32
        scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                              device=q.device)
        counters = _counters(q.device, stream, b * h)
    extra = tuple(None if x is None else x.data_ptr()
                  for x in (scratch, counters))
    bias_ptr = None if kv_bias is None else kv_bias.data_ptr()
    if not quantized:
        st = (ctypes.c_int64 * 10)(*strides)
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                      o.data_ptr(), *extra, b, h, t, d, tiles,
                      ctypes.addressof(st), float(scale), code, stream)
        return o
    strides += [k_scale.stride(0), k_scale.stride(1), k_scale.stride(2),
                v_scale.stride(0), v_scale.stride(1), v_scale.stride(2)]
    st = (ctypes.c_int64 * 16)(*strides)
    KERNEL_Q8.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), bias_ptr,
                     o.data_ptr(), *extra, b, h, t, d, tiles,
                     ctypes.addressof(st), float(scale), code, stream)
    return o


def cached_attention(q, k, v, *, kv_bias: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None):
    """Single-new-token attention over a gathered KV-cache context.

    Args:
      q: (B, 1, H, D) — the new token's queries.
      k, v: (B, T, H, D) — the gathered context, the new token's own
        k/v included; in q's dtype, or int8 with scales.
      kv_bias: optional (B, T) additive fp32 mask (0 keep / NEG_INF
        drop); unwritten slots MUST be masked by the caller.
      scale: logit scale, default 1/sqrt(D).
      k_scale, v_scale: optional (B, T, H) fp32 dequantization scales
        (the quantized pool's sidecar); k/v are then int8 and widen to
        q's dtype at read (kernel B8 on CUDA).

    Returns (B, 1, H, D) in q's dtype.  Inference only: the kernels
    have no backward (neither have the JAX ones), so on CUDA tensors
    they raise when grad mode is on and an input requires grad, rather
    than return an output cut from the graph.
    """
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D); got {tuple(q.shape)}")
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"k/v must be (B, T, H, D) matching q; got q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}")
    _check_scales(k, k_scale, v_scale, "cached_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    extra = tuple(x for x in (kv_bias, k_scale, v_scale) if x is not None)
    if plain_path(q, k, v, *extra):
        return _reference(q, k, v, kv_bias, scale, k_scale, v_scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, *extra)):
        raise RuntimeError(
            "cached_attention: the decode kernel has no backward; call it "
            "under torch.no_grad() or on inputs that do not require grad")
    return _decode_cuda(q, k, v, kv_bias, scale, k_scale, v_scale)


def chunk_cached_attention(q, k, v, ctx_bias,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None):
    """Multi-token (chunked-prefill) attention over gathered cache
    context plus the chunk itself.

    Args:
      q: (B, C, H, D) — one prefill chunk's queries.
      k, v: (B, T + C, H, D) — the first T positions are the gathered
        cache context (masked by ``ctx_bias``), the last C the chunk's
        own fresh K/V, attended causally within the chunk.
      ctx_bias: (B, T) additive fp32 context mask.
      scale: logit scale, default 1/sqrt(D).
      k_scale, v_scale: optional (B, T + C, H) fp32 dequantization
        scales; k/v (the quantized context and the chunk's own
        quantized K/V) are then int8 and widen to q's dtype first.

    Plain PyTorch with the same fp32 numeric policy as
    :func:`cached_attention`'s reference.
    """
    b, c, _, d = q.shape
    t = k.shape[1] - c
    if t < 0 or v.shape != k.shape:
        raise ValueError(
            f"k/v must be (B, T + C, H, D) with T >= 0; got "
            f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    _check_scales(k, k_scale, v_scale, "chunk_cached_attention")
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
        v = dequantize_kv(v, v_scale, q.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = _einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    idx = torch.arange(c, device=q.device)
    causal = torch.where(idx[:, None] >= idx[None, :], 0.0, NEG_INF)
    bias = torch.cat(
        [ctx_bias.float()[:, None, :].expand(b, c, t),
         causal[None].expand(b, c, c)], dim=-1)
    s = s + bias[:, None]                              # (B, H, C, T+C)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = _einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out.to(q.dtype)
