"""Flash attention through hand-written CUDA kernels, forward and backward.

Twin of ``apex_tpu/ops/flash_attention.py``: exact attention over
(B, S, H, D) operands with an additive (B, Sk) key mask and optional
causal masking on global positions, fp32 softmax, no (Sq, Sk) score
tensor in device memory.  :func:`flash_attention` is a
``torch.autograd.Function`` on both devices, as the JAX function is a
``custom_vjp``, differentiable in the output and the lse:

- forward: ``csrc/flash_fwd.cu`` (B4, and B4d with dropout) on CUDA
  tensors, :func:`_reference` on CPU tensors; it saves q, k, v, o, the
  fp32 lse, the mask and the dropout seed;
- backward: ``delta = rowsum(do * o)`` in fp32, minus the lse cotangent
  when the lse output has one (``_bwd_pallas``), then
  ``csrc/flash_bwd.cu`` (B5 for dq, B6 for dk/dv, and their dropout
  branches B5d/B6d) on CUDA tensors and :func:`_bwd_dq_reference` /
  :func:`_bwd_dkv_reference` on CPU tensors.

Attention-probability dropout runs inside the kernels: the keep-mask is
the murmur3 hash of the GLOBAL (batch*head, q, k) coordinate and the
step seed (:func:`_dropout_keep`, bit for bit the JAX function), so the
forward, both backward kernels and the plain versions regenerate the
same mask and nothing of (Sq, Sk) size is stored.  ``l`` and the lse
stay the undropped statistics; the value accumulator takes
``keep ? p / (1 - rate) : 0``; the backward masks and scales ``do.v``
the same way and ``dv`` uses the dropped p; ``delta`` needs no change
because ``o`` already carries the dropout.  The seed travels as the
5-int32 :func:`seed_array` ``[seed, row_off, col_off, head_off,
num_heads_total]`` in device memory, so a seed drawn on the card needs
no host sync.  Dropout launches count under their own names
(``flash_fwd_dropout``, ``flash_bwd_dq_dropout``,
``flash_bwd_dkv_dropout``); rate 0 runs the dropout-free kernels.

In bf16 the forward, dq and dk/dv kernels run on Hopper's tensor cores
(``wgmma``; P and dS rounded to bf16 before the second product, as the
TPU's MXU and SDPA round them), reading q, k, v and do with 16-byte
``cp.async``: a bf16 operand whose base or (b, s, h) strides are not
multiples of 16 bytes is passed as a contiguous copy
(:func:`_kernel_operand`).  fp32 keeps the CUDA-core bodies (no TF32),
which read any stride.

There is no short-sequence gate: the TPU's XLA/Pallas crossover
(``FLASH_AUTO_MIN_SEQ``) was a v5e measurement and is not inherited.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from apex_tpu_torch._kernels.build import (
    Kernel,
    check_dtype,
    plain_path,
    stream_handle,
)
from apex_tpu_torch.ops.unpatched import unpatched

NEG_INF = -1e30

# the plain versions' einsum, immune to amp O1's half-list patch: their
# fp32 upcasts are deliberate numerics, not user policy
_einsum = unpatched(torch.einsum)

_HEAD_DIMS = (64,)   # the head dims csrc/flash_*.cu are built for

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the dropout-free and dropout launches of one entry point count apart
_FWD_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _P, _F,
             _F, _I, _P]
_DQ_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I,
            _P, _F, _F, _I, _P]
_DKV_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F,
             _I, _P, _F, _F, _I, _P]
KERNEL = Kernel("flash_fwd", "apex_flash_fwd", _FWD_ARGS)
DROPOUT_KERNEL = Kernel("flash_fwd_dropout", "apex_flash_fwd", _FWD_ARGS)
BWD_DQ_KERNEL = Kernel("flash_bwd_dq", "apex_flash_bwd_dq", _DQ_ARGS)
DROPOUT_BWD_DQ_KERNEL = Kernel("flash_bwd_dq_dropout", "apex_flash_bwd_dq",
                               _DQ_ARGS)
BWD_DKV_KERNEL = Kernel("flash_bwd_dkv", "apex_flash_bwd_dkv", _DKV_ARGS)
DROPOUT_BWD_DKV_KERNEL = Kernel("flash_bwd_dkv_dropout",
                                "apex_flash_bwd_dkv", _DKV_ARGS)

# -- the dropout keep-mask ----------------------------------------------------

_M32 = 0xFFFFFFFF


def _u32(x):
    """int tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & _M32


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a uint32
    constant, from 16-bit halves of x: no int64 product reaches 2**49,
    so nothing overflows."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _dropout_keep(seed, bh, rows, cols, rate):
    """Deterministic keep-mask for attention-probability dropout: the
    murmur3 finalizer of the GLOBAL coordinate (batch*head, q position,
    k position) and the step seed, in uint32 arithmetic carried by int64
    tensors, then the top 24 bits as a uniform in [0, 1).  Bit for bit
    ``apex_tpu.ops.flash_attention._dropout_keep`` and
    ``apex::dropout_keep`` in ``csrc/common.cuh``.  Integer tensor
    arguments broadcast; ``rate`` is the DROP probability, True = keep."""
    x = (_mul32(_u32(rows), 0x9E3779B1) ^ _mul32(_u32(cols), 0x85EBCA77)
         ^ _mul32((_u32(bh) + 1) & _M32, 0xC2B2AE3D)
         ^ _mul32(_u32(seed), 0x27D4EB2F))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * 2.0 ** -24   # < 2**24: exact
    return u >= rate    # an fp32 compare, as JAX's and the kernels'


_OFFSETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _default_offsets(num_heads: int, device: torch.device) -> torch.Tensor:
    """The (4,) int32 default offsets ``(0, 0, 0, num_heads)`` on
    ``device``, made once per (device, head count)."""
    key = (device, num_heads)
    offs = _OFFSETS.get(key)
    if offs is None:
        offs = _OFFSETS[key] = torch.tensor(
            (0, 0, 0, num_heads), dtype=torch.int32, device=device)
    return offs


def seed_array(dropout_seed, offsets=None, *, num_heads: int, device=None):
    """Pack ``(seed, row_off, col_off, head_off, num_heads_total)`` into
    the (5,) int32 tensor every dropout consumer reads (the kernels, the
    plain versions, :func:`keep_from_seed`), on ``device`` (default: the
    seed's, or the CPU).  ``dropout_seed`` is a Python int or a 0-d
    integer tensor (a seed drawn on the card stays there: no value goes
    to the host); ``offsets`` default to ``(0, 0, 0, num_heads)``."""
    if device is None and isinstance(dropout_seed, torch.Tensor):
        device = dropout_seed.device
    if isinstance(dropout_seed, torch.Tensor) and offsets is None:
        # the models' per-step path: one cat with the cached offsets
        return torch.cat([
            dropout_seed.to(device=device, dtype=torch.int32).reshape(1),
            _default_offsets(num_heads, torch.device(device))])
    parts = [dropout_seed] + list(offsets or (0, 0, 0, num_heads))
    return torch.stack([
        x.to(device=device, dtype=torch.int32).reshape(())
        if isinstance(x, torch.Tensor)
        else torch.full((), int(x), dtype=torch.int32, device=device)
        for x in parts])


def keep_from_seed(seed, b: int, h_local: int, rows, cols, rate):
    """(B, h_local, len(rows), len(cols)) keep-mask from a
    :func:`seed_array` and LOCAL coordinate ranges (1-D integer
    tensors): the one non-kernel mapping of local coordinates to the
    global hash (the in-kernel form is ``apex::dropout_keep``'s caller in
    each kernel)."""
    dev = seed.device
    s = seed.to(torch.int64)
    bh = (torch.arange(b, device=dev)[:, None] * s[4] + s[3]
          + torch.arange(h_local, device=dev)[None, :])[:, :, None, None]
    return _dropout_keep(s[0], bh,
                         (rows.to(dev) + s[1])[None, None, :, None],
                         (cols.to(dev) + s[2])[None, None, None, :], rate)


def _keep_mask(seed, q, k, rate):
    b, sq, h, _ = q.shape
    return keep_from_seed(seed, b, h, torch.arange(sq, device=q.device),
                          torch.arange(k.shape[1], device=q.device), rate)


def _divisor(rate, device):
    """``1 - rate`` as the fp32 0-d tensor the plain versions divide by:
    a true division like the kernels', not the multiply by a reciprocal
    PyTorch's CUDA division by a Python scalar becomes."""
    return torch.full((), 1.0 - rate, dtype=torch.float32, device=device)


# -- plain versions -----------------------------------------------------------

def _scores(q, k, kv_mask, causal, scale):
    """(B, H, Sq, Sk) fp32 logits with the key mask and causal mask."""
    s = _einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s + kv_mask[:, None, None, :].float()
    if causal:
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        s = torch.where((pos_q[:, None] >= pos_k[None, :])[None, None],
                        s, NEG_INF)
    return s


def _reference(q, k, v, kv_mask, causal, scale, return_lse: bool = False,
               dropout_rate: float = 0.0, seed=None):
    """Plain PyTorch version of the forward (fp32 softmax), shapes
    (B, S, H, D).  With ``return_lse`` also returns the per-row
    log-sum-exp (B, H, Sq) fp32, NEG_INF for fully-masked rows.  Dropout
    (``dropout_rate`` > 0 with a :func:`seed_array` ``seed``) drops the
    normalized probs with the kernels' hash mask, as the JAX
    ``_reference`` does."""
    s = _scores(q, k, kv_mask, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    valid = m > NEG_INF / 2
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    probs = p / den.clamp_min(1e-30)
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, q, k, dropout_rate)
        probs = torch.where(keep, probs / _divisor(dropout_rate, q.device),
                            0.0)
    out = _einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out * valid.permute(0, 2, 1, 3).to(out.dtype)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(valid[..., 0],
                      m[..., 0] + torch.log(den[..., 0].clamp_min(1e-30)),
                      NEG_INF)
    return out, lse


def _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale,
              dropout_rate=0.0, seed=None):
    """The probs ``dv`` takes (p recomputed from the saved lse, 0 on
    fully-masked rows, dropped and scaled under dropout) and ``ds = p *
    (c * do.v - delta)`` with ``c = keep / (1 - rate)`` (1 without
    dropout), both (B, H, Sq, Sk) fp32."""
    s = _scores(q, k, kv_mask, causal, scale)
    lse4 = lse[..., None]
    p = torch.where(lse4 > NEG_INF / 2, torch.exp(s - lse4),
                    torch.zeros((), device=q.device))
    dov = _einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    p_v = p
    if dropout_rate > 0.0:
        keep = _keep_mask(seed, q, k, dropout_rate)
        div = _divisor(dropout_rate, q.device)
        dov = torch.where(keep, dov / div, 0.0)
        p_v = torch.where(keep, p / div, 0.0)
    return p_v, p * (dov - delta[..., None])


def _bwd_dq_reference(q, k, v, do, lse, delta, kv_mask, causal, scale,
                      dropout_rate=0.0, seed=None):
    """Plain PyTorch version of B5 (B5d with dropout): ``dq = ds @ k *
    scale`` in q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale,
                      dropout_rate, seed)
    return (_einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(
        q.dtype)


def _bwd_dkv_reference(q, k, v, do, lse, delta, kv_mask, causal, scale,
                       dropout_rate=0.0, seed=None):
    """Plain PyTorch version of B6 (B6d with dropout): ``dk = ds^T @ q *
    scale`` and ``dv = p^T @ do`` (p dropped and scaled) in q's
    dtype."""
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, kv_mask, causal, scale,
                      dropout_rate, seed)
    dk = _einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = _einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check_operands(name, q, k, v, kv_mask, dropout_rate, seed):
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
    if dropout_rate > 0.0:
        if seed is None or seed.shape != (5,) or seed.dtype != torch.int32:
            raise ValueError(f"{name}: dropout needs the (5,) int32 "
                             "seed_array")
        seed = seed.contiguous()
    else:
        seed = None
    return code, kv_mask, seed


def _meets_16_byte_rule(t) -> bool:
    """Whether the kernels that copy 16-byte chunks (the bf16 flash
    kernels, decode attention) can read ``t`` (B, S, H, D) with
    ``cp.async``: its base address and its (b, s, h) strides, over the
    dims longer than 1, are multiples of 16 bytes (the head dim is
    contiguous and 64 wide)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * size % 16 == 0 for i in range(3) if t.shape[i] > 1)


def _kernel_operand(t):
    """``t`` as the kernels read it: a bf16 operand that breaks the
    16-byte rule (:func:`_meets_16_byte_rule`) becomes a contiguous copy
    in new memory; every other operand, and every fp32 one (the fp32
    kernels read any stride), is passed as it lies."""
    if t.dtype != torch.bfloat16 or _meets_16_byte_rule(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _dropout_args(dropout_rate, seed):
    """(seed pointer, fp32 rate, fp32 divisor ``1 - rate`` rounded from
    double) for the C entry points; rate 0 selects the dropout-free
    kernel."""
    if dropout_rate > 0.0:
        return seed.data_ptr(), float(dropout_rate), float(1.0 - dropout_rate)
    return None, 0.0, 1.0


def _flash_cuda(q, k, v, kv_mask, causal, scale, dropout_rate, seed):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code, kv_mask, seed = _check_operands("flash_attention", q, k, v,
                                          kv_mask, dropout_rate, seed)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2))
    kernel = DROPOUT_KERNEL if dropout_rate > 0.0 else KERNEL
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if kv_mask is None else kv_mask.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), b, h, sq, sk, d,
                  ctypes.addressof(strides), float(scale), int(causal),
                  *_dropout_args(dropout_rate, seed), code,
                  stream_handle(q.device))
    return o, lse


def _bwd_launch_args(q, k, v, do, lse, delta, kv_mask, causal, scale,
                     dropout_rate, seed):
    """Checks the backward's operands and returns the pointer and scalar
    arguments B5 and B6 share (the strides array is kept alive beside
    them).  q, k, v and do go through :func:`_kernel_operand`: the bf16
    bodies of both read 16-byte lines."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    code, kv_mask, seed = _check_operands("flash_attention backward", q, k,
                                          v, kv_mask, dropout_rate, seed)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must be {tuple(q.shape)} in {q.dtype}; got "
                         f"{tuple(do.shape)} in {do.dtype}")
    for n, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{n} must be ({b}, {h}, {sq}) float32")
    if do.stride(-1) != 1:
        do = do.contiguous()
    q, k, v, do = (_kernel_operand(t) for t in (q, k, v, do))
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
              int(causal), *_dropout_args(dropout_rate, seed), code,
              stream_handle(q.device))
    # the tensors made here must outlive the launch
    keep = (strides, q, k, v, do, lse, delta, kv_mask, seed)
    return ptrs, common, keep


def _plain_bwd(q, k, v, do, lse, delta, kv_mask, seed):
    extra = tuple(t for t in (kv_mask, seed) if t is not None)
    return plain_path(q, k, v, do, lse, delta, *extra)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask, causal, scale,
                           dropout_rate: float = 0.0, seed=None):
    """dq (B, Sq, H, D) given the output gradient ``do``, the forward's
    lse and ``delta = rowsum(do * o) - dlse`` (B, H, Sq) fp32: the kernel
    B5 (B5d with dropout) for CUDA tensors, the plain version for CPU
    tensors.  A bf16 q, k, v or do whose base or (b, s, h) strides are
    not multiples of 16 bytes is read from a contiguous copy
    (:func:`_kernel_operand`)."""
    if _plain_bwd(q, k, v, do, lse, delta, kv_mask, seed):
        return _bwd_dq_reference(q, k, v, do, lse, delta, kv_mask, causal,
                                 scale, dropout_rate, seed)
    ptrs, common, _keep = _bwd_launch_args(q, k, v, do, lse, delta, kv_mask,
                                           causal, scale, dropout_rate, seed)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        kernel = DROPOUT_BWD_DQ_KERNEL if dropout_rate > 0.0 \
            else BWD_DQ_KERNEL
        kernel.launch(*ptrs, dq.data_ptr(), *common)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask, causal,
                            scale, dropout_rate: float = 0.0, seed=None):
    """(dk, dv) (B, Sk, H, D), from the same operands as
    :func:`flash_attention_bwd_dq`: the kernel B6 (B6d with dropout) for
    CUDA tensors, the plain version for CPU tensors.  A bf16 q, k, v or
    do whose base or (b, s, h) strides are not multiples of 16 bytes is
    read from a contiguous copy (:func:`_kernel_operand`)."""
    if _plain_bwd(q, k, v, do, lse, delta, kv_mask, seed):
        return _bwd_dkv_reference(q, k, v, do, lse, delta, kv_mask, causal,
                                  scale, dropout_rate, seed)
    ptrs, common, _keep = _bwd_launch_args(q, k, v, do, lse, delta, kv_mask,
                                           causal, scale, dropout_rate, seed)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel():
        kernel = DROPOUT_BWD_DKV_KERNEL if dropout_rate > 0.0 \
            else BWD_DKV_KERNEL
        kernel.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *common)
    return dk, dv


def flash_attention_fwd(q, k, v, kv_mask, causal, scale,
                        dropout_rate: float = 0.0, seed=None):
    """(o, lse) without autograd: the kernel B4 (B4d with dropout) for
    CUDA tensors, the plain version for CPU tensors.  A bf16 q, k or v
    whose base or (b, s, h) strides are not multiples of 16 bytes is read
    from a contiguous copy (:func:`_kernel_operand`)."""
    extra = tuple(t for t in (kv_mask, seed) if t is not None)
    if plain_path(q, k, v, *extra):
        return _reference(q, k, v, kv_mask, causal, scale, return_lse=True,
                          dropout_rate=dropout_rate, seed=seed)
    return _flash_cuda(q, k, v, kv_mask, causal, scale, dropout_rate, seed)


def flash_attention_bwd(q, k, v, do, lse, delta, kv_mask, causal, scale,
                        dropout_rate: float = 0.0, seed=None):
    """(dq, dk, dv): B5 then B6 (or their plain versions)."""
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, kv_mask, causal,
                                scale, dropout_rate, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask,
                                     causal, scale, dropout_rate, seed)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, causal, scale, dropout_rate):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale,
                                     dropout_rate, seed)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, seed)
        ctx.causal, ctx.scale, ctx.rate = causal, scale, dropout_rate
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_mask, seed = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.to(q.dtype)
        # delta in the (B, H, Sq) layout of lse; the lse cotangent folds
        # into it: d lse / d s = p, so ds = p * (dov - delta + dlse).
        # Under dropout o already carries the dropped probs, so delta
        # needs no change
        delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse,
                                         delta.contiguous(), kv_mask,
                                         ctx.causal, ctx.scale, ctx.rate,
                                         seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    return_lse: bool = False, dropout_rate: float = 0.0,
                    dropout_seed=None, dropout_offsets=None):
    """Exact attention without materialising the score matrix.

    Args:
      q, k, v: (B, S, H, D); q and k/v sequence lengths may differ.
      kv_mask: optional (B, Sk) additive key mask (0 keep / NEG_INF drop).
      causal: causal masking on global positions.
      scale: logit scale, default 1/sqrt(D).
      return_lse: also return the per-row log-sum-exp (B, H, Sq) fp32
        (NEG_INF for fully-masked rows).
      dropout_rate: attention-probability dropout in [0, 1), applied to
        the normalized probs inside the kernels; the lse stays the
        undropped statistic.
      dropout_seed: int32 scalar (Python int or 0-d tensor), required
        when ``dropout_rate`` > 0.  The mask is a pure function of (seed,
        batch*head, q, k), so the seed must differ per step and per
        layer.
      dropout_offsets: optional ``(row_offset, col_offset, head_offset,
        num_heads_total)`` translating this call's local coordinates to
        global ones; default ``(0, 0, 0, H)``.

    Returns (B, Sq, H, D) in q's dtype (and the lse).  Fully-masked rows
    give zeros.  Differentiable in q, k, v through both outputs (the
    mask gets no gradient).
    """
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"q/k/v must be (B, S, H, D) with matching B, H, "
                         f"D; got q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1); got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError(
            "flash_attention(dropout_rate>0) requires dropout_seed — a "
            "per-step int32 scalar (a fixed implicit seed would freeze "
            "the dropout mask across steps)")
    seed = None
    if dropout_rate > 0.0:
        seed = seed_array(dropout_seed, dropout_offsets,
                          num_heads=q.shape[2], device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _FlashFn.apply(q, k, v, kv_mask, seed, bool(causal),
                            float(scale), dropout_rate)
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


def dropout_params(dropout_fn):
    """``(rate, seed)`` from an ``attention_fn``-contract ``dropout_fn``:
    the models attach ``.rate`` (a float) and ``.seed`` (a per-step
    int32) to the dropout closure they hand a custom attention function,
    and the fused kernels consume those instead of calling the closure
    (which needs the materialized probs).  ``(0.0, None)`` for no
    ``dropout_fn``; raises for a closure without the annotation."""
    if dropout_fn is None:
        return 0.0, None
    rate = getattr(dropout_fn, "rate", None)
    seed = getattr(dropout_fn, "seed", None)
    if rate is None or seed is None:
        raise NotImplementedError(
            "this dropout_fn carries no (rate, seed) annotation, and a "
            "plain probs->probs dropout closure cannot run inside the "
            "fused kernel (the probs are never materialized). Attach "
            "`dropout_fn.rate` / `dropout_fn.seed` (see "
            "models.bert.BertSelfAttention) or set "
            "attention_probs_dropout_prob=0.")
    return float(rate), seed


def make_flash_attention(*, causal: bool = False, **kwargs):
    """Adapter with the ``attention_fn(q, k, v, bias, dropout_fn)``
    signature the models take; ``bias`` must be a key-position-only
    (B, 1, 1, Sk) additive mask.  Attention dropout runs in the kernels
    from the ``(rate, seed)`` annotation on ``dropout_fn``
    (:func:`dropout_params`), and its ``.offsets`` where a
    tensor-parallel model sets them (``dropout_offsets``)."""

    def attention_fn(q, k, v, bias=None, dropout_fn=None):
        rate, seed = dropout_params(dropout_fn)
        return flash_attention(q, k, v, kv_mask=bias_to_kv_mask(bias),
                               causal=causal, dropout_rate=rate,
                               dropout_seed=seed,
                               dropout_offsets=getattr(dropout_fn,
                                                       "offsets", None),
                               **kwargs)

    return attention_fn
