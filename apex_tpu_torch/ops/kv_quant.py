"""Symmetric int8 absmax quantization of K/V vectors for the KV cache.

Twin of ``apex_tpu/ops/kv_quant.py``: the one numeric contract of the
quantized pool, shared by the model (which quantizes fresh K/V at the
projection), the pool (which stores the bytes and their fp32 scales)
and the attention ops (which widen them back at read, B8 inside the
decode kernel).  Plain PyTorch on both devices, as it is plain jnp in
the reference.

Absmax maps to +/-127 (never -128), so the grid is symmetric; an
all-zero vector takes scale 0 through a gated inverse (no division by
0, no NaN); the math is fp32 whatever the input dtype, and
dequantization is one fp32 multiply and one cast.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

INT8_QMAX = 127.0


def quantize_kv(x: torch.Tensor):
    """Quantize over the last axis (a K/V vector's head_dim): ``x``
    (..., D) float -> ``(q int8 (..., D), scale fp32 (...))`` with
    ``scale = absmax / 127`` and ``q = round(x / scale)`` clipped to
    [-127, 127].  Elementwise per vector, so the same value quantizes
    to the same bytes however the writes were batched."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # by a 0-d tensor on amax's device: PyTorch's CUDA division by a
    # Python scalar multiplies by its rounded reciprocal instead
    scale = amax / amax.new_full((), INT8_QMAX)
    inv = torch.where(scale > 0, scale.reciprocal(), 0.0)
    q = torch.round(xf * inv[..., None]).clamp_(-INT8_QMAX, INT8_QMAX) \
        .to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Widen int8 K/V to ``dtype``: ``q (..., D) int8, scale (...) fp32
    -> (..., D) dtype``, the product taken in fp32 and cast once."""
    return (q.float() * scale[..., None]).to(dtype)
