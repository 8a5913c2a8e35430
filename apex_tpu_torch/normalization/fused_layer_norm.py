"""FusedLayerNorm — layer normalization through a hand-written CUDA kernel.

Twin of ``apex_tpu/normalization/fused_layer_norm.py`` (forward only:
the serving path runs no backward).  The input is viewed as (n1, n2)
with n2 = prod(normalized_shape); each row gets its fp32 mean, two-pass
biased variance and ``invvar = rsqrt(var + eps)`` whatever the input
dtype.  On a CUDA tensor the ``csrc/layer_norm.cu`` kernel computes the
statistics and the affine step in one pass and writes y in x's dtype;
on a CPU tensor :func:`_ln_forward_plain` computes the same function in
PyTorch (it is also the kernel's reference in ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._kernels.build import (
    Kernel,
    check_dtype,
    plain_path,
    stream_handle,
)

Shape = Union[int, Sequence[int]]

_P = ctypes.c_void_p
KERNEL = Kernel("layer_norm_fwd", "apex_layer_norm_fwd",
                [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, _P])


def _norm_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


def _ln_forward_plain(x2: torch.Tensor, eps: float):
    """(n1, n2) -> (xhat fp32, mean fp32, invvar fp32): the TPU kernel's
    arithmetic — fp32 mean, two-pass variance."""
    x32 = x2.float()
    mean = x32.mean(dim=1)
    d = x32 - mean[:, None]
    var = (d * d).mean(dim=1)
    invvar = torch.rsqrt(var + eps)
    return d * invvar[:, None], mean, invvar


def layer_norm_fwd(x2: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float):
    """LayerNorm over the rows of ``x2`` (n1, n2), with the affine step
    ``* weight + bias`` when both are given.  Returns ``(y, mean,
    invvar)``: y in x's dtype, the statistics (n1,) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous fp32/bf16 rows and raises on anything else."""
    if (weight is None) != (bias is None):
        raise ValueError("weight and bias must be given together")
    if x2.ndim != 2:
        raise ValueError(f"x2 must be (n1, n2); got {tuple(x2.shape)}")
    n1, n2 = x2.shape
    affine = () if weight is None else (weight, bias)
    if plain_path(x2, *affine):
        xhat, mean, invvar = _ln_forward_plain(x2, eps)
        y = xhat if weight is None else (
            xhat * weight.float()[None, :] + bias.float()[None, :])
        return y.to(x2.dtype), mean, invvar
    code = check_dtype("layer_norm_fwd", x2)
    if not x2.is_contiguous():
        raise ValueError("layer_norm_fwd: x2 must be contiguous")
    if weight is not None:
        if weight.shape != (n2,) or bias.shape != (n2,):
            raise ValueError(
                f"weight/bias must be ({n2},); got {tuple(weight.shape)} "
                f"and {tuple(bias.shape)}")
        weight = weight.float().contiguous()
        bias = bias.float().contiguous()
    y = torch.empty_like(x2)
    mean = torch.empty((n1,), dtype=torch.float32, device=x2.device)
    invvar = torch.empty_like(mean)
    if n1 == 0:
        return y, mean, invvar
    KERNEL.launch(x2.data_ptr(),
                  None if weight is None else weight.data_ptr(),
                  None if bias is None else bias.data_ptr(),
                  y.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
                  n1, n2, float(eps), code, stream_handle(x2.device))
    return y, mean, invvar


def _rows(x: torch.Tensor, ns: Tuple[int, ...]) -> torch.Tensor:
    if tuple(x.shape[x.ndim - len(ns):]) != ns:
        raise ValueError(
            f"input trailing dims {tuple(x.shape[x.ndim - len(ns):])} != "
            f"normalized_shape {ns}")
    n2 = 1
    for d in ns:
        n2 *= d
    return x.reshape(-1, n2)


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """y = LN(x) * weight + bias over the trailing ``normalized_shape``
    dims, in x's dtype (reference ``fused_layer_norm_affine``)."""
    ns = _norm_shape(normalized_shape)
    y, _, _ = layer_norm_fwd(_rows(x, ns), weight.reshape(-1),
                             bias.reshape(-1), eps)
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    """Non-affine LN over the trailing ``normalized_shape`` dims."""
    ns = _norm_shape(normalized_shape)
    y, _, _ = layer_norm_fwd(_rows(x, ns), None, None, eps)
    return y.reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """Module form; ``elementwise_affine`` adds params named ``scale`` and
    ``bias`` (the JAX module's names), initialised to ones and zeros."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.scale = nn.Parameter(torch.ones(
                self.normalized_shape, device=dev, dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, device=dev, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.scale, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)
