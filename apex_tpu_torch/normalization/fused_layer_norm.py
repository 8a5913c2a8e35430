"""FusedLayerNorm — layer normalization through hand-written CUDA kernels.

Twin of ``apex_tpu/normalization/fused_layer_norm.py``.  The input is
viewed as (n1, n2) with n2 = prod(normalized_shape); each row gets its
fp32 mean, two-pass biased variance and ``invvar = rsqrt(var + eps)``
whatever the input dtype.  On a CUDA tensor the ``csrc/layer_norm.cu``
kernels compute the forward (statistics and the affine step in one
pass, y in x's dtype) and the whole backward (dx, and the column sums
dweight and dbias the JAX package leaves to XLA); on a CPU tensor
:func:`_ln_forward_plain` and :func:`_ln_backward_plain` compute the
same functions in PyTorch (they are also the kernels' references in
``chip_smoke.py``).

:func:`fused_layer_norm_affine` and :func:`fused_layer_norm` are
``torch.autograd.Function``s on both devices, as the JAX functions are
``custom_vjp``s: the forward saves x and the fp32 mean/invvar, the
backward recomputes xhat from them.  dweight and dbias are fp32 sums
over the rows and come back in the weight's dtype, dx in x's.  The
kernels read fp32 or bf16 weights as they are (amp O2 keeps LayerNorm's
params in bf16) and widen them in registers; a weight of another dtype,
or a weight and bias of two dtypes, is read through fp32 copies.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._kernels.build import (
    DTYPE_CODES,
    Kernel,
    check_dtype,
    library,
    plain_path,
    stream_handle,
)

Shape = Union[int, Sequence[int]]

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("layer_norm_fwd", "apex_layer_norm_fwd",
                [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I,
                 _I, _P])
BWD_KERNEL = Kernel("layer_norm_bwd", "apex_layer_norm_bwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                     _I, _I, _P])
# the 16-byte paths of both kernels: rows of at most this many elements
_FAST_MAX_N2 = 1024


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


def _xhat(x2, mean, invvar):
    return (x2.float() - mean[:, None]) * invvar[:, None]


def _ln_backward_plain(dy2, x2, mean, invvar, weight, grad_input=True,
                       grad_weight=True):
    """LayerNorm's backward over rows: ``(dx, dweight, dbias)``, None for
    a gradient not asked for (``grad_input``, ``grad_weight``) and for
    dweight/dbias without a weight.  dx is the TPU kernel's
    ``invvar * (dy' - (sum(dy') + xhat * sum(dy' * xhat)) / n2)`` with
    ``dy' = dy * weight`` in fp32 and xhat recomputed from x, in x's
    dtype; dweight and dbias are ``_fla_bwd``'s fp32 column sums of
    ``dy * xhat`` and ``dy``, in the weight's dtype."""
    dy32 = dy2.float()
    xhat = _xhat(x2, mean, invvar)
    dx = dw = db = None
    if grad_input:
        dyw = dy32 if weight is None else dy32 * weight.float()[None, :]
        sum1 = dyw.sum(dim=1, keepdim=True)
        sum2 = (dyw * xhat).sum(dim=1, keepdim=True)
        dx = invvar[:, None] * (dyw - (sum1 + xhat * sum2) / x2.shape[1])
        dx = dx.to(x2.dtype)
    if grad_weight and weight is not None:
        dw = (dy32 * xhat).sum(dim=0).to(weight.dtype)
        db = dy32.sum(dim=0).to(weight.dtype)
    return dx, dw, db


def _fast_rows(n2, *tensors) -> bool:
    """Whether a kernel takes its 16-byte path: whole 16-byte chunks of
    ``tensors[0]``'s dtype a row, at most ``_FAST_MAX_N2`` elements (32
    a lane), and every operand 16-byte aligned.  The forward passes x,
    y and the affine weights; the backward dy, x, dx and the weight."""
    vec = 16 // tensors[0].element_size()
    return (n2 % vec == 0 and n2 <= _FAST_MAX_N2
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _kernel_weight(t: torch.Tensor) -> torch.Tensor:
    """An affine operand as the kernels read it: fp32 or bf16 as it is,
    another dtype as an fp32 copy."""
    return (t if t.dtype in DTYPE_CODES else t.float()).contiguous()


def _check_affine(weight, bias, n2):
    if (weight is None) != (bias is None):
        raise ValueError("weight and bias must be given together")
    if weight is not None and (weight.shape != (n2,) or bias.shape != (n2,)):
        raise ValueError(
            f"weight/bias must be ({n2},); got {tuple(weight.shape)} "
            f"and {tuple(bias.shape)}")


def layer_norm_fwd(x2: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float):
    """LayerNorm over the rows of ``x2`` (n1, n2), with the affine step
    ``* weight + bias`` when both are given.  Returns ``(y, mean,
    invvar)``: y in x's dtype, the statistics (n1,) fp32.  No autograd:
    :func:`fused_layer_norm_affine` is the differentiable form.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous fp32/bf16 rows and raises on anything else.
    Weight and bias are read in their dtype when both are fp32 or both
    bf16; any other pair goes through fp32 copies."""
    if x2.ndim != 2:
        raise ValueError(f"x2 must be (n1, n2); got {tuple(x2.shape)}")
    n1, n2 = x2.shape
    _check_affine(weight, bias, n2)
    affine = () if weight is None else (weight, bias)
    if plain_path(x2, *affine):
        xhat, mean, invvar = _ln_forward_plain(x2, eps)
        y = xhat if weight is None else (
            xhat * weight.float()[None, :] + bias.float()[None, :])
        return y.to(x2.dtype), mean, invvar
    code = check_dtype("layer_norm_fwd", x2)
    if not x2.is_contiguous():
        raise ValueError("layer_norm_fwd: x2 must be contiguous")
    if weight is not None and weight.dtype != bias.dtype:
        affine = (weight.float(), bias.float())
    affine = tuple(_kernel_weight(t) for t in affine)
    y = torch.empty_like(x2)
    mean = torch.empty((n1,), dtype=torch.float32, device=x2.device)
    invvar = torch.empty_like(mean)
    if n1 == 0:
        return y, mean, invvar
    fast = _fast_rows(n2, x2, y, *affine)
    w, b = (t.data_ptr() for t in affine) if affine else (None, None)
    KERNEL.launch(x2.data_ptr(), w, b, y.data_ptr(), mean.data_ptr(),
                  invvar.data_ptr(), n1, n2, float(eps), code,
                  DTYPE_CODES[affine[0].dtype] if affine else 0, int(fast),
                  stream_handle(x2.device))
    return y, mean, invvar


@functools.lru_cache(maxsize=None)
def _bwd_parts(n1: int, n2: int, code: int, w_code: int, fast: bool) -> int:
    """Partial rows (the kernel's grid) of a backward at this shape."""
    fn = library().apex_layer_norm_bwd_parts
    fn.argtypes = [_I, _I, _I, _I, _I]
    fn.restype = _I
    return fn(n1, n2, code, w_code, int(fast))


def layer_norm_bwd(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                   invvar: torch.Tensor, weight: Optional[torch.Tensor], *,
                   grad_input: bool = True, grad_weight: bool = True):
    """LayerNorm's backward over the rows of ``x2`` (n1, n2) given the
    output gradient ``dy2`` (n1, n2), the forward's fp32 ``mean`` and
    ``invvar`` (n1,) and the affine ``weight`` (n2,) or None.  Returns
    ``(dx, dweight, dbias)``: dx in x's dtype, dweight and dbias (the
    fp32 sums over rows of ``dy * xhat`` and ``dy``) in the weight's;
    None for a gradient not asked for (``grad_input``, ``grad_weight``)
    and for dweight/dbias without a weight.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32/bf16, dy in x's dtype): one call, counted once, runs the row
    kernel and, for the weight gradients, a column-sum kernel."""
    if x2.ndim != 2 or dy2.shape != x2.shape:
        raise ValueError(f"dy2 and x2 must be the same (n1, n2); got "
                         f"{tuple(dy2.shape)} and {tuple(x2.shape)}")
    n1, n2 = x2.shape
    if mean.shape != (n1,) or invvar.shape != (n1,):
        raise ValueError(f"mean/invvar must be ({n1},)")
    if weight is not None and weight.shape != (n2,):
        raise ValueError(f"weight must be ({n2},); got {tuple(weight.shape)}")
    w = () if weight is None else (weight,)
    if plain_path(dy2, x2, mean, invvar, *w):
        return _ln_backward_plain(dy2, x2, mean, invvar, weight, grad_input,
                                  grad_weight)
    code = check_dtype("layer_norm_bwd", x2)
    if dy2.dtype != x2.dtype:
        raise TypeError(f"layer_norm_bwd: dy dtype {dy2.dtype} != x dtype "
                        f"{x2.dtype}")
    if mean.dtype != torch.float32 or invvar.dtype != torch.float32:
        raise TypeError("layer_norm_bwd: mean/invvar must be float32")
    grad_weight = grad_weight and weight is not None
    x2 = x2.contiguous()
    dy2 = dy2.contiguous()
    mean = mean.contiguous()
    invvar = invvar.contiguous()
    dx = torch.empty_like(x2) if grad_input else None
    dw = db = w_dtype = None
    if grad_weight:
        # the kernel writes fp32 or bf16; another weight dtype is cast
        w_dtype = weight.dtype
        out_dtype = w_dtype if w_dtype in DTYPE_CODES else torch.float32
        dw, db = (torch.empty((n2,), dtype=out_dtype, device=x2.device)
                  for _ in range(2))
    w_code = 0
    if weight is not None:
        weight = _kernel_weight(weight)
        w_code = DTYPE_CODES[weight.dtype]
    if n1 == 0:
        if grad_weight:
            dw.zero_()
            db.zero_()
    elif grad_input or grad_weight:
        fast = _fast_rows(n2, dy2, x2, *(t for t in (dx, weight)
                                         if t is not None))
        parts = _bwd_parts(n1, n2, code, w_code, fast)
        part = torch.empty((parts, 2, n2), dtype=torch.float32,
                           device=x2.device) if grad_weight else None
        BWD_KERNEL.launch(*(None if t is None else t.data_ptr() for t in (
            dy2, x2, mean, invvar, weight, dx, part)), parts,
            *(None if t is None else t.data_ptr() for t in (dw, db)),
            w_code, n1, n2, int(fast), code, stream_handle(x2.device))
    if dw is not None and dw.dtype != w_dtype:
        dw, db = dw.to(w_dtype), db.to(w_dtype)
    return dx, dw, db


class _LayerNormFn(torch.autograd.Function):
    """y = LN(x2) [* weight + bias] over rows; B3 (or its plain version)
    computes dx, dweight and dbias in one call."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        y, mean, invvar = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, invvar)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mean, invvar = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(
            dy.to(x2.dtype), x2, mean, invvar, weight,
            grad_input=ctx.needs_input_grad[0],
            grad_weight=ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        return dx, dw, db, None


def _rows(x: torch.Tensor, ns: Tuple[int, ...]) -> torch.Tensor:
    if tuple(x.shape[x.ndim - len(ns):]) != ns:
        raise ValueError(
            f"input trailing dims {tuple(x.shape[x.ndim - len(ns):])} != "
            f"normalized_shape {ns}")
    n2 = 1
    for d in ns:
        n2 *= d
    return x.reshape(-1, n2).contiguous()


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """y = LN(x) * weight + bias over the trailing ``normalized_shape``
    dims, in x's dtype (reference ``fused_layer_norm_affine``);
    differentiable in x, weight and bias."""
    ns = _norm_shape(normalized_shape)
    y = _LayerNormFn.apply(_rows(x, ns), weight.reshape(-1),
                           bias.reshape(-1), eps)
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    """Non-affine LN over the trailing ``normalized_shape`` dims;
    differentiable in x."""
    ns = _norm_shape(normalized_shape)
    y = _LayerNormFn.apply(_rows(x, ns), None, None, eps)
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
