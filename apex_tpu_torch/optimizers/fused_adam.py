"""FusedAdam — Adam over one flat fp32 buffer through a CUDA kernel (B1).

Twin of ``apex_tpu/optimizers/fused_adam.py`` with the flat layout.  The
update (``_adam_math`` there, reference ``fused_adam_cuda_kernel.cu``):

    g     = grad / combined_scale
    m     = beta1*m + (1-beta1)*g
    v     = beta2*v + (1-beta2)*g*g
    denom = sqrt(v + eps)  (eps_inside_sqrt)  |  sqrt(v) + eps
    p    -= step_size * (m/denom + weight_decay*p)

with ``step_size = lr * sqrt(1-beta2^t) / (1-beta1^t)`` under bias
correction, ``t = max(step, 1)`` in fp32, computed with torch ops on the
device.  ``step(..., skip=overflow)`` runs amp's skip-step inside the
kernel: a skipped step leaves p, m, v and the step counter unchanged,
and no value is read back to the host.

The port's flat layout differs from the JAX one in where the masters
live: the state holds the flat fp32 parameter buffer ``p`` beside m and
v, and ``step`` returns the parameters as *views* of it, so the kernel
updates them in place and no unflatten copy is made.  Parameters that
are not such views (the first step, or O3's half params) are copied in
first, and half leaves are cast back out, as the JAX step does.  p, m
and v are updated in place: a state passed to ``step`` is consumed.

Not here yet: ``max_grad_norm``, ``param_groups``, ``layout="tree"``,
``add_param_group``, ``with_zero`` and ``output_params_dtype``.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch._kernels.build import Kernel, plain_path, stream_handle
from apex_tpu_torch.ops.flatten import FlatSpec, flatten, flatten_like, \
    unflatten

Tree = Any

# the flat buffers are padded to a multiple of this many elements, so
# the kernel's 128-bit (4-float) accesses divide them exactly
PAD_TO = 128

_P = ctypes.c_void_p
KERNEL = Kernel("fused_adam", "apex_fused_adam",
                [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P])


class FusedAdamState(NamedTuple):
    step: torch.Tensor   # int32 0-d, steps taken (skipped ones excluded)
    m: torch.Tensor      # fp32 flat
    v: torch.Tensor      # fp32 flat
    p: torch.Tensor      # fp32 flat master parameters
    spec: FlatSpec


def _adam_plain(p, m, v, g, scalars, eps_inside_sqrt: bool):
    """Plain PyTorch version of the kernel: returns new (p, m, v) from
    the 7 scalars [step_size, beta1, beta2, eps, combined_scale,
    weight_decay, keep]; ``keep`` selects new or old values with a
    where, never a blend (an overflowed g is inf/nan)."""
    step_size, beta1, beta2, eps, cs, wd, keep = scalars.unbind()
    g = g / cs
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    if eps_inside_sqrt:
        denom = torch.sqrt(v_new + eps)
    else:
        denom = torch.sqrt(v_new) + eps
    p_new = p - step_size * (m_new / denom + wd * p)
    tag = keep > 0.5
    return (torch.where(tag, p_new, p), torch.where(tag, m_new, m),
            torch.where(tag, v_new, v))


def adam_flat(p, m, v, g, scalars, eps_inside_sqrt: bool) -> None:
    """One Adam step over flat fp32 ``p``, ``m``, ``v`` in place, from
    grads ``g`` and the 7 device scalars.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    bufs = (p, m, v, g)
    n = p.numel()
    if any(t.dtype != torch.float32 or t.ndim != 1 or t.numel() != n
           for t in bufs):
        raise ValueError("adam_flat: p, m, v, g must be 1-D float32 of "
                         "one length")
    if scalars.shape != (7,) or scalars.dtype != torch.float32:
        raise ValueError("adam_flat: scalars must be (7,) float32")
    if plain_path(*bufs, scalars):
        new = _adam_plain(p, m, v, g, scalars, eps_inside_sqrt)
        for buf, val in zip((p, m, v), new):
            buf.copy_(val)
        return
    if n % 4 or any(not t.is_contiguous() or t.data_ptr() % 16
                    for t in bufs):
        raise ValueError("adam_flat: the kernel needs contiguous 16-byte "
                         "aligned buffers whose length divides by 4")
    KERNEL.launch(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                  scalars.contiguous().data_ptr(), n, int(eps_inside_sqrt),
                  stream_handle(p.device))


def _full(x, device):
    return torch.full((), float(x), dtype=torch.float32, device=device)


class FusedAdam:
    """Adam over flat buffers (reference ``fused_adam.py:5-49``): ``lr``,
    ``bias_correction``, ``betas``, ``eps``, ``eps_inside_sqrt``,
    ``weight_decay``.  ``init(params)`` and
    ``step(params, grads, state, scale=1.0, skip=None)`` take trees
    (e.g. a ``{name: tensor}`` dict) of parameters and gradients."""

    # AmpOptimizer hands the overflow flag to step(skip=...): the
    # skip-step select runs inside the kernel
    supports_fused_skip = True

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 eps_inside_sqrt: bool = False, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        self.lr = float(lr)
        self.bias_correction = bias_correction
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.eps_inside_sqrt = bool(eps_inside_sqrt)
        self.weight_decay = float(weight_decay)

    def init(self, params: Tree) -> FusedAdamState:
        flat, spec = flatten(params, dtype=torch.float32, pad_to=PAD_TO)
        return FusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=flat.device),
            m=torch.zeros_like(flat), v=torch.zeros_like(flat), p=flat,
            spec=spec)

    def params(self, state: FusedAdamState) -> Tree:
        """The parameters as views of the state's master buffer (cast
        back where a leaf is not fp32), ready for autograd."""
        with torch.no_grad():
            tree = unflatten(state.p, state.spec)
        return pytree.tree_map(
            lambda t: t.requires_grad_(t.is_floating_point()), tree)

    def _are_views(self, params: Tree, state: FusedAdamState) -> bool:
        base = state.p.data_ptr()
        leaves = pytree.tree_leaves(params)
        return len(leaves) == len(state.spec.offsets) and all(
            t.dtype == torch.float32 and t.device == state.p.device
            and t.is_contiguous() and tuple(t.shape) == shape
            and t.data_ptr() == base + 4 * off
            for t, shape, off in zip(leaves, state.spec.shapes,
                                     state.spec.offsets))

    def _scalars(self, step, scale, keep):
        dev = step.device
        beta1, beta2 = self.betas
        if self.bias_correction:
            # a skipped first step leaves step at 0, where 1 - beta^0 = 0:
            # clamp to 1; that step_size only feeds a discarded result
            t = step.clamp_min(1).float()
            step_size = self.lr * torch.sqrt(1.0 - torch.pow(beta2, t)) \
                / (1.0 - torch.pow(beta1, t))
        else:
            step_size = _full(self.lr, dev)
        cs = (scale.float().reshape(()) if isinstance(scale, torch.Tensor)
              else _full(scale, dev))
        return torch.stack([step_size, _full(beta1, dev), _full(beta2, dev),
                            _full(self.eps, dev), cs,
                            _full(self.weight_decay, dev), keep])

    def _update(self, p, m, v, g, scalars) -> None:
        adam_flat(p, m, v, g, scalars, self.eps_inside_sqrt)

    def step(self, params: Tree, grads: Tree, state: FusedAdamState,
             scale=1.0, skip=None):
        """Apply one update; returns ``(params, state)`` with params as
        views of ``state.p``.  ``skip`` (a bool or 0-d bool tensor):
        amp's overflow skip, selected inside the kernel."""
        p = state.p
        with torch.no_grad():
            if not self._are_views(params, state):
                p.copy_(flatten_like(params, state.spec, dtype=torch.float32,
                                     pad_to=PAD_TO))
            g = flatten_like(grads, state.spec, dtype=torch.float32,
                             pad_to=PAD_TO)
            if g.shape != p.shape:
                raise ValueError(f"grads flatten to {g.numel()} elements, "
                                 f"the state holds {p.numel()}")
            if skip is None:
                keep = _full(1.0, p.device)
                step = state.step + 1
            else:
                if not isinstance(skip, torch.Tensor):
                    skip = torch.full((), bool(skip), device=p.device)
                keep = 1.0 - skip.float().reshape(())
                # a skipped step leaves the bias-correction clock alone
                step = state.step + keep.to(torch.int32)
            self._update(p, state.m, state.v, g,
                         self._scalars(step, scale, keep))
        new_state = state._replace(step=step)
        return self.params(new_state), new_state
