"""Legacy loss scalers for the manual ``FP16_Optimizer`` API.

Twin of ``apex_tpu/fp16_utils/loss_scaler.py`` (reference
``apex/fp16_utils/loss_scaler.py``): ``LossScaler`` (a static scale,
:10-44) and ``DynamicLossScaler`` (:47-140; init 2**32, halve on
overflow, double after 1000 clean steps).  Unlike the device-resident
``apex_tpu_torch.amp.LossScaler``, these are stateful host-side objects,
as the legacy API is eager: ``has_overflow`` reads whether any gradient
is non-finite back to the host (one sync, where the reference checks
each parameter on the CPU, :84-110) and ``update_scale`` mutates the
object.  Use the amp scaler for a step that never syncs.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.ops.multi_tensor import tree_any_nonfinite

Tree = Any


class LossScaler:
    """Static loss scaler (reference :10-44): the scale never changes and
    no overflow is ever reported."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = float(scale)

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def has_overflow(self, grads: Tree) -> bool:  # reference :21-23
        return False

    def update_scale(self, overflow: bool) -> None:  # reference :28-29
        pass

    def scale_gradient(self, grads: Tree) -> Tree:
        """The gradients times the scale (the reference's backward hook
        ``scale_gradient`` :25-26, as a tree map)."""
        return pytree.tree_map(lambda g: g * self.cur_scale, grads)

    def unscale_gradient(self, grads: Tree) -> Tree:
        inv = 1.0 / self.cur_scale
        return pytree.tree_map(lambda g: g.float() * inv, grads)

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """The scaled loss (the reference runs ``(loss * scale)
        .backward()``, :31-44; differentiating it is the caller's job)."""
        return loss.float() * self.cur_scale


class DynamicLossScaler(LossScaler):
    """Dynamic loss scaler (reference :47-140): starts huge and backs off.
    ``init_scale=2**32``, ``scale_factor=2``, ``scale_window=1000``: the
    legacy defaults, not amp's (2**16, window 2000)."""

    def __init__(self, init_scale: float = 2.0 ** 32,
                 scale_factor: float = 2.0, scale_window: int = 1000):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.last_overflow_iter = -1
        self.iter = 0

    def has_overflow(self, grads: Tree) -> bool:
        """Whether any gradient holds a non-finite value (reference
        ``has_overflow``/``_has_inf_or_nan`` :84-110): one host sync."""
        return bool(tree_any_nonfinite(grads))

    def update_scale(self, overflow: bool) -> None:
        """Reference :115-127: halve on overflow (not below 1); double
        after ``scale_window`` clean iterations."""
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor, 1.0)
            self.last_overflow_iter = self.iter
        elif (self.iter - self.last_overflow_iter) % self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.iter += 1
