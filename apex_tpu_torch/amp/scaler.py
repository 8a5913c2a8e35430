"""Dynamic loss scaling as device-resident state.

Twin of ``apex_tpu/amp/scaler.py`` (reference ``apex/amp/scaler.py``):
the dynamic scale starts at 2**16, halves on overflow (clamped to
``min_loss_scale``), doubles after ``scale_window`` (2000) consecutive
overflow-free steps (clamped to ``max_loss_scale``, 2**24).

The state is three 0-d tensors on the device — scale fp32, unskipped
int32, overflow bool — and :meth:`LossScaler.update` is branch-free
``torch.where`` arithmetic, so the overflow decision never travels to
the host (the reference's ``_overflow_buf.item()`` sync is gone).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.multi_tensor import multi_tensor_axpby, \
    multi_tensor_unscale, tree_any_nonfinite

Tree = Any


class LossScalerState(NamedTuple):
    loss_scale: torch.Tensor   # fp32 0-d, current scale
    unskipped: torch.Tensor    # int32 0-d, overflow-free steps since change
    overflow: torch.Tensor     # bool 0-d, did the last step overflow


class LossScaler:
    """Static hyperparameters + functions over :class:`LossScalerState`.

    ``loss_scale``: ``"dynamic"`` or a fixed float."""

    def __init__(self, loss_scale: Union[str, float, int] = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24):
        if loss_scale == "dynamic":
            self.dynamic = True
            self._init_scale = float(init_scale)
        else:
            self.dynamic = False
            self._init_scale = float(loss_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = float(max_loss_scale)

    def init(self, device="cuda") -> LossScalerState:
        """The starting state on ``device``: the card unless the caller
        asks for the CPU (``device="cpu"``)."""
        device = resolve_device(device)
        return LossScalerState(
            loss_scale=torch.full((), self._init_scale, dtype=torch.float32,
                                  device=device),
            unskipped=torch.zeros((), dtype=torch.int32, device=device),
            overflow=torch.zeros((), dtype=torch.bool, device=device))

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScalerState) -> torch.Tensor:
        """``loss.float() * scale``."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Tree, state: LossScalerState, *,
                out_dtype=None):
        """``(grads / scale, overflow)``."""
        return multi_tensor_unscale(grads, state.loss_scale,
                                    out_dtype=out_dtype)

    def unscale_with_stashed(self, grads: Tree, stashed: Tree,
                             state: LossScalerState):
        """``(stashed + grads / scale, overflow)``, the grad-accumulation
        path: only ``grads`` can trip the flag."""
        inv = 1.0 / state.loss_scale
        return multi_tensor_axpby(inv, grads, 1.0, stashed, arg_to_check=0)

    def check_overflow(self, grads: Tree) -> torch.Tensor:
        """Whether any leaf of ``grads`` holds a non-finite value (a 0-d
        device bool)."""
        return tree_any_nonfinite(grads)

    def update(self, state: LossScalerState, overflow) -> LossScalerState:
        """Post-step scale adjustment, branch-free on the device."""
        if not isinstance(overflow, torch.Tensor):
            overflow = torch.full((), bool(overflow), dtype=torch.bool,
                                  device=state.loss_scale.device)
        if not self.dynamic:
            return state._replace(overflow=overflow)
        scale = state.loss_scale
        down = scale / self.scale_factor
        if self.min_loss_scale is not None:
            down = down.clamp_min(float(self.min_loss_scale))
        unskipped = torch.where(overflow, 0, state.unskipped + 1)
        grow = unskipped >= self.scale_window
        up = (scale * self.scale_factor).clamp_max(self.max_loss_scale)
        new_scale = torch.where(overflow, down, torch.where(grow, up, scale))
        unskipped = torch.where(grow, 0, unskipped)
        return LossScalerState(loss_scale=new_scale, unskipped=unskipped,
                               overflow=overflow)

    def loss_scale(self, state: LossScalerState) -> torch.Tensor:
        return state.loss_scale
