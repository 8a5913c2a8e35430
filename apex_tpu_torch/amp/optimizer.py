"""AmpOptimizer — loss-scale-aware optimizer wrapper with the skip-step.

Twin of ``apex_tpu/amp/optimizer.py``.  The canonical params handed to
``step`` are already the fp32 masters (``amp/model.py``), so there is no
half/fp32 group splitting; the overflow -> skip-step protocol is a
device bool that the fused optimizer consumes inside its update
(``supports_fused_skip``: FusedAdam's kernel, FusedLAMB's per-leaf
selects), so a skipped step needs no host sync.

Not here yet: the wrapper-level select for optimizers without a fused
skip (the ``optax`` path), gradient accumulation into stashed grads
(``unscale_grads(stashed=...)``) and ``with_zero``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState

Tree = Any


class AmpOptimizerState(NamedTuple):
    inner: Any                                  # wrapped optimizer's state
    loss_scalers: Tuple[LossScalerState, ...]   # one per loss
    applied_steps: torch.Tensor                 # int32, steps taken
    skipped_steps: torch.Tensor                 # int32, overflow-skipped


class AmpOptimizer:
    """Wraps a fused optimizer (``init(params)`` and
    ``step(params, grads, state, skip=...)``, whose state has a ``step``
    counter tensor) with unscale, overflow and skip logic."""

    def __init__(self, inner, loss_scaler: LossScaler, num_losses: int = 1):
        if not getattr(inner, "supports_fused_skip", False):
            raise NotImplementedError(
                f"{type(inner).__name__} has no fused skip-step; only "
                "optimizers with one (FusedAdam, FusedLAMB) are ported so "
                "far")
        self.inner = inner
        self.loss_scaler = loss_scaler
        self.num_losses = int(num_losses)

    def init(self, params: Tree) -> AmpOptimizerState:
        inner = self.inner.init(params)
        # the step counter lies where the state does, whether the moments
        # are one flat buffer (FusedAdam) or trees (FusedLAMB)
        device = inner.step.device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return AmpOptimizerState(
            inner=inner,
            loss_scalers=tuple(self.loss_scaler.init(device)
                               for _ in range(self.num_losses)),
            applied_steps=zero, skipped_steps=zero.clone())

    def unscale_grads(self, grads: Tree, state: AmpOptimizerState,
                      loss_id: int = 0):
        """Unscale one loss's grads to fp32 and update its scale; returns
        ``(grads, overflow, new_state)``."""
        g, overflow = self.loss_scaler.unscale(
            grads, state.loss_scalers[loss_id], out_dtype=torch.float32)
        return g, overflow, self.update_scale(state, overflow, loss_id)

    def update_scale(self, state: AmpOptimizerState, overflow,
                     loss_id: int = 0) -> AmpOptimizerState:
        new = self.loss_scaler.update(state.loss_scalers[loss_id], overflow)
        scalers = tuple(new if i == loss_id else s
                        for i, s in enumerate(state.loss_scalers))
        return state._replace(loss_scalers=scalers)

    def apply_gradients(self, params: Tree, grads: Tree,
                        state: AmpOptimizerState, overflow):
        """The inner step with the overflow skip inside its kernel."""
        params_out, inner_out = self.inner.step(params, grads, state.inner,
                                                skip=overflow)
        skipped = overflow.to(torch.int32)
        return params_out, state._replace(
            inner=inner_out,
            applied_steps=state.applied_steps + (1 - skipped),
            skipped_steps=state.skipped_steps + skipped)

    def step(self, params: Tree, grads: Tree, state: AmpOptimizerState,
             loss_id: int = 0):
        """unscale -> scaler update -> inner step with skip, in one call;
        returns ``(params, state)``."""
        g, overflow, state = self.unscale_grads(grads, state, loss_id)
        return self.apply_gradients(params, g, state, overflow)

    def loss_scale(self, state: AmpOptimizerState, loss_id: int = 0):
        return state.loss_scalers[loss_id].loss_scale
