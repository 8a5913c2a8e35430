"""AmpOptimizer — loss-scale-aware optimizer wrapper with the skip-step.

Twin of ``apex_tpu/amp/optimizer.py``.  The canonical params handed to
``step`` are already the fp32 masters (``amp/model.py``), so there is no
half/fp32 group splitting; the overflow -> skip-step protocol is a
device bool.  A fused optimizer consumes it inside its update
(``supports_fused_skip``: FusedAdam's kernel, FusedLAMB's per-leaf
selects); any other optimizer in optax's protocol (``init`` and
``update(grads, state, params)``, e.g. ``optimizers.transforms.sgd``)
runs ``update`` and ``apply_updates``, then a ``torch.where`` over the
params and over its whole state picks the new or the old values, so an
overflowed step keeps every bit of both, a schedule's count included.
Neither path reads a value back to the host.

Gradient accumulation: ``unscale_grads(stashed=..., update_scale=False)``
adds each microbatch's unscaled grads into the stash and leaves the
scaler where it was; the step ends with one ``update_scale`` on the
ORed overflow and one ``apply_gradients``.

Not here yet: ``with_zero``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.optimizers.transforms import apply_updates

Tree = Any


class AmpOptimizerState(NamedTuple):
    inner: Any                                  # wrapped optimizer's state
    loss_scalers: Tuple[LossScalerState, ...]   # one per loss
    applied_steps: torch.Tensor                 # int32, steps taken
    skipped_steps: torch.Tensor                 # int32, overflow-skipped


def _tree_select(keep: torch.Tensor, on_true: Tree, on_false: Tree):
    """``torch.where(keep, new, old)`` leaf by leaf over two trees of one
    structure (tensor leaves only)."""
    return pytree.tree_map(lambda t, f: torch.where(keep, t, f),
                           on_true, on_false)


class AmpOptimizer:
    """Wraps an optimizer with unscale, overflow and skip logic: a fused
    one (``init(params)`` and ``step(params, grads, state, skip=...)``,
    ``supports_fused_skip = True``) or one in optax's protocol
    (``init(params)`` and ``update(grads, state, params)``)."""

    def __init__(self, inner, loss_scaler: LossScaler, num_losses: int = 1):
        self.inner = inner
        self.loss_scaler = loss_scaler
        self.num_losses = int(num_losses)

    def init(self, params: Tree) -> AmpOptimizerState:
        inner = self.inner.init(params)
        device = next(t for t in pytree.tree_leaves(params)
                      if isinstance(t, torch.Tensor)).device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return AmpOptimizerState(
            inner=inner,
            loss_scalers=tuple(self.loss_scaler.init(device)
                               for _ in range(self.num_losses)),
            applied_steps=zero, skipped_steps=zero.clone())

    def unscale_grads(self, grads: Tree, state: AmpOptimizerState,
                      loss_id: int = 0, *, stashed: Optional[Tree] = None,
                      update_scale: bool = True):
        """Unscale one loss's grads to fp32 and update its scale; returns
        ``(grads, overflow, new_state)``.  With ``stashed`` the result is
        ``stashed + grads / scale`` and only ``grads`` can overflow;
        ``update_scale=False`` leaves the scaler as it was, for one
        :meth:`update_scale` on the ORed flag at the end of the step."""
        sstate = state.loss_scalers[loss_id]
        if stashed is None:
            g, overflow = self.loss_scaler.unscale(grads, sstate,
                                                   out_dtype=torch.float32)
        else:
            g, overflow = self.loss_scaler.unscale_with_stashed(
                grads, stashed, sstate)
        if not update_scale:
            return g, overflow, state
        return g, overflow, self.update_scale(state, overflow, loss_id)

    def update_scale(self, state: AmpOptimizerState, overflow,
                     loss_id: int = 0) -> AmpOptimizerState:
        new = self.loss_scaler.update(state.loss_scalers[loss_id], overflow)
        scalers = tuple(new if i == loss_id else s
                        for i, s in enumerate(state.loss_scalers))
        return state._replace(loss_scalers=scalers)

    def apply_gradients(self, params: Tree, grads: Tree,
                        state: AmpOptimizerState, overflow):
        """The inner step with the overflow skip: inside a fused
        optimizer's update, else a select between the updated and the old
        params and inner state."""
        if getattr(self.inner, "supports_fused_skip", False):
            params_out, inner_out = self.inner.step(params, grads,
                                                    state.inner,
                                                    skip=overflow)
        else:
            keep = ~overflow
            with torch.no_grad():
                updates, new_inner = self.inner.update(grads, state.inner,
                                                       params)
                new_params = apply_updates(params, updates)
                params_out = _tree_select(keep, new_params, params)
                inner_out = _tree_select(keep, new_inner, state.inner)
            params_out = pytree.tree_map(
                lambda new, old: new.requires_grad_(old.requires_grad),
                params_out, params)
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
