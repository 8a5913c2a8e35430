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

The overflow decision is global.  Where the gradients are split over
ranks (the model group under tensor parallelism, the data group under
ZeRO-2), ``with_overflow_groups(*groups)`` reduces the flag with
``parallel.pmax_g`` over each before the skip and the scaler update, so
an inf on one rank skips the step on all of them; on GSPMD the JAX
package's flag is global by construction.

ZeRO: ``with_zero(group, like_params=...)`` passes through to an inner
optimizer that has ``with_zero`` (``FusedAdam``, flat or tree, and
``FusedLAMB``, whose per-leaf update runs on each rank's moment slices
with whole-leaf trust ratios), as the JAX package does.  An
optimizer in optax's protocol has none: there the JAX package's
per-leaf update follows the sharded state under GSPMD, and here the
returned optimizer runs it on each sharded leaf's slice and gathers the
params (``parallel.zero.zero1_update``).  ``zero2_step`` is amp's
protocol around ``parallel.zero2_update``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

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

    def __init__(self, inner, loss_scaler: LossScaler, num_losses: int = 1,
                 overflow_groups: Sequence = (), zero=None):
        self.inner = inner
        self.loss_scaler = loss_scaler
        self.num_losses = int(num_losses)
        self.overflow_groups = tuple(overflow_groups)
        self.zero = zero    # (group, min_shard_elems): ZeRO-1 per leaf

    def _copy(self, **kw) -> "AmpOptimizer":
        args = dict(inner=self.inner, loss_scaler=self.loss_scaler,
                    num_losses=self.num_losses,
                    overflow_groups=self.overflow_groups, zero=self.zero)
        args.update(kw)
        return AmpOptimizer(**args)

    def with_overflow_groups(self, *groups) -> "AmpOptimizer":
        """A copy that takes the overflow flag's max over each of
        ``groups`` (``parallel.ProcessGroup``s the gradients are split
        over) before it skips and updates the scale."""
        return self._copy(overflow_groups=self.overflow_groups + groups)

    def with_zero(self, group, min_shard_elems: Optional[int] = None,
                  like_params=None) -> "AmpOptimizer":
        """ZeRO-1 over ``group`` (the data ranks), to pair with
        ``parallel.shard_optimizer_state(state, group, min_shard_elems,
        like_params)``: the inner optimizer's own ``with_zero`` where it
        has one (``FusedAdam``, ``FusedLAMB``), else the per-leaf sharded
        update (module docstring).  ``like_params`` places the per-leaf
        moments of tensor-parallel or pipelined params (a model's
        ``tp_places()``)."""
        if hasattr(self.inner, "with_zero"):
            return self._copy(inner=self.inner.with_zero(
                group, min_shard_elems, like_params=like_params))
        if getattr(self.inner, "supports_fused_skip", False):
            raise NotImplementedError(
                f"{type(self.inner).__name__} has no ZeRO update")
        return self._copy(zero=(group, min_shard_elems))

    def _global(self, overflow: torch.Tensor, *groups) -> torch.Tensor:
        from apex_tpu_torch.parallel.collectives import pmax_g
        for group in groups + self.overflow_groups:
            overflow = pmax_g(overflow, group)
        return overflow

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
        overflow = self._global(overflow)
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
        elif self.zero is not None:
            from apex_tpu_torch.parallel.zero import zero1_update
            params_out, inner_out = zero1_update(
                self.inner, params, grads, state.inner, self.zero[0],
                ~overflow, self.zero[1])
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

    def zero2_step(self, params: Tree, grads: Tree, state: AmpOptimizerState,
                   group, loss_id: int = 0):
        """ZeRO-2 under amp: ``grads`` are this rank's LOCAL scaled
        gradients; the overflow flag is taken over ``group`` (and the
        overflow groups), ``parallel.zero2_update`` unscales inside B1's
        combined scale and skips inside its select, then the scaler
        updates.  Returns ``(params, state)``."""
        from apex_tpu_torch.parallel.zero import zero2_update
        sstate = state.loss_scalers[loss_id]
        overflow = self._global(self.loss_scaler.check_overflow(grads),
                                group)
        params, inner = zero2_update(self.inner, params, grads, state.inner,
                                     group,
                                     scale=self.loss_scaler.loss_scale(
                                         sstate),
                                     skip=overflow)
        state = self.update_scale(state, overflow, loss_id)
        skipped = overflow.to(torch.int32)
        return params, state._replace(
            inner=inner, applied_steps=state.applied_steps + (1 - skipped),
            skipped_steps=state.skipped_steps + skipped)

    def loss_scale(self, state: AmpOptimizerState, loss_id: int = 0):
        return state.loss_scalers[loss_id].loss_scale
