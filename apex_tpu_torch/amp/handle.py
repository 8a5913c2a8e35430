"""Per-iteration amp protocol: ``scale_loss`` / ``disable_casts``.

Twin of ``apex_tpu/amp/handle.py``.  ``scale_loss`` is the entry half of
the reference's context manager: it yields ``loss.float() * scale`` from
the optimizer *state*; the exit half (unscale, scale update, skip-step)
is ``AmpOptimizer.step``.
"""

from __future__ import annotations

import contextlib

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.optimizer import AmpOptimizerState
from apex_tpu_torch.amp.scaler import LossScalerState


def _resolve_scaler_state(state, loss_id: int) -> LossScalerState:
    if isinstance(state, LossScalerState):
        return state
    if isinstance(state, AmpOptimizerState):
        return state.loss_scalers[loss_id]
    raise TypeError(
        "scale_loss needs a LossScalerState or AmpOptimizerState (pass the "
        f"optimizer *state*, not the optimizer object); got {type(state)}")


@contextlib.contextmanager
def scale_loss(loss, state, loss_id: int = 0):
    """``with amp.scale_loss(loss, opt_state) as scaled_loss:`` yields
    ``loss.float() * loss_scale``; differentiate the scaled loss, then
    ``AmpOptimizer.step`` unscales."""
    props = _amp_state._amp_state.opt_properties
    if props is not None and not props.enabled:
        yield loss
        return
    yield loss.float() * _resolve_scaler_state(state, loss_id).loss_scale


def scale(loss, state, loss_id: int = 0):
    """Function form of :func:`scale_loss` for non-context-manager use."""
    with scale_loss(loss, state, loss_id) as s:
        return s


@contextlib.contextmanager
def disable_casts():
    """Code under this context runs without amp's casts: the O1 op
    policy, the decorators of ``amp.functional`` and ``AmpModel``'s
    parameter and input casts (reference ``handle.py:160``)."""
    old = _amp_state._amp_state.casts_disabled
    _amp_state._amp_state.casts_disabled = True
    try:
        yield
    finally:
        _amp_state._amp_state.casts_disabled = old
