"""Legacy amp API shims: ``amp.init`` handles and ``OptimWrapper``.

Twin of ``apex_tpu/amp/compat_api.py``.  The reference keeps the old
handle-based API alive (``amp.init()`` -> ``AmpHandle``/``NoOpHandle``
with ``wrap_optimizer`` and a per-handle ``scale_loss``,
``apex/amp/amp.py:68``, ``handle.py:166-277``, ``opt.py:9``) beside
``amp.initialize``; these shims keep old call sites working on the
functional core.  New code should use ``amp.initialize``.
"""

from __future__ import annotations

import contextlib
import warnings

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp import handle as _handle
from apex_tpu_torch.amp.optimizer import AmpOptimizer
from apex_tpu_torch.amp.properties import Properties
from apex_tpu_torch.amp.scaler import LossScaler


class AmpHandle:
    """Legacy handle (reference ``handle.py:166``): owns a loss-scale
    setting and wraps optimizers on request."""

    def __init__(self, loss_scale="dynamic", enable_caching: bool = True,
                 verbose: bool = False):
        self._enabled = True
        self._loss_scale = loss_scale
        self._verbose = verbose

    @property
    def is_active(self):
        return self._enabled

    @property
    def has_cache(self):
        # the reference's weight-cast cache: each call casts afresh here,
        # reported True for API compatibility as the JAX package does
        return True

    def wrap_optimizer(self, optimizer, num_loss: int = 1) -> AmpOptimizer:
        """The reference's ``OptimWrapper`` construction (``opt.py:9``):
        the loss-scale-aware optimizer wrapper."""
        scaler = (LossScaler("dynamic") if self._loss_scale == "dynamic"
                  else LossScaler(float(self._loss_scale)))
        return AmpOptimizer(optimizer, scaler, num_losses=num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer_state, loss_id: int = 0):
        with _handle.scale_loss(loss, optimizer_state, loss_id) as s:
            yield s

    def _deactivate(self):
        self._enabled = False


class NoOpHandle:
    """Disabled-amp handle (reference ``handle.py:250``)."""

    is_active = False
    has_cache = False

    def wrap_optimizer(self, optimizer, num_loss: int = 1) -> AmpOptimizer:
        return AmpOptimizer(optimizer, LossScaler(1.0), num_losses=num_loss)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer_state, loss_id: int = 0):
        yield loss

    def _deactivate(self):
        pass


def init(enabled: bool = True, loss_scale="dynamic",
         enable_caching: bool = True, verbose: bool = False, **kwargs):
    """Legacy entry point (reference ``amp.py:68``).  Prefer
    ``amp.initialize``."""
    warnings.warn(
        "amp.init is the legacy handle API; prefer amp.initialize "
        "(opt_level presets).", DeprecationWarning, stacklevel=2)
    if not enabled:
        return NoOpHandle()
    props = Properties()
    props.enabled = True
    props.opt_level = "O1"
    props.cast_ops = True
    props.loss_scale = loss_scale
    _amp_state._amp_state.opt_properties = props
    return AmpHandle(loss_scale, enable_caching, verbose)


# the reference's class name, for old imports
OptimWrapper = AmpOptimizer
