"""apex_tpu_torch.amp — automatic mixed precision (O0-O3).

Twin of ``apex_tpu.amp``: ``initialize`` with the opt-level presets, the
``scale_loss`` protocol, master weights, the O1 op-level cast policy
(``amp.patch``, installed on the ``torch`` namespaces), the precision
decorators and the legacy ``amp.init`` handles, on device-resident
state (the loss scale, overflow flag and skip-step never leave the
card)::

    model, optimizer = amp.initialize(model, FusedAdam(lr=3e-4),
                                      opt_level="O2")
    params = model.init()
    opt_state = optimizer.init(params)
    for ids in batches:
        loss = lm_loss(model.apply(params, ids), ids)
        with amp.scale_loss(loss, opt_state) as scaled:
            grads = torch.autograd.grad(scaled, list(params.values()))
        params, opt_state = optimizer.step(
            params, dict(zip(params, grads)), opt_state)
"""

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp._amp_state import maybe_print
from apex_tpu_torch.amp.compat_api import AmpHandle, NoOpHandle, \
    OptimWrapper, init
from apex_tpu_torch.amp.frontend import initialize
from apex_tpu_torch.amp.functional import (
    banned_function,
    float_function,
    half_function,
    master_params,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.handle import disable_casts, scale, scale_loss
from apex_tpu_torch.amp.model import AmpModel, applier, cast_tree
from apex_tpu_torch.amp.optimizer import AmpOptimizer, AmpOptimizerState
from apex_tpu_torch.amp.patch import install_o1_patches, remove_o1_patches
from apex_tpu_torch.amp.properties import (
    AmpOptimizationError,
    Properties,
    opt_levels,
)
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState

__all__ = [
    "AmpHandle",
    "NoOpHandle",
    "OptimWrapper",
    "init",
    "lists",
    "AmpModel",
    "AmpOptimizer",
    "AmpOptimizerState",
    "AmpOptimizationError",
    "LossScaler",
    "LossScalerState",
    "Properties",
    "applier",
    "cast_tree",
    "disable_casts",
    "float_function",
    "half_function",
    "initialize",
    "master_params",
    "maybe_print",
    "opt_levels",
    "promote_function",
    "register_float_function",
    "register_half_function",
    "register_promote_function",
    "scale",
    "scale_loss",
]
