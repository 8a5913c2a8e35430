"""apex_tpu_torch.optimizers — fused optimizers and their helpers.

Twin of ``apex_tpu.optimizers``: FusedAdam (flat, grouped flat and tree
layouts) with the cut-down FP16_Optimizer, FusedLAMB, the param-group
declarations (:mod:`.param_groups`) and optax's transformations
(:mod:`.transforms`).
"""

from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, FusedLAMBState
from apex_tpu_torch.optimizers.fp16_optimizer import (
    FP16_Optimizer,
    FP16OptimizerState,
)
from apex_tpu_torch.optimizers import param_groups

__all__ = [
    "FP16_Optimizer",
    "FP16OptimizerState",
    "FusedAdam",
    "FusedAdamState",
    "FusedLAMB",
    "FusedLAMBState",
    "param_groups",
]
