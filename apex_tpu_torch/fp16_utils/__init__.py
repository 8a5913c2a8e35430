"""apex_tpu_torch.fp16_utils — the manual mixed-precision toolkit (legacy
API).

Twin of ``apex_tpu.fp16_utils`` (reference ``apex/fp16_utils``): the
half-conversion helpers, master-parameter copies, the legacy loss scalers
and the general ``FP16_Optimizer``, as functions over parameter dicts
``{name: tensor}``.  ``apex_tpu_torch.amp`` supersedes this toolkit, as
in the reference.
"""

from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    FP16Model,
    clip_grad_norm,
    convert_network,
    convert_tree,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    tofp16,
)
from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, \
    LossScaler
from apex_tpu_torch.fp16_utils.fp16_optimizer import (
    FP16OptimizerState,
    FP16_Optimizer,
)

__all__ = [
    "BN_convert_float",
    "DynamicLossScaler",
    "FP16Model",
    "FP16OptimizerState",
    "FP16_Optimizer",
    "LossScaler",
    "clip_grad_norm",
    "convert_network",
    "convert_tree",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "network_to_half",
    "prep_param_lists",
    "tofp16",
]
