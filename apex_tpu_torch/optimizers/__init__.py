from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, FusedLAMBState

__all__ = ["FusedAdam", "FusedAdamState", "FusedLAMB", "FusedLAMBState"]
