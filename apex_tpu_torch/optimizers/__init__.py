from apex_tpu_torch.optimizers.fused_adam import FusedAdam, FusedAdamState

__all__ = ["FusedAdam", "FusedAdamState"]
