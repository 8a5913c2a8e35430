from apex_tpu_torch.amp._amp_state import maybe_print
from apex_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter", "maybe_print"]
