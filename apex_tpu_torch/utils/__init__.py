"""apex_tpu_torch.utils — training-loop utilities.

Twin of ``apex_tpu.utils``: :class:`AverageMeter`, :class:`CounterMeter`,
:func:`maybe_print`, :mod:`.checkpoint` (one-call save and restore of a
whole train state) and :func:`load_torch_resnet` / :func:`load_hf_bert`
(torchvision ResNet and HuggingFace BERT checkpoints, from
:mod:`.torch_interop`).
"""

from apex_tpu_torch.amp._amp_state import maybe_print
from apex_tpu_torch.utils import checkpoint
from apex_tpu_torch.utils.meters import AverageMeter, CounterMeter
from apex_tpu_torch.utils.torch_interop import load_hf_bert, \
    load_torch_resnet

__all__ = ["AverageMeter", "CounterMeter", "checkpoint", "load_hf_bert",
           "load_torch_resnet", "maybe_print"]
