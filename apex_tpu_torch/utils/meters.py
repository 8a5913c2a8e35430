"""Training-loop meters (twin of ``apex_tpu/utils/meters.py``'s
``AverageMeter``; reference ``examples/imagenet/main_amp.py:445-460``)."""

from __future__ import annotations


class AverageMeter:
    """Tracks the latest value and the running (weighted) average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
