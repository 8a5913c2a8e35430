"""Cross-module amp state and rank-0-aware printing.

Twin of ``apex_tpu/amp/_amp_state.py``.  The mutable global holds only
configuration (verbosity, ``casts_disabled``, the active Properties); every
numeric state (loss scales, overflow flags) lives in explicit state
objects on the device.
"""

from __future__ import annotations

import torch


class AmpState:
    def __init__(self):
        self.verbosity = 1
        self.casts_disabled = False
        self.opt_properties = None


_amp_state = AmpState()


def _is_rank0() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def maybe_print(msg: str, rank0: bool = False):
    """Verbosity-gated print, optionally only on process 0 (the JAX
    package reads ``jax.process_index``; here the ``torch.distributed``
    rank when a process group is up)."""
    if _amp_state.verbosity > 0:
        if not rank0 or _is_rank0():
            print(msg)
