"""Greedy on-device sampling primitives for the serving engine.

Twin of the greedy half of ``apex_tpu/ops/sampling.py``; the stochastic
suite (temperature / top-k / top-p with counter-keyed noise) is not
ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["finite_rows", "greedy_argmax"]


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) logits -> (…,) int32 argmax token ids, on the logits'
    device.

    The FIRST maximum wins (``np.argmax``'s rule), by construction:
    max, then equality, then the minimum index among the maxima — the
    reference's decomposition, which does not depend on how a backend's
    fused argmax breaks ties.  A row whose max is NaN matches nothing and
    clamps to the last id; :func:`finite_rows` flags such rows."""
    v = logits.shape[-1]
    m = logits.amax(dim=-1, keepdim=True)
    iota = torch.arange(v, device=logits.device, dtype=torch.int32)
    idx = torch.where(logits == m, iota, torch.full_like(iota, v))
    return idx.amin(dim=-1).clamp_max(v - 1).to(torch.int32)


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(…, V) logits -> (…,) bool: True where every entry of the row is
    finite."""
    return torch.isfinite(logits).all(dim=-1)
