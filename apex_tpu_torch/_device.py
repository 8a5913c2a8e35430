"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port's entry points run on the card unless the caller asks
    for the CPU: ``device`` defaults to ``"cuda"``, and a CUDA device on
    a machine without CUDA raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        # "meta": shapes only (the tensor-parallel model reads the full
        # model's parameter shapes from a meta copy)
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
