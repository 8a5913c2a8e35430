"""MNIST-scale MLP: the minimal end-to-end amp exercise.

Twin of ``apex_tpu/models/mlp.py`` (flax's ``Dense_i`` + ReLU per width,
then the classifier ``Dense_{n}``; BASELINE.json config 1 is an
"examples/simple amp O1 MNIST MLP").  The layers keep flax's module
names, so :func:`mlp_params_from_jax` is a rename and a transpose.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device


class MLP(nn.Module):
    """``x.reshape(B, -1)`` -> (Linear -> ReLU) per width in ``features``
    -> Linear to ``num_classes``.  ``in_features`` is the flattened input
    width (flax infers it at ``init``).  ``seed`` draws the weights
    normal(0, 1/fan_in) from a CPU ``torch.Generator``, layer by layer,
    with zero biases, so a seed gives the same weights on any device;
    ``seed=None`` leaves PyTorch's default init for callers that load a
    state dict.  ``device`` defaults to the card."""

    def __init__(self, features: Sequence[int] = (1024, 1024),
                 num_classes: int = 10, in_features: int = 784, *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        widths = [in_features, *features, num_classes]
        self.num_layers = len(widths) - 1
        for i in range(self.num_layers):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1],
                                                  device=dev, dtype=dtype))
        if seed is not None:
            self.reset_parameters(seed)

    def _layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))
        for lin in self._layers():
            fan_in = lin.in_features
            lin.weight.copy_(torch.randn(lin.out_features, fan_in,
                                         generator=gen) * fan_in ** -0.5)
            lin.bias.zero_()

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        *hidden, head = self._layers()
        for lin in hidden:
            x = F.relu(lin(x))
        return head(x)


def mlp_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX MLP's param tree (``{"params": ...}`` or its inner dict,
    leaves as arrays) as this model's ``state_dict``: each flax
    ``Dense_i`` ``kernel`` (in, out) becomes ``Dense_i.weight`` (out,
    in), its ``bias`` carries over."""
    p = params.get("params", params)
    sd = {}
    for name, leaf in p.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.array(leaf["kernel"], np.float32).T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32))
    return sd
