"""DCGAN generator and discriminator: the multi-model, multi-optimizer
workload.

Twin of ``apex_tpu/models/dcgan.py`` (Radford et al. 2016): the
Generator maps (B, z_dim) noise to (B, 64, 64, C) images in [-1, 1],
the Discriminator maps (B, 64, 64, C) images to (B,) float32 logits.
Both take and give NHWC, as the JAX models do, and run NCHW views
(``channels_last``) inside.

Modules carry flax's names: ``ConvTranspose_i`` and ``BatchNorm_i`` in
the Generator, ``Conv_i`` and ``BatchNorm_i`` in the Discriminator, so
:func:`dcgan_params_from_jax` is a rename and a change of kernel
layout.  The norm is a factory attribute (``norm``), by default the
copy of flax's ``nn.BatchNorm`` the ResNet uses (``models.resnet``);
the block norms are ``BatchNorm_i`` whatever their class.  Weights are
N(0, 0.02), drawn from a CPU ``torch.Generator`` seeded with ``seed``
(``seed=None`` leaves them for a caller that loads a state dict).

flax's ``ConvTranspose`` (``transpose_kernel=False``) slides its kernel
over the stride-dilated input without flipping it; torch's
``ConvTranspose2d`` is the adjoint of a convolution, which flips it.
So a flax kernel (kh, kw, in, out) is torch's (in, out, kh, kw) with
both spatial axes reversed, and flax's ``SAME`` at kernel 4, stride 2
is torch's ``padding=1``, its first ``VALID`` layer ``padding=0``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.models.resnet import _module_name, default_norm

ModuleDef = Any

INIT_STD = 0.02
IMAGE_SIZE = 64


def _init_normal(module: nn.Module, seed: int) -> None:
    """Every conv kernel N(0, 0.02) from one generator, in module order;
    the norms at their own init."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=gen) * INIT_STD)
            elif hasattr(mod, "scale_init"):
                mod.reset_parameters()


class Generator(nn.Module):
    """(B, z_dim) -> (B, 64, 64, out_channels): 1x1 -> 4x4 -> 8 -> 16 ->
    32 -> 64, each up-sampling but the last followed by the norm and a
    ReLU, then tanh."""

    def __init__(self, z_dim: int = 100, base_features: int = 64,
                 out_channels: int = 3, norm: ModuleDef = default_norm, *,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        self.z_dim = int(z_dim)
        f = int(base_features)
        widths = [self.z_dim, f * 8, f * 4, f * 2, f, out_channels]
        self.num_convs = len(widths) - 1
        for i in range(self.num_convs):
            stride, padding = (1, 0) if i == 0 else (2, 1)
            setattr(self, f"ConvTranspose_{i}", nn.ConvTranspose2d(
                widths[i], widths[i + 1], 4, stride, padding, bias=False,
                device=dev))
            if i < self.num_convs - 1:
                setattr(self, f"BatchNorm_{i}", norm(widths[i + 1],
                                                     device=dev))
        if seed is not None:
            _init_normal(self, seed)
        self.to(memory_format=torch.channels_last)

    def forward(self, z: torch.Tensor, train: Optional[bool] = None):
        train = self.training if train is None else bool(train)
        x = z.reshape(z.shape[0], self.z_dim, 1, 1)
        for i in range(self.num_convs - 1):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(
                x, use_running_average=not train))
        x = getattr(self, f"ConvTranspose_{self.num_convs - 1}")(x)
        return torch.tanh(x).permute(0, 2, 3, 1)      # NCHW -> NHWC


class Discriminator(nn.Module):
    """(B, 64, 64, C) -> (B,) float32 logits: four stride-2 convs (the
    last three followed by the norm) with leaky ReLU 0.2, then a 4x4
    ``VALID`` head.  Other image sizes raise, as the JAX model does."""

    def __init__(self, base_features: int = 64, norm: ModuleDef = default_norm,
                 in_channels: int = 3, *, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        f = int(base_features)
        widths = [in_channels, f, f * 2, f * 4, f * 8]
        for i in range(4):
            setattr(self, f"Conv_{i}", nn.Conv2d(
                widths[i], widths[i + 1], 4, 2, 1, bias=False, device=dev))
            if i > 0:
                setattr(self, f"BatchNorm_{i - 1}", norm(widths[i + 1],
                                                         device=dev))
        self.Conv_4 = nn.Conv2d(f * 8, 1, 4, 1, 0, bias=False, device=dev)
        if seed is not None:
            _init_normal(self, seed)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        if x.shape[1] != IMAGE_SIZE or x.shape[2] != IMAGE_SIZE:
            raise ValueError(
                f"DCGAN discriminator expects 64x64 inputs, got "
                f"{x.shape[1]}x{x.shape[2]}")
        train = self.training if train is None else bool(train)
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last
        for i in range(4):
            x = getattr(self, f"Conv_{i}")(x)
            if i > 0:
                x = getattr(self, f"BatchNorm_{i - 1}")(
                    x, use_running_average=not train)
            x = F.leaky_relu(x, 0.2)
        return self.Conv_4(x).reshape(x.shape[0]).float()


_LEAF = {"params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
         "batch_stats": {"mean": "running_mean", "var": "running_var"}}


def _kernel(module: str, arr: np.ndarray) -> np.ndarray:
    if module.startswith("ConvTranspose_"):
        # flax slides the kernel unflipped; torch's adjoint flips it
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)            # HWIO -> OIHW


def dcgan_params_from_jax(variables: Mapping[str, Any]) \
        -> Dict[str, torch.Tensor]:
    """A JAX ``Generator``'s or ``Discriminator``'s ``{"params": ...,
    "batch_stats": ...}`` (numpy or anything ``np.asarray`` takes) as
    the twin's ``state_dict``: ``Conv`` kernels HWIO -> OIHW,
    ``ConvTranspose`` kernels (kh, kw, in, out) -> (in, out, kh, kw)
    with both spatial axes reversed, ``scale``/``bias`` and
    ``mean``/``var`` -> ``weight``/``bias`` and
    ``running_mean``/``running_var`` (``SyncBatchNorm_i`` ->
    ``BatchNorm_i``).  fp32 tensors on the CPU, for
    ``load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for module, leaves in variables.get(collection, {}).items():
            for key, value in leaves.items():
                arr = np.array(value, dtype=np.float32)
                if key == "kernel":
                    arr = _kernel(module, arr)
                name = f"{_module_name(module)}.{_LEAF[collection][key]}"
                out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
