"""ResNet family (v1.5), the flagship benchmark model.

Twin of ``apex_tpu/models/resnet.py``: torchvision's layout (7x7 stem,
max pool, four stages, global average pool, fc) with the stride of a
Bottleneck on its 3x3 conv, and the JAX model's choices kept:

- the input is NHWC, as the JAX model takes it; the forward views it as
  NCHW, which is PyTorch's ``channels_last`` layout with no copy, and
  the conv weights are stored ``channels_last`` too, so cuDNN runs the
  convs in NHWC;
- the norm layer is a factory attribute (``norm``), so
  ``parallel.convert_syncbn_model`` can swap it from outside; the
  default, :data:`default_norm`, is a copy of flax's ``nn.BatchNorm``
  as the JAX model configures it (:class:`BatchNorm`);
- the classifier runs in fp32 on the parameters it is given: under amp
  O2 those are the bf16-rounded ones, cast up for the product;
- ``stem`` ``"conv"``, ``"s2d"`` or ``"s2d_pre"``: the space-to-depth
  stems compute the conv stem's function with a 4x4 stride-1 kernel
  over the input folded 2x2 into channels (:func:`stem_to_s2d`).

Modules carry flax's names, so the parameter names map one to one onto
the JAX model's variables (:func:`resnet_params_from_jax`): the stem is
``stem_conv`` (``stem_conv_s2d``) and ``stem_bn``, the blocks are
``BasicBlock_k`` / ``Bottleneck_k`` numbered across stages, and inside
a block ``Conv_i``, ``BatchNorm_i``, ``downsample_conv`` and
``downsample_bn``.  A block's norms are ``BatchNorm_i`` whatever their
class: the JAX model names them after the norm class (``SyncBatchNorm_i``
under ``--sync_bn``), the port keeps one name so that module surgery
needs no renaming.  amp's O2 keeps every such parameter fp32 (its
patterns match ``BatchNorm`` and ``_bn``).

Running statistics are module buffers (``running_mean``,
``running_var``), fp32 at every opt level, updated in place by a
training forward (on an overflowed step too, as the JAX step's
``batch_stats`` are).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device

ModuleDef = Any

IMAGE_CHANNELS = 3        # RGB

# flax's truncated normal is cut at two standard deviations and rescaled
# so the kept part has the requested variance
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """Copy of flax's ``nn.BatchNorm`` over the channel dim (dim 1 of an
    NCHW view).  Statistics in fp32 whatever the input dtype: mean and
    ``var = max(0, E[x^2] - mean^2)``, the biased batch variance, which
    is also what the running variance takes; flax's momentum convention
    (``running = momentum * running + (1 - momentum) * batch``).  The
    output takes the promoted dtype of x and the parameters, as flax's
    does (fp32 for bf16 x and fp32 parameters: amp's O2 casts it back).
    """

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, scale_init: Callable = nn.init.ones_,
                 *, device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale_init = scale_init
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty(num_features, **f32))
        self.bias = nn.Parameter(torch.empty(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale_init(self.weight)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _use_running_average(self, use_running_average) -> bool:
        if use_running_average is None:
            return not self.training
        return bool(use_running_average)

    def batch_stats(self, x32: torch.Tensor, dims):
        """(mean, biased var) of fp32 ``x32`` over ``dims``, flax's fast
        variance."""
        mean = x32.mean(dims)
        mean2 = (x32 * x32).mean(dims)
        return mean, torch.clamp_min(mean2 - mean * mean, 0.0)

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """``use_running_average`` defaults to ``not self.training``."""
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self._use_running_average(use_running_average):
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self.batch_stats(x.float(), dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        y = x - mean.view(shape)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = y * mul.view(shape)
        y = y + self.bias.view(shape)
        out_dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        return y.to(out_dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}")


# the JAX model's norm: flax BatchNorm at torch's defaults (flax momentum
# 0.9 is torch's 0.1; eps 1e-5)
default_norm = functools.partial(BatchNorm, momentum=0.9, epsilon=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False,
                     device=device)


class BasicBlock(nn.Module):
    """2-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, norm: ModuleDef,
                 strides: int = 1, *, device=None):
        super().__init__()
        self.Conv_0 = _conv(in_features, filters, 3, strides, 1, device)
        self.BatchNorm_0 = norm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, 1, 1, device)
        # zero-init the last norm's scale (torchvision's zero_init_residual)
        self.BatchNorm_1 = norm(filters, scale_init=nn.init.zeros_,
                                device=device)
        self.has_downsample = strides != 1 or in_features != filters
        if self.has_downsample:
            self.downsample_conv = _conv(in_features, filters, 1, strides,
                                         0, device)
            self.downsample_bn = norm(filters, device=device)

    def forward(self, x, train: bool = True):
        ra = not train
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), use_running_average=ra))
        y = self.BatchNorm_1(self.Conv_1(y), use_running_average=ra)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x),
                                          use_running_average=ra)
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 block with 4x expansion (ResNet-50/101/152),
    v1.5: the stride lives on the 3x3."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, norm: ModuleDef,
                 strides: int = 1, *, device=None):
        super().__init__()
        out = filters * 4
        self.Conv_0 = _conv(in_features, filters, 1, device=device)
        self.BatchNorm_0 = norm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, strides, 1, device)
        self.BatchNorm_1 = norm(filters, device=device)
        self.Conv_2 = _conv(filters, out, 1, device=device)
        self.BatchNorm_2 = norm(out, scale_init=nn.init.zeros_,
                                device=device)
        self.has_downsample = strides != 1 or in_features != out
        if self.has_downsample:
            self.downsample_conv = _conv(in_features, out, 1, strides, 0,
                                         device)
            self.downsample_bn = norm(out, device=device)

    def forward(self, x, train: bool = True):
        ra = not train
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), use_running_average=ra))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), use_running_average=ra))
        y = self.BatchNorm_2(self.Conv_2(y), use_running_average=ra)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x),
                                          use_running_average=ra)
        return F.relu(residual + y)


def _permute(x, perm):
    return x.permute(*perm) if isinstance(x, torch.Tensor) \
        else x.transpose(perm)


def space_to_depth(x, block: int = 2):
    """NHWC (B, H, W, C) -> (B, H/b, W/b, b*b*C), channel order (dh, dw,
    c), the layout :func:`stem_to_s2d` folds the stem kernel into.
    Takes numpy arrays (the host input pipeline) and tensors alike."""
    b_, h, w, c = x.shape
    x = x.reshape(b_, h // block, block, w // block, block, c)
    return _permute(x, (0, 1, 3, 2, 4, 5)).reshape(
        b_, h // block, w // block, block * block * c)


def s2d_input_transform(x):
    """NHWC (B, H, W, C) -> (B, (H+6)/2, (W+6)/2, 4C): pad 4 before and 2
    after each spatial dim, then :func:`space_to_depth`.  ``stem="s2d"``
    runs it inside the forward; ``stem="s2d_pre"`` takes input the
    pipeline already transformed (``data.s2d_batches``, on the host)."""
    if isinstance(x, torch.Tensor):
        x = F.pad(x, (0, 0, 4, 2, 4, 2))
    else:
        x = np.pad(x, ((0, 0), (4, 2), (4, 2), (0, 0)))
    return space_to_depth(x, 2)


def stem_to_s2d(weight: torch.Tensor) -> torch.Tensor:
    """Fold a (F, C, 7, 7) stride-2 stem weight into the equivalent
    (F, 4C, 4, 4) stride-1 weight over :func:`s2d_input_transform`'s
    layout: zero-pad the kernel to 8x8 at the top-left, then fold each
    2x2 spatial sub-block into channels in (dh, dw, c) order."""
    f, c, kh, kw = weight.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem_to_s2d needs a 7x7 kernel; got {(kh, kw)}")
    k = weight.permute(2, 3, 1, 0)                      # HWIO
    k8 = k.new_zeros((8, 8, c, f))
    k8[1:, 1:] = k
    k8 = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return k8.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1).contiguous()


class ResNet(nn.Module):
    """Input NHWC (for ``stem="s2d_pre"``: already in
    :func:`s2d_input_transform`'s layout), output (B, num_classes) fp32
    logits.  ``forward(x, train=None)``: ``train`` defaults to the
    module's training mode; a training forward normalizes with batch
    statistics and updates the running ones.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``device="cpu"`` is passed.  ``seed`` draws the JAX model's
    initializers (variance scaling 2.0 fan-out truncated normal for the
    convs, lecun normal for fc, zero-init last norm scale in each
    block) from a CPU ``torch.Generator``; ``seed=None`` leaves them for
    a caller that loads a state dict."""

    def __init__(self, stage_sizes: Sequence[int], block: ModuleDef,
                 num_classes: int = 1000, width: int = 64,
                 norm: ModuleDef = default_norm, stem: str = "conv", *,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__()
        if stem not in ("conv", "s2d", "s2d_pre"):
            raise ValueError(f"stem must be 'conv', 's2d' or 's2d_pre', "
                             f"got {stem!r}")
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.block = block
        self.norm = norm
        self.stem = stem
        self.width = width
        if stem == "conv":
            self.stem_conv = _conv(IMAGE_CHANNELS, width, 7, 2, 3, dev)
        else:
            self.stem_conv_s2d = _conv(4 * IMAGE_CHANNELS, width, 4,
                                       device=dev)
        self.stem_bn = norm(width, device=dev)
        self.block_names = []
        features = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                name = f"{block.__name__}_{len(self.block_names)}"
                filters = width * 2 ** i
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(name, block(features, filters, norm,
                                            strides, device=dev))
                self.block_names.append(name)
                features = filters * block.expansion
        self.fc = nn.Linear(features, num_classes, device=dev)
        if seed is not None:
            self.reset_parameters(seed)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(int(seed))

        def trunc(shape, std):
            w = torch.empty(shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std / _TRUNC_STD, -2 * std
                                  / _TRUNC_STD, 2 * std / _TRUNC_STD,
                                  generator=gen)
            return w

        for name, mod in self.named_modules():
            if isinstance(mod, nn.Conv2d):
                o, _, kh, kw = mod.weight.shape
                mod.weight.copy_(trunc(mod.weight.shape,
                                       math.sqrt(2.0 / (o * kh * kw))))
            elif isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                mod.weight.copy_(trunc(mod.weight.shape,
                                       math.sqrt(1.0 / fan_in)))
                mod.bias.zero_()
            elif hasattr(mod, "scale_init"):          # the norms
                mod.reset_parameters()

    def forward(self, x: torch.Tensor, train: Optional[bool] = None):
        train = self.training if train is None else bool(train)
        if self.stem == "s2d":
            h, w = x.shape[1], x.shape[2]
            if h % 2 or w % 2:
                raise ValueError(
                    f"stem='s2d' needs even spatial dims; got {(h, w)}")
            x = s2d_input_transform(x)
        x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last
        x = self.stem_conv(x) if self.stem == "conv" \
            else self.stem_conv_s2d(x)
        x = F.relu(self.stem_bn(x, use_running_average=not train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train=train)
        x = x.mean(dim=(2, 3))
        # classifier in fp32: the product is small and feeds a softmax
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())


def _resnet(stages, block):
    def build(num_classes: int = 1000, norm: ModuleDef = default_norm,
              width: int = 64, stem: str = "conv", *, device="cuda",
              seed: Optional[int] = 0) -> ResNet:
        return ResNet(stages, block, num_classes=num_classes, norm=norm,
                      width=width, stem=stem, device=device, seed=seed)
    return build


ResNet18 = _resnet([2, 2, 2, 2], BasicBlock)
ResNet34 = _resnet([3, 4, 6, 3], BasicBlock)
ResNet50 = _resnet([3, 4, 6, 3], Bottleneck)
ResNet101 = _resnet([3, 4, 23, 3], Bottleneck)
ResNet152 = _resnet([3, 8, 36, 3], Bottleneck)


# -- weights from the JAX model ------------------------------------------------

_LEAF = {"params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
         "batch_stats": {"mean": "running_mean", "var": "running_var"}}


def _module_name(part: str) -> str:
    # a block's norms are named after their class in flax
    # (SyncBatchNorm_i under --sync_bn); the port names them BatchNorm_i
    if part.startswith("SyncBatchNorm_"):
        return "BatchNorm_" + part[len("SyncBatchNorm_"):]
    return part


def resnet_params_from_jax(variables: Mapping[str, Any]) \
        -> Dict[str, torch.Tensor]:
    """The JAX ResNet's ``{"params": ..., "batch_stats": ...}`` trees (numpy
    or anything ``np.asarray`` takes) as this model's ``state_dict``: conv
    kernels HWIO -> OIHW, the fc kernel (I, O) -> (O, I), flax's
    ``scale``/``bias`` and ``mean``/``var`` -> ``weight``/``bias`` and
    ``running_mean``/``running_var``, module names as flax made them
    (``SyncBatchNorm_i`` -> ``BatchNorm_i``).  The inverse of the mapping
    the JAX package documents for torchvision checkpoints, on flax's
    own names.  Load with ``load_state_dict`` (fp32 tensors on the CPU;
    ``load_state_dict`` copies them into the model's device and
    layout)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, collection):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [_module_name(key)], collection)
                continue
            arr = np.array(value, dtype=np.float32)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = ".".join(prefix + [_LEAF[collection][key]])
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), [], collection)
    return out
