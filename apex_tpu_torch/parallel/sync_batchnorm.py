"""SyncBatchNorm: batch normalization with statistics merged across ranks.

Twin of ``apex_tpu/parallel/sync_batchnorm.py``, with its semantics:

- the forward merges each rank's (mean, biased var, count) exactly
  through two sums over the group: ``n = sum(c_r)``, ``mean =
  sum(c_r * mean_r) / n``, ``var = sum(c_r * (var_r + (mean_r -
  mean)^2)) / n`` (exact for unequal counts);
- the running variance takes the unbiased ``var * n / (n - 1)``, in
  fp32 whatever the input dtype (reference
  ``optimized_sync_batchnorm_kernel.py:39-51``);
- torch's momentum convention, ``running = (1 - m) * running + m *
  batch``, ``m = 0.1``;
- ``process_group`` (``create_syncbn_process_group``) limits the merge
  to this rank's group.

The statistics reduce over the given group, else over the default group
when ``torch.distributed`` is initialized, else they are this process's
own (a world of one).  The backward is autograd through the sums
(``collectives.psum_g``: the gradient of a sum over ranks is the sum of
the gradients), the same two reductions the reference writes by hand
(``sum_dy`` and ``sum_dy_xmu``, ``optimized_sync_batchnorm_kernel.py:
70-109``).

``welford_combine`` and ``merge_stats`` are the gather-then-merge form
of the same combination (Chan's parallel variance).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.models.resnet import BatchNorm
from apex_tpu_torch.parallel.collectives import psum_g
from apex_tpu_torch.parallel.mesh import WORLD, ProcessGroup


def welford_combine(mean_a, m2_a, n_a, mean_b, m2_b, n_b):
    """Chan's parallel variance combination: the exact merge of two
    (mean, M2, count) partitions (reference ``welford.cu:113-137``)."""
    n = n_a + n_b
    delta = mean_b - mean_a
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    mean = mean_a + delta * (n_b / safe_n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / safe_n)
    return mean, m2, n


def merge_stats(means, variances, counts):
    """Merge per-rank (mean, biased var, count) stacked on dim 0 into
    the global (mean, biased var, count), one rank after another.
    Shapes: means and variances (R, C), counts (R,) or (R, C)."""
    r = means.shape[0]
    counts = torch.broadcast_to(
        counts.reshape((r,) + (1,) * (means.ndim - 1)), means.shape)
    m2s = variances * counts
    mean, m2, n = means[0], m2s[0], counts[0]
    for i in range(1, r):
        mean, m2, n = welford_combine(mean, m2, n, means[i], m2s[i],
                                      counts[i])
    var = m2 / torch.where(n > 0, n, torch.ones_like(n))
    return mean, var, n


def _active_group(process_group: Optional[ProcessGroup]):
    if process_group is not None:
        return process_group
    if dist.is_available() and dist.is_initialized():
        return WORLD
    return None


class SyncBatchNorm(nn.Module):
    """Batch normalization over dim 1 (the channels of an NCHW view, or
    the features of (N, C)) with cross-rank statistics.  Parameters
    ``weight``/``bias`` and buffers ``running_mean``/``running_var`` in
    fp32; the output in x's dtype.  ``forward(x, use_running_average)``
    normalizes with the running statistics when asked, by default when
    the module is in eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, scale_init: Callable = nn.init.ones_,
                 process_group: Optional[ProcessGroup] = None, *,
                 device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale_init = scale_init
        self.process_group = process_group
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty(num_features, **f32))
        self.bias = nn.Parameter(torch.empty(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.reset_parameters()

    reset_parameters = BatchNorm.reset_parameters
    _use_running_average = BatchNorm._use_running_average

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        x32 = x.float()
        if self._use_running_average(use_running_average):
            mean, var = self.running_mean, self.running_var
        else:
            local_count = torch.full((), x.numel() // x.shape[1],
                                     dtype=torch.float32, device=x.device)
            local_mean = x32.mean(dims)
            local_var = (x32 * x32).mean(dims) - local_mean * local_mean
            group = _active_group(self.process_group)
            if group is not None:
                # one sum for the count and the weighted means, one for
                # the moments about the global mean
                summed = psum_g(torch.cat([local_mean * local_count,
                                           local_count.reshape(1)]), group)
                count = summed[-1]
                mean = summed[:-1] / count
                m2 = psum_g((local_var + torch.square(local_mean - mean))
                            * local_count, group)
                var = m2 / count
            else:
                mean, var, count = local_mean, local_var, local_count
            with torch.no_grad():
                unbiased = var * (count / torch.clamp_min(count - 1.0, 1.0))
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var + self.epsilon) \
            .view(shape)
        y = y * self.weight.float().view(shape)
        y = y + self.bias.float().view(shape)
        return y.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}")


def _sync_factory(norm, process_group):
    """A SyncBatchNorm factory for a BatchNorm factory, or None."""
    if norm is BatchNorm:
        # flax's default momentum 0.99 is torch's 0.01
        return functools.partial(SyncBatchNorm, momentum=1.0 - 0.99,
                                 process_group=process_group)
    if isinstance(norm, functools.partial) and norm.func is BatchNorm:
        kw = dict(norm.keywords)
        kw["momentum"] = 1.0 - kw.get("momentum", 0.99)
        kw.setdefault("process_group", process_group)
        return functools.partial(SyncBatchNorm, *norm.args, **kw)
    return None


def _convert_one(mod: nn.Module, process_group) -> Optional[SyncBatchNorm]:
    if isinstance(mod, BatchNorm):
        momentum = 1.0 - mod.momentum        # flax convention -> torch
        eps = mod.epsilon
    elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
        if mod.momentum is None:
            raise NotImplementedError(
                "SyncBatchNorm has no cumulative moving average "
                "(BatchNorm momentum=None)")
        if not (mod.affine and mod.track_running_stats):
            raise NotImplementedError(
                "SyncBatchNorm converts affine BatchNorms that track "
                "running statistics")
        momentum, eps = mod.momentum, mod.eps
    else:
        return None
    sync = SyncBatchNorm(mod.num_features, momentum=momentum, epsilon=eps,
                         process_group=process_group,
                         device=mod.weight.device)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(sync, name).copy_(getattr(mod, name))
    sync.train(mod.training)
    return sync


def convert_syncbn_model(module: nn.Module,
                         process_group: Optional[ProcessGroup] = None):
    """Replace every BatchNorm in ``module``'s tree (the port's flax-like
    :class:`~apex_tpu_torch.models.resnet.BatchNorm` or a
    ``torch.nn`` BatchNorm) with a :class:`SyncBatchNorm` holding its
    parameters and running statistics, momentum carried over in torch's
    convention (flax's ``m`` becomes ``1 - m``); a ``norm`` factory
    attribute that makes such BatchNorms becomes a SyncBatchNorm
    factory.  Module surgery, as the reference's
    (``apex/parallel/__init__.py:21-53``): returns the module, converted
    in place (a BatchNorm passed alone comes back as its
    SyncBatchNorm)."""
    converted = _convert_one(module, process_group)
    if converted is not None:
        return converted
    for mod in list(module.modules()):
        factory = _sync_factory(getattr(mod, "norm", None), process_group)
        if factory is not None:
            mod.norm = factory
        for name, child in list(mod.named_children()):
            new = _convert_one(child, process_group)
            if new is not None:
                setattr(mod, name, new)
    return module
