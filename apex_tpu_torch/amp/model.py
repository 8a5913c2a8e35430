"""Model-side casting: the twin of ``apex_tpu/amp/model.py``.

The JAX package keeps a model's canonical variables fp32 (the master
weights) and casts them to the compute dtype inside ``apply``; autodiff
through the cast routes the half cotangents back to the fp32 masters.
Here the model is an ``nn.Module`` and the canonical parameters are a
dict ``{name: tensor}`` the caller owns (``AmpModel.init``).
``AmpModel.apply(params, *args)`` casts them per call and runs the
module through ``torch.func.functional_call``, so autograd routes the
bf16 gradients back to the fp32 masters as fp32 — the same flow.

- O0: everything fp32; O1 and O2: compute in half, canonical fp32
  masters; O3: canonical params stored in half (no masters).
- Parameters on paths matching ``keep_fp32_patterns`` stay fp32: under
  O1 every norm layer and MoE router (``NORM_PATTERNS +
  ROUTER_PATTERNS``), under O2 BatchNorm and the routers.  Patterns are
  matched against the components of the dotted parameter name, as the
  JAX package matches flax path components: GPT's ``attn_ln``,
  ``mlp_ln`` and ``final_ln`` match ``_ln$`` (fp32 under O1) and none
  of O2's patterns (GPT trains all-half under O2).
- Float inputs are cast to the compute dtype; integer inputs (token
  ids) are not.
- A kept-fp32 *norm* module's float32 output is recast to the half
  compute dtype (the JAX package's norm-output seam mend), so one fp32
  norm does not drag the rest of the network up to fp32.
- Under ``amp.disable_casts()`` none of these casts happens.

``AmpModel.loss_and_grad_1f1b`` is the pipeline models' 1F1B entry:
the cast params swapped into the module for that method (a
``functional_call`` of a wrapper whose ``forward`` calls it), the
gradients returned in the canonical params' dtypes.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.properties import Properties

BATCHNORM_PATTERNS = (r"BatchNorm", r"SyncBatchNorm", r"^bn(_|\d|$)",
                      r"_bn$")
NORM_PATTERNS = BATCHNORM_PATTERNS + (r"LayerNorm", r"GroupNorm", r"RMSNorm",
                                      r"^norm(_|\d|$)", r"_norm$",
                                      r"^ln(_|\d|$)", r"_ln$")
ROUTER_PATTERNS = (r"^router$",)


def _path_matches(name: str, patterns) -> bool:
    parts = name.split(".")
    return any(re.search(pat, part) for pat in patterns for part in parts)


def _module_matches(name: str, module: nn.Module, patterns) -> bool:
    """Does a module look like one of ``patterns``, by its class name or
    its own (last) name component?"""
    names = [type(module).__name__, name.rsplit(".", 1)[-1]]
    return any(re.search(pat, n) for pat in patterns for n in names if n)


def cast_tree(params: Dict[str, torch.Tensor], dtype, *,
              except_patterns: Sequence[str] = ()):
    """Cast the float tensors of ``params`` to ``dtype``; names matching
    ``except_patterns`` and non-float tensors pass through."""
    out = {}
    for name, x in params.items():
        if not x.is_floating_point() or (
                except_patterns and _path_matches(name, except_patterns)):
            out[name] = x
        else:
            out[name] = x.to(dtype)
    return out


def applier(value, cast_fn: Callable):
    """Apply ``cast_fn`` to the float tensors inside nested dicts, lists
    and tuples (named tuples included); everything else passes."""
    if isinstance(value, torch.Tensor):
        return cast_fn(value) if value.is_floating_point() else value
    if isinstance(value, dict):
        return {k: applier(v, cast_fn) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(applier(v, cast_fn) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(applier(v, cast_fn) for v in value)
    return value


class AmpModel:
    """Casting wrapper around an ``nn.Module``, returned by
    ``amp.initialize``.  ``init()`` gives the canonical parameters,
    ``apply(params, *args, **kwargs)`` runs the module on them in the
    opt level's compute layout."""

    def __init__(self, module: nn.Module, properties: Properties,
                 keep_fp32_patterns: Optional[Sequence[str]] = None):
        self.module = module
        self._properties = properties
        p = properties
        self.half_dtype = (p.cast_model_type
                           if p.cast_model_type not in (None, False)
                           else torch.bfloat16)
        if keep_fp32_patterns is not None:
            self.keep_fp32_patterns = tuple(keep_fp32_patterns)
        elif p.cast_ops:  # O1: norm layers and MoE routers stay fp32
            self.keep_fp32_patterns = NORM_PATTERNS + ROUTER_PATTERNS
        elif p.keep_batchnorm_fp32:  # O2 (and O3 with the override)
            self.keep_fp32_patterns = BATCHNORM_PATTERNS + ROUTER_PATTERNS
        else:
            self.keep_fp32_patterns = ()

    @property
    def properties(self) -> Properties:
        return self._properties

    @property
    def unwrapped(self) -> nn.Module:
        return self.module

    def _compute_cast_needed(self) -> bool:
        p = self._properties
        return bool(p.enabled) and (
            bool(p.cast_ops) or p.cast_model_type not in (None, False))

    def canonical_variables(self, params: Dict[str, torch.Tensor]):
        """Canonical (optimizer-side) layout: fp32 masters for O0-O2,
        half for O3."""
        p = self._properties
        if not p.enabled:
            return params
        if p.opt_level == "O3" or (
                p.cast_model_type not in (None, False)
                and not p.master_weights and p.opt_level != "O0"):
            return cast_tree(params, self.half_dtype,
                             except_patterns=self.keep_fp32_patterns)
        return cast_tree(params, torch.float32)

    def compute_variables(self, params: Dict[str, torch.Tensor]):
        """Canonical params cast to the compute layout for one call."""
        p = self._properties
        if not p.enabled or _amp_state._amp_state.casts_disabled:
            return params
        if p.opt_level == "O0":
            return cast_tree(params, torch.float32)
        if self._compute_cast_needed():
            return cast_tree(params, self.half_dtype,
                             except_patterns=self.keep_fp32_patterns)
        return params

    def cast_inputs(self, args, kwargs):
        p = self._properties
        if not p.enabled or _amp_state._amp_state.casts_disabled:
            return args, kwargs
        if p.opt_level == "O0":
            dtype = torch.float32
        elif self._compute_cast_needed():
            dtype = self.half_dtype
        else:
            return args, kwargs

        def cast(x):
            return x.to(dtype)

        args = tuple(applier(a, cast) for a in args)
        kwargs = {k: applier(v, cast) for k, v in kwargs.items()}
        return args, kwargs

    @contextlib.contextmanager
    def _norm_output_recast(self):
        """Forward hooks on the kept-fp32 norm modules that cast their
        float32 outputs to the half compute dtype, for one call."""
        half = self.half_dtype
        patterns = self.keep_fp32_patterns

        def recast(_module, _args, out):
            return applier(out, lambda x: x.to(half)
                           if x.dtype == torch.float32 else x)

        handles = [m.register_forward_hook(recast)
                   for name, m in self.module.named_modules()
                   if name and _module_matches(name, m, patterns)
                   and _module_matches(name, m, NORM_PATTERNS)]
        try:
            yield
        finally:
            for h in handles:
                h.remove()

    def _apply_context(self):
        if (self._compute_cast_needed() and self.keep_fp32_patterns
                and not _amp_state._amp_state.casts_disabled):
            return self._norm_output_recast()
        return contextlib.nullcontext()

    def init(self) -> Dict[str, torch.Tensor]:
        """The module's parameters in the canonical layout, as fresh leaf
        tensors that require grad (the module keeps its own)."""
        with torch.no_grad():
            params = self.canonical_variables(
                {n: p.detach().clone()
                 for n, p in self.module.named_parameters()})
        return {n: p.requires_grad_(p.is_floating_point())
                for n, p in params.items()}

    def apply(self, params: Dict[str, torch.Tensor], *args, **kwargs):
        params = self.compute_variables(params)
        args, kwargs = self.cast_inputs(args, kwargs)
        with self._apply_context():
            return torch.func.functional_call(self.module, params, args,
                                              kwargs)

    def loss_and_grad_1f1b(self, params: Dict[str, torch.Tensor], *args,
                           **kwargs):
        """amp's passthrough to the wrapped model's 1F1B loss-and-grad
        (``models.PipelinedBert.loss_and_grad_1f1b``): the params cast to
        the compute layout and swapped into the module for the call, the
        norm-output hooks active around the schedule's rematerialized
        forwards.  Returns ``(loss, grads)`` with each gradient in its
        canonical parameter's dtype, as autograd through ``apply``'s
        cast gives it, for ``AmpOptimizer.step`` to unscale."""
        if not hasattr(self.module, "loss_and_grad_1f1b"):
            raise AttributeError(
                f"{type(self.module).__name__} has no loss_and_grad_1f1b "
                "(only pipeline models with the 1F1B schedule do)")
        compute = self.compute_variables(params)
        with self._apply_context():
            loss, grads = torch.func.functional_call(
                _Method(self.module, "loss_and_grad_1f1b"),
                {f"inner.{k}": v for k, v in compute.items()}, args, kwargs)
        return loss, {k: g.to(params[k].dtype) for k, g in grads.items()}


class _Method(nn.Module):
    """``module.<name>`` as a module's forward, so ``functional_call``
    can swap the parameters in for a method other than ``forward``."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.inner = module
        self.name = name

    def forward(self, *args, **kwargs):
        return getattr(self.inner, self.name)(*args, **kwargs)
