"""amp.initialize — the mixed-precision entry point.

Twin of ``apex_tpu/amp/frontend.py`` (reference
``apex/amp/frontend.py:194-396``): validates the opt level, applies its
preset Properties and the caller's overrides with the reference's
prints, and wraps the model(s) and optimizer(s).  The returned
``AmpModel``/``AmpOptimizer`` hold no numeric state: parameters come
from ``model.init()``, optimizer state from ``optimizer.init(params)``,
and both are threaded through the caller's train step.

O1 (``cast_ops``; ``patch_torch_functions`` is its reference-name
alias) installs the op-level cast policy by patching the ``torch``
namespaces (``amp.patch``); the half dtype is bfloat16 unless
``cast_model_type`` says otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp._amp_state import maybe_print
from apex_tpu_torch.amp.model import AmpModel
from apex_tpu_torch.amp.optimizer import AmpOptimizer
from apex_tpu_torch.amp.patch import install_o1_patches
from apex_tpu_torch.amp.properties import Properties, opt_levels
from apex_tpu_torch.amp.scaler import LossScaler


def initialize(models, optimizers=None, enabled: bool = True,
               opt_level: str = "O1", cast_model_type=None,
               cast_ops: Optional[bool] = None,
               patch_torch_functions: Optional[bool] = None,
               keep_batchnorm_fp32=None,
               master_weights: Optional[bool] = None, loss_scale=None,
               min_loss_scale: Optional[float] = None,
               max_loss_scale: float = 2.0 ** 24, num_losses: int = 1,
               verbosity: int = 1,
               keep_fp32_patterns: Optional[Sequence[str]] = None):
    """Initialize models and optimizers for mixed-precision training.

    Returns the shape of its inputs: a single wrapper for a single
    model/optimizer, lists for lists; ``(models, optimizers)`` when
    optimizers are given, else just the models.
    """
    _amp_state._amp_state.verbosity = verbosity

    if not enabled:
        properties = Properties()
        _amp_state._amp_state.opt_properties = properties
        models_out = _wrap_models(models, properties, None)
        if optimizers is None:
            return models_out
        return models_out, _wrap_optimizers(optimizers, properties,
                                            num_losses, min_loss_scale,
                                            max_loss_scale)

    if opt_level not in opt_levels:
        raise RuntimeError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3'. Note the prefix is the capital letter O, "
            "not the number zero.")

    properties = opt_levels[opt_level](Properties())
    maybe_print(f"Selected optimization level {opt_level}", True)
    maybe_print("Defaults for this optimization level are:", True)
    for k, v in properties.options.items():
        maybe_print(f"{k:24} : {v}", True)

    if patch_torch_functions is not None and cast_ops is None:
        cast_ops = patch_torch_functions
    overrides = dict(cast_model_type=cast_model_type, cast_ops=cast_ops,
                     keep_batchnorm_fp32=keep_batchnorm_fp32,
                     master_weights=master_weights, loss_scale=loss_scale)
    explicit = {k: v for k, v in overrides.items() if v is not None}
    if explicit:
        maybe_print("Processing user overrides (additional kwargs that are "
                    "not None)...", True)
        for k, v in explicit.items():
            setattr(properties, k, v)
    maybe_print("After processing overrides, optimization options are:",
                True)
    for k, v in properties.options.items():
        maybe_print(f"{k:24} : {v}", True)

    _amp_state._amp_state.opt_properties = properties
    if properties.enabled and properties.cast_ops:
        # O1: the per-op precision policy (reference amp.init,
        # apex/amp/amp.py:68-171)
        install_o1_patches()
    models_out = _wrap_models(models, properties, keep_fp32_patterns)
    if optimizers is None:
        return models_out
    return models_out, _wrap_optimizers(optimizers, properties, num_losses,
                                        min_loss_scale, max_loss_scale)


def _wrap_models(models, properties, keep_fp32_patterns):
    single = not isinstance(models, list)
    wrapped = [AmpModel(m, properties, keep_fp32_patterns)
               for m in ([models] if single else models)]
    return wrapped[0] if single else wrapped


def _make_scaler(properties, min_loss_scale, max_loss_scale) -> LossScaler:
    ls = properties.loss_scale
    kwargs = dict(min_loss_scale=min_loss_scale,
                  max_loss_scale=max_loss_scale)
    if ls == "dynamic":
        return LossScaler("dynamic", **kwargs)
    return LossScaler(float(ls) if ls is not None else 1.0, **kwargs)


def _wrap_optimizers(optimizers, properties, num_losses, min_loss_scale,
                     max_loss_scale):
    single = not isinstance(optimizers, list)
    scaler = _make_scaler(properties, min_loss_scale, max_loss_scale)
    wrapped = [AmpOptimizer(o, scaler, num_losses=num_losses)
               for o in ([optimizers] if single else optimizers)]
    return wrapped[0] if single else wrapped
