"""amp option bag and O0-O3 optimization-level presets.

Twin of ``apex_tpu/amp/properties.py`` (reference
``apex/amp/frontend.py:6-190``) with torch dtypes.  The half dtype
defaults to ``torch.bfloat16``; ``cast_ops`` (alias
``patch_torch_functions``) is the option O1 sets: ``amp.initialize``
then installs the op-level cast policy of ``amp.patch``.
"""

from __future__ import annotations

import warnings

import torch


class AmpOptimizationError(ValueError):
    pass


class Properties:
    """Mutable, validated option bag.  Options start unset and are
    filled by an opt-level preset, then optionally overridden one by one
    by ``amp.initialize`` keyword arguments."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "cast_ops": None,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
        }

    def __getattr__(self, name):
        if "options" in self.__dict__ and name in self.__dict__["options"]:
            return self.options[name]
        if name == "patch_torch_functions":  # reference-name alias
            return self.options["cast_ops"]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if "options" not in self.__dict__:
            super().__setattr__(name, value)
            return
        if name == "patch_torch_functions":
            name = "cast_ops"
        if name not in self.options:
            super().__setattr__(name, value)
            return
        if name == "cast_model_type":
            if self.opt_level == "O1" and value is not None:
                if value is not False and value != torch.float32:
                    warnings.warn(
                        "O1 inserts casts around ops, not the model weights "
                        "themselves, so with O1 cast_model_type is normally "
                        "left None.")
            value = _canonical_dtype(value)
        elif name == "keep_batchnorm_fp32":
            if isinstance(value, str):
                if value not in ("True", "False"):
                    raise AmpOptimizationError(
                        f"keep_batchnorm_fp32 string must be 'True' or "
                        f"'False'; got {value!r}")
                value = value == "True"
        elif name == "loss_scale":
            if value != "dynamic" and value is not None:
                value = float(value)
        self.options[name] = value

    def __repr__(self):
        return "\n".join(f"{k:24}: {v}" for k, v in self.options.items())


def _canonical_dtype(value):
    """Accept dtype strings and torch dtypes."""
    if value is None or value is False:
        return value
    if isinstance(value, str):
        value = {
            "float16": torch.float16, "fp16": torch.float16,
            "half": torch.float16, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16, "float32": torch.float32,
            "fp32": torch.float32, "float": torch.float32,
        }.get(value.lower(), value)
        if isinstance(value, str):
            raise AmpOptimizationError(f"Unrecognized dtype string {value!r}")
    return value


# the half type: bf16 needs no loss scaling to stay in range and is what
# Hopper's tensor cores and the port's kernels take
HALF = torch.bfloat16
FLOAT = torch.float32


class O3:
    """Pure half (reference ``frontend.py:101``)."""

    brief = "O3: Pure half-precision (speed-of-light baseline)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = HALF
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2:
    """Half model + fp32 masters + dynamic scale (reference
    ``frontend.py:123``)."""

    brief = "O2: Insert casts at the model boundary; fp32 master weights."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = HALF
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O1:
    """Op-policy mixed precision + dynamic scale (reference
    ``frontend.py:146``)."""

    brief = "O1: Insert casts around matmul-bound ops (op-level policy)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.cast_ops = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O0:
    """Pure fp32 baseline (reference ``frontend.py:168``)."""

    brief = "O0: Pure fp32 training."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = FLOAT
        properties.cast_ops = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}
