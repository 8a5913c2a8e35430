"""apex_tpu_torch — the PyTorch/CUDA twin of :mod:`apex_tpu` for NVIDIA Hopper.

Laid out like ``apex_tpu`` subpackage for subpackage, so every ported
module has an obvious counterpart: ``amp``, ``fp16_utils``,
``normalization``, ``ops``, ``optimizers``, ``models``, ``parallel``,
``data``, ``resilience``, ``serving``, ``utils`` and ``examples``.
Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU is a CUDA C++ kernel written for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound
with :mod:`ctypes` (``_kernels``).  Each kernel wrapper runs its plain
PyTorch version for a CPU tensor and launches its kernel for a CUDA
tensor.

This package imports PyTorch, NumPy and the standard library only —
never JAX, and nothing of ``apex_tpu``.  Subpackages load lazily, so
``import apex_tpu_torch`` costs nothing beyond PyTorch itself.
"""

import importlib

_SUBPACKAGES = ("amp", "data", "examples", "fp16_utils", "models",
                "normalization", "ops", "optimizers", "parallel", "resilience",
                "serving", "utils")

__all__ = list(_SUBPACKAGES)


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
