"""O1 per-op precision enforcement: patching the torch namespaces.

Twin of ``apex_tpu/amp/patch.py``, and of the reference's own design:
it enforces its op lists by replacing the functions of ``torch`` and
``torch.nn.functional`` with casting wrappers (``apex/amp/amp.py:90-148``,
``wrap.py:10-29``), so a user calling ``torch.softmax`` gets fp32 whatever
their model code hands it.  Each wrapper:

- ``"fp32"`` (losses, the softmax family, pointwise transcendentals,
  reductions): upcasts half float tensors to fp32 before the call;
- ``"half"`` (the direct matmul entry points: ``torch.matmul``,
  ``einsum`` ...): casts fp32 tensors to the active half dtype (bf16
  unless ``cast_model_type`` says otherwise);
- ``"banned"`` (``F.binary_cross_entropy``): raises.

Integer tensors and Python scalars pass through untouched.  The set of
functions is the twin of the JAX package's ``_targets()``, not all of
``lists.py``: ``F.linear`` and ``F.conv*`` are left alone as flax's
``Dense``/``Conv`` are there (their dtype comes from ``AmpModel``'s
module-boundary cast, so a layer a user keeps fp32 stays fp32), and so
are Tensor methods (``x.sum()``), which the JAX methods are too.  The
promote ops need no patch: PyTorch's type promotion computes
``bf16 op fp32`` in fp32.

The wrappers are installed once (``amp.initialize`` with ``cast_ops``)
and are inert unless the *active* properties enable ``cast_ops`` and
``disable_casts`` is not in effect (the reference's handle-is-active
check, ``handle.py:20-40``).  They read dtypes only: no host sync.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp._amp_state import _amp_state as _STATE
from apex_tpu_torch.amp.lists import BANNED_OPS, FP16_OPS, FP32_OPS, \
    check_banned
from apex_tpu_torch.amp.model import applier

_HALF_DTYPES = (torch.float16, torch.bfloat16)

# (id(module), attribute) -> (module, attribute, original), per patch
_originals = {}


def _active() -> bool:
    p = _STATE.opt_properties
    return (p is not None and bool(p.enabled) and bool(p.cast_ops)
            and not _STATE.casts_disabled)


def _half_dtype():
    cmt = _STATE.opt_properties.cast_model_type
    return cmt if cmt not in (None, False) else torch.bfloat16


def _maybe_float(x):
    return x.float() if x.dtype in _HALF_DTYPES else x


def _maybe_half(x):
    return x.to(_half_dtype()) if x.dtype == torch.float32 else x


def _wrap(fn: Callable, mode: str) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _active():
            if mode == "banned":  # reference amp.py:164-171
                check_banned(fn.__name__)
            cast = _maybe_float if mode == "fp32" else _maybe_half
            args = tuple(applier(a, cast) for a in args)
            kwargs = {k: applier(v, cast) for k, v in kwargs.items()}
        return fn(*args, **kwargs)

    wrapper.__amp_original__ = fn
    return wrapper


def _targets() -> List[Tuple[Any, str, str]]:
    """(module, attribute, mode) for every function to patch: the torch
    twins of the JAX package's targets (``jnp.power`` is ``torch.pow``,
    ``jnp.arccos`` both ``torch.acos`` and ``torch.arccos``,
    ``jax.scipy.special`` is ``torch`` and ``torch.special``; optax's
    losses are ``F.cross_entropy`` (both softmax cross entropies),
    ``F.binary_cross_entropy_with_logits`` (``sigmoid_binary_cross_
    entropy``), ``F.mse_loss`` (``l2_loss``), ``F.huber_loss`` and
    ``F.kl_div`` (``kl_divergence``))."""
    fp32_torch = (
        "exp", "expm1", "log", "log10", "log1p", "log2", "pow", "cosh",
        "sinh", "tan", "acos", "arccos", "asin", "arcsin", "atan", "arctan",
        "cumsum", "cumprod", "mean", "sum", "prod", "std", "var",
        "logsumexp", "erf", "erfc", "softmax", "log_softmax",
    )
    fp32_special = ("logsumexp", "erf", "erfc")
    fp32_functional = (
        "softmax", "log_softmax", "cross_entropy",
        "binary_cross_entropy_with_logits", "mse_loss", "huber_loss",
        "kl_div",
    )
    half_torch = ("matmul", "dot", "vdot", "inner", "tensordot", "einsum")

    out = [(torch, n, "fp32") for n in fp32_torch]
    out += [(torch.special, n, "fp32") for n in fp32_special]
    out += [(torch.linalg, "norm", "fp32")]
    out += [(F, n, "fp32") for n in fp32_functional]
    out += [(torch, n, "half") for n in half_torch]
    # BCE on probabilities: torch ships it, so the ban fires here as it
    # did in the reference (functional_overrides.py:67-77)
    out += [(F, n, "banned") for n in BANNED_OPS if hasattr(F, n)]

    # every patched name is covered by the policy tables
    known = FP32_OPS | FP16_OPS | BANNED_OPS | {
        "arccos", "arcsin", "arctan", "vdot", "inner", "tensordot",
        "huber_loss", "kl_div", "binary_cross_entropy_with_logits"}
    unknown = [n for _, n, _m in out if n not in known]
    if unknown:
        raise AssertionError(f"patched names outside the policy: {unknown}")
    return out


def install_o1_patches() -> None:
    """Install the op-policy wrappers (idempotent).  Called by
    ``amp.initialize`` when the opt level enables ``cast_ops``; the
    wrappers read the active amp state at each call, so installation is
    permanent and cheap (the reference installs at ``amp.init``,
    ``amp.py:68``)."""
    for mod, name, mode in _targets():
        key = (id(mod), name)
        fn = getattr(mod, name)
        if key in _originals or hasattr(fn, "__amp_original__"):
            continue
        _originals[key] = (mod, name, fn)
        setattr(mod, name, _wrap(fn, mode))


def remove_o1_patches() -> None:
    """Restore every patched function."""
    for mod, name, fn in list(_originals.values()):
        setattr(mod, name, fn)
    _originals.clear()
