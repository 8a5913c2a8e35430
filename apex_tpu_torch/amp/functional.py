"""User-facing precision decorators and ``master_params``.

Twin of ``apex_tpu/amp/functional.py``: the reference lets users register
their own functions into the O1 casting machinery
(``amp.half_function`` / ``float_function`` / ``promote_function``,
``apex/amp/amp.py:30-64``).  The decorators wrap a function directly:
its float tensor arguments are cast on the way in while amp is active,
honouring ``disable_casts``; the ``register_*`` forms replace a module's
attribute with the wrapped function.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.lists import banned_message, check_banned
from apex_tpu_torch.amp.model import applier
from apex_tpu_torch.amp.optimizer import AmpOptimizerState


def _amp_active() -> bool:
    """An active, enabled amp configuration and casts not disabled: the
    predicate every decorator here gates on."""
    props = _amp_state._amp_state.opt_properties
    return (props is not None and bool(props.enabled)
            and not _amp_state._amp_state.casts_disabled)


def _active_half_dtype():
    if not _amp_active():
        return None
    props = _amp_state._amp_state.opt_properties
    if props.cast_model_type not in (None, False):
        return props.cast_model_type
    if props.cast_ops:
        return torch.bfloat16
    return None


def _cast_args(args, kwargs, dtype):
    def cast(x):
        return x.to(dtype)

    args = tuple(applier(a, cast) for a in args)
    kwargs = {k: applier(v, cast) for k, v in kwargs.items()}
    return args, kwargs


def half_function(fn):
    """Run ``fn`` with float args cast to the active half dtype
    (reference ``amp.py:30``)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dtype = _active_half_dtype()
        if dtype is not None:
            args, kwargs = _cast_args(args, kwargs, dtype)
        return fn(*args, **kwargs)
    return wrapper


def float_function(fn):
    """Run ``fn`` with float args cast to fp32 (reference ``amp.py:34``)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _amp_active():
            args, kwargs = _cast_args(args, kwargs, torch.float32)
        return fn(*args, **kwargs)
    return wrapper


def promote_function(fn):
    """Run ``fn`` with float args promoted to the widest float dtype among
    them (reference ``amp.py:38``; widest-type promotion
    ``wrap.py:65-90``)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _amp_active():
            return fn(*args, **kwargs)
        floats = [x.dtype for x in pytree.tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor) and x.is_floating_point()]
        if not floats:
            return fn(*args, **kwargs)
        widest = functools.reduce(torch.promote_types, floats)
        args, kwargs = _cast_args(args, kwargs, widest)
        return fn(*args, **kwargs)
    return wrapper


def banned_function(fn):
    """Wrap ``fn`` to raise under active amp (the reference's banned
    wrapper, ``amp.py:164-171``): decorating is the ban declaration, the
    call errors whenever amp is active (``disable_casts`` is the escape
    hatch), whatever the function is named."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _amp_active():
            raise RuntimeError(banned_message(fn.__name__))
        return fn(*args, **kwargs)
    wrapper.__amp_original__ = fn
    return wrapper


def _register(module, fn_name: str, wrapper):
    # the reference refuses banned functions however they are registered
    # (functional_overrides.py:67-77)
    check_banned(fn_name)
    setattr(module, fn_name, wrapper(getattr(module, fn_name)))


def register_half_function(module, fn_name: str) -> None:
    """Patch ``module.fn_name`` to run with half-cast float args
    (reference ``amp.py:46-50``); register before the calls it should
    cover."""
    _register(module, fn_name, half_function)


def register_float_function(module, fn_name: str) -> None:
    """Patch ``module.fn_name`` to run in fp32 (reference ``amp.py:52``)."""
    _register(module, fn_name, float_function)


def register_promote_function(module, fn_name: str) -> None:
    """Patch ``module.fn_name`` to promote mixed float args (reference
    ``amp.py:58``)."""
    _register(module, fn_name, promote_function)


def master_params(params):
    """Iterate the fp32 master parameters (reference ``_amp_state.py:61``):
    the canonical params *are* the masters for O0-O2
    (``apex_tpu_torch/amp/model.py``), so this yields the tensors of the
    given params tree.  Pass the params, not the optimizer state."""
    if isinstance(params, AmpOptimizerState):
        raise TypeError(
            "master_params takes the params tree, not AmpOptimizerState "
            "(the state holds optimizer moments; the canonical params are "
            "the fp32 masters).")
    yield from pytree.tree_leaves(params)
