"""Gradient transformations in optax's protocol, in plain PyTorch.

Copies of the optax pieces the JAX package's ImageNet example and entry
points train with (``examples/imagenet/main_amp.py``: ``sgd(schedule,
momentum)`` after ``add_decayed_weights``, the warmup-then-step-decay
schedule; ``examples/dcgan/main_amp.py``: ``adam`` and
``sigmoid_binary_cross_entropy``), kept here so the port imports no optax.  A transformation is
a pair of functions, ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``, over trees of tensors (a
``{name: tensor}`` dict).  The state layout is optax's: ``chain``
gives a tuple of its members' states, ``sgd`` holds a ``TraceState``
then a ``ScaleByScheduleState`` whose ``count`` is a 0-d int32 tensor
on the parameters' device.  So ``amp.AmpOptimizer``'s overflow skip,
a select over the whole state, leaves the schedule's count where it was.

A schedule maps the count (a 0-d int32 tensor, or an int) to a 0-d
float32 tensor on the count's device, computed in float32 in optax's
order of operations, so the values equal optax's bit for bit and no
step reads a value back to the host.

Nothing here updates a tensor in place: every ``update`` returns new
tensors, and ``apply_updates`` returns new parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, \
    Union

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

Tree = Any
Schedule = Callable[[Any], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]

INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """The state of a transformation that keeps none."""


class TraceState(NamedTuple):
    trace: Tree


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor   # int32 0-d, updates applied so far


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d, updates applied so far
    mu: Tree              # first moment
    nu: Tree              # second moment


def _tree_map(fn, tree, *rest):
    return pytree.tree_map(fn, tree, *rest)


def _first_device(tree) -> torch.device:
    leaves = [x for x in pytree.tree_leaves(tree)
              if isinstance(x, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def _as_count(count) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count
    return torch.tensor(int(count), dtype=torch.int32)


def _constant(value, count: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32,
                      device=count.device)


# -- schedules ---------------------------------------------------------------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax ``linear_schedule``: ``init_value`` to ``end_value`` over
    the first ``transition_steps`` steps."""
    if transition_steps <= 0:
        return lambda count: _constant(init_value, _as_count(count))

    def schedule(count):
        count = torch.clamp(_as_count(count), 0, transition_steps)
        frac = 1 - count.to(torch.float32) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def piecewise_constant_schedule(
        init_value: float,
        boundaries_and_scales: Optional[Dict[int, float]] = None) -> Schedule:
    """optax ``piecewise_constant_schedule``: ``init_value`` times every
    scale whose boundary the count has reached."""
    if boundaries_and_scales is not None and any(
            s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError("piecewise_constant_schedule expects non-negative "
                         "scale factors")

    def schedule(count):
        count = _as_count(count)
        v = _constant(init_value, count)
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            indicator = torch.clamp_min(
                torch.sign(threshold - count).to(torch.float32), 0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax ``join_schedules``: each schedule past its boundary, fed the
    count since that boundary."""

    def schedule(count):
        count = _as_count(count)
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


# -- transformations ---------------------------------------------------------

def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None:
                                  (updates, state))


def trace(decay: float) -> GradientTransformation:
    """optax ``trace``: momentum ``t = g + decay * t``; the update is the
    new trace."""

    def init(params):
        return TraceState(trace=_tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        del params
        new_trace = _tree_map(lambda g, t: g + decay * t, updates,
                              state.trace)
        return new_trace, TraceState(trace=new_trace)

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        del params
        return _tree_map(lambda g: step_size * g, updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < INT32_MAX, count + 1, count)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """optax ``scale_by_schedule``: multiply by ``step_size_fn(count)``
    (cast to each update's dtype), then count one more step."""

    def init(params):
        return ScaleByScheduleState(count=torch.zeros(
            (), dtype=torch.int32, device=_first_device(params)))

    def update(updates, state, params=None):
        del params
        step_size = step_size_fn(state.count)
        updates = _tree_map(lambda g: step_size.to(g.dtype) * g, updates)
        return updates, ScaleByScheduleState(
            count=_safe_increment(state.count))

    return GradientTransformation(init, update)


def scale_by_learning_rate(
        learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """optax's: scale by ``-learning_rate`` (a schedule's value, or a
    constant)."""
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -1 * learning_rate(count))
    return scale(-learning_rate)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    """optax ``add_decayed_weights``: ``g + weight_decay * p``."""

    def update(updates, state, params):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return _tree_map(lambda g, p: g + weight_decay * p, updates,
                         params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax ``chain``: apply each in turn; the state is the tuple of
    their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        if len(state) != len(transforms):
            raise ValueError("chain: the state does not match the "
                             "transformations (call init first)")
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def _bias_correction(moment: Tree, decay: float,
                     count: torch.Tensor) -> Tree:
    correction = 1 - decay ** count.to(torch.float32)
    return _tree_map(lambda t: t / correction.to(t.dtype), moment)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax ``scale_by_adam``: the moments ``(1 - b) * g**k + b * m``,
    the count one more, then ``mu_hat / (sqrt(nu_hat + eps_root) +
    eps)`` with both moments bias-corrected by the new count."""

    def init(params):
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=_first_device(params)),
            mu=_tree_map(torch.zeros_like, params),
            nu=_tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        del params
        mu = _tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates,
                       state.mu)
        nu = _tree_map(lambda g, t: (1 - b2) * (g ** 2) + b2 * t, updates,
                       state.nu)
        count = _safe_increment(state.count)
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        updates = _tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                            mu_hat, nu_hat)
        return updates, ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """optax ``adam``: ``scale_by_adam`` then ``scale_by_learning_rate``."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: ScalarOrSchedule,
        momentum: Optional[float] = None) -> GradientTransformation:
    """optax ``sgd``: ``trace(momentum)`` (when given) then
    ``scale_by_learning_rate``."""
    first = trace(momentum) if momentum is not None else identity()
    return chain(first, scale_by_learning_rate(learning_rate))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` in each parameter's dtype."""
    return _tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# -- loss --------------------------------------------------------------------

def softmax_cross_entropy_with_integer_labels(
        logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's: ``logsumexp(logits) - logits[label]`` along the last
    axis, per example."""
    label_logits = torch.take_along_dim(
        logits, labels.long().unsqueeze(-1), dim=-1).squeeze(-1)
    return torch.logsumexp(logits, dim=-1) - label_logits


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's, elementwise: ``-labels * log_sigmoid(logits) - (1 -
    labels) * log_sigmoid(-logits)``, computed by
    ``F.binary_cross_entropy_with_logits`` (looked up at each call, so
    amp O1's fp32 policy for it applies)."""
    return F.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype), reduction="none")
