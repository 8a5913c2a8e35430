"""Parameter groups — per-group hyperparameters over parameter names.

Twin of ``apex_tpu/optimizers/param_groups.py``.  A group is a name
predicate plus hyperparameter overrides, as a plain dict::

    {"match": r"(bias|_ln)", "weight_decay": 0.0, "lr": 1e-4}

``match`` is a regex, searched (``re.search``) in the parameter's dotted
name — ``encoder.layer_0.attention.query.bias`` — where the JAX package
searches the ``keystr`` of the leaf's key path; or a callable
``f(name) -> bool``.  Groups are checked in order, the first match
wins, and unmatched parameters take the optimizer's own
hyperparameters.  :func:`leaf_names` (alias :func:`leaf_paths`) gives
the dotted names of any tree of tensors (a ``{name: tensor}`` dict's
keys as they are).

:func:`resolve_group_ids` numbers each leaf's group (0 the default,
``i + 1`` the i-th spec), :func:`group_hparams` resolves each group's
hyperparameters, and :func:`labels`, :func:`masks` and
:func:`multi_transform` carry the same declaration over to any
transformation in optax's protocol (``optimizers.transforms``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

from torch.utils import _pytree as pytree

Tree = Any
GroupSpec = Dict[str, Any]


def validate_specs(group_specs: Sequence[GroupSpec],
                   allowed: Sequence[str], owner: str) -> None:
    """Reject group specs without ``match`` or with override keys the
    optimizer does not read (a typo'd ``weight_deacy`` would otherwise
    be silently ignored)."""
    allowed_set = set(allowed) | {"match"}
    for spec in group_specs:
        if "match" not in spec:
            raise ValueError(f"{owner} param group {spec!r} has no 'match'")
        unknown = set(spec) - allowed_set
        if unknown:
            raise ValueError(
                f"{owner} param group {spec!r} has unsupported keys "
                f"{sorted(unknown)}; supported overrides: "
                f"{sorted(allowed_set - {'match'})}")


def match_fn(match) -> Callable[[str], bool]:
    """Compile a group spec's ``match`` field into a name predicate."""
    if callable(match):
        return match
    rx = re.compile(match)
    return lambda name: rx.search(name) is not None


def _key_name(key) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    return str(key)


def leaf_names(tree: Tree) -> Tuple[str, ...]:
    """Dotted name of every leaf, in tree-flatten order."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return tuple(".".join(_key_name(k) for k in path) for path, _ in flat)


leaf_paths = leaf_names


def resolve_group_ids(tree: Tree,
                      group_specs: Sequence[GroupSpec]) -> Tuple[int, ...]:
    """Group id per leaf, in tree order: 0 the default group, ``i + 1``
    the first spec ``i`` whose ``match`` finds the leaf's name."""
    fns = [match_fn(s["match"]) for s in group_specs]
    ids = []
    for name in leaf_names(tree):
        ids.append(next((i + 1 for i, f in enumerate(fns) if f(name)), 0))
    return tuple(ids)


def group_hparams(defaults: Dict[str, Any],
                  group_specs: Sequence[GroupSpec]) -> List[Dict[str, Any]]:
    """Resolved hyperparameters per group: ``[defaults, *overridden]``."""
    out = [dict(defaults)]
    for spec in group_specs:
        hp = dict(defaults)
        hp.update({k: v for k, v in spec.items() if k != "match"})
        out.append(hp)
    return out


def hparam_for_path(name: str, defaults: Dict[str, Any],
                    group_specs: Sequence[GroupSpec]) -> Dict[str, Any]:
    """Resolved hyperparameters for one parameter name."""
    for spec in group_specs:
        if match_fn(spec["match"])(name):
            hp = dict(defaults)
            hp.update({k: v for k, v in spec.items() if k != "match"})
            return hp
    return dict(defaults)


def labels(tree: Tree, group_specs: Sequence[GroupSpec]) -> Tree:
    """A tree shaped like ``tree`` of labels ``"group0"``..``"groupN"``:
    optax's ``multi_transform`` ``param_labels``."""
    leaves, treedef = pytree.tree_flatten(tree)
    ids = resolve_group_ids(tree, group_specs)
    return pytree.tree_unflatten([f"group{i}" for i in ids], treedef)


def masks(tree: Tree, group_specs: Sequence[GroupSpec]) -> List[Tree]:
    """One boolean tree per group (the default group 0 first), True on
    that group's leaves."""
    _, treedef = pytree.tree_flatten(tree)
    ids = resolve_group_ids(tree, group_specs)
    return [pytree.tree_unflatten([i == g for i in ids], treedef)
            for g in range(len(group_specs) + 1)]


class MultiTransformState(NamedTuple):
    inner_states: Dict[str, Any]   # label -> that group's state


def multi_transform(make_opt: Callable[..., Any], defaults: Dict[str, Any],
                    group_specs: Sequence[GroupSpec], tree: Tree):
    """optax's ``multi_transform`` of ``make_opt(**hparams)`` per group,
    for any transformation in optax's protocol::

        opt = multi_transform(transforms.adam, {"learning_rate": 1e-3},
                              [{"match": r"bias", "learning_rate": 0.0}],
                              params)

    Group ``groupN``'s transformation sees a ``{name: tensor}`` dict of
    that group's leaves (optax hands it the whole tree with the other
    leaves masked out); the updates come back in ``tree``'s structure."""
    from apex_tpu_torch.optimizers.transforms import GradientTransformation

    hps = group_hparams(defaults, group_specs)
    transforms = {f"group{i}": make_opt(**hp) for i, hp in enumerate(hps)}
    names = leaf_names(tree)
    ids = resolve_group_ids(tree, group_specs)

    def split(t):
        leaves = pytree.tree_leaves(t)
        parts = {label: {} for label in transforms}
        for name, gid, leaf in zip(names, ids, leaves):
            parts[f"group{gid}"][name] = leaf
        return parts

    def init(params):
        parts = split(params)
        return MultiTransformState({k: tr.init(parts[k])
                                    for k, tr in transforms.items()})

    def update(updates, state, params=None):
        _, treedef = pytree.tree_flatten(updates)
        parts = split(updates)
        pparts = split(params) if params is not None else {}
        new_states, out = {}, {}
        for k, tr in transforms.items():
            u, new_states[k] = tr.update(parts[k], state.inner_states[k],
                                         pparts.get(k))
            out.update(u)
        return (pytree.tree_unflatten([out[n] for n in names], treedef),
                MultiTransformState(new_states))

    return GradientTransformation(init, update)
