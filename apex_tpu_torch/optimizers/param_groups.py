"""Parameter groups — per-group hyperparameters over parameter names.

Twin of ``apex_tpu/optimizers/param_groups.py`` (``validate_specs``,
``match_fn``, ``hparam_for_path``).  A group is a name predicate plus
hyperparameter overrides, as a plain dict::

    {"match": r"(bias|_ln)", "weight_decay": 0.0, "lr": 1e-4}

``match`` is a regex, searched (``re.search``) in the parameter's dotted
name — ``encoder.layer_0.attention.query.bias`` — where the JAX package
searches the ``keystr`` of the leaf's key path; or a callable
``f(name) -> bool``.  Groups are checked in order, the first match
wins, and unmatched parameters take the optimizer's own
hyperparameters.  :func:`leaf_names` gives the dotted names of any tree
of tensors (a ``{name: tensor}`` dict's keys as they are).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Sequence, Tuple

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


def hparam_for_path(name: str, defaults: Dict[str, Any],
                    group_specs: Sequence[GroupSpec]) -> Dict[str, Any]:
    """Resolved hyperparameters for one parameter name."""
    for spec in group_specs:
        if match_fn(spec["match"])(name):
            hp = dict(defaults)
            hp.update({k: v for k, v in spec.items() if k != "match"})
            return hp
    return dict(defaults)
