"""Checkpoint and resume of a whole train state.

Twin of ``apex_tpu/utils/checkpoint.py``'s :func:`save` and
:func:`restore` on its ``.npz`` backend.  The state is one tree
(``torch.utils._pytree``): params, running statistics, the
``AmpOptimizerState`` with every loss scaler, the optax-twin states,
the epoch.  ``save`` writes its leaves to ``train_state.npz``, leaf i
under ``leaf_i`` as the JAX package names them, and beside it
``leaves.json``, which records each leaf's key path, kind, dtype and
shape.  Nothing is pickled: no treedef, no torch object.

numpy has no bfloat16, so a bfloat16 leaf is stored as its raw bits (a
``uint16`` view) and its dtype is recorded, so that ``restore`` gives
the same bits back.

Leaf i is the JAX package's leaf i for the same tree: dict children in
sorted key order, every other node's children in their own order.

``restore(path, target)`` maps the leaves onto ``target``'s structure
by key path: each tensor keeps its saved dtype and bits, as the JAX
package's restore keeps the saved leaves (an optimizer state may hold
fp32 moments where a fresh ``init`` of O3's bf16 params holds bf16),
and takes the target leaf's device and memory layout (a
``channels_last`` weight stays ``channels_last``); Python scalars come
back as the target's type.  A leaf count, a path or a shape that
differs from the target's raises ``ValueError``.  Without a target it
rebuilds nested dicts and lists from the recorded paths (a named tuple
becomes a dict of its fields), tensors on the CPU.  Only one process
should ``save`` to a path (rank 0 in a data-parallel run).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

Tree = Any

NPZ_FILE = "train_state.npz"
INDEX_FILE = "leaves.json"

# dtypes numpy lacks, stored as the raw bits of a 16-bit integer view
_BITS = (torch.bfloat16,)


def leaf_checksum(leaf) -> str:
    """``crc32:dtype:shape`` fingerprint of one host array, the JAX
    package's :func:`leaf_checksum`.  Covers value bytes AND geometry, so
    a silently re-shaped or down-cast leaf fails verification even when
    its bytes collide (the KV offload store's disk manifest)."""
    a = np.ascontiguousarray(np.asarray(leaf))
    crc = zlib.crc32(a.tobytes()) & 0xFFFFFFFF
    return f"{crc:08x}:{a.dtype.str}:{'x'.join(map(str, a.shape))}"


def _path_entry(key) -> list:
    if isinstance(key, pytree.MappingKey):
        return ["key", key.key]
    if isinstance(key, pytree.SequenceKey):
        return ["index", key.idx]
    if isinstance(key, pytree.GetAttrKey):
        return ["attr", key.name]
    raise TypeError(f"unsupported tree key {key!r}")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(leaf, where: str):
    """``(array, record)`` for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        rec = {"kind": "tensor", "dtype": _dtype_name(t.dtype),
               "shape": list(t.shape)}
        if t.dtype in _BITS:
            return t.view(torch.int16).numpy().view(np.uint16), rec
        try:
            return t.numpy(), rec
        except TypeError as e:
            raise TypeError(f"{where}: cannot store dtype {t.dtype}") from e
    if leaf is None:
        return np.zeros((), np.bool_), {"kind": "none"}
    for kind in (bool, int, float):
        if isinstance(leaf, kind):
            return np.asarray(leaf), {"kind": kind.__name__}
    if isinstance(leaf, np.ndarray):
        return leaf, {"kind": "numpy", "dtype": str(leaf.dtype),
                      "shape": list(leaf.shape)}
    raise TypeError(f"{where}: cannot store a leaf of type "
                    f"{type(leaf).__name__}")


def _entries(kpath) -> Tuple[tuple, ...]:
    return tuple(tuple(_path_entry(k)) for k in kpath)


def _flatten(state: Tree):
    """``(path, leaf)`` pairs in the JAX package's leaf order: a dict's
    children by sorted key, every other node's in their own order."""
    flat, _ = pytree.tree_flatten_with_path(state)
    first: Dict[tuple, int] = {}
    for i, (kpath, _) in enumerate(flat):
        for d in range(1, len(kpath) + 1):
            first.setdefault(_entries(kpath[:d]), i)

    def order(kpath):
        path = _entries(kpath)
        return tuple((0, type(key).__name__, key) if kind == "key"
                     else (1, "", first[path[:d + 1]])
                     for d, (kind, key) in enumerate(path))

    return sorted(flat, key=lambda kv: order(kv[0]))


def save(path: str, state: Tree) -> None:
    """Save ``state`` (a tree of tensors, numpy arrays and Python
    scalars) to the directory ``path``, replacing what is there."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays, records = {}, []
    for i, (kpath, leaf) in enumerate(_flatten(state)):
        arr, rec = _to_numpy(leaf, pytree.keystr(kpath))
        rec["path"] = [list(e) for e in _entries(kpath)]
        arrays[f"leaf_{i}"] = arr
        records.append(rec)
    np.savez(os.path.join(path, NPZ_FILE), **arrays)
    with open(os.path.join(path, INDEX_FILE), "w") as f:
        json.dump({"leaves": records}, f)


def _from_numpy(arr: np.ndarray, rec: Dict[str, Any]):
    """The stored leaf as its own kind: a CPU tensor, an array or a
    Python scalar."""
    kind = rec["kind"]
    if kind == "tensor":
        dtype = getattr(torch, rec["dtype"])
        arr = np.ascontiguousarray(arr)
        if dtype in _BITS:
            t = torch.from_numpy(arr.view(np.int16)).view(dtype)
        else:
            t = torch.from_numpy(arr)
        return t.reshape(rec["shape"])
    if kind == "numpy":
        return arr
    if kind == "none":
        return None
    return {"bool": bool, "int": int, "float": float}[kind](arr.item())


def _onto(value, target):
    """``value`` (a restored leaf) in ``target``'s place: a tensor keeps
    its saved dtype and bits and takes the target's device and memory
    layout; a Python scalar takes the target's type."""
    if isinstance(target, torch.Tensor):
        src = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(value)
        out = torch.empty_like(target, dtype=src.dtype, requires_grad=False)
        with torch.no_grad():
            out.copy_(src)
        return out.requires_grad_(target.requires_grad
                                  and out.is_floating_point())
    if isinstance(target, (bool, int, float)) and not isinstance(
            value, (torch.Tensor, np.ndarray)):
        return type(target)(value)
    return value


def _rebuild(records: List[Dict[str, Any]], leaves: list):
    """Nested dicts and lists from the recorded paths: a node whose keys
    came from sequence indices becomes a list."""
    if len(records) == 1 and not records[0]["path"]:
        return leaves[0]
    root: Dict[Any, Any] = {}
    lists = set()
    for rec, leaf in zip(records, leaves):
        node, prefix = root, ()
        for kind, key in rec["path"][:-1]:
            if kind == "index":
                lists.add(prefix)
            node = node.setdefault(key, {})
            prefix += (key,)
        kind, key = rec["path"][-1]
        if kind == "index":
            lists.add(prefix)
        node[key] = leaf

    def walk(node, prefix):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, prefix + (k,)) for k, v in node.items()}
        return [out[i] for i in sorted(out)] if prefix in lists else out

    return walk(root, ())


def restore(path: str, target: Optional[Tree] = None) -> Tree:
    """The tree saved at ``path``: on ``target``'s structure and devices
    when given (a leaf count that differs raises ``ValueError`` naming
    the path and both counts), else as nested dicts and lists."""
    path = os.path.abspath(path)
    with open(os.path.join(path, INDEX_FILE)) as f:
        records = json.load(f)["leaves"]
    with np.load(os.path.join(path, NPZ_FILE)) as z:
        leaves = [_from_numpy(z[f"leaf_{i}"], rec)
                  for i, rec in enumerate(records)]
    if target is None:
        return _rebuild(records, leaves)
    t_flat, spec = pytree.tree_flatten_with_path(target)
    if len(t_flat) != len(leaves):
        raise ValueError(
            f"checkpoint at {path} has {len(leaves)} leaves; target "
            f"expects {len(t_flat)}")
    saved = {tuple(tuple(e) for e in rec["path"]): (rec, v)
             for rec, v in zip(records, leaves)}
    out = []
    for kpath, t in t_flat:
        where = pytree.keystr(kpath)
        if _entries(kpath) not in saved:
            raise ValueError(f"checkpoint at {path} has no leaf {where}")
        rec, value = saved[_entries(kpath)]
        if isinstance(t, torch.Tensor) and list(t.shape) != rec.get("shape"):
            raise ValueError(
                f"checkpoint at {path}: {where} has shape "
                f"{tuple(rec.get('shape', ()))}; target expects "
                f"{tuple(t.shape)}")
        out.append(_onto(value, t))
    return pytree.tree_unflatten(out, spec)
