"""FusedAdam — Adam over flat buffers or per leaf, through CUDA kernels (B1).

Twin of ``apex_tpu/optimizers/fused_adam.py``.  The update
(``_adam_math`` there, reference ``fused_adam_cuda_kernel.cu``):

    g     = grad / combined_scale
    m     = beta1*m + (1-beta1)*g
    v     = beta2*v + (1-beta2)*g*g
    denom = sqrt(v + eps)  (eps_inside_sqrt)  |  sqrt(v) + eps
    p    -= step_size * (m/denom + weight_decay*p)

with ``step_size = lr * sqrt(1-beta2^t) / (1-beta1^t)`` under bias
correction, ``t = max(step, 1)`` in fp32, computed with torch ops on the
device.  ``max_grad_norm`` folds into the combined scale (reference
``fused_adam.py:98-104``): with ``clip = (norm / scale) /
max_grad_norm``, the scale becomes ``clip * scale`` where ``clip > 1``,
selected with ``torch.where`` on the device.  The norm is the group's
(its slice of the flat buffer, or the sum of its leaves' sums of
squares in the tree layout) unless ``step(grad_norm=...)`` gives one.
``step(..., skip=overflow)`` runs amp's skip-step inside the kernels: a
skipped step leaves p, m, v and the step counter unchanged, and no
value is read back to the host.

Layouts (``layout=``):

- ``"flat"``: m and v are flat fp32 buffers and the state also holds
  the flat fp32 parameter buffer ``p`` (where the JAX state keeps none):
  ``step`` returns the parameters as *views* of it, so the kernel
  updates them in place and no unflatten copy is made.  Parameters
  that are not such views (the first step, or O3's half params) are
  copied in first, and half leaves are cast back out.  Without
  ``param_groups`` one launch of the flat kernel updates the buffer;
  with them the buffer is laid out group by group
  (``ops.flatten_grouped``) and one launch of the multi-tensor kernel
  updates every group's slice with its own hyperparameters.
- ``"tree"``: m and v are trees shaped like the params, one segment per
  leaf for the multi-tensor kernel, one launch a step.  fp32
  contiguous parameters (amp O2's masters) are updated in place and
  returned as they are; other leaves are updated in fp32 copies and
  cast back.

Either way p, m and v are updated in place: a state passed to ``step``
is consumed.  ``param_groups`` (``optimizers.param_groups``) match the
parameters' dotted names and override ``lr``, ``betas``, ``eps``,
``weight_decay`` and ``max_grad_norm``.

``with_zero(group)`` (ZeRO-1, with ``parallel.shard_optimizer_state``):
the flat layout's m and v hold this rank's 1/n of the buffer; B1 runs
on this rank's slice of p, m, v and the (all-reduced) g, and the fresh
slice is all-gathered into the flat p that the params view.  A grouped
layout launches B1-multi over each group's segment cut to the rank's
range.  The clipping norm is the group's over the whole reduced g,
which every rank holds, so the step is the replicated one bit for bit.
A buffer that does not shard (``parallel.zero.flat_shard_len``) takes
the replicated update.  Over the tree layout (``with_zero(group,
like_params=...)``, the moments sharded by ``shard_optimizer_state``
with the same ``like_params``), B1-multi steps each sharded leaf's m
and v with contiguous copies of its param's and gradient's slices
(``parallel.zero.tree_shard``) and the fresh slices are all-gathered
into the params, one flat gather a step; the update is elementwise, so
the step is the replicated one bit for bit.

``with_model_parallel(group, sharded)`` (tensor parallelism): the
``max_grad_norm`` norm counts each replicated leaf once and sums the
squares of the sharded leaves (``sharded[name]``) over the model group.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch._kernels.build import Kernel, plain_path, stream_handle
from apex_tpu_torch.ops.flatten import FlatSpec, flatten, flatten_grouped, \
    flatten_like, unflatten
from apex_tpu_torch.optimizers.param_groups import group_hparams, \
    leaf_paths, resolve_group_ids, validate_specs

Tree = Any

# the flat buffers are padded to a multiple of this many elements, so
# the flat kernel's 128-bit (4-float) accesses divide them exactly
PAD_TO = 128

# the multi-tensor kernel's chunk: at most this many elements of one
# segment a row of its table
_CHUNK = 65536

_P = ctypes.c_void_p
KERNEL = Kernel("fused_adam", "apex_fused_adam",
                [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P])
MULTI_KERNEL = Kernel("fused_adam_multi", "apex_fused_adam_multi",
                      [_P, ctypes.c_int64, _P, ctypes.c_int, _P])


class FusedAdamState(NamedTuple):
    step: torch.Tensor   # int32 0-d, steps taken (skipped ones excluded)
    m: Any               # fp32 flat (flat layout) or a tree (tree layout)
    v: Any
    p: Optional[torch.Tensor]  # fp32 flat master parameters; None (tree)
    spec: Optional[FlatSpec]   # the flat layout; None (tree)


def _adam_plain(p, m, v, g, scalars, eps_inside_sqrt: bool):
    """Plain PyTorch version of the kernels: returns new (p, m, v) from
    the 7 scalars [step_size, beta1, beta2, eps, combined_scale,
    weight_decay, keep]; ``keep`` selects new or old values with a
    where, never a blend (an overflowed g is inf/nan)."""
    step_size, beta1, beta2, eps, cs, wd, keep = scalars.unbind()
    g = g / cs
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    if eps_inside_sqrt:
        denom = torch.sqrt(v_new + eps)
    else:
        denom = torch.sqrt(v_new) + eps
    p_new = p - step_size * (m_new / denom + wd * p)
    tag = keep > 0.5
    return (torch.where(tag, p_new, p), torch.where(tag, m_new, m),
            torch.where(tag, v_new, v))


def adam_flat(p, m, v, g, scalars, eps_inside_sqrt: bool) -> None:
    """One Adam step over flat fp32 ``p``, ``m``, ``v`` in place, from
    grads ``g`` and the 7 device scalars.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    bufs = (p, m, v, g)
    n = p.numel()
    if any(t.dtype != torch.float32 or t.ndim != 1 or t.numel() != n
           for t in bufs):
        raise ValueError("adam_flat: p, m, v, g must be 1-D float32 of "
                         "one length")
    if scalars.shape != (7,) or scalars.dtype != torch.float32:
        raise ValueError("adam_flat: scalars must be (7,) float32")
    if plain_path(*bufs, scalars):
        new = _adam_plain(p, m, v, g, scalars, eps_inside_sqrt)
        for buf, val in zip((p, m, v), new):
            buf.copy_(val)
        return
    if n % 4 or any(not t.is_contiguous() or t.data_ptr() % 16
                    for t in bufs):
        raise ValueError("adam_flat: the kernel needs contiguous 16-byte "
                         "aligned buffers whose length divides by 4")
    KERNEL.launch(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                  scalars.contiguous().data_ptr(), n, int(eps_inside_sqrt),
                  stream_handle(p.device))


Segment = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]


def adam_multi_plain(segments: Sequence[Segment], scalars,
                     eps_inside_sqrt: bool) -> None:
    """Plain PyTorch version of the multi-tensor kernel: each segment
    ``(p, m, v, g, group)`` through :func:`_adam_plain` on its group's
    row of ``scalars``, in place."""
    for p, m, v, g, gid in segments:
        new = _adam_plain(p, m, v, g, scalars[gid], eps_inside_sqrt)
        for buf, val in zip((p, m, v), new):
            buf.copy_(val)


def _segment_rows(segments: Sequence[Segment], device_index: int):
    """One ``(p, m, v, g, n, group)`` pointer row per segment, after
    checking each tensor is 1-D, contiguous, float32, of its segment's
    length and on the device ``device_index`` (``get_device()``: -1 for
    the CPU).  fp32 data is 4-byte aligned by construction."""
    rows = []
    for p, m, v, g, gid in segments:
        n = p.numel()
        for t in (p, m, v, g):
            if t.dtype is not torch.float32 or t.dim() != 1 \
                    or t.numel() != n or not t.is_contiguous():
                raise ValueError("adam_multi: p, m, v, g of a segment "
                                 "must be contiguous 1-D float32 of one "
                                 "length")
            if t.get_device() != device_index:
                raise ValueError("adam_multi: a segment lies on another "
                                 "device than the scalars")
        rows.append((p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                     n, gid))
    return rows


def _chunk_table(rows) -> np.ndarray:
    """The kernel's chunk table from :func:`_segment_rows`: one int64 row
    ``(p, m, v, g, n, group)`` per piece of at most ``_CHUNK`` elements of
    a segment, the pointers advanced to the piece."""
    rows = np.array(rows, dtype=np.int64).reshape(-1, 6)
    pieces = -(-rows[:, 4] // _CHUNK)
    table = np.repeat(rows, pieces, axis=0)
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    start = (np.arange(len(table), dtype=np.int64) - first) * _CHUNK
    table[:, :4] += 4 * start[:, None]
    table[:, 4] = np.minimum(table[:, 4] - start, _CHUNK)
    return np.ascontiguousarray(table)


def adam_multi(segments: Sequence[Segment], scalars,
               eps_inside_sqrt: bool) -> None:
    """One Adam step over a list of segments ``(p, m, v, g, group)`` of
    contiguous 1-D fp32 tensors of any length and 4-byte alignment, in
    place, each with its group's row of the (G, 7) device ``scalars``:
    one launch of the multi-tensor kernel for CUDA tensors (the chunk
    table goes to the card by a ``non_blocking`` copy from pinned
    memory, so nothing syncs), the plain version for CPU tensors."""
    if scalars.ndim != 2 or scalars.shape[1] != 7 \
            or scalars.dtype != torch.float32:
        raise ValueError("adam_multi: scalars must be (G, 7) float32")
    if any(not 0 <= s[4] < scalars.shape[0] for s in segments):
        raise ValueError("adam_multi: a group has no scalars")
    device_index = scalars.get_device()
    if device_index >= 0 and scalars.device.type != "cuda":
        raise ValueError(f"unsupported device {scalars.device}")
    rows = _segment_rows(segments, device_index)
    if not rows:
        return
    if device_index < 0:
        adam_multi_plain(segments, scalars, eps_inside_sqrt)
        return
    host = torch.from_numpy(_chunk_table(rows))
    table = host.pin_memory().to(scalars.device, non_blocking=True)
    MULTI_KERNEL.launch(table.data_ptr(), table.shape[0],
                        scalars.contiguous().data_ptr(),
                        int(eps_inside_sqrt), stream_handle(scalars.device))


def _full(x, device):
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _scalar(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return _full(x, device)


def _to_len(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad a flat buffer to the state's length ``n``."""
    if flat.shape[0] < n:
        flat = torch.cat([flat, flat.new_zeros((n - flat.shape[0],))])
    return flat


class FusedAdam:
    """Adam over flat buffers or per leaf (reference ``fused_adam.py:5-49``):
    ``lr``, ``bias_correction``, ``betas``, ``eps``, ``eps_inside_sqrt``,
    ``weight_decay``, ``max_grad_norm``, ``amsgrad`` (refused, as the
    reference does), ``param_groups``, ``pad_to`` (the flat buffers'
    length multiple; the padding stays zero) and ``layout`` (``"flat"``
    or ``"tree"``, see the module docstring).  ``init(params)``,
    ``step(params, grads, state, ...)`` and the optax-style
    ``update(grads, state, params, ...)`` take trees (e.g. a ``{name:
    tensor}`` dict) of parameters and gradients."""

    # AmpOptimizer hands the overflow flag to step(skip=...): the
    # skip-step select runs inside the kernels
    supports_fused_skip = True

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 eps_inside_sqrt: bool = False, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0, amsgrad: bool = False,
                 param_groups=None, pad_to: int = PAD_TO,
                 layout: str = "flat"):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        if layout not in ("flat", "tree"):
            raise ValueError(f"layout must be 'flat' or 'tree', "
                             f"got {layout!r}")
        self.layout = layout
        self.lr = float(lr)
        self.bias_correction = bias_correction
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.eps_inside_sqrt = bool(eps_inside_sqrt)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = float(max_grad_norm)
        self.pad_to = int(pad_to)
        self.param_groups = list(param_groups) if param_groups else []
        if self.param_groups:
            validate_specs(self.param_groups, self._defaults().keys(),
                           "FusedAdam")
        self._zero = None       # (group, min_shard_elems, places)
        self._tp = None         # (group, {name: sharded}): model parallel

    def _defaults(self):
        return {"lr": self.lr, "betas": self.betas, "eps": self.eps,
                "weight_decay": self.weight_decay,
                "max_grad_norm": self.max_grad_norm}

    def _clone(self, **overrides) -> "FusedAdam":
        kw = dict(lr=self.lr, bias_correction=self.bias_correction,
                  betas=self.betas, eps=self.eps,
                  eps_inside_sqrt=self.eps_inside_sqrt,
                  weight_decay=self.weight_decay,
                  max_grad_norm=self.max_grad_norm,
                  param_groups=self.param_groups, pad_to=self.pad_to,
                  layout=self.layout)
        kw.update(overrides)
        new = type(self)(**kw)
        new._zero, new._tp = self._zero, self._tp
        return new

    def with_zero(self, group, min_shard_elems: Optional[int] = None,
                  like_params=None) -> "FusedAdam":
        """A copy whose update runs on this rank's shard of the state
        over ``group`` (the data ranks) and all-gathers the params
        (module docstring).  ``min_shard_elems`` (default ``n * 128``)
        and ``like_params`` (the tree layout's ``{name: Place}``; the
        flat layout ignores it) must be what
        ``parallel.shard_optimizer_state`` was given."""
        new = self._clone()
        new._zero = (group, min_shard_elems, dict(like_params or {}))
        return new

    def with_model_parallel(self, group, sharded) -> "FusedAdam":
        """A copy whose ``max_grad_norm`` norm is the tensor-parallel
        model's: ``sharded`` maps each dotted parameter name to whether
        it is split over the model ``group`` (``parallel.param_specs``:
        a non-empty spec).  The tree layout only."""
        if self.layout != "tree":
            raise ValueError("tensor-parallel params step with "
                             "layout='tree'")
        new = self._clone()
        new._tp = (group, dict(sharded))
        return new

    # -- state --------------------------------------------------------------
    def init(self, params: Tree) -> FusedAdamState:
        leaves = [t for t in pytree.tree_leaves(params)
                  if isinstance(t, torch.Tensor)]
        device = leaves[0].device if leaves else torch.device("cpu")
        step = torch.zeros((), dtype=torch.int32, device=device)
        if self.layout == "tree":
            def zeros(t):
                return torch.zeros(t.shape, dtype=torch.float32,
                                   device=t.device)
            return FusedAdamState(step=step,
                                  m=pytree.tree_map(zeros, params),
                                  v=pytree.tree_map(zeros, params),
                                  p=None, spec=None)
        if self.param_groups:
            ids = resolve_group_ids(params, self.param_groups)
            flat, spec = flatten_grouped(params, ids, dtype=torch.float32,
                                         pad_to=self.pad_to)
            n_groups = len(self.param_groups) + 1
            if len(spec.group_bounds) < n_groups:   # trailing empty groups
                bounds = list(spec.group_bounds)
                bounds += [(spec.total, 0)] * (n_groups - len(bounds))
                spec = spec._replace(group_bounds=tuple(bounds))
        else:
            flat, spec = flatten(params, dtype=torch.float32,
                                 pad_to=self.pad_to)
        return FusedAdamState(step=step, m=torch.zeros_like(flat),
                              v=torch.zeros_like(flat), p=flat, spec=spec)

    def params(self, state: FusedAdamState) -> Tree:
        """The parameters as views of the flat state's master buffer (cast
        back where a leaf is not fp32), ready for autograd."""
        with torch.no_grad():
            tree = unflatten(state.p, state.spec)
        return pytree.tree_map(
            lambda t: t.requires_grad_(t.is_floating_point()), tree)

    def _are_views(self, params: Tree, state: FusedAdamState) -> bool:
        base = state.p.data_ptr()
        leaves = pytree.tree_leaves(params)
        return len(leaves) == len(state.spec.offsets) and all(
            t.dtype == torch.float32 and t.device == state.p.device
            and t.is_contiguous() and tuple(t.shape) == shape
            and t.data_ptr() == base + 4 * off
            for t, shape, off in zip(leaves, state.spec.shapes,
                                     state.spec.offsets))

    # -- runtime group surgery ----------------------------------------------
    def add_param_group(self, state: FusedAdamState, params: Tree, match,
                        **overrides):
        """Add a group mid-training (reference
        ``_process_optimizer.py:333-407``): returns ``(new_optimizer,
        new_state)`` where the leaves ``match`` finds take ``overrides``
        (the new group comes first: first match wins) and every leaf
        keeps its moments by name; ``params`` may hold new leaves, whose
        moments start at zero."""
        new_opt = self._clone(param_groups=[dict(match=match, **overrides)]
                              + self.param_groups)
        new_state = new_opt.init(params)
        if self.layout == "tree":
            trees = (state.m, state.v, new_state.m, new_state.v)
        else:
            trees = tuple(unflatten(buf, st.spec, cast_back=False)
                          for st in (state, new_state)
                          for buf in (st.m, st.v))
        old_m, old_v, new_m, new_v = trees
        old = {name: (m, v) for name, m, v in zip(
            leaf_paths(old_m), pytree.tree_leaves(old_m),
            pytree.tree_leaves(old_v))}
        with torch.no_grad():
            for name, m, v in zip(leaf_paths(params),
                                  pytree.tree_leaves(new_m),
                                  pytree.tree_leaves(new_v)):
                if name in old and old[name][0].shape == m.shape:
                    m.copy_(old[name][0])
                    v.copy_(old[name][1])
        return new_opt, new_state._replace(step=state.step.clone())

    # -- optax-style update ---------------------------------------------------
    def update(self, grads: Tree, state: FusedAdamState,
               params: Optional[Tree] = None, *, scale=1.0, grad_norm=None,
               skip=None):
        """optax-style: returns ``(updates, new_state)`` with ``new_params
        = params + updates`` (the updates in each param's dtype).  The
        caller's params are left as they are; the state is consumed.
        ``skip`` true gives zero updates and keeps the state's bits."""
        if params is None:
            raise ValueError("FusedAdam.update requires params")
        with torch.no_grad():
            if self.layout == "tree":
                work = pytree.tree_map(lambda t: t.detach().clone(), params)
                new, new_state = self._step_tree(work, grads, state, scale,
                                                 grad_norm, skip)
                return pytree.tree_map(
                    lambda n, p: (n.detach() - p.detach()).to(p.dtype),
                    new, params), new_state
            if self._are_views(params, state):
                # keep the caller's views of the buffer where they are
                state = state._replace(p=state.p.clone())
            old = _to_len(flatten_like(params, state.spec,
                                       dtype=torch.float32), state.p.shape[0])
            new_state = self._step_flat(params, grads, state, scale,
                                        grad_norm, skip)
            updates = unflatten(new_state.p - old, state.spec,
                                cast_back=False)
            return pytree.tree_map(lambda u, p: u.to(p.dtype), updates,
                                   params), new_state

    # -- apex-style step ------------------------------------------------------
    def step(self, params: Tree, grads: Tree, state: FusedAdamState,
             scale=1.0, grad_norm=None, output_params_dtype=None, skip=None):
        """Apply one update; returns ``(params, state)``.  ``skip`` (a bool
        or 0-d bool tensor): amp's overflow skip, selected inside the
        kernels.  ``grad_norm``: the norm ``max_grad_norm`` clips by, in
        place of each group's own.  ``output_params_dtype``: the params
        come back cast to it (the reference's ``output_params`` copy)."""
        with torch.no_grad():
            if self.layout == "tree":
                new, new_state = self._step_tree(params, grads, state, scale,
                                                 grad_norm, skip)
            else:
                new_state = self._step_flat(params, grads, state, scale,
                                            grad_norm, skip)
                new = None
        if output_params_dtype is not None:
            if new is None:
                new = unflatten(new_state.p, new_state.spec, cast_back=False)
            return pytree.tree_map(
                lambda t: t.detach().to(output_params_dtype), new), new_state
        if new is None:
            return self.params(new_state), new_state
        return new, new_state

    # -- core -----------------------------------------------------------------
    def _keep_and_step(self, state, skip):
        dev = state.step.device
        if skip is None:
            return _full(1.0, dev), state.step + 1
        if not isinstance(skip, torch.Tensor):
            skip = torch.full((), bool(skip), device=dev)
        keep = 1.0 - skip.float().reshape(())
        # a skipped step leaves the bias-correction clock alone
        return keep, state.step + keep.to(torch.int32)

    def _scalars(self, hp, step, scale, keep, norm_fn, grad_norm):
        """One group's 7 device scalars; ``norm_fn()`` is the group's own
        grad norm, computed only when ``max_grad_norm`` needs it."""
        dev = step.device
        beta1, beta2 = hp["betas"]
        scale_t = _scalar(scale, dev)
        cs = scale_t
        if hp["max_grad_norm"] > 0:
            gn = _scalar(grad_norm, dev) if grad_norm is not None \
                else norm_fn()
            clip = (gn / scale_t) / hp["max_grad_norm"]
            cs = torch.where(clip > 1, clip * scale_t, scale_t)
        if self.bias_correction:
            # a skipped first step leaves step at 0, where 1 - beta^0 = 0:
            # clamp to 1; that step_size only feeds a discarded result
            t = step.clamp_min(1).float()
            step_size = hp["lr"] * torch.sqrt(1.0 - torch.pow(beta2, t)) \
                / (1.0 - torch.pow(beta1, t))
        else:
            step_size = _full(hp["lr"], dev)
        return torch.stack([step_size.float(), _full(beta1, dev),
                            _full(beta2, dev), _full(hp["eps"], dev), cs,
                            _full(hp["weight_decay"], dev), keep])

    def _update(self, p, m, v, g, scalars) -> None:
        adam_flat(p, m, v, g, scalars, self.eps_inside_sqrt)

    def _update_multi(self, segments, scalars) -> None:
        adam_multi(segments, scalars, self.eps_inside_sqrt)

    def _group_hps(self, n_groups: int):
        hps = group_hparams(self._defaults(), self.param_groups)
        if len(hps) == 1 and n_groups > 1:
            # the state has a grouped layout but this optimizer declares
            # no groups (a layout-only restore): every group takes the
            # defaults
            hps = hps * n_groups
        elif len(hps) != n_groups:
            raise ValueError(
                f"optimizer declares {len(hps)} groups but the state's "
                f"flat layout has {n_groups} — param_groups must match "
                "the specs the state was init'd (or add_param_group'd) "
                "with")
        return hps

    def _step_flat(self, params, grads, state: FusedAdamState, scale,
                   grad_norm, skip) -> FusedAdamState:
        p, spec = state.p, state.spec
        n = p.shape[0]
        # pad to the state's buffer length, not to pad_to: a restored
        # state keeps its layout
        if not self._are_views(params, state):
            p.copy_(_to_len(flatten_like(params, spec, dtype=torch.float32),
                            n))
        g = _to_len(flatten_like(grads, spec, dtype=torch.float32), n)
        if g.shape != p.shape:
            raise ValueError(f"grads flatten to {g.numel()} elements, "
                             f"the state holds {n}")
        keep, step = self._keep_and_step(state, skip)

        def norm_of(t):
            return lambda: torch.sqrt(torch.sum(t * t))

        if self._zero is not None:
            shard = self._zero_shard(n, state)
            if shard is not None:
                group, lo, k = shard
                self._step_flat_shard(
                    p, g[lo:lo + k], state, spec, step, scale, keep,
                    lambda a, size: norm_of(g[a:a + size]), grad_norm,
                    group, lo, k)
                return state._replace(step=step)
        if not spec.group_bounds:
            scalars = self._scalars(self._group_hps(1)[0], step, scale, keep,
                                    norm_of(g), grad_norm)
            if n % 4 == 0:
                self._update(p, state.m, state.v, g, scalars)
            else:
                self._update_multi([(p, state.m, state.v, g, 0)],
                                   scalars[None])
        else:
            hps = self._group_hps(len(spec.group_bounds))
            scalars, segments = [], []
            for gid, ((start, size), hp) in enumerate(
                    zip(spec.group_bounds, hps)):
                sl = slice(start, start + size)
                scalars.append(self._scalars(hp, step, scale, keep,
                                             norm_of(g[sl]), grad_norm))
                if size:
                    segments.append((p[sl], state.m[sl], state.v[sl], g[sl],
                                     gid))
            self._update_multi(segments, torch.stack(scalars))
        return state._replace(step=step)

    def _zero_shard(self, total: int, state: FusedAdamState):
        """``(group, lo, k)``: this rank's range of the buffer under
        ``with_zero``; None where the buffer takes the replicated
        update."""
        from apex_tpu_torch.parallel import zero
        group, least, _ = self._zero
        ranks, r = zero.group_place(group)
        k = zero.flat_shard_len(total, ranks, zero.min_shard(group, least))
        if k is None:
            return None
        if state.m.shape[0] != k:
            raise ValueError(
                f"with_zero: m holds {state.m.shape[0]} elements, this "
                f"rank's shard {k}: shard the state with "
                "parallel.shard_optimizer_state")
        return group, r * k, k

    def _step_flat_shard(self, p, g_shard, state, spec, step, scale, keep,
                         norm_of, grad_norm, group, lo, k) -> None:
        """The sharded flat update of ZeRO-1 and ZeRO-2: B1 (or B1-multi
        over the groups' pieces) on ``[lo, lo + k)`` of p with
        ``g_shard``, the gradient's same range, and this rank's m and v,
        then the all-gather of p's slices.  ``norm_of(start, size)``
        gives the function that computes the norm of the gradient's
        ``[start, start + size)``."""
        from apex_tpu_torch.parallel.collectives import all_gather_flat
        hi = lo + k
        if not spec.group_bounds:
            scalars = self._scalars(self._group_hps(1)[0], step, scale, keep,
                                    norm_of(0, p.shape[0]), grad_norm)
            self._update(p[lo:hi], state.m, state.v, g_shard, scalars)
        else:
            hps = self._group_hps(len(spec.group_bounds))
            scalars, segments = [], []
            for gid, ((start, size), hp) in enumerate(
                    zip(spec.group_bounds, hps)):
                scalars.append(self._scalars(hp, step, scale, keep,
                                             norm_of(start, size), grad_norm))
                a, b = max(start, lo) - lo, min(start + size, hi) - lo
                if a < b:
                    segments.append((p[lo + a:lo + b], state.m[a:b],
                                     state.v[a:b], g_shard[a:b], gid))
            self._update_multi(segments, torch.stack(scalars))
        all_gather_flat(p[lo:hi], group, out=p)

    def _update_tree_shards(self, params, work, m_leaves, v_leaves, g32,
                            ids, scalars) -> None:
        """ZeRO-1 over the tree layout: one B1-multi launch over each
        leaf's moment shard with contiguous copies of its param's and
        gradient's slices (``parallel.zero.tree_shard``), then one flat
        all-gather of the fresh slices back into ``work``."""
        from apex_tpu_torch.optimizers.param_groups import leaf_paths
        from apex_tpu_torch.parallel import zero
        from apex_tpu_torch.parallel.tensor_parallel import Place
        group, least, places = self._zero
        n, r = zero.group_place(group)
        least = zero.min_shard(group, least)
        segments, views, dims, fresh = [], [], [], []
        for name, w, m, v, g, gid in zip(leaf_paths(params), work, m_leaves,
                                         v_leaves, g32, ids):
            place = places.get(name, Place())
            view, d, p_shard = zero.tree_shard(w, place, n, r, least)
            want = w.shape if d is None else p_shard.shape
            if m.shape != want:
                raise ValueError(
                    f"with_zero: {name}'s moment is {tuple(m.shape)}, this "
                    f"rank's shard {tuple(want)}: shard the state with "
                    "parallel.shard_optimizer_state and the same "
                    "like_params")
            if d is None:
                segments.append((w.view(-1), m.view(-1), v.view(-1),
                                 g.view(-1), gid))
                continue
            p_shard = p_shard.contiguous()
            g_shard = zero.tree_shard(g, place, n, r, least)[2].contiguous()
            segments.append((p_shard.view(-1), m.view(-1), v.view(-1),
                             g_shard.view(-1), gid))
            views.append(view)
            dims.append(d)
            fresh.append(p_shard)
        self._update_multi(segments, scalars)
        zero._gather_into(fresh, views, dims, group)

    def _step_tree(self, params, grads, state: FusedAdamState, scale,
                   grad_norm, skip):
        p_leaves, treedef = pytree.tree_flatten(params)
        g_leaves = pytree.tree_leaves(grads)
        m_leaves = pytree.tree_leaves(state.m)
        v_leaves = pytree.tree_leaves(state.v)
        if not len(p_leaves) == len(g_leaves) == len(m_leaves) \
                == len(v_leaves):
            raise ValueError(f"{len(p_leaves)} params, {len(g_leaves)} "
                             f"grads and {len(m_leaves)} moments")
        hps = self._group_hps(len(self.param_groups) + 1)
        ids = (resolve_group_ids(params, self.param_groups)
               if self.param_groups else (0,) * len(p_leaves))
        keep, step = self._keep_and_step(state, skip)
        work = [p.detach() if p.dtype == torch.float32 and p.is_contiguous()
                else p.detach().float().contiguous() for p in p_leaves]
        g32 = [g.detach().float().contiguous() for g in g_leaves]

        names = leaf_paths(params) if self._tp is not None else None

        def norm_of(gid):
            def fn():
                if self._tp is not None:
                    from apex_tpu_torch.parallel.tensor_parallel import \
                        model_grad_norm
                    group, sharded = self._tp
                    picked = {n: g for n, g, i in zip(names, g32, ids)
                              if i == gid}
                    split = {n: ("model",) if sharded[n] else ()
                             for n in picked}
                    return model_grad_norm(picked, split, {"model": group},
                                           step.device)
                sq = sum(torch.sum(g * g) for g, i in zip(g32, ids)
                         if i == gid)
                return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32,
                                                  device=step.device))
            return fn

        scalars = torch.stack([
            self._scalars(hp, step, scale, keep, norm_of(gid), grad_norm)
            for gid, hp in enumerate(hps)])
        if self._zero is None:
            self._update_multi(
                [(w.view(-1), m.view(-1), v.view(-1), g.view(-1), gid)
                 for w, m, v, g, gid in zip(work, m_leaves, v_leaves, g32,
                                            ids)], scalars)
        else:
            self._update_tree_shards(params, work, m_leaves, v_leaves, g32,
                                     ids, scalars)
        out = []
        for p, w in zip(p_leaves, work):
            if w.data_ptr() == p.data_ptr() and w.dtype == p.dtype:
                out.append(p)           # updated in place
            else:
                out.append(w.to(p.dtype).requires_grad_(p.requires_grad))
        return (pytree.tree_unflatten(out, treedef),
                state._replace(step=step))
