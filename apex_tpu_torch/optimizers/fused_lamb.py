"""FusedLAMB — layer-wise adaptive moments (LAMB) for large-batch training.

Twin of ``apex_tpu/optimizers/fused_lamb.py``, the math of the
reference's ``multi_tensor_lamb_stage_1.cu`` / ``_stage_2.cu``:

stage 1:
    clipped = global_grad_norm > max_grad_norm
                  ? global_grad_norm / max_grad_norm : 1.0
    g      = grad / clipped
    m      = beta1*m + (1-beta1)*g ;  v = beta2*v + (1-beta2)*g^2
    m_hat  = m / (1-beta1^t) ;        v_hat = v / (1-beta2^t)
    update = m_hat / (sqrt(v_hat) + eps) + weight_decay * p

stage 2:
    ratio  = (||p|| > 0 and ||update|| > 0) ? ||p|| / ||update|| : 1.0
    p     -= lr * ratio * update

The trust ratio is per parameter *tensor*, so the state holds trees of
moments shaped like the parameters (``FusedLAMBState``), and the
arithmetic runs leaf by leaf — plain PyTorch, as the JAX package has no
Pallas kernel for it: ``torch._foreach_*`` ops for the elementwise
chain (one multi-tensor launch per op on the card), the global grad norm
from :func:`multi_tensor_l2norm`, the per-tensor norms from
``torch._foreach_norm``.  ``step(..., skip=overflow)`` is amp's
skip-step: ``torch.where`` selects (never a blend, since overflowed
grads carry inf/NaN) keep every bit of p, m, v and the step counter, and
nothing is read back to the host.

Parameter names are the trees' dotted leaf names
(``param_groups.leaf_names``; a ``{name: tensor}`` dict's keys):
``param_groups`` match them, and ``exclude_from_layer_adaptation`` and
``per_slice_trust_ratio`` are predicates on them.

Norms across ranks.  In the JAX package GSPMD makes every norm a norm
of the whole (global) leaf; here a rank holds parts, so each norm is
summed over the ranks that hold the parts, each replicated leaf counted
once, and the sums ride one small all-reduce a group:

- pipeline parallelism: a ``PipelinedBert`` rank holds one stage, so the
  global clipping norm (the JAX optimizer's over the whole tree, every
  stage once) sums the stage leaves' squares over the pipe group:
  ``with_model_parallel(group, sharded)``, as ``FusedAdam``'s.  The
  port's stage leaves are one tensor a layer, so each gets its own trust
  ratio, as the JAX ``(pp, ...)`` stacks under ``per_slice_trust_ratio``
  (the BERT example's setting); a pipelined port rank does not pass it;
- tensor parallelism: ``with_tensor_parallel(group, split)`` names the
  leaves cut over the model group; their squares are summed over it in
  the clipping norm (beside the pipe group's: the model's norm spans the
  (pipe x model) ranks of one data index, ``parallel.tensor_parallel.
  model_grad_norm``) and in both trust-ratio norms, ``||p||`` and
  ``||update||``, so each ratio is the whole leaf's;
- ZeRO-1, ``with_zero(group, like_params=...)`` (with
  ``parallel.shard_optimizer_state``): a rank updates its slice of each
  sharded leaf (the moments' shards, cut as the JAX package's
  ``like_params`` places them) and all-gathers the fresh slices; the
  clipping norm is taken from the whole reduced gradients, and the
  trust-ratio norms of a sharded leaf are summed over the data group as
  well.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.optimizers.param_groups import (
    hparam_for_path,
    leaf_names,
    validate_specs,
)

Tree = Any


#: the elements of one group of leaves that stage 1 and the final add
#: take at once: the temporaries live for a group, not for the model
CHUNK_ELEMENTS = 1 << 26


def _chunks(leaves: List[torch.Tensor]):
    """Index lists of consecutive leaves of at most ``CHUNK_ELEMENTS``
    elements together (a larger leaf alone)."""
    group, size = [], 0
    for i, leaf in enumerate(leaves):
        if group and size + leaf.numel() > CHUNK_ELEMENTS:
            yield group
            group, size = [], 0
        group.append(i)
        size += leaf.numel()
    if group:
        yield group


def _add_consuming(params: List[torch.Tensor], deltas: List) -> List:
    """``params + deltas`` (each delta cast to its parameter's dtype), a
    group of leaves at a time, each delta dropped from ``deltas`` as soon
    as it is added."""
    out = []
    for idx in _chunks(params):
        out += torch._foreach_add([params[i] for i in idx],
                                  [deltas[i].to(params[i].dtype)
                                   for i in idx])
        for i in idx:
            deltas[i] = None
    return out


class FusedLAMBState(NamedTuple):
    step: torch.Tensor   # int32 0-d, steps taken (skipped ones excluded)
    m: Tree              # fp32, like params
    v: Tree              # fp32, like params


class _Plan(NamedTuple):
    """Per-leaf hyperparameters of one parameter tree, resolved once:
    eps and weight decay as Python floats, ``-lr`` and the exclusion as
    device vectors (so a step copies nothing from the host)."""
    eps: List[float]
    weight_decay: List[float]
    neg_lr: torch.Tensor     # (L,) fp32
    excluded: torch.Tensor   # (L,) bool


class FusedLAMB:
    """LAMB over trees of parameters (e.g. a ``{name: tensor}`` dict):
    ``init(params)``, ``update(grads, state, params, skip=None)`` ->
    ``(deltas, state)`` and ``step(params, grads, state, skip=None)`` ->
    ``(params, state)``.

    ``exclude_from_layer_adaptation``: optional predicate
    ``f(name) -> bool``; matching tensors use ratio 1.0 (the BERT
    practice for bias and LayerNorm parameters).  ``param_groups``:
    name-matched group specs with ``lr`` / ``weight_decay`` / ``eps``
    overrides, resolved per leaf; ``betas`` and ``max_grad_norm`` stay
    global.  ``trust_clip``: optional upper bound on the ratio.
    ``per_slice_trust_ratio``: optional predicate ``f(name) -> bool``
    marking leaves that are stacks of per-layer tensors along dim 0:
    each dim-0 slice gets its own trust ratio, as if the layers were
    separate leaves."""

    # AmpOptimizer hands the overflow flag to step(skip=...): the select
    # runs inside the per-leaf update, without a host sync
    supports_fused_skip = True

    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0,
                 trust_clip: Optional[float] = None,
                 exclude_from_layer_adaptation=None, param_groups=None,
                 per_slice_trust_ratio=None):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.max_grad_norm = float(max_grad_norm)
        self.trust_clip = trust_clip
        self.exclude_from_layer_adaptation = exclude_from_layer_adaptation
        self.per_slice_trust_ratio = per_slice_trust_ratio
        self.param_groups = list(param_groups) if param_groups else []
        if self.param_groups:
            validate_specs(self.param_groups, ("lr", "weight_decay", "eps"),
                           "FusedLAMB")
        self._plans: Dict[Tuple, _Plan] = {}
        self._mp = None     # (group, {name: sharded}): the pipe group
        self._tp = None     # (group, {name: split}): the model group
        self._zero = None   # (group, min_shard_elems, {name: Place})

    def _args(self) -> dict:
        return dict(lr=self.lr, betas=self.betas, eps=self.eps,
                    weight_decay=self.weight_decay,
                    max_grad_norm=self.max_grad_norm,
                    trust_clip=self.trust_clip,
                    exclude_from_layer_adaptation=(
                        self.exclude_from_layer_adaptation),
                    param_groups=self.param_groups,
                    per_slice_trust_ratio=self.per_slice_trust_ratio)

    def _copy(self, args=None, **parallel) -> "FusedLAMB":
        """A new optimizer of ``args`` (default: this one's) with this
        one's groups and ZeRO setting, ``parallel`` replacing some."""
        new = FusedLAMB(**(args or self._args()))
        new._mp, new._tp, new._zero = self._mp, self._tp, self._zero
        for k, v in parallel.items():
            setattr(new, k, v)
        return new

    def with_model_parallel(self, group, sharded) -> "FusedLAMB":
        """A copy whose clipping norm is the model's over ``group`` (the
        pipe group: each rank holds one stage): ``sharded`` maps each
        dotted parameter name to whether its leaf is this rank's alone
        (squares summed over the group) or the same on every rank
        (counted once)."""
        return self._copy(_mp=(group, dict(sharded)))

    def with_tensor_parallel(self, group, split) -> "FusedLAMB":
        """A copy for a tensor-parallel model's rank: ``split`` maps each
        dotted parameter name to whether its leaf is cut over the model
        ``group`` (a non-empty ``parallel.param_specs`` spec).  Those
        leaves' squares are summed over the group in the clipping norm
        and in both trust-ratio norms (module docstring)."""
        return self._copy(_tp=(group, dict(split)))

    def with_zero(self, group, min_shard_elems: Optional[int] = None,
                  like_params=None) -> "FusedLAMB":
        """A copy whose update runs on this rank's shard of the moments
        over ``group`` (the data ranks) and all-gathers the params
        (module docstring).  ``min_shard_elems`` and ``like_params`` (the
        ``{name: Place}`` of a TP or pipelined model's ``tp_places()``)
        must be what ``parallel.shard_optimizer_state`` was given."""
        return self._copy(_zero=(group, min_shard_elems,
                                 dict(like_params or {})))

    def add_param_group(self, state: FusedLAMBState, params: Tree, match,
                        **overrides):
        """``(new_optimizer, new_state)``: the ``match``-ed leaves use
        ``overrides`` from now on (the newest group first, so it wins
        over older ones); the moments carry over by leaf name (new leaves
        start at zero)."""
        args = self._args()
        args["param_groups"] = [dict(match=match, **overrides)] \
            + self.param_groups
        new = self._copy(args)
        old_m = dict(zip(leaf_names(state.m), pytree.tree_leaves(state.m)))
        old_v = dict(zip(leaf_names(state.v), pytree.tree_leaves(state.v)))
        fresh = new.init(params)
        m_leaves, spec = pytree.tree_flatten(fresh.m)
        v_leaves = pytree.tree_leaves(fresh.v)
        m_out, v_out = [], []
        for name, m, v in zip(leaf_names(fresh.m), m_leaves, v_leaves):
            keep = name in old_m and old_m[name].shape == m.shape
            m_out.append(old_m[name] if keep else m)
            v_out.append(old_v[name] if keep else v)
        return new, FusedLAMBState(step=state.step,
                                   m=pytree.tree_unflatten(m_out, spec),
                                   v=pytree.tree_unflatten(v_out, spec))

    def _plan(self, names: Tuple[str, ...], device) -> _Plan:
        key = (names, torch.device(device))
        plan = self._plans.get(key)
        if plan is None:
            defaults = {"lr": self.lr, "weight_decay": self.weight_decay,
                        "eps": self.eps}
            hps = [hparam_for_path(n, defaults, self.param_groups)
                   for n in names]
            excl = self.exclude_from_layer_adaptation
            plan = _Plan(
                eps=[float(hp["eps"]) for hp in hps],
                weight_decay=[float(hp["weight_decay"]) for hp in hps],
                neg_lr=torch.tensor([-float(hp["lr"]) for hp in hps],
                                    dtype=torch.float32, device=device),
                excluded=torch.tensor([bool(excl(n)) if excl else False
                                       for n in names], device=device))
            self._plans[key] = plan
        return plan

    def init(self, params: Tree) -> FusedLAMBState:
        leaves, spec = pytree.tree_flatten(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        self._plan(leaf_names(params), device)
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        return FusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=pytree.tree_unflatten(zeros, spec),
            v=pytree.tree_unflatten([z.clone() for z in zeros], spec))

    def _clip_norm(self, grads: Tree, device) -> torch.Tensor:
        """The global gradient norm: over the pipe and model groups'
        parts (each replicated leaf once) where the ranks hold parts."""
        if self._mp is None and self._tp is None:
            return multi_tensor_l2norm(grads)
        from apex_tpu_torch.parallel.tensor_parallel import model_grad_norm
        names = leaf_names(grads)
        groups, split = {}, {name: () for name in names}
        for axis, mp in (("pipe", self._mp), ("model", self._tp)):
            if mp is None:
                continue
            groups[axis] = mp[0]
            for name in names:
                if mp[1].get(name, False):
                    split[name] += (axis,)
        return model_grad_norm(dict(zip(names, pytree.tree_leaves(grads))),
                               split, groups, device)

    @torch.no_grad()
    def _deltas(self, grads: Tree, state: FusedLAMBState, params: Tree,
                skip, gnorm=None, data_split=None):
        """``(deltas, keep, new_state, spec)``: the leaves' ``-lr * ratio
        * update`` in fp32 before the skip select, the 0-d bool keep (or
        None without ``skip``), and the state with m, v already
        selected.  ``gnorm``: the clipping norm when the caller took it
        (ZeRO: from the whole gradients); ``data_split``: per leaf,
        whether the tree holds this rank's ZeRO slice of it (its
        trust-ratio norms then summed over the data group)."""
        p_leaves, spec = pytree.tree_flatten(params)
        g_leaves, g_spec = pytree.tree_flatten(grads)
        m_leaves, _ = pytree.tree_flatten(state.m)
        v_leaves, _ = pytree.tree_flatten(state.v)
        if g_spec != spec or len(m_leaves) != len(p_leaves):
            raise ValueError("FusedLAMB: params, grads and state must be "
                             "trees of the same structure")
        plan = self._plan(leaf_names(params), state.step.device)
        if skip is None:
            keep = None
            step = state.step + 1
        else:
            if not isinstance(skip, torch.Tensor):
                skip = torch.full((), bool(skip), device=state.step.device)
            keep = ~skip.to(torch.bool).reshape(())
            # a skipped step leaves the bias-correction clock alone
            step = state.step + keep.to(torch.int32)
        beta1, beta2 = self.betas

        # stage 0: global grad-norm clipping
        if gnorm is None:
            gnorm = self._clip_norm(grads, state.step.device)
        clip = torch.where(gnorm > self.max_grad_norm,
                           gnorm / self.max_grad_norm, 1.0)

        # stage 1: per-leaf adam-style update (eps, weight decay per
        # group), run over groups of leaves (``_chunks``) with each
        # temporary dropped or reused in place as soon as it is spent (the
        # same values as one out-of-place chain over every leaf): beyond
        # its inputs the step holds the new m, v and update, so a model
        # whose masters, grads and moments fill most of the card still
        # steps.  Bias correction: clamp, a skipped first step sees t = 0,
        # where 1 - beta^0 = 0; its update only feeds keep-selected values
        t = step.clamp_min(1).float()
        bc1, bc2 = 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)
        p32 = [x.float() for x in p_leaves]
        m2, v2, upd = [None] * len(p32), [None] * len(p32), [None] * len(p32)
        for idx in _chunks(p32):
            g = torch._foreach_div([g_leaves[i].float() for i in idx], clip)
            m = torch._foreach_mul([m_leaves[i] for i in idx], beta1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - beta1))
            gg = torch._foreach_mul(g, 1.0 - beta2)
            torch._foreach_mul_(gg, g)
            del g
            v = torch._foreach_mul([v_leaves[i] for i in idx], beta2)
            torch._foreach_add_(v, gg)
            del gg
            u = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, [plan.eps[i] for i in idx])
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(
                [p32[i] for i in idx], [plan.weight_decay[i] for i in idx]))
            for i, a, b, c in zip(idx, m, v, u):
                m2[i], v2[i], upd[i] = a, b, c
        if keep is not None:
            for new, old in zip(m2 + v2, m_leaves + v_leaves):
                torch.where(keep, new, old, out=new)

        # stage 2: per-tensor trust ratio, of the whole leaf
        p_norm = torch.stack(torch._foreach_norm(p32))
        u_norm = torch.stack(torch._foreach_norm(upd))
        masks = self._split_masks(leaf_names(params), data_split,
                                  p_norm.device)
        if masks:
            from apex_tpu_torch.parallel.tensor_parallel import \
                sum_over_groups
            sq = sum_over_groups(
                torch.cat([p_norm * p_norm, u_norm * u_norm]),
                {a: torch.cat([m, m]) for a, (_, m) in masks.items()},
                {a: g for a, (g, _) in masks.items()})
            p_norm, u_norm = torch.sqrt(sq).chunk(2)
        ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm,
                            1.0)
        if self.trust_clip is not None:
            ratio = torch.clamp_max(ratio, float(self.trust_clip))
        ratio = torch.where(plan.excluded, 1.0, ratio)
        factors = list((plan.neg_lr * ratio).unbind())
        if self.per_slice_trust_ratio is not None:
            for i, name in enumerate(leaf_names(params)):
                if self.per_slice_trust_ratio(name):
                    if any(bool(m[i]) for _, m in masks.values()):
                        raise NotImplementedError(
                            f"per_slice_trust_ratio on {name}, a leaf cut "
                            "over ranks (TP or ZeRO)")
                    factors[i] = self._slice_factor(p32[i], upd[i],
                                                    plan.neg_lr[i],
                                                    plan.excluded[i])
        torch._foreach_mul_(upd, factors)
        deltas = upd
        new_state = FusedLAMBState(step=step,
                                   m=pytree.tree_unflatten(m2, spec),
                                   v=pytree.tree_unflatten(v2, spec))
        return deltas, keep, new_state, (p_leaves, spec)

    def _split_masks(self, names, data_split, device):
        """``{axis: (group, bool vector)}``: the groups a leaf's
        trust-ratio norms are summed over, the model group's leaves
        (``with_tensor_parallel``) and the data group's ZeRO slices;
        empty where no leaf is cut."""
        masks = {}
        if self._tp is not None and any(self._tp[1].get(n, False)
                                        for n in names):
            masks["model"] = (self._tp[0], torch.tensor(
                [bool(self._tp[1].get(n, False)) for n in names],
                device=device))
        if data_split is not None and any(data_split):
            masks["data"] = (self._zero[0], torch.tensor(
                list(data_split), device=device))
        return masks

    def _slice_factor(self, p, upd, neg_lr, excluded):
        """``-lr * ratio`` of a stacked leaf, one ratio for each dim-0
        slice, shaped to broadcast over the stack."""
        dims = tuple(range(1, upd.dim()))
        pn = torch.sqrt(torch.sum(p * p, dim=dims))
        un = torch.sqrt(torch.sum(upd * upd, dim=dims))
        ratio = torch.where((pn > 0) & (un > 0), pn / un, 1.0)
        if self.trust_clip is not None:
            ratio = torch.clamp_max(ratio, float(self.trust_clip))
        ratio = torch.where(excluded, 1.0, ratio)
        return (neg_lr * ratio).reshape((-1,) + (1,) * (upd.dim() - 1))

    def update(self, grads: Tree, state: FusedLAMBState,
               params: Optional[Tree] = None, *, skip=None):
        """``(deltas, new_state)``: each leaf's ``-lr * ratio * update``
        in the parameter's dtype, zero where ``skip`` holds (the
        moments then keep their values and the step counter stands)."""
        if params is None:
            raise ValueError("FusedLAMB.update requires params")
        deltas, keep, new_state, (p_leaves, spec) = self._deltas(
            grads, state, params, skip)
        with torch.no_grad():
            if keep is not None:
                deltas = [torch.where(keep, d, 0.0) for d in deltas]
            deltas = [d.to(p.dtype) for d, p in zip(deltas, p_leaves)]
        return pytree.tree_unflatten(deltas, spec), new_state

    def step(self, params: Tree, grads: Tree, state: FusedLAMBState,
             skip=None):
        """Apply one update; returns ``(params, state)``, the params as
        new leaf tensors that require grad.  Under ``skip`` every bit of
        the params is kept (a select of the old tensor, not ``p + 0``).
        After ``with_zero`` the state holds this rank's moment shards and
        ``grads`` are the reduced (whole) gradients."""
        if self._zero is not None:
            return self._step_zero(params, grads, state, skip)
        deltas, keep, new_state, (p_leaves, spec) = self._deltas(
            grads, state, params, skip)
        with torch.no_grad():
            new = _add_consuming(p_leaves, deltas)
            if keep is not None:
                for a, b in zip(new, p_leaves):
                    torch.where(keep, a, b, out=a)
        new = [t.requires_grad_(t.is_floating_point()) for t in new]
        return pytree.tree_unflatten(new, spec), new_state

    @torch.no_grad()
    def _step_zero(self, params: Tree, grads: Tree, state: FusedLAMBState,
                   skip):
        """ZeRO-1: LAMB's per-leaf update on this rank's slice of each
        sharded leaf (``parallel.zero.tree_shard``, the moments' layout),
        whole leaves elsewhere; the fresh slices all-gathered (one flat
        gather a dtype) into new params."""
        from apex_tpu_torch.parallel import zero
        from apex_tpu_torch.parallel.tensor_parallel import Place
        group, least, places = self._zero
        n, r = zero.group_place(group)
        least = zero.min_shard(group, least)
        names = leaf_names(params)
        p_leaves, spec = pytree.tree_flatten(params)
        g_leaves, g_spec = pytree.tree_flatten(grads)
        m_leaves = pytree.tree_leaves(state.m)
        if g_spec != spec or len(m_leaves) != len(p_leaves):
            raise ValueError("FusedLAMB: params, grads and state must be "
                             "trees of the same structure")
        gnorm = self._clip_norm(grads, state.step.device)
        p_loc, g_loc, cuts = [], [], []
        for name, p, g, m in zip(names, p_leaves, g_leaves, m_leaves):
            place = places.get(name, Place())
            _, d, p_shard = zero.tree_shard(p.detach(), place, n, r, least)
            want = p.shape if d is None else p_shard.shape
            if m.shape != want:
                raise ValueError(
                    f"with_zero: {name}'s moment is {tuple(m.shape)}, this "
                    f"rank's shard {tuple(want)}: shard the state with "
                    "parallel.shard_optimizer_state and the same "
                    "like_params")
            cuts.append((place, d))
            if d is None:       # a whole leaf, in its own layout
                p_loc.append(p.detach())
                g_loc.append(g)
                continue
            p_loc.append(p_shard.contiguous())
            g_loc.append(zero.tree_shard(g, place, n, r, least)[2]
                         .contiguous())
        deltas, keep, new_state, _ = self._deltas(
            pytree.tree_unflatten(g_loc, spec), state,
            pytree.tree_unflatten(p_loc, spec), skip, gnorm=gnorm,
            data_split=[d is not None for _, d in cuts])
        fresh = _add_consuming(p_loc, deltas)
        if keep is not None:
            for a, b in zip(fresh, p_loc):
                torch.where(keep, a, b, out=a)
        out, views, dims, shards = [], [], [], []
        for p, (place, d), x in zip(p_leaves, cuts, fresh):
            if d is None:
                out.append(x)
                continue
            full = torch.empty_like(p, memory_format=torch.contiguous_format)
            view, _, _ = zero.tree_shard(full, place, n, r, least)
            views.append(view)
            dims.append(d)
            shards.append(x)
            out.append(full)
        zero._gather_into(shards, views, dims, group)
        out = [t.requires_grad_(t.is_floating_point()) for t in out]
        return pytree.tree_unflatten(out, spec), new_state
