"""Pipeline parallelism over a process group: GPipe and 1F1B.

Twin of ``apex_tpu/parallel/pipeline.py``.  The JAX package runs each
schedule as one SPMD ``lax.scan`` inside ``shard_map``; here each rank of
the pipe group is one stage, holds only its own stage's parameters, and
runs the schedule's ticks in eager PyTorch with the hops written out
(:func:`~apex_tpu_torch.parallel.collectives.shift_g`'s non-cyclic
pairs ``(i, i + 1)`` forward, ``(i + 1, i)`` backward).  The tick
formulas are the JAX schedules': which microbatch a rank works on at a
tick, and whether the tick is valid, is plain Python arithmetic on ints,
so the loop reads nothing back from the device.  A rank skips the stage
body on a bubble tick (the JAX scan computes on garbage there).  A hop
runs on the ticks where some stage has a valid tick to send from, with
only those stages' pairs; every rank computes the same senders from the
same ints and takes part in every such hop, so the ranks' calls of each
collective line up.

Contract (classic GPipe), as the JAX package's:

- ``stage_fn(stage_params, x) -> y`` where ``x``/``y`` are a tensor or
  a pytree of tensors with identical structure and per-leaf shapes (the
  leaves of ``y`` are cast to ``x``'s dtypes for the hop).  With
  ``microbatch_index=True`` the schedules call ``stage_fn(stage_params,
  x, j)`` with ``j`` the microbatch's index (a Python int): a stage can
  then slice its side inputs (an attention bias, its dropout key's
  microbatch id) from the batch every rank holds, where the JAX models
  carry them through the pipeline as activation leaves;
- the one-call forms (:func:`pipeline_apply`,
  :func:`onef1b_loss_and_grad`) take the stage parameters STACKED with a
  leading stage dim ``(S, ...)`` and use this rank's row; the per-rank
  bodies (:func:`gpipe_spmd`, :func:`onef1b_spmd`) take this rank's
  ``(1, ...)`` slice, and :func:`gpipe` / :func:`onef1b` this rank's
  unstacked stage parameters (what the pipelined models pass);
- the batch of ``B`` rows splits into ``num_microbatches`` M; GPipe
  runs ``T = M + S - 1`` ticks, 1F1B ``2T``, with the bubble ``(S-1)/T``.

GPipe (:func:`gpipe`) is one ``torch.autograd.Function``: its forward
runs the ticks, keeping each valid tick's stage graph (memory grows with
M, as XLA keeps every tick's activations), and its backward runs the
ticks in reverse, each rank's stage backward fed by the gradient hop of
the stage after it.  Eager autograd has no SPMD program: a hop whose
output a rank ignores (stage 0 injects its microbatch and never reads
its inbox) would have its backward collective run on the other ranks
but not on that one.  Writing the reverse ticks out makes every rank
run every backward hop, in the same order.  The stages after the first
differentiate their floating inputs whenever anything is
differentiated, so the gradient hops carry the earlier stages'
parameter gradients whether or not ``x`` needs a gradient; ``x``'s
own need decides only whether stage 0's ``dx`` is kept.  The output is collected as
the JAX schedule's masked ``psum`` is: the last stage's rows, zeros
elsewhere, summed over the group forward and passed through as they
are backward (``reduce_from_group``; a sum in the backward as well would
scale every stage gradient by S).

1F1B (:func:`onef1b`) interleaves forward and backward ticks: forward
of microbatch m on stage s at ``t = 2m + s``, backward at ``t = 2m + 2S
- 1 - s``, the stage input saved in slot ``m % S`` of a ring.  A forward
tick runs under ``torch.no_grad()`` and keeps only the detached stage
input; a backward tick rematerializes the stage forward and calls
``torch.autograd.grad`` on (stage params, input) with the gradient from
the stage after it, or, on the last stage, on ``loss_fn(stage_fn(p, x),
target[, loss_params])`` seeded with ``1/M``.  The last stage's forward
tick only saves its input: it has no one to send to, and its backward
tick, the next one, runs the forward with the graph.  No graph outlives
its tick, so a rank holds at most S saved inputs, whatever M.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from apex_tpu_torch.parallel.collectives import _initialized, _shift, \
    reduce_from_group
from apex_tpu_torch.parallel.mesh import ProcessGroup

Pytree = Any


def _place(group: ProcessGroup):
    """``(stage, stages)``: this rank's index in the pipe group and the
    group's size (0 and 1 in a world of one process)."""
    if not _initialized():
        return 0, 1
    return group.rank(), group.size()


def _unstack(stacked_params_local: Pytree, group_desc: str, s: int):
    """This rank's stage params from its ``(1, ...)`` slice of the
    stacked layout (each leaf's row 0, a view)."""
    for leaf in pytree.tree_leaves(stacked_params_local):
        # each rank must hold exactly ONE stage slice; a stacked stage
        # count that is a multiple of the group size would otherwise
        # silently run only every k-th stage
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stacked stage params have leading dim {leaf.shape[0]} "
                f"per rank; the stage count must equal the size of "
                f"{group_desc} ({s})")
    return pytree.tree_map(lambda a: a[0], stacked_params_local)


def _microbatch(x: Pytree, m: int):
    """``(leaves, spec, b)``: the activation leaves, their tree spec and
    the shared batch dim, checked as the JAX prologue checks them."""
    leaves, spec = pytree.tree_flatten(x)
    b = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.shape[0] != b:
            raise ValueError(
                "every activation leaf must share the batch dim; got "
                f"{[tuple(l.shape) for l in leaves]}")
    if b % m:
        raise AssertionError(f"batch {b} must divide into {m} microbatches")
    return leaves, spec, b


def _rows(leaves: List[torch.Tensor], j: int, mb: int):
    return [a[j * mb:(j + 1) * mb] for a in leaves]


def _stage_rows(group: ProcessGroup, stacked_params: Pytree, s: int):
    """This rank's ``(1, ...)`` slice of fully stacked stage params (a
    stack of k * S stages gives k rows a rank, which :func:`_unstack`
    refuses)."""
    r = _place(group)[0]

    def rows(a):
        k = a.shape[0] // s if a.shape[0] % s == 0 else a.shape[0]
        return a[r * k:(r + 1) * k]
    return pytree.tree_map(rows, stacked_params)


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _call(stage_fn, params, x, j, with_index):
    return stage_fn(params, x, j) if with_index else stage_fn(params, x)


class _Plan:
    """What a GPipe call needs beyond its tensors."""

    def __init__(self, group, stage_fn, p_spec, n_p, x_spec, m,
                 with_index):
        self.group, self.stage_fn = group, stage_fn
        self.p_spec, self.n_p = p_spec, n_p
        self.x_spec, self.m, self.with_index = x_spec, m, with_index


def _hop(leaves: List[torch.Tensor], group: ProcessGroup, shift: int,
         senders: List[int]):
    """One hop of every leaf, the pairs of the ``senders`` (group indices
    with a valid tick; every rank computes the same list, so every rank
    takes part in the same collectives)."""
    return [_shift(a, group, shift, senders) for a in leaves]


def _gpipe_valid(t: int, r: int, m: int) -> bool:
    """Stage ``r`` works on microbatch ``t - r`` at GPipe tick ``t``
    (forward; the backward runs the same ticks in reverse)."""
    return 0 <= t - r < m


def _fwd_tick(t: int, r: int, m: int) -> bool:
    """Stage ``r`` runs microbatch ``(t - r) // 2``'s forward at 1F1B
    tick ``t``."""
    return t >= r and (t - r) % 2 == 0 and (t - r) // 2 < m


def _bwd_tick(t: int, r: int, m: int, n_s: int) -> bool:
    """Stage ``r`` runs microbatch ``(t - (2 S - 1 - r)) // 2``'s
    backward at 1F1B tick ``t``."""
    tb = t - (2 * n_s - 1 - r)
    return tb >= 0 and tb % 2 == 0 and tb // 2 < m


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node (module docstring): the
    forward runs the ticks and returns this rank's part of the collected
    output (the last stage's rows, zeros elsewhere); the backward runs
    the reverse ticks with the gradient hops written out."""

    @staticmethod
    def forward(ctx, plan: _Plan, *flat):
        group, m = plan.group, plan.m
        s, n_s = _place(group)
        p_in, x_in = flat[:plan.n_p], flat[plan.n_p:]
        mb = x_in[0].shape[0] // m
        p_req = ctx.needs_input_grad[1:1 + plan.n_p]
        x_req = ctx.needs_input_grad[1 + plan.n_p:]
        p_work = [p.detach().requires_grad_(r) for p, r in zip(p_in, p_req)]
        params = pytree.tree_unflatten(p_work, plan.p_spec)
        template = _rows(list(x_in), 0, mb)
        # a stage after the first differentiates its floating inputs
        # whenever anything is differentiated: the gradient hop into it
        # carries the stage parameters' gradients of the stages before
        # it, whether or not x itself needs one
        hop_req = any(p_req) or any(x_req)
        saved, outs, inbox = {}, [None] * m, None
        for t in range(m + n_s - 1):
            j = t - s
            if 0 <= j < m:
                if s == 0:
                    xin = [a.detach().requires_grad_(r) for a, r in
                           zip(_rows(list(x_in), j, mb), x_req)]
                else:
                    xin = [a.detach().requires_grad_(
                        hop_req and _is_float(a)) for a in inbox]
                with torch.enable_grad():
                    y = _call(plan.stage_fn, params,
                              pytree.tree_unflatten(xin, plan.x_spec), j,
                              plan.with_index)
                    y = [a.to(tl.dtype) for a, tl in
                         zip(pytree.tree_leaves(y), template)]
                saved[t] = (xin, y)
                send = [a.detach() for a in y]
                if s == n_s - 1:
                    outs[j] = send
            else:
                send = [torch.zeros_like(a) for a in template]
            senders = [r for r in range(n_s - 1) if _gpipe_valid(t, r, m)]
            if n_s > 1 and senders:
                # every rank, the same ticks: the hop's pairs line up
                inbox = _hop(send, group, 1, senders)
        ctx.plan, ctx.saved, ctx.p_work = plan, saved, p_work
        ctx.x_req, ctx.mb = x_req, mb
        ctx.x_meta = [(tuple(a.shape), a.dtype, a.device) for a in x_in]
        if s == n_s - 1:
            result = [torch.cat(parts) for parts in zip(*outs)]
        else:
            result = [torch.zeros_like(a) for a in x_in]
        ctx.mark_non_differentiable(*[a for a in result if not _is_float(a)])
        return tuple(result)

    @staticmethod
    def backward(ctx, *grad_out):
        plan, group, m, mb = ctx.plan, ctx.plan.group, ctx.plan.m, ctx.mb
        s, n_s = _place(group)
        last = s == n_s - 1
        x_req, p_work = ctx.x_req, ctx.p_work
        # every floating leaf hops, on every rank (module docstring)
        hop_idx = [i for i, (_, dtype, _) in enumerate(ctx.x_meta)
                   if dtype.is_floating_point]
        zeros = [torch.zeros((mb,) + shape[1:], dtype=dtype, device=dev)
                 for shape, dtype, dev in (ctx.x_meta[i] for i in hop_idx)]
        p_grads: List[Optional[torch.Tensor]] = [None] * len(p_work)
        dxs: List[Optional[List[torch.Tensor]]] = [None] * m
        g_inbox = zeros
        for t in reversed(range(m + n_s - 1)):
            j = t - s
            send = zeros
            if 0 <= j < m:
                xin, y = ctx.saved.pop(t)
                if last:
                    g_y = [None if g is None else g[j * mb:(j + 1) * mb]
                           for g in grad_out]
                else:
                    g_y = [None] * len(y)
                    for i, g in zip(hop_idx, g_inbox):
                        g_y[i] = g
                outs = [(a, g) for a, g in zip(y, g_y)
                        if g is not None and a.requires_grad]
                x_idx = [i for i in hop_idx if xin[i].requires_grad]
                want = [p for p in p_work if p.requires_grad] + \
                    [xin[i] for i in x_idx]
                got = [None] * len(want)
                if outs and want:
                    got = list(torch.autograd.grad(
                        [a for a, _ in outs], want, [g for _, g in outs],
                        allow_unused=True))
                it = iter(got)
                for k, p in enumerate(p_work):
                    if p.requires_grad:
                        g = next(it)
                        if g is not None:
                            p_grads[k] = g if p_grads[k] is None \
                                else p_grads[k] + g
                gx = dict(zip(x_idx, it))
                send = [z if gx.get(i) is None else gx[i]
                        for i, z in zip(hop_idx, zeros)]
                if s == 0:
                    dxs[j] = send
            senders = [r for r in range(1, n_s) if _gpipe_valid(t, r, m)]
            if n_s > 1 and senders and hop_idx:
                # every rank, the forward's ticks in reverse
                g_inbox = _hop(send, group, -1, senders)
        p_grads = [torch.zeros_like(p) if g is None and p.requires_grad
                   else g for g, p in zip(p_grads, p_work)]
        x_grads: List[Optional[torch.Tensor]] = [None] * len(x_req)
        for n, i in enumerate(hop_idx):
            if not x_req[i]:
                continue
            shape, dtype, dev = ctx.x_meta[i]
            full = torch.cat([d[n] for d in dxs]) if s == 0 else \
                torch.zeros(shape, dtype=dtype, device=dev)
            if n_s > 1:
                # the JAX schedule's masked psum: stage 0's rows on every
                # rank (each then runs the caller's vjp, e.g. the
                # embeddings')
                dist.broadcast(full, src=group.members()[0],
                               group=group.handle)
            x_grads[i] = full
        del ctx.saved, ctx.p_work
        return (None, *p_grads, *x_grads)


def gpipe(group: ProcessGroup, stage_fn: Callable, params: Pytree,
          x: Pytree, num_microbatches: int, *,
          microbatch_index: bool = False) -> Pytree:
    """GPipe over ``group`` with this rank's (unstacked) stage
    ``params``: ``x`` is the whole batch ``(B, ...)`` (every rank of the
    group holds it; stage 0 reads it), the result the pipeline's output
    ``(B, ...)``, the same on every rank of the group.  Differentiable in
    ``params`` and in ``x`` (whose gradient, stage 0's, reaches every
    rank)."""
    m = num_microbatches
    x_leaves, x_spec, _ = _microbatch(x, m)
    p_leaves, p_spec = pytree.tree_flatten(params)
    if not torch.is_grad_enabled():
        # inference: no tick keeps a graph
        p_leaves = [p.detach() for p in p_leaves]
        x_leaves = [a.detach() for a in x_leaves]
    plan = _Plan(group, stage_fn, p_spec, len(p_leaves), x_spec, m,
                 microbatch_index)
    parts = _GPipe.apply(plan, *p_leaves, *x_leaves)
    if _place(group)[1] > 1:
        parts = [reduce_from_group(a, group) for a in parts]
    return pytree.tree_unflatten(list(parts), x_spec)


def gpipe_spmd(stage_fn: Callable, group: ProcessGroup,
               num_microbatches: int, *, microbatch_index: bool = False):
    """The per-rank GPipe body (the twin of ``gpipe_spmd(stage_fn,
    axis_name, num_microbatches)``): returns ``run(stacked_params_local,
    x)`` where ``stacked_params_local`` is this rank's ``(1, ...)`` slice
    of the stacked stage params and ``x`` the whole batch; the output is
    the same on every rank of ``group``."""

    def run(stacked_params_local: Pytree, x: Pytree) -> Pytree:
        s = _place(group)[1]
        params = _unstack(stacked_params_local, "the pipe group", s)
        return gpipe(group, stage_fn, params, x, num_microbatches,
                     microbatch_index=microbatch_index)

    return run


def pipeline_apply(mesh, axis_name: str, stage_fn: Callable,
                   stacked_params: Pytree, x: Pytree,
                   num_microbatches: int, *,
                   microbatch_index: bool = False) -> Pytree:
    """One-call GPipe over ``mesh``'s ``axis_name`` group: this rank's
    row of ``stacked_params`` (leading dim S, the group's size) runs as
    its stage; the output is the same on every rank of the group.
    Differentiable (the gradients of the other ranks' rows are zero
    here)."""
    group = mesh.groups.get(axis_name)
    s = _place(group)[1]
    run = gpipe_spmd(stage_fn, group, num_microbatches,
                     microbatch_index=microbatch_index)
    return run(_stage_rows(group, stacked_params, s), x)


def _broadcast(t: torch.Tensor, group: ProcessGroup, index: int):
    """``t`` of the group's rank ``index`` on every rank (in place)."""
    dist.broadcast(t, src=group.members()[index], group=group.handle)
    return t


def onef1b(group: ProcessGroup, stage_fn: Callable, loss_fn: Callable,
           params: Pytree, x: Pytree, target: Pytree,
           num_microbatches: int, loss_params: Pytree = None, *,
           microbatch_index: bool = False, stats: Optional[dict] = None):
    """1F1B over ``group`` with this rank's (unstacked) stage ``params``
    (module docstring).  Returns ``(loss, grads, dx)``, plus
    ``loss_param_grads`` when ``loss_params`` is given:

    - ``loss_fn(y_mb, target_mb[, loss_params]) -> scalar``; ``loss``
      (fp32, 0-d) is the mean over the microbatches, on every rank;
    - ``grads``: d loss / d params of this rank's stage, summed over the
      microbatches (no reduction over any other group: per-shard
      partials the caller reduces once);
    - ``dx``: d loss / d x on every rank, for the caller's own vjp;
      integer leaves get zeros of their own dtype;
    - ``loss_param_grads``: d loss / d loss_params, on every rank.

    ``stats``, when given, gets ``"max_live_inputs"``: the most stage
    inputs this rank held saved at once."""
    m = num_microbatches
    s, n_s = _place(group)
    last = s == n_s - 1
    x_leaves, x_spec, b = _microbatch(x, m)
    x_leaves = [a.detach() for a in x_leaves]
    mb = b // m
    t_leaves, t_spec = pytree.tree_flatten(target)
    for leaf in t_leaves:
        if leaf.dim() == 0 or leaf.shape[0] != b:
            raise ValueError(
                "every target leaf must share the activations' batch dim "
                f"({b}); got {[tuple(l.shape) for l in t_leaves]}")
    p_leaves, p_spec = pytree.tree_flatten(params)
    p_work = [p.detach().requires_grad_(_is_float(p)) for p in p_leaves]
    p_tree = pytree.tree_unflatten(p_work, p_spec)
    lp_work, lp_spec = [], None
    if loss_params is not None:
        lp_leaves, lp_spec = pytree.tree_flatten(loss_params)
        lp_work = [p.detach().requires_grad_(_is_float(p))
                   for p in lp_leaves]
    lp_tree = None if lp_spec is None else \
        pytree.tree_unflatten(lp_work, lp_spec)
    fl = [i for i, a in enumerate(x_leaves) if _is_float(a)]
    template = _rows(x_leaves, 0, mb)
    g_zero = [torch.zeros_like(template[i]) for i in fl]
    x_zero = [torch.zeros_like(a) for a in template]
    gacc: List[Optional[torch.Tensor]] = [None] * len(p_work)
    lpacc: List[Optional[torch.Tensor]] = [None] * len(lp_work)
    lacc = torch.zeros((), dtype=torch.float32, device=x_leaves[0].device)
    dxbuf: List[Optional[List[torch.Tensor]]] = [None] * m
    ring, live = {}, 0
    x_inbox, g_inbox = x_zero, g_zero

    def acc(store, grads, work):
        for k, (w, g) in enumerate(zip(work, grads)):
            if w.requires_grad and g is not None:
                store[k] = g if store[k] is None else store[k] + g

    for t in range(2 * (m + n_s - 1)):
        y_out, g_out = x_zero, g_zero
        if _fwd_tick(t, s, m):
            j = (t - s) // 2
            xin = _rows(x_leaves, j, mb) if s == 0 else x_inbox
            ring[j % n_s] = xin
            live = max(live, len(ring))
            if not last:
                # the last stage sends nothing: its backward tick, the
                # next one, runs the forward it needs
                with torch.no_grad():
                    y = _call(stage_fn, p_tree,
                              pytree.tree_unflatten(xin, x_spec), j,
                              microbatch_index)
                y_out = [a.to(tl.dtype) for a, tl in
                         zip(pytree.tree_leaves(y), template)]
        elif _bwd_tick(t, s, m, n_s):
            j = (t - (2 * n_s - 1 - s)) // 2
            xin = ring.pop(j % n_s)
            xg = [a.detach().requires_grad_(i in fl)
                  for i, a in enumerate(xin)]
            xt = pytree.tree_unflatten(xg, x_spec)
            want = [p for p in p_work if p.requires_grad] + \
                [xg[i] for i in fl]
            with torch.enable_grad():
                y = _call(stage_fn, p_tree, xt, j, microbatch_index)
                if last:
                    tgt = pytree.tree_unflatten(
                        _rows(t_leaves, j, mb), t_spec)
                    lval = loss_fn(y, tgt) if lp_tree is None else \
                        loss_fn(y, tgt, lp_tree)
                    want += [p for p in lp_work if p.requires_grad]
                    outs = [lval]
                    seeds = [torch.full_like(lval, 1.0 / m)]
                else:
                    y_l = [a.to(tl.dtype) for a, tl in
                           zip(pytree.tree_leaves(y), template)]
                    pairs = [(y_l[i], g) for i, g in zip(fl, g_inbox)
                             if y_l[i].requires_grad]
                    outs = [a for a, _ in pairs]
                    seeds = [g for _, g in pairs]
                got = list(torch.autograd.grad(
                    outs, want, seeds, allow_unused=True)) \
                    if outs else [None] * len(want)
            n_p = sum(p.requires_grad for p in p_work)
            it = iter(got[:n_p])
            acc(gacc, [next(it) if p.requires_grad else None
                       for p in p_work], p_work)
            dx = [torch.zeros_like(xg[i]) if g is None else g
                  for i, g in zip(fl, got[n_p:n_p + len(fl)])]
            if last:
                it = iter(got[n_p + len(fl):])
                acc(lpacc, [next(it) if p.requires_grad else None
                            for p in lp_work], lp_work)
                lacc = lacc + lval.detach().float() / m
            if s == 0:
                dxbuf[j] = dx
            g_out = dx
        if n_s > 1:
            # a hop runs on every rank on the ticks where some stage
            # sends (the same ints on every rank), with only the pairs
            # whose sender has a valid tick
            senders = [r for r in range(n_s - 1) if _fwd_tick(t, r, m)]
            if senders:
                x_inbox = _hop(y_out, group, 1, senders)
            senders = [r for r in range(1, n_s) if _bwd_tick(t, r, m, n_s)]
            if senders and fl:
                g_inbox = _hop(g_out, group, -1, senders)
    if stats is not None:
        stats["max_live_inputs"] = live
    grads = pytree.tree_unflatten(
        [torch.zeros_like(p) if g is None else g
         for g, p in zip(gacc, p_leaves)], p_spec)
    dx_leaves = []
    k = 0
    for i, a in enumerate(x_leaves):
        if i in fl:
            full = torch.cat([d[k] for d in dxbuf]) if s == 0 \
                else torch.zeros_like(a)
            k += 1
        else:
            full = torch.zeros_like(a)
        if n_s > 1 and i in fl:
            _broadcast(full, group, 0)
        dx_leaves.append(full)
    if n_s > 1:
        _broadcast(lacc, group, n_s - 1)
    dx = pytree.tree_unflatten(dx_leaves, x_spec)
    if loss_params is None:
        return lacc, grads, dx
    lp_grads = [torch.zeros_like(p) if g is None else g
                for g, p in zip(lpacc, pytree.tree_leaves(loss_params))]
    if n_s > 1:
        for g in lp_grads:
            _broadcast(g, group, n_s - 1)
    return lacc, grads, dx, pytree.tree_unflatten(lp_grads, lp_spec)


def onef1b_spmd(stage_fn: Callable, loss_fn: Callable, group: ProcessGroup,
                num_microbatches: int, *, microbatch_index: bool = False):
    """The per-rank 1F1B body (the twin of ``onef1b_spmd(stage_fn,
    loss_fn, axis_name, num_microbatches)``): returns
    ``run(stacked_params_local, x, target[, loss_params]) -> (loss,
    grads, dx[, loss_param_grads])`` with ``grads`` this rank's ``(1,
    ...)`` slice, like the params it took (see :func:`onef1b`)."""

    def run(stacked_params_local: Pytree, x: Pytree, target: Pytree,
            loss_params: Pytree = None, stats: Optional[dict] = None):
        s = _place(group)[1]
        params = _unstack(stacked_params_local, "the pipe group", s)
        out = onef1b(group, stage_fn, loss_fn, params, x, target,
                     num_microbatches, loss_params,
                     microbatch_index=microbatch_index, stats=stats)
        grads = pytree.tree_map(lambda a: a[None], out[1])
        return (out[0], grads) + tuple(out[2:])

    return run


def onef1b_loss_and_grad(mesh, axis_name: str, stage_fn: Callable,
                         loss_fn: Callable, stacked_params: Pytree,
                         x: Pytree, target: Pytree, num_microbatches: int,
                         loss_params: Pytree = None, *,
                         microbatch_index: bool = False):
    """One-call 1F1B over ``mesh``'s ``axis_name`` group: this rank's row
    of ``stacked_params`` runs as its stage.  Returns ``(loss, grads,
    dx)`` plus ``loss_param_grads`` with ``loss_params``; ``grads`` is
    this rank's ``(1, ...)`` row of the stacked gradients (the JAX form
    returns the whole stack, sharded over the axis), everything else
    the same on every rank."""
    group = mesh.groups.get(axis_name)
    s = _place(group)[1]
    run = onef1b_spmd(stage_fn, loss_fn, group, num_microbatches,
                      microbatch_index=microbatch_index)
    return run(_stage_rows(group, stacked_params, s), x, target,
               loss_params)
