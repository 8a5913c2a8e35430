"""Switch-MoE MLP with expert parallelism over a process group.

Twin of ``apex_tpu/models/moe.py``.  The experts live as four stacked
parameters with a leading expert dim, in the JAX layout (so a JAX tree
carries over as it is and the EP rule splits dim 0): ``experts_in`` (E,
H, F), ``experts_bias_in`` (E, F), ``experts_out`` (E, F, H),
``experts_bias_out`` (E, H); the router is an ``nn.Linear(H, E)`` named
``router``, which amp's ``ROUTER_PATTERNS`` keeps fp32 under O1 and O2.

Router: softmax gate over ``router(x)`` computed from ``x.float()`` as a
true fp32 product (TF32 off for the call, whatever the global flags
say: the JAX router asks for ``precision=HIGHEST``, and a rounded
product flips routing decisions), top-1 by ``argmax`` (ties to the first
index, as ``jnp.argmax``), the chosen expert's probability the combine
weight (Switch).  Load-balance aux ``E * sum_e f_e * P_e`` (``f_e`` the
fraction of tokens routed to expert e, ``P_e`` its mean gate
probability), fp32.

Two dispatches, the JAX module's:

- ``"dense"``: every expert runs every token (einsums over the stacked
  experts, exact-erf GELU) and the one-hot combine masks the sum;
- ``"capacity"``: Switch capacity-factor gather/scatter.  Expert e takes
  at most ``C = ceil(capacity_factor * T / E)`` tokens in arrival order
  (the position an exclusive cumsum of the one-hot); a token past its
  expert's capacity goes to a dummy slot and its output row is exactly
  zero (it rides the caller's residual); an empty slot gathers an
  appended zero row; the combine is a scatter-add in the expert output's
  dtype, cast to x's once at the end.  With ``capacity_factor >= E``
  nothing drops and the output equals the dense dispatch's.  A rank's
  slot table is ``E x min(C, T_local)``.

Expert parallelism (``ep=`` a ``parallel.ProcessGroup`` of n ranks that
hold the same tokens): the JAX package places the experts by
``EP_RULES`` and GSPMD runs each device's experts and reduces once; here
each rank holds E/n experts (``parallel.shard_params(state_dict,
Mesh({"expert": n}, {"expert": group}), EP_RULES)`` cuts its slice),
computes the router and the routing table as every rank does, runs its
own experts (dense: over all tokens, with its columns of the combine;
capacity: over its own slots) and sums the partial outputs with
``reduce_from_group``.  ``x`` and the combine weights are replicated
inputs of per-rank work, so they pass ``copy_to_group`` first: their
gradients are summed over the group, and the router's and ``x``'s
gradients are whole on every rank.  E not divisible by n leaves the
experts whole, as ``param_specs`` falls back.

``aux_group`` (a ``ProcessGroup`` of ranks that run one step on
different tokens, e.g. a data-parallel group): the batch is the
group's, as the JAX package's GSPMD sees a data- and sequence-sharded
global batch.  ``f_e`` is averaged over it (no gradient) before the
product with the local ``P_e``, so the group's mean of the ranks' aux is
the aux of the whole batch, value and gradient.  The capacity dispatch
takes T, and each token's arrival position, over the whole batch in
its global (row, position) order: rank g of the group holds row block g
// ``seq_shards`` and sequence block g % ``seq_shards`` (the mesh's
``"data_sp"`` order; ``seq_shards`` the sequence-parallel degree), and
one all-reduce of the ranks' per-row expert counts gives each token the
count of earlier tokens on the other ranks.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.parallel.collectives import copy_to_group, \
    reduce_from_group
from apex_tpu_torch.parallel.mesh import ProcessGroup
from apex_tpu_torch.parallel.tensor_parallel import TPPlace, reset_seeded

EXPERT_LEAVES = ("experts_in", "experts_bias_in", "experts_out",
                 "experts_bias_out")


def ep_rules(axis: str = "expert"):
    """Sharding rules for ``MoEMlp`` params (leading expert dim), for
    ``parallel.shard_params`` over the port's dotted names."""
    return (
        (r"experts_in$", (axis, None, None)),
        (r"experts_bias_in$", (axis, None)),
        (r"experts_out$", (axis, None, None)),
        (r"experts_bias_out$", (axis, None)),
    )


EP_RULES = ep_rules()


def ep_specs(module: nn.Module) -> Dict[str, tuple]:
    """Each expert leaf of ``module``'s parameters (an ``MoEMlp`` or a
    model holding some) with its split under ``EP_RULES``."""
    return {name: spec for name, _ in module.named_parameters()
            for pat, spec in EP_RULES if re.search(pat, name)}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``MoEMlp``'s param tree (``{"params": ...}`` or its inner
    dict, leaves as arrays) as this module's state dict: the stacked
    experts as they are, the router kernel (H, E) transposed into
    ``nn.Linear``'s (E, H)."""
    p = params.get("params", params)

    def t(a):
        return torch.from_numpy(np.array(a, order="C"))

    sd = {name: t(p[name]) for name in EXPERT_LEAVES}
    sd["router.weight"] = t(np.asarray(p["router"]["kernel"]).T)
    sd["router.bias"] = t(p["router"]["bias"])
    return sd


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _ieee_fp32(device: torch.device):
    """fp32 products as fp32 (no TF32) for the block, on the card."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MoEMlp(nn.Module):
    """Top-1-routed MLP: ``(B, S, H) -> ((B, S, H), aux)``, aux fp32.

    ``seed`` draws the JAX module's initialization from a CPU generator
    (normal(0.02) for the expert kernels and the router, zero biases; the
    full tensors, this rank's experts kept); ``seed=None`` leaves the
    parameters for the caller to fill (a state dict, or a model's own
    init)."""

    def __init__(self, num_experts: int, hidden_size: int,
                 intermediate_size: int, dispatch: str = "dense",
                 capacity_factor: float = 1.25, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 ep: Optional[ProcessGroup] = None,
                 aux_group: Optional[ProcessGroup] = None,
                 seq_shards: int = 1, seed: Optional[int] = None):
        super().__init__()
        if dispatch not in ("dense", "capacity"):
            raise ValueError(
                f"MoEMlp dispatch must be 'dense' or 'capacity', got "
                f"{dispatch!r}")
        dev = resolve_device(device)
        e, h, f = num_experts, hidden_size, intermediate_size
        self.num_experts = e
        self.dispatch, self.capacity_factor = dispatch, capacity_factor
        n = ep.size() if ep is not None and _initialized() else 1
        self.ep = ep if n > 1 and e % n == 0 else None
        self.ep_size = n if self.ep is not None else 1
        self.ep_rank = self.ep.rank() if self.ep is not None else 0
        self.aux_group, self.seq_shards = aux_group, seq_shards
        el = e // self.ep_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=dev, dtype=dtype))

        self.experts_in = param(el, h, f)
        self.experts_bias_in = param(el, f)
        self.experts_out = param(el, f, h)
        self.experts_bias_out = param(el, h)
        self.router = nn.Linear(h, e, device=dev, dtype=dtype)
        if seed is not None:
            self.reset_parameters(seed)

    def reset_parameters(self, seed: int, std: float = 0.02) -> None:
        places = {} if self.ep is None else {
            "expert": TPPlace(self.ep, self.ep_rank, self.ep_size)}
        reset_seeded(self, ep_specs(self) if places else {}, places, seed,
                     std)

    def _route(self, x):
        """(gate, top1, one_hot): the fp32 softmax gate, the chosen
        expert and its one-hot, from the fp32 router."""
        with _ieee_fp32(x.device):
            logits = F.linear(x.float(), self.router.weight.float(),
                              self.router.bias.float())
        gate = torch.softmax(logits, dim=-1)
        top1 = torch.argmax(gate, dim=-1)
        one_hot = F.one_hot(top1, self.num_experts).to(gate.dtype)
        return gate, top1, one_hot

    def _aux(self, gate, one_hot):
        dims = tuple(range(gate.dim() - 1))
        frac_tokens = one_hot.mean(dim=dims)
        group = self._batch_group()
        if group is not None:
            frac_tokens = frac_tokens.detach().clone()
            dist.all_reduce(frac_tokens, group=group.handle)
            frac_tokens = frac_tokens / group.size()
        frac_prob = gate.mean(dim=dims)
        aux = self.num_experts * torch.sum(frac_tokens * frac_prob)
        return aux.float()

    def _shared(self, t):
        """``t`` as the input of this rank's share of the experts: its
        gradient summed over the expert group."""
        return t if self.ep is None else copy_to_group(t, self.ep)

    def forward(self, x):
        gate, top1, one_hot = self._route(x)
        if self.dispatch == "capacity":
            out = self._capacity(x, gate, top1, one_hot)
        else:
            out = self._dense(x, gate, one_hot)
        return out, self._aux(gate, one_hot)

    def _dense(self, x, gate, one_hot):
        el = self.experts_in.shape[0]
        lo = self.ep_rank * el
        # Switch scaling: route weight = the chosen expert's probability
        combine = self._shared((one_hot * gate).to(x.dtype))[..., lo:lo + el]
        xs = self._shared(x)
        y = torch.einsum("bsh,ehf->bsef", xs, self.experts_in) \
            + self.experts_bias_in[None, None]
        y = F.gelu(y)                                   # exact erf
        y = torch.einsum("bsef,efh->bseh", y, self.experts_out) \
            + self.experts_bias_out[None, None]
        out = torch.einsum("bseh,bse->bsh", y, combine)
        return out if self.ep is None else reduce_from_group(out, self.ep)

    def _batch_group(self) -> Optional[ProcessGroup]:
        group = self.aux_group
        return group if group is not None and _initialized() \
            and group.size() > 1 else None

    def _arrival(self, oh, b, s):
        """(positions, tokens): each of the rank's tokens' position in
        each expert's arrival order (an exclusive cumsum of the one-hot
        ``oh``, (T, E)) over the whole batch, and the batch's token count.
        With ``aux_group`` the batch is every rank's of the group in the
        global (row, position) order, the rank's rows block g //
        ``seq_shards`` and its sequence block g % ``seq_shards`` (g its
        rank in the group): the earlier tokens' counts come from one
        all-reduce of every rank's per-row counts."""
        group = self._batch_group()
        if group is None:
            return torch.cumsum(oh, dim=0) - oh, b * s
        n, k, e = group.size(), self.seq_shards, self.num_experts
        if n % k:
            raise ValueError(f"MoEMlp seq_shards {k} must divide the "
                             f"aux_group's {n} ranks")
        ohr = oh.detach().reshape(b, s, e)
        counts = ohr.new_zeros(n, b, e)
        counts[group.rank()] = ohr.sum(dim=1)
        dist.all_reduce(counts, group=group.handle)
        # (row blocks, sequence blocks, rows, E) -> the global rows'
        # counts per sequence block
        counts = counts.reshape(n // k, k, b, e).transpose(1, 2) \
            .reshape(n // k * b, k, e)
        rows = counts.sum(dim=1)
        before = torch.cumsum(rows, dim=0) - rows
        d, j = divmod(group.rank(), k)
        mine = slice(d * b, (d + 1) * b)
        offset = before[mine] + counts[mine, :j].sum(dim=1)
        pos = torch.cumsum(ohr, dim=1) - ohr + offset[:, None]
        return pos.reshape(b * s, e), b * s * n

    def _capacity(self, x, gate, top1, one_hot):
        e = self.num_experts
        b, s, h = x.shape
        t = b * s
        dev = x.device
        top1_f = top1.reshape(t)
        # the chosen expert's probability per token (the combine weight)
        gate_top = torch.sum(one_hot * gate, dim=-1).reshape(t)
        oh = one_hot.reshape(t, e)
        # each token's position in its expert's arrival order over the
        # batch, and the cap from the batch's tokens
        arrival, total = self._arrival(oh, b, s)
        cap = max(1, int(math.ceil(self.capacity_factor * total / e)))
        pos = arrival.gather(1, top1_f[:, None])[:, 0].to(torch.int64)
        # the rank's slots: a kept token at its place among the rank's own
        # tokens of its expert (the first ones of them are the kept ones,
        # so the place is below the cap and below t)
        local = pos
        if total != t:
            cum = torch.cumsum(oh, dim=0) - oh
            local = cum.gather(1, top1_f[:, None])[:, 0].to(torch.int64)
        slots = min(cap, t)
        # routing slot = expert * slots + place; overflow -> dummy slot
        slot = torch.where(pos < cap, top1_f * slots + local,
                           torch.full_like(pos, e * slots))
        # slot -> token (kept slots are unique; the dropped tokens all land
        # on the dummy and go with it); an empty slot reads row t, zero
        token_for_slot = torch.full((e * slots + 1,), t, dtype=torch.int64,
                                    device=dev)
        token_for_slot[slot] = torch.arange(t, dtype=torch.int64, device=dev)
        el = self.experts_in.shape[0]
        lo = self.ep_rank * el * slots
        tok = token_for_slot[lo:lo + el * slots]
        xf = self._shared(x).reshape(t, h)
        xg = torch.cat([xf, xf.new_zeros(1, h)])[tok]
        y = torch.einsum("ech,ehf->ecf", xg.reshape(el, slots, h),
                         self.experts_in) + self.experts_bias_in[:, None]
        y = F.gelu(y)
        y = torch.einsum("ecf,efh->ech", y, self.experts_out) \
            + self.experts_bias_out[:, None]
        # combine: each slot scaled by its token's gate probability (0 for
        # an empty slot) and scattered back in y's dtype; a dropped token's
        # row stays zero
        g = self._shared(gate_top)
        gate_slot = torch.cat([g, g.new_zeros(1)])[tok]
        yf = y.reshape(el * slots, h) * gate_slot[:, None].to(y.dtype)
        out = yf.new_zeros(t + 1, h).index_add(0, tok, yf)[:t]
        if self.ep is not None:
            out = reduce_from_group(out, self.ep)
        return out.reshape(b, s, h).to(x.dtype)
