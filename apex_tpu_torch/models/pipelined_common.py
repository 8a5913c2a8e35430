"""Shared plumbing of the pipelined model families.

Twin of ``apex_tpu/models/pipelined_common.py``: ``PipelinedBert`` and
``PipelinedGPT`` differ in their stage bodies and loss heads but share
the dropout prologue and the per-(microbatch, stage[, data index]) key
chain, so one copy lives here.  The mixin reads the attributes both
families set: ``mesh``, ``pipe_axis``, ``batch_axis``,
``num_microbatches`` and ``cfg`` (with ``hidden_dropout_prob`` and
``attention_probs_dropout_prob``).

Each rank of the port holds one stage, so the keys are computed on the
host from the microbatch's index and this rank's coordinates: nothing
is read back from the device.

The sequence axis (``seq_axis`` with a sequence-parallel
``attention_fn``): every rank of a (sp, pipe) group holds its data
index's whole batch and runs its S/sp tokens through its stage
(:meth:`PipelinedCommon._seq_slice`).  The stage keys fold in the
sequence index last, so each shard's stage masks are drawn at its local
shape from its own key, as the JAX stage inside ``shard_map`` draws
them; the embeddings, which the JAX model runs outside its
``shard_map`` on the whole batch, draw the rank's window of the whole
activation's stream (:meth:`PipelinedCommon._embed_window`).  Under 1F1B
the last stage gathers the microbatch's hidden states over the group
before the loss (:func:`gather_seq`, whose backward keeps this rank's
slice of the replicated cotangent), and the stage and embedding
gradients, partial on each shard, are summed over the group
(:meth:`PipelinedCommon._sum_over_seq`); the loss-head gradients,
computed on the gathered states, are whole on every shard already.

The model axis (``tp_axis``, the mesh's model group): Megatron tensor
parallelism inside each stage, as the JAX package's partial-manual
``shard_map`` leaves the model axis to GSPMD.  A rank holds its stage's
slice of each leaf under the family's rules (``tp_rules_name``), the
embeddings and heads their unstacked slices (:meth:`param_spec_tree`,
the port of ``tensor_parallel.pipeline_param_specs``); the stage body's
layers carry their own ``copy_to_group``/``reduce_from_group``, so the
model group's collectives run inside the schedules' ticks, at the same
tick on every rank of one (data, sp, pipe) coordinate.  The gradients
come out as local slices already (:meth:`constrain_grads` checks their
shapes); the stage key folds no model index, so the model ranks draw
the dense masks.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops import threefry

#: the embed key's fold_in index, far outside the microbatch ids the
#: stage keys fold in
EMBED_FOLD = 2 ** 20


def gather_seq(h: torch.Tensor, group) -> torch.Tensor:
    """``h``'s sequence shards (B, S_local, ...) concatenated over
    ``group`` on dim 1 (``parallel.gather_from_group``: the backward
    keeps this rank's slice of the cotangent, every rank computing the
    same replicated loss from the gathered tensor); ``h`` itself without
    an initialized process group."""
    from apex_tpu_torch.parallel.collectives import gather_from_group
    return gather_from_group(h, group, axis=1)


def rank_state_dict(state_dict: Mapping[str, torch.Tensor],
                    rank_name: Callable, layers_per_stage: int,
                    rank: int) -> Dict[str, torch.Tensor]:
    """The entries of a dense model's ``state_dict`` (or gradient tree)
    that pipeline rank ``rank`` holds, under its names (``rank_name(name,
    layers_per_stage, rank)``, None for another rank's)."""
    out = {}
    for name, t in state_dict.items():
        local = rank_name(name, layers_per_stage, rank)
        if local is not None:
            out[local] = t
    return out


class PipelinedCommon:
    #: the family's Megatron rules in ``parallel.tensor_parallel``
    #: (``"bert_tp_rules"``, ``"gpt_tp_rules"``), set by the subclass
    tp_rules_name = None

    def _setup(self, cfg, mesh, pp: int, num_microbatches: int,
               pipe_axis: str, batch_axis, seq_axis, tp_axis, attention_fn,
               sp_factory: str) -> None:
        """The checks and attributes both families' ``__init__`` share;
        ``sp_factory`` names the sequence-parallel attention a
        ``seq_axis`` would take, for the error."""
        if cfg.num_hidden_layers % pp:
            raise ValueError(
                f"num_hidden_layers={cfg.num_hidden_layers} must divide "
                f"into pp={pp} equal stages")
        if seq_axis is not None and attention_fn is None:
            raise ValueError(
                "seq_axis requires a sequence-parallel attention_fn for "
                f"the same axis ({sp_factory}) — plain attention would "
                "silently attend only within each sequence shard")
        if dist.is_initialized() and mesh.shape[pipe_axis] != pp:
            raise ValueError(f"pp={pp} but the mesh's {pipe_axis!r} axis "
                             f"has {mesh.shape[pipe_axis]} ranks")
        self.cfg, self.mesh, self.pp = cfg, mesh, pp
        self.num_microbatches = num_microbatches
        self.pipe_axis, self.batch_axis = pipe_axis, batch_axis
        self.seq_axis, self.tp_axis = seq_axis, tp_axis
        self.attention_fn = attention_fn
        self.tp = None
        if tp_axis is not None and dist.is_initialized():
            from apex_tpu_torch.parallel.tensor_parallel import tp_place
            self.tp = tp_place(mesh.group(tp_axis))
        elif tp_axis is not None and mesh.shape.get(tp_axis, 1) > 1:
            raise RuntimeError("a tensor-parallel model needs an "
                               "initialized process group")

    def _meta_layout(self):
        """The model without TP on ``meta``: a module whose parameters
        carry this rank's names at their full per-stage shapes (the
        subclass builds it)."""
        raise NotImplementedError

    def param_spec_tree(self, params=None) -> Dict[str, tuple]:
        """``{name: spec}`` by ``parallel.tensor_parallel.
        pipeline_param_specs`` under the family's rules for ``tp_axis``
        (none without it): the stage leaves ``(pipe_axis, *spec)``, the
        embeddings and heads their plain specs.  ``params`` (``{name:
        tensor}`` at the full per-stage shapes) defaults to this model's
        own (:meth:`_meta_layout`)."""
        from apex_tpu_torch.parallel import tensor_parallel as tpar
        rules = (getattr(tpar, self.tp_rules_name)(self.tp_axis)
                 if self.tp_axis is not None else ())
        if params is None:
            params = dict(self._meta_layout().named_parameters())
        return tpar.pipeline_param_specs(
            params, tpar.Mesh(dict(self.mesh.shape)), rules, self.pipe_axis,
            num_heads=self.cfg.num_attention_heads)

    def _tp_specs(self) -> Dict[str, tuple]:
        """Each local name's model split (its spec without the stacked
        pipe entry); ``{}`` without TP."""
        if self.tp is None:
            return {}
        prefix = "stages."
        return {name: spec[1:] if name.startswith(prefix) else spec
                for name, spec in self.param_spec_tree().items()}

    def tp_places(self) -> Dict[str, tuple]:
        """Each local parameter's ``parallel.tensor_parallel.Place`` in the
        JAX layout: its model split (heads kept), and for a stage leaf the
        pipe ranks its JAX leaf is stacked over (``split``): the
        ``like_params`` of ZeRO-1 over the moments (the data shard goes
        on the first dim the stacking and the model split leave free)."""
        from apex_tpu_torch.parallel import tensor_parallel as tpar
        rules = (getattr(tpar, self.tp_rules_name)(self.tp_axis)
                 if self.tp is not None else ())
        full = dict(self._meta_layout().named_parameters())
        specs = tpar.param_specs(full, tpar.Mesh(dict(self.mesh.shape)),
                                 rules,
                                 num_heads=self.cfg.num_attention_heads,
                                 keep_heads=True)
        places = tpar.param_places(self, specs, self.mesh.shape,
                                   self.cfg.num_attention_heads)
        return {name: place._replace(split=place.split * self.pp)
                if name.startswith("stages.") else place
                for name, place in places.items()}

    def shard_variables(self, state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """This rank's Megatron slice of its stage's full state dict
        (``dense_to_rank``'s or ``params_from_jax(..., rank=)``'s, at the
        full TP shapes): each leaf cut as :meth:`param_spec_tree` places
        it, at this rank's model index; as it is without TP."""
        specs = self._tp_specs()
        if not specs:
            return dict(state_dict)
        from apex_tpu_torch.parallel.tensor_parallel import local_slice
        coords = {self.tp_axis: self.tp.rank}
        return {name: local_slice(t, specs[name], self.mesh.shape, coords)
                if specs.get(name) else t
                for name, t in state_dict.items()}

    def constrain_grads(self, grads: Mapping[str, torch.Tensor]):
        """The gradients as they are: a rank's are its leaves' local
        slices already (the JAX method pins GSPMD's placement on them);
        raises where one's shape is not its parameter's."""
        mine = dict(self.named_parameters())
        for name, g in grads.items():
            if g.shape != mine[name].shape:
                raise ValueError(f"{name}'s gradient is {tuple(g.shape)}, "
                                 f"the parameter {tuple(mine[name].shape)}")
        return grads

    def _pipe(self):
        return self.mesh.group(self.pipe_axis) if dist.is_initialized() \
            else None

    @torch.no_grad()
    def _reset_from_dense(self, dense, rank_name: Callable,
                          layers_per_stage: int, seed: int) -> None:
        """The dense model's draws from ``seed`` (normal(initializer_range)
        for every weight in its parameter order, unit LN scales, zero
        biases), this rank's kept (under TP its slice): the ranks
        together hold the dense model's weights.  ``dense`` is the dense
        model on ``meta``."""
        from apex_tpu_torch.parallel.tensor_parallel import is_bias, \
            local_slice
        gen = torch.Generator().manual_seed(int(seed))
        std = self.cfg.initializer_range
        mine = dict(self.named_parameters())
        r = self._coord(self.pipe_axis)
        specs = self._tp_specs()
        coords = {self.tp_axis: self.tp.rank} if specs else {}
        for name, p in dense.named_parameters():
            if name.endswith("_ln.scale"):
                fill = torch.ones(())
            elif is_bias(name):
                fill = torch.zeros(())
            else:
                fill = torch.empty(p.shape, dtype=torch.float32).normal_(
                    0.0, std, generator=gen)
            local = rank_name(name, layers_per_stage, r)
            if local is not None:
                if specs.get(local) and fill.dim():
                    fill = local_slice(fill, specs[local], self.mesh.shape,
                                       coords)
                mine[local].copy_(fill)

    def _coord(self, axis: Optional[str]) -> int:
        if axis is None or not dist.is_initialized():
            return 0
        return self.mesh.index(axis)

    def _microbatch_ids(self, h: torch.Tensor) -> torch.Tensor:
        """One microbatch id per row, as the schedules split the (local)
        batch: contiguous groups of b / M rows."""
        b = h.shape[0]
        return torch.arange(b, dtype=torch.int32, device=h.device) // \
            max(1, b // self.num_microbatches)

    def _stage_dropout_key(self, base_key, mb: int) -> threefry.Key:
        """The key of microbatch ``mb`` on this rank's stage: ``base_key``
        with the microbatch id, the pipe index, (with ``batch_axis``) the
        data index and (with ``seq_axis``) the sequence index folded in,
        in that order."""
        key = threefry.fold_in(base_key, mb)
        key = threefry.fold_in(key, self._coord(self.pipe_axis))
        if self.batch_axis:
            key = threefry.fold_in(key, self._coord(self.batch_axis))
        if self.seq_axis:
            key = threefry.fold_in(key, self._coord(self.seq_axis))
        return key

    def _seq_group(self):
        return self.mesh.group(self.seq_axis) \
            if self.seq_axis and dist.is_initialized() else None

    def _seq_slice(self, t: Optional[torch.Tensor]):
        """This rank's tokens ``t[:, r * S/sp:(r + 1) * S/sp]`` of a (B, S)
        input (``t`` itself without a sequence axis, None for None)."""
        group = self._seq_group()
        if t is None or group is None:
            return t
        n = t.shape[1] // group.size()
        return t[:, group.rank() * n:(group.rank() + 1) * n]

    def _embed_window(self, input_ids: torch.Tensor):
        """``(offset, window)`` of this rank's embeddings: the position of
        its first token, and where its (B, S_local, H) activation lies
        in the counters of the whole (B * dp, S, H) activation the JAX
        model's embeddings drop (``threefry.window``; None when the rank
        holds all of it)."""
        b, s = input_ids.shape
        seq = self._seq_group()
        n_sp = 1 if seq is None else seq.size()
        n_dp = self.mesh.shape[self.batch_axis] \
            if self.batch_axis and dist.is_initialized() else 1
        if n_sp == 1 and n_dp == 1:
            return 0, None
        s_local = s // n_sp
        offset = 0 if seq is None else seq.rank() * s_local
        row, stride, base = threefry.window(
            (b * n_dp, s, self.cfg.hidden_size), 1, offset, s_local)
        base += self._coord(self.batch_axis) * b * stride
        return offset, (row, stride, base)

    def _check_onef1b(self) -> None:
        """The reference's fence: under ``seq_axis`` 1F1B takes only an
        ``attention_fn`` marked ``onef1b_compatible``."""
        if self.seq_axis is not None and not getattr(
                self.attention_fn, "onef1b_compatible", False):
            raise NotImplementedError(
                "seq_axis under 1F1B needs an attention_fn marked "
                "onef1b_compatible=True (make_ulysses_attention is; ring "
                "attention is NOT — its collective-carrying scan "
                "miscomputes in the schedule's cond branches). Tag your "
                "own scan-free implementation explicitly, or use the GPipe "
                "apply() path")

    def _sum_over_seq(self, grads: Dict[str, torch.Tensor]):
        """``grads`` summed over the sequence group (bucketed, one
        all-reduce a dtype); as they are without one."""
        group = self._seq_group()
        if group is None or group.size() == 1 or not grads:
            return grads
        from apex_tpu_torch.parallel.distributed import \
            DistributedDataParallel
        return DistributedDataParallel(
            process_group=group, gradient_average=False).reduce_gradients(
                grads)

    def _dropout_setup(self, deterministic: bool, dropout_key, caller: str):
        """The rng prologue of both training paths: ``(needs_rng,
        base_key, embed_key)``, the embed key ``fold_in(base_key,
        2**20)``."""
        cfg = self.cfg
        needs_rng = not deterministic and (
            cfg.hidden_dropout_prob > 0
            or cfg.attention_probs_dropout_prob > 0)
        if not needs_rng:
            return False, None, None
        if dropout_key is None:
            raise ValueError(
                f"{caller}(deterministic=False) with dropout in the "
                "config needs dropout_key= (the JAX model's "
                "rngs={'dropout': key})")
        base_key = threefry.as_key(dropout_key)
        return True, base_key, threefry.fold_in(base_key, EMBED_FOLD)
