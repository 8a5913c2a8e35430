"""Process groups over ``torch.distributed``.

Twin of ``apex_tpu/parallel/mesh.py``.  The JAX package names a group by
a mesh axis and a partition of its indices; here a group is the
partition of the world's ranks into equal groups plus the
``torch.distributed`` group that holds this rank.  ``groups=None`` is
the whole world (the default group).

:func:`create_mesh` is the twin of the JAX examples' ``Mesh(devices
.reshape(dp, sp, tp), ("data", "sp", "model"))`` and of the BERT
example's ``Mesh(devices.reshape(dp, pp), ("data", "pipe"))`` (with a
sequence axis ``(dp, sp, pp)``): rank r sits at data index ``r // (sp *
pp * tp)``, sequence index ``(r // (pp * tp)) % sp``, pipe index ``(r //
tp) % pp`` and model index ``r % tp``, so the model groups are
contiguous and the pipe, sequence and data groups strided.  A fifth
group, ``"data_sp"``, holds the ranks of one (pipe, model) coordinate:
the ranks over which a sequence-parallel model's replicated parameters
are reduced.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist


class ProcessGroup(NamedTuple):
    """A collective scope: the world (``groups=None``), or this rank's
    member of a partition of the world into equal contiguous groups."""

    groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    handle: Any = None        # torch.distributed group; None: the world

    @property
    def group_size(self) -> Optional[int]:
        """Ranks a group of the partition holds; None for the world."""
        if self.groups is None:
            return None
        return len(self.groups[0])

    def size(self) -> int:
        """Ranks in this rank's group (the world's size for the world)."""
        if self.groups is None:
            return dist.get_world_size()
        return len(self.groups[0])

    def members(self) -> Tuple[int, ...]:
        """Global ranks of this rank's group, in group order."""
        if self.groups is None:
            return tuple(range(dist.get_world_size()))
        rank = dist.get_rank()
        return next(g for g in self.groups if rank in g)

    def rank(self) -> int:
        """This rank's index within its group."""
        return self.members().index(dist.get_rank())

    def backend(self) -> str:
        """The group's ``torch.distributed`` backend name (``"nccl"``,
        ``"gloo"``)."""
        return str(dist.get_backend(self.handle))


WORLD = ProcessGroup()


def _new_groups(groups: Sequence[Tuple[int, ...]]) -> ProcessGroup:
    """Make every group of the partition on every rank, in order (each
    ``dist.new_group`` is a collective call of the whole world), and keep
    the one that holds this rank."""
    rank = dist.get_rank()
    handle = None
    for g in groups:
        made = dist.new_group(list(g))
        if rank in g:
            handle = made
    return ProcessGroup(tuple(tuple(g) for g in groups), handle)


def create_process_group(group_size: Optional[int] = None,
                         world_size: Optional[int] = None) -> ProcessGroup:
    """Partition the world into contiguous groups of ``group_size`` ranks
    (rank r in group r // group_size), as the reference's
    ``create_syncbn_process_group(group_size)``; ``None`` gives the
    world.  Every rank must call it, with the same arguments and in the
    same order as every other rank: each group is made with
    ``torch.distributed.new_group`` on every rank."""
    if group_size is None:
        return WORLD
    if world_size is None:
        world_size = dist.get_world_size()
    if group_size <= 0 or world_size % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must evenly divide world size "
            f"{world_size} (reference requires the same)")
    return _new_groups([tuple(range(g * group_size, (g + 1) * group_size))
                        for g in range(world_size // group_size)])


class Mesh(NamedTuple):
    """A (data, sp, pipe, model) rank mesh: ``shape`` maps each axis name
    to its size, ``groups`` each axis (and ``"data_sp"``, the data and
    sequence axes together) to this rank's ``ProcessGroup`` along it
    (empty for a mesh made only to read shapes, as ``param_specs``
    does)."""

    shape: Dict[str, int]
    groups: Dict[str, ProcessGroup] = {}

    def group(self, axis: str) -> ProcessGroup:
        return self.groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.groups[axis].rank()


def create_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
                pp: int = 1) -> Mesh:
    """The world as a ``(dp, sp, pp, tp)`` mesh with axes ``"data"``,
    ``"sp"``, ``"pipe"`` and ``"model"`` (``dp`` defaults to world size
    // (``sp`` * ``pp`` * ``tp``)): rank r is data index ``r // (sp * pp
    * tp)``, sequence index ``(r // (pp * tp)) % sp``, pipe index ``(r //
    tp) % pp``, model index ``r % tp``.  The model groups are
    contiguous, the pipe groups strided by ``tp``, the sequence groups by
    ``pp * tp``, the data groups by ``sp * pp * tp``.  Every rank must
    call it in the same order as every other rank; every group is made
    on every rank, the model groups first, then the data, sequence and
    pipe groups (at ``pp`` 1 the ranks and the first three axes' groups
    are those of the ``(dp, sp, tp)`` mesh), then, with ``sp`` above 1
    beside a pipe or model axis above 1, the ``"data_sp"`` groups: the
    ``dp * sp`` ranks of each (pipe, model) coordinate (else it is the
    data group at ``sp`` 1 and the world when the data and sequence
    axes are all of it).  A model axis beside the pipe axis is tensor
    parallelism inside the pipeline: each stage's layers split over the
    ``tp`` contiguous ranks of one (data, sp, pipe) coordinate, the
    stage hops running between the ranks of one model index."""
    world = dist.get_world_size()
    inner = sp * pp * tp
    if dp is None:
        dp = world // inner if inner > 0 else 0
    if min(tp, sp, pp, dp) <= 0 or dp * inner != world:
        raise ValueError(f"mesh ({dp}, {sp}, {pp}, {tp}) does not tile a "
                         f"world of {world} ranks")
    model = _new_groups([tuple(range(g * tp, (g + 1) * tp))
                         for g in range(dp * sp * pp)])
    data = _new_groups([tuple(range(j, world, inner)) for j in range(inner)])
    seq = _new_groups([tuple(d * inner + s * pp * tp + q * tp + m
                             for s in range(sp))
                       for d in range(dp) for q in range(pp)
                       for m in range(tp)])
    pipe = _new_groups([tuple(d * inner + s * pp * tp + q * tp + m
                              for q in range(pp))
                        for d in range(dp) for s in range(sp)
                        for m in range(tp)])
    if sp == 1:
        data_sp = data
    elif pp * tp == 1:
        data_sp = WORLD
    else:
        data_sp = _new_groups([tuple(d * inner + s * pp * tp + q * tp + m
                                     for d in range(dp) for s in range(sp))
                               for q in range(pp) for m in range(tp)])
    return Mesh({"data": dp, "sp": sp, "pipe": pp, "model": tp},
                {"data": data, "sp": seq, "pipe": pipe, "model": model,
                 "data_sp": data_sp})
