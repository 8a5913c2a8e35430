"""Process groups over ``torch.distributed``.

Twin of ``apex_tpu/parallel/mesh.py``.  The JAX package names a group by
a mesh axis and a partition of its indices; here a group is the
partition of the world's ranks into contiguous groups plus the
``torch.distributed`` group that holds this rank.  ``groups=None`` is
the whole world (the default group).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

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


WORLD = ProcessGroup()


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
    groups = tuple(tuple(range(g * group_size, (g + 1) * group_size))
                   for g in range(world_size // group_size))
    rank = dist.get_rank()
    handle = None
    for g in groups:
        made = dist.new_group(list(g))
        if rank in g:
            handle = made
    return ProcessGroup(groups, handle)
