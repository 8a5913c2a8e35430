"""apex_tpu_torch.parallel — data-parallel training on ``torch.distributed``.

Twin of ``apex_tpu.parallel``'s data-parallel half (reference
``apex/parallel``): ``DistributedDataParallel`` and ``Reducer``,
``SyncBatchNorm`` with ``convert_syncbn_model``, ``LARC``, process
groups and the launcher.  One process per GPU: NCCL on the card, gloo
on the CPU.

Not here yet: tensor, sequence and pipeline parallelism, expert
parallelism and ZeRO.
"""

from apex_tpu_torch.parallel.LARC import LARC
from apex_tpu_torch.parallel.collectives import all_gather_g, pmean_g, \
    psum_g
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    all_gather_tree,
    all_reduce_tree,
    broadcast_params,
)
from apex_tpu_torch.parallel.mesh import ProcessGroup, create_process_group
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    merge_stats,
    welford_combine,
)


def create_syncbn_process_group(group_size: int,
                                world_size=None) -> ProcessGroup:
    """Reference-named alias of :func:`create_process_group`
    (``apex/parallel/__init__.py:55``)."""
    return create_process_group(group_size, world_size)


__all__ = [
    "DistributedDataParallel",
    "LARC",
    "ProcessGroup",
    "Reducer",
    "SyncBatchNorm",
    "all_gather_g",
    "all_gather_tree",
    "all_reduce_tree",
    "broadcast_params",
    "convert_syncbn_model",
    "create_process_group",
    "create_syncbn_process_group",
    "initialize_distributed",
    "merge_stats",
    "pmean_g",
    "psum_g",
    "welford_combine",
]
