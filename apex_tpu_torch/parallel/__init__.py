"""apex_tpu_torch.parallel — data-parallel training on ``torch.distributed``.

Twin of ``apex_tpu.parallel``'s data-parallel half (reference
``apex/parallel``): ``DistributedDataParallel`` and ``Reducer``,
``SyncBatchNorm`` with ``convert_syncbn_model``, ``LARC``, process
groups and the launcher.  One process per GPU: NCCL on the card, gloo
on the CPU.  Megatron tensor parallelism (``tensor_parallel``: the rules
and the split; the (data, sp, model) rank mesh ``create_mesh``; the
collectives ``copy_to_group`` / ``reduce_from_group``), ZeRO-1/2
(``zero``), sequence parallelism (``sequence``: ring and Ulysses
attention over the collectives ``ppermute_g`` / ``all_to_all_g``) and
pipeline parallelism (``pipeline``: GPipe and 1F1B over the stage hop
``shift_g``, one stage a rank of the mesh's pipe axis).

Expert parallelism lives with its module, as in the JAX package:
``models.MoEMlp(ep=<group>)`` with ``models.EP_RULES`` for
:func:`shard_params`.
"""

from apex_tpu_torch.parallel.LARC import LARC
from apex_tpu_torch.parallel.collectives import (
    all_gather_flat,
    all_gather_g,
    all_to_all_g,
    copy_to_group,
    gather_from_group,
    pmax_g,
    pmean_g,
    ppermute_g,
    psum_g,
    reduce_from_group,
    reduce_scatter_flat,
    shift_g,
)
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    all_gather_tree,
    all_reduce_tree,
    broadcast_params,
)
from apex_tpu_torch.parallel.mesh import Mesh, ProcessGroup, create_mesh, \
    create_process_group
from apex_tpu_torch.parallel.multiproc import initialize_distributed
from apex_tpu_torch.parallel.pipeline import (
    gpipe,
    gpipe_spmd,
    onef1b,
    onef1b_loss_and_grad,
    onef1b_spmd,
    pipeline_apply,
)
from apex_tpu_torch.parallel.sequence import (
    make_ring_attention,
    make_ulysses_attention,
    ring_attention,
    ulysses_attention,
)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    merge_stats,
    welford_combine,
)
from apex_tpu_torch.parallel.tensor_parallel import (
    BERT_TP_RULES,
    Heads,
    bert_tp_rules,
    gpt_tp_rules,
    param_specs,
    pipeline_param_specs,
    shard_params,
)
from apex_tpu_torch.parallel.zero import (
    shard_optimizer_state,
    unshard_optimizer_state,
    zero2_update,
)


def create_syncbn_process_group(group_size: int,
                                world_size=None) -> ProcessGroup:
    """Reference-named alias of :func:`create_process_group`
    (``apex/parallel/__init__.py:55``)."""
    return create_process_group(group_size, world_size)


__all__ = [
    "BERT_TP_RULES",
    "DistributedDataParallel",
    "Heads",
    "LARC",
    "Mesh",
    "ProcessGroup",
    "Reducer",
    "SyncBatchNorm",
    "all_gather_flat",
    "all_gather_g",
    "all_gather_tree",
    "all_reduce_tree",
    "all_to_all_g",
    "bert_tp_rules",
    "broadcast_params",
    "convert_syncbn_model",
    "copy_to_group",
    "create_mesh",
    "create_process_group",
    "create_syncbn_process_group",
    "gather_from_group",
    "gpipe",
    "gpipe_spmd",
    "gpt_tp_rules",
    "initialize_distributed",
    "make_ring_attention",
    "make_ulysses_attention",
    "merge_stats",
    "onef1b",
    "onef1b_loss_and_grad",
    "onef1b_spmd",
    "param_specs",
    "pipeline_apply",
    "pipeline_param_specs",
    "pmax_g",
    "pmean_g",
    "ppermute_g",
    "psum_g",
    "reduce_from_group",
    "reduce_scatter_flat",
    "ring_attention",
    "shard_optimizer_state",
    "shard_params",
    "shift_g",
    "ulysses_attention",
    "unshard_optimizer_state",
    "welford_combine",
    "zero2_update",
]
