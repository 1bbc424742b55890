"""Rank groups of the multi-GPU paths.

Port of ``repro/launch/mesh.py``. The reference builds XLA meshes of
forced or real devices; the port runs SPMD on ``torch.distributed``, one
process a rank, so a "mesh" is a group of the default group's ranks.
The caller initializes the default group (NCCL with a card a rank, gloo
when ranks share a card or run on the CPU) and each rank's device.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.ctx import SeqShard


def seq_group(degree: int | None = None) -> SeqShard | None:
    """This rank's ``SeqShard`` in the group of ranks 0..degree-1 of the
    default group (all of them by default), or None on a rank past it.
    Every rank of the default group must call it alike: the subgroup is
    made by ``dist.new_group``, which every rank enters."""
    world = dist.get_world_size()
    degree = world if degree is None else degree
    if not 1 <= degree <= world:
        raise ValueError(f"degree {degree} is not in 1..{world}")
    group = None if degree == world else dist.new_group(list(range(degree)))
    rank = dist.get_rank()
    return SeqShard(group, rank, degree) if rank < degree else None

