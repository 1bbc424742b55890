"""KV-head sharding state of the paged serving path (DESIGN.md §11).

Port of the ``kv_shard`` part of ``repro/distributed/ctx.py``. The
sharded engine (``serving/sharded.py``) enters ``kv_shard(shard)`` around
``serve``; while it is active, the paged attention blocks of
``models/transformer.py`` keep their rank's query and KV heads, run the
kernels on them against the rank's own pools, and all-gather the
attention outputs over the shard's process group
(``distributed/paged.py``). Outside it every block is the single-card
path.

The state is one module-level value, set and restored by the context
manager and read by ``kv_shard_state()``: no thread-local state. The
reference's training policies (``sharding_policy``, ``constrain``,
``seq_sharded_*``) come with multi-GPU training.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any


@dataclasses.dataclass
class KVShard:
    """One rank's place in a KV-head-sharded group.

    ``group`` is the ``torch.distributed`` process group of the shard's
    ranks (None at degree 1, which needs none), ``rank`` this process's
    index in it and ``degree`` its size. Rank r holds KV heads
    [r·Hkv/degree, (r+1)·Hkv/degree) and the query heads that read them.
    ``gathered_bytes`` counts the bytes this rank's output all-gathers
    received from the other ranks; the engine reads and clears it a step.
    """

    group: Any
    rank: int
    degree: int
    gathered_bytes: int = 0

    def __post_init__(self):
        if self.degree < 1 or not 0 <= self.rank < self.degree:
            raise ValueError(f"rank {self.rank} is not in a shard of "
                             f"degree {self.degree}")


_STATE: KVShard | None = None


@contextlib.contextmanager
def kv_shard(shard: KVShard):
    """Activate KV-head sharding for the paged attention blocks; the
    previous state comes back on exit."""
    global _STATE
    prev, _STATE = _STATE, shard
    try:
        yield shard
    finally:
        _STATE = prev


def kv_shard_state() -> KVShard | None:
    """The active ``KVShard`` inside ``kv_shard``; None otherwise."""
    return _STATE
