"""KV-head-sharded paged serving: a rank's heads and the output
all-gather (DESIGN.md §11).

Port of ``head_sharded`` and ``replicated`` of
``repro/distributed/paged.py``. The page pools are (Hkv, P, page, E), so
the KV-head axis is the shard dim: each rank holds Hkv/n heads of every
page, and page identity, block tables and ``kv_lens`` are the same on
every rank. Between the pool write and the attention output every op is
local to a (sequence, KV head), so a rank computes its heads alone;
``replicated`` then all-gathers the per-head outputs once a layer before
the replicated output projection. No partial sums cross ranks, so
nothing is reduced in another order, and the sharded tokens are the
single card's.

The reference's ``ring_paged_prefill`` is not ported: the port's chunk
step runs B5 on the rank's heads through the page table, as decode runs
B6, and moves no K/V between ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.ctx import KVShard


def head_sharded(x: torch.Tensor, shard: KVShard, dim: int = 0
                 ) -> torch.Tensor:
    """The rank's block of ``x``'s heads along ``dim`` (a view)."""
    n = x.shape[dim]
    if n % shard.degree:
        raise ValueError(f"{n} heads do not split over {shard.degree} "
                         f"ranks")
    per = n // shard.degree
    return x.narrow(dim, shard.rank * per, per)


def replicated(x: torch.Tensor, shard: KVShard, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the head dim ``dim`` in rank
    order: one all-gather over the shard's group, the identity at degree
    1. Adds the bytes received to ``shard.gathered_bytes``."""
    if shard.degree == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.degree)]
    dist.all_gather(parts, x, group=shard.group)
    shard.gathered_bytes += x.numel() * x.element_size() * (shard.degree - 1)
    return torch.cat(parts, dim)
