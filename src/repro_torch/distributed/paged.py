"""KV-head-sharded paged serving: a rank's heads, the output all-gather
and the head-block ring of a prompt chunk (DESIGN.md §11).

Port of ``head_sharded``, ``replicated`` and ``ring_paged_prefill`` of
``repro/distributed/paged.py``. The page pools are (Hkv, P, page, E), so
the KV-head axis is the shard dim: each rank holds Hkv/n heads of every
page, and page identity, block tables and ``kv_lens`` are the same on
every rank. Between the pool write and the attention output every op is
local to a (sequence, KV head), so a rank computes its heads alone;
``replicated`` then all-gathers the per-head outputs once a layer before
the replicated output projection. No partial sums cross ranks, so
nothing is reduced in another order, and the sharded tokens are the
single card's.

A chunk step takes one of two routes (``ctx.KVShard.chunk_route``). The
``"local"`` route runs B5 on the rank's heads through the page table, as
decode runs B6, and moves no K/V between ranks. The ``"ring"`` route is
the reference's: ``ring_paged_prefill`` gathers the rank's heads' pages
of the sequence into a dense slab once, splits the chunk's Q rows over
the ranks and passes the slabs round the ring; at hop t a rank holds
head shard (rank - t) % n's slab and computes that head slot of its own
rows with a full-context softmax, so the hops fill disjoint slots and
the result is an exact concatenation, with no online combine.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.ctx import KVShard
from repro_torch.kernels import ops as kops


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
    """Every rank's ``x`` concatenated along ``dim`` (its heads, or the
    ring's rows) in rank order: one all-gather over the shard's group, the
    identity at degree 1. Adds the bytes received to
    ``shard.gathered_bytes``."""
    if shard.degree == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.degree)]
    dist.all_gather(parts, x, group=shard.group)
    shard.gathered_bytes += x.numel() * x.element_size() * (shard.degree - 1)
    return torch.cat(parts, dim)


def ring_paged_prefill(q, k_pages, v_pages, page_table, span, shard: KVShard,
                       *, k_scales=None, v_scales=None, attend=None):
    """One prompt chunk on a KV-head-sharded paged pool, by the head-block
    ring (see the module doc).

    ``models.attention.paged_prefill_attention``'s contract, with the
    pools the rank's: q (Hq, chunk, E), every head, for one sequence;
    pools (Hkv/n, P, page, E), int8 with their (Hkv/n, P) scales;
    page_table (max_pages,) int32; span the (q_offset, kv_len) int32 pair
    on q's device. Each hop runs ``attend`` (default
    ``kernels.ops.paged_prefill_attention``, kernel B5) with the same
    arguments on the held slab as a pool of max_pages pages, an identity
    table and the span moved to the rank's first row; the slab's int8
    scales travel with it. n - 1 passes, each counted in
    ``shard.ring_hops`` and ``shard.ring_bytes``; the (Hq, chunk / n, E)
    outputs are all-gathered over rows (``shard.gathered_bytes``) and the
    padding sliced off. -> (Hq, chunk, E)."""
    attend = attend or kops.paged_prefill_attention
    hq, chunk, e = q.shape
    hkv_loc, _, page, _ = k_pages.shape
    n, r = shard.degree, shard.rank
    hq_loc = hq // n
    pad = (-chunk) % n          # Q rows split over the ranks: pad, slice
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    rows = (chunk + pad) // n
    q_loc = q[:, r * rows:(r + 1) * rows]
    ids = page_table.long()
    # the rank's heads' pages of the sequence, gathered once: the ring
    # passes this slab, a pool of max_pages pages with an identity table
    slab = [k_pages[:, ids], v_pages[:, ids]]
    if k_scales is not None:
        slab += [k_scales[:, ids], v_scales[:, ids]]
    table = torch.arange(ids.shape[0], dtype=torch.int32, device=q.device)
    hop_span = span.clone()
    hop_span[0].add_(r * rows)   # on the device: no host copy
    out = torch.empty_like(q_loc)
    for t in range(n):
        src = (r - t) % n       # the head shard whose slab this rank holds
        wait = shard.ring_pass(slab) if t < n - 1 else None
        heads = slice(src * hq_loc, (src + 1) * hq_loc)
        kp, vp, *scales = slab
        out[heads] = attend(q_loc[heads], kp, vp, table, hop_span,
                            k_scales=scales[0] if scales else None,
                            v_scales=scales[1] if scales else None)
        if wait is not None:
            slab = wait()
    return replicated(out, shard, dim=1)[:, :chunk]
