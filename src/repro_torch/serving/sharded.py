"""Multi-GPU paged serving (DESIGN.md §11), on ``torch.distributed``.

Port of ``repro/serving/sharded.py``. ``ShardedContinuousBatchingEngine``
runs the continuous-batching engine over ``shard`` ranks, one process a
rank (SPMD): NCCL when each rank has a card of its own, gloo when ranks
share a card or run on the CPU; the caller initializes the process group
and picks the backend and each rank's device. Every rank

* holds the weights whole (forward-only serving: replication costs no
  collective traffic), and a paged pool of only its own KV heads,
  [r·Hkv/n, (r+1)·Hkv/n), with their int8 scales;
* runs the whole host scheduler unchanged (admission, preemption,
  speculation, the prefix index, the auditor);
* in every attention layer of every step kind computes q, k, v whole,
  keeps its heads, appends its K/V rows to its pool, runs the kernel of
  the step on its heads (B6 decode, B7 verify, each with its int8
  branch, split as for the model's head count) and takes one all-gather
  of the attention outputs before the replicated ``wo``
  (``models/transformer.py`` under ``distributed/ctx.kv_shard``).

No partial sum crosses ranks, so a rank's tokens are the single card's.
A chunk step takes ``chunk_route``. ``"local"`` (the default) runs B5 on
the rank's heads through the table, as decode runs B6, so no K/V moves
on the wire. ``"ring"`` is the reference's route
(``distributed/paged.ring_paged_prefill``): each rank gathers its heads'
pages of the sequence into a slab, takes its 1/n of the chunk's Q rows
with every query head, and at each of n hops runs B5 on the slab it
holds for that slab's head slot while passing the slab on (n - 1
passes), then all-gathers the rows. ``shard.ring_hops`` counts the
passes, ``shard.ring_bytes`` the slab bytes they received, and
``shard.allgather_bytes`` the bytes every output all-gather received.

The ranks stay in lockstep: after each step's one device-to-host copy,
rank 0's packed result (tokens and finite flags) is broadcast and every
rank's scheduler acts on it, so no rank can take another branch and hang
a collective. A rank whose own result differs counts the entries in
``shard.result_mismatch``. Deadlines are swept against rank 0's clock
for the same reason. Calls that change the scheduler between steps
(``cancel``, the injector, the auditor) must be made alike on every rank.

``LeastLoadedRouter`` adds the data-parallel tier on top: N engine
replicas, each request routed to the replica with the least pending
estimated work.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.autotune import tune_shard_degree
from repro_torch.distributed.ctx import CHUNK_ROUTES, KVShard, kv_shard
from repro_torch.distributed.sharding import local_cache
from repro_torch.serving.engine import ContinuousBatchingEngine


def _largest_divisor_leq(n: int, cap: int) -> int:
    for s in range(min(n, cap), 0, -1):
        if n % s == 0:
            return s
    return 1


class ShardedContinuousBatchingEngine(ContinuousBatchingEngine):
    """KV-head-sharded continuous batching over ranks 0..shard-1 of the
    default process group.

    ``shard="auto"`` resolves through the closed-form
    ``core/autotune.tune_shard_degree``, then clamps to the group's size
    and the KV-head divisors; an int is validated strictly. Degree 1 needs
    no process group and is the single-card engine. Above 1 the group must
    be initialized and hold the degree; ``dist.new_group`` is called on
    every rank of it, and ranks at or past the degree take no part: their
    ``serve`` returns ``{}``. ``chunk_route`` is ``"local"`` or
    ``"ring"`` (see the module doc). All other knobs are the base
    engine's; each rank passes its own ``device``.
    """

    def __init__(self, model, params, *, shard: int | str = "auto",
                 chunk_route: str = "local", **kw):
        if chunk_route not in CHUNK_ROUTES:
            raise ValueError(f"unknown chunk route {chunk_route!r}; one of "
                             f"{CHUNK_ROUTES}")
        super().__init__(model, params, **kw)
        cfg = self.cfg
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        rank = dist.get_rank() if grouped else 0
        if shard == "auto":
            itemsize = cfg.compute_dtype.itemsize
            kv_itemsize = (self.kv_dtype or cfg.compute_dtype).itemsize
            want = tune_shard_degree(
                heads_kv=cfg.num_kv_heads,
                group=cfg.num_heads // cfg.num_kv_heads,
                n_ctx=self.max_len, e=cfg.hd, batch=self.batch_size,
                itemsize=itemsize, page=self.page_size,
                kv_itemsize=kv_itemsize)
            shard = _largest_divisor_leq(cfg.num_kv_heads, min(want, world))
        if isinstance(shard, bool) or not isinstance(shard, int) or shard < 1:
            raise ValueError(f"bad shard degree {shard!r}")
        if cfg.num_kv_heads % shard:
            raise ValueError(
                f"shard degree {shard} does not divide "
                f"num_kv_heads={cfg.num_kv_heads}")
        if shard > 1 and not grouped:
            raise RuntimeError(
                f"shard degree {shard} needs an initialized "
                f"torch.distributed process group, one rank a shard")
        if shard > world:
            raise ValueError(f"shard degree {shard} > {world} ranks in the "
                             f"process group")
        self.shard = shard
        self.rank = rank
        self.member = rank < shard
        group = dist.new_group(list(range(shard))) if shard > 1 else None
        self.chunk_route = chunk_route
        self._kv = (KVShard(group, rank, shard, chunk_route=chunk_route)
                    if self.member else None)

    def _make_cache(self) -> dict:
        """The rank's KV heads of every pool, built at their size (the
        full pools are never allocated)."""
        if self.shard == 1:
            return super()._make_cache()
        shapes = self.model.make_cache(
            self.batch_size, self.max_len, device="meta",
            cache_layout="paged", page_size=self.page_size,
            num_pages=self.num_pages, kv_dtype=self.kv_dtype)
        return local_cache(shapes, rank=self.rank, degree=self.shard,
                           layout="paged", device=self.device)

    def serve(self, requests):
        if not self.member:
            return {}
        if self.shard == 1:
            return super().serve(requests)
        kv = self._kv
        kv.gathered_bytes = kv.ring_hops = kv.ring_bytes = 0
        with kv_shard(kv):
            return super().serve(requests)

    def _host_result(self, packed: torch.Tensor) -> np.ndarray:
        """Rank 0's packed result on every rank, in the step's one
        device-to-host copy (this rank's result beside it), with the
        entries where this rank's own differs counted."""
        if self.shard == 1:
            return super()._host_result(packed)
        ref = packed.clone()
        # rank 0 of the shard's group is rank 0 of the default group
        dist.broadcast(ref, src=0, group=self._kv.group)
        both = torch.cat([packed, ref]).cpu().numpy()
        mine, ref_host = np.split(both, 2)
        differ = int((mine != ref_host).sum())
        self.metrics.counter(
            "shard.result_mismatch",
            "entries of a step's result that differ from rank 0's").inc(
            differ)
        return ref_host

    def _deadline_clock(self) -> float:
        """Rank 0's time since its ``serve`` began, on this rank's clock."""
        if self.shard == 1:
            return super()._deadline_clock()
        t = torch.tensor([time.perf_counter() - self.serve_t0],
                         dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0, group=self._kv.group)
        return self.serve_t0 + float(t.item())

    def _observe_step(self, kind, t0, t1, chunk_tokens, live):
        m = self.metrics
        m.gauge("shard.degree", "active shard degree").record(self.shard)
        gathered = hops = ring_bytes = 0
        kv = self._kv
        if kv is not None:
            gathered, hops, ring_bytes = (kv.gathered_bytes, kv.ring_hops,
                                          kv.ring_bytes)
            kv.gathered_bytes = kv.ring_hops = kv.ring_bytes = 0
        m.counter("shard.allgather_bytes",
                  "bytes this rank's output all-gathers received").inc(
            gathered)
        m.counter("shard.ring_hops",
                  "head-block ring passes of the chunk steps").inc(hops)
        m.counter("shard.ring_bytes",
                  "slab bytes this rank's ring passes received").inc(
            ring_bytes)
        m.counter("shard.result_mismatch",
                  "entries of a step's result that differ from rank 0's")
        tr = self.tracer
        if tr.enabled:
            tr.complete(kind, tr.to_us(t0), (t1 - t0) * 1e6,
                        track=f"shard{self.rank}",
                        args={"shard": self.rank, "live_decode": live,
                              "chunk_tokens": chunk_tokens})

    @property
    def shard_stats(self) -> dict:
        """Sharding summary of this rank's last serve() call."""
        c = self.metrics.counter
        return {
            "degree": self.shard,
            "allgather_bytes": int(c("shard.allgather_bytes").value),
            "ring_hops": int(c("shard.ring_hops").value),
            "ring_bytes": int(c("shard.ring_bytes").value),
            "result_mismatch": int(c("shard.result_mismatch").value),
        }


class LeastLoadedRouter:
    """Data-parallel request router over engine replicas.

    Requests are assigned (in arrival order, deterministically) to the
    replica with the least pending ESTIMATED tokens — prompt length
    plus the decode budget, the same unit the admission planner
    reserves pages in. ``serve`` then drives each replica's serve()
    over its share and merges the result dicts (rids are globally
    unique). Replica shares run one after another, as the host scheduler
    is single-threaded, so the router's gain is capacity (N pools) and
    the load-balance accounting, not overlap in time.
    """

    def __init__(self, engines):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        self.stats: dict | None = None

    def route(self, requests):
        """-> (shares, est_tokens): per-replica request lists/loads."""
        load = [0] * len(self.engines)
        shares = [[] for _ in self.engines]
        for r in requests:
            i = min(range(len(load)), key=lambda j: load[j])
            shares[i].append(r)
            load[i] += len(r.prompt) + r.max_new_tokens
        return shares, load

    def serve(self, requests):
        shares, load = self.route(requests)
        out = {}
        for eng, share in zip(self.engines, shares):
            if share:
                out.update(eng.serve(share))
        mean = sum(load) / len(load)
        self.stats = {
            "replicas": len(self.engines),
            "requests": [len(s) for s in shares],
            "est_tokens": load,
            "balance": (max(load) / mean) if mean else 1.0,
        }
        return out
