"""Analytical serving defaults and the attention kernels' block-shape search.

Port of ``tune_prefill_chunk``, ``tune_pool_headroom``,
``tune_spec_depth``, ``tune_cache_reserve``, ``tune_shard_degree`` and
``tune_attention`` (the paper's §4.2 tiling search applied to the real
kernels, with its ``_score`` and ``_causal_fraction``) from
``repro/core/autotune.py``. The step models keep the reference's
max-of-streams form (matrix products, device-memory traffic and
elementwise softmax work overlap, the slowest sets the step) and are
restated with the published peaks of an H100 SXM instead of the TPU's:
tensor cores for the MXU, CUDA cores for the VPU, HBM3 for the TPU's
HBM, NVLink 4 for the TPU mesh's links."""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.policy import (
    KV_TILE,
    MIN_BLK_Q,
    choose_attention_method,
    flash_blk_q,
)

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
TENSOR_FLOPS = 989e12      # bf16 tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
CUDA_CORE_FLOPS = 67e12    # fp32 outside the tensor cores

# Fixed cost assumed for one chunked-prefill step regardless of its size
# (kernel launches and the ramp of the first tiles, seconds): what makes
# one-page chunks a bad default although they stall decode least.
CHUNK_STEP_OVERHEAD_S = 5e-5


def _kv_row_bytes(e: int, itemsize: int, page: int,
                  kv_itemsize: int | None) -> float:
    """Bytes of one pool row; an int8 pool amortizes its fp32 per-page
    scale over the page's rows."""
    kv_item = itemsize if kv_itemsize is None else kv_itemsize
    return e * kv_item + ((4 / page) if kv_item < itemsize else 0)


def _step_s(*, b_h: int, rows: int, n_ctx: int, e: int, itemsize: int,
            kv_row_bytes: float, dequant: bool) -> float:
    """Max-of-streams time of ``rows`` query rows a head against
    ``n_ctx`` pool rows, read once, plus the fixed step overhead."""
    mma = 4.0 * b_h * rows * n_ctx * e / TENSOR_FLOPS
    hbm = (2 * b_h * n_ctx * kv_row_bytes
           + 2 * b_h * rows * e * itemsize) / HBM_BW
    elementwise = (6.0 + (2.0 if dequant else 0.0)) * b_h * rows * n_ctx \
        / CUDA_CORE_FLOPS
    return max(mma, hbm, elementwise) + CHUNK_STEP_OVERHEAD_S


@functools.lru_cache(maxsize=1024)
def tune_prefill_chunk(*, b_h: int, n_ctx: int, e: int, itemsize: int = 2,
                       page: int = 16, kv_itemsize: int | None = None,
                       step_seconds_target: float = 2e-3) -> int:
    """Engine-default prompt chunk size for chunked paged prefill.

    Every chunk re-reads all prior context from the page pool, so bigger
    chunks do less work in all, while the mixed scheduler stalls every
    live decode slot for one whole chunk step. Returns the largest
    page-aligned chunk (doubling from one page, capped at ``n_ctx``) whose
    worst-case step, the last chunk against the whole context, fits
    ``step_seconds_target``, floored at one page. At the H100's rates a
    bf16 model of the port's widths usually gets the whole context: a
    caller that wants several chunks passes ``chunk_size``.
    ``kv_itemsize=1`` prices an int8 pool.
    """
    kv_row_bytes = _kv_row_bytes(e, itemsize, page, kv_itemsize)
    best = page
    c = page
    while c < 2 * n_ctx:
        chunk = min(c, n_ctx)
        # worst-case step: the last chunk sees the whole context
        if _step_s(b_h=b_h, rows=chunk, n_ctx=n_ctx, e=e, itemsize=itemsize,
                   kv_row_bytes=kv_row_bytes,
                   dequant=False) <= step_seconds_target:
            best = chunk
        c *= 2
    return best


@functools.lru_cache(maxsize=1024)
def tune_spec_depth(*, b_h: int, n_ctx: int, e: int, itemsize: int = 2,
                    page: int = 16, kv_itemsize: int | None = None,
                    accept_rate: float = 0.7, max_depth: int = 8) -> int:
    """Engine-default speculation depth k for paged verify steps.

    A verify step reads every live page once for all k candidate
    positions, while the arithmetic grows with k and each extra position
    only pays if every draft before it was accepted. With a geometric
    acceptance model (each draft matches greedy with probability
    ``accept_rate``) a k-deep step emits E(k) = 1 + p + ... + p^(k-1)
    tokens; the step costs the max-of-streams model at the full context.
    Returns the k in [1, max_depth] that maximizes E(k) / cost(k).
    """
    p = min(max(accept_rate, 0.0), 1.0)
    kv_item = itemsize if kv_itemsize is None else kv_itemsize
    kv_row_bytes = _kv_row_bytes(e, itemsize, page, kv_itemsize)
    best_k, best_rate = 1, 0.0
    for k in range(1, max_depth + 1):
        cost = _step_s(b_h=b_h, rows=k, n_ctx=n_ctx, e=e, itemsize=itemsize,
                       kv_row_bytes=kv_row_bytes, dequant=kv_item < itemsize)
        expected = k if p >= 1.0 else (1.0 - p ** k) / (1.0 - p)
        if expected / cost > best_rate:
            best_k, best_rate = k, expected / cost
    return best_k


@functools.lru_cache(maxsize=1024)
def tune_pool_headroom(*, num_slots: int, chunk_pages: int,
                       preempt_rate: float = 0.25) -> int:
    """Free pages held back from fresh admissions when the pool runs hot
    (``decode_reserve_frac`` < 1).

    A preempted request re-admits at the queue head with its full
    remaining budget, and needs free pages to do so; ``preempt_rate`` is
    the expected fraction of slots mid-recompute at once, each running
    ``chunk_pages`` pages of re-prefill ahead of its allocation:

        headroom = ceil(preempt_rate * num_slots) * chunk_pages

    Only resumed requests may dip into this reserve.
    """
    if preempt_rate <= 0:
        return 0
    inflight = max(1, math.ceil(preempt_rate * num_slots))
    return inflight * max(1, chunk_pages)


@functools.lru_cache(maxsize=1024)
def tune_cache_reserve(*, pool_pages: int, page: int, slots: int,
                       pages_per_seq: int, prefix_tokens: int,
                       hit_rate: float) -> float:
    """Analytical default for the pool split between live decode and
    the shared-prefix cache (DESIGN.md §10) — the fraction of pages the
    prefix index may keep pinned once its publishers drain.

    Retaining the shared prefix costs live capacity: the pool serves
    ``(pool - reserve) / pages_per_seq`` concurrent sequences instead
    of ``pool / pages_per_seq``, scaling decode throughput by roughly
    the same ratio. It buys every cache-hit admission its prefix
    prefill back: at ``hit_rate`` the expected per-request saving is
    ``hit_rate * prefix_tokens / prompt_tokens`` of the prefill work.
    Admission overlaps decode (the chunked scheduler packs one chunk
    per step), so the reserve pays iff the prefill-work saving exceeds
    the capacity loss:

        hit_rate * (prefix_pages / pages_per_seq)            [saving]
            >  prefix_pages / (pool_pages)                   [capacity]

    i.e. iff ``hit_rate * pool_pages > pages_per_seq``. When it pays,
    reserve exactly the prefix's own pages (an interior point — more
    buys nothing, the index holds one copy); otherwise 0.0. The
    reference's simulator searches the same trade against the full
    workload as its seventh tiling factor; this closed form is the
    engine default when none is given.
    """
    if hit_rate <= 0 or prefix_tokens <= 0 or pool_pages <= 0:
        return 0.0
    prefix_pages = -(-prefix_tokens // page)
    if prefix_pages >= pool_pages:
        return 0.0  # the cache would starve live decode entirely
    saving = hit_rate * prefix_pages / max(1, pages_per_seq)
    capacity_cost = prefix_pages / pool_pages
    if saving <= capacity_cost:
        return 0.0
    del slots  # capacity model is page-bound, not slot-bound
    return prefix_pages / pool_pages


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    method: str
    blk_q: int
    blk_kv: int
    est_seconds: float
    mma_s: float
    hbm_s: float
    elementwise_s: float


def _causal_fraction(n_q: int, n_kv: int, blk_q: int, blk_kv: int) -> float:
    """Fraction of the dense KV-tile grid a causal prefill actually touches.

    Mirrors the kernels' tile bounds exactly: Q row block iq computes
    n_needed(iq) = min(nkv_tiles, (iq*blk_q + blk_q - 1)//blk_kv + 1)
    whole KV tiles (begin-aligned causal, see ref.attention). That is
    ~(1 + 1/n_tiles)/2 for square prefill, (n_q + blk_q)/(2 n_kv) when
    n_kv >> n_q, and ~1 - n_kv/(2 n_q) when n_q >> n_kv (late rows see
    every key but early rows still prune). Charging tile-granular work —
    not the triangle area — keeps the tuner able to rank blk_kv choices.
    """
    tr = max(1, -(-n_q // blk_q))
    nkv_tiles = max(1, -(-n_kv // blk_kv))
    live = sum(
        min(n_kv, (min(nkv_tiles, (i * blk_q + blk_q - 1) // blk_kv + 1))
            * blk_kv)
        for i in range(tr)
    )
    return min(1.0, live / (tr * n_kv))


def _score(method: str, blk_q: int, blk_kv: int, *, b_h: int, n_q: int,
           n_kv: int, e: int, itemsize: int, causal: bool = False,
           kv_itemsize: int | None = None) -> tuple[float, float, float]:
    """(mma_s, hbm_s, elementwise_s) for the whole attention call: the
    tensor cores' products, the device-memory traffic and the CUDA cores'
    softmax passes.

    ``kv_itemsize`` prices a quantized KV operand: the K/V memory terms
    shrink to the narrow width (plus fp32 per-row scale side-traffic)
    while the CUDA cores pay two extra dequant multiply passes over the
    score rows.
    """
    kv_item = itemsize if kv_itemsize is None else kv_itemsize
    frac = _causal_fraction(n_q, n_kv, blk_q, blk_kv) if causal else 1.0
    flops = 4.0 * b_h * n_q * n_kv * e * frac  # QK^T + PV, pruned tiles only
    mma = flops / TENSOR_FLOPS
    # softmax on the CUDA cores: ~6 passes over the score rows. The MAS
    # kernels normalize the FULL (blk_q, N) row buffer even when causal
    # (the pruned tail is masked, not skipped), so only flash — which
    # never visits dead tiles — gets the pruning win here.
    ew_frac = frac if method == "flash" else 1.0
    elementwise = 6.0 * b_h * n_q * n_kv * ew_frac / CUDA_CORE_FLOPS
    if kv_item < itemsize:
        # in-kernel dequant: K scales on the score tile + V fold into P
        elementwise += 2.0 * b_h * n_q * n_kv * ew_frac / CUDA_CORE_FLOPS
    # memory traffic: Q/O once; K/V per Q block unless resident
    qo = 2 * b_h * n_q * e * itemsize
    kv_row_bytes = e * kv_item + (4 if kv_item < itemsize else 0)
    if method == "mas_resident":
        kv = 2 * b_h * n_kv * kv_row_bytes  # staged once: no pruning win
    else:
        # streamed / flash: K/V re-fetched per Q row block, but a causal
        # block only fetches its intersecting tiles.
        kv = 2 * b_h * n_kv * kv_row_bytes * -(-n_q // blk_q) * frac
    hbm = (qo + kv) / HBM_BW
    return mma, hbm, elementwise


def _blk_q_grid(method: str, policy_blk_q: int, n_q: int,
                itemsize: int) -> tuple[int, ...]:
    """Q block heights the port's kernel for ``method`` compiles and the
    shared-memory policy admits: the bf16 flash kernel's own height; else
    32, 16 and 8, no taller than the policy's choice (a taller streamed
    block's score row would not fit) nor than the prompt rounded up to 8
    rows (``ops.resolve_method`` pads Q to the block)."""
    if method == "flash" and itemsize == 2:
        return (flash_blk_q(itemsize),)
    cap = min(policy_blk_q, max(MIN_BLK_Q, -(-n_q // MIN_BLK_Q) * MIN_BLK_Q))
    return tuple(bq for bq in (32, 16, 8) if bq <= cap)


# The link between cards for the shard tuner: NVLink 4 on an H100 SXM,
# 900 GB/s in total, 450 GB/s a direction (NVIDIA H100 data sheet).
LINK_GBPS = 450.0
# Latency of one hop of the output all-gather, seconds: an assumption (a
# small NCCL all-gather over NVLink costs microseconds a ring step), not
# measured until a run has two cards.
LINK_SETUP_S = 5e-6


@functools.lru_cache(maxsize=1024)
def tune_shard_degree(*, heads_kv: int, group: int, n_ctx: int, e: int,
                      batch: int = 4, itemsize: int = 2, page: int = 16,
                      kv_itemsize: int | None = None,
                      link_gbps: float = LINK_GBPS,
                      link_setup_s: float = LINK_SETUP_S,
                      max_shard: int = 8) -> int:
    """Engine-default shard degree for KV-head-sharded serving
    (``serving/sharded.py``): how many cards before the collective
    dominates.

    Each of ``s`` cards holds ``heads_kv / s`` KV heads of the paged pool,
    so a decode step's tensor-core, HBM and CUDA-core streams all shrink
    by the degree, but every step ends with an all-gather of the per-head
    attention outputs before the replicated output projection: ``s - 1``
    serial hops, each paying ``link_setup_s`` plus one card's output
    slice over ``link_gbps``. The per-step cost

        max(mma/s, hbm/s, elementwise/s) + overhead + (s-1) * hop(s)

    is minimized over the degrees in [1, max_shard] that divide
    ``heads_kv``. Long contexts and fast links buy cards; a near-zero link
    collapses to 1. The reference's closed form, at the H100's rates.
    """
    kv_item = itemsize if kv_itemsize is None else kv_itemsize
    pages_seq = -(-n_ctx // page)
    # one step's full gather: every card ends holding (batch, Hq, E)
    gather_bytes = batch * heads_kv * group * e * itemsize
    best_s, best_cost = 1, math.inf
    for s in range(1, max(1, max_shard) + 1):
        if heads_kv % s:
            continue
        h_loc = heads_kv // s
        rows = batch * h_loc * group
        mma = 4.0 * rows * n_ctx * e / TENSOR_FLOPS
        kv_b = 2 * batch * h_loc * pages_seq * page * e * kv_item
        if kv_item < itemsize:
            kv_b += 2 * batch * h_loc * pages_seq * 4  # fp32 page scales
        hbm = (kv_b + 2 * rows * e * itemsize) / HBM_BW
        elementwise = 6.0 * rows * n_ctx / CUDA_CORE_FLOPS
        if kv_item < itemsize:
            elementwise += 2.0 * rows * n_ctx / CUDA_CORE_FLOPS
        link = (s - 1) * (link_setup_s
                          + (gather_bytes / s) / (link_gbps * 1e9))
        cost = max(mma, hbm, elementwise) + CHUNK_STEP_OVERHEAD_S + link
        if cost < best_cost:
            best_s, best_cost = s, cost
    return best_s


@functools.lru_cache(maxsize=1024)
def tune_attention(*, b_h: int, n_q: int, n_kv: int, e: int,
                   itemsize: int = 2, causal: bool = False) -> KernelChoice:
    """Grid search over the block shapes the port's kernels compile
    (``KV_TILE`` = 64 key rows a tile; 32, 16 or 8 query rows a block, or
    the bf16 flash kernel's 64); the route is the shared-memory policy's
    (``choose_attention_method``), as ``ops.attention`` dispatches. The
    card overlaps the tensor-core, memory and CUDA-core streams, so cost =
    max of the three + the ramp of one K/V tile. Memoized on the full
    (shapes, dtype, causal) key.
    """
    decision = choose_attention_method(n_kv=n_kv, e=e, itemsize=itemsize)
    # pipeline ramp: one copy of a K/V tile
    ramp = (2 * KV_TILE * e * itemsize) / HBM_BW
    best: KernelChoice | None = None
    for blk_q in _blk_q_grid(decision.method, decision.blk_q, n_q, itemsize):
        mma, hbm, ew = _score(decision.method, blk_q, KV_TILE, b_h=b_h,
                              n_q=n_q, n_kv=n_kv, e=e, itemsize=itemsize,
                              causal=causal)
        cand = KernelChoice(decision.method, blk_q, KV_TILE,
                            max(mma, hbm, ew) + ramp, mma, hbm, ew)
        if best is None or cand.est_seconds < best.est_seconds:
            best = cand
    return best
