"""Analytical serving defaults for the paged continuous-batching engine.

Port of ``tune_prefill_chunk``, ``tune_pool_headroom`` and
``tune_spec_depth`` from ``repro/core/autotune.py``; nothing else of that
module is ported. The step models keep the reference's max-of-streams
form (matrix products, device-memory traffic and elementwise softmax
work overlap, the slowest sets the step) and are restated with the
published peaks of an H100 SXM instead of the TPU's.
"""

from __future__ import annotations

import functools
import math

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
