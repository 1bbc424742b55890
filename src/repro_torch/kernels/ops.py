"""Public wrappers around the attention kernels and the SSD scan.

Port of ``repro/kernels/ops.py`` for the dense, paged and SSM slices:
layout
flattening
(B, H, N, E) -> (B·H, N, E), GQA grouping (query row ``bh`` reads kv
head ``bh // group``), padding to the kernels' block multiples with the
padded kv columns masked through ``kv_len``, and method dispatch through
the shared-memory policy of ``core/policy.py``. Padding follows what the
port's kernels need: Q rows to a multiple of ``blk_q`` (itself a
multiple of 8) and KV rows to the 64-row tile. The decode paths pad
nothing: the kernels read only rows below ``kv_len``. The paged wrappers
group the query heads under their kv head (decode), lay a verify
block out position-major (verify) or pad a prompt chunk's rows to the Q
block (prefill); the TPU's padding of the GQA group to the 8-row sublane
tile does not carry over. int8 caches pass their fp32 scales through:
per row (B, Hkv, S) for the dense cache, per page (Hkv, P) for the pools.
``ssd_chunked`` is the mamba2 scan with its intra-chunk step on B8
(``kernels/ssd_scan.py``).

The CUDA kernels fill their outputs through ctypes, outside autograd, so
a backward through them would treat attention (and B8's step) as a
constant and say nothing. Every wrapper here therefore refuses a call
that autograd would record (grad enabled and a tensor argument that
requires grad), on the CPU as on the card, and runs no plain version in
its place: training takes ``attn_impl="chunked"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import (
    DEFAULT_BLK_Q,
    KV_TILE,
    MIN_BLK_Q,
    choose_attention_method,
    flash_blk_q,
)
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mas_attention as _mas
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import paged_prefill_attention as _ppre
from repro_torch.kernels import paged_verify_attention as _pver
from repro_torch.kernels import ssd_scan as _ssd

METHODS = ("auto", "mas_resident", "mas_streamed", "flash")


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by kernel."""
    return {**_mas.LAUNCHES, **_flash.LAUNCHES, **_decode.LAUNCHES,
            **_pdec.LAUNCHES, **_ppre.LAUNCHES, **_pver.LAUNCHES,
            **_ssd.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_mas.LAUNCHES, _flash.LAUNCHES, _decode.LAUNCHES,
                   _pdec.LAUNCHES, _ppre.LAUNCHES, _pver.LAUNCHES,
                   _ssd.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _refuse_grad(*args) -> None:
    """Raise if autograd would record a call on ``args``."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in args):
        raise RuntimeError(
            "the attention and SSD kernels have no backward: train with "
            'attn_impl="chunked", or call them under torch.no_grad()')


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[1]) % multiple
    if pad == 0:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def resolve_method(n_q: int, n_kv: int, e: int, itemsize: int, *,
                   window: int | None = None,
                   method: str = "auto") -> tuple[str, int]:
    """(kernel, blk_q) that ``attention`` runs for these sizes."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method == "auto":
        decision = choose_attention_method(n_kv=n_kv, e=e, itemsize=itemsize)
        method, bq = decision.method, decision.blk_q
    else:
        bq = DEFAULT_BLK_Q
    if window is not None and method.startswith("mas"):
        # A sliding window needs per-block skip bookkeeping the paper's
        # dataflow does not define: the flash kernel serves it.
        method = "flash"
    if method == "flash" and itemsize == 2:
        # the bf16 flash kernel runs blocks of its own height; Q rows are
        # padded to it
        return method, flash_blk_q(itemsize)
    # A short prompt needs no block taller than itself (rounded to 8).
    bq = min(bq, max(MIN_BLK_Q, -(-n_q // MIN_BLK_Q) * MIN_BLK_Q))
    return method, bq


def attention(q, k, v, *, causal: bool = False, window: int | None = None,
              sm_scale: float | None = None, q_offset: int = 0,
              method: str = "auto") -> torch.Tensor:
    """Exact attention. q: (B, Hq, Nq, E); k, v: (B, Hkv, Nkv, E). Query
    row i sits at key position ``q_offset + i`` for the causal and window
    masks (the flash route only: the MAS dataflow places rows at 0)."""
    _refuse_grad(q, k, v)
    b, hq, nq, e = q.shape
    _, hkv, nkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    method, bq = resolve_method(nq, nkv, e, q.element_size(), window=window,
                                method=method)
    qf = _pad_rows(q.reshape(b * hq, nq, e), bq)
    kf = _pad_rows(k.reshape(b * hkv, nkv, e), KV_TILE)
    vf = _pad_rows(v.reshape(b * hkv, nkv, e), KV_TILE)
    kv_len = nkv if kf.shape[1] != nkv else None
    common = dict(blk_q=bq, blk_kv=KV_TILE, causal=causal, sm_scale=sm_scale,
                  kv_len=kv_len)
    if method == "flash":
        of = _flash.flash_attention_flat(qf, kf, vf, window=window,
                                         q_offset=q_offset, **common)
    elif q_offset:
        raise ValueError(f"the {method} route takes no q_offset")
    else:
        of = _mas.mas_attention_flat(
            qf, kf, vf, kv_resident=(method == "mas_resident"), **common)
    return of[:, :nq].reshape(b, hq, nq, e)


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     sm_scale: float | None = None, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """Single-token decode against a (partially filled) dense cache.

    q: (B, Hq, E); caches: (B, Hkv, S, E), int8 with ``k_scale``/
    ``v_scale`` (B, Hkv, S) fp32 per-row scales; ``kv_len`` an int (every
    row) or a (B,) integer tensor (a ragged batch).
    """
    _refuse_grad(q, k_cache, v_cache, k_scale, v_scale)
    b, hq, e = q.shape
    _, hkv, s_len, _ = k_cache.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    group = hq // hkv
    # (B·Hkv, G, E): the query heads of one kv head share its cache rows.
    qg = q.reshape(b * hkv, group, e).contiguous()
    kf = k_cache.reshape(b * hkv, s_len, e)
    vf = v_cache.reshape(b * hkv, s_len, e)
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(device=q.device, dtype=torch.int32).reshape(b)
        lens = lens.repeat_interleave(hkv)
        max_kv_len = None
    else:
        lens = torch.full((b * hkv,), int(kv_len), dtype=torch.int32,
                          device=q.device)
        max_kv_len = int(kv_len)
    if k_scale is not None:
        k_scale = k_scale.reshape(b * hkv, s_len)
        v_scale = v_scale.reshape(b * hkv, s_len)
    of = _decode.decode_attention_flat(
        qg, kf, vf, lens, sm_scale=sm_scale, max_kv_len=max_kv_len,
        k_scale=k_scale, v_scale=v_scale)
    return of.reshape(b, hq, e)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           sm_scale: float | None = None, k_scales=None,
                           v_scales=None,
                           plan_kv_heads: int | None = None) -> torch.Tensor:
    """Single-token decode against a block-table paged KV cache.

    q: (B, Hq, E); pools: (Hkv, P, page, E), int8 with
    ``k_scales``/``v_scales`` (Hkv, P); page_table: (B, max_pages) and
    kv_lens: (B,), int32 tensors on q's device. ``plan_kv_heads``: the KV
    heads the split is planned for (default Hkv; a head-sharded call
    passes the model's).
    """
    _refuse_grad(q, k_pages, v_pages, k_scales, v_scales)
    b, hq, e = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    qg = q.reshape(b, hkv, hq // hkv, e).contiguous()
    of = _pdec.paged_decode_attention_flat(
        qg, k_pages, v_pages, page_table, kv_lens, sm_scale=sm_scale,
        k_scales=k_scales, v_scales=v_scales, plan_kv_heads=plan_kv_heads)
    return of.reshape(b, hq, e)


def paged_verify_attention(q, k_pages, v_pages, page_table, kv_lens,
                           q_starts, *, sm_scale: float | None = None,
                           k_scales=None, v_scales=None,
                           plan_kv_heads: int | None = None) -> torch.Tensor:
    """k-position speculative verify against a block-table paged cache.

    q: (B, k, Hq, E), the k candidate positions of each slot, whose K/V
    rows are already in the pages; position i of slot b sits at
    ``q_starts[b] + i``. Pools (Hkv, P, page, E), int8 with
    ``k_scales``/``v_scales`` (Hkv, P); page_table (B, max_pages),
    kv_lens and q_starts (B,), int32 on q's device. Rows at or past
    ``kv_lens[b]`` return values the host discards. ``plan_kv_heads``
    as for ``paged_decode_attention``. Returns (B, k, Hq, E).
    """
    _refuse_grad(q, k_pages, v_pages, k_scales, v_scales)
    b, spec, hq, e = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    group = hq // hkv
    # position-major (k·G, E) rows: row i = query head i % G of position
    # i // G
    qg = (q.reshape(b, spec, hkv, group, e).transpose(1, 2)
          .reshape(b, hkv, spec * group, e).contiguous())
    of = _pver.paged_verify_attention_flat(
        qg, k_pages, v_pages, page_table, kv_lens, q_starts, spec=spec,
        sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales,
        plan_kv_heads=plan_kv_heads)
    return (of.reshape(b, hkv, spec, group, e).transpose(1, 2)
            .reshape(b, spec, hq, e))


def paged_prefill_blk_q(chunk: int, dtype=torch.float32) -> int:
    """Q rows a block of B5 takes for a prompt chunk of ``chunk`` rows of
    ``dtype``: the bf16 form's own 64 (a short chunk pads to it), else up
    to ``DEFAULT_BLK_Q``."""
    if dtype == torch.bfloat16:
        return _ppre.BLK_Q_BF16
    return min(DEFAULT_BLK_Q, -(-chunk // MIN_BLK_Q) * MIN_BLK_Q)


def paged_prefill_attention(q, k_pages, v_pages, page_table, span, *,
                            sm_scale: float | None = None,
                            k_scales=None, v_scales=None) -> torch.Tensor:
    """One prompt chunk attending to all prior context in a paged cache.

    q: (Hq, chunk, E) for one sequence; pools: (Hkv, P, page, E), int8
    with ``k_scales``/``v_scales`` (Hkv, P); page_table: (max_pages,)
    int32 on q's device; span: the (q_offset, kv_len) int32 pair on q's
    device. The chunk's own K/V must already be in its pages. Pad rows
    past ``kv_len - q_offset`` return values the caller slices off.
    """
    _refuse_grad(q, k_pages, v_pages, k_scales, v_scales)
    hq, chunk, e = q.shape
    bq = paged_prefill_blk_q(chunk, q.dtype)
    qf = _pad_rows(q, bq)
    of = _ppre.paged_prefill_attention_flat(
        qf, k_pages, v_pages, page_table, span, blk_q=bq, sm_scale=sm_scale,
        k_scales=k_scales, v_scales=v_scales)
    return of[:, :chunk]


def ssd_chunked(x, a, bmat, cmat, chunk: int, initial_state=None,
                out_dtype=None):
    """The chunked SSD scan of ``models/ssm.py`` with its intra-chunk step
    on kernel B8 (``ssd_scan.ssd_chunked_kernel``; a ragged length padded
    to a whole chunk)."""
    _refuse_grad(x, a, bmat, cmat, initial_state)
    return _ssd.ssd_chunked_kernel(x, a, bmat, cmat, chunk,
                                   initial_state=initial_state,
                                   out_dtype=out_dtype)
