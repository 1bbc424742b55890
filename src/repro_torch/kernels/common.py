"""Constants and mask helpers shared by the attention kernels.

Port of ``repro/kernels/common.py``. Every plain version (and the CUDA
kernels, which restate them in C) builds its masks from these, so the
causal/padding semantics are defined once:

* ``causal_tile_mask`` — the begin-aligned in-tile causal mask
  (``cols <= rows``) for a (blk_q, blk_kv) tile at (row0, col0);
* ``mask_kv_tail`` — score columns at absolute kv position >= ``kv_len``
  are forced to ``NEG_INF``;
* ``causal_tile_bounds`` — the three-band tile classification
  (fully visible / straddling the diagonal / fully masked);
* ``three_band_select`` — the fused causal-diagonal + kv-tail select of
  a paged score tile whose rows start at a traced query offset;
* ``gather_pages`` — the dense view of a page pool through page tables;
* ``quantize_q8`` / ``dequantize_q8`` — symmetric absmax int8 with one
  fp32 scale per group, the storage of int8 KV caches;
* ``page_scales`` — per-page scales as one factor per logical row.

``row0``, ``col0``, ``iq`` and ``kv_len`` may be Python ints or integer
tensors that broadcast against the tile, so the plain versions can
classify every Q row block of a call at once.
"""

from __future__ import annotations

import torch

# Finite stand-in for -inf: exp(NEG_INF - m) underflows to exactly 0 in
# fp32 without producing NaNs when a whole row is masked.
NEG_INF = -1e30


def causal_tile_mask(blk_q: int, blk_kv: int, row0, col0,
                     device=None) -> torch.Tensor:
    """Begin-aligned causal mask for one (blk_q, blk_kv) score tile."""
    rows = torch.arange(blk_q, device=device).view(blk_q, 1) + row0
    cols = torch.arange(blk_kv, device=device).view(1, blk_kv) + col0
    return cols <= rows


def causal_tile_bounds(iq, blk_q: int, blk_kv: int, nkv: int):
    """(n_full, n_needed) KV-tile counts for Q row block ``iq``.

    Tiles [0, n_full) lie strictly below the causal diagonal (no in-tile
    mask); tiles [n_full, n_needed) straddle it (in-tile mask); tiles
    [n_needed, nkv) are fully masked and are never computed or loaded.
    """
    row0 = iq * blk_q
    n_full = (row0 + 1) // blk_kv
    n_needed = (row0 + blk_q - 1) // blk_kv + 1
    if isinstance(iq, torch.Tensor):
        return n_full.clamp(max=nkv), n_needed.clamp(max=nkv)
    return min(n_full, nkv), min(n_needed, nkv)


def mask_kv_tail(s: torch.Tensor, col0, kv_len) -> torch.Tensor:
    """Mask score columns whose absolute kv position is >= ``kv_len``.

    ``s`` is a (..., rows, blk_kv) score tile whose first column sits at
    absolute kv position ``col0``.
    """
    blk_kv = s.shape[-1]
    cols = torch.arange(blk_kv, device=s.device) + col0
    return torch.where(cols < kv_len, s, NEG_INF)


def three_band_select(s: torch.Tensor, q0, col0, kv_len, *,
                      rows_per_pos: int = 1) -> torch.Tensor:
    """Fused straddling-band select for one paged score tile.

    ``s`` is a (..., blk_q, blk_kv) score tile whose row ``i`` sits at
    absolute query position ``q0 + i // rows_per_pos`` (grouped query
    heads share one position when ``rows_per_pos`` is the GQA group) and
    whose first column sits at absolute kv position ``col0``. Keeps
    ``cols <= rows & cols < kv_len`` and forces the rest to ``NEG_INF``.
    """
    blk_q, blk_kv = s.shape[-2:]
    rows = (torch.arange(blk_q, device=s.device).view(blk_q, 1)
            // rows_per_pos + q0)
    cols = torch.arange(blk_kv, device=s.device).view(1, blk_kv) + col0
    keep = (cols <= rows) & (cols < kv_len)
    return torch.where(keep, s, NEG_INF)


def gather_pages(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense rows of a page pool (Hkv, P, page, E) through page tables.

    ``table`` (..., max_pages) of physical page ids gives
    (..., Hkv, max_pages·page, E): logical row ``r`` of a sequence is row
    ``r % page`` of page ``table[..., r // page]``.
    """
    hkv, _, page, e = pages.shape
    g = pages[:, table.long()]                 # (Hkv, ..., max_pages, page, E)
    g = g.movedim(0, -4)                       # (..., Hkv, max_pages, page, E)
    return g.reshape(*g.shape[:-3], g.shape[-3] * page, e)


# ---------------------------------------------------------------------------
# int8 symmetric-absmax quantization
# ---------------------------------------------------------------------------

Q8_LEVELS = 127.0


def quantize_q8(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization of ``x`` over ``dims``.

    Returns ``(values int8, scales fp32)``; the scales drop the reduced
    dims (one scale per group). In the reference's order, so the int8
    values come out equal: ``x / scale`` in fp32, rounded half to even,
    clipped to [-127, 127]. An all-zero group gets scale 0 and values 0.
    """
    xf = x.float()
    scales = xf.abs().amax(dim=dims, keepdim=True) / Q8_LEVELS
    denom = torch.where(scales == 0.0, 1.0, scales)
    q = torch.clamp(torch.round(xf / denom), -Q8_LEVELS, Q8_LEVELS)
    return q.to(torch.int8), scales.squeeze(dims)


def dequantize_q8(values: torch.Tensor, scales: torch.Tensor,
                  dims) -> torch.Tensor:
    """Inverse of ``quantize_q8`` (up to the rounding error)."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    for d in sorted(d % values.dim() for d in dims):
        scales = scales.unsqueeze(d)
    return values.float() * scales


def page_scales(scales: torch.Tensor, table: torch.Tensor,
                page: int) -> torch.Tensor:
    """Per-page scales (Hkv, P) read through page tables (..., max_pages):
    one factor per logical row, (..., Hkv, max_pages·page)."""
    g = scales[:, table.long()].movedim(0, -2)   # (..., Hkv, max_pages)
    return g.repeat_interleave(page, dim=-1)


def check_prefill_tile(blk_q: int, e: int) -> None:
    """Raise unless the prefill kernels' thread layout covers a
    (blk_q, E) block: 256 threads, four score rows apart, E / 4 threads
    on each output row (``csrc/mas_attention.cu``, ``flash_attention.cu``)."""
    if (blk_q % 8 or not 8 <= blk_q <= 64 or e % 4 or e > 1024
            or 256 % (e // 4) or blk_q * e > 8192):
        raise ValueError(f"unsupported tile for the CUDA kernels: "
                         f"blk_q={blk_q}, E={e}")
