"""Attention backends used inside the model, selected by ``attn_impl``.

Port of the dense and paged parts of ``repro/models/attention.py``:

* ``kernel`` — ``kernels/ops.py``: the policy-routed MAS / flash kernels
  for full sequences and the split-KV decode kernel, as CUDA kernels on
  a CUDA tensor and their plain versions on a CPU tensor (the
  reference's ``pallas``);
* ``plain`` — the exact oracle in ``kernels/ref.py`` (the reference's
  ``xla_full``).

The dense functions take q: (B, Hq, Nq, E), k/v: (B, Hkv, Nkv, E); the
paged ones take page pools (Hkv, P, page, E) and page tables, and their
``plain`` twin gathers the pool dense and runs the reference's fp32
masked softmax.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.common import NEG_INF, gather_pages

IMPLS = ("kernel", "plain")


def attention(q, k, v, *, impl: str = "kernel", causal: bool = True,
              window: int | None = None):
    if impl == "kernel":
        return kops.attention(q, k, v, causal=causal, window=window)
    if impl == "plain":
        return kref.attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attn impl {impl!r}")


def decode_attention(q, k_cache, v_cache, kv_len, *, impl: str = "kernel"):
    """q: (B, Hq, E) against dense caches (B, Hkv, S, E), masked at
    ``kv_len`` (an int, or a (B,) tensor)."""
    if impl == "kernel":
        return kops.decode_attention(q, k_cache, v_cache, kv_len)
    if impl == "plain":
        return kref.decode_attention(q, k_cache, v_cache, kv_len)
    raise ValueError(f"unknown attn impl {impl!r}")


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           impl: str = "kernel"):
    """Single-token decode over a block-table paged KV cache.

    q: (B, Hq, E); pools: (Hkv, P, page, E); page_table: (B, max_pages)
    int32; kv_lens: (B,) int32 live tokens per sequence. ``plain`` gathers
    the pool into the dense per-sequence layout and runs the reference
    twin's fp32 masked softmax op for op (``repro/models/attention.py``).
    """
    if impl == "kernel":
        return kops.paged_decode_attention(q, k_pages, v_pages, page_table,
                                           kv_lens)
    if impl != "plain":
        raise ValueError(f"unknown attn impl {impl!r}")
    b, hq, e = q.shape
    hkv = k_pages.shape[0]
    k = gather_pages(k_pages, page_table)           # (B, Hkv, S, E)
    v = gather_pages(v_pages, page_table)
    s_len = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, e)
    sc = torch.einsum("bkge,bkse->bkgs", qg.float(), k.float()) * e ** -0.5
    mask = (torch.arange(s_len, device=q.device).view(1, 1, 1, s_len)
            < kv_lens.to(q.device).view(b, 1, 1, 1))
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bkse->bkge", p, v.float())
    return (o / l).reshape(b, hq, e).to(q.dtype)


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset: int,
                            kv_len: int, *, impl: str = "kernel"):
    """One prompt chunk attending to all prior context in a paged cache.

    q: (Hq, chunk, E) for one sequence; pools: (Hkv, P, page, E);
    page_table: (max_pages,) int32; chunk row i sits at absolute position
    ``q_offset + i`` and sees keys < min(q_offset + i + 1, kv_len). The
    chunk's own K/V are already in the pages. ``plain`` gathers the pool
    dense and runs the causal oracle of ``kernels/ref.py``.
    """
    if impl == "kernel":
        return kops.paged_prefill_attention(q, k_pages, v_pages, page_table,
                                            q_offset, kv_len)
    if impl != "plain":
        raise ValueError(f"unknown attn impl {impl!r}")
    k = gather_pages(k_pages, page_table)           # (Hkv, S, E)
    v = gather_pages(v_pages, page_table)
    return kref.attention(q[None], k[None], v[None], causal=True,
                          kv_len=kv_len, q_offset=q_offset)[0]
