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
masked softmax. int8 caches carry fp32 scales, per row (B, Hkv, S) on the
dense cache and per page (Hkv, P) on the pools; the twins apply them
where the kernels do: K scales on the score columns after q·k, V scales
folded into P after the row sum.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.common import NEG_INF, gather_pages, page_scales

IMPLS = ("kernel", "plain")


def attention(q, k, v, *, impl: str = "kernel", causal: bool = True,
              window: int | None = None):
    if impl == "kernel":
        return kops.attention(q, k, v, causal=causal, window=window)
    if impl == "plain":
        return kref.attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attn impl {impl!r}")


def _masked_softmax_pv(sc, mask, v, ks=None, vs=None):
    """The twins' fp32 tail: K scales on the scores, mask, softmax with
    the V scales folded into P after the sum, P·V. ``sc`` (..., R, S);
    ``v`` (..., S, E); ``mask``, ``ks`` and ``vs`` broadcast to ``sc``."""
    if ks is not None:
        sc = sc * ks
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    if vs is not None:
        p = p * vs
    return (p @ v.float()) / l


def decode_attention(q, k_cache, v_cache, kv_len, *, impl: str = "kernel",
                     k_scale=None, v_scale=None):
    """q: (B, Hq, E) against dense caches (B, Hkv, S, E), masked at
    ``kv_len`` (an int, or a (B,) tensor); an int8 cache comes with its
    (B, Hkv, S) per-row ``k_scale``/``v_scale``."""
    if impl == "kernel":
        return kops.decode_attention(q, k_cache, v_cache, kv_len,
                                     k_scale=k_scale, v_scale=v_scale)
    if impl != "plain":
        raise ValueError(f"unknown attn impl {impl!r}")
    if k_scale is None:
        return kref.decode_attention(q, k_cache, v_cache, kv_len)
    b, hq, e = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, e).float()
    sc = (qg @ k_cache.float().transpose(-1, -2)) * e ** -0.5
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1)
    mask = torch.arange(s_len, device=q.device) < lens
    o = _masked_softmax_pv(sc, mask, v_cache, k_scale[:, :, None],
                           v_scale[:, :, None])
    return o.reshape(b, hq, e).to(q.dtype)


def _paged_scales(k_pages, page_table, k_scales, v_scales):
    """Per-page scales as per-row factors (..., Hkv, 1, S), or Nones."""
    if k_scales is None:
        return None, None
    page = k_pages.shape[2]
    return (page_scales(k_scales, page_table, page).unsqueeze(-2),
            page_scales(v_scales, page_table, page).unsqueeze(-2))


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           impl: str = "kernel", k_scales=None,
                           v_scales=None):
    """Single-token decode over a block-table paged KV cache.

    q: (B, Hq, E); pools: (Hkv, P, page, E), int8 with (Hkv, P)
    ``k_scales``/``v_scales``; page_table: (B, max_pages) int32; kv_lens:
    (B,) int32 live tokens per sequence. ``plain`` gathers the pool into
    the dense per-sequence layout and runs the reference twin's fp32
    masked softmax op for op (``repro/models/attention.py``).
    """
    if impl == "kernel":
        return kops.paged_decode_attention(q, k_pages, v_pages, page_table,
                                           kv_lens, k_scales=k_scales,
                                           v_scales=v_scales)
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
    ks, vs = _paged_scales(k_pages, page_table, k_scales, v_scales)
    o = _masked_softmax_pv(sc, mask, v, ks, vs)
    return o.reshape(b, hq, e).to(q.dtype)


def paged_verify_attention(q, k_pages, v_pages, page_table, kv_lens,
                           q_starts, *, impl: str = "kernel", k_scales=None,
                           v_scales=None):
    """k-position speculative verify over a block-table paged KV cache.

    q: (B, k, Hq, E), the k candidate positions of each slot, whose K/V
    rows are already in the pages; position i of slot b sits at
    ``q_starts[b] + i`` and sees the keys at positions
    <= min(q_starts[b] + i, kv_lens[b] - 1). Rows at or past
    ``kv_lens[b]`` return values the host discards. ``plain`` gathers the
    pool dense and runs the reference twin's fused causal + kv-tail mask
    and fp32 softmax op for op.
    """
    if impl == "kernel":
        return kops.paged_verify_attention(q, k_pages, v_pages, page_table,
                                           kv_lens, q_starts,
                                           k_scales=k_scales,
                                           v_scales=v_scales)
    if impl != "plain":
        raise ValueError(f"unknown attn impl {impl!r}")
    b, spec, hq, e = q.shape
    hkv = k_pages.shape[0]
    g = hq // hkv
    k = gather_pages(k_pages, page_table)           # (B, Hkv, S, E)
    v = gather_pages(v_pages, page_table)
    s_len = k.shape[2]
    # (B, Hkv, k·G, E): position-major rows under their kv head
    qg = q.reshape(b, spec, hkv, g, e).transpose(1, 2).reshape(
        b, hkv, spec * g, e)
    sc = (qg.float() @ k.float().transpose(-1, -2)) * e ** -0.5
    dev = q.device
    rows = (q_starts.to(dev).long().view(b, 1, 1, 1)
            + (torch.arange(spec * g, device=dev) // g).view(1, 1, -1, 1))
    cols = torch.arange(s_len, device=dev).view(1, 1, 1, s_len)
    mask = (cols <= rows) & (cols < kv_lens.to(dev).view(b, 1, 1, 1))
    ks, vs = _paged_scales(k_pages, page_table, k_scales, v_scales)
    o = _masked_softmax_pv(sc, mask, v, ks, vs)
    return (o.reshape(b, hkv, spec, g, e).transpose(1, 2)
            .reshape(b, spec, hq, e).to(q.dtype))


def paged_prefill_attention(q, k_pages, v_pages, page_table, span, *,
                            impl: str = "kernel", k_scales=None,
                            v_scales=None):
    """One prompt chunk attending to all prior context in a paged cache.

    q: (Hq, chunk, E) for one sequence; pools: (Hkv, P, page, E), int8
    with (Hkv, P) ``k_scales``/``v_scales``; page_table: (max_pages,)
    int32; span: the (q_offset, kv_len) int32 pair on q's device. Chunk
    row i sits at absolute position ``q_offset + i`` and sees keys <
    min(q_offset + i + 1, kv_len). The chunk's own K/V are already in the
    pages. ``plain`` gathers the pool dense and runs the causal oracle of
    ``kernels/ref.py`` (for int8 pools, the reference twin's scaled fp32
    softmax), its masks built from the pair as tensors.
    """
    if impl == "kernel":
        return kops.paged_prefill_attention(q, k_pages, v_pages, page_table,
                                            span, k_scales=k_scales,
                                            v_scales=v_scales)
    if impl != "plain":
        raise ValueError(f"unknown attn impl {impl!r}")
    q_offset, kv_len = span[0], span[1]
    k = gather_pages(k_pages, page_table)           # (Hkv, S, E)
    v = gather_pages(v_pages, page_table)
    if k_scales is None:
        return kref.attention(q[None], k[None], v[None], causal=True,
                              kv_len=kv_len, q_offset=q_offset)[0]
    hq, chunk, e = q.shape
    hkv, s_len = k.shape[0], k.shape[1]
    qg = q.reshape(hkv, hq // hkv * chunk, e)
    sc = (qg.float() @ k.float().transpose(-1, -2)) * e ** -0.5
    rows = (q_offset + torch.arange(chunk, device=q.device)).repeat(
        hq // hkv).view(1, -1, 1)
    cols = torch.arange(s_len, device=q.device).view(1, 1, s_len)
    mask = (cols <= rows) & (cols < kv_len)
    ks, vs = _paged_scales(k_pages, page_table, k_scales, v_scales)
    o = _masked_softmax_pv(sc, mask, v, ks, vs)
    return o.reshape(hq, chunk, e).to(q.dtype)
