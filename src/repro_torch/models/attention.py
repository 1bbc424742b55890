"""Attention backends used inside the model, selected by ``attn_impl``.

Port of the dense and paged parts of ``repro/models/attention.py``:

* ``kernel`` — ``kernels/ops.py``: the policy-routed MAS / flash kernels
  for full sequences and the split-KV decode kernel, as CUDA kernels on
  a CUDA tensor and their plain versions on a CPU tensor (the
  reference's ``pallas``);
* ``plain`` — the exact oracle in ``kernels/ref.py`` (the reference's
  ``xla_full``);
* ``chunked`` — ``chunked_attention``, the MAS dataflow in torch ops (the
  reference's ``xla``): a full fp32 score row per chunk of Q rows, one
  exact softmax, then P·V, each chunk recomputed in the backward. It is
  the route that trains, since the kernels have no backward. The decode
  and paged functions take their ``plain`` twin under it, as the
  reference's ``xla`` takes its XLA twins.

Under ``distributed/ctx.sharding_policy`` (SPMD, one process a rank),
a prefill whose rows the policy split reaches ``attention(ring=True)``,
which runs ``distributed/ring_attention.ring_attention`` on the rank's
blocks, and ``decode_attention`` runs ``sharded_decode_attention`` over
the rank's block of the dense cache or a window's ring (``whole=True``:
a cache every rank holds whole, attended as on one card); neither reads
``impl``, as the reference computes both in XLA outside any kernel. A
windowed layer's split rows take the full-sequence route by ``impl``
with a ``q_offset`` (their halo's rows), no ring. Under
``distributed/ctx.kv_shard`` with the ``"ring"`` chunk route,
``paged_prefill_attention`` takes every query head and the rank's pools
and runs ``distributed/paged.ring_paged_prefill``, each hop on this
function's ``impl`` route (B5 on the kernel route), as the reference's
XLA twin dispatches to its ring under ``kv_shard``.

The dense functions take q: (B, Hq, Nq, E), k/v: (B, Hkv, Nkv, E); the
paged ones take page pools (Hkv, P, page, E) and page tables, and their
``plain`` twin gathers the pool dense and runs the reference's fp32
masked softmax. int8 caches carry fp32 scales, per row (B, Hkv, S) on the
dense cache and per page (Hkv, P) on the pools; the twins apply them
where the kernels do: K scales on the score columns after q·k, V scales
folded into P after the row sum.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import ctx
from repro_torch.distributed.paged import ring_paged_prefill
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.common import NEG_INF, gather_pages, page_scales

IMPLS = ("kernel", "plain", "chunked")


def _twin(impl: str) -> str:
    """The decode and paged functions' route: ``chunked`` takes the plain
    twin."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}")
    return "plain" if impl == "chunked" else impl


def tracks_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def chunked_attention(q, k, v, *, causal: bool, window: int | None = None,
                      q_offset: int = 0, chunk: int = 1024,
                      remat: bool = True):
    """Port of the reference's ``xla_chunked_attention``: the kv heads
    repeated over their query groups, Q padded to whole chunks of
    ``chunk`` rows (the padding sliced off), and per chunk the full fp32
    score row (Alg. 2), the causal / window mask at rows offset by
    ``q_offset``, one exact softmax over the row (Alg. 3) and P·V (Alg.
    4), cast back to q's dtype. With ``remat`` a chunk keeps only its
    inputs for the backward and recomputes its scores there, so the
    backward holds one chunk's (chunk, Nkv) rows at a time."""
    b, hq, nq, e = q.shape
    hkv, nkv = k.shape[1], k.shape[2]
    kf = kref._repeat_kv(k, hq // hkv).float()
    vf = kref._repeat_kv(v, hq // hkv).float()
    scale = e ** -0.5
    chunk = min(chunk, nq)
    pad = (-nq) % chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
    cols = torch.arange(nkv, device=q.device)[None, :]

    def one_chunk(qc, kf, vf, start: int):
        s = (qc.float() @ kf.transpose(-1, -2)) * scale
        if causal or window is not None:
            rows = (start + q_offset
                    + torch.arange(chunk, device=q.device)[:, None])
            m = cols <= rows
            if window is not None:
                m = m & (cols > rows - window)
            s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return (p @ vf).to(q.dtype)

    remat = remat and tracks_grad(q, kf, vf)
    outs = []
    for start in range(0, q.shape[2], chunk):
        qc = q[:, :, start:start + chunk]
        outs.append(checkpoint(one_chunk, qc, kf, vf, start,
                               use_reentrant=False) if remat
                    else one_chunk(qc, kf, vf, start))
    return torch.cat(outs, dim=2)[:, :, :nq]


def attention(q, k, v, *, impl: str = "kernel", causal: bool = True,
              window: int | None = None, q_offset: int = 0,
              chunk: int = 1024, remat: bool = True, ring: bool = False,
              on_block=None):
    """Full-sequence attention by ``impl``; query row i sits at key
    position ``q_offset + i``. With ``ring`` (the caller's rows are its
    block of a sequence split by the active policy) ``ring_attention``
    over the policy's group, ``on_block`` passed on; it takes no window."""
    if ring:
        shard = ctx.seq_shard_state()
        if shard is None or window is not None or q_offset:
            raise ValueError("ring attention needs an active sharding "
                             "policy, no window and no q_offset")
        return ring_attention(q, k, v, shard, causal=causal,
                              on_block=on_block)
    if impl == "kernel":
        return kops.attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if impl == "plain":
        return kref.attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=chunk, remat=remat)
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
                     k_scale=None, v_scale=None, whole: bool = False):
    """q: (B, Hq, E) against dense caches (B, Hkv, S, E), masked at
    ``kv_len`` (an int, or a (B,) tensor); an int8 cache comes with its
    (B, Hkv, S) per-row ``k_scale``/``v_scale``. Under the sharding policy
    the caches are the rank's block and ``kv_len`` an int:
    ``sharded_decode_attention``, unless ``whole`` (every rank holds the
    whole cache)."""
    shard = ctx.seq_shard_state()
    if shard is not None and not whole:
        return sharded_decode_attention(q, k_cache, v_cache, kv_len, shard,
                                        k_scale=k_scale, v_scale=v_scale)
    if _twin(impl) == "kernel":
        return kops.decode_attention(q, k_cache, v_cache, kv_len,
                                     k_scale=k_scale, v_scale=v_scale)
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
                           v_scales=None, plan_kv_heads: int | None = None):
    """Single-token decode over a block-table paged KV cache.

    q: (B, Hq, E); pools: (Hkv, P, page, E), int8 with (Hkv, P)
    ``k_scales``/``v_scales``; page_table: (B, max_pages) int32; kv_lens:
    (B,) int32 live tokens per sequence. ``plan_kv_heads`` reaches B6's
    split plan (a head-sharded call passes the model's KV heads). ``plain``
    gathers the pool into the dense per-sequence layout and runs the
    reference twin's fp32 masked softmax op for op
    (``repro/models/attention.py``).
    """
    if _twin(impl) == "kernel":
        return kops.paged_decode_attention(q, k_pages, v_pages, page_table,
                                           kv_lens, k_scales=k_scales,
                                           v_scales=v_scales,
                                           plan_kv_heads=plan_kv_heads)
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
                           v_scales=None, plan_kv_heads: int | None = None):
    """k-position speculative verify over a block-table paged KV cache.

    q: (B, k, Hq, E), the k candidate positions of each slot, whose K/V
    rows are already in the pages; position i of slot b sits at
    ``q_starts[b] + i`` and sees the keys at positions
    <= min(q_starts[b] + i, kv_lens[b] - 1). Rows at or past
    ``kv_lens[b]`` return values the host discards. ``plan_kv_heads`` as
    for ``paged_decode_attention`` (B7's plan). ``plain`` gathers the pool
    dense and runs the reference twin's fused causal + kv-tail mask and
    fp32 softmax op for op.
    """
    if _twin(impl) == "kernel":
        return kops.paged_verify_attention(q, k_pages, v_pages, page_table,
                                           kv_lens, q_starts,
                                           k_scales=k_scales,
                                           v_scales=v_scales,
                                           plan_kv_heads=plan_kv_heads)
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
    softmax), its masks built from the pair as tensors. Under ``kv_shard``
    with the ``"ring"`` chunk route the pools are the rank's heads and q
    has every head: ``ring_paged_prefill``, a hop on this route each.
    """
    shard = ctx.kv_shard_state()
    if shard is not None and shard.chunk_route == "ring":
        return ring_paged_prefill(
            q, k_pages, v_pages, page_table, span, shard, k_scales=k_scales,
            v_scales=v_scales,
            attend=functools.partial(_paged_prefill_one, impl=impl))
    return _paged_prefill_one(q, k_pages, v_pages, page_table, span,
                              impl=impl, k_scales=k_scales, v_scales=v_scales)


def _paged_prefill_one(q, k_pages, v_pages, page_table, span, *, impl,
                       k_scales=None, v_scales=None):
    """``paged_prefill_attention`` on one pool, by ``impl``."""
    if _twin(impl) == "kernel":
        return kops.paged_prefill_attention(q, k_pages, v_pages, page_table,
                                            span, k_scales=k_scales,
                                            v_scales=v_scales)
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


def decode_partial(q, k_cache, v_cache, kv_len: int, col0: int, *,
                   k_scale=None, v_scale=None):
    """One block's split-K decode partial: q (B, Hq, E) over caches (B,
    Hkv, S_blk, E) whose row 0 sits at position ``col0``, masked at
    ``kv_len`` -> (B, Hkv, G, E + 2) fp32, the unnormalised P·V, then the
    block's row max m and sum l. An int8 block applies its per-row
    scales where the reference does: K on the scores after the scale, V
    folded into P after the sum."""
    b, hq, e = q.shape
    hkv, s_blk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, e).float()
    sc = (qg @ k_cache.float().transpose(-1, -2)) * e ** -0.5
    if k_scale is not None:
        sc = sc * k_scale[:, :, None]
    mask = col0 + torch.arange(s_blk, device=q.device) < kv_len
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None]
    return torch.cat([p @ v_cache.float(), m, l], dim=-1)


def combine_partials(parts: list):
    """Merge decode partials (``decode_partial``), in list order ->
    (B, Hkv, G, E) fp32. A block the mask left empty weighs
    exp(NEG_INF - M) = 0."""
    m_all = parts[0][..., -2:-1]
    for p in parts[1:]:
        m_all = torch.maximum(m_all, p[..., -2:-1])
    acc = l = None
    for p in parts:
        w = torch.exp(p[..., -2:-1] - m_all)
        acc = p[..., :-2] * w if acc is None else acc + p[..., :-2] * w
        l = p[..., -1:] * w if l is None else l + p[..., -1:] * w
    return acc / l


def sharded_decode_attention(q, k_cache, v_cache, kv_len: int, shard, *,
                             k_scale=None, v_scale=None):
    """Distributed flash-decode: the split-K combine of the decode kernel,
    across ranks. q: (B, Hq, E), whole on every rank; caches (B, Hkv,
    S/n, E) and int8 scales (B, Hkv, S/n): the rank's block of a cache
    sequence-sharded over ``shard``'s n ranks. Each rank computes its
    block's partial, masked at ``kv_len``; one all-gather (kind
    ``combine``) brings every rank's, and each rank merges them in rank
    order, so every rank holds the same bits whatever the backend's
    reduction order. -> (B, Hq, E) in q's dtype."""
    part = decode_partial(q, k_cache, v_cache, kv_len,
                          shard.rank * k_cache.shape[2], k_scale=k_scale,
                          v_scale=v_scale)
    parts = shard.all_gather(part, "combine")
    return combine_partials(parts).reshape(q.shape).to(q.dtype)
