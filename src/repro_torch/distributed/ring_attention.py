"""Ring attention: exact attention with sequence-sharded Q and K/V.

Port of ``repro/distributed/ring_attention.py`` on ``torch.distributed``,
SPMD, one process a rank. Each rank owns a contiguous block of Q rows
and of K/V rows; the K/V blocks travel around the ring (rank r sends to
r + 1 and receives from r - 1) while each rank keeps the online-softmax
carry (m, l, acc) of its rows. A hop's scores are masked with the
three-band select of the kernels (``kernels/common.py``), so ``kv_len``
masks a tail-padded K/V slab and ``q_offset`` places the Q rows of a
chunk that starts mid-sequence. The wire carries the K/V bytes, n - 1
sends a rank (the reference's n-th ``ppermute`` is never read); the next
block's transfer runs while the current one is attended.

A hop is computed in chunks of Q rows, so that a rank's fp32 scores stay
near ``SCORE_BYTES``; the math is row by row, so the result does not
depend on the chunk. A chunk whose block the mask leaves empty is
skipped: before a row's first visible key its carry is wiped by the
factor exp(NEG_INF - m) = 0 when that key arrives, and after it the hop
adds exactly zero, so skipping changes nothing for a row that sees any
key at all.

Grouped-query heads stay grouped: K/V keep their Hkv heads on the wire
and the G query heads of a KV head attend its block as G·rows rows.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.ctx import SeqShard
from repro_torch.kernels.common import NEG_INF, mask_kv_tail, three_band_select

# fp32 score bytes a chunk of Q rows may hold on a rank
SCORE_BYTES = 1 << 30


def attend_hop(q, k, v, carry, *, q0: int, col0: int, causal: bool,
               kv_lim: int, masked: bool, scale: float, group: int) -> None:
    """One hop's online-softmax update of ``carry`` = (m, l, acc), in
    place. q: (B, Hkv, R·G, E), rows position-major (row i at position
    q0 + i // G); k, v: (B, Hkv, S_blk, E) fp32, column 0 at ``col0``."""
    m, l, acc = carry
    s = (q.float() @ k.transpose(-1, -2)) * scale
    if causal:
        s = three_band_select(s, q0, col0, kv_lim, rows_per_pos=group)
    elif masked:
        s = mask_kv_tail(s, col0, kv_lim)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l.mul_(alpha).add_(p.sum(dim=-1, keepdim=True))
    acc.mul_(alpha).add_(p @ v)
    m.copy_(m_new)


def ring_attention(q, k, v, shard: SeqShard, *, causal: bool = False,
                   sm_scale: float | None = None, kv_len: int | None = None,
                   q_offset: int = 0, on_block=None):
    """q: (B, Hq, S/n, E), k, v: (B, Hkv, S/n, E), this rank's blocks of a
    sequence of S rows split over ``shard``'s n ranks -> (B, Hq, S/n, E)
    in q's dtype.

    ``kv_len`` masks kv positions >= kv_len on every hop; ``q_offset``
    shifts the Q rows' absolute positions for the causal mask (rank r's
    row 0 sits at r·S/n + q_offset). ``on_block(src, k, v)`` is called
    with every K/V block this rank holds, its own first, ``src`` the rank
    that owns it (its rows start at src·S/n).
    """
    b, hq, s_loc, e = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    n, r = shard.degree, shard.rank
    scale = e ** -0.5 if sm_scale is None else sm_scale
    kv_lim = s_loc * n if kv_len is None else kv_len
    q0 = r * s_loc + q_offset
    # position-major rows under each KV head: row i·G + j is query head
    # j of the group at local position i
    qg = q.reshape(b, hkv, g, s_loc, e).transpose(2, 3)
    rows = max(1, min(s_loc, SCORE_BYTES // (b * hq * s_loc * 4)))
    m = torch.full((b, hkv, s_loc * g, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, s_loc * g, e), device=q.device)
    cur = [k, v]
    for t in range(n):
        src = (r - t) % n
        col0 = src * s_loc
        wait = shard.ring_pass(cur) if t < n - 1 else None
        if on_block is not None:
            on_block(src, *cur)
        starts = [a for a in range(0, s_loc, rows) if col0 < kv_lim and not (
            causal and col0 > q0 + min(a + rows, s_loc) - 1)]
        kf, vf = (cur[0].float(), cur[1].float()) if starts else (None, None)
        for a in starts:
            z = min(a + rows, s_loc)
            part = slice(a * g, z * g)
            attend_hop(qg[:, :, a:z].reshape(b, hkv, (z - a) * g, e), kf, vf,
                       (m[:, :, part], l[:, :, part], acc[:, :, part]),
                       q0=q0 + a, col0=col0, causal=causal, kv_lim=kv_lim,
                       masked=kv_len is not None, scale=scale, group=g)
        if wait is not None:
            cur = wait()
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).reshape(b, hkv, s_loc, g, e).transpose(2, 3)
    return out.reshape(b, hq, s_loc, e).to(q.dtype)
