"""Plain oracles for the attention kernels (port of ``repro/kernels/ref.py``).

Everything is exact attention computed in fp32 with the output in the
query's dtype. Q, K, V are (B, H, N, E) with GQA allowed
(H_kv <= H_q, H_q % H_kv == 0).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, N, E) -> (B, Hkv * n_rep, N, E) by repeating each kv head."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=1)


def attention_mask(nq: int, nkv: int, *, causal: bool = False,
                   window: int | None = None, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """Boolean (nq, nkv) mask; True = attend. ``window`` implies causal."""
    rows = torch.arange(nq, device=device)[:, None] + q_offset
    cols = torch.arange(nkv, device=device)[None, :]
    mask = torch.ones((nq, nkv), dtype=torch.bool, device=device)
    if causal or window is not None:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def attention(q, k, v, *, causal: bool = False, window: int | None = None,
              sm_scale: float | None = None, kv_len=None,
              q_offset: int = 0) -> torch.Tensor:
    """Exact attention. q: (B, Hq, Nq, E); k, v: (B, Hkv, Nkv, E).

    ``kv_len`` masks cache positions >= kv_len; an int or a (B,) tensor.
    """
    b, hq, nq, e = q.shape
    _, hkv, nkv, _ = k.shape
    assert hq % hkv == 0, (hq, hkv)
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    s = torch.einsum("bhqe,bhke->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(nq, nkv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)[None, None]
    if kv_len is not None:
        kv = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1)
        mask = mask & (torch.arange(nkv, device=q.device) < kv)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhke->bhqe", p, v.float())
    return o.to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     sm_scale: float | None = None) -> torch.Tensor:
    """Single-token decode oracle. q: (B, Hq, E); caches: (B, Hkv, S, E)."""
    o = attention(q[:, :, None, :], k_cache, v_cache, causal=False,
                  sm_scale=sm_scale, kv_len=kv_len)
    return o[:, :, 0, :]


def mas_attention_tiled(q, k, v, *, blk_q: int, blk_kv: int,
                        causal: bool = False,
                        sm_scale: float | None = None) -> torch.Tensor:
    """The exact MAS dataflow (Alg. 1-4) at tile granularity: per Q row
    block a full score row is built from ``blk_kv`` tiles, softmaxed once
    (no online rescale) and multiplied into V tile by tile."""
    b, hq, nq, e = q.shape
    _, hkv, nkv, _ = k.shape
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    assert nq % blk_q == 0 and nkv % blk_kv == 0
    out = torch.zeros((b, hq, nq, e), dtype=torch.float32, device=q.device)
    for i in range(nq // blk_q):
        rows = slice(i * blk_q, (i + 1) * blk_q)
        s_tiles = []
        for j in range(nkv // blk_kv):
            cols = slice(j * blk_kv, (j + 1) * blk_kv)
            s = torch.einsum("bhqe,bhke->bhqk", q[:, :, rows].float(),
                             k[:, :, cols].float()) * scale
            if causal:
                m = attention_mask(blk_q, blk_kv, causal=True,
                                   q_offset=i * blk_q - j * blk_kv,
                                   device=q.device)
                s = torch.where(m, s, NEG_INF)
            s_tiles.append(s)
        p_row = torch.softmax(torch.cat(s_tiles, dim=-1), dim=-1)
        acc = torch.zeros((b, hq, blk_q, e), dtype=torch.float32,
                          device=q.device)
        for j in range(nkv // blk_kv):
            cols = slice(j * blk_kv, (j + 1) * blk_kv)
            acc = acc + torch.einsum("bhqk,bhke->bhqe", p_row[..., cols],
                                     v[:, :, cols].float())
        out[:, :, rows] = acc
    return out.to(q.dtype)
