"""The dense GQA decoder: init, forward, prefill and decode on a dense or
a paged KV cache.

Port of the dense and paged paths of ``repro/models/transformer.py``.
Parameters are
a plain dict of tensors with one entry per layer in ``params["layers"]``
(the reference stacks them over a scanned axis); the layers run in a
Python loop. The dense KV cache is ``{"layers": [{"k", "v"}, ...]}`` with
(B, Hkv, max_len, E) tensors; unlike the reference's functional update,
``prefill`` fills a fresh cache and ``decode_step`` writes its row into
the cache in place, which saves a copy of the cache per step.

The paged cache is ``{"layers": [{"k", "v"}, ...]}`` with one
(Hkv, P, page, E) pool pair per layer, shared by every sequence through
its page table (one row per sequence, the same for every layer).
``prefill_chunk`` writes one prompt chunk's K/V into its pages and
``paged_decode_step`` writes each sequence's new row, both in place.

The Q/K/V/O, MLP and unembedding projections are ``torch.matmul``, as
the reference leaves them to XLA; attention goes through
``models/attention.py`` (``cfg.attn_impl``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    ArchConfig,
    apply_rope,
    dense_init,
    embed_scale,
    rms_norm,
)

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, *, seed: int = 0, device="cuda",
         dtype: torch.dtype | None = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``, in
    ``dtype`` (default ``cfg.param_dtype``); norm scales start at 0."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, e, f = cfg.d_model, cfg.hd, cfg.d_ff
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def dense(*shape, in_axis=0):
        return dense_init(gen, shape, in_axis=in_axis, dtype=dt)

    params: Params = {
        "embed": dense(cfg.vocab_size, d, in_axis=1),
        "final_norm": zeros(d),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        attn = {"norm": zeros(d), "wq": dense(d, hq * e),
                "wk": dense(d, hkv * e), "wv": dense(d, hkv * e),
                "wo": dense(hq * e, d)}
        if cfg.qk_norm:
            attn["q_norm"] = zeros(e)
            attn["k_norm"] = zeros(e)
        ffn = {"norm": zeros(d), "w_gate": dense(d, f), "w_up": dense(d, f),
               "w_down": dense(f, d)}
        params["layers"].append({"attn": attn, "ffn": ffn})
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def mlp(params, x, cfg: ArchConfig):
    dt = x.dtype
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    up = h @ params["w_up"].to(dt)
    up = up * F.silu(h @ params["w_gate"].to(dt))
    return up @ params["w_down"].to(dt)


def _split_heads(x, n_heads: int, e: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, e).transpose(1, 2)


def _merge_heads(x):
    b, h, s, e = x.shape
    return x.transpose(1, 2).reshape(b, s, h * e)


def _qkv(params, x, cfg: ArchConfig, positions):
    dt = x.dtype
    e = cfg.hd
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q = _split_heads(h @ params["wq"].to(dt), cfg.num_heads, e)
    k = _split_heads(h @ params["wk"].to(dt), cfg.num_kv_heads, e)
    v = _split_heads(h @ params["wv"].to(dt), cfg.num_kv_heads, e)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(params, x, cfg: ArchConfig, *, positions):
    """Causal self-attention over the full sequence -> (out, (k, v))."""
    q, k, v = _qkv(params, x, cfg, positions)
    o = attn_mod.attention(q, k, v, impl=cfg.attn_impl, causal=True)
    return _merge_heads(o) @ params["wo"].to(x.dtype), (k, v)


def attn_decode(params, x, cfg: ArchConfig, *, cache_k, cache_v, pos: int):
    """One-token self-attention. x: (B, 1, D); cache_[kv]: (B, Hkv, C, E)
    with rows [0, pos) filled; writes row ``pos`` in place."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    cache_k[:, :, pos] = k[:, :, 0]
    cache_v[:, :, pos] = v[:, :, 0]
    o = attn_mod.decode_attention(q[:, :, 0], cache_k, cache_v, pos + 1,
                                  impl=cfg.attn_impl)
    return o.reshape(x.shape[0], 1, -1) @ params["wo"].to(x.dtype)


def attn_paged_decode(params, x, cfg: ArchConfig, *, k_pages, v_pages,
                      page_table, positions):
    """One-token self-attention against a paged (block-table) cache.

    x: (B, 1, D); pools: (Hkv, P, page, E); page_table: (B, max_pages)
    int32; positions: (B,) int32 per-sequence absolute positions, so one
    batch decodes sequences of different ages. Writes each sequence's new
    K/V row at its position in place, then attends with
    ``kv_len = position + 1``. Idle slots (a table row of scratch page 0,
    position 0) all write row 0 of the scratch page; no live sequence
    reads it, so the order in which those writes land does not matter.
    """
    b = x.shape[0]
    page = k_pages.shape[2]
    q, k, v = _qkv(params, x, cfg, positions[:, None, None])
    pos = positions.long()
    page_ids = page_table[torch.arange(b, device=x.device), pos // page]
    slots = pos % page
    k_pages[:, page_ids.long(), slots] = k[:, :, 0].transpose(0, 1)
    v_pages[:, page_ids.long(), slots] = v[:, :, 0].transpose(0, 1)
    o = attn_mod.paged_decode_attention(q[:, :, 0], k_pages, v_pages,
                                        page_table, positions + 1,
                                        impl=cfg.attn_impl)
    return o.reshape(b, 1, -1) @ params["wo"].to(x.dtype)


def attn_paged_prefill(params, x, cfg: ArchConfig, *, k_pages, v_pages,
                       page_table, chunk_page_ids, q_offset: int,
                       kv_len: int):
    """One prompt chunk of self-attention against a paged cache.

    x: (1, chunk, D), rows at absolute positions ``q_offset + i``; pools:
    (Hkv, P, page, E); page_table: (max_pages,) for the one sequence;
    chunk_page_ids: (chunk // page,) physical pages of the chunk's span
    (entries past the allocation point at the scratch page);
    ``kv_len`` = q_offset + live rows. The chunk's K/V rows are written
    into their pages first, rows past ``kv_len`` zeroed, then the chunk's
    Q attends through the page table and sees prior context and its own
    keys alike (the write is enqueued on the same stream before the
    kernel). Returns (1, chunk, D).
    """
    chunk = x.shape[1]
    hkv, _, page, e = k_pages.shape
    positions = q_offset + torch.arange(chunk, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    live = (positions < kv_len).view(1, chunk, 1)
    ids = chunk_page_ids.long()
    for pages, rows in ((k_pages, k[0]), (v_pages, v[0])):
        rows = torch.where(live, rows, 0).reshape(hkv, chunk // page, page, e)
        pages[:, ids] = rows.to(pages.dtype)
    o = attn_mod.paged_prefill_attention(q[0], k_pages, v_pages, page_table,
                                         q_offset, kv_len, impl=cfg.attn_impl)
    return _merge_heads(o[None]) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ArchConfig):
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    return x * embed_scale(cfg.d_model, x.dtype)


def _unembed(params, x, cfg: ArchConfig):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["embed"].to(h.dtype).T          # tied embeddings


def forward(params, tokens, cfg: ArchConfig):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux 0.0)."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in params["layers"]:
        y, _ = attn_block(layer["attn"], x, cfg, positions=positions)
        x = x + y
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), 0.0


def make_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.hd)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
         "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
        for _ in range(cfg.num_layers)
    ]}


def prefill(params, cfg: ArchConfig, tokens, max_len: int):
    """Run the prompt and fill a fresh cache.

    Returns (last-position logits (B, 1, V), cache)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds the cache ({max_len})")
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    cache = make_cache(cfg, b, max_len, device=x.device)
    for layer, blk in zip(params["layers"], cache["layers"]):
        y, (k, v) = attn_block(layer["attn"], x, cfg, positions=positions)
        blk["k"][:, :, :s] = k
        blk["v"][:, :, :s] = v
        x = x + y
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x[:, -1:], cfg), cache


def decode_step(params, cfg: ArchConfig, token, cache, pos: int):
    """token: (B, 1) at absolute position ``pos`` -> (logits (B, 1, V),
    cache). The cache is updated in place and returned."""
    x = _embed(params, token, cfg)
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_decode(layer["attn"], x, cfg, cache_k=blk["k"],
                            cache_v=blk["v"], pos=pos)
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def _check_paged_support(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            "the paged cache layout supports dense rope decoder stacks only "
            f"(got {cfg.name})")


def make_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     device="cuda") -> dict:
    """Global page pools, one (Hkv, P, page, E) pair per layer. Page 0 is
    the scratch page of the cache manager; the page table is not part of
    the cache, it is an argument of every paged step."""
    _check_paged_support(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.hd)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
         "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
        for _ in range(cfg.num_layers)
    ]}


def paged_decode_step(params, cfg: ArchConfig, token, cache, page_table,
                      positions):
    """token: (B, 1) int; page_table: (B, max_pages) int32; positions:
    (B,) int32 per sequence -> (logits (B, 1, V), cache). The pools are
    updated in place and returned."""
    _check_paged_support(cfg)
    x = _embed(params, token, cfg)
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_paged_decode(layer["attn"], x, cfg, k_pages=blk["k"],
                                  v_pages=blk["v"], page_table=page_table,
                                  positions=positions)
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), cache


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, page_table,
                  chunk_page_ids, q_offset: int, chunk_len: int):
    """One chunk of chunked paged prefill.

    tokens: (1, chunk) int, rows at absolute positions ``q_offset + i``, a
    ragged last chunk padded past ``chunk_len``; page_table: (max_pages,)
    int32 for the one sequence; chunk_page_ids: (chunk // page,) physical
    pages of the chunk's span. Writes the chunk's K/V into the pools in
    place and returns ``(last_logits (1, V), cache)`` for the chunk's last
    live row: on the final chunk, the logits of the first generated token.
    """
    _check_paged_support(cfg)
    x = _embed(params, tokens, cfg)
    kv_len = q_offset + chunk_len
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_paged_prefill(
            layer["attn"], x, cfg, k_pages=blk["k"], v_pages=blk["v"],
            page_table=page_table, chunk_page_ids=chunk_page_ids,
            q_offset=q_offset, kv_len=kv_len)
        x = x + mlp(layer["ffn"], x, cfg)
    last = x[:, chunk_len - 1:chunk_len]
    return _unembed(params, last, cfg)[:, 0], cache
