"""The decoder stacks: init, forward, prefill and decode on a dense or
a paged KV cache, or on the SSD state of a mamba2 stack.

Port of the dense, paged and SSM paths of ``repro/models/transformer.py``.
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
``prefill_chunk`` writes one prompt chunk's K/V into its pages,
``paged_decode_step`` writes each sequence's new row and
``paged_verify_step`` up to k candidate rows per sequence, all in place.

``kv_dtype=torch.int8`` stores either cache quantized (symmetric absmax,
``kernels/common.quantize_q8``) beside fp32 scales, ``"k_scale"`` and
``"v_scale"`` in each layer's dict: one per row (B, Hkv, C) on the dense
cache, where a row is written once and quantized with its own scale; one
per page (Hkv, P) on the pools, where a chunk write quantizes whole pages
and a decode or verify append requantizes each touched page over its
live rows.

An SSM stack (``cfg.family == "ssm"``) has one ``{"ssd": {...}}`` dict
per layer (``models/ssm.py``) and its cache one ``{"conv": (B, K-1,
conv channels) compute dtype, "state": (B, H, P, N) fp32}`` per layer:
``prefill`` fills a fresh cache, ``decode_step`` updates it in place, and
``kv_dtype`` leaves it as it is, as the reference's
``make_cache_block`` does. The paged functions serve dense stacks only
and raise ``NotImplementedError`` for it.

The Q/K/V/O, MLP and unembedding projections are ``torch.matmul``, as
the reference leaves them to XLA; attention goes through
``models/attention.py`` (``cfg.attn_impl``), the SSD scan through
``models/ssm.py``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm
from repro_torch.kernels.common import quantize_q8
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
    ``dtype`` (default ``cfg.param_dtype``); norm scales start at 0. An
    SSD layer takes ``ssm.init_ssd_block``."""
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
    for kind in cfg.layer_kinds:
        if kind == "ssd":
            params["layers"].append({"ssd": ssm.init_ssd_block(gen, cfg, dt)})
            continue
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


def attn_decode(params, x, cfg: ArchConfig, *, cache_k, cache_v, pos: int,
                k_scale=None, v_scale=None):
    """One-token self-attention. x: (B, 1, D); cache_[kv]: (B, Hkv, C, E)
    with rows [0, pos) filled; writes row ``pos`` in place. An int8 cache
    carries per-row (B, Hkv, C) ``k_scale``/``v_scale``: the new row is
    quantized with its own absmax scale."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    if cache_k.dtype == torch.int8:
        k, k_scale[:, :, pos] = quantize_q8(k[:, :, 0], -1)
        v, v_scale[:, :, pos] = quantize_q8(v[:, :, 0], -1)
        cache_k[:, :, pos], cache_v[:, :, pos] = k, v
    else:
        cache_k[:, :, pos] = k[:, :, 0]
        cache_v[:, :, pos] = v[:, :, 0]
    o = attn_mod.decode_attention(q[:, :, 0], cache_k, cache_v, pos + 1,
                                  impl=cfg.attn_impl, k_scale=k_scale,
                                  v_scale=v_scale)
    return o.reshape(x.shape[0], 1, -1) @ params["wo"].to(x.dtype)


def _paged_append_requant(pages, scales, page_ids, slots, row) -> None:
    """Append one quantized row per sequence, in place.

    pages: (Hkv, P, page, E) int8; scales: (Hkv, P) fp32; page_ids, slots:
    (B,); row: (Hkv, B, E). The touched page's live rows [0, slot) are
    dequantized, the new row inserted, and the page requantized under a
    fresh absmax, so a page's scale always covers exactly the rows written
    so far. Stale rows (>= slot: a reused page keeps its old bytes until
    they are overwritten) stay out of both the absmax and the rewrite.
    While the scale is unchanged the round trip gives the same int8
    values. Idle slots all land on scratch page 0, which no live sequence
    reads; no other page is written twice.
    """
    page = pages.shape[2]
    ids = page_ids.long()
    pg = pages[:, ids].float() * scales[:, ids][:, :, None, None]
    live = (torch.arange(page, device=pages.device)[None, :]
            < slots[:, None])                          # (B, page)
    pg = torch.where(live[None, :, :, None], pg, 0.0)
    pg[:, torch.arange(ids.shape[0], device=pages.device),
       slots.long()] = row.float()
    pages[:, ids], scales[:, ids] = quantize_q8(pg, (-2, -1))


def _paged_append_n(pages, scales, table, positions, rows, n_valid, *,
                    spec: int) -> None:
    """Append up to ``spec`` candidate rows per sequence in one pass, in
    place.

    pages: (Hkv, P, page, E); scales: (Hkv, P) fp32, or None for a pool of
    the compute dtype; table: (B, max_pages); positions: (B,) position of
    each sequence's first candidate; rows: (Hkv, B, k, E); n_valid: (B,)
    rows that land (fewer than k near a token budget, 0 for idle slots;
    the surplus rows are zeroed out of the write). The candidates may
    straddle a page boundary, so the touched span, at most ``t_max``
    pages, all allocated by the engine beforehand, is gathered whole, the
    candidates inserted at their offsets, and for int8 pools every touched
    page requantized under one fresh absmax over its live rows (stale
    bytes stay out of the absmax and the rewrite). Window pages past a
    sequence's last candidate, and idle slots, land on scratch page 0.
    """
    hkv, _, page, e = pages.shape
    bsz = rows.shape[1]
    dev = pages.device
    t_max = (page - 1 + spec - 1) // page + 1
    positions, n_valid = positions.long(), n_valid.long()
    p0 = positions // page
    p_last = (positions + n_valid - 1) // page      # -1 when n_valid == 0
    off0 = positions % page
    lp = p0[:, None] + torch.arange(t_max, device=dev)[None, :]  # (B, t_max)
    ids = torch.where(
        lp <= p_last[:, None],
        torch.take_along_dim(table.long(), lp.clamp(0, table.shape[1] - 1),
                             dim=1),
        0)
    win = pages[:, ids].float()                     # (Hkv, B, t_max, pg, E)
    if scales is not None:
        win = win * scales[:, ids][..., None, None]
    win = win.reshape(hkv, bsz, t_max * page, e)
    flat = torch.arange(t_max * page, device=dev)[None, :]
    win = torch.where((flat < off0[:, None])[None, :, :, None], win, 0.0)
    idx = off0[:, None] + torch.arange(spec, device=dev)[None, :]  # (B, k)
    win[:, torch.arange(bsz, device=dev)[:, None], idx] = rows.float()
    keep = flat < (off0 + n_valid)[:, None]         # drop surplus rows
    win = torch.where(keep[None, :, :, None], win, 0.0)
    win = win.reshape(hkv, bsz, t_max, page, e)
    if scales is None:
        pages[:, ids] = win.to(pages.dtype)
    else:
        pages[:, ids], scales[:, ids] = quantize_q8(win, (-2, -1))


def attn_paged_decode(params, x, cfg: ArchConfig, *, k_pages, v_pages,
                      page_table, positions, k_scales=None, v_scales=None):
    """One-token self-attention against a paged (block-table) cache.

    x: (B, 1, D); pools: (Hkv, P, page, E); page_table: (B, max_pages)
    int32; positions: (B,) int32 per-sequence absolute positions, so one
    batch decodes sequences of different ages. Writes each sequence's new
    K/V row at its position in place, then attends with
    ``kv_len = position + 1``. Idle slots (a table row of scratch page 0,
    position 0) all write row 0 of the scratch page; no live sequence
    reads it, so the order in which those writes land does not matter.
    Int8 pools carry (Hkv, P) ``k_scales``/``v_scales`` and append
    through ``_paged_append_requant``.
    """
    b = x.shape[0]
    page = k_pages.shape[2]
    q, k, v = _qkv(params, x, cfg, positions[:, None, None])
    pos = positions.long()
    page_ids = page_table[torch.arange(b, device=x.device), pos // page]
    slots = pos % page
    k_row = k[:, :, 0].transpose(0, 1)              # (Hkv, B, E)
    v_row = v[:, :, 0].transpose(0, 1)
    if k_pages.dtype == torch.int8:
        _paged_append_requant(k_pages, k_scales, page_ids, slots, k_row)
        _paged_append_requant(v_pages, v_scales, page_ids, slots, v_row)
    else:
        k_pages[:, page_ids.long(), slots] = k_row
        v_pages[:, page_ids.long(), slots] = v_row
    o = attn_mod.paged_decode_attention(q[:, :, 0], k_pages, v_pages,
                                        page_table, positions + 1,
                                        impl=cfg.attn_impl,
                                        k_scales=k_scales, v_scales=v_scales)
    return o.reshape(b, 1, -1) @ params["wo"].to(x.dtype)


def attn_paged_verify(params, x, cfg: ArchConfig, *, k_pages, v_pages,
                      page_table, positions, n_rows, k_scales=None,
                      v_scales=None):
    """k-position speculative-verify self-attention on a paged cache.

    x: (B, k, D), each slot's last emitted token and up to k - 1 drafted
    ones, rows at positions ``positions[b] + i``; n_rows: (B,) candidate
    rows that land (fewer near a token budget, 0 for idle slots). The
    valid candidates' K/V rows are written first, in one requant-safe
    pass into pages the engine allocated beforehand; then the k-row Q
    block attends through the page table with ``kv_len = positions +
    n_rows``. Rows past ``n_rows`` return values the engine drops. Rows of
    rejected candidates stay in the pool as stale bytes: later kv_lens
    stop before them and the requant masks skip them.
    """
    b, k = x.shape[0], x.shape[1]
    pos_bk = positions[:, None] + torch.arange(k, device=x.device)[None, :]
    q, kk, vv = _qkv(params, x, cfg, pos_bk[:, None, :])
    for pages, scales, rows in ((k_pages, k_scales, kk),
                                (v_pages, v_scales, vv)):
        _paged_append_n(pages, scales, page_table, positions,
                        rows.transpose(0, 1), n_rows, spec=k)
    o = attn_mod.paged_verify_attention(
        q.transpose(1, 2), k_pages, v_pages, page_table, positions + n_rows,
        positions, impl=cfg.attn_impl, k_scales=k_scales, v_scales=v_scales)
    return o.reshape(b, k, -1) @ params["wo"].to(x.dtype)


def attn_paged_prefill(params, x, cfg: ArchConfig, *, k_pages, v_pages,
                       page_table, chunk_page_ids, span, k_scales=None,
                       v_scales=None):
    """One prompt chunk of self-attention against a paged cache.

    x: (1, chunk, D), rows at absolute positions ``q_offset + i``; pools:
    (Hkv, P, page, E); page_table: (max_pages,) for the one sequence;
    chunk_page_ids: (chunk // page,) physical pages of the chunk's span
    (entries past the allocation point at the scratch page); span: the
    (q_offset, kv_len) int32 pair on x's device, ``kv_len`` = q_offset +
    live rows. The chunk's K/V rows are written
    into their pages first, rows past ``kv_len`` zeroed, then the chunk's
    Q attends through the page table and sees prior context and its own
    keys alike (the write is enqueued on the same stream before the
    kernel). Int8 pools quantize whole pages at write time, the zeroed
    rows included, and overwrite their (Hkv, P) scales with the values, so
    a reused page needs no scale reset. Returns (1, chunk, D).
    """
    chunk = x.shape[1]
    hkv, _, page, e = k_pages.shape
    positions = span[0] + torch.arange(chunk, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    live = (positions < span[1]).view(1, chunk, 1)
    ids = chunk_page_ids.long()
    for pages, scales, rows in ((k_pages, k_scales, k[0]),
                                (v_pages, v_scales, v[0])):
        rows = torch.where(live, rows, 0).reshape(hkv, chunk // page, page, e)
        if pages.dtype == torch.int8:
            pages[:, ids], scales[:, ids] = quantize_q8(rows, (-2, -1))
        else:
            pages[:, ids] = rows.to(pages.dtype)
    o = attn_mod.paged_prefill_attention(q[0], k_pages, v_pages, page_table,
                                         span, impl=cfg.attn_impl,
                                         k_scales=k_scales, v_scales=v_scales)
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
        if "ssd" in layer:
            x = x + ssm.ssd_block(layer["ssd"], x, cfg)[0]
            continue
        y, _ = attn_block(layer["attn"], x, cfg, positions=positions)
        x = x + y
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), 0.0


def kv_storage_dtype(kv_dtype) -> torch.dtype | None:
    """A cache's ``kv_dtype`` argument as a torch dtype: None (the compute
    dtype) or ``torch.int8`` (also given as ``"int8"``)."""
    if kv_dtype is None or kv_dtype == torch.int8:
        return kv_dtype
    if kv_dtype == "int8":
        return torch.int8
    raise ValueError(f"kv_dtype must be None or int8, got {kv_dtype!r}")


def _kv_layers(cfg: ArchConfig, shape, scale_shape, kv_dtype,
               device) -> dict:
    """One zeroed K/V pair per layer of ``shape``, in ``kv_dtype`` (default
    the compute dtype); int8 adds zeroed fp32 scales of ``scale_shape``."""
    dt = kv_storage_dtype(kv_dtype) or cfg.compute_dtype
    layers = []
    for _ in range(cfg.num_layers):
        blk = {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)}
        if dt == torch.int8:
            blk["k_scale"] = torch.zeros(scale_shape, device=device)
            blk["v_scale"] = torch.zeros(scale_shape, device=device)
        layers.append(blk)
    return {"layers": layers}


def make_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda", kv_dtype=None) -> dict:
    """Dense (B, Hkv, max_len, E) K/V per layer; ``kv_dtype=torch.int8``
    (or ``"int8"``) adds per-row (B, Hkv, max_len) fp32 scales. An SSM
    stack gets zeroed conv and SSD states per layer, whatever
    ``max_len`` and ``kv_dtype``."""
    if cfg.family == "ssm":
        kv_storage_dtype(kv_dtype)          # validated, then not used
        dev = resolve_device(device)
        dims = ssm.ssd_dims(cfg)
        return {"layers": [
            {"conv": torch.zeros((batch, *dims["conv"]),
                                 dtype=cfg.compute_dtype, device=dev),
             "state": torch.zeros((batch, *dims["state"]),
                                  dtype=torch.float32, device=dev)}
            for _ in range(cfg.num_layers)]}
    shape = (batch, cfg.num_kv_heads, max_len, cfg.hd)
    return _kv_layers(cfg, shape, shape[:3], kv_dtype,
                      resolve_device(device))


def prefill(params, cfg: ArchConfig, tokens, max_len: int, *,
            kv_dtype=None):
    """Run the prompt and fill a fresh cache; ``kv_dtype=torch.int8``
    quantizes each prompt row with its own scale.

    Returns (last-position logits (B, 1, V), cache)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds the cache ({max_len})")
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    cache = make_cache(cfg, b, max_len, device=x.device, kv_dtype=kv_dtype)
    for layer, blk in zip(params["layers"], cache["layers"]):
        if "ssd" in layer:
            y, (conv, state) = ssm.ssd_block(layer["ssd"], x, cfg)
            blk["conv"].copy_(conv)
            blk["state"].copy_(state)
            x = x + y
            continue
        y, (k, v) = attn_block(layer["attn"], x, cfg, positions=positions)
        if blk["k"].dtype == torch.int8:
            blk["k"][:, :, :s], blk["k_scale"][:, :, :s] = quantize_q8(k, -1)
            blk["v"][:, :, :s], blk["v_scale"][:, :, :s] = quantize_q8(v, -1)
        else:
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
        if "ssd" in layer:
            y, (conv, state) = ssm.ssd_block(
                layer["ssd"], x, cfg, conv_state=blk["conv"],
                ssm_state=blk["state"], streaming=True)
            blk["conv"].copy_(conv)
            blk["state"].copy_(state)
            x = x + y
            continue
        x = x + attn_decode(layer["attn"], x, cfg, cache_k=blk["k"],
                            cache_v=blk["v"], pos=pos,
                            k_scale=blk.get("k_scale"),
                            v_scale=blk.get("v_scale"))
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def check_paged_support(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the paged cache serves
    ``cfg`` (dense rope decoder stacks only)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            "the paged cache layout supports dense rope decoder stacks only "
            f"(got {cfg.name})")


def make_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     device="cuda", kv_dtype=None) -> dict:
    """Global page pools, one (Hkv, P, page, E) pair per layer
    (``kv_dtype=torch.int8`` adds per-page (Hkv, P) fp32 scales). Page 0 is
    the scratch page of the cache manager; the page table is not part of
    the cache, it is an argument of every paged step."""
    check_paged_support(cfg)
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.hd)
    return _kv_layers(cfg, shape, shape[:2], kv_dtype,
                      resolve_device(device))


def paged_decode_step(params, cfg: ArchConfig, token, cache, page_table,
                      positions):
    """token: (B, 1) int; page_table: (B, max_pages) int32; positions:
    (B,) int32 per sequence -> (logits (B, 1, V), cache). The pools are
    updated in place and returned."""
    check_paged_support(cfg)
    x = _embed(params, token, cfg)
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_paged_decode(layer["attn"], x, cfg, k_pages=blk["k"],
                                  v_pages=blk["v"], page_table=page_table,
                                  positions=positions,
                                  k_scales=blk.get("k_scale"),
                                  v_scales=blk.get("v_scale"))
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), cache


def paged_verify_step(params, cfg: ArchConfig, tokens, cache, page_table,
                      positions, n_rows):
    """One speculative verify step.

    tokens: (B, k) int, column 0 each slot's last emitted token, columns
    1.. its drafted candidates; page_table: (B, max_pages) int32;
    positions: (B,) int32 position of column 0 (the kv_len before the
    step); n_rows: (B,) int32 candidate rows to verify (0 for idle slots;
    columns past it are neither written nor meaningfully attended).
    Returns (logits (B, k, V), cache): ``argmax(logits[:, i - 1])`` is the
    greedy token at drafted position i, so the host accepts the longest
    matching draft prefix plus one token. k = 1 is ``paged_decode_step``.
    """
    check_paged_support(cfg)
    x = _embed(params, tokens, cfg)
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_paged_verify(layer["attn"], x, cfg, k_pages=blk["k"],
                                  v_pages=blk["v"], page_table=page_table,
                                  positions=positions, n_rows=n_rows,
                                  k_scales=blk.get("k_scale"),
                                  v_scales=blk.get("v_scale"))
        x = x + mlp(layer["ffn"], x, cfg)
    return _unembed(params, x, cfg), cache


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, page_table,
                  chunk_page_ids, chunk_span):
    """One chunk of chunked paged prefill.

    tokens: (1, chunk) int, rows at absolute positions ``q_offset + i``, a
    ragged last chunk padded past its live rows; page_table: (max_pages,)
    int32 for the one sequence; chunk_page_ids: (chunk // page,) physical
    pages of the chunk's span; chunk_span: (q_offset, kv_len, last) int32
    on the device, kv_len = q_offset + the live rows and last = the live
    rows - 1, as the engine packs them into the step's array (the host
    never reads them back; B5 takes the first two as they are). Writes the
    chunk's K/V into the pools in place and returns ``(last_logits (1, V),
    cache)`` for the chunk's last live row: on the final chunk, the logits
    of the first generated token.
    """
    check_paged_support(cfg)
    x = _embed(params, tokens, cfg)
    span = chunk_span[:2]                       # (q_offset, kv_len)
    for layer, blk in zip(params["layers"], cache["layers"]):
        x = x + attn_paged_prefill(
            layer["attn"], x, cfg, k_pages=blk["k"], v_pages=blk["v"],
            page_table=page_table, chunk_page_ids=chunk_page_ids, span=span,
            k_scales=blk.get("k_scale"), v_scales=blk.get("v_scale"))
        x = x + mlp(layer["ffn"], x, cfg)
    last = x.index_select(1, chunk_span[2:])
    return _unembed(params, last, cfg)[:, 0], cache
