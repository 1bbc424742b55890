"""The decoder stacks: init, forward, prefill and decode on a dense or
a paged KV cache, on the SSD state of a mamba2 stack, or on the ring
caches and RG-LRU states of a hybrid (recurrentgemma) stack.

Port of the dense, paged, SSM, hybrid, vision-frontend and
encoder-decoder paths of ``repro/models/transformer.py``.
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
Under ``distributed/ctx.kv_shard`` (the sharded engine) the pools hold a
rank's KV heads only, and each paged attention block computes q, k, v
whole, keeps the rank's heads, attends with them and all-gathers the
outputs before ``wo``; on the ``"ring"`` chunk route a chunk keeps every
query head and attends through the head-block ring
(``distributed/paged.ring_paged_prefill``).

Under ``distributed/ctx.sharding_policy`` (SPMD, a process a rank; the
reference's ``tp_sp``/``sp_rep`` serving policy) ``encode``,
``forward``, ``prefill`` and ``decode_step`` of every stack (dense, MoE,
ssm, hybrid, the vision frontend and the encoder-decoder) run on the
rank's part of the work: a prompt the degree n divides is split in n
blocks of rows, rank r embedding and running the norms, projections and
FFN on rows [r·S/n, (r+1)·S/n) at their true positions (a vision
prompt's S counts its F patch rows, and a rank builds only its rows of
patches then tokens); a prompt it does not divide stays whole on every
rank, on the single-card route. A full attention layer attends through
``ring_attention``; a windowed one attends its rows and the up to
W - 1 K/V rows before them, gathered once (``SeqShard.halo``), on the
full-sequence route at a ``q_offset`` (B3 on the kernel route); an SSD
or RG-LRU layer takes its conv's halo rows and composes its scan's
carry across the ranks (``models/ssm.py``, ``models/rglru.py``). The
cache is the rank's ``cache_specs`` block of every leaf
(``rank_cache``): the dense cache split in n blocks of ``max_len / n``
positions, a window's ring in n blocks of slots, the recurrent states
by conv channel, SSD head and RG-LRU width, the cross memories in n
blocks of F / n rows. ``prefill`` fills the
rank's block from every K/V block that passes it on the ring (the row
split and the cache split need not agree), a ring's slots from the
prompt's last rows, a state block from the whole prompt's state every
rank composes; ``decode_step`` takes the new token whole on every rank,
writes its K/V row on the rank whose block holds ``pos`` (a ring: slot
``pos % C``) and attends with ``sharded_decode_attention``, and a
recurrent layer updates the rank's channels and heads and all-gathers
the results. K/V rows the degree does not divide stay whole on every
rank (``fit_spec``'s rule), marked ``cache["replicated"]``: each rank
fills all its rows and decode attends to them with no combine. The last
row's logits come from the rank that holds it, by broadcast. MoE layers
dispatch in the policy's token groups (``models/moe.py``). A rank may
hold its ``tp_sp`` split of the weights (``distributed/sharding.
local_params(policy="tp_sp")``): the embedding, each layer and the
unembedding are then all-gathered whole just before their use and
dropped after (``SeqShard.gather_weights``), so the results are the
whole weights' bit for bit; whole weights pass through unchanged.

Under ``sharding_policy(shard, "fsdp")`` (training across ranks, the
reference's ``fsdp``) ``forward`` and ``encode`` run the single card's
route on the rank's own batch rows, and each rank holds dim 0 of every
matrix cut in n blocks (``local_params(policy="fsdp")``): the embedding
is gathered whole in the compute dtype before the embedding lookup (a
tied one kept for the unembedding, so its two uses' gradients sum in
one reduce-scatter, as one card sums them), an untied unembedding
before its use, each layer's blocks just before the layer, inside its
``checkpoint`` region under remat, so the backward gathers them again
and no gathered layer outlives its use (``ctx.gather_split``; the
backward reduce-scatters each gathered weight's gradient). ``prefill``
and ``decode_step`` refuse it, and so does an MoE stack (its train cells
take ``tp_sp``).

Under ``sharding_policy(shard, "tp_sp")`` every stack trains through
``tp_sp_forward`` (``Model.loss_fn`` takes it): every rank holds the
whole batch, its ``local_params(policy="tp_sp")`` split and its rows
[r·T/n, (r+1)·T/n) of the T = F + S rows (``tp_sp_rows``; a vision
input's F patch rows first). The embedding is gathered once (a tied one
serves the unembedding too), each layer's split leaves inside its
``checkpoint`` region (``ctx.gather_split``, along each leaf's own dim),
the rank's Q rows attend K/V gathered whole (``ctx.gather_rows``) on the
full-sequence route at ``q_offset`` = the rank's first row (the
reference's own trade in its chunked attention: the ring's bytes, one
reduce-scatter back), a windowed layer's the K/V halo before them
(``_seq_window``), an SSD or RG-LRU layer takes its conv's halo and its
scan's carry (``SeqShard.halo``/``carry``, differentiable where autograd
records them), an encoder-decoder's encoder runs the rank's block of
the frames and each cross block gathers its memories whole
(``_gathered_encode``), the MoE FFN dispatches its group through the
differentiable all-to-all with the rank's term of the aux loss, and only
the rank's label columns are unembedded. A sequence the degree does not
divide stays whole on every rank, each rank's loss a share of the label
columns. The serving route still refuses a backward (its ring has
none).

The encoder under the policy runs rank r's block of the F frames: each
layer all-gathers its K/V whole (``SeqShard.whole``, kind ``gather``)
and the rank's Q rows attend every frame non-causally on the
full-sequence route (B2 on the kernel route), as one card's encoder
does; ``encode`` returns the rank's block of its output. A cross block
projects that block into the rank's block of the memories, which is the
cache's block; on a prompt it gathers them whole once a layer and the
rank's rows attend them on the full-sequence route (B2), and a decode
step combines the ranks' partials over their memory blocks in rank
order (``sharded_decode_attention``). Memories the degree does not
divide stay whole on every rank, marked ``cache["mem_replicated"]``
beside the K/V's flag, and decode attends them as one card does.

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

An MoE stack (``cfg.family == "moe"``) has the dense stack's attention
and caches, and in each layer's ``"ffn"`` the routed experts of
``models/moe.py``. Its FFN runs over every row of a call, padding rows,
idle decode slots and a chunk's padded tail included, as the
reference's does: those rows take expert capacity ahead of later rows.

The Q/K/V/O, MLP, expert and unembedding projections are
``torch.matmul``, as the reference leaves them to XLA; attention goes
through ``models/attention.py`` (``cfg.attn_impl``), the SSD scan
through ``models/ssm.py``.

A hybrid stack (``cfg.family == "hybrid"``) has one dict a layer by its
kind (``cfg.layer_kinds``): ``{"rec", "ffn"}`` for an RG-LRU layer
(``models/rglru.py``) and ``{"attn", "ffn"}`` for an attention layer,
whose attention sees the last ``cfg.window`` positions (B3's windowed
form on the kernel route). Its FFN is the GELU MLP (``w_up``, ``w_down``)
when ``cfg.mlp == "gelu"``. In the cache an RG-LRU layer keeps ``{"conv":
(B, 3, W) compute dtype, "rnn": (B, W) fp32}`` and an attention layer a
ring of ``c = min(max_len, window)`` K/V rows where position p sits at
slot p % c: ``prefill`` keeps a prompt's last c rows, rolled into place,
and ``decode_step`` writes slot pos % c and attends over the
min(pos + 1, c) live rows (the order of a ring's rows does not matter
to attention; rope placed each key at its position when it was written).
The paged functions refuse the hybrid, as the reference's paged cache
does.

A stack with ``cfg.frontend == "vision"`` (internvl2) takes
``frontend_embeds`` (B, F, D) in ``forward`` and ``prefill``: they are
prepended, unscaled, to the scaled token embeddings, and positions and
the cache count those F rows (a decode step at position F + i). An
encoder-decoder (``cfg.encoder_layers`` > 0, whisper) has
``params["encoder"]``, one ``{"attn", "ffn"}`` dict a layer, and
``enc_final_norm``; ``encode`` runs the non-causal encoder over stub
frames. Each decoder attention layer adds a ``"cross"`` block (norm and
projections, no qk-norm) between its self-attention and its MLP: Q from
the block's norm, K and V the encoder output's projections, no mask.
``prefill`` writes those memories once into the cache as ``"mem_k"`` and
``"mem_v"`` (B, Hkv, F, E) at the compute dtype, an int8 cache
included, and ``decode_step`` reads them. With ``cfg.rope`` false,
sinusoidal positions are added to the embeddings (and to the frames in
``encode``) instead of rope.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import kv_shard_state, seq_shard_state
from repro_torch.distributed.paged import head_sharded, replicated
from repro_torch.distributed.sharding import local_cache, split_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe, rglru, ssm
from repro_torch.kernels.common import quantize_q8
from repro_torch.models.common import (
    ArchConfig,
    MetaGenerator,
    apply_rope,
    dense_init,
    embed_scale,
    rms_norm,
    sinusoidal_positions,
)
from repro_torch.tree import tree_leaves

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, *, seed: int = 0, device="cuda",
         dtype: torch.dtype | None = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device``, in
    ``dtype`` (default ``cfg.param_dtype``); norm scales start at 0. An
    SSD layer takes ``ssm.init_ssd_block``, an RG-LRU layer
    ``rglru.init_rglru_block`` and an MLP, an MoE layer's FFN
    ``moe.init_moe``; untied embeddings add ``unembed`` (d_model, vocab).
    An encoder-decoder adds a ``"cross"`` block to each decoder attention
    layer, the encoder's layers and ``enc_final_norm``. On the meta device
    the tree holds shapes only."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    if dev.type == "meta":
        gen = MetaGenerator()
    else:
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
    if not cfg.tie_embeddings:
        params["unembed"] = dense(d, cfg.vocab_size)
    def mlp_params():
        p = {"norm": zeros(d), "w_up": dense(d, f), "w_down": dense(f, d)}
        if cfg.mlp == "swiglu":
            p["w_gate"] = dense(d, f)
        return p

    def attn_params(cross: bool = False):
        p = {"norm": zeros(d), "wq": dense(d, hq * e),
             "wk": dense(d, hkv * e), "wv": dense(d, hkv * e),
             "wo": dense(hq * e, d)}
        if cfg.qk_norm and not cross:
            p["q_norm"] = zeros(e)
            p["k_norm"] = zeros(e)
        return p

    for kind in cfg.layer_kinds:
        if kind == "ssd":
            params["layers"].append({"ssd": ssm.init_ssd_block(gen, cfg, dt)})
            continue
        if kind == "rec":
            params["layers"].append({"rec": rglru.init_rglru_block(gen, cfg,
                                                                   dt),
                                     "ffn": mlp_params()})
            continue
        ffn = moe.init_moe(gen, cfg, dt) if cfg.moe is not None \
            else mlp_params()
        layer = {"attn": attn_params(), "ffn": ffn}
        if cfg.encoder_layers:
            layer["cross"] = attn_params(cross=True)
        params["layers"].append(layer)
    if cfg.encoder_layers:
        params["encoder"] = [{"attn": attn_params(), "ffn": mlp_params()}
                             for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = zeros(d)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def mlp(params, x, cfg: ArchConfig):
    """SwiGLU, or with ``cfg.mlp == "gelu"`` the tanh-approximated GELU of
    the up projection (the reference's ``jax.nn.gelu``)."""
    dt = x.dtype
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    up = h @ params["w_up"].to(dt)
    if cfg.mlp == "swiglu":
        up = up * F.silu(h @ params["w_gate"].to(dt))
    else:
        up = F.gelu(up, approximate="tanh")
    return up @ params["w_down"].to(dt)


def ffn(layer, x, cfg: ArchConfig, seq_len: int | None = None,
        rank_aux: bool = False):
    """The layer's FFN over every row of ``x`` -> (y, aux): the dense MLP
    (aux 0.0), or the MoE FFN on the un-normalised ``x`` (``seq_len``: the
    whole sequence's rows, of which ``x`` may hold the rank's block;
    ``rank_aux``: the rank's term of the aux loss, ``moe.moe_ffn``)."""
    if cfg.moe is not None:
        return moe.moe_ffn(layer["ffn"], x, cfg, seq_len, rank_aux=rank_aux)
    return mlp(layer["ffn"], x, cfg), 0.0


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
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _whole_kv(k, v, rows: int) -> tuple:
    """K/V (B, Hkv, R, E), the rank's block of ``rows`` rows under the
    sharding policy, made whole by one all-gather of both (kind
    ``gather``: ``ctx.gather_rows``, whose backward, where autograd
    records the call, reduce-scatters dK/dV); as they are where whole."""
    if k.shape[2] == rows:
        return k, v
    kv = ctx.gather_rows(torch.stack([k, v]), seq_shard_state(), 3)
    return kv[0], kv[1]


def attn_block(params, x, cfg: ArchConfig, *, positions,
               window: int | None = None, causal: bool = True,
               ring: bool = False, on_block=None,
               kv_rows: int | None = None, q_offset: int = 0):
    """Self-attention over the full sequence (causal unless ``causal`` is
    false), each row over its last ``window`` positions when given ->
    (out, (k, v)). With ``ring`` the rows are the rank's block of a
    sequence the sharding policy split (``attention(ring=True)``); with
    ``kv_rows`` the rank's block, from row ``q_offset``, of a sequence of
    that many rows, whose K/V are gathered whole before the rank's Q rows
    attend them on the full-sequence route (``_whole_kv``); (k, v) stay
    the rank's."""
    q, k, v = _qkv(params, x, cfg, positions)
    kk, vv = (k, v) if kv_rows is None else _whole_kv(k, v, kv_rows)
    o = attn_mod.attention(q, kk, vv, impl=cfg.attn_impl, causal=causal,
                           window=window, q_offset=q_offset,
                           chunk=cfg.attn_chunk, remat=cfg.remat, ring=ring,
                           on_block=on_block)
    return _merge_heads(o) @ params["wo"].to(x.dtype), (k, v)


def cross_memory(params, encoder_out, cfg: ArchConfig):
    """The cross block's (mem_k, mem_v), each (B, Hkv, F, E): the encoder
    output (already normed by ``enc_final_norm``) times ``wk`` and ``wv``
    in the compute dtype."""
    dt = cfg.compute_dtype
    hm = encoder_out.to(dt)
    return (_split_heads(hm @ params["wk"].to(dt), cfg.num_kv_heads, cfg.hd),
            _split_heads(hm @ params["wv"].to(dt), cfg.num_kv_heads, cfg.hd))


def _cross_q(params, x, cfg: ArchConfig):
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    return _split_heads(h @ params["wq"].to(x.dtype), cfg.num_heads, cfg.hd)


def cross_attn_block(params, x, cfg: ArchConfig, *, mem_k, mem_v,
                     mem_rows: int | None = None):
    """Decoder cross-attention: Q from the block's norm of ``x``, over
    every row of the encoder memories (no mask), through the same
    full-sequence attention as self-attention (one decode row too).
    Under the sharding policy ``mem_rows`` is the whole memory's F rows,
    of which ``mem_k``/``mem_v`` hold the rank's block: they are gathered
    whole first (``_whole_kv``)."""
    if mem_rows is not None:
        mem_k, mem_v = _whole_kv(mem_k, mem_v, mem_rows)
    o = attn_mod.attention(_cross_q(params, x, cfg), mem_k, mem_v,
                           impl=cfg.attn_impl, causal=False,
                           chunk=cfg.attn_chunk, remat=cfg.remat)
    return _merge_heads(o) @ params["wo"].to(x.dtype)


def cross_attn_decode(params, x, cfg: ArchConfig, *, mem_k, mem_v):
    """One decode row's cross-attention under the sharding policy, the
    memories (B, Hkv, F/n, E) the rank's block: each rank's partial over
    its block, combined in rank order after one all-gather (kind
    ``combine``; ``sharded_decode_attention``), so every rank holds the
    same bits."""
    shard = seq_shard_state()
    q = _cross_q(params, x, cfg)[:, :, 0]
    o = attn_mod.sharded_decode_attention(
        q, mem_k, mem_v, mem_k.shape[2] * shard.degree, shard)
    return o.reshape(x.shape[0], 1, -1) @ params["wo"].to(x.dtype)


def attn_decode(params, x, cfg: ArchConfig, *, cache_k, cache_v, pos: int,
                window: int | None = None, k_scale=None, v_scale=None,
                whole: bool = False):
    """One-token self-attention. x: (B, 1, D); cache_[kv]: (B, Hkv, C, E).
    Without ``window`` rows [0, pos) are filled and row ``pos`` is written;
    with it the cache is a ring of C slots holding position p at slot
    p % C, slot pos % C is written and the min(pos + 1, C) live slots are
    attended. The write is in place. An int8 cache carries per-row
    (B, Hkv, C) ``k_scale``/``v_scale``: the new row is quantized with its
    own absmax scale. Under the sharding policy the cache is the rank's
    block of C rows (a window's: ring slots) from r·C: the rank whose block
    holds ``pos`` (slot ``pos % (n·C)``) writes the row, and every rank
    attends its block (``sharded_decode_attention``, a slot valid below
    min(pos + 1, n·C)); with ``whole`` every rank holds the whole cache,
    writes the row and attends as on one card."""
    c = cache_k.shape[2]
    shard = None if whole else seq_shard_state()
    ring = c if shard is None else c * shard.degree     # the whole cache
    slot = pos % ring if window is not None else pos
    if shard is not None:
        slot -= shard.rank * c
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    if not 0 <= slot < c:           # another rank's block holds the row
        pass
    elif cache_k.dtype == torch.int8:
        k, k_scale[:, :, slot] = quantize_q8(k[:, :, 0], -1)
        v, v_scale[:, :, slot] = quantize_q8(v[:, :, 0], -1)
        cache_k[:, :, slot], cache_v[:, :, slot] = k, v
    else:
        cache_k[:, :, slot] = k[:, :, 0]
        cache_v[:, :, slot] = v[:, :, 0]
    kv_len = min(pos + 1, ring)
    o = attn_mod.decode_attention(q[:, :, 0], cache_k, cache_v, kv_len,
                                  impl=cfg.attn_impl,
                                  k_scale=k_scale, v_scale=v_scale,
                                  whole=whole)
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


def _rank_heads(q, k, v, k_pages):
    """Under ``kv_shard`` (the sharded engine): the rank's query and KV
    heads of q, k, v (B, H, S, E), computed whole from the replicated
    weights so that they keep the single card's bits, the shard, and the
    model's KV heads for B6's and B7's split plan; else q, k, v as they
    are and no shard."""
    shard = kv_shard_state()
    if shard is None:
        return q, k, v, None, None
    q, k, v = (head_sharded(t, shard, dim=1) for t in (q, k, v))
    return q, k, v, shard, k_pages.shape[0] * shard.degree


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
    through ``_paged_append_requant``. Under ``kv_shard`` the pools hold
    the rank's KV heads, the block attends with its heads (B6 planned for
    the model's) and all-gathers the outputs before ``wo``.
    """
    b = x.shape[0]
    page = k_pages.shape[2]
    q, k, v, shard, plan = _rank_heads(
        *_qkv(params, x, cfg, positions[:, None, None]), k_pages)
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
                                        k_scales=k_scales, v_scales=v_scales,
                                        plan_kv_heads=plan)
    if shard is not None:
        o = replicated(o, shard, dim=1)
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
    stop before them and the requant masks skip them. Under ``kv_shard``
    the rank's heads, as ``attn_paged_decode`` (B7 planned for the
    model's).
    """
    b, k = x.shape[0], x.shape[1]
    pos_bk = positions[:, None] + torch.arange(k, device=x.device)[None, :]
    q, kk, vv, shard, plan = _rank_heads(
        *_qkv(params, x, cfg, pos_bk[:, None, :]), k_pages)
    for pages, scales, rows in ((k_pages, k_scales, kk),
                                (v_pages, v_scales, vv)):
        _paged_append_n(pages, scales, page_table, positions,
                        rows.transpose(0, 1), n_rows, spec=k)
    o = attn_mod.paged_verify_attention(
        q.transpose(1, 2), k_pages, v_pages, page_table, positions + n_rows,
        positions, impl=cfg.attn_impl, k_scales=k_scales, v_scales=v_scales,
        plan_kv_heads=plan)
    if shard is not None:
        o = replicated(o, shard, dim=2)
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
    a reused page needs no scale reset. Under ``kv_shard`` the pools hold
    the rank's heads. On the ``"local"`` chunk route B5 runs the rank's
    heads through the table, one block a (query head, Q block) as on one
    card, and the outputs are all-gathered before ``wo``; no K/V moves
    between ranks. On the ``"ring"`` route q keeps every head and the
    chunk attends through the head-block ring, whose hops run B5 and
    whose rows it all-gathers. Returns (1, chunk, D).
    """
    chunk = x.shape[1]
    hkv, _, page, e = k_pages.shape
    positions = span[0] + torch.arange(chunk, device=x.device)
    q_all, k, v = _qkv(params, x, cfg, positions)
    q, k, v, shard, _ = _rank_heads(q_all, k, v, k_pages)
    ring = shard is not None and shard.chunk_route == "ring"
    if ring:
        q = q_all
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
    if shard is not None and not ring:
        o = replicated(o, shard, dim=0)
    return _merge_heads(o[None]) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ArchConfig, frontend_embeds=None,
           start: int = 0):
    """Scaled token embeddings, after ``frontend_embeds`` (unscaled) when
    given; with ``cfg.rope`` false, plus the sinusoids of the rows'
    positions, ``start`` onwards. The lookup is ``F.embedding``, whose
    CUDA backward sums a token's rows in fp32: indexing's sums them
    through the bf16 gradient one row at a time, and a token that takes a
    quarter of a batch's rows loses most of its sum."""
    x = F.embedding(tokens, params["embed"].to(cfg.compute_dtype))
    x = x * embed_scale(cfg.d_model, x.dtype)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    if not cfg.rope:
        positions = torch.arange(start, start + x.shape[1], device=x.device)
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    return x


def _need_memory(params, encoder_out) -> None:
    if "encoder" in params and encoder_out is None:
        raise ValueError("an encoder-decoder needs encoder_out (from encode)")


def encode(params, frames, cfg: ArchConfig):
    """The encoder over stub frames (B, F, D): sinusoids added when
    ``cfg.rope`` is false, then per layer non-causal self-attention and
    the MLP, then ``enc_final_norm``.

    Under the sharding policy the rank's block of the output, (B, F/n,
    D), or all F rows where the degree n does not divide F
    (``_seq_encode``); under ``fsdp`` the rank's batch rows whole, each
    layer's weights gathered on use (``_fsdp_encode``)."""
    fsdp = ctx.fsdp_state()
    if fsdp is not None:
        return _fsdp_encode(params, frames, cfg, fsdp)
    shard = seq_shard_state()
    if shard is not None:
        return _seq_encode(params, frames, cfg, shard)
    x = frames.to(cfg.compute_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    if not cfg.rope:
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    for layer in params["encoder"]:
        x = x + attn_block(layer["attn"], x, cfg, positions=positions,
                           causal=False)[0]
        x = x + mlp(layer["ffn"], x, cfg)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _unembed(params, x, cfg: ArchConfig):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"].to(h.dtype).T
    return h @ params["unembed"].to(h.dtype)


def _layer_train(layer, x, cfg: ArchConfig, positions, encoder_out,
                 split: tuple | None = None):
    """One layer of the full-sequence forward -> (x, aux). With ``split``
    = (first row, S) the rows are the rank's under ``tp_sp``, of an S-row
    sequence: where they are a block of it, an SSD or RG-LRU layer takes
    its conv's halo and its scan's carry from the other ranks
    (``ssd_block``/``rglru_block`` with the shard), a windowed attention
    layer the K/V halo before its rows (``_seq_window``), a full one
    attends K/V gathered whole (``attn_block(kv_rows=S)``); a cross block
    gathers its memories whole (``encoder_out`` the rank's block of the
    encoder's rows, or all of them); the FFN gives the rank's aux term
    (an MoE FFN's split dispatch)."""
    start, s = split or (0, None)
    shard = seq_shard_state() if split is not None and x.shape[1] < s \
        else None                                   # the rows are a block
    if "ssd" in layer:
        return x + ssm.ssd_block(layer["ssd"], x, cfg, shard=shard)[0], 0.0
    if "rec" in layer:
        x = x + rglru.rglru_block(layer["rec"], x, cfg, shard=shard)[0]
    elif shard is not None and cfg.attn_window is not None:
        x = x + _seq_window(layer["attn"], x, cfg, shard, positions, True, s)
    else:
        x = x + attn_block(layer["attn"], x, cfg, positions=positions,
                           window=cfg.attn_window, causal=cfg.causal,
                           kv_rows=s, q_offset=start)[0]
    if "cross" in layer:
        mem_k, mem_v = cross_memory(layer["cross"], encoder_out, cfg)
        x = x + cross_attn_block(
            layer["cross"], x, cfg, mem_k=mem_k, mem_v=mem_v,
            mem_rows=None if split is None else cfg.num_frontend_tokens)
    y, a = ffn(layer, x, cfg, s, rank_aux=split is not None)
    return x + y, a


def forward(params, tokens, cfg: ArchConfig, *, frontend_embeds=None,
            encoder_out=None):
    """Full-sequence forward: tokens (B, S) -> (logits (B, F + S, V),
    aux), F the rows of ``frontend_embeds`` (0 without); aux is the MoE
    layers' summed load-balance loss, fp32 (0 for other stacks). An
    encoder-decoder takes the encoder's output as ``encoder_out``.

    With ``cfg.remat``, when autograd records the call, each layer keeps
    only its input for the backward and runs again there, as the
    reference checkpoints its scanned unit body.

    Under the sharding policy each rank runs its rows of the F + S
    (``ring_attention`` when the degree divides F + S), its cross blocks
    over the memories gathered whole (``encoder_out`` whole, or the
    rank's block as ``encode`` gives it under the policy), and the final
    rows are all-gathered, so every rank returns the whole logits; aux
    is the groups' loss. It does not train (the ring has no backward):
    under ``tp_sp`` ``Model.loss_fn`` trains through ``tp_sp_forward``.
    Under ``fsdp`` the rank's batch rows on the single card's route, the
    weights gathered on use (``_fsdp_forward``)."""
    fsdp = ctx.fsdp_state()
    if fsdp is not None:
        return _fsdp_forward(params, tokens, cfg, fsdp, frontend_embeds,
                             encoder_out)
    shard = seq_shard_state()
    if shard is not None:
        return _seq_forward(params, tokens, cfg, shard, frontend_embeds,
                            encoder_out)
    _need_memory(params, encoder_out)
    x = _embed(params, tokens, cfg, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and attn_mod.tracks_grad(x)
    for layer in params["layers"]:
        if remat:
            x, a = checkpoint(_layer_train, layer, x, cfg, positions,
                              encoder_out, use_reentrant=False)
        else:
            x, a = _layer_train(layer, x, cfg, positions, encoder_out)
        aux = aux + a
    return _unembed(params, x, cfg), aux


def kv_storage_dtype(kv_dtype) -> torch.dtype | None:
    """A cache's ``kv_dtype`` argument as a torch dtype: None (the compute
    dtype) or ``torch.int8`` (also given as ``"int8"``)."""
    if kv_dtype is None or kv_dtype == torch.int8:
        return kv_dtype
    if kv_dtype == "int8":
        return torch.int8
    raise ValueError(f"kv_dtype must be None or int8, got {kv_dtype!r}")


def _kv_block(cfg: ArchConfig, shape, scale_shape, kv_dtype,
              device) -> dict:
    """A zeroed K/V pair of ``shape``, in ``kv_dtype`` (default the
    compute dtype); int8 adds zeroed fp32 scales of ``scale_shape``."""
    dt = kv_storage_dtype(kv_dtype) or cfg.compute_dtype
    blk = {"k": torch.zeros(shape, dtype=dt, device=device),
           "v": torch.zeros(shape, dtype=dt, device=device)}
    if dt == torch.int8:
        blk["k_scale"] = torch.zeros(scale_shape, device=device)
        blk["v_scale"] = torch.zeros(scale_shape, device=device)
    return blk


def _state_block(dims: dict, dtypes: dict, batch: int, device) -> dict:
    """Zeroed recurrent states: entry ``key`` of shape (batch, *dims[key])
    in ``dtypes[key]``."""
    return {key: torch.zeros((batch, *dims[key]), dtype=dtypes[key],
                             device=device) for key in dims}


def make_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda", kv_dtype=None, mem_len: int = 0) -> dict:
    """Per layer by its kind: an attention layer's (B, Hkv, C, E) K/V, C =
    max_len, or ``min(max_len, window)`` slots of a ring for a windowed
    stack; ``kv_dtype=torch.int8`` (or ``"int8"``) adds per-row (B, Hkv,
    C) fp32 scales. An encoder-decoder's attention layer adds zeroed
    cross memories ``mem_k``, ``mem_v`` (B, Hkv, mem_len, E) at the
    compute dtype, whatever ``kv_dtype``. An SSD layer gets zeroed conv
    and SSD states, an RG-LRU layer zeroed conv (compute dtype) and
    recurrent (fp32) states, whatever ``max_len`` and ``kv_dtype``."""
    kv_storage_dtype(kv_dtype)              # validated for every family
    dev = resolve_device(device)
    c = max_len if cfg.attn_window is None else min(max_len,
                                                     cfg.attn_window)
    shape = (batch, cfg.num_kv_heads, c, cfg.hd)
    f32, comp = torch.float32, cfg.compute_dtype
    layers = []
    for kind in cfg.layer_kinds:
        if kind == "ssd":
            layers.append(_state_block(ssm.ssd_dims(cfg),
                                       {"conv": comp, "state": f32}, batch,
                                       dev))
        elif kind == "rec":
            layers.append(_state_block(rglru.rglru_dims(cfg),
                                       {"conv": comp, "rnn": f32}, batch,
                                       dev))
        else:
            blk = _kv_block(cfg, shape, shape[:3], kv_dtype, dev)
            if cfg.encoder_layers:
                mem = (batch, cfg.num_kv_heads, mem_len, cfg.hd)
                blk["mem_k"] = torch.zeros(mem, dtype=comp, device=dev)
                blk["mem_v"] = torch.zeros(mem, dtype=comp, device=dev)
            layers.append(blk)
    return {"layers": layers}


def _ring_rows(k: torch.Tensor, c: int, s: int | None = None
               ) -> torch.Tensor:
    """A prompt's (B, Hkv, S, E) rows as a cache of C slots holds them:
    all S when S < C; else the last C, rolled by S % C so that position p
    sits at slot p % C. ``k`` may hold only the prompt's last rows, at
    least min(S, C) of them, with ``s`` the prompt's length S."""
    s = k.shape[2] if s is None else s
    if s < c:
        return k[:, :, k.shape[2] - s:]
    return torch.roll(k[:, :, -c:], s % c, dims=2)


def prefill(params, cfg: ArchConfig, tokens, max_len: int, *,
            frontend_embeds=None, encoder_out=None, kv_dtype=None):
    """Run the prompt and fill a fresh cache; ``kv_dtype=torch.int8``
    quantizes each prompt row with its own scale. A windowed attention
    layer keeps the prompt's last ``min(max_len, window)`` rows in ring
    order (``_ring_rows``); an RG-LRU or SSD layer its final states.
    ``frontend_embeds`` (B, F, D) come before the tokens and count
    against ``max_len``; an encoder-decoder's ``encoder_out`` is
    projected once a layer into the cache's cross memories.

    Under the sharding policy the rank's rows of the F + S and its block
    of the cache, the cross memories' included (``_seq_prefill``).

    Returns (last-position logits (B, 1, V), cache)."""
    shard = seq_shard_state()
    if shard is not None:
        return _seq_prefill(params, cfg, tokens, max_len, shard, kv_dtype,
                            frontend_embeds, encoder_out)
    _need_memory(params, encoder_out)
    b, s = tokens.shape
    if frontend_embeds is not None:
        s += frontend_embeds.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} rows exceeds the cache ({max_len})")
    x = _embed(params, tokens, cfg, frontend_embeds)
    positions = torch.arange(s, device=x.device)
    mem_len = 0 if encoder_out is None else encoder_out.shape[1]
    cache = make_cache(cfg, b, max_len, device=x.device, kv_dtype=kv_dtype,
                       mem_len=mem_len)
    for layer, blk in zip(params["layers"], cache["layers"]):
        if "ssd" in layer:
            y, (conv, state) = ssm.ssd_block(layer["ssd"], x, cfg)
            blk["conv"].copy_(conv)
            blk["state"].copy_(state)
            x = x + y
            continue
        if "rec" in layer:
            y, (conv, rnn) = rglru.rglru_block(layer["rec"], x, cfg)
            blk["conv"].copy_(conv)
            blk["rnn"].copy_(rnn)
        else:
            y, (k, v) = attn_block(layer["attn"], x, cfg,
                                   positions=positions,
                                   window=cfg.attn_window, causal=cfg.causal)
            c = blk["k"].shape[2]
            k, v = _ring_rows(k, c), _ring_rows(v, c)
            n = k.shape[2]
            if blk["k"].dtype == torch.int8:
                blk["k"][:, :, :n], blk["k_scale"][:, :, :n] = quantize_q8(
                    k, -1)
                blk["v"][:, :, :n], blk["v_scale"][:, :, :n] = quantize_q8(
                    v, -1)
            else:
                blk["k"][:, :, :n] = k
                blk["v"][:, :, :n] = v
        x = x + y
        if "cross" in layer:
            mem_k, mem_v = cross_memory(layer["cross"], encoder_out, cfg)
            blk["mem_k"].copy_(mem_k)
            blk["mem_v"].copy_(mem_v)
            x = x + cross_attn_block(layer["cross"], x, cfg, mem_k=mem_k,
                                     mem_v=mem_v)
        x = x + ffn(layer, x, cfg)[0]
    return _unembed(params, x[:, -1:], cfg), cache


def decode_step(params, cfg: ArchConfig, token, cache, pos: int):
    """token: (B, 1) at absolute position ``pos`` -> (logits (B, 1, V),
    cache). The cache is updated in place and returned; an
    encoder-decoder's cross blocks read the memories ``prefill`` wrote.
    Under the sharding policy the cache is the rank's block (``prefill``
    under the policy, or ``distributed/sharding.local_cache``; its cross
    memories the rank's block of F / n rows) and every rank returns the
    same logits (``_seq_decode``). ``pos`` counts a vision prompt's patch
    rows, as on one card."""
    shard = seq_shard_state()
    if shard is not None:
        return _seq_decode(params, cfg, token, cache, pos, shard)
    x = _embed(params, token, cfg, start=pos)
    for layer, blk in zip(params["layers"], cache["layers"]):
        if "ssd" in layer:
            y, (conv, state) = ssm.ssd_block(
                layer["ssd"], x, cfg, conv_state=blk["conv"],
                ssm_state=blk["state"], streaming=True)
            blk["conv"].copy_(conv)
            blk["state"].copy_(state)
            x = x + y
            continue
        if "rec" in layer:
            y, (conv, rnn) = rglru.rglru_block(
                layer["rec"], x, cfg, conv_state=blk["conv"],
                rnn_state=blk["rnn"], streaming=True)
            blk["conv"].copy_(conv)
            blk["rnn"].copy_(rnn)
            x = x + y
        else:
            x = x + attn_decode(layer["attn"], x, cfg, cache_k=blk["k"],
                                cache_v=blk["v"], pos=pos,
                                window=cfg.attn_window,
                                k_scale=blk.get("k_scale"),
                                v_scale=blk.get("v_scale"))
            if "cross" in layer:
                x = x + cross_attn_block(layer["cross"], x, cfg,
                                         mem_k=blk["mem_k"],
                                         mem_v=blk["mem_v"])
        x = x + ffn(layer, x, cfg)[0]
    return _unembed(params, x, cfg), cache


# ---------------------------------------------------------------------------
# the sequence-sharding policy
# ---------------------------------------------------------------------------


def check_seq_support(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the sequence-sharding policy
    serves ``cfg``: every stack (dense, MoE, ssm, hybrid, the vision
    frontend's patch rows in the row split, the encoder-decoder's split
    encoder and cross memories) under ``tp_sp`` or ``sp_rep``; not
    ``fsdp``, which splits the batch for training (``forward`` and
    ``encode`` only)."""
    if ctx.policy_kind() == "fsdp":
        raise NotImplementedError(
            f"the fsdp policy splits the batch for training across devices; "
            f"{cfg.name} serves under tp_sp or sp_rep, ROADMAP A10")


# ---------------------------------------------------------------------------
# training under fsdp
# ---------------------------------------------------------------------------


def _fsdp_specs(cfg: ArchConfig, shard) -> dict:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"fsdp training of the MoE stack {cfg.name}: its train cells "
            f"take tp_sp (experts over the group), ROADMAP A10 item 3b")
    return split_specs(cfg, shard.degree, "fsdp")


def _gathered_layer(layer, spec, shard, x, cfg: ArchConfig, positions,
                    encoder_out, split=None):
    """``_layer_train`` on the layer's split blocks gathered whole."""
    return _layer_train(ctx.gather_split(layer, spec, shard,
                                         cfg.compute_dtype),
                        x, cfg, positions, encoder_out, split)


def _gathered_forward(params, tokens, cfg: ArchConfig, shard, specs, *,
                      frontend_embeds=None, encoder_out=None,
                      rows: slice | None = None, keep: slice | None = None):
    """The train forward on split weights (``specs``: the policy's
    ``split_specs``) -> (logits, aux): the embedding gathered once and,
    tied, serving the unembedding too; each layer's blocks gathered
    inside its ``checkpoint`` region under remat, so the backward gathers
    them again. With ``rows`` only those rows of the F + S (``tp_sp``: a
    vision input's F patch rows, then the tokens), at their positions,
    and of them only the ``keep`` rows are unembedded."""
    dt = cfg.compute_dtype
    embed = ctx.gather_split({"embed": params["embed"]}, specs, shard, dt)
    if rows is None:
        x = _embed(embed, tokens, cfg, frontend_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        split = None
    else:
        f = 0 if frontend_embeds is None else frontend_embeds.shape[1]
        front, mine = _input_rows(tokens, frontend_embeds, rows)
        x = _embed(embed, mine, cfg, front, start=rows.start)
        positions = torch.arange(rows.start, rows.stop, device=x.device)
        split = (rows.start, f + tokens.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and attn_mod.tracks_grad(x)
    for layer, spec in zip(params["layers"], specs["layers"], strict=True):
        if remat:
            x, a = checkpoint(_gathered_layer, layer, spec, shard, x, cfg,
                              positions, encoder_out, split,
                              use_reentrant=False)
        else:
            x, a = _gathered_layer(layer, spec, shard, x, cfg, positions,
                                   encoder_out, split)
        aux = aux + a
    if cfg.tie_embeddings:      # the gathered embedding, both uses' grads
        head = {"final_norm": params["final_norm"], **embed}
    else:
        head = ctx.gather_split(_head(params), specs, shard, dt)
    return _unembed(head, x if keep is None else x[:, keep], cfg), aux


def _fsdp_forward(params, tokens, cfg: ArchConfig, shard,
                  frontend_embeds=None, encoder_out=None):
    specs = _fsdp_specs(cfg, shard)
    _need_memory(params, encoder_out)
    return _gathered_forward(params, tokens, cfg, shard, specs,
                             frontend_embeds=frontend_embeds,
                             encoder_out=encoder_out)


def _gathered_encoder_layer(layer, spec, shard, x, cfg: ArchConfig,
                            positions, kv_rows=None):
    layer = ctx.gather_split(layer, spec, shard, cfg.compute_dtype)
    x = x + attn_block(layer["attn"], x, cfg, positions=positions,
                       causal=False, kv_rows=kv_rows)[0]
    return x + mlp(layer["ffn"], x, cfg)


def _gathered_encode(params, frames, cfg: ArchConfig, shard, specs,
                     rows: slice | None = None):
    """``encode`` on split weights, each encoder layer's blocks gathered
    inside its ``checkpoint`` region under remat: every frame (``fsdp``:
    the rank's batch rows), or with ``rows`` those frames of the F at
    their positions (``tp_sp``), whose Q rows attend K/V gathered whole
    (``attn_block(kv_rows=F)``). Returns the output's rows it ran."""
    f = frames.shape[1]
    rows = rows or slice(0, f)
    x = frames[:, rows].to(cfg.compute_dtype)
    positions = torch.arange(rows.start, rows.stop, device=x.device)
    if not cfg.rope:
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    kv_rows = f if rows.stop - rows.start < f else None
    remat = cfg.remat and attn_mod.tracks_grad(
        x, *tree_leaves(params["encoder"]))
    for layer, spec in zip(params["encoder"], specs["encoder"], strict=True):
        if remat:
            x = checkpoint(_gathered_encoder_layer, layer, spec, shard, x, cfg,
                           positions, kv_rows, use_reentrant=False)
        else:
            x = _gathered_encoder_layer(layer, spec, shard, x, cfg, positions,
                                        kv_rows)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _fsdp_encode(params, frames, cfg: ArchConfig, shard):
    """``encode`` on the rank's batch rows (``_gathered_encode``)."""
    return _gathered_encode(params, frames, cfg, shard,
                            _fsdp_specs(cfg, shard))


# ---------------------------------------------------------------------------
# training under tp_sp
# ---------------------------------------------------------------------------

def tp_sp_rows(total: int, texts: int, shard) -> tuple:
    """What rank ``shard.rank`` trains of a sequence of ``total`` rows
    whose last ``texts`` are text (a vision input's F patch rows first)
    under ``tp_sp`` -> (its rows of the ``total``, the label columns its
    loss covers, those columns' rows among its rows). Where the degree n
    divides ``total`` the rows are its block [r·T/n, (r+1)·T/n) and the
    columns the text among them (none on a rank of patch rows only);
    where it does not, the rows stay whole on every rank (the
    reference's ``fit_spec`` rule) and each rank's loss covers its share
    [r·S/n, (r+1)·S/n) of the S label columns, so the ranks' terms still
    sum to the batch's loss and every gradient is reduced once."""
    n, r, f = shard.degree, shard.rank, total - texts
    if total % n:
        rows = slice(0, total)
        cols = slice(r * texts // n, (r + 1) * texts // n)
    else:
        rows = shard.span(total // n, total)
        cols = slice(max(rows.start - f, 0), max(rows.stop - f, 0))
    keep = slice(f + cols.start - rows.start, f + cols.stop - rows.start)
    return rows, cols, keep


def tp_sp_forward(params, tokens, cfg: ArchConfig, shard, frontend=None):
    """The ``tp_sp`` train route: tokens (B, S) and ``frontend`` (B, F, D)
    (a vision input's patch embeddings, an encoder-decoder's frames),
    whole on every rank -> (logits of the rank's label columns (B, C, V),
    the rank's aux term, those columns). The rank holds its
    ``local_params(policy="tp_sp")`` split (or whole leaves), gathered as
    ``_gathered_forward`` does, and runs its rows of the F + S
    (``tp_sp_rows``): its Q rows attend K/V gathered whole
    (``ctx.gather_rows``, whose backward reduce-scatters dK/dV) on the
    full-sequence route at ``q_offset`` = its first row, a windowed layer
    its rows and the K/V halo before them, a recurrent layer its rows with
    the conv's halo and the scan's carry (``SeqShard.halo``/``carry``,
    whose backwards send each gradient to the rank whose rows it is). An
    encoder-decoder's encoder runs the rank's block of the F frames
    (``_gathered_encode``; all F where the degree does not divide them)
    and each cross block gathers its memories whole. Only the rank's
    label columns are unembedded, so every gradient is a sum over the
    ranks' terms and each is reduced once: a gathered leaf's or row's by
    its reduce-scatter, the rank's experts' by the all-to-all's backward,
    a whole leaf's by the train step's all-reduce."""
    n = shard.degree
    specs = split_specs(cfg, n)
    vision = cfg.frontend == "vision"
    s = tokens.shape[1]
    rows, cols, keep = tp_sp_rows(
        s + (frontend.shape[1] if vision else 0), s, shard)
    encoder_out = None
    if cfg.encoder_layers:
        f = frontend.shape[1]
        encoder_out = _gathered_encode(
            params, frontend, cfg, shard, specs,
            rows=slice(0, f) if f % n else shard.span(f // n, f))
    logits, aux = _gathered_forward(
        params, tokens, cfg, shard, specs,
        frontend_embeds=frontend if vision else None,
        encoder_out=encoder_out, rows=rows, keep=keep)
    return logits, aux, cols


def _refuse_grad(params) -> None:
    if attn_mod.tracks_grad(*tree_leaves(params)):
        raise NotImplementedError(
            "training across devices under tp_sp goes through "
            "Model.loss_fn (transformer.tp_sp_forward); the sequence "
            "route's forward serves only (its ring has no backward)")


def _seq_rows(s: int) -> tuple[slice, bool]:
    """The rank's rows of an S-row prompt, and whether the policy split
    them."""
    rows = ctx.seq_slice(s)
    return rows, rows.stop - rows.start < s


def _head(params) -> dict:
    """The leaves ``_unembed`` reads: the final norm and the unembedding,
    or, tied, the embedding."""
    out = "unembed" if "unembed" in params else "embed"
    return {"final_norm": params["final_norm"], out: params[out]}


def _seq_layers(params, cfg: ArchConfig, shard, key: str = "layers"):
    """``params[key]``' layers in turn (the decoder's, or the encoder's),
    each with the rank's split leaves gathered whole
    (``SeqShard.gather_weights``) as it is reached."""
    specs = split_specs(cfg, shard.degree)[key]
    for layer, spec in zip(params[key], specs, strict=True):
        yield shard.gather_weights(layer, spec)


def _input_rows(tokens, frontend_embeds, rows: slice) -> tuple:
    """The rank's part of an input of F frontend rows (``frontend_embeds``,
    or none) then the tokens' columns, for its rows [start, stop) of the
    F + S: (its frontend rows, or None, and its token columns; either may
    be empty: a rank may hold patch rows only)."""
    f = 0 if frontend_embeds is None else frontend_embeds.shape[1]
    front = None
    if rows.start < f:
        front = frontend_embeds[:, rows.start:min(rows.stop, f)]
    return front, tokens[:, max(rows.start - f, 0):max(rows.stop - f, 0)]


def _seq_embed(params, tokens, cfg: ArchConfig, shard, start: int,
               frontend_embeds=None):
    """``_embed`` of the rank's rows from absolute position ``start``
    (``frontend_embeds`` and ``tokens`` as ``_input_rows`` cuts them), the
    embedding gathered whole on use."""
    embed = shard.gather_weights({"embed": params["embed"]},
                                 split_specs(cfg, shard.degree))
    return _embed(embed, tokens, cfg, frontend_embeds, start=start)


def _seq_memory(encoder_out, cfg: ArchConfig, shard) -> tuple:
    """(the rank's block of an encoder-decoder's memory rows, their whole
    count F = ``cfg.num_frontend_tokens``), or (None, 0) without an
    encoder. ``encoder_out`` is whole (F rows; cut here) or the rank's
    block as ``encode`` gives it under the policy."""
    if not cfg.encoder_layers:
        return None, 0
    f, rows = cfg.num_frontend_tokens, encoder_out.shape[1]
    if rows == f:
        return encoder_out[:, ctx.seq_slice(f)], f
    if rows * shard.degree != f:
        raise ValueError(f"encoder_out of {rows} rows is neither the {f} "
                         f"frames of {cfg.name} nor a block of them over "
                         f"{shard.degree} ranks")
    return encoder_out, f


def _seq_cross(params, x, cfg: ArchConfig, mem, mem_len: int, blk=None):
    """A cross block on the rank's rows under the policy: the rank's
    memory block projected (``cross_memory``; kept in ``blk``, the rank's
    cache block, when given), gathered whole, attended by every row."""
    mem_k, mem_v = cross_memory(params, mem, cfg)
    if blk is not None:
        blk["mem_k"].copy_(mem_k)
        blk["mem_v"].copy_(mem_v)
    return cross_attn_block(params, x, cfg, mem_k=mem_k, mem_v=mem_v,
                            mem_rows=mem_len)


def _seq_encode(params, frames, cfg: ArchConfig, shard):
    """``encode`` on the rank's block of the F frames (all F where the
    degree does not divide F) at their absolute positions: each layer's
    attention gathers its K/V whole and the rank's rows attend every
    frame (``attn_block(kv_rows=F)``); the layers' split leaves gathered
    on use. Returns the rank's rows of the output."""
    check_seq_support(cfg)
    _refuse_grad(params)
    f = frames.shape[1]
    rows, _ = _seq_rows(f)
    x = frames[:, rows].to(cfg.compute_dtype)
    positions = torch.arange(rows.start, rows.stop, device=x.device)
    if not cfg.rope:
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    for layer in _seq_layers(params, cfg, shard, "encoder"):
        x = x + attn_block(layer["attn"], x, cfg, positions=positions,
                           causal=False, kv_rows=f)[0]
        x = x + mlp(layer["ffn"], x, cfg)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _seq_unembed(params, x, cfg: ArchConfig, shard):
    head = shard.gather_weights(_head(params),
                                split_specs(cfg, shard.degree))
    return _unembed(head, x, cfg)


def _write_rows(blk: dict, at: int, k, v) -> None:
    """K/V rows (B, Hkv, R, E) into the cache block's rows [at, at + R),
    each int8 row quantized with its own scale."""
    n = k.shape[2]
    if blk["k"].dtype == torch.int8:
        blk["k"][:, :, at:at + n], blk["k_scale"][:, :, at:at + n] = \
            quantize_q8(k, -1)
        blk["v"][:, :, at:at + n], blk["v_scale"][:, :, at:at + n] = \
            quantize_q8(v, -1)
    else:
        blk["k"][:, :, at:at + n] = k
        blk["v"][:, :, at:at + n] = v


def ring_slots(cfg: ArchConfig, max_len: int) -> int:
    """Rows of an attention layer's cache: ``max_len``, or the window's
    ring of min(max_len, window) slots."""
    if cfg.attn_window is None:
        return max_len
    return min(max_len, cfg.attn_window)


def rank_cache(cfg: ArchConfig, batch: int, max_len: int, shard, *,
               device, kv_dtype=None, mem_len: int = 0) -> dict:
    """The zeroed cache a rank of ``shard`` holds under the policy: each
    leaf's ``sharding.cache_specs`` block (dense layout; a dim the degree
    does not divide stays whole): an attention layer's K/V rows [r·C,
    (r + 1)·C), C = max_len / n, or ring slots alike, with an int8
    cache's per-row scales cut as their rows; an SSD layer's conv
    channels and heads; an RG-LRU layer's conv channels and width; an
    encoder-decoder's cross memories ``mem_k``/``mem_v`` of ``mem_len``
    rows, rows [r·F/n, (r + 1)·F/n) at the compute dtype whatever
    ``kv_dtype``. K/V the degree does not divide are held whole by every
    rank and marked ``replicated``; memories it does not divide,
    ``mem_replicated`` (the two need not agree)."""
    meta = make_cache(cfg, batch, max_len, device="meta", kv_dtype=kv_dtype,
                      mem_len=mem_len)
    cache = local_cache(meta, rank=shard.rank, degree=shard.degree,
                        layout="dense", device=device)
    for blk in cache["layers"]:
        for name in ("k_scale", "v_scale"):
            if name in blk:
                blk[name] = blk[name].new_zeros(blk[name[0]].shape[:3])
    if shard.degree > 1 and ring_slots(cfg, max_len) % shard.degree:
        cache["replicated"] = True
    if cfg.encoder_layers and shard.degree > 1 and mem_len % shard.degree:
        cache["mem_replicated"] = True
    return cache


def keep_block(leaf: torch.Tensor, whole: torch.Tensor, shard) -> None:
    """Copy into ``leaf`` the rank's block of ``whole`` (a leaf of the
    whole cache): along the dim where their sizes differ, all of it where
    none does."""
    for dim, (mine, size) in enumerate(zip(leaf.shape, whole.shape)):
        if mine != size:
            whole = whole.narrow(dim, shard.span(mine, size).start, mine)
    leaf.copy_(whole)


# a recurrent layer's cache leaf of its scan state beside "conv", and its
# block's keyword for that state
_RECURRENT = {"ssd": ("state", "ssm_state"), "rec": ("rnn", "rnn_state")}


def _recurrent(layer):
    """(kind, block function) of a recurrent layer, (None, None) for an
    attention layer; the function is looked up at the call."""
    if "ssd" in layer:
        return "ssd", ssm.ssd_block
    if "rec" in layer:
        return "rec", rglru.rglru_block
    return None, None


def _seq_window(params, x, cfg: ArchConfig, shard, positions, split: bool,
                s: int, max_len: int = 0, blk=None):
    """A windowed attention layer on the rank's rows -> its output. Split
    rows attend (the up to W - 1 K/V rows before them, gathered from the
    ranks before by ``SeqShard.halo``, and their own) through the full-
    sequence route at ``q_offset`` = the halo's rows: B3 on the kernel
    route, no ring pass. ``blk``, the rank's slots of the ring of a cache
    of ``max_len``, takes the prompt's last rows that fall in them
    (position p at slot p % ring)."""
    w = cfg.attn_window
    q, k, v = _qkv(params, x, cfg, positions)
    kw = dict(impl=cfg.attn_impl, causal=True, window=w,
              chunk=cfg.attn_chunk, remat=cfg.remat)
    if split:
        before, tail = shard.halo(torch.stack([k, v]), w, dim=3)
        h = min(before.shape[3], w - 1)
        before = before[:, :, :, before.shape[3] - h:]
        o = attn_mod.attention(q, torch.cat([before[0], k], 2),
                               torch.cat([before[1], v], 2), q_offset=h, **kw)
        k, v = tail[0], tail[1]             # the prompt's last min(W, S)
    else:
        o = attn_mod.attention(q, k, v, **kw)
    if blk is not None:
        c, ring = blk["k"].shape[2], ring_slots(cfg, max_len)
        k, v = _ring_rows(k, ring, s), _ring_rows(v, ring, s)
        c0 = shard.span(c, ring).start
        if c0 < k.shape[2]:
            _write_rows(blk, 0, k[:, :, c0:c0 + c], v[:, :, c0:c0 + c])
    return _merge_heads(o) @ params["wo"].to(x.dtype)


def _seq_mixer(layer, x, cfg: ArchConfig, shard, positions, split: bool,
               s: int, max_len: int = 0, blk=None):
    """One layer's token mixer (SSD, RG-LRU or attention) on the rank's
    rows of an S-row prompt -> its output; with ``blk``, the rank's cache
    block of the layer (of a cache of ``max_len``), it is filled: a
    recurrent layer's states are the whole prompt's cut to the block."""
    kind, block = _recurrent(layer)
    if kind is not None:
        state, _ = _RECURRENT[kind]
        y, (conv, st) = block(layer[kind], x, cfg,
                              shard=shard if split else None)
        if blk is not None:
            keep_block(blk["conv"], conv, shard)
            keep_block(blk[state], st, shard)
        return y
    if cfg.attn_window is not None:
        return _seq_window(layer["attn"], x, cfg, shard, positions, split, s,
                           max_len, blk)
    fill = None
    if blk is not None:
        c = blk["k"].shape[2]
        c0 = shard.span(c, max_len).start

        def fill(start: int, k, v) -> None:
            # rows of k from absolute position ``start``, kept where they
            # fall in this rank's block
            lo, hi = max(start, c0), min(start + k.shape[2], c0 + c)
            if lo < hi:
                _write_rows(blk, lo - c0, k[:, :, lo - start:hi - start],
                            v[:, :, lo - start:hi - start])

    rows = x.shape[1]
    y, (k, v) = attn_block(
        layer["attn"], x, cfg, positions=positions, causal=cfg.causal,
        ring=split, on_block=None if fill is None else (
            lambda src, k, v: fill(src * rows, k, v)))
    if fill is not None and not split:
        fill(0, k, v)
    return y


def _seq_prompt(params, tokens, cfg: ArchConfig, shard, frontend_embeds,
                encoder_out) -> tuple:
    """A prompt's start on the policy's route: (the rank's rows of the F +
    S embedded, their positions, F + S, whether the policy split the
    rows, the rank's memory block and F, ``_seq_memory``)."""
    check_seq_support(cfg)
    _need_memory(params, encoder_out)
    f = 0 if frontend_embeds is None else frontend_embeds.shape[1]
    s = f + tokens.shape[1]
    rows, split = _seq_rows(s)
    front, mine = _input_rows(tokens, frontend_embeds, rows)
    x = _seq_embed(params, mine, cfg, shard, rows.start, front)
    positions = torch.arange(rows.start, rows.stop, device=x.device)
    return (x, positions, s, split,
            *_seq_memory(encoder_out, cfg, shard))


def _seq_forward(params, tokens, cfg: ArchConfig, shard,
                 frontend_embeds=None, encoder_out=None):
    _refuse_grad(params)
    x, positions, s, split, mem, mem_len = _seq_prompt(
        params, tokens, cfg, shard, frontend_embeds, encoder_out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _seq_layers(params, cfg, shard):
        x = x + _seq_mixer(layer, x, cfg, shard, positions, split, s)
        if "cross" in layer:
            x = x + _seq_cross(layer["cross"], x, cfg, mem, mem_len)
        if "ssd" not in layer:
            y, a = ffn(layer, x, cfg, s)
            x, aux = x + y, aux + a
    if split:
        x = torch.cat(shard.all_gather(x, "gather"), dim=1)
    return _seq_unembed(params, x, cfg, shard), aux


def _seq_prefill(params, cfg: ArchConfig, tokens, max_len: int, shard,
                 kv_dtype, frontend_embeds=None, encoder_out=None):
    """``prefill`` on the rank's rows of the F + S into the rank's cache
    block (``rank_cache``): a dense layer's K/V block of positions [r·C,
    (r + 1)·C), C = max_len / n, filled from each K/V block the ring
    brings (or, rows whole, from the whole K/V); a windowed layer's ring
    slots from the prompt's last rows; a recurrent layer's states cut
    from the whole prompt's; a cross block's memory block from the
    rank's block of ``encoder_out`` (``_seq_cross``)."""
    b, n = tokens.shape[0], shard.degree
    x, positions, s, split, mem, mem_len = _seq_prompt(
        params, tokens, cfg, shard, frontend_embeds, encoder_out)
    if s > max_len:
        raise ValueError(f"prompt of {s} rows exceeds the cache ({max_len})")
    cache = rank_cache(cfg, b, max_len, shard, device=x.device,
                       kv_dtype=kv_dtype, mem_len=mem_len)
    for layer, blk in zip(_seq_layers(params, cfg, shard), cache["layers"]):
        x = x + _seq_mixer(layer, x, cfg, shard, positions, split, s,
                           max_len, blk)
        if "cross" in layer:
            x = x + _seq_cross(layer["cross"], x, cfg, mem, mem_len, blk)
        if "ssd" not in layer:
            x = x + ffn(layer, x, cfg, s)[0]
    if not split:
        return _seq_unembed(params, x[:, -1:], cfg, shard), cache
    # every rank joins the unembedding's gather; the last row's rank uses it
    head = shard.gather_weights(_head(params), split_specs(cfg, n))
    if shard.rank == n - 1:
        logits = _unembed(head, x[:, -1:], cfg)
    else:
        logits = torch.empty((b, 1, cfg.vocab_size), dtype=x.dtype,
                             device=x.device)
    return shard.broadcast(logits, n - 1), cache


def _seq_decode(params, cfg: ArchConfig, token, cache, pos: int, shard):
    """``decode_step`` on the rank's cache block (K/V whole when the cache
    is ``replicated``), the weights gathered on use: an attention layer
    attends its rows or ring slots and combines across ranks; an SSD or
    RG-LRU layer updates its channels and heads and gathers the results
    (``ssm.ssd_block``, ``rglru.rglru_block`` with ``shard``); a cross
    block combines the ranks' partials over their memory blocks
    (``cross_attn_decode``), or attends whole ``mem_replicated``
    memories as one card does."""
    check_seq_support(cfg)
    whole = cache.get("replicated", False)
    mem_whole = cache.get("mem_replicated", False)
    x = _seq_embed(params, token, cfg, shard, pos)
    for layer, blk in zip(_seq_layers(params, cfg, shard), cache["layers"]):
        kind, block = _recurrent(layer)
        if kind is not None:
            state, keyword = _RECURRENT[kind]
            y, (conv, st) = block(layer[kind], x, cfg, conv_state=blk["conv"],
                                  streaming=True, shard=shard,
                                  **{keyword: blk[state]})
            blk["conv"].copy_(conv)
            blk[state].copy_(st)
        else:
            y = attn_decode(layer["attn"], x, cfg, cache_k=blk["k"],
                            cache_v=blk["v"], pos=pos, window=cfg.attn_window,
                            k_scale=blk.get("k_scale"),
                            v_scale=blk.get("v_scale"), whole=whole)
        x = x + y
        if "cross" in layer:
            cross = cross_attn_block if mem_whole else cross_attn_decode
            x = x + cross(layer["cross"], x, cfg, mem_k=blk["mem_k"],
                          mem_v=blk["mem_v"])
        if kind != "ssd":
            x = x + ffn(layer, x, cfg)[0]
    return _seq_unembed(params, x, cfg, shard), cache


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def check_paged_support(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless the paged cache serves
    ``cfg``: the reference's rule, a stack of attention layers only, with
    no tail, no window, no encoder and rope (a vision-frontend stack is
    served text-only)."""
    pattern = (("ssd",) if cfg.family == "ssm"
               else cfg.block_pattern or ("attn",))
    if (pattern != ("attn",) or cfg.pattern_tail or cfg.window is not None
            or cfg.encoder_layers or not cfg.rope):
        raise NotImplementedError(
            "the paged cache layout supports pure-attention rope decoder "
            f"stacks only (got {cfg.name})")


def make_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     device="cuda", kv_dtype=None) -> dict:
    """Global page pools, one (Hkv, P, page, E) pair per layer
    (``kv_dtype=torch.int8`` adds per-page (Hkv, P) fp32 scales). Page 0 is
    the scratch page of the cache manager; the page table is not part of
    the cache, it is an argument of every paged step."""
    check_paged_support(cfg)
    shape = (cfg.num_kv_heads, num_pages, page_size, cfg.hd)
    dev = resolve_device(device)
    return {"layers": [_kv_block(cfg, shape, shape[:2], kv_dtype, dev)
                       for _ in range(cfg.num_layers)]}


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
        x = x + ffn(layer, x, cfg)[0]
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
        x = x + ffn(layer, x, cfg)[0]
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
        x = x + ffn(layer, x, cfg)[0]
    last = x.index_select(1, chunk_span[2:])
    return _unembed(params, last, cfg)[:, 0], cache
