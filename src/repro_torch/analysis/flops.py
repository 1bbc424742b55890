"""Analytic compute and memory counts per (arch x shape) cell.

Port of ``repro/analysis/flops.py`` on the port's ``ArchConfig``, whose
``param_count`` counts what its init draws (ROADMAP C6, C10, C12, C13):
called with their defaults, ``model_flops`` and ``model_bytes`` are the
reference's formulas, and differ from the reference's numbers by exactly
those count gaps times the cell's multiplier.

Three counts:
* ``model_flops`` — "useful" flops: 6·N_active·D for training (2·N for
  forward-only), plus the quadratic attention terms (which 6·N·D
  excludes). ``causal=True`` counts a step as the port runs it: a causal
  prompt's score pairs, s(s+1)/2 a head (or the window's), instead of
  s², and an encoder-decoder's encoder and cross-attention K/V
  projections over the encoder's frames instead of the decoder's tokens
  (at decode: no encoder, and the decoder's parameters exactly, where
  the reference takes a share of all parameters by layer count).
* ``model_bytes`` — the reference's expected HBM traffic of its BASELINE
  lowering: parameter reads, activation traffic, fp32 score-matrix round
  trips, KV cache sweeps. The MAS, flash and decode kernels never make
  the score round trips, so this is not a lower bound on the port's
  traffic; it is kept for comparison with the reference.
* ``least_bytes`` — the least HBM traffic of a step: each input read
  once and each output written once (parameters, the KV cache or
  recurrent state, prompt tokens and frames in, logits out). A roofline
  built on it never reads above 100% for a kernel that keeps its scores
  on chip.

All numbers are GLOBAL (whole step, all devices).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import ShapeCell
from repro_torch.models.common import ArchConfig


def _attn_layers(cfg: ArchConfig) -> int:
    return sum(k == "attn" for k in cfg.layer_kinds)


def _ssd_layers(cfg: ArchConfig) -> int:
    return sum(k == "ssd" for k in cfg.layer_kinds)


def _rec_layers(cfg: ArchConfig) -> int:
    return sum(k == "rec" for k in cfg.layer_kinds)


def _causal_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs of a causal prompt of ``s`` rows, each row
    seeing itself and at most ``window`` - 1 rows before it."""
    if window is None or s <= window:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _attn_flops_fwd(cfg: ArchConfig, b: int, s_q: int, s_kv: int,
                    include_encoder: bool = True,
                    causal: bool = False) -> float:
    """QK^T + PV for all attention layers (decoder self-attn)."""
    window = None
    if cfg.window is not None and cfg.block_pattern is not None:
        window = cfg.window
        s_kv = min(s_kv, cfg.window)
    if causal and s_q > 1:
        pairs = _causal_pairs(s_q, window)
    else:
        pairs = s_q * s_kv
    per_layer = 4.0 * b * cfg.num_heads * pairs * cfg.hd
    total = per_layer * _attn_layers(cfg)
    if cfg.encoder_layers:
        f = cfg.num_frontend_tokens
        if include_encoder:
            # encoder self-attention over the frontend frames
            total += (4.0 * b * cfg.num_heads * f * f * cfg.hd
                      * cfg.encoder_layers)
        # decoder cross-attention
        total += 4.0 * b * cfg.num_heads * s_q * f * cfg.hd * cfg.num_layers
    return total


def _ssd_flops_fwd(cfg: ArchConfig, b: int, s: int) -> float:
    if cfg.ssm is None:
        return 0.0
    sm = cfg.ssm
    di = sm.expand * cfg.d_model
    nh = di // sm.head_dim
    q = min(sm.chunk, s)
    intra = 4.0 * b * s * q * nh * sm.head_dim      # CB^T scores + y_diag
    states = 6.0 * b * s * nh * sm.head_dim * sm.d_state  # states/y_off
    return (intra + states) * _ssd_layers(cfg)


def _encdec_split(cfg: ArchConfig) -> tuple[int, int, int]:
    """An encoder-decoder's parameters as a step runs them: (decoder side,
    run over the decoder's tokens: its layers, embeddings, the cross
    blocks' norm, Q and O projections; memory side, run over the encoder's
    frames once a prompt: the cross blocks' K and V projections; the
    encoder: its layers and final norm)."""
    d, e = cfg.d_model, cfg.hd
    n_cross = _attn_layers(cfg)
    decoder = dataclasses.replace(cfg, encoder_layers=0).param_count()
    cross_kv = n_cross * 2 * d * cfg.num_kv_heads * e
    cross_qo = n_cross * (2 * d * cfg.num_heads * e + d)
    encoder = cfg.param_count() - decoder - cross_kv - cross_qo
    return decoder + cross_qo, cross_kv, encoder


def model_flops(cfg: ArchConfig, cell: ShapeCell, *,
                causal: bool = False) -> float:
    n_active = cfg.active_param_count()
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = b * s
        base = 6.0 * n_active * tokens
        extra = 3.0 * (_attn_flops_fwd(cfg, b, s, s, causal=causal)
                       + _ssd_flops_fwd(cfg, b, s))
        return base + extra
    if causal and cfg.encoder_layers:
        tok_side, mem_side, encoder = _encdec_split(cfg)
        f = cfg.num_frontend_tokens
        if cell.kind == "prefill":
            return (2.0 * b * (tok_side * s + (mem_side + encoder) * f)
                    + _attn_flops_fwd(cfg, b, s, s, causal=True))
        return (2.0 * tok_side * b
                + _attn_flops_fwd(cfg, b, 1, s, include_encoder=False))
    if cell.kind == "prefill":
        tokens = b * s
        return (2.0 * n_active * tokens
                + _attn_flops_fwd(cfg, b, s, s, causal=causal)
                + _ssd_flops_fwd(cfg, b, s))
    # decode: one token per sequence against an s-long cache/state.
    # The encoder ran at prefill: exclude (approximately) its share of
    # the params from the per-token matmul count.
    if cfg.encoder_layers:
        frac = cfg.num_layers / (cfg.num_layers + cfg.encoder_layers)
        n_active = int(n_active * frac)
    base = 2.0 * n_active * b
    attn = _attn_flops_fwd(cfg, b, 1, s, include_encoder=False)
    ssd = 0.0
    if cfg.ssm is not None:
        sm = cfg.ssm
        di = sm.expand * cfg.d_model
        nh = di // sm.head_dim
        ssd = 4.0 * b * nh * sm.head_dim * sm.d_state * _ssd_layers(cfg)
    return base + attn + ssd


def model_bytes(cfg: ArchConfig, cell: ShapeCell) -> dict[str, float]:
    """Baseline HBM traffic decomposition (global bytes per step)."""
    n = cfg.param_count()
    b, s = cell.global_batch, cell.seq_len
    d = cfg.d_model
    out: dict[str, float] = {}
    act_bpe = 2  # bf16 activations
    if cell.kind == "train":
        # params: fwd read + bwd read + remat re-read; grads w+r;
        # adam mu/nu r+w each; master write (fp32 states)
        out["params"] = n * (3 * 4 + 2 * 4 + 4 * 4 + 4)
        # activations: ~12 tensor passes of (B,S,D) per layer, r+w
        out["activations"] = (
            cfg.num_layers * 12 * 2 * b * s * d * act_bpe * 1.5  # +remat
        )
        # chunked-attention score round trips (fp32), fwd + bwd recompute
        skv = min(s, cfg.window) if (cfg.window and cfg.block_pattern) else s
        out["scores"] = (
            _attn_layers(cfg) * 3 * 2 * b * cfg.num_heads * s * skv * 4
        )
        out["logits"] = 3 * b * s * cfg.vocab_size * act_bpe
    elif cell.kind == "prefill":
        out["params"] = n * 4
        out["activations"] = cfg.num_layers * 12 * 2 * b * s * d * act_bpe
        skv = min(s, cfg.window) if (cfg.window and cfg.block_pattern) else s
        out["scores"] = (
            _attn_layers(cfg) * 2 * b * cfg.num_heads * s * skv * 4
        )
        out["cache_write"] = (
            _attn_layers(cfg) * 2 * b * cfg.num_kv_heads
            * min(s, cfg.window or s) * cfg.hd * act_bpe
        )
        out["logits"] = b * 1 * cfg.vocab_size * act_bpe
    else:  # decode
        out["params"] = n * 4
        skv = min(s, cfg.window) if (cfg.window and cfg.block_pattern) else s
        out["cache_read"] = (
            _attn_layers(cfg) * 2 * b * cfg.num_kv_heads * skv * cfg.hd
            * act_bpe
        )
        if cfg.encoder_layers:
            out["cache_read"] += (
                cfg.num_layers * 2 * b * cfg.num_kv_heads
                * cfg.num_frontend_tokens * cfg.hd * act_bpe
            )
        if cfg.ssm is not None:
            sm = cfg.ssm
            di = sm.expand * cfg.d_model
            nh = di // sm.head_dim
            out["state"] = (
                2 * _ssd_layers(cfg) * b * nh * sm.head_dim * sm.d_state * 4
            )
        if _rec_layers(cfg):
            w = cfg.lru_width or d
            out["state"] = out.get("state", 0) + (
                2 * _rec_layers(cfg) * b * w * 4
            )
        out["activations"] = cfg.num_layers * 12 * 2 * b * 1 * d * act_bpe
        out["logits"] = b * cfg.vocab_size * act_bpe
    out["total"] = sum(out.values())
    return out


def _params_read(cfg: ArchConfig, cell: ShapeCell) -> int:
    """Parameters a step must read: a decode step skips the encoder and
    the cross blocks' K and V projections (the cross memories are
    cached); an MoE layer reads only the routed experts its tokens can
    reach, min(experts, tokens · top_k), besides the shared ones."""
    n = cfg.param_count()
    tokens = cell.global_batch * (1 if cell.kind == "decode"
                                  else cell.seq_len)
    if cfg.moe is not None:
        m = cfg.moe
        unread = max(0, m.num_experts - tokens * m.top_k)
        n -= _attn_layers(cfg) * unread * 3 * cfg.d_model * m.d_expert
    if cfg.encoder_layers and cell.kind == "decode":
        tok_side, _, _ = _encdec_split(cfg)
        n = tok_side
    return n


def least_bytes(cfg: ArchConfig, cell: ShapeCell, *, param_bytes: int = 2,
                kv_bytes: int = 2) -> dict[str, float]:
    """Least HBM traffic of one step (global bytes), each input read once
    and each output written once: the parameters the step reads at
    ``param_bytes`` (a training step also writes their gradients and reads
    and writes fp32 AdamW master weights and moments); the KV cache
    written (prefill) or read (decode) at ``kv_bytes`` a value, with one
    fp32 scale a row and head when ``kv_bytes`` is 1, the window's rows
    for a windowed stack; an encoder-decoder's cross memories at the
    compute width (``param_bytes``); SSD and RG-LRU states in fp32 (read
    and written at decode); int32 prompt tokens and an encoder's frames
    in; the last position's logits out. No score or activation term: the
    attention kernels keep their scores on chip."""
    b, s = cell.global_batch, cell.seq_len
    out: dict[str, float] = {}
    n = _params_read(cfg, cell)
    if cell.kind == "train":
        out["params"] = n * (2 * param_bytes + 3 * 2 * 4)
        out["tokens"] = b * s * 4
        out["total"] = sum(out.values())
        return out
    out["params"] = n * param_bytes
    rows = min(s, cfg.attn_window) if cfg.attn_window else s
    kv_row = cfg.num_kv_heads * (cfg.hd * kv_bytes
                                 + (4 if kv_bytes == 1 else 0))
    cache = _attn_layers(cfg) * 2 * b * rows * kv_row
    if cfg.encoder_layers:
        cache += (_attn_layers(cfg) * 2 * b * cfg.num_kv_heads
                  * cfg.num_frontend_tokens * cfg.hd * param_bytes)
    state = 0
    if cfg.ssm is not None:
        sm = cfg.ssm
        nh = sm.expand * cfg.d_model // sm.head_dim
        state += _ssd_layers(cfg) * b * nh * sm.head_dim * sm.d_state * 4
    state += _rec_layers(cfg) * b * (cfg.lru_width or cfg.d_model) * 4
    if cell.kind == "prefill":
        out["cache_write"] = cache
        out["state"] = state
        out["tokens"] = b * s * 4
        if cfg.encoder_layers:
            out["frames"] = (b * cfg.num_frontend_tokens * cfg.d_model
                             * param_bytes)
    else:
        out["cache_read"] = cache
        out["state"] = 2 * state
        out["tokens"] = b * 4
    out["logits"] = b * cfg.vocab_size * param_bytes
    out["total"] = sum(out.values())
    return out
