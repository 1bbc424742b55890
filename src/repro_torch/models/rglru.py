"""The RG-LRU recurrent block of the hybrid (Griffin / RecurrentGemma)
stack: full-sequence and one-token streaming forms.

Port of ``repro/models/rglru.py``:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),  c = 8

where x is the block's input branch after a depthwise causal conv of
width 4, and r, i are sigmoid gates of the conv's output. The reference
runs the recurrence over a prompt as ``jax.lax.associative_scan``; here it
is ``affine_scan``, a doubling (Hillis-Steele) scan of log2(L) passes of
whole-tensor torch ops, so a 32768-token prompt costs 15 passes and no
Python loop over its positions. It is device code outside any TPU kernel
(the reference computes it with XLA ops), so it stays torch ops.

Under the sequence-sharding policy ``rglru_block(shard=...)`` runs a
rank's block of a prompt's rows (the conv's halo rows and the scan's
carry exchanged once each, ``affine_scan_split``) and a decode step on
the rank's channels.

The dtype placement is the reference's: the gate, the x branch, the conv
and the r / i projections in the compute dtype; softplus, a,
sqrt(max(1 - a^2, 1e-12)) and the scan in fp32; the scan's output cast to
the compute dtype before the gate product. ``jax.nn.gelu`` is the tanh
approximation, and so is the gate here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import zero_front
from repro_torch.models.common import ArchConfig, dense_init, rms_norm

_C = 8.0
CONV_WIDTH = 4


def init_rglru_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype: torch.dtype) -> dict:
    """One RG-LRU block's weights: a zero norm, ``lam`` spread over
    linspace(0.3, 1.5, w) (a^c between about 0.9 and 0.999, as in
    Griffin), the matrices and the conv drawn from ``generator``."""
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = generator.device

    def dense(*shape):
        return dense_init(generator, shape, dtype=dtype)

    return {
        "norm": torch.zeros((d,), dtype=dtype, device=dev),
        "w_x": dense(d, w),
        "w_gate": dense(d, w),
        "conv_w": dense(CONV_WIDTH, w),
        "w_i": dense(w, w),
        "w_r": dense(w, w),
        "lam": torch.linspace(0.3, 1.5, w, device=dev).to(dtype),
        "w_out": dense(w, d),
    }


def affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, from h_{-1} = 0. a, b:
    (B, L, W) fp32. After the pass of offset d, position t holds the
    composition of the steps (t - 2d, t]: b_t + a_t * b_{t-d} and
    a_t * a_{t-d}, both from the previous pass's values. Each pass builds
    new tensors (autograd needs the old ones for the backward)."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def affine_scan_split(a, log_a, b, shard):
    """``affine_scan`` of this rank's rows of a sequence split in equal
    blocks over ``shard``'s group -> (h (B, L, W), the state after the
    sequence's last row (B, W)), fp32. The rank scans its rows from a zero
    state; one exchange (``SeqShard.carry``) of its last h and its summed
    log a gives h0, the state entering its rows, whose contribution to row
    t is (Π_{u <= t} a_u) h0, the product taken as exp(Σ log a)."""
    h = affine_scan(a, b)
    log_cum = torch.cumsum(log_a, dim=1)
    h0, h_end = shard.carry(h[:, -1], log_cum[:, -1])
    return h + torch.exp(log_cum) * h0[:, None], h_end


def causal_conv(xb, conv_w, state=None):
    """Depthwise causal conv of width K over the x branch. xb: (B, L, W),
    conv_w: (K, W) in xb's dtype; ``state`` (B, K-1, W), when given, holds
    the K-1 rows before xb (zeros when None). Returns (conv, the last K-1
    rows of the padded input)."""
    bsz, length, width = xb.shape
    k = conv_w.shape[0]
    if state is None:
        state = torch.zeros((bsz, k - 1, width), dtype=xb.dtype,
                            device=xb.device)
    xp = torch.cat([state.to(xb.dtype), xb], dim=1)
    conv = sum(xp[:, i:i + length] * conv_w[i] for i in range(k))
    return conv, xp[:, -(k - 1):]


def rglru_block(params, x, cfg: ArchConfig, *, conv_state=None,
                rnn_state=None, streaming: bool = False, shard=None):
    """x: (B, L, D) -> (y, (conv_state, rnn_state)).

    ``conv_state`` (B, 3, W) holds the x branch's last three rows before x
    (zeros when None); ``rnn_state`` (B, W) fp32 the recurrence's state
    before x, folded into the first step. ``streaming`` is the one-token
    step (L == 1). The returned states are those after x's last row.

    With ``shard`` (``distributed/ctx.SeqShard``) and a prompt, x holds
    this rank's block of a prompt split in equal blocks of rows over the
    group, from zero states: the conv takes the three x-branch rows before
    the block from the ranks before (``SeqShard.halo``) and the scan its
    carried-in state (``affine_scan_split``); the returned states are the
    whole prompt's. With ``shard`` and ``streaming`` the states are the
    rank's channels (``sharding.cache_specs``, whole where the degree does
    not divide W): the rank convolves and updates its channels, and the
    conv output and h are all-gathered whole before the projections that
    read across channels."""
    dt = x.dtype
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    gate = F.gelu(h @ params["w_gate"].to(dt), approximate="tanh")
    xb = h @ params["w_x"].to(dt)

    length, width = xb.shape[1], xb.shape[2]
    conv_w = params["conv_w"].to(dt)
    ws = slice(0, width)
    if shard is not None and streaming:
        ws = shard.span(conv_state.shape[-1], width)    # the rank's channels
        conv, new_conv = causal_conv(xb[..., ws], conv_w[:, ws], conv_state)
        conv = shard.whole(conv, width, -1)
    elif shard is not None:
        before, tail = shard.halo(xb, CONV_WIDTH - 1)
        conv, _ = causal_conv(xb, conv_w, zero_front(before, CONV_WIDTH - 1))
        new_conv = zero_front(tail, CONV_WIDTH - 1)
    else:
        conv, new_conv = causal_conv(xb, conv_w, conv_state)

    r = torch.sigmoid(conv @ params["w_r"].to(dt)).float()
    i = torch.sigmoid(conv @ params["w_i"].to(dt)).float()
    log_a = -_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)                                    # (B, L, W)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * conv.float())

    if streaming:
        if length != 1:
            raise ValueError(f"a streaming step takes one token, got "
                             f"{length}")
        s0 = (torch.zeros_like(gated_in[:, 0, ws]) if rnn_state is None
              else rnn_state.float())
        new_state = a[:, 0, ws] * s0 + gated_in[:, 0, ws]
        hseq = new_state[:, None]
        if shard is not None:
            hseq = shard.whole(hseq, width, -1)
    elif shard is not None:
        hseq, new_state = affine_scan_split(a, log_a, gated_in, shard)
    else:
        if rnn_state is not None:
            # the carried state enters through the first step
            first = gated_in[:, :1] + a[:, :1] * rnn_state.float()[:, None]
            gated_in = torch.cat([first, gated_in[:, 1:]], dim=1)
        hseq = affine_scan(a, gated_in)
        new_state = hseq[:, -1]

    y = (hseq.to(dt) * gate) @ params["w_out"].to(dt)
    return y.to(x.dtype), (new_conv, new_state)


def rglru_dims(cfg: ArchConfig) -> dict:
    """Shapes of one RG-LRU block's cache entries for one sequence."""
    w = cfg.lru_width or cfg.d_model
    return {"conv": (CONV_WIDTH - 1, w), "rnn": (w,)}
