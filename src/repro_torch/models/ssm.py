"""The Mamba-2 SSD (state-space duality) block: chunked prefill and the
one-token streaming step.

Port of ``repro/models/ssm.py``. ``ssd_chunked`` is the plain oracle of
the scan (``attn_impl="plain"``); with ``attn_impl="kernel"`` the
chunked form runs ``kernels/ops.ssd_chunked`` instead, whose intra-chunk
step is kernel B8 on a CUDA tensor. Both pad a sequence whose length is
not a multiple of the chunk to a whole chunk (``ssd_scan.pad_tail``),
where the reference asserts and kills the serve (ROADMAP C5).

Under the sequence-sharding policy ``ssd_block(shard=...)`` runs a
rank's block of a prompt's rows (the conv's halo rows and the scan's
carry exchanged once each, ``ssd_scan_split``) and a decode step on the
rank's conv channels and SSD heads.

Where the reference's dtype promotion mixes fp32 and the compute dtype
(the streaming step's y is fp32), the port converts explicitly to the
type the reference promotes to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import zero_front
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import pad_tail
from repro_torch.models.common import ArchConfig, dense_init, rms_norm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) lower-triangular segment sums:
    out[i, j] = sum_{j < k <= i} a[k] for i >= j, else -inf."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, a, bmat, cmat, chunk: int, initial_state=None,
                out_dtype=None):
    """SSD scan, the plain oracle.

    x: (B, L, H, P) inputs (already dt-scaled); a: (B, L, H) log-decay
    per step (negative; already dt-scaled); bmat, cmat: (B, L, H, N)
    (group-expanded). A ragged tail is padded to a whole chunk. Returns
    y: (B, L, H, P) in ``out_dtype`` (default x's dtype), final_state:
    (B, H, P, N) fp32.
    """
    b, length, h, p = x.shape
    pad = (-length) % chunk
    x, a, bmat, cmat = (pad_tail(t, pad) for t in (x, a, bmat, cmat))
    nc = (length + pad) // chunk

    def r(t):  # (B, L, ...) -> (B, nc, chunk, ...)
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, ac, bc, cc = r(x), r(a), r(bmat), r(cmat)
    ac = ac.float()
    a_cum = torch.cumsum(ac, dim=2)                          # (b,nc,q,h)

    # intra-chunk: Y_diag = (C B^T * L) x
    lmat = torch.exp(_segsum(ac.movedim(-1, 2)))             # (b,nc,h,q,q)
    scores = torch.einsum("bcqhn,bcshn->bchqs", cc.float(), bc.float())
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores * lmat, xc.float())

    # chunk states (B^T x with right decay)
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (b,nc,q,h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bc.float(),
                          decay_states, xc.float())          # (b,nc,h,p,n)

    # recurrence across chunks, in order (the reference's scan)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])              # (b,nc,h)
    s = (torch.zeros((b, h, p, bmat.shape[-1]), dtype=torch.float32,
                     device=x.device)
         if initial_state is None else initial_state.float())
    state_in = []
    for c in range(nc):
        state_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    state_in = torch.stack(state_in, dim=1)                  # (b,nc,h,p,n)

    # the carried-in state's contribution, with left decay
    decay_in = torch.exp(a_cum)                              # (b,nc,q,h)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc.float(), state_in,
                         decay_in)

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :length]
    return y.to(x.dtype if out_dtype is None else out_dtype), s


def ssd_scan_split(scan, x, a, bmat, cmat, chunk: int, shard):
    """The chunked scan of this rank's rows of a sequence split in equal
    blocks over ``shard``'s group (``scan``: ``ssd_chunked`` or
    ``kernels/ops.ssd_chunked``, arguments as theirs) -> (y (B, L, H, P)
    fp32, the state after the sequence's last row (B, H, P, N) fp32).

    The rank scans its rows from a zero state. A block that is not a
    whole number of chunks is padded at its tail with a = 0 and x = B = C
    = 0, which leaves its final state as it is (no decay, nothing added).
    One exchange (``SeqShard.carry``) gives the state s_r entering the
    rank's rows, composed from every earlier rank's final state and summed
    a; its contribution to row t is (C_t · s_r) exp(Σ_{u <= t} a_u), the
    ``y_off`` term of ``ssd_chunked``."""
    y, final = scan(x, a, bmat, cmat, chunk, out_dtype=torch.float32)
    a_cum = torch.cumsum(a.float(), dim=1)                   # (B, L, H)
    s_in, s_end = shard.carry(final, a_cum[:, -1])
    y_in = torch.einsum("blhn,bhpn->blhp", cmat.float(), s_in)
    return y + y_in * torch.exp(a_cum)[..., None], s_end


# ---------------------------------------------------------------------------
# full mamba2 block
# ---------------------------------------------------------------------------


def init_ssd_block(generator: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype) -> dict:
    """One SSD block's weights: zero norms, ``dt_bias`` 0,
    ``a_log = log(linspace(1, 16, nh))``, ``d_skip`` ones, the matrices
    drawn from ``generator``."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    conv_ch = di + 2 * s.n_groups * s.d_state
    dev = generator.device

    def dense(*shape):
        return dense_init(generator, shape, dtype=dtype)

    return {
        "norm": torch.zeros((d,), dtype=dtype, device=dev),
        "w_in": dense(d, 2 * di + 2 * s.n_groups * s.d_state + nh),
        "conv_w": dense(s.conv_width, conv_ch),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)
                           .to(dtype)),
        "d_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=dev),
        "w_out": dense(di, d),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, L, C), w: (K, C). ``state`` (B, K-1,
    C), when given, holds the K-1 inputs before x (a streaming step; L
    may be 1). Returns (y, new_state), new_state the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):]


def ssd_block(params, x, cfg: ArchConfig, *, conv_state=None, ssm_state=None,
              streaming: bool = False, shard=None):
    """x: (B, L, D) -> (y, (conv_state, ssm_state)); ``streaming`` runs the
    one-token recurrence (L == 1) from the given states.

    With ``shard`` (``distributed/ctx.SeqShard``) and a prompt, x holds
    this rank's block of a prompt split in equal blocks of rows over the
    group, from zero states: the conv takes the K - 1 input rows before
    the block from the ranks before (``SeqShard.halo``; zeros on rank 0)
    and the scan its carried-in state (``ssd_scan_split``). The returned
    states are the whole prompt's, the same on every rank. With ``shard``
    and ``streaming``, the token is whole on every rank and the states are
    the rank's blocks (``sharding.cache_specs``: conv channels and SSD
    heads, a dim the degree does not divide whole): the rank convolves
    its channels and updates its heads, and each result is all-gathered
    whole before the next step reads across channels or heads, so every
    value is one rank's arithmetic, never a sum across ranks."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    gn = s.n_groups * s.d_state
    dt_comp = x.dtype

    h = rms_norm(x, params["norm"], cfg.norm_eps)
    proj = h @ params["w_in"].to(dt_comp)
    z, xin, bc, dt = torch.split(proj, [di, di, 2 * gn, nh], dim=-1)

    conv_in = torch.cat([xin, bc], dim=-1)
    conv_w = params["conv_w"].to(dt_comp)
    if shard is not None and streaming:
        ch = shard.span(conv_state.shape[-1], conv_in.shape[-1])
        conv_out, new_conv = _causal_conv(conv_in[..., ch], conv_w[:, ch],
                                          conv_state)
        conv_out = shard.whole(conv_out, conv_in.shape[-1], -1)
    elif shard is not None:
        before, tail = shard.halo(conv_in, s.conv_width - 1)
        conv_out, _ = _causal_conv(conv_in, conv_w,
                                   zero_front(before, s.conv_width - 1))
        new_conv = zero_front(tail, s.conv_width - 1)
    else:
        conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [di, gn, gn], dim=-1)

    b_, length, _ = x.shape
    dt = F.softplus(dt.float() + params["dt_bias"].float())   # (B, L, H)
    a = -torch.exp(params["a_log"].float())                   # (H,)
    xh = xin.reshape(b_, length, nh, s.head_dim)
    per_group = nh // s.n_groups
    bmat = bmat.reshape(b_, length, s.n_groups, s.d_state).repeat_interleave(
        per_group, dim=2)
    cmat = cmat.reshape(b_, length, s.n_groups, s.d_state).repeat_interleave(
        per_group, dim=2)

    if streaming:
        # single step: state = state * exp(dt a) + dt B x
        if length != 1:
            raise ValueError(f"a streaming step takes one token, got "
                             f"{length}")
        hs = (slice(0, nh) if shard is None
              else shard.span(ssm_state.shape[1], nh))      # the rank's heads
        dt0 = dt[:, 0, hs]                                    # (B, H)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dt0, bmat[:, 0, hs].float(),
                           xh[:, 0, hs].float())
        state = (torch.zeros_like(upd) if ssm_state is None
                 else ssm_state.float())
        new_state = state * torch.exp(dt0 * a[hs])[..., None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", cmat[:, 0, hs].float(), new_state)
        if shard is not None:
            y = shard.whole(y, nh, 1)
        y = y[:, None]                                        # (B, 1, H, P)
    else:
        xs = (xh.float() * dt[..., None]).to(dt_comp)
        scan = (kops.ssd_chunked if cfg.attn_impl == "kernel"
                else ssd_chunked)
        if shard is None:
            y, new_state = scan(xs, dt * a, bmat, cmat, min(s.chunk, length),
                                initial_state=ssm_state)
        else:
            y, new_state = ssd_scan_split(scan, xs, dt * a, bmat, cmat,
                                          min(s.chunk, length), shard)
            y = y.to(dt_comp)

    y = y + xh.to(y.dtype) * params["d_skip"].to(y.dtype)[:, None]
    y = y.reshape(b_, length, di)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    w_out = params["w_out"].to(dt_comp)
    out = y @ w_out.to(torch.promote_types(y.dtype, w_out.dtype))
    return out.to(x.dtype), (new_conv, new_state)


def ssd_dims(cfg: ArchConfig) -> dict:
    """Shapes of one SSD block's cache entries for one sequence."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return {"conv": (s.conv_width - 1, di + 2 * s.n_groups * s.d_state),
            "state": (nh, s.head_dim, s.d_state)}
