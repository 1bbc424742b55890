"""Mixture-of-Experts FFN: top-k routing with capacity buffers.

Port of ``repro/models/moe.py``. Tokens are dispatched in the groups the
active sharding gives (``_token_groups``): one group on one device, the
rank-local groups under ``distributed/ctx.sharding_policy``. Every token
of the call (padding rows, idle decode slots and a chunk's padded tail
included) is routed, and each expert takes at most ``capacity =
max(4, int(capacity_factor * Tg * top_k / num_experts))`` of a group's
Tg * top_k assignments, in token-major order: an assignment past its
expert's capacity is dropped, so what else is in the group can change a
token's output, and the grouping changes which assignments drop,
exactly as in the reference.

Dispatch scatters each kept assignment into a (G, E, C + 1, D) buffer (a
dropped one goes to slot C, which is sliced off) and the experts run as
batched matmuls over (E, G·C, D); under the policy the rank's experts
run on the slots of every group, which the expert all-to-all brings.
The capacity comes from shapes and no step selects by a boolean mask, so
nothing here reads the device from the host. The FFN takes the
un-normalised residual stream, as the reference's does (no norm is
drawn or applied; ROADMAP C11).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.models.common import ArchConfig, dense_init


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    """The reference's shapes and fan-in axes: ``router`` (d, E), routed
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and with
    ``num_shared`` a ``shared`` SwiGLU of width f * num_shared."""
    m = cfg.moe
    d, f, ne = cfg.d_model, m.d_expert, m.num_experts

    def dense(*shape, in_axis=0):
        return dense_init(gen, shape, in_axis=in_axis, dtype=dtype)

    params = {"router": dense(d, ne), "w_gate": dense(ne, d, f, in_axis=1),
              "w_up": dense(ne, d, f, in_axis=1),
              "w_down": dense(ne, f, d, in_axis=1)}
    if m.num_shared:
        fs = f * m.num_shared
        params["shared"] = {"w_gate": dense(d, fs), "w_up": dense(d, fs),
                            "w_down": dense(fs, d)}
    return params


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


@dataclasses.dataclass(frozen=True)
class Route:
    """One call's routing. Tokens (T, D) are one group; (G, Tg, D) are G
    groups of Tg, each routed alone. Within a group the Tg * top_k
    assignments are flattened token-major."""

    expert_ids: torch.Tensor   # (..., Tg, K) int64, best first
    gate_vals: torch.Tensor    # (..., Tg, K) fp32, renormalised over the K
    positions: torch.Tensor    # (..., Tg * K) rank among its expert's earlier
    keep: torch.Tensor         # (..., Tg * K) bool, positions < capacity
    capacity: int
    density: torch.Tensor      # (E,) fp32 share of first choices
    mean_probs: torch.Tensor   # (E,) fp32 mean router probability

    @property
    def aux(self) -> torch.Tensor:
        """The Switch load-balance loss, E * sum_e f_e * p_e (fp32)."""
        return self.density.numel() * torch.sum(self.density
                                                * self.mean_probs)


def moe_route(params, tokens, cfg: ArchConfig) -> Route:
    """Route ``tokens`` (T, D), or (G, Tg, D) in G groups: fp32 router
    logits and softmax, top-k (ties to the lower expert index, as
    ``jax.lax.top_k``) renormalised, the first choices' density and the
    mean probabilities over every token (the aux loss's terms), and each
    assignment's position in its expert's buffer by a cumulative count
    over its group's token-major order. Each expert takes at most
    ``capacity = max(4, int(capacity_factor * Tg * top_k / E))`` of a
    group's assignments, the reference's rule with Tg the group's
    tokens."""
    m = cfg.moe
    tg = tokens.shape[-2]
    ne = m.num_experts
    capacity = max(4, int(m.capacity_factor * tg * m.top_k / ne))
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (..., Tg, E)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[..., :m.top_k]
    expert_ids = expert_ids[..., :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    experts = torch.arange(ne, device=tokens.device)
    density = (expert_ids[..., :1].reshape(-1, 1) == experts).float().mean(
        dim=0)
    mean_probs = probs.reshape(-1, ne).mean(dim=0)
    flat_ids = expert_ids.flatten(-2)                        # (..., Tg * K)
    # (..., E, Tg * K): the count runs along the innermost axis, which the
    # card scans in parallel (along the outer axis it ran 64 columns wide
    # and took half of a 4 x 2048 prefill's device time)
    onehot = (experts[:, None] == flat_ids[..., None, :]).to(torch.int32)
    count = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    positions = torch.take_along_dim(count, flat_ids[..., None, :],
                                     dim=-2)[..., 0, :].long() - 1
    return Route(expert_ids, gate_vals, positions, positions < capacity,
                 capacity, density, mean_probs)


def token_groups(b: int, s: int, degree: int, kind: str = "tp_sp"
                 ) -> tuple[int, int]:
    """(g_b, g_s): the reference's ``_token_groups`` for a group of
    ``degree`` ranks, the port's one group being the reference's
    'model' axis. Under ``fsdp`` the batch splits over it (g_b = degree
    when it divides ``b``), otherwise the sequence (g_s = degree when it
    divides ``s``); a dim it does not divide is one group."""
    if kind == "fsdp":
        return (degree if b % degree == 0 else 1), 1
    return 1, (degree if s % degree == 0 else 1)


def _token_groups(b: int, s: int) -> tuple[int, int]:
    """``token_groups`` under the active policy, or ``ctx.grouped_as``."""
    return token_groups(b, s, ctx.grouping_degree(), ctx.policy_kind())


def _rank_experts(w, shard, ne: int):
    """The rank's experts [r·E/n, (r+1)·E/n) of ``w`` (E or E/n, ...)."""
    per = ne // shard.degree
    return w if w.shape[0] == per else w.narrow(0, shard.rank * per, per)


def _experts(params, buf, dt, shard, ne: int):
    """The SwiGLU experts over ``buf`` (E', N, D) -> (E', N, D), E' the
    experts of ``params`` (all, or with ``shard`` the rank's)."""
    w = [params[k] if shard is None else _rank_experts(params[k], shard, ne)
         for k in ("w_gate", "w_up", "w_down")]
    h = (F.silu(torch.bmm(buf, w[0].to(dt))) * torch.bmm(buf, w[1].to(dt)))
    return torch.bmm(h, w[2].to(dt))


def rank_aux_term(r: Route, shard) -> torch.Tensor:
    """A rank's term of its group's aux loss: E · Σ_e f_e · p_e^r / n,
    f the first-choice density of every rank's tokens (the ranks'
    densities all-reduced and averaged: it comes from an argmax and
    carries no gradient) and p^r this rank's mean router probabilities,
    so the ranks' terms sum to E · Σ_e f_e · p_e."""
    density = shard.all_reduce(r.density) / shard.degree
    return density.numel() * torch.sum(density * r.mean_probs) / shard.degree


def moe_ffn(params, x, cfg: ArchConfig, seq_len: int | None = None, *,
            rank_aux: bool = False):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux fp32).

    Tokens are dispatched in the reference's groups (``_token_groups`` of
    the batch and ``seq_len``, the whole sequence's rows, default S).
    With one group this is the single-device FFN: each kept assignment is
    scattered into an (E, C + 1, D) buffer (a dropped one to slot C,
    sliced off) and the experts run as batched matmuls over (E, C, D).
    With G groups and no policy (``ctx.grouped_as``) the (G, E, C, D)
    buffers run as (E, G·C, D).

    Under the sharding policy the rank holds experts [r·E/n, (r+1)·E/n)
    (``params`` may hold all of them or only those). When the policy
    split the sequence, ``x`` is the rank's rows, which are group r: its
    (E, C, D) buffer goes out in one all-to-all (expert block j to rank
    j), the rank's experts run over every group's slots, and a second
    all-to-all brings its group's outputs back; the aux terms are
    all-gathered and averaged in rank order. With one group (a decode
    row, or a sequence the degree does not divide) every rank holds every
    token, runs its experts' slots and all-gathers the outputs
    (``ctx.gather_rows``, whose backward reduce-scatters their gradient).

    Both all-to-alls are differentiable (``ctx.AllToAll``: the backward
    sends the gradients' blocks back), so the split dispatch trains: a
    rank's experts receive every group's gradient. With ``rank_aux`` (the
    ``tp_sp`` train route) aux is the rank's term of the group's loss
    instead: the first-choice density f, which carries no gradient, is
    the ranks' densities all-reduced and averaged, and the rank adds E ·
    Σ_e f_e · p_e^r / n, p^r its own mean router probabilities, so the
    ranks' terms sum to the group's E · Σ_e f_e · p_e; with one group
    (every rank holding every token) the rank's term is aux / n.
    """
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    k, ne = m.top_k, m.num_experts
    shard = ctx.seq_shard_state()
    if shard is not None and ne % shard.degree:
        raise ValueError(f"{ne} experts do not split over {shard.degree} "
                         "ranks")
    g_b, g_s = _token_groups(b, s if seq_len is None else seq_len)
    local = shard is not None and g_b * g_s > 1     # x is group r
    g = 1 if local else g_b * g_s
    if g == 1:
        tokens = x.reshape(b * s, d)
    else:
        tokens = (x.reshape(g_b, b // g_b, g_s, s // g_s, d).transpose(1, 2)
                  .reshape(g, -1, d))
    r = moe_route(params, tokens, cfg)
    cap = r.capacity
    tg = b * s // g
    flat_ids = r.expert_ids.reshape(g, tg * k)
    pos = r.positions.reshape(g, tg * k)
    keep = r.keep.reshape(g, tg * k)
    grp = torch.arange(g, device=x.device)[:, None]
    tok_rep = tokens.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(
        g, tg * k, d)
    buf = tokens.new_zeros((g, ne, cap + 1, d))
    buf[grp, flat_ids, torch.where(keep, pos, cap)] = tok_rep
    buf = buf[:, :, :cap]                                     # (G, E, C, D)
    if shard is None:
        out_buf = _experts(params, buf.transpose(0, 1).reshape(ne, g * cap, d),
                           dt, None, ne).reshape(ne, g, cap, d).transpose(0, 1)
    elif local:
        n = shard.degree
        mine = ctx.AllToAll.apply(buf[0], shard)              # (E, C, D)
        mine = mine.reshape(n, ne // n, cap, d).transpose(0, 1).reshape(
            ne // n, n * cap, d)
        out = _experts(params, mine, dt, shard, ne).reshape(ne // n, n, cap, d)
        out_buf = ctx.AllToAll.apply(
            out.transpose(0, 1).reshape(ne, cap, d), shard)
        out_buf = out_buf[None]
    else:
        out = _experts(params, _rank_experts(buf[0], shard, ne), dt, shard,
                       ne)
        out_buf = ctx.gather_rows(out, shard, 0)[None]
    safe_pos = torch.where(keep, pos, 0)
    gathered = torch.where(keep[..., None], out_buf[grp, flat_ids, safe_pos],
                           0)
    y = (gathered.reshape(g, tg, k, d) * r.gate_vals.reshape(
        g, tg, k)[..., None].to(dt)).sum(dim=2)
    if g > 1:
        y = y.reshape(g_b, g_s, b // g_b, s // g_s, d).transpose(1, 2)
    y = y.reshape(b * s, d)
    aux = r.aux
    if local and rank_aux:
        aux = rank_aux_term(r, shard)
    elif shard is not None and rank_aux:       # every rank holds every token
        aux = aux / shard.degree
    elif local:
        terms = shard.all_gather(torch.stack([r.density, r.mean_probs]),
                                 "gather")
        mean = terms[0]
        for t in terms[1:]:
            mean = mean + t
        mean = mean / shard.degree
        aux = ne * torch.sum(mean[0] * mean[1])
    if m.num_shared:
        sh = params["shared"]
        y = y + _swiglu(x.reshape(b * s, d), sh["w_gate"].to(dt),
                        sh["w_up"].to(dt), sh["w_down"].to(dt))
    return y.reshape(b, s, d), aux.float()
