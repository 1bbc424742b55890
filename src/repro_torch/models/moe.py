"""Mixture-of-Experts FFN: top-k routing with capacity buffers.

Port of ``repro/models/moe.py`` at one token group (the reference groups
tokens by the active sharding; on one device it has one group). Every
token of the call (padding rows, idle decode slots and a chunk's padded
tail included) is routed, and each expert takes at most ``capacity =
max(4, int(capacity_factor * T * top_k / num_experts))`` of the call's
T * top_k assignments, in token-major order: an assignment past its
expert's capacity is dropped, so what else is in the call can change a
token's output, exactly as in the reference.

Dispatch scatters each kept assignment into an (E, C + 1, D) buffer (a
dropped one goes to slot C, which is sliced off) and the experts run as
batched matmuls over (E, C, D). The capacity comes from shapes and no
step selects by a boolean mask, so nothing here reads the device from
the host. The FFN takes the un-normalised residual stream, as the
reference's does (no norm is drawn or applied; ROADMAP C11).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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
    """One call's routing over its T tokens, flattened token-major to
    T * top_k assignments."""

    expert_ids: torch.Tensor   # (T, K) int64, best first
    gate_vals: torch.Tensor    # (T, K) fp32, renormalised over the K
    positions: torch.Tensor    # (T * K,) rank among its expert's earlier
    keep: torch.Tensor         # (T * K,) bool, positions < capacity
    capacity: int
    aux: torch.Tensor          # () fp32 Switch load-balance loss


def moe_route(params, tokens, cfg: ArchConfig) -> Route:
    """Route ``tokens`` (T, D): fp32 router logits and softmax, top-k
    (ties to the lower expert index, as ``jax.lax.top_k``) renormalised,
    the Switch aux loss from each token's first choice, and each
    assignment's position in its expert's buffer by a cumulative count
    over the token-major order."""
    m = cfg.moe
    t = tokens.shape[0]
    ne = m.num_experts
    capacity = max(4, int(m.capacity_factor * t * m.top_k / ne))
    logits = tokens.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals = gate_vals[:, :m.top_k]
    expert_ids = expert_ids[:, :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    experts = torch.arange(ne, device=tokens.device)
    density = (expert_ids[:, :1] == experts).float().mean(dim=0)
    aux = ne * torch.sum(density * probs.mean(dim=0))
    flat_ids = expert_ids.reshape(-1)                        # (T * K,)
    # (E, T * K): the count runs along the innermost axis, which the card
    # scans in parallel (along the outer axis it ran 64 columns wide and
    # took half of a 4 x 2048 prefill's device time)
    onehot = (experts[:, None] == flat_ids).to(torch.int32)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    positions = torch.take_along_dim(count, flat_ids[None, :],
                                     dim=0)[0].long() - 1
    return Route(expert_ids, gate_vals, positions, positions < capacity,
                 capacity, aux)


def moe_ffn(params, x, cfg: ArchConfig):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux fp32)."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    k = m.top_k
    tokens = x.reshape(b * s, d)
    r = moe_route(params, tokens, cfg)
    cap = r.capacity
    flat_ids = r.expert_ids.reshape(-1)
    tok_rep = tokens[:, None].expand(b * s, k, d).reshape(b * s * k, d)
    buf = tokens.new_zeros((m.num_experts, cap + 1, d))
    buf[flat_ids, torch.where(r.keep, r.positions, cap)] = tok_rep
    buf = buf[:, :cap]
    h = (F.silu(torch.bmm(buf, params["w_gate"].to(dt)))
         * torch.bmm(buf, params["w_up"].to(dt)))
    out_buf = torch.bmm(h, params["w_down"].to(dt))           # (E, C, D)
    safe_pos = torch.where(r.keep, r.positions, 0)
    gathered = torch.where(r.keep[:, None], out_buf[flat_ids, safe_pos], 0)
    y = (gathered.reshape(b * s, k, d) * r.gate_vals[..., None].to(dt)
         ).sum(dim=1)
    if m.num_shared:
        sh = params["shared"]
        y = y + _swiglu(tokens, sh["w_gate"].to(dt), sh["w_up"].to(dt),
                        sh["w_down"].to(dt))
    return y.reshape(b, s, d), r.aux.float()
