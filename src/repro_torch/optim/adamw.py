"""AdamW with a cosine schedule and global-norm clipping.

Port of ``repro/optim/adamw.py``: the same arithmetic in the same order,
in fp32. The reference returns new trees; here ``adamw_update`` writes
the new parameters and moments into the given tensors (no grad), which
saves a copy of each at full width, and returns them. Under ``fsdp`` it
runs on a rank's blocks (every step elementwise); only the clipping norm
is global (``global_norm(..., shard=, split=)``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio * lr`` at ``total_steps``, flat after it. ``step`` an
    int or a tensor; returns an fp32 tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                        - cfg.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Zero moments in fp32 beside each parameter, and step 0 (int32)."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _squares(leaves) -> torch.Tensor:
    return sum(x.float().square().sum() for x in leaves)


def global_norm(tree, *, shard=None, split=None) -> torch.Tensor:
    """sqrt of the sum over leaves of their fp32 sums of squares, the
    leaves added in turn. Across ranks (``shard``, a ``ctx.SeqShard``;
    ``split`` a tree of bools shaped like ``tree``, true for a leaf each
    rank holds a block of): the split leaves' sum all-reduced over the
    group, the whole leaves, the same on every rank, counted once."""
    if shard is None:
        return torch.sqrt(_squares(tree_leaves(tree)))
    parts = list(zip(tree_leaves(tree), tree_leaves(split)))
    mine = _squares([x for x, s in parts if s]) + torch.zeros(
        (), device=tree_leaves(tree)[0].device)
    return torch.sqrt(shard.all_reduce(mine, "all_reduce")
                      + _squares([x for x, s in parts if not s]))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig, *, shard=None,
                 split=None):
    """One AdamW step on clipped gradients. Writes the new parameters
    (in their own dtype) and moments in place; returns (params, new
    opt_state, {"grad_norm", "lr"} fp32 tensors). Across ranks the
    leaves are the rank's blocks and whole leaves (``global_norm``'s
    ``shard`` and ``split``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, shard=shard, split=split)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    b1, b2 = cfg.b1, cfg.b2
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    new_opt = {**opt_state, "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr}
