"""Which dim of each cache tensor a shard group splits, and a rank's
slice of a cache.

Port of ``cache_specs`` and ``fit_spec``'s rule from
``repro/distributed/sharding.py``, over the port's cache trees
(``cache["layers"][i]`` with ``k``, ``v`` and, on int8 caches,
``k_scale``, ``v_scale``; recurrent states ``conv``, ``state``, ``rnn``).
The reference names mesh axes in a ``PartitionSpec``; the port has one
shard group, so a leaf's spec is the one dim the group splits, or None
for a leaf every rank holds whole. Parameter, optimizer and batch specs
come with multi-GPU training.
"""

from __future__ import annotations

import re

import torch

from repro_torch.tree import tree_map

# (leaf-name pattern, the dim the group splits) by layout; first match
# wins, no match: whole on every rank.
_DENSE = (
    (r"^(k|v|mem_k|mem_v)$", 2),   # (B, Hkv, S, E): sequence-sharded
    (r"^conv$", 2),                # (B, K, C): channels
    (r"^rnn$", 1),                 # (B, W)
    (r"^state$", 1),               # (B, H, P, N): SSD heads
)
# The serving engine's pools (Hkv, P, page, E) and their int8 scales
# (Hkv, P) split on the KV-head axis: a page holds every head's rows for
# its token span, so the head axis is the only one that keeps page
# identity the same on every rank.
_PAGED = (
    (r"^(k|v)$", 0),
    (r"^(k|v)_scale$", 0),
)
LAYOUTS = {"dense": _DENSE, "paged": _PAGED}


def fit_dim(dim: int | None, shape, degree: int | None) -> int | None:
    """``dim``, or None when ``degree`` does not divide ``shape[dim]``
    (the reference's ``fit_spec``: such a dim stays whole)."""
    if dim is None or dim >= len(shape):
        return None
    if degree is not None and shape[dim] % degree:
        return None
    return dim


def cache_specs(cache: dict, *, layout: str = "dense",
                degree: int | None = None) -> dict:
    """A tree shaped like ``cache`` holding, for each tensor, the dim a
    shard group of ``degree`` ranks splits (None: whole on every rank).

    ``layout="dense"``: the wave caches (B, Hkv, S, E), sequence-sharded,
    and the recurrent states; ``layout="paged"``: the continuous engine's
    pools, KV-head-sharded with their scales. The two layouts cannot be
    told apart by shape, hence the argument. Without ``degree`` no dim is
    dropped for not dividing.
    """
    rules = LAYOUTS[layout]

    def spec(name: str, leaf: torch.Tensor) -> int | None:
        for pattern, dim in rules:
            if re.search(pattern, name):
                return fit_dim(dim, leaf.shape, degree)
        return None

    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, name) for v in node]
        return spec(name, node)

    return visit(cache)


def local_cache(cache: dict, *, rank: int, degree: int,
                layout: str = "paged", device=None) -> dict:
    """Rank ``rank``'s slice of ``cache`` over a group of ``degree``: each
    tensor cut along its ``cache_specs`` dim to the rank's block (whole
    where it has none). A cache on the meta device (shapes only, as
    ``make_cache(device="meta")`` builds it) becomes zeros on ``device``,
    which is how every cache starts, so the full cache is never
    allocated; a real one is copied."""
    if not 0 <= rank < degree:
        raise ValueError(f"rank {rank} is not in a group of {degree}")
    specs = cache_specs(cache, layout=layout, degree=degree)

    def cut(leaf: torch.Tensor, dim: int | None) -> torch.Tensor:
        if dim is not None:
            per = leaf.shape[dim] // degree
            leaf = leaf.narrow(dim, rank * per, per)
        dev = leaf.device if device is None else torch.device(device)
        if leaf.is_meta:
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=dev)
        return leaf.to(dev, copy=True).contiguous()

    return tree_map(cut, cache, specs)
