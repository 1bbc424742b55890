"""Which dim of each parameter, optimizer, batch and cache tensor a
shard group splits, and a rank's slice of a cache or of the parameters.

Port of ``param_specs``, ``opt_specs``, ``batch_specs``, ``cache_specs``
and ``fit_spec``'s rule from ``repro/distributed/sharding.py``, over the
port's trees (``params["layers"][i]``, unstacked; ``cache["layers"][i]``
with ``k``, ``v`` and, on int8 caches, ``k_scale``, ``v_scale``;
recurrent states ``conv``, ``state``, ``rnn``). The reference names mesh
axes in a ``PartitionSpec``; the port has one shard group, the
reference's ``'model'`` axis, and no data or pod axis, so a leaf's spec
is the one dim the group splits, or None for a leaf every rank holds
whole (a rule's ``'data'`` entries drop out, as ``fit_spec`` drops axes
a mesh lacks).

What acts: the dense layout under ``ctx.sharding_policy``
(``models/transformer.rank_cache``): the K/V sequence split (a window's
ring by slot) and the recurrent states by conv channel, SSD head and
RG-LRU width, a leaf whose dim the degree does not divide whole on every
rank by ``fit_spec``'s rule; and ``local_params``:
under ``sp_rep`` every weight whole but the MoE experts, split over the
ranks; under ``tp_sp`` every leaf cut along its fitted tensor-parallel
dim, which is what a rank holds at rest (and trains under ``tp_sp``);
under ``fsdp`` (training) dim 0 of every matrix. ``local_opt_state``
cuts AdamW's moments and the int8 error feedback as their parameters
under either training policy. The sequence route gathers a layer's split
leaves whole just before the layer (``split_specs``,
``ctx.SeqShard.gather_weights``); so does training
(``ctx.gather_split``: under ``fsdp`` with ``split_specs(..., "fsdp")``,
under ``tp_sp`` with ``split_specs``, the experts staying the rank's).
``fsdp_blocks`` and ``tp_sp_blocks`` name each leaf's block for the
sharded checkpoints (``checkpoint/manager.py``); ``held_blocks`` tells a
rank's blocks from its whole leaves (the train step's reductions and
its global norm).

One departure from the reference's rules (ROADMAP C17): its ``embed$``
comes first and also matches ``unembed``, so an untied (D, V)
unembedding takes the embedding's spec and splits its D rows; here
``unembed$`` comes first and splits the vocabulary columns, as the rule
written for it says.
"""

from __future__ import annotations

import functools
import re

import torch

from repro_torch.distributed.ctx import POLICIES
from repro_torch.tree import tree_map, tree_map_with_path

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


# (path pattern, axis names by dim), the reference's _PARAM_RULES; first
# match wins ("unembed$" ahead of "embed$", which also matches it: C17)
_PARAM_RULES = (
    (r"unembed$", (None, "model")),
    (r"embed$", ("model", None)),
    (r"(^|/)w(q|k|v)$", ("data", "model")),
    (r"(^|/)wo$", ("model", "data")),
    (r"ffn/(w_gate|w_up)$", ("data", "model")),
    (r"ffn/w_down$", ("model", "data")),
    (r"shared/(w_gate|w_up)$", ("data", "model")),
    (r"shared/w_down$", ("model", "data")),
    (r"router$", (None, None)),
    (r"ssd/w_in$", ("data", "model")),
    (r"ssd/w_out$", ("model", "data")),
    (r"rec/w_(x|gate|i|r)$", ("data", "model")),
    (r"rec/w_out$", ("model", "data")),
)


def _is_expert(path: str, leaf) -> bool:
    """A routed expert stack (E, D, F) / (E, F, D)."""
    return bool(re.search(r"ffn/w_(gate|up|down)$", path)) and leaf.ndim == 3


def param_spec(path: str, ndim: int, *, is_moe_expert: bool) -> tuple:
    """The reference's ``param_spec``: axis names by dim under ``tp_sp``
    (experts over 'model', d_model over 'data'; then the first rule that
    matches ``path``, ``unembed`` by its own rule (C17); none: whole)."""
    if is_moe_expert:
        spec = (("model", "data", None) if re.search(r"w_(gate|up)$", path)
                else ("model", None, "data"))
        return spec[:ndim]
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            return spec[-ndim:] if ndim < len(spec) else spec
    return ()


def _group_dim(spec: tuple, shape, degree: int | None) -> int | None:
    """The dim of ``spec`` that names 'model', fitted (``fit_dim``)."""
    for dim, axes in enumerate(spec):
        names = (axes,) if isinstance(axes, str) else (axes or ())
        if "model" in names:
            return fit_dim(dim, shape, degree)
    return None


def param_specs(params: dict, *, policy: str = "tp_sp",
                degree: int | None = None) -> dict:
    """A tree shaped like ``params`` holding the dim the group splits in
    each tensor (None: whole), the reference's ``param_specs`` with the
    group as its 'model' axis. ``tp_sp``: the tensor-parallel rules and
    the experts over the group; ``sp_rep``: every weight whole (forward
    serving of weights that fit); ``fsdp``: every matrix's first dim.
    With ``degree`` a dim it does not divide stays whole."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")

    def spec(path: str, leaf) -> int | None:
        if policy == "sp_rep":
            return None
        if policy == "fsdp":
            return fit_dim(0, leaf.shape, degree) if leaf.ndim >= 2 else None
        return _group_dim(param_spec(path, leaf.ndim,
                                     is_moe_expert=_is_expert(path, leaf)),
                          leaf.shape, degree)

    return tree_map_with_path(spec, params)


def opt_specs(p_specs: dict) -> dict:
    """AdamW's moments split as their parameters; the step whole."""
    return {"mu": p_specs, "nu": p_specs, "step": None}


def batch_specs(*, policy: str = "tp_sp", batch: int | None = None,
                degree: int | None = None, with_frontend: bool = False
                ) -> dict:
    """The dim of each batch tensor the group splits. The reference
    splits the batch over its data and pod axes, which the port has not,
    so the batch is whole, except under ``fsdp``, where (as the
    reference's ``batch_sds``) the batch widens over the group when the
    degree divides ``batch``."""
    dim = None
    if policy == "fsdp" and (batch is None or degree is None
                             or batch % degree == 0):
        dim = 0
    out = {"tokens": dim, "labels": dim}
    if with_frontend:
        out["frontend"] = dim
    return out


def local_params(params: dict, *, rank: int, degree: int,
                 policy: str = "sp_rep", in_place: bool = False) -> dict:
    """Rank ``rank``'s parameters under the sharding ``policy``.

    ``sp_rep``: every weight whole (the same tensors) but each MoE layer's
    routed experts, [r·E/n, (r+1)·E/n) copied out. ``tp_sp``: every leaf
    cut to the rank's block along its fitted ``param_specs`` dim (a dim
    the degree does not divide stays whole), the experts as under
    ``sp_rep``. ``fsdp``: every leaf of two or more dims cut to the rank's
    block of dim 0 where the degree divides it, the rest whole. With
    ``in_place`` the blocks replace the leaves in ``params`` itself, each
    whole leaf released as its block is copied, so a whole tree drawn on
    the device never lives beside its cut."""
    if not 0 <= rank < degree:
        raise ValueError(f"rank {rank} is not in a group of {degree}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    dims = param_specs(params, policy="fsdp" if policy == "fsdp"
                       else "tp_sp", degree=degree)

    def cut(path: str, leaf, dim):
        expert = policy != "fsdp" and _is_expert(path, leaf)
        if expert and leaf.shape[0] % degree:
            raise ValueError(f"{leaf.shape[0]} experts do not split over "
                             f"{degree} ranks")
        if dim is None or not (expert or policy != "sp_rep"):
            return leaf
        per = leaf.shape[dim] // degree
        return leaf.narrow(dim, rank * per, per).clone()

    def visit(node, spec, prefix: str):
        out = node if in_place else type(node)(node)
        keys = node.keys() if isinstance(node, dict) else range(len(node))
        for k in keys:
            path = f"{prefix}{k}"
            if isinstance(node[k], (dict, list)):
                out[k] = visit(node[k], spec[k], path + "/")
            else:
                out[k] = cut(path, node[k], spec[k])
        return out

    return visit(params, dims, "")


def local_opt_state(opt_state: dict, *, rank: int, degree: int,
                    policy: str = "fsdp", in_place: bool = False) -> dict:
    """Rank ``rank``'s part of AdamW's state (``opt_specs``) under the
    training ``policy`` (``fsdp`` or ``tp_sp``): ``mu``, ``nu`` and the
    int8 error feedback ``err`` cut as ``local_params(policy=policy)``
    cuts their parameters, ``step`` whole."""
    if policy not in ("fsdp", "tp_sp"):
        raise ValueError(f"{policy!r} is no training policy")
    out = opt_state if in_place else dict(opt_state)
    for key in ("mu", "nu", "err"):
        if key in opt_state:
            out[key] = local_params(opt_state[key], rank=rank, degree=degree,
                                    policy=policy, in_place=in_place)
    return out


def fsdp_blocks(tree, *, rank: int, degree: int):
    """A tree shaped like ``tree`` (whole shapes: a whole tree, or one on
    the meta device) holding, for each leaf ``fsdp`` splits over
    ``degree`` ranks, (0, rank, degree): rank ``rank`` holds its block of
    dim 0; None for a leaf every rank holds whole. ``CheckpointManager``
    reads it as ``shardings``."""
    return tree_map(lambda leaf: None if fit_dim(
        0 if leaf.dim() >= 2 else None, leaf.shape, degree) is None
        else (0, rank, degree), tree)


def tp_sp_blocks(tree, *, rank: int, degree: int):
    """``fsdp_blocks``' counterpart under ``tp_sp``: for each leaf of
    ``tree`` (whole shapes; a params tree, or a state tree whose leaves'
    paths end as their parameters', ``{"params", "opt": {"mu", ...}}``)
    that ``local_params(policy="tp_sp")`` cuts over ``degree`` ranks,
    (dim, rank, degree) with dim its fitted tensor-parallel dim, the
    routed experts on dim 0; None for a leaf every rank holds whole."""
    dims = param_specs(tree, policy="tp_sp", degree=degree)
    return tree_map(lambda d: None if d is None else (d, rank, degree),
                    dims)


@functools.lru_cache(maxsize=None)
def whole_shapes(cfg) -> dict:
    """{path: shape} of ``cfg``'s whole parameters (``init`` on the meta
    device)."""
    from repro_torch.models.transformer import init
    from repro_torch.tree import leaves_with_paths

    return {p: tuple(t.shape) for p, t in leaves_with_paths(
        init(cfg, device="meta"))}


def held_blocks(params, cfg) -> dict:
    """A tree shaped like ``params`` (a rank's training parameters):
    true for a leaf the rank holds a block of (its shape is not the whole
    leaf's: an ``fsdp`` or ``tp_sp`` block, or the rank's experts), false
    for a leaf every rank holds whole."""
    shapes = whole_shapes(cfg)
    return tree_map_with_path(
        lambda path, leaf: tuple(leaf.shape) != shapes[path], params)


@functools.lru_cache(maxsize=None)
def split_specs(cfg, degree: int, policy: str = "tp_sp") -> dict:
    """A tree shaped like ``cfg``'s parameters holding, for each leaf that
    ``policy`` splits over ``degree`` ranks and its route gathers on use,
    (dim, whole size); None for a leaf held whole (under ``tp_sp`` the
    experts too: their route exchanges tokens, not weights). ``tp_sp``:
    the sequence route; ``fsdp``: training, dim 0 of every matrix. From
    the shapes of ``init`` on the meta device."""
    from repro_torch.models.transformer import init

    shapes = init(cfg, device="meta")
    dims = param_specs(shapes, policy=policy, degree=degree)

    def visit(node, spec, prefix: str):
        if isinstance(node, dict):
            return {k: visit(v, spec[k], f"{prefix}{k}/")
                    for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, spec[i], f"{prefix}{i}/")
                    for i, v in enumerate(node)]
        if spec is None or (policy == "tp_sp"
                            and _is_expert(prefix[:-1], node)):
            return None
        return spec, node.shape[spec]

    return visit(shapes, dims, "")


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
