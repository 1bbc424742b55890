"""Gradient compression with error feedback.

Port of ``repro/distributed/compression.py``: gradients are quantized and
dequantized after the reduction over the ranks, where the reference's
data-parallel all-reduce would carry them in the compressed dtype, so a
run sees what the compressed all-reduce would give it.

* ``"bf16"``: each gradient rounded to bf16 and back;
* ``"int8"``: symmetric scaling to int8, one scale per array of the
  reference's tree, with error feedback: the quantization residual is
  carried into the next step's gradient.

Across ranks under ``fsdp`` (``shard``) each rank compresses its blocks
of the reduced gradient: int8 takes each scale's absmax over every
rank's blocks (one all-reduce of the scales' maxima, kind
``all_reduce_max``), so the scale is the global gradient's; the error
feedback stays a rank's, block by block. The wire still carries fp32
(the reference's wire format is described, not run, there too).
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves_with_paths, tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def apply_compression(grads, err, mode: str | None, group_of=None):
    """Returns (the gradients as the all-reduce would see them, the new
    error feedback), new trees of ``grads``' and ``err``'s shapes."""
    if mode is None or mode == "none":
        return grads, err
    grads = tree_map(torch.clone, grads)
    err = None if err is None else tree_map(torch.clone, err)
    apply_compression_(grads, err, mode, group_of)
    return grads, err


def global_absmax(amax: torch.Tensor, shard) -> torch.Tensor:
    """Each group's absmax (a vector, one entry a group) over the ranks'
    blocks: the maxima all-reduced once (kind ``all_reduce_max``); as it
    is on one process."""
    return amax if shard is None else shard.all_reduce(
        amax, "all_reduce_max", op="max")


def compress_bf16(grads):
    return apply_compression(grads, None, "bf16")[0]


def compress_int8_with_feedback(grads, err, group_of=None):
    return apply_compression(grads, err, "int8", group_of)


@torch.no_grad()
def apply_compression_(grads, err, mode: str | None, group_of=None,
                       shard=None):
    """``apply_compression`` written into the tensors of ``grads`` and
    ``err`` (one leaf's temporaries at a time).

    int8 scales each group of leaves by its absmax over the group (of
    g + err): ``group_of(path)`` names a leaf's group, by default the leaf
    itself. The reference scales each array of its tree, and stacks the
    layers at one position of its repeating unit into one array;
    ``weights.reference_leaf`` groups the port's layers the same way.
    With ``shard`` the leaves are a rank's blocks and the absmax is taken
    over every rank's (``global_absmax``)."""
    if mode is None or mode == "none":
        return
    if mode not in ("bf16", "int8"):
        raise ValueError(mode)
    leaves = leaves_with_paths(grads)
    if mode == "bf16":
        for _, g in leaves:
            g.copy_(g.to(torch.bfloat16))
        return
    errs = dict(leaves_with_paths(err))
    groups: dict = {}
    for path, g in leaves:
        key = path if group_of is None else group_of(path)
        groups.setdefault(key, []).append((g, errs[path]))
    amaxes = global_absmax(torch.stack([
        torch.stack([(g.float() + e).abs().max() for g, e in members]).max()
        for members in groups.values()]), shard)
    for members, amax in zip(groups.values(), amaxes):
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for g, e in members:
            g32 = g.float() + e
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(
                torch.int8)
            deq = q.float() * scale
            g.copy_(deq)
            e.copy_(g32 - deq)
