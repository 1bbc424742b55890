"""Step builders: a training step, a prefill step and a decode step, and
the distribution policy of a cell.

Port of the step functions and ``choose_policy`` of
``repro/launch/steps.py``. The train step runs on one card, or on a rank
of a group under ``sharding_policy(shard, "fsdp")`` or ``"tp_sp"`` (the
reference's train cells, by ``choose_policy``); the prefill and decode
steps on one card, or on a rank under the policy ``choose_policy`` names
(``launch/dryrun.run_cell``).

The reference's abstract input specs, under its names: each argument of
a cell's step as shapes and dtypes on the meta device, with no memory
allocated (the reference's ``jax.eval_shape``), whole and as one rank of
a group of ``degree`` holds it (``AbstractArg``; the reference's
``ShapeDtypeStruct`` with its ``NamedSharding`` on a ``(1, degree)``
mesh). ``launch/dryrun.abstract_cell`` sums a rank's bytes from them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.distributed import compression as comp
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import SeqShard
from repro_torch.distributed.sharding import (
    batch_specs,
    held_blocks,
    local_opt_state,
    local_params,
    param_specs,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.api import Model, build_model
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import reference_leaf


def token_denominators(labels: torch.Tensor, grad_accum: int,
                       shard) -> torch.Tensor:
    """(B,) fp32, for each of a rank's B rows the count of unmasked labels
    (>= 0) in its microbatch of the global batch, the ranks' rows
    concatenated in rank order and cut in ``grad_accum`` contiguous
    microbatches (the reference's reshape of its batch), at least 1: the
    rank's counts by microbatch, all-reduced once."""
    b = labels.shape[0]
    rows = torch.arange(b, device=labels.device) + shard.rank * b
    mb = rows // (b * shard.degree // grad_accum)
    counts = torch.zeros(grad_accum, dtype=torch.float32,
                         device=labels.device).index_add_(
        0, mb, (labels >= 0).sum(-1).float())
    counts = shard.all_reduce(counts, "all_reduce")
    return torch.clamp(counts, min=1.0)[mb]


def _sum_whole_grads(leaves, split, shard) -> None:
    """The gradients of the leaves every rank holds whole, summed over the
    ranks in one all-reduce of their concatenation (kind
    ``all_reduce``)."""
    whole = [p for p, s in zip(leaves, split) if not s]
    if shard.degree == 1 or not whole:
        return
    flat = shard.all_reduce(torch.cat([p.grad.reshape(-1) for p in whole]),
                            "all_reduce")
    at = 0
    for p in whole:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
        at += p.numel()


def make_loss_and_grads(model: Model, grad_accum: int = 1):
    """``(params, batch) -> (loss, grads)``: the batch's loss (fp32, no
    grad) and a tree of its gradients, as ``grad_accum`` contiguous
    microbatches, losses and gradients summed and then scaled by
    1 / grad_accum, as the reference's scan over its reshaped batch. The
    gradients are each parameter's ``.grad`` (zeros for a parameter the
    loss never read), which the caller clears.

    Under ``fsdp`` the batch is the rank's rows and the parameters its
    blocks (``sharding.local_params(policy="fsdp")``): each microbatch's
    loss divides by its global count of labels (``token_denominators``),
    each gathered weight's gradient is reduce-scattered into the rank's
    block in the backward (``ctx.GatherLeaf``) and summed over the
    microbatches there. Under ``tp_sp`` the batch is whole on every rank
    and the parameters its ``local_params(policy="tp_sp")`` split: the
    loss is the rank's term (``Model.loss_fn``), a split leaf's gradient
    arrives reduce-scattered and the rank's experts' complete (the
    all-to-all's backward brings every group's part). Under either the
    gradients of the leaves every rank holds whole are all-reduced once
    after the last microbatch, zeros included (no rank skips a
    collective), and the loss is the ranks' losses all-reduced."""
    def loss_and_grads(params, batch):
        shard, kind = ctx.train_shard()
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        n = batch["tokens"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} does not split into {grad_accum} "
                             "microbatches")
        m = n // grad_accum
        denom = None if kind != "fsdp" else token_denominators(
            batch["labels"], grad_accum, shard)
        loss = None
        for i in range(grad_accum):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            mb_loss = model.loss_fn(params, mb) if denom is None else \
                model.loss_fn(params, mb, denom=denom[i * m:(i + 1) * m])
            mb_loss.backward()      # sums into each parameter's .grad
            loss = mb_loss.detach() if loss is None \
                else loss + mb_loss.detach()
        with torch.no_grad():
            for p in leaves:
                if p.grad is None:      # a parameter the loss never read
                    p.grad = torch.zeros_like(p)
            if shard is not None:
                _sum_whole_grads(leaves, tree_leaves(
                    held_blocks(params, model.cfg)), shard)
                loss = shard.all_reduce(loss, "all_reduce")
            if grad_accum > 1:
                for p in leaves:
                    p.grad.mul_(1.0 / grad_accum)
                loss = loss * (1.0 / grad_accum)
        return loss, tree_map(lambda p: p.grad, params)

    return loss_and_grads


def make_train_step(model: Model, opt_cfg: OptConfig,
                    compression: str | None = None, grad_accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and gradients of the batch
    (``make_loss_and_grads``), the gradients compressed (``"bf16"``, or
    ``"int8"`` with the error feedback in ``opt_state["err"]`` and one
    scale over the layers the reference stacks in one array), then one
    AdamW step.

    The parameters are fp32 leaf tensors, updated in place; the step
    sets their ``requires_grad`` and leaves it set, so a ``"kernel"``
    forward on them afterwards runs under ``torch.no_grad()``. The
    metrics (``loss``, ``grad_norm``, ``lr``) are fp32 tensors on the
    device.

    Under ``sharding_policy(shard, "fsdp")`` or ``"tp_sp"`` the step
    works on the rank's blocks of the parameters and of the optimizer
    state (``sharding.local_opt_state(policy=)``): the gradients are the
    global batch's, reduced over the ranks before compression (int8's
    scales over every rank's blocks), the clipping norm is global (the
    rank's blocks, experts included, summed over the ranks, the whole
    leaves once: ``sharding.held_blocks``), and AdamW runs on the blocks.
    Every rank returns the same metrics."""
    if compression not in (None, "none", "bf16", "int8"):
        raise ValueError(f"unknown compression {compression!r}")
    cfg = model.cfg
    loss_and_grads = make_loss_and_grads(model, grad_accum)

    def group_of(path: str) -> str:
        # int8 shares a scale over the layers the reference stacks
        return reference_leaf(path, cfg)

    def train_step(params, opt_state, batch):
        shard, _ = ctx.train_shard()
        loss, grads = loss_and_grads(params, batch)
        err = opt_state["err"] if compression == "int8" else None
        comp.apply_compression_(grads, err, compression, group_of, shard)
        split = None if shard is None else held_blocks(params, cfg)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg, shard=shard,
                                                  split=split)
        for p in tree_leaves(params):
            p.grad = None
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def train_cfg(cfg):
    """``cfg`` as a train step runs it: the ``"kernel"`` route, which has
    no backward, on ``"chunked"`` attention."""
    if cfg.attn_impl == "kernel":
        return dataclasses.replace(cfg, attn_impl="chunked")
    return cfg


def choose_policy(cfg, cell) -> str:
    """The reference's distribution policy of an (arch, cell): a prefill
    replicates weights (``sp_rep``) when the model is dense and its bf16
    weights fit in 8 GB, else ``tp_sp``; decode is ``tp_sp`` (the cache
    sequence-sharded); a train cell is ``tp_sp`` for MoE (experts over the
    group) or an odd global batch, else ``fsdp``."""
    if cell.kind == "prefill":
        if cfg.moe is None and cfg.param_count() * 2 <= 8e9:
            return "sp_rep"
        return "tp_sp"
    if cell.kind != "train":
        return "tp_sp"
    if cfg.moe is not None or cell.global_batch % 2:
        return "tp_sp"
    return "fsdp"


def make_prefill_step(model: Model, max_len: int):
    """``(params, batch) -> (last_logits, cache)``: ``batch["tokens"]``,
    and ``batch["frontend"]`` as patch embeddings before the tokens
    (vision) or frames the encoder runs first (audio). Under the sharding
    policy ``encode`` and ``prefill`` take the rank's rows themselves."""
    cfg = model.cfg

    def prefill_step(params, batch):
        kwargs = {}
        if cfg.frontend == "vision":
            kwargs["frontend_embeds"] = batch["frontend"]
        if cfg.encoder_layers:
            kwargs["encoder_out"] = model.encode(params, batch["frontend"])
        return model.prefill(params, cfg, batch["tokens"], max_len, **kwargs)

    return prefill_step


def make_decode_step(model: Model):
    cfg = model.cfg

    def decode_step(params, cache, token, pos):
        return model.decode_step(params, cfg, token, cache, pos)

    return decode_step


# ---------------------------------------------------------------------------
# abstract specs
# ---------------------------------------------------------------------------


class AbstractArg(NamedTuple):
    """One argument of a cell's step, on the meta device: ``whole``, the
    global tree (the reference's shapes and dtypes), and ``rank``, the
    block of it that one rank of the group holds (the reference's shard
    shapes; every rank's are the same)."""

    whole: Any
    rank: Any


def _cut(tree: dict, specs: dict, degree: int) -> dict:
    """Rank 0's block of each leaf of ``tree`` along its ``specs`` dim
    (None: whole)."""
    return {k: v if specs[k] is None else
            v.narrow(specs[k], 0, v.shape[specs[k]] // degree)
            for k, v in tree.items()}


def abstract_params(model: Model, degree: int, policy: str = "tp_sp"
                    ) -> tuple:
    """(the whole parameter tree on the meta device, its
    ``sharding.param_specs`` over ``degree`` ranks under ``policy``)."""
    params = model.init(device="meta")
    return params, param_specs(params, policy=policy, degree=degree)


def abstract_opt_state(params) -> dict:
    """AdamW's state for ``params`` (a meta tree): ``mu`` and ``nu`` like
    the parameters, ``step`` an int32 scalar."""
    def like(p):
        return torch.empty(p.shape, dtype=p.dtype, device="meta")

    return {"mu": tree_map(like, params), "nu": tree_map(like, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def batch_sds(cfg, cell, degree: int, *, kind: str, policy: str = "tp_sp"
              ) -> tuple:
    """(a train or prefill cell's batch on the meta device, the dim each
    tensor splits over ``degree`` ranks): int32 ``tokens`` (and
    ``labels`` for a train step) of the cell's batch and length, an
    audio or vision stack's fp32 ``frontend`` rows (B, F, D), whose F
    patch rows count toward a vision cell's length. Under ``fsdp`` the
    batch splits over the group where the degree divides it
    (``sharding.batch_specs``)."""
    b, s = cell.global_batch, cell.seq_len
    f = cfg.num_frontend_tokens
    if cfg.frontend == "vision":
        s -= f

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {"tokens": meta(b, s)}
    if cfg.frontend is not None:
        out["frontend"] = meta(b, f, cfg.d_model, dtype=torch.float32)
    if kind == "train":
        out["labels"] = meta(b, s)
    specs = batch_specs(policy=policy, batch=b, degree=degree,
                        with_frontend=cfg.frontend is not None)
    return out, {k: specs[k] for k in out}


def abstract_cache(model: Model, cell, degree: int) -> dict:
    """The decode cache one rank of ``degree`` holds, on the meta device
    (``transformer.rank_cache``): the cell's batch and length, an
    encoder-decoder's cross memories of F rows."""
    cfg = model.cfg
    mem_len = cfg.num_frontend_tokens if cfg.encoder_layers else 0
    return tfm.rank_cache(cfg, cell.global_batch, cell.seq_len,
                          SeqShard(None, 0, degree), device="meta",
                          mem_len=mem_len)


def cell_lowering_inputs(arch, cell, degree: int,
                         opt_cfg: OptConfig | None = None) -> tuple:
    """(step, args, donate, policy) of ``arch`` (an id or an
    ``ArchConfig``) at ``cell`` over ``degree`` ranks: the step of the
    cell's kind, each of its arguments an ``AbstractArg``, the indices of
    the arguments the step updates in place (the reference's
    ``donate_argnums``: a train step's parameters and optimizer state,
    whose int32 step count it returns anew, a decode step's cache) and
    ``choose_policy``'s policy. A train step
    runs ``train_cfg``'s route; its parameters and state are the rank's
    ``local_params`` and ``local_opt_state`` under the policy. A decode
    step's ``token`` is int32 (B, 1) and its ``pos`` an int32 scalar, as
    the reference's; the port's step takes ``pos`` as a host int."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch) if isinstance(arch, str) else arch
    policy = choose_policy(cfg, cell)
    if cell.kind == "train":
        cfg = train_cfg(cfg)
    model = build_model(cfg)
    whole, _ = abstract_params(model, degree, policy)
    params = AbstractArg(whole, local_params(whole, rank=0, degree=degree,
                                             policy=policy))
    if cell.kind in ("train", "prefill"):
        batch, specs = batch_sds(cfg, cell, degree, kind=cell.kind,
                                 policy=policy)
        batch = AbstractArg(batch, _cut(batch, specs, degree))
    if cell.kind == "train":
        opt = abstract_opt_state(whole)
        opt = AbstractArg(opt, local_opt_state(opt, rank=0, degree=degree,
                                               policy=policy))
        step = make_train_step(model, opt_cfg or OptConfig())
        return step, (params, opt, batch), (0, 1), policy
    if cell.kind == "prefill":
        return (make_prefill_step(model, max_len=cell.seq_len),
                (params, batch), (), policy)
    mem_len = cfg.num_frontend_tokens if cfg.encoder_layers else 0
    cache = AbstractArg(tfm.make_cache(cfg, cell.global_batch, cell.seq_len,
                                       device="meta", mem_len=mem_len),
                        abstract_cache(model, cell, degree))
    token = torch.empty((cell.global_batch, 1), dtype=torch.int32,
                        device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return (make_decode_step(model),
            (params, cache, AbstractArg(token, token), AbstractArg(pos, pos)),
            (1,), policy)


def argument_bytes(args) -> list[int]:
    """Each argument's bytes on one rank (its ``rank`` tree's leaves)."""
    return [sum(t.numel() * t.element_size() for t in tree_leaves(a.rank)
                if isinstance(t, torch.Tensor))      # not a cache's flags
            for a in args]
