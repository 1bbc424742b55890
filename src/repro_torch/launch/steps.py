"""Step builders: a training step, a prefill step and a decode step, and
the distribution policy of a cell.

Port of the step functions and ``choose_policy`` of
``repro/launch/steps.py``. The prefill and decode steps run on one card,
or on a rank of a group under ``distributed/ctx.sharding_policy`` with
the policy ``choose_policy`` names (``launch/dryrun.run_cell``). The
reference's abstract input specs (``abstract_params``, ``batch_sds``,
``abstract_cache``, ``cell_lowering_inputs``) lower its steps onto XLA
meshes; the port runs a cell on real tensors instead.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.compression import apply_compression_
from repro_torch.models.api import Model
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import reference_leaf


def make_train_step(model: Model, opt_cfg: OptConfig,
                    compression: str | None = None, grad_accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and gradients of the batch (as ``grad_accum``
    contiguous microbatches, losses and gradients summed and then scaled
    by 1 / grad_accum, as the reference's scan over its reshaped batch),
    the gradients compressed (``"bf16"``, or ``"int8"`` with the error
    feedback in ``opt_state["err"]`` and one scale over the layers the
    reference stacks in one array), then one AdamW step.

    The parameters are fp32 leaf tensors, updated in place; the step
    sets their ``requires_grad`` and leaves it set, so a ``"kernel"``
    forward on them afterwards runs under ``torch.no_grad()``. The
    metrics (``loss``, ``grad_norm``, ``lr``) are fp32 tensors on the
    device."""
    if compression not in (None, "none", "bf16", "int8"):
        raise ValueError(f"unknown compression {compression!r}")
    cfg = model.cfg

    def group_of(path: str) -> str:
        # int8 shares a scale over the layers the reference stacks
        return reference_leaf(path, cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        n = batch["tokens"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} does not split into {grad_accum} "
                             "microbatches")
        m = n // grad_accum
        loss = None
        for i in range(grad_accum):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            mb_loss = model.loss_fn(params, mb)
            mb_loss.backward()      # sums into each parameter's .grad
            loss = mb_loss.detach() if loss is None \
                else loss + mb_loss.detach()
        with torch.no_grad():
            for p in leaves:
                if p.grad is None:      # a parameter the loss never read
                    p.grad = torch.zeros_like(p)
                elif grad_accum > 1:
                    p.grad.mul_(1.0 / grad_accum)
        if grad_accum > 1:
            loss = loss * (1.0 / grad_accum)
        grads = tree_map(lambda p: p.grad, params)
        err = opt_state["err"] if compression == "int8" else None
        apply_compression_(grads, err, compression, group_of)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        for p in leaves:
            p.grad = None
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


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
