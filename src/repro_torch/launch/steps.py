"""Step builders: a training step, a prefill step and a decode step.

Port of the step functions of ``repro/launch/steps.py`` for one device.
The reference's abstract input specs (``choose_policy``,
``abstract_params``, ``batch_sds``, ``abstract_cache``,
``cell_lowering_inputs``) lower its steps onto XLA meshes; their
counterpart comes with multi-GPU training.
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


def make_prefill_step(model: Model, max_len: int):
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
