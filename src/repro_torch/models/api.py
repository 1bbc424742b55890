"""Public model API: ``build_model(cfg) -> Model`` with plain functions.

Port of ``repro/models/api.py`` for the dense and the MoE decoders with
their dense or paged cache, either of them int8 (``kv_dtype``), for
the SSM family (mamba2) with its conv and SSD states, for the hybrid
family (recurrentgemma) with its RG-LRU states and windowed ring caches,
for the vision-frontend family (internvl2: stub patch embeddings before
the tokens) and for the encoder-decoder (whisper: ``Model.encode`` and
cross memories in the dense cache). The paged functions refuse the SSM,
the hybrid and the encoder-decoder. ``Model.init(seed=...,
device=...)`` draws the port's own seeded weights;
``weights.params_from_jax`` carries the reference's instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import ctx
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    # (seed=, device=, dtype=) -> params
    init: Callable[..., Any]
    # (params, tokens, cfg, frontend_embeds=, encoder_out=) -> (logits, aux)
    forward: Callable[..., Any]
    # (params, cfg, tokens, max_len, frontend_embeds=, encoder_out=,
    #  kv_dtype=) -> (last_logits, cache)
    prefill: Callable[..., Any]
    # (params, cfg, token, cache, pos) -> (logits, cache)
    decode_step: Callable[..., Any]
    # (batch, max_len, mem_len=0, device=, cache_layout=, page_size=,
    #  num_pages=, kv_dtype=) -> cache
    make_cache: Callable[..., Any]
    # (params, cfg, token, cache, page_table, positions) -> (logits, cache)
    paged_decode_step: Callable[..., Any]
    # (params, cfg, tokens, cache, page_table, chunk_page_ids, q_offset,
    #  chunk_len) -> (last_logits, cache)
    prefill_chunk: Callable[..., Any]
    # (params, cfg, tokens, cache, page_table, positions, n_rows)
    # -> (logits, cache)
    paged_verify_step: Callable[..., Any]
    # (params, frames) -> encoder output; None without an encoder
    encode: Callable[..., Any] | None = None

    def loss_fn(self, params, batch, *, denom=None):
        """Next-token cross-entropy (+ the MoE aux loss) of a batch:
        ``tokens`` and ``labels`` (B, S) integer tensors, labels < 0
        masked, and ``frontend`` (B, F, D) stub patches (vision) or frames
        (audio). Port of the reference's ``Model.loss_fn``: fp32 params
        of two or more dims cast to the compute dtype once (autograd
        carries the cast back to them), log-softmax in fp32 over the text
        positions only.

        Under ``fsdp`` the batch is the rank's rows of the global batch and
        the mean is the global one: the rank's masked sum over the count
        of unmasked labels on every rank (one all-reduce), so the ranks'
        losses sum to the global batch's; the weights are cast where the
        model gathers them (``ctx.gather_split``). ``denom`` (one entry a
        row) replaces that count, row by row: the train step's
        microbatches (``launch/steps.py``).

        Under ``tp_sp`` the batch is whole on every rank and the loss is
        the rank's term (``transformer.tp_sp_forward``, any stack): the
        masked sum of its label columns (``transformer.tp_sp_rows``: the
        text among its rows of the F + S, or where the degree does not
        divide them its share of the columns) over the batch's whole count
        of unmasked labels (every rank holds every label, so the count
        needs no exchange) plus its aux term, so the ranks' terms sum to
        the one card's loss."""
        cfg = self.cfg
        shard, kind = ctx.train_shard()
        if shard is None:
            params = tree_map(
                lambda p: p.to(cfg.compute_dtype)
                if p.dtype == torch.float32 and p.dim() >= 2 else p, params)
        labels = batch["labels"].long()
        if kind == "tp_sp":
            logits, aux, cols = tfm.tp_sp_forward(
                params, batch["tokens"], cfg, shard, batch.get("frontend"))
            count = (labels >= 0).sum()
            labels = labels[:, cols]
        else:
            kwargs = {}
            if cfg.frontend == "vision":
                kwargs["frontend_embeds"] = batch["frontend"]
            if cfg.encoder_layers:
                kwargs["encoder_out"] = tfm.encode(params, batch["frontend"],
                                                   cfg)
            logits, aux = self.forward(params, batch["tokens"], cfg,
                                       **kwargs)
            if cfg.frontend == "vision":
                logits = logits[:, -labels.shape[1]:]   # text positions only
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        if denom is not None:
            ce = -((ll * mask).sum(-1) / denom).sum()
        elif kind == "tp_sp":
            ce = -(ll * mask).sum() / torch.clamp(count.float(), min=1.0)
        elif shard is not None:
            count = shard.all_reduce(mask.sum(), "all_reduce")
            ce = -(ll * mask).sum() / torch.clamp(count, min=1.0)
        else:
            ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        if cfg.moe is not None:
            ce = ce + cfg.moe.aux_loss_weight * aux / max(1, cfg.num_layers)
        return ce


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port serves {', '.join(FAMILIES)} stacks only "
            f"(got {cfg.family})")

    def init(seed: int = 0, *, device="cuda", dtype=None):
        return tfm.init(cfg, seed=seed, device=device, dtype=dtype)

    def make_cache(batch: int, max_len: int, mem_len: int = 0, *,
                   device="cuda",
                   cache_layout: str = "dense", page_size: int = 16,
                   num_pages: int | None = None, kv_dtype=None):
        if cache_layout == "paged":
            if num_pages is None:
                # one scratch page (id 0) + full residency for the batch
                num_pages = batch * -(-max_len // page_size) + 1
            return tfm.make_paged_cache(cfg, num_pages, page_size,
                                        device=device, kv_dtype=kv_dtype)
        if cache_layout != "dense":
            raise ValueError(f"unknown cache layout {cache_layout!r}")
        return tfm.make_cache(cfg, batch, max_len, device=device,
                              kv_dtype=kv_dtype, mem_len=mem_len)

    def encode(params, frames):
        return tfm.encode(params, frames, cfg)

    return Model(cfg=cfg, init=init, forward=tfm.forward,
                 prefill=tfm.prefill, decode_step=tfm.decode_step,
                 make_cache=make_cache,
                 paged_decode_step=tfm.paged_decode_step,
                 prefill_chunk=tfm.prefill_chunk,
                 paged_verify_step=tfm.paged_verify_step,
                 encode=encode if cfg.encoder_layers else None)
