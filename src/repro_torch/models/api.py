"""Public model API: ``build_model(cfg) -> Model`` with plain functions.

Port of ``repro/models/api.py`` for the dense decoder with its dense or
paged cache, either of them int8 (``kv_dtype``), and for the SSM family
(mamba2) with its conv and SSD states (the paged functions refuse it). ``Model.init(seed=...,
device=...)`` draws the port's own seeded weights;
``weights.params_from_jax`` carries the reference's instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    # (seed=, device=, dtype=) -> params
    init: Callable[..., Any]
    # (params, tokens, cfg) -> (logits, aux)
    forward: Callable[..., Any]
    # (params, cfg, tokens, max_len, kv_dtype=) -> (last_logits, cache)
    prefill: Callable[..., Any]
    # (params, cfg, token, cache, pos) -> (logits, cache)
    decode_step: Callable[..., Any]
    # (batch, max_len, device=, cache_layout=, page_size=, num_pages=,
    #  kv_dtype=) -> cache
    make_cache: Callable[..., Any]
    # (params, cfg, token, cache, page_table, positions) -> (logits, cache)
    paged_decode_step: Callable[..., Any]
    # (params, cfg, tokens, cache, page_table, chunk_page_ids, q_offset,
    #  chunk_len) -> (last_logits, cache)
    prefill_chunk: Callable[..., Any]
    # (params, cfg, tokens, cache, page_table, positions, n_rows)
    # -> (logits, cache)
    paged_verify_step: Callable[..., Any]


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"the port serves dense and ssm stacks only (got {cfg.family})")

    def init(seed: int = 0, *, device="cuda", dtype=None):
        return tfm.init(cfg, seed=seed, device=device, dtype=dtype)

    def make_cache(batch: int, max_len: int, *, device="cuda",
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
                              kv_dtype=kv_dtype)

    return Model(cfg=cfg, init=init, forward=tfm.forward,
                 prefill=tfm.prefill, decode_step=tfm.decode_step,
                 make_cache=make_cache,
                 paged_decode_step=tfm.paged_decode_step,
                 prefill_chunk=tfm.prefill_chunk,
                 paged_verify_step=tfm.paged_verify_step)
