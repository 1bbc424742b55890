"""Public model API: ``build_model(cfg) -> Model`` with plain functions.

Port of ``repro/models/api.py`` for the dense decoder with its dense
cache. ``Model.init(seed=..., device=...)`` draws the port's own seeded
weights; ``weights.params_from_jax`` carries the reference's instead.
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
    # (params, cfg, tokens, max_len) -> (last_logits, cache)
    prefill: Callable[..., Any]
    # (params, cfg, token, cache, pos) -> (logits, cache)
    decode_step: Callable[..., Any]
    # (batch, max_len, device=) -> cache
    make_cache: Callable[..., Any]


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves dense decoders only (got {cfg.family})")

    def init(seed: int = 0, *, device="cuda", dtype=None):
        return tfm.init(cfg, seed=seed, device=device, dtype=dtype)

    def make_cache(batch: int, max_len: int, *, device="cuda"):
        return tfm.make_cache(cfg, batch, max_len, device=device)

    return Model(cfg=cfg, init=init, forward=tfm.forward,
                 prefill=tfm.prefill, decode_step=tfm.decode_step,
                 make_cache=make_cache)
