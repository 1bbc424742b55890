"""Run one (arch x shape) cell's step across the ranks of a group.

Port of ``repro/launch/dryrun.py::run_cell``. The reference lowers and
compiles each cell on a production mesh and reads XLA's memory and cost
analysis; the port runs the cell's step on real tensors, SPMD, one
process a rank, under the policy ``launch/steps.choose_policy`` names,
and records the same fields as measured: the policy and degree, the
rank's peak device memory, the step's device time (CUDA events), the
cell's ``model_flops`` (``analysis/flops.py``) and the bytes this rank's
collectives sent and received, by kind (``distributed/ctx.SeqShard``).
Weights are random from a seed, the inputs too: a prefill cell's
tokens, a decode cell's cache of seeded K/V rows and its tokens. A rank
holds the policy's cut of the weights (``sharding.local_params``): under
``tp_sp`` its split of every leaf, gathered whole layer by layer as the
step reaches them; under ``sp_rep`` every weight whole but the experts.
The whole draw is cut in place, so it does not outlive the cut.

A train cell raises: training across devices is not ported yet
(ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.analysis.flops import model_flops
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed.ctx import SeqShard, sharding_policy
from repro_torch.distributed.sharding import local_params
from repro_torch.launch.steps import (
    choose_policy,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.models.api import build_model
from repro_torch.models.transformer import cache_block, make_cache


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def cell_tokens(cfg, batch: int, length: int, *, seed: int,
                device) -> torch.Tensor:
    """(batch, length) int64 tokens in [0, vocab) from ``seed``."""
    return torch.randint(0, cfg.vocab_size, (batch, length), device=device,
                         generator=_generator(seed, device))


def seeded_cache(cfg, batch: int, max_len: int, kv_len: int, *, seed: int,
                 device, shard: SeqShard | None = None) -> dict:
    """A dense cache of ``max_len`` rows whose rows [0, kv_len) hold K/V
    drawn from ``seed`` (standard normal in the compute dtype) and the
    rest zeros. With ``shard``
    the rank's block of ``max_len / n`` rows, whose values are the whole
    cache's, or, where n does not divide ``max_len``, the whole cache
    marked ``replicated`` (``transformer.cache_block``)."""
    lo, c = (0, max_len) if shard is None else cache_block(max_len, shard)
    hi = min(lo + c, kv_len)
    cache = make_cache(cfg, batch, c, device=device)
    if shard is not None and shard.degree > 1 and c == max_len:
        cache["replicated"] = True
    shape = (batch, cfg.num_kv_heads, kv_len, cfg.hd)
    for i, blk in enumerate(cache["layers"]):
        for j, name in enumerate(("k", "v")):
            if lo >= hi:
                continue
            rows = torch.randn(shape, device=device,
                               generator=_generator(seed + 2 * i + j, device))
            blk[name][:, :, :hi - lo] = rows.to(cfg.compute_dtype)[:, :, lo:hi]
    return cache


def _timed(fn, dev):
    """fn() -> (result, device ms or None on the CPU, wall s)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, None, time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end), time.perf_counter() - t0


def decode_steps(model, params, cache, tokens, start: int, dev) -> tuple:
    """Decode ``tokens`` (B, steps) one column a step from position
    ``start`` -> (logits (steps, B, V), device ms a step, wall s a step)."""
    step = make_decode_step(model)
    logits, ms, wall = [], [], []
    for i in range(tokens.shape[1]):
        (out, cache), t, w = _timed(
            lambda i=i, cache=cache: step(params, cache, tokens[:, i:i + 1],
                                          start + i), dev)
        logits.append(out[:, 0])
        ms.append(t)
        wall.append(w)
    return torch.stack(logits), ms, wall


def run_cell(arch, shape, shard: SeqShard, *, batch: int | None = None,
             params=None, seed: int = 0, device="cuda",
             max_len: int | None = None, steps: int = 1) -> tuple:
    """Run cell ``shape`` (a ``SHAPES`` key or a ``ShapeCell``) of ``arch``
    (an arch id or an ``ArchConfig``) on this rank of ``shard``'s group ->
    (record, outputs).

    ``batch`` cuts the cell's global batch. ``params`` are the rank's
    weights, whole or the policy's split (default: drawn whole from
    ``seed`` and cut in place to ``local_params``' tree for the policy).
    A prefill cell prefills seeded tokens into a cache of ``max_len``
    rows (default the cell's length): outputs ``logits`` (B, 1, V),
    ``cache`` and ``tokens``. A decode cell takes a seeded cache of the
    cell's length holding its first ``seq_len - steps`` rows and decodes
    ``steps`` seeded tokens to its end: outputs ``logits`` (steps, B, V)
    and ``cache``. Every rank returns the same logits.
    """
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    if cell.kind == "train":
        raise NotImplementedError("a train cell needs training across "
                                  "devices, which is not ported (ROADMAP A10)")
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    cell = dataclasses.replace(cell, global_batch=batch or cell.global_batch)
    dev = resolve_device(device)
    model = build_model(cfg)
    policy = choose_policy(cfg, cell)
    if params is None:
        params = local_params(model.init(seed, device=dev), rank=shard.rank,
                              degree=shard.degree, policy=policy,
                              in_place=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    b, s = cell.global_batch, cell.seq_len
    shard.reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), sharding_policy(shard, policy):
        if cell.kind == "prefill":
            tokens = cell_tokens(cfg, b, s, seed=seed + 1, device=dev)
            step = make_prefill_step(model, max_len or s)
            (logits, cache), ms, wall = _timed(
                lambda: step(params, {"tokens": tokens}), dev)
            outputs = {"logits": logits, "cache": cache, "tokens": tokens}
            ms, wall = [ms], [wall]
        else:
            cache = seeded_cache(cfg, b, s, s - steps, seed=seed + 2,
                                 device=dev, shard=shard)
            tokens = cell_tokens(cfg, b, steps, seed=seed + 3, device=dev)
            logits, ms, wall = decode_steps(model, params, cache, tokens,
                                            s - steps, dev)
            outputs = {"logits": logits, "cache": cache}
    record = {
        "arch": cfg.name, "shape": cell.name, "kind": cell.kind,
        "policy": policy, "degree": shard.degree, "rank": shard.rank,
        "batch": b, "seq_len": s, "steps": len(ms),
        "step_device_ms": ms if dev.type == "cuda" else "not measured",
        "step_wall_s": wall,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else "not measured"),
        "model_flops": model_flops(cfg, cell, causal=True),
        "sent_bytes": dict(shard.sent), "received_bytes": dict(shard.received),
        "staged_bytes": shard.staged_bytes,
    }
    return record, outputs
