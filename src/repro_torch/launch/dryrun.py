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
tokens and, for whisper and internvl2, its fp32 stub frames or patch
embeddings (B, F, D) (a vision cell's F patch rows count toward its
length, as the reference's ``batch_sds`` has it); a decode cell's cache
of seeded K/V rows, ring slots, recurrent states and cross memories of
F rows, and its tokens. A cell ``configs.cell_is_runnable``
refuses (long_500k of a stack that is not sub-quadratic) raises. A rank
holds the policy's cut of the weights (``sharding.local_params``): under
``tp_sp`` its split of every leaf, gathered whole layer by layer as the
step reaches them; under ``sp_rep`` every weight whole but the experts.
The whole draw is cut in place, so it does not outlive the cut.

A train cell runs ``steps`` train steps under ``choose_policy``'s
policy with ``"chunked"`` attention (the kernels have no backward); the
record adds each step's loss and grad norm. Under ``fsdp`` (a dense,
ssm, hybrid, audio or vision stack at an even batch) each rank holds its
``fsdp`` blocks of fp32 weights and AdamW state and draws its slice of
seeded ``SyntheticLMData`` at the cell's sequence (a vision cell's F
patch rows count toward it). Under ``tp_sp`` (an MoE stack, or an odd
batch, of any stack) each rank holds its ``tp_sp`` split and draws the
whole batch, of which the model takes its rows of the sequence (all of
them where the degree does not divide it, its loss a share of the
label columns: ``transformer.tp_sp_rows``).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.analysis.flops import model_flops
from repro_torch.configs import SHAPES, cell_is_runnable, get_arch
from repro_torch.distributed.ctx import SeqShard, sharding_policy
from repro_torch.distributed.sharding import local_params
from repro_torch.launch.steps import (
    choose_policy,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models.api import build_model
from repro_torch.models.transformer import (
    keep_block,
    make_cache,
    rank_cache,
    ring_slots,
)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def cell_tokens(cfg, batch: int, length: int, *, seed: int,
                device) -> torch.Tensor:
    """(batch, length) int64 tokens in [0, vocab) from ``seed``."""
    return torch.randint(0, cfg.vocab_size, (batch, length), device=device,
                         generator=_generator(seed, device))


def cell_frames(cfg, batch: int, *, seed: int, device) -> torch.Tensor:
    """(batch, F, d_model) fp32 standard-normal stub frames (whisper) or
    patch embeddings (internvl2) from ``seed``, F =
    ``cfg.num_frontend_tokens``."""
    return torch.randn((batch, cfg.num_frontend_tokens, cfg.d_model),
                       device=device, generator=_generator(seed, device))


def seeded_cache(cfg, batch: int, max_len: int, kv_len: int, *, seed: int,
                 device, shard: SeqShard | None = None) -> dict:
    """A cache of ``max_len`` positions holding values drawn from
    ``seed`` (standard normal in each leaf's dtype; layer i's two leaves
    from seeds seed + 2i and seed + 2i + 1): an attention layer's K/V rows
    [0, kv_len), of a window's ring its first min(kv_len, slots) slots,
    the rest zeros; an SSD or RG-LRU layer's states whole; an
    encoder-decoder's cross memories, all F = ``cfg.num_frontend_tokens``
    rows (the reference's ``abstract_cache``), layer i's from seeds seed
    + 2(L + i) and seed + 2(L + i) + 1, L the layers. With ``shard`` the
    rank's cache (``transformer.rank_cache``: K/V blocks of ``max_len /
    n`` rows or ring slots, recurrent states by channel, head or width,
    memory blocks of F / n rows), whose values are the whole cache's cut
    to its blocks, or, where n does not divide the K/V rows, the whole
    K/V, marked ``replicated`` (memories: ``mem_replicated``)."""
    if shard is None:
        shard = SeqShard(None, 0, 1)
    mem_len = cfg.num_frontend_tokens if cfg.encoder_layers else 0
    cache = rank_cache(cfg, batch, max_len, shard, device=device,
                       mem_len=mem_len)
    whole = make_cache(cfg, batch, max_len, device="meta", mem_len=mem_len)
    filled = min(kv_len, ring_slots(cfg, max_len))
    n_layers = len(cache["layers"])
    for i, (blk, full) in enumerate(zip(cache["layers"], whole["layers"])):
        for j, name in enumerate(("mem_k", "mem_v") if "mem_k" in blk
                                 else ()):
            gen = _generator(seed + 2 * (n_layers + i) + j, device)
            draw = torch.randn(full[name].shape, device=device, generator=gen)
            keep_block(blk[name], draw.to(blk[name].dtype), shard)
        for j, name in enumerate(("k", "v") if "k" in blk else
                                 ("conv", "state" if "state" in blk
                                  else "rnn")):
            gen = _generator(seed + 2 * i + j, device)
            if name in ("conv", "state", "rnn"):
                draw = torch.randn(full[name].shape, device=device,
                                   generator=gen)
                keep_block(blk[name], draw.to(blk[name].dtype), shard)
                continue
            c = blk[name].shape[2]
            lo = shard.span(c, full[name].shape[2]).start
            hi = min(lo + c, filled)
            if lo >= hi:
                continue
            rows = torch.randn((batch, cfg.num_kv_heads, filled, cfg.hd),
                               device=device, generator=gen)
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


def train_steps(model, params, shard: SeqShard, cell, *, seed: int,
                steps: int, dev, policy: str = "fsdp") -> tuple:
    """``steps`` train steps of ``model`` under ``policy`` on seeded
    ``SyntheticLMData`` (seed ``seed``) at ``cell``'s global batch and
    sequence, this rank's slice of the batch under ``fsdp``, the whole
    batch under ``tp_sp`` -> (metrics a step, device ms a step, wall s a
    step). AdamW at the train launcher's defaults, no compression."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import batch_on
    from repro_torch.optim import OptConfig, adamw_init

    cfg = model.cfg
    f = cfg.num_frontend_tokens if cfg.frontend else 0
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, global_batch=cell.global_batch,
        seq_len=cell.seq_len - (f if cfg.frontend == "vision" else 0),
        seed=seed, process_index=shard.rank if policy == "fsdp" else 0,
        process_count=shard.degree if policy == "fsdp" else 1,
        frontend_tokens=f, d_model=cfg.d_model)
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=0,
                                            total_steps=steps))
    opt = adamw_init(params)
    metrics, ms, wall = [], [], []
    for i in range(steps):
        batch = batch_on(data.batch_at(i), dev)
        (params, opt, m), t, w = _timed(lambda: step(params, opt, batch),
                                        dev)
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append(t)
        wall.append(w)
    return metrics, ms, wall


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
    rows (default the cell's length) through ``make_prefill_step``:
    outputs ``logits`` (B, 1, V), ``cache`` and ``tokens``. An
    encoder-decoder's batch adds seeded frames (``cell_frames``, seed +
    4), which every rank encodes on its block of them, its cache holding
    its block of the cross memories; a vision cell's adds seeded patch
    embeddings and has ``seq_len - F`` tokens, the patch rows split with
    the tokens' rows. A decode cell takes a seeded cache of the cell's
    length holding its first ``seq_len - steps`` rows (an
    encoder-decoder's: its memories' F rows too) and decodes ``steps``
    seeded tokens to its end: outputs ``logits`` (steps, B, V) and
    ``cache``. Every rank returns the same logits. A train cell runs
    ``steps`` train steps under its policy (``train_steps``, data seed
    ``seed + 5``; ``params`` fp32, the rank's blocks, trained in place):
    outputs ``metrics`` a step, the same on every rank, and ``params``.
    """
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    runnable, why = cell_is_runnable(cfg.name, cell.name)
    if not runnable:
        raise ValueError(f"{cfg.name} x {cell.name}: {why}")
    cell = dataclasses.replace(cell, global_batch=batch or cell.global_batch)
    dev = resolve_device(device)
    policy = choose_policy(cfg, cell)
    if cell.kind == "train":
        if policy == "fsdp" and cell.global_batch % shard.degree:
            raise ValueError(f"a global batch of {cell.global_batch} does "
                             f"not split over {shard.degree} ranks")
        if cfg.attn_impl == "kernel":
            cfg = dataclasses.replace(cfg, attn_impl="chunked")
    model = build_model(cfg)
    if params is None:
        dtype = torch.float32 if cell.kind == "train" else None
        params = local_params(model.init(seed, device=dev, dtype=dtype),
                              rank=shard.rank, degree=shard.degree,
                              policy=policy, in_place=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    shard.reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if cell.kind == "train":
        with sharding_policy(shard, policy):
            metrics, ms, wall = train_steps(model, params, shard, cell,
                                            seed=seed + 5, steps=steps,
                                            dev=dev, policy=policy)
        outputs = {"metrics": metrics, "params": params}
    else:
        outputs, ms, wall = _serve_cell(model, params, shard, cell, policy,
                                        seed=seed, dev=dev, max_len=max_len,
                                        steps=steps)
    b, s = cell.global_batch, cell.seq_len
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
    if cell.kind == "train":
        record["losses"] = [m["loss"] for m in outputs["metrics"]]
        record["grad_norms"] = [m["grad_norm"] for m in outputs["metrics"]]
    return record, outputs


def _serve_cell(model, params, shard, cell, policy: str, *, seed: int, dev,
                max_len, steps: int) -> tuple:
    """A prefill or decode cell's step(s) under the policy -> (outputs,
    device ms a step, wall s a step); see ``run_cell``."""
    cfg = model.cfg
    b, s = cell.global_batch, cell.seq_len
    with torch.no_grad(), sharding_policy(shard, policy):
        if cell.kind == "prefill":
            batch = {}
            if cfg.frontend is not None:
                batch["frontend"] = cell_frames(cfg, b, seed=seed + 4,
                                                device=dev)
            f = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
            tokens = cell_tokens(cfg, b, s - f, seed=seed + 1, device=dev)
            batch["tokens"] = tokens
            step = make_prefill_step(model, max_len or s)
            (logits, cache), ms, wall = _timed(
                lambda: step(params, batch), dev)
            outputs = {"logits": logits, "cache": cache, "tokens": tokens}
            ms, wall = [ms], [wall]
        else:
            cache = seeded_cache(cfg, b, s, s - steps, seed=seed + 2,
                                 device=dev, shard=shard)
            tokens = cell_tokens(cfg, b, steps, seed=seed + 3, device=dev)
            logits, ms, wall = decode_steps(model, params, cache, tokens,
                                            s - steps, dev)
            outputs = {"logits": logits, "cache": cache}
    return outputs, ms, wall
