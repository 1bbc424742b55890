"""The dry run: every (arch x shape) cell, abstractly or run across the
ranks of a group.

Port of ``repro/launch/dryrun.py``. ``abstract_cell`` is what the
reference's record holds without compiling: the policy, a rank's
argument bytes (``launch/steps.cell_lowering_inputs``, by part), the
cell's ``model_flops`` and whether the arguments fit the card; what only
XLA's compile gives (temp and code sizes, collective bytes) is "not
measured". ``main`` is the command line:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--degree N] [--out DIR] [--fail-fast]
        [--abstract | --run [--device cuda|cpu] [--batch B] [--layers L]]

It walks ``configs.all_cells()`` and writes one JSON record a cell,
``<out>/deg<N>/<arch>__<shape>.json``: a skip record with
``cell_is_runnable``'s reason, a failure with the exception's repr, or
the record of an ``abstract_cell`` (the default) or of ``run_cell``
(``--run``: at degree N > 1, N processes, one a rank; NCCL with a card a
rank where the machine has N cards, else gloo with every rank on card 0,
or on the CPU). ``--batch`` and ``--layers`` cut a run's cell, and the
record's ``reduced`` says so. It exits 1 if any cell failed.

``run_cell`` runs one cell's step across the ranks of a group. The reference lowers and
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

import argparse
import dataclasses
import json
import os
import tempfile
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.analysis.flops import model_flops
from repro_torch.configs import SHAPES, all_cells, cell_is_runnable, get_arch
from repro_torch.distributed.ctx import SeqShard, sharding_policy
from repro_torch.distributed.sharding import local_params
from repro_torch.launch.steps import (
    argument_bytes,
    cell_lowering_inputs,
    choose_policy,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    train_cfg,
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
        cfg = train_cfg(cfg)
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


# ---------------------------------------------------------------------------
# the abstract record and the command line
# ---------------------------------------------------------------------------

NOT_MEASURED = "not measured"
# the part of a step's arguments each one is, by the cell's kind
_PARTS = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
          "decode": ("params", "cache", "batch", "batch")}


def abstract_cell(arch_id: str, shape_id: str, degree: int, *,
                  device_bytes: int | None = None) -> dict:
    """The reference's record fields of a cell over ``degree`` ranks that
    need no compile and no run: the policy, ``memory.
    argument_size_in_bytes`` (a rank's arguments, also by part), the
    cell's ``model_flops`` (causal) and whether the arguments fit
    ``device_bytes`` of device memory (``"not measured"`` without it).
    XLA's output, temp, code and alias sizes and the collectives'
    bytes are "not measured"."""
    cell = SHAPES[shape_id]
    cfg = get_arch(arch_id)
    _, args, donate, policy = cell_lowering_inputs(cfg, cell, degree)
    sizes = argument_bytes(args)
    by_part: dict[str, int] = {}
    for part, n in zip(_PARTS[cell.kind], sizes):
        by_part[part] = by_part.get(part, 0) + n
    total = sum(sizes)
    memory = {"argument_size_in_bytes": total,
              "argument_bytes_by_part": by_part}
    for field in ("output_size_in_bytes", "temp_size_in_bytes",
                  "generated_code_size_in_bytes", "alias_size_in_bytes"):
        memory[field] = NOT_MEASURED
    return {"arch": arch_id, "shape": shape_id, "mesh": f"deg{degree}",
            "policy": policy, "num_devices": degree, "donate": list(donate),
            "memory": memory, "model_flops": model_flops(cfg, cell,
                                                         causal=True),
            "collectives": NOT_MEASURED,
            "device_memory_bytes": (NOT_MEASURED if device_bytes is None
                                    else device_bytes),
            "fits_device_memory": (NOT_MEASURED if device_bytes is None
                                   else total <= device_bytes),
            "ok": True}


def cut_arch(arch_id: str, layers: int | None) -> tuple:
    """(``arch_id``'s config with ``layers`` decoder layers (an
    encoder-decoder's encoder cut alike), the cut as {field: [published,
    run]}); the config itself with ``layers`` None."""
    cfg = get_arch(arch_id)
    if layers is None:
        return cfg, {}
    cut = {"num_layers": layers}
    if cfg.encoder_layers:
        cut["encoder_layers"] = min(layers, cfg.encoder_layers)
    return dataclasses.replace(cfg, **cut), {
        k: [getattr(cfg, k), v] for k, v in cut.items()}


def run_record(arch_id: str, shape_id: str, shard: SeqShard, *, device,
               batch: int | None = None, layers: int | None = None) -> dict:
    """``run_cell`` of the cell on this rank, cut to ``batch`` and
    ``layers``: its record, with ``reduced`` (the cuts), ``mesh`` and
    ``ok``, true when every logit (a train cell: every loss) is
    finite."""
    cfg, reduced = cut_arch(arch_id, layers)
    published = SHAPES[shape_id].global_batch
    if batch is not None and batch != published:
        reduced["global_batch"] = [published, batch]
    record, outputs = run_cell(cfg, shape_id, shard, batch=batch,
                               device=device)
    if "logits" in outputs:
        finite = bool(outputs["logits"].isfinite().all())
    else:
        finite = bool(torch.tensor(record["losses"]).isfinite().all())
    return dict(record, arch=arch_id, mesh=f"deg{shard.degree}",
                reduced=reduced, ok=finite)


def _rank_main(rank: int, world: int, backend: str, store: str, out: str,
               arch_id: str, shape_id: str, device: str,
               batch: int | None, layers: int | None) -> None:
    """One rank of a ``--run`` cell (a process of its own): join the
    group, run the cell, write its record to ``out``/rank<r>.json."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        rec = run_record(arch_id, shape_id, SeqShard(None, rank, world),
                         device=dev, batch=batch, layers=layers)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def run_ranks(arch_id: str, shape_id: str, degree: int, *, device,
              batch: int | None = None, layers: int | None = None) -> dict:
    """``run_record`` of the cell at ``degree``: in this process at degree
    1, else on ``degree`` spawned ranks (NCCL with a card a rank where
    there are as many cards, else gloo, every rank on card 0 or on the
    CPU). Rank 0's record, ``ok`` only if every rank's is, and each
    rank's record under ``ranks``. A rank's exception is raised here."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if degree == 1:
        return run_record(arch_id, shape_id, SeqShard(None, 0, 1),
                          device=dev, batch=batch, layers=layers)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= degree else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(degree, backend,
                                   os.path.join(tmp, "store"), tmp, arch_id,
                                   shape_id, dev.type, batch, layers),
                 nprocs=degree, join=True)
        ranks = []
        for r in range(degree):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return dict(ranks[0], backend=backend, ranks=ranks,
                ok=all(rec["ok"] for rec in ranks))


def _summary(rec: dict) -> str:
    if "memory" in rec:
        return (f"args/rank={rec['memory']['argument_size_in_bytes']}B "
                f"fits={rec['fits_device_memory']}")
    return (f"step_device_ms={rec['step_device_ms']} "
            f"peak={rec['peak_mem_bytes']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--fail-fast", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--abstract", action="store_true",
                      help="a rank's argument bytes, from the shapes "
                           "(the default)")
    mode.add_argument("--run", action="store_true",
                      help="run each cell's step on --device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.run and (args.batch or args.layers):
        ap.error("--batch and --layers cut a --run")
    if args.degree < 1:
        ap.error("--degree must be at least 1")
    device_bytes = (torch.cuda.get_device_properties(0).total_memory
                    if not args.run and torch.cuda.is_available() else None)
    mesh = f"deg{args.degree}"
    outdir = os.path.join(args.out, mesh)
    os.makedirs(outdir, exist_ok=True)
    n_ok = n_fail = n_skip = 0
    for arch_id, shape_id, runnable, why in all_cells():
        if args.arch and arch_id != args.arch:
            continue
        if args.shape and shape_id != args.shape:
            continue
        path = os.path.join(outdir, f"{arch_id}__{shape_id}.json")
        if not runnable:
            rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh,
                   "ok": False, "skipped": True, "reason": why}
            print(f"[skip] {mesh} {arch_id} {shape_id}: {why}", flush=True)
            n_skip += 1
        else:
            try:
                if args.run:
                    rec = run_ranks(arch_id, shape_id, args.degree,
                                    device=args.device, batch=args.batch,
                                    layers=args.layers)
                else:
                    rec = abstract_cell(arch_id, shape_id, args.degree,
                                        device_bytes=device_bytes)
                if not rec["ok"]:
                    raise FloatingPointError("non-finite outputs")
                print(f"[ ok ] {mesh} {arch_id} {shape_id}: "
                      f"{_summary(rec)}", flush=True)
                n_ok += 1
            except Exception as e:  # noqa: BLE001  a cell's failure is its record
                n_fail += 1
                rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh,
                       "ok": False, "error": repr(e)}
                print(f"[FAIL] {mesh} {arch_id} {shape_id}: {e!r}",
                      flush=True)
                traceback.print_exc()
                if args.fail_fast:
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    raise
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"dryrun done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
