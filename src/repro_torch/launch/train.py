"""Fault-tolerant training launcher, on one device or across ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --steps 30
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3-1.7b --smoke --device cpu --steps 30
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch deepseek-moe-16b --smoke --device cpu --steps 30

Port of ``repro/launch/train.py``: the same flags less ``--mesh``, plus
``--device`` (default ``cuda``, which raises where there is no CUDA
device). It restores the newest checkpoint of ``--ckpt-dir`` on start,
saves asynchronously every ``--save-every`` steps and at the end, draws
the seekable ``SyntheticLMData`` stream (a resumed run sees the batches
an uninterrupted one saw), flags straggler steps (``StepTimer``), writes
a heartbeat a step (``Watchdog``) and, with ``--metrics-file``, a JSON
line a step. Weights are the port's own init from seed 0, in fp32.

Across ranks: with a default ``torch.distributed`` group of more than
one rank (initialized here from ``torchrun``'s environment when it is
not yet: NCCL with a card a rank, ``cuda:LOCAL_RANK``; gloo with
``--device cpu``), it trains under ``steps.choose_policy``'s policy at
the group's degree. ``--batch`` is the global batch. Under ``fsdp``
each rank draws its slice (``SyntheticLMData(process_index=rank,
process_count=n)``, as the reference's launcher) and holds its ``fsdp``
blocks of the weights and the optimizer state; under ``tp_sp`` (an MoE
stack, or an odd batch, of any stack) each rank draws the whole batch,
of which the model takes the rank's rows of the sequence (all of them
where the degree does not divide it, the rank's loss a share of the
label columns), and holds its ``tp_sp`` split (the experts its own).
Either saves and restores sharded (a checkpoint saved at another degree
restores onto this one). The heartbeat worker is
``proc<rank>``; rank 0 alone prints and writes ``--metrics-file``.
Where the reference's launcher places parameters by the ``tp_sp`` rules
whatever the cell, the port follows ``choose_policy``.

The kernels have no backward, so a config whose ``attn_impl`` is
``"kernel"`` trains on ``"chunked"`` (the reference's ``"xla"``), and
says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import contextlib

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeCell, get_arch, get_smoke
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.compression import init_error_feedback
from repro_torch.distributed.ctx import SeqShard, sharding_policy
from repro_torch.distributed.elastic import StepTimer, Watchdog
from repro_torch.distributed.sharding import (
    fsdp_blocks,
    local_params,
    tp_sp_blocks,
)
from repro_torch.launch.steps import choose_policy, make_train_step
from repro_torch.models.api import build_model
from repro_torch.models.transformer import init
from repro_torch.optim import OptConfig, adamw_init


def batch_on(batch: dict, device) -> dict:
    """A ``SyntheticLMData`` batch as tensors on ``device``: token ids and
    labels int64, frontend features fp32."""
    return {k: torch.from_numpy(v).to(
        device, torch.float32 if k == "frontend" else torch.int64)
        for k, v in batch.items()}


def join_group(device: str) -> tuple[int, int, bool]:
    """(rank, ranks, whether this call initialized the default group): the
    default group's, initialized from ``torchrun``'s environment where it
    spans more than one rank and is not yet (NCCL, or gloo for a CPU
    ``device``); (0, 1, False) with no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 0, 1, False
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size(), True


def state_blocks(cfg, compression: str, rank: int, degree: int,
                 policy: str = "fsdp") -> dict:
    """Each leaf's block of the saved state ``{"params", "opt"}`` on rank
    ``rank`` of ``degree`` under the training ``policy``
    (``sharding.fsdp_blocks`` or ``tp_sp_blocks``), from the shapes of
    ``init`` on the meta device."""
    shapes = init(cfg, device="meta")
    opt = {"mu": shapes, "nu": shapes,
           "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if compression == "int8":
        opt["err"] = shapes
    blocks = tp_sp_blocks if policy == "tp_sp" else fsdp_blocks
    return blocks({"params": shapes, "opt": opt}, rank=rank, degree=degree)


def main(argv=None):
    """Train and return the loss of each step run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="LR-schedule horizon (defaults to --steps); set "
                    "explicitly when a run will stop early and resume")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M example)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-file", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rank, degree, joined = join_group(args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and degree > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    try:
        return _train(args, rank, degree, dev)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, rank: int, degree: int, dev) -> list:
    lead = rank == 0
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["head_dim"] = max(8, args.d_model // cfg.num_heads)
        overrides["d_ff"] = (args.d_model * 4) if cfg.d_ff else 0
        if cfg.lru_width:
            overrides["lru_width"] = args.d_model
    if args.layers:
        overrides["num_layers"] = args.layers
    if cfg.attn_impl == "kernel":
        if lead:
            print('[train] the attention kernels have no backward: '
                  'training with attn_impl="chunked"')
        overrides["attn_impl"] = "chunked"
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    policy = choose_policy(cfg, ShapeCell("train", args.seq, args.batch,
                                          "train"))
    shard = SeqShard(None, rank, degree)
    split_batch = degree > 1 and policy == "fsdp"

    model = build_model(cfg)
    horizon = args.total_steps or args.steps
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, horizon // 10),
                        total_steps=horizon)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=17,
        process_index=rank if split_batch else 0,
        process_count=degree if split_batch else 1,
        frontend_tokens=cfg.num_frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model,
    )

    params = model.init(seed=0, device=dev, dtype=torch.float32)
    if degree > 1:
        params = local_params(params, rank=rank, degree=degree,
                              policy=policy, in_place=True)
    opt_state = adamw_init(params)
    if args.compression == "int8":
        opt_state["err"] = init_error_feedback(params)
    blocks = (state_blocks(cfg, args.compression, rank, degree, policy)
              if degree > 1 else None)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=3, rank=rank,
                                 degree=degree)
        if degree > 1:
            dist.barrier()    # rank 0 has cleared interrupted saves
        state = {"params": params, "opt": opt_state}
        step_found, restored = ckpt.restore_latest(state, device=dev,
                                                   shardings=blocks)
        if step_found is not None:
            params = restored["params"]
            opt_state = restored["opt"]
            start_step = step_found
            if lead:
                print(f"[train] restored checkpoint at step {start_step}")

    step_fn = make_train_step(model, opt_cfg, args.compression
                              if args.compression != "none" else None)
    timer = StepTimer()
    watchdog = (Watchdog(os.path.join(args.ckpt_dir, "hb"))
                if args.ckpt_dir else None)
    metrics_f = (open(args.metrics_file, "a")
                 if args.metrics_file and lead else None)
    worker = f"proc{rank}"
    policy_ctx = (sharding_policy(shard, policy) if degree > 1
                  else contextlib.nullcontext())

    losses = []
    with policy_ctx:
        try:
            for step in range(start_step, args.steps):
                t0 = time.time()
                batch = batch_on(data.batch_at(step), dev)
                params, opt_state, m = step_fn(params, opt_state, batch)
                loss = float(m["loss"])
                dt = time.time() - t0
                slow = timer.observe(dt)
                losses.append(loss)
                if watchdog:
                    watchdog.beat(worker, step)
                if slow and lead:
                    print(f"[train] step {step}: straggler step "
                          f"({dt:.2f}s vs ema {timer.ema:.2f}s)")
                if lead and (step % args.log_every == 0
                             or step == args.steps - 1):
                    print(f"[train] step {step} loss={loss:.4f} "
                          f"gnorm={float(m['grad_norm']):.3f} "
                          f"lr={float(m['lr']):.2e} {dt:.2f}s", flush=True)
                if metrics_f:
                    metrics_f.write(json.dumps(
                        {"step": step, "loss": loss, "dt": dt}) + "\n")
                if ckpt and (step + 1) % args.save_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state},
                              blocking=False, shardings=blocks)
            if ckpt:
                ckpt.save(args.steps, {"params": params, "opt": opt_state},
                          blocking=True, shardings=blocks)
        finally:
            if metrics_f:
                metrics_f.close()
    if losses and lead:
        print(f"[train] done. first loss={losses[0]:.4f} "
              f"last loss={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
