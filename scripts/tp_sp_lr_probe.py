#!/usr/bin/env python3
"""Train full-width deepseek-moe-16b on one card and under tp_sp, side by
side, to see whether a divergence belongs to the settings or to the route.

    python3 scripts/tp_sp_lr_probe.py [--layers 3] [--steps 4]

chip_smoke.py's train_tp_sp phase trains deepseek-moe-16b at full width
(bf16 compute, int8 compression, chunked attention with remat, train_4k's
4096 rows, a global batch of 2) on ``bounded_moe``'s weights at
TRAIN_TP_SP_LR. For each setting below this script runs that step from
seed 0's weights twice on card 0: first the port's one-card
``make_train_step`` under ``ctx.grouped_as(4)`` (the same MoE groups),
then the tp_sp step at degree 4 (``chip_smoke.tp_sp_run``), four ranks
over gloo sharing the card. The settings: the launcher's lr 3e-3 on the
weights as drawn (the expert down projections unscaled), and the phase's
own (TRAIN_TP_SP_LR on ``bounded_moe``'s weights). Before training, each
route's first-batch gradient (``make_loss_and_grads``) is taken apart by
leaf: each leaf's global norm before and after int8 compression (err 0,
the train step's scales), and the leaves whose norms differ between the
routes by more than LEAF_APART are listed beside the one-card norms in
fp32 compute. Then the embedding lookup's backward on the first batch's
tokens (a Zipf draw: one token takes a quarter of the rows) against its
fp64 sum, for a seeded upstream gradient: advanced indexing in bf16 (the
port's ``_embed``), the same on each quarter of the rows summed in fp32
(a tp_sp rank's block, reduce-scattered), and ``F.embedding`` in bf16.
Eight layers' training state
(~98 GB with error feedback) does not fit one card; three layers (~39
GB, and a quarter of it a rank beside its activations) do. Prints one
JSON line a setting (loss and grad norm a step of both runs, the
losses' relative difference, the leaves apart), then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEGREE = 4
BATCH = 2
LEAF_APART = 1e-2


def settings(smoke) -> list:
    return [{"lr": 3e-3, "bounded": False},
            {"lr": smoke.TRAIN_TP_SP_LR, "bounded": True}]


def _imports():
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    return chip_smoke


def leaf_norms(torch, model, params, batch, shard=None) -> dict:
    """{path: [global norm of the leaf's gradient, the same after int8
    compression]} of ``batch``'s gradient; under tp_sp (``shard``) the
    rank's blocks' squares summed over the ranks, a whole leaf's once."""
    from repro_torch.distributed.compression import (
        apply_compression_,
        init_error_feedback,
    )
    from repro_torch.distributed.sharding import held_blocks
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.tree import leaves_with_paths, tree_leaves
    from repro_torch.weights import reference_leaf

    _, grads = make_loss_and_grads(model)(params, batch)
    blocks = (tree_leaves(held_blocks(params, model.cfg)) if shard
              else [False] * len(tree_leaves(grads)))

    def norms():
        out = []
        for (_, g), blk in zip(leaves_with_paths(grads), blocks):
            sq = g.float().pow(2).sum()
            if blk:
                sq = shard.all_reduce(sq)
            out.append(float(sq.sqrt()))
        return out

    raw = norms()
    apply_compression_(grads, init_error_feedback(grads), "int8",
                       lambda path: reference_leaf(path, model.cfg), shard)
    for p in tree_leaves(params):
        p.grad = None
    return {path: [r, c] for (path, _), r, c in
            zip(leaves_with_paths(grads), raw, norms())}


def one_card(torch, smoke, layers: int, steps: int, lr: float,
             bounded: bool) -> tuple:
    """The one-card step's metrics a step, and its first batch's
    ``leaf_norms``."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init

    cfg = smoke.train_tp_sp_cfg(layers)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.float32)
    if bounded:
        smoke.bounded_moe(params)
    opt = adamw_init(params)
    opt["err"] = init_error_feedback(params)
    step_fn = make_train_step(model, smoke.tp_sp_opt(steps, lr), "int8")
    data = smoke.tp_sp_data(cfg, smoke.TRAIN_SEQ, BATCH)
    out = []
    with ctx.grouped_as(DEGREE):
        norms = leaf_norms(torch, model, params,
                           batch_on(data.batch_at(0), "cuda"))
        for step in range(steps):
            params, opt, m = step_fn(params, opt,
                                     batch_on(data.batch_at(step), "cuda"))
            out.append({k: float(v) for k, v in m.items()})
    del params, opt
    torch.cuda.empty_cache()
    return out, norms


def one_card_fp32_norms(torch, smoke, layers: int, bounded: bool) -> dict:
    """``leaf_norms`` of the first batch on one card in fp32 compute."""
    import dataclasses

    from repro_torch.distributed import ctx
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(smoke.train_tp_sp_cfg(layers),
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.float32)
    if bounded:
        smoke.bounded_moe(params)
    batch = smoke.tp_sp_data(cfg, smoke.TRAIN_SEQ, BATCH).batch_at(0)
    with ctx.grouped_as(DEGREE):
        norms = leaf_norms(torch, model, params, batch_on(batch, "cuda"))
    del params
    torch.cuda.empty_cache()
    return norms


def lookup_backward(torch, smoke, layers: int) -> dict:
    """Relative L2 errors of the embedding lookup's gradient (vocab x
    d_model) against its fp64 sum: see the module docstring."""
    import torch.nn.functional as F

    cfg = smoke.train_tp_sp_cfg(layers)
    batch = smoke.tp_sp_data(cfg, smoke.TRAIN_SEQ, BATCH).batch_at(0)
    tokens = torch.as_tensor(batch["tokens"], device="cuda").reshape(-1)
    v, d = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(0)
    common = torch.randn(v, d, device="cuda", generator=gen)
    g = (common[tokens] + torch.randn(tokens.numel(), d, device="cuda",
                                      generator=gen)).to(torch.bfloat16)
    exact = torch.zeros(v, d, dtype=torch.float64, device="cuda").index_add_(
        0, tokens, g.double())

    def grad(fn, rows):
        e = torch.zeros(v, d, dtype=torch.bfloat16, device="cuda",
                        requires_grad=True)
        fn(e, tokens[rows]).backward(g[rows])
        return e.grad

    def err(got) -> float:
        return float((got.double() - exact).norm() / exact.norm())

    quarter = tokens.numel() // DEGREE
    whole = slice(None)
    return {"index_bf16": err(grad(lambda e, t: e[t], whole)),
            "index_bf16_quarters_fp32_sum": err(sum(
                grad(lambda e, t: e[t], slice(r * quarter,
                                              (r + 1) * quarter)).float()
                for r in range(DEGREE))),
            "embedding_bf16": err(grad(lambda e, t: F.embedding(t, e),
                                       whole))}


def rank_norms(torch, smoke, plan: dict, shard) -> dict:
    """``leaf_norms`` of the first batch on this rank's tp_sp split of the
    plan's weights."""
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.distributed.sharding import local_params
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model

    cfg = smoke.train_tp_sp_cfg(plan["layers"])
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.float32)
    if plan["bounded"]:
        smoke.bounded_moe(params)
    params = local_params(params, rank=shard.rank, degree=shard.degree,
                          policy="tp_sp", in_place=True)
    torch.cuda.empty_cache()
    batch = smoke.tp_sp_data(cfg, smoke.TRAIN_SEQ, BATCH).batch_at(0)
    with sharding_policy(shard, "tp_sp"):
        norms = leaf_norms(torch, model, params, batch_on(batch, "cuda"),
                           shard)
    del params
    torch.cuda.empty_cache()
    return norms


def rank_main(rank: int, store: str, out: str, plan: dict) -> None:
    import torch
    import torch.distributed as dist

    smoke = _imports()
    from repro_torch.launch.mesh import seq_group

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=DEGREE)
    try:
        shard = seq_group(DEGREE)
        norms = rank_norms(torch, smoke, plan, shard)
        rec = smoke.tp_sp_run(torch, plan, shard, dev, "bf16", None)
        if rank == 0:
            Path(out).write_text(json.dumps({"steps": rec["steps"],
                                             "norms": norms}))
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    smoke = _imports()
    torch.backends.cuda.matmul.allow_tf32 = False
    for setting in settings(smoke):
        want, want_norms = one_card(torch, smoke, args.layers, args.steps,
                                    **setting)
        plan = {"layers": args.layers, "batch": BATCH, "steps": args.steps,
                **setting}
        with tempfile.TemporaryDirectory() as tmp:
            out = f"{tmp}/rank0.json"
            mp.spawn(rank_main, args=(f"{tmp}/store", out, plan),
                     nprocs=DEGREE, join=True)
            got = json.loads(Path(out).read_text())
        got, norms = got["steps"], got["norms"]
        fp32 = one_card_fp32_norms(torch, smoke, args.layers,
                                   setting["bounded"])
        apart = {path: {"one_card": w, "tp_sp": norms[path],
                        "one_card_fp32": fp32[path]}
                 for path, w in want_norms.items()
                 if any(abs(g - x) > LEAF_APART * max(abs(x), 1e-30)
                        for g, x in zip(norms[path], w))}
        print(json.dumps({
            "probe": "tp_sp_lr", "arch": smoke.MOE_ARCH,
            "seq": smoke.TRAIN_SEQ, "degree": DEGREE, **plan,
            "one_card": {k: [m[k] for m in want] for k in ("loss",
                                                           "grad_norm")},
            "tp_sp": {k: [m[k] for m in got] for k in ("loss", "grad_norm")},
            "loss_rel_diff": [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                              for g, w in zip(got, want)],
            "leaves": len(want_norms), "leaves_apart": apart}), flush=True)
    print(json.dumps({"probe": "lookup_backward", "rel_err": lookup_backward(
        torch, smoke, args.layers)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
