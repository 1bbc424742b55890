"""The ranks of ``tests/test_torch_seqshard.py`` (this file defines no
tests).

``seq_rank_main`` is a ``test_torch_sharded_ranks.Ranks`` target: each
rank joins the gloo group, runs every case on its part of the work under
``distributed/ctx.sharding_policy`` and pickles what it saw; the test's
own process computes the reference's results and compares. A case is
one of

* ``ring``: ``ring_attention`` on the rank's blocks of seeded global
  q, k, v;
* ``decode``: ``sharded_decode_attention`` on the rank's block of a
  cache (int8 with its per-row scales);
* ``slice``: a smoke model's ``prefill`` and greedy ``decode_step``s,
  then ``forward``, from the reference's weights (numpy), on the
  ``sp_rep`` tree (weights whole but the experts) and again on the
  rank's ``tp_sp`` split of the weights (dense, MoE, ssm and hybrid
  stacks; whisper after ``encode`` of the case's frames, internvl2 with
  its patch embeddings before the prompt);
* ``cell``: ``launch/dryrun.run_cell`` on a small prefill, decode and
  train cell.

A case of a degree below the world runs on ranks 0..degree-1; every rank
enters ``launch/mesh.seq_group`` alike. The ranks import no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


def slice_model(arch: str, weights, capacity_factor=None,
                frontend_tokens=None):
    """The port's fp32 smoke ``arch`` with ``weights`` (the reference's
    params as numpy), a MoE's capacity factor and the frontend's rows F
    replaced when given."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.api import build_model
    from repro_torch.weights import params_from_jax

    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32)
    if frontend_tokens is not None:
        cfg = dataclasses.replace(cfg, num_frontend_tokens=frontend_tokens)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return build_model(cfg), params_from_jax(weights, cfg, device="cpu")


def _blocks(x: np.ndarray, shard, dim: int) -> torch.Tensor:
    per = x.shape[dim] // shard.degree
    return torch.from_numpy(np.take(x, range(shard.rank * per,
                                             (shard.rank + 1) * per), dim))


def _ring(case, shard) -> dict:
    from repro_torch.distributed.ring_attention import ring_attention

    q, k, v = (_blocks(case[n], shard, 2) for n in ("q", "k", "v"))
    seen = []
    shard.reset_counts()
    out = ring_attention(q, k, v, shard, causal=case["causal"],
                         kv_len=case["kv_len"], q_offset=case["q_offset"],
                         on_block=lambda src, kb, vb: seen.append(
                             (src, bool(torch.equal(kb, _blocks(
                                 case["k"], _owner(shard, src), 2))))))
    return {"out": out.numpy(), "seen": seen, "sent": dict(shard.sent),
            "received": dict(shard.received)}


def _owner(shard, src: int):
    from repro_torch.distributed.ctx import SeqShard

    return SeqShard(None, src, shard.degree)


def _decode(case, shard) -> dict:
    from repro_torch.models.attention import sharded_decode_attention

    scales = {n: _blocks(case[n], shard, 2) for n in ("k_scale", "v_scale")
              if n in case}
    shard.reset_counts()
    out = sharded_decode_attention(
        torch.from_numpy(case["q"]), _blocks(case["k"], shard, 2),
        _blocks(case["v"], shard, 2), case["kv_len"], shard,
        k_scale=scales.get("k_scale"), v_scale=scales.get("v_scale"))
    return {"out": out.numpy(), "sent": dict(shard.sent)}


def _run_slice(model, params, case, shard) -> dict:
    """Prefill (an encoder-decoder's ``encode`` first), the case's greedy
    decode steps and forward under ``tp_sp`` on ``params``: logits,
    tokens, bytes sent by kind, the cache block's shapes and whether its
    K/V and its memories are replicated, and the rank's encoder rows."""
    from repro_torch.distributed.ctx import sharding_policy

    cfg = model.cfg
    tokens = torch.from_numpy(case["prompt"]).long()
    s = tokens.shape[1]
    out, kw = {}, {}
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        shard.reset_counts()
        if "frames" in case:
            frames = torch.from_numpy(case["frames"])
            if cfg.encoder_layers:
                kw["encoder_out"] = model.encode(params, frames)
                out["encoded"] = kw["encoder_out"].numpy()
            else:
                kw["frontend_embeds"] = frames
                s += frames.shape[1]
        logits, cache = model.prefill(params, cfg, tokens, case["max_len"],
                                      kv_dtype=case.get("kv_dtype"), **kw)
        out["prefill_sent"] = dict(shard.sent)
        out["cache_shapes"] = [{name: tuple(t.shape)
                                for name, t in blk.items()}
                               for blk in cache["layers"]]
        out["replicated"] = cache.get("replicated", False)
        out["mem_replicated"] = cache.get("mem_replicated", False)
        steps, toks = [logits[:, 0]], []
        shard.reset_counts()
        for i in range(case["steps"]):
            tok = steps[-1].argmax(-1, keepdim=True)
            toks.append(tok[:, 0])
            logits, cache = model.decode_step(params, cfg, tok, cache, s + i)
            steps.append(logits[:, 0])
        out["decode_sent"] = dict(shard.sent)
        shard.reset_counts()
        out["forward"], out["aux"] = model.forward(params, tokens, cfg,
                                                   **kw)
        out["forward_sent"] = dict(shard.sent)
    out.update(logits=torch.stack(steps).numpy(),
               tokens=torch.stack(toks, 1).numpy(),
               forward=out["forward"].numpy(), aux=float(out["aux"]))
    return out


def _slice(case, shard, weights) -> dict:
    from repro_torch.distributed.sharding import local_params

    model, whole = slice_model(case["arch"], weights[case["arch"]],
                               case.get("capacity_factor"),
                               case.get("frontend_tokens"))
    params = local_params(whole, rank=shard.rank, degree=shard.degree)
    out = _run_slice(model, params, case, shard)
    if model.cfg.moe is not None:
        out["expert_shape"] = tuple(
            params["layers"][0]["ffn"]["w_gate"].shape)
    split = local_params(whole, rank=shard.rank, degree=shard.degree,
                         policy="tp_sp")
    out["split"] = _run_slice(model, split, case, shard)
    return out


def _cell(case, shard) -> dict:
    from repro_torch.launch.dryrun import run_cell

    try:
        rec, outs = run_cell(case["cfg"], case["cell"], shard,
                             device="cpu", steps=case.get("steps", 1))
    except NotImplementedError as exc:
        return {"raised": str(exc)}
    if "metrics" in outs:           # a train cell
        return {"record": rec}
    return {"record": rec, "logits": outs["logits"].numpy()}


def seq_rank_main(rank: int, world: int, store: str, out_dir: str,
                  cases: list, weights: dict) -> None:
    from repro_torch.launch.mesh import seq_group

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        groups = {}
        for degree in sorted({c["degree"] for c in cases}):
            groups[degree] = seq_group(degree)
        res = {}
        for case in cases:
            shard = groups[case["degree"]]
            if shard is None:
                continue
            kind = case["kind"]
            if kind == "ring":
                res[case["name"]] = _ring(case, shard)
            elif kind == "decode":
                res[case["name"]] = _decode(case, shard)
            elif kind == "slice":
                res[case["name"]] = _slice(case, shard, weights)
            else:
                res[case["name"]] = _cell(case, shard)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
