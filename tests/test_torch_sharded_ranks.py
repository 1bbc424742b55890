"""The ranks of ``tests/test_torch_sharded.py`` (this file defines no
tests).

``Ranks`` (and ``run_ranks``, which waits for them) spawns ``world``
processes (``torch.multiprocessing``, the spawn method) that join one
gloo group through a ``FileStore`` in a
temporary directory, so that parallel test workers never share a TCP
port. Each rank builds the port's smoke models from the numpy weights it
is given, serves every case through ``ShardedContinuousBatchingEngine``
on the CPU (a case of kind ``ring_fn`` instead runs
``distributed/paged.ring_paged_prefill`` on the rank's heads of the
case's pools, ``ring_case``; of kind ``fsdp`` trains under the fsdp
(or the case's tp_sp) policy and saves sharded, ``fsdp_case``; of kind ``resume`` runs
``launch/train.main`` over the group, ``resume_case``) and pickles what
it saw; the caller compares. The ranks import no JAX: the reference's
results are computed in the test's own process.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def requests(prompts, max_new: int, deadlines=None):
    """Requests of ``prompts`` (rid = index), with ``deadlines`` (rid ->
    seconds) where given."""
    from repro_torch.serving import Request

    deadlines = deadlines or {}
    return [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new, eos_id=-2,
                    deadline_s=deadlines.get(i))
            for i, p in enumerate(prompts)]


def port_model(arch: str, weights):
    """The port's fp32 smoke ``arch`` on its kernels' plain versions,
    with ``weights`` (the reference's params as numpy)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.api import build_model
    from repro_torch.weights import params_from_jax

    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32)
    return build_model(cfg), params_from_jax(weights, cfg, device="cpu")


def _split_plan_spy():
    """Wrap B6's and B7's ``decode_split_plan``: every (kernel, bh) the
    wrappers plan from is appended to the returned list. Returns the list
    and a function that takes the wrappers off."""
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_verify_attention as pver

    seen, plans = [], []
    for name, mod in (("B6", pdec), ("B7", pver)):
        plan = mod.decode_split_plan
        plans.append((mod, plan))

        def spy(q_dtype, bh, n_kv, _plan=plan, _name=name):
            seen.append((_name, bh))
            return _plan(q_dtype, bh, n_kv)

        mod.decode_split_plan = spy

    def restore():
        for mod, plan in plans:
            mod.decode_split_plan = plan

    return seen, restore


def serve_case(case: dict, weights: dict) -> dict:
    """Serve one case through the sharded engine on this rank."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import (
        PoolAuditor,
        ScriptedFaults,
        ShardedContinuousBatchingEngine,
    )

    model, params = port_model(case["arch"], weights[case["arch"]])
    rank = dist.get_rank()
    tracer = Tracer(pid=rank) if case.get("trace") else None
    eng = ShardedContinuousBatchingEngine(
        model, params, shard=case["shard"], device="cpu", tracer=tracer,
        chunk_route=case.get("chunk_route", "local"), **case["engine_kw"])
    if case.get("burst"):
        eng.injector = ScriptedFaults(
            exhaust_at_appends=frozenset(case["burst"]))
    auditor = PoolAuditor() if case.get("audit") else None
    eng.auditor = auditor
    seen, restore = _split_plan_spy() if case.get("spy") else (None, None)
    try:
        out = eng.serve(requests(case["prompts"], case["max_new"],
                                 case.get("deadlines")))
    finally:
        if restore is not None:
            restore()
    res = {"tokens": {rid: np.asarray(t) for rid, t in out.items()},
           "states": {rid: rec.state.value
                      for rid, rec in eng.results.items()},
           "member": eng.member, "shard": eng.shard}
    if not eng.member:
        return res
    pools = eng._make_cache()["layers"][0]
    res.update(
        shard_stats=eng.shard_stats, step_log=list(eng.step_log),
        preemptions=eng.preemption_count, spec_stats=eng.spec_stats,
        degree_gauge=list(eng.metrics.gauge("shard.degree").series),
        pool_shapes={k: tuple(v.shape) for k, v in pools.items()},
        audited=auditor.steps_checked if auditor else 0,
        pages_left=eng._mgr.pages_used,
        trace=tracer.export() if tracer else None,
        split_plans=sorted(set(seen)) if seen is not None else None)
    return res


def ring_case(case: dict) -> dict:
    """A chunk through ``models.attention.paged_prefill_attention`` under
    ``kv_shard`` with the ``"ring"`` chunk route, on this rank's heads of
    the case's pools (numpy, int8 with their scales), each hop on the
    ``kernel`` route (B5's plain version on the CPU) and on the ``plain``
    twin: every rank's output, and the hops, slab bytes and gathered
    bytes of one call."""
    from repro_torch.distributed.ctx import KVShard, kv_shard
    from repro_torch.distributed.paged import head_sharded
    from repro_torch.models.attention import paged_prefill_attention

    t = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    res = {"out": {}}
    for impl in ("kernel", "plain"):
        shard = KVShard(None, dist.get_rank(), case["shard"],
                        chunk_route="ring")
        pools = {k: head_sharded(t[k], shard) for k in
                 ("k", "v", "k_scales", "v_scales") if k in t}
        with kv_shard(shard):
            out = paged_prefill_attention(
                t["q"], pools["k"], pools["v"], t["table"], t["span"],
                impl=impl, k_scales=pools.get("k_scales"),
                v_scales=pools.get("v_scales"))
        res["out"][impl] = out.numpy()
        res.update(ring_hops=shard.ring_hops, ring_bytes=shard.ring_bytes,
                   gathered_bytes=shard.gathered_bytes)
    return res


def fsdp_case(case: dict, weights: dict) -> dict:
    """``case["steps"]`` train steps of the case's smoke model (chunked
    attention, int8 compression) under ``case["policy"]`` (default
    ``fsdp``: on this rank's slice of ``SyntheticLMData(seed=17)``;
    ``tp_sp``: on the whole batch, the rank's rows of the sequence), then
    an async sharded save of the state into ``case["ckpt"]``: the metrics
    a step, the rank's trained blocks and first moments, and the last
    step's bytes by kind."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.distributed.ctx import SeqShard, sharding_policy
    from repro_torch.distributed.sharding import (
        fsdp_blocks,
        local_params,
        tp_sp_blocks,
    )
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import leaves_with_paths

    model, whole = fsdp_model(case, weights)
    rank, n = dist.get_rank(), case["degree"]
    policy = case.get("policy", "fsdp")
    shard = SeqShard(None, rank, n)
    params = local_params(whole, rank=rank, degree=n, policy=policy)
    state = adamw_init(params)
    state["err"] = init_error_feedback(params)
    step = make_train_step(model, OptConfig(**case["opt"]), "int8")
    split = policy == "fsdp"
    data = SyntheticLMData(vocab_size=model.cfg.vocab_size,
                           seq_len=case["seq"], global_batch=case["batch"],
                           seed=17, process_index=rank if split else 0,
                           process_count=n if split else 1)
    mgr = CheckpointManager(case["ckpt"], rank=rank, degree=n)
    dist.barrier()                  # every rank opened the directory
    blocks = (fsdp_blocks if split else tp_sp_blocks)({
        "params": whole, "opt": {"mu": whole, "nu": whole, "err": whole,
                                 "step": state["step"]}},
        rank=rank, degree=n)
    metrics = []
    with sharding_policy(shard, policy):
        for i in range(case["steps"]):
            shard.reset_counts()
            params, state, m = step(params, state,
                                    batch_on(data.batch_at(i), "cpu"))
            metrics.append({k: float(v) for k, v in m.items()})
    mgr.save(case["steps"], {"params": params, "opt": state},
             blocking=False, shardings=blocks)
    mgr.wait()
    return {"metrics": metrics, "sent": dict(shard.sent),
            "received": dict(shard.received),
            "params": {p: t.detach().numpy()
                       for p, t in leaves_with_paths(params)},
            "mu": {p: t.numpy() for p, t in leaves_with_paths(state["mu"])}}


def fsdp_model(case: dict, weights: dict):
    """The case's fp32 smoke model on the chunked attention route, which
    trains, and its whole weights."""
    from repro_torch.models.api import build_model

    model, whole = port_model(case["arch"], weights[case["arch"]])
    return build_model(dataclasses.replace(
        model.cfg, attn_impl="chunked", attn_chunk=8)), whole


def resume_case(case: dict) -> dict:
    """``launch/train.main(case["argv"])`` on this rank of the default
    group: it resumes from the newest checkpoint of its ``--ckpt-dir``
    onto the group's degree and returns the losses of the steps it ran."""
    from repro_torch.launch import train

    return {"losses": train.main(case["argv"])}


def pipeline_case(case: dict) -> dict:
    """``distributed/pipeline.pipelined_apply`` of the case's layers
    (numpy (L, D, D), ``tanh(h @ w)`` a layer) on its batch, this rank
    a stage of the default group: the output and the bytes by kind."""
    from repro_torch.distributed.ctx import SeqShard
    from repro_torch.distributed.pipeline import pipelined_apply, stage_layers

    shard = SeqShard(None, dist.get_rank(), dist.get_world_size())
    layers = stage_layers(list(torch.from_numpy(case["layers"])), shard)
    with torch.no_grad():
        y = pipelined_apply(layers, torch.from_numpy(case["x"]),
                            lambda w, h: torch.tanh(h @ w), shard,
                            num_microbatches=case["microbatches"])
    return {"out": y.numpy(), "sent": dict(shard.sent),
            "received": dict(shard.received)}


RANK_CASES = {"ring_fn": lambda case, weights: ring_case(case),
              "pipeline": lambda case, weights: pipeline_case(case),
              "fsdp": fsdp_case,
              "resume": lambda case, weights: resume_case(case)}


def refusals(weights: dict) -> dict:
    """Degrees the group cannot hold: what each raises on this rank."""
    from repro_torch.serving import ShardedContinuousBatchingEngine

    model, params = port_model("deepseek-moe-16b",
                               weights["deepseek-moe-16b"])
    world = dist.get_world_size()
    out = {}
    for shard in (2 * world, "auto"):
        try:
            eng = ShardedContinuousBatchingEngine(
                model, params, shard=shard, device="cpu", max_len=32,
                batch_size=2, page_size=8)
            out[shard] = ("ok", eng.shard)
        except (ValueError, RuntimeError) as exc:
            out[shard] = (type(exc).__name__, str(exc))
    return out


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               cases: list, weights: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {case["name"]: RANK_CASES.get(case.get("kind"), serve_case)(
            case, weights) for case in cases}
        res["_refusals"] = refusals(weights)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` gloo ranks serving ``cases``, started at once
    (``torch.multiprocessing``, the spawn method), so that the caller
    can work while they run. ``target(rank, world, store, out_dir, cases,
    weights)`` is each rank's function (default: serve the cases through
    the sharded engine); it writes ``rank{r}.pkl`` into ``out_dir``."""

    def __init__(self, world: int, cases: list, weights: dict,
                 target=None):
        self.world = world
        self._tmp = tempfile.TemporaryDirectory()
        store = os.path.join(self._tmp.name, "store")
        self._ctx = mp.spawn(
            target or _rank_main,
            args=(world, store, self._tmp.name, cases, weights),
            nprocs=world, join=False)

    def results(self) -> list[dict]:
        """Each rank's results, in rank order, once all have ended. A
        rank's exception is raised here."""
        while not self._ctx.join():
            pass
        out = []
        for r in range(self.world):
            with open(os.path.join(self._tmp.name, f"rank{r}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
        return out

    def close(self) -> None:
        """Stop any rank still running and remove the directory."""
        for proc in self._ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        self._tmp.cleanup()


def run_ranks(world: int, cases: list, weights: dict) -> list[dict]:
    """Spawn ``world`` gloo ranks over ``cases``; each rank's results, in
    rank order. A rank's exception fails the call."""
    ranks = Ranks(world, cases, weights)
    try:
        return ranks.results()
    finally:
        ranks.close()
