"""Training across ranks under the fsdp policy, with no spawn.

Ranks are threads of this process, each with its own ``ThreadShard``
(``tests/test_torch_seqcarry.py``: all-gather, reduce-scatter and
all-reduce through a hub, summed in rank order) seen through a
per-thread stand-in for ``distributed/ctx.fsdp_state``:

* the fsdp train step of internlm2-smoke in fp32 at degrees 2 and 4
  against the reference's jitted ``make_train_step`` on the ranks' rows
  concatenated: compression none, bf16 and int8, ``grad_accum`` 1 and
  2, 4 steps across the end of warmup; losses, grad norms and lr within
  ``STEP_RTOL``, every leaf (the ranks' blocks put together) within it
  of its norm, every rank the same metrics; the gradients before the
  first update within 1e-5 of each leaf's norm of the port's one-card
  step's;
* mamba2, recurrentgemma, whisper and internvl2 smoke configs at degree
  2 against the port's one-card step;
* ``chip_smoke.py``'s fsdp gates (``fsdp_step_gate``,
  ``fsdp_leaves_gate``) pass the clean run and reject each of
  ``FSDP_FAULTS`` (``planted_fsdp_fault``), labels masked unevenly over
  the ranks, as the card runs them;
* the bytes by kind against ``chip_smoke.fsdp_bytes``' arithmetic;
* ``run_cell``'s train cells, and an odd batch of an ssm and an audio
  stack and the launcher on a hybrid stack and on a sequence the degree
  does not divide, which take ``tp_sp`` (on thread ranks of
  ``tests/test_torch_tp_sp_train.py``);
* sharded checkpoints: a degree-4 save restores at degrees 3, 2 and 1
  bit for bit, the reference's ``CheckpointManager.restore`` reads it
  into the one-card save's arrays, and no half-written step is seen;
  ``plan_remesh`` against the reference's.

The multi-process runs (gloo ranks, ``launch/train.main`` resumed over
two ranks) are in ``tests/test_torch_sharded.py``'s spawns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import SyntheticLMData as JaxData
from repro.distributed.compression import init_error_feedback as jax_err
from repro.distributed.elastic import plan_remesh as jax_plan_remesh
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import ShapeCell, get_smoke
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import ctx
from repro_torch.distributed.compression import init_error_feedback
from repro_torch.distributed.elastic import plan_remesh
from repro_torch.distributed.sharding import (
    fsdp_blocks,
    local_opt_state,
    local_params,
)
from repro_torch.launch import dryrun, steps, train
from repro_torch.models.api import build_model
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves_with_paths, tree_map
from repro_torch.weights import params_from_jax
from test_torch_harness import model_pair
from test_torch_seqcarry import SMOKE, ThreadShard, _Hub
from test_torch_tp_sp_train import _LOCAL as TP_SP_LOCAL
from test_torch_tp_sp_train import on_ranks as tp_sp_ranks
from test_torch_train_step import OPT, STEP_RTOL, STEPS

GRAD_RTOL = 1e-5
BATCH, SEQ = 8, 16
OTHER_ARCHS = ("mamba2-130m", "recurrentgemma-9b", "whisper-large-v3",
               "internvl2-2b")

_LOCAL = threading.local()


@contextlib.contextmanager
def thread_fsdp():
    """While active, ``ctx.fsdp_state`` gives each thread its own shard
    (``_LOCAL.shard``, set by ``on_ranks``; this edits no file)."""
    real = ctx.fsdp_state
    ctx.fsdp_state = lambda: getattr(_LOCAL, "shard", None)
    try:
        yield
    finally:
        ctx.fsdp_state = real


def on_ranks(degree: int, fn) -> list:
    """``fn(shard)`` on ``degree`` threads, one a rank, each under the
    fsdp policy of its own ``ThreadShard`` -> their results in rank order;
    a rank's exception is raised here."""
    hub = _Hub(degree)
    out, errors = [None] * degree, []

    def run(rank):
        _LOCAL.shard = ThreadShard(None, rank, degree, hub=hub)
        try:
            out[rank] = fn(_LOCAL.shard)
        except BaseException as exc:      # re-raised below
            errors.append(exc)
            hub.barrier.abort()
        finally:
            _LOCAL.shard = None

    threads = [threading.Thread(target=run, args=(r,)) for r in range(degree)]
    with thread_fsdp():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _rows(batch: dict, shard, degree: int | None = None) -> dict:
    """The rank's rows of a global batch (tensors or numpy)."""
    n = degree or shard.degree
    per = batch["tokens"].shape[0] // n
    return {k: v[shard.rank * per:(shard.rank + 1) * per]
            for k, v in batch.items()}


def _whole(parts: list) -> dict:
    """The ranks' trees (rank order) as one whole tree: each split leaf's
    blocks concatenated on dim 0, a whole leaf as rank 0 holds it."""
    flat = [dict(leaves_with_paths(p)) for p in parts]
    out = {}
    for path, leaf in flat[0].items():
        blocks = [f[path].detach() for f in flat]
        same = all(b.shape == leaf.shape for b in blocks) and all(
            torch.equal(b, blocks[0]) for b in blocks)
        out[path] = blocks[0] if same else torch.cat(blocks, 0)
    return out


def _assert_leaves_close(got: dict, want, rtol: float) -> None:
    want = dict(leaves_with_paths(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(torch.linalg.vector_norm(got[path].double()
                                             - w.detach().double()))
        norm = float(torch.linalg.vector_norm(w.detach().double()))
        assert err <= rtol * norm, (path, err, norm)


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# the step against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair():
    return model_pair("internlm2-1.8b", jax_impl="xla_full")


def _data():
    return JaxData(vocab_size=_pair().jcfg.vocab_size, seq_len=SEQ,
                   global_batch=BATCH, seed=17)


@functools.lru_cache(maxsize=None)
def _reference_run(compression, grad_accum: int) -> tuple:
    """The reference's jitted step over STEPS steps of the global batch:
    (metrics a step, its trained params as the port's tree)."""
    pair = _pair()
    jstep = jax.jit(jax_make_train_step(pair.jmodel, JaxOptConfig(**OPT),
                                        compression, grad_accum))
    jparams, jopt = pair.jparams, jax_adamw_init(pair.jparams)
    if compression == "int8":
        jopt["err"] = jax_err(jparams)
    out = []
    for step in range(STEPS):
        jbatch = {k: jnp.asarray(v) for k, v in _data().batch_at(step).items()}
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        out.append(_metrics(jm))
    return out, params_from_jax(jax.tree.map(np.asarray, jparams), pair.tcfg,
                                device="cpu")


def _port_model(cfg=None):
    pair = _pair()
    cfg = cfg or dataclasses.replace(pair.tcfg, attn_impl="plain")
    return build_model(cfg)


def _fsdp_run(model, whole, batches, degree: int, compression, grad_accum,
              opt=OPT) -> list:
    """The fsdp step on ``degree`` thread ranks, each from its blocks of
    ``whole`` on its rows of each of ``batches`` (tensor dicts) -> each
    rank's (metrics a step, trained blocks, shard)."""
    def rank(shard):
        params = local_params(tree_map(torch.clone, whole), rank=shard.rank,
                              degree=degree, policy="fsdp")
        state = adamw_init(params)
        if compression == "int8":
            state["err"] = init_error_feedback(params)
        step = steps.make_train_step(model, OptConfig(**opt), compression,
                                     grad_accum)
        ms = []
        for batch in batches:
            params, state, m = step(params, state, _rows(batch, shard))
            ms.append(_metrics(m))
        return ms, params, shard

    return on_ranks(degree, rank)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("compression", [None, "bf16", "int8"])
@pytest.mark.parametrize("degree", [2, 4])
def test_fsdp_step_matches_the_reference(degree, compression, grad_accum):
    want, want_params = _reference_run(compression, grad_accum)
    batches = [train.batch_on(_data().batch_at(s), "cpu")
               for s in range(STEPS)]
    ranks = _fsdp_run(_port_model(), _pair().tparams, batches, degree,
                      compression, grad_accum)
    for step in range(STEPS):
        got = ranks[0][0][step]
        assert all(r[0][step] == got for r in ranks), step
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[step][key],
                                       rtol=STEP_RTOL,
                                       err_msg=f"{step} {key}")
    _assert_leaves_close(_whole([r[1] for r in ranks]), want_params,
                         STEP_RTOL)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("degree", [2, 4])
def test_fsdp_gradients_match_one_card(degree, grad_accum):
    """``make_loss_and_grads`` under fsdp: the rank's blocks of the global
    gradient (reduce-scattered, whole leaves all-reduced), before any
    update, within 1e-5 of each leaf's norm of the one-card gradient."""
    model = _port_model()
    batch = train.batch_on(_data().batch_at(0), "cpu")
    grads_fn = steps.make_loss_and_grads(model, grad_accum)
    loss, want = grads_fn(tree_map(torch.clone, _pair().tparams), batch)

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair().tparams),
                              rank=shard.rank, degree=degree, policy="fsdp")
        return grads_fn(params, _rows(batch, shard))

    ranks = on_ranks(degree, rank)
    assert all(float(r[0]) == float(ranks[0][0]) for r in ranks)
    np.testing.assert_allclose(float(ranks[0][0]), float(loss),
                               rtol=GRAD_RTOL)
    _assert_leaves_close(_whole([r[1] for r in ranks]), want, GRAD_RTOL)


def _family(arch: str):
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="chunked",
                              attn_chunk=8, compute_dtype=torch.float32)
    model = build_model(cfg)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=4, seed=17,
        frontend_tokens=cfg.num_frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model)
    return model, model.init(seed=0, device="cpu", dtype=torch.float32), \
        [train.batch_on(data.batch_at(s), "cpu") for s in range(2)]


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_fsdp_step_of_other_families_matches_one_card(arch):
    model, whole, batches = _family(arch)
    opt = dict(OPT, warmup_steps=1, total_steps=2)
    step = steps.make_train_step(model, OptConfig(**opt), "int8")
    params = tree_map(torch.clone, whole)
    state = adamw_init(params)
    state["err"] = init_error_feedback(params)
    want = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        want.append(_metrics(m))
    ranks = _fsdp_run(model, whole, batches, 2, "int8", 1, opt)
    for s, w in enumerate(want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ranks[0][0][s][key], w[key],
                                       rtol=STEP_RTOL, err_msg=f"{s} {key}")
    _assert_leaves_close(_whole([r[1] for r in ranks]), params, STEP_RTOL)


def test_loss_fn_under_fsdp_is_the_global_token_mean():
    """With labels masked unevenly over the ranks, each rank's loss (its
    masked sum over the all-reduced count) sums to the one-card mean."""
    model = _port_model()
    batch = train.batch_on(SMOKE.uneven_labels(
        _data().batch_at(0), 1, 2), "cpu")
    want = float(model.loss_fn(_pair().tparams, batch))

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair().tparams),
                              rank=shard.rank, degree=2, policy="fsdp")
        with torch.no_grad():
            return float(model.loss_fn(params, _rows(batch, shard)))

    got = on_ranks(2, rank)
    np.testing.assert_allclose(sum(got), want, rtol=1e-6)
    assert abs(got[0] - got[1]) > 1e-3      # the masks made them differ


def test_gather_leaf_gathers_and_reduce_scatters():
    """``ctx.GatherLeaf``: the blocks cast and gathered in rank order; the
    backward, the whole gradient in fp32 summed over the ranks, the
    rank's block of it."""
    whole = torch.arange(24.0).reshape(6, 4)

    def rank(shard):
        block = whole[shard.rank * 2:(shard.rank + 1) * 2].clone()
        block.requires_grad_(True)
        got = ctx.GatherLeaf.apply(block, shard, torch.bfloat16)
        (got.float() * (shard.rank + 1)).sum().backward()
        return got.detach(), block.grad

    for r, (got, grad) in enumerate(on_ranks(3, rank)):
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(),
                                                           whole)
        assert grad.dtype == torch.float32
        assert torch.equal(grad, torch.full((2, 4), 6.0))


# ---------------------------------------------------------------------------
# chip_smoke.py's gates and the planted faults
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gate_setup(kind: str):
    """internlm2-smoke in fp32 with random norm scales, 2 steps of 4
    sequences with labels masked unevenly over 4 ranks, compressed as
    the card's run ``kind`` (``chip_smoke.TRAIN_SHARDED_KINDS``): (model,
    whole weights, the ranks' batches a step, the one-card metrics and
    trained weights)."""
    pair = model_pair("internlm2-1.8b", jax_impl="xla_full", norm_std=2.0)
    model = build_model(dataclasses.replace(pair.tcfg, attn_impl="chunked",
                                            attn_chunk=8))
    compression = SMOKE.TRAIN_SHARDED_KINDS[kind][1]
    batches = [SMOKE.sharded_batches(lambda r: SyntheticLMData(
        vocab_size=pair.tcfg.vocab_size, seq_len=SEQ, global_batch=4,
        seed=17, process_index=r, process_count=4), 4, s, True)
        for s in range(2)]
    step = steps.make_train_step(model, OptConfig(**OPT), compression)
    params = tree_map(torch.clone, pair.tparams)
    state = adamw_init(params)
    if compression:
        state["err"] = init_error_feedback(params)
    want = []
    for parts in batches:
        params, state, m = step(params, state, train.batch_on(
            SMOKE.concat_batches(parts), "cpu"))
        want.append(_metrics(m))
    return model, pair.tparams, batches, want, params


def _gated_run(kind: str, fault=None) -> dict:
    model, whole, batches, want, want_params = _gate_setup(kind)
    compression = SMOKE.TRAIN_SHARDED_KINDS[kind][1]

    def rank(shard):
        params = local_params(tree_map(torch.clone, whole), rank=shard.rank,
                              degree=4, policy="fsdp")
        state = adamw_init(params)
        if compression:
            state["err"] = init_error_feedback(params)
        step = steps.make_train_step(model, OptConfig(**OPT), compression)
        ms = []
        for parts in batches:
            params, state, m = step(params, state,
                                    train.batch_on(parts[shard.rank], "cpu"))
            ms.append(_metrics(m))
        return ms, SMOKE.fsdp_leaf_errs(torch, params, want_params, shard)

    ctx_ = (SMOKE.planted_fsdp_fault(fault, layer_leaves=(
        SMOKE.layer_split_leaves(model.cfg, 4))) if fault
        else contextlib.nullcontext())
    with ctx_:
        ranks = on_ranks(4, rank)
    steps_limit, leaf_limit = SMOKE.TRAIN_SHARDED_GATES[kind]
    return {"steps": SMOKE.fsdp_step_gate(ranks[0][0], want, steps_limit),
            "leaves": SMOKE.fsdp_leaves_gate(ranks[0][1], leaf_limit)}


@pytest.mark.parametrize("kind", ["fp32", "fp32_int8"])
def test_the_fsdp_gates_pass_the_clean_run(kind):
    gates = _gated_run(kind)
    assert not gates["steps"]["failures"], gates["steps"]
    assert not gates["leaves"]["failures"], gates["leaves"]


@pytest.mark.parametrize("fault", SMOKE.FSDP_FAULTS)
def test_the_fsdp_gates_reject_each_planted_fault(fault):
    gates = _gated_run(SMOKE.FAULT_KIND[fault], fault)
    assert gates["steps"]["failures"] or gates["leaves"]["failures"], gates


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("degree", [2, 4])
def test_bytes_by_kind_are_the_shapes(degree, compression, grad_accum):
    """One step's bytes a rank by kind, sent and received, equal
    ``chip_smoke.fsdp_bytes``' arithmetic on the shapes."""
    model = _port_model()
    batch = train.batch_on(_data().batch_at(0), "cpu")

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair().tparams),
                              rank=shard.rank, degree=degree, policy="fsdp")
        state = adamw_init(params)
        if compression:
            state["err"] = init_error_feedback(params)
        steps.make_train_step(model, OptConfig(**OPT), compression,
                              grad_accum)(params, state, _rows(batch, shard))
        return dict(shard.sent), dict(shard.received)

    want = SMOKE.fsdp_bytes(model.cfg, degree, grad_accum,
                            int8=compression == "int8")
    for sent, received in on_ranks(degree, rank):
        assert {k: sent[k] for k in want} == want
        assert {k: received[k] for k in want} == want
        assert sum(sent.values()) == sum(want.values())


# ---------------------------------------------------------------------------
# run_cell and the launcher
# ---------------------------------------------------------------------------


def test_run_cell_trains_a_dense_cell_under_fsdp(monkeypatch):
    """A train cell on 2 thread ranks: the fsdp policy, the rank's record,
    the same losses on every rank, equal to the one-card step on the
    ranks' batches concatenated."""
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              compute_dtype=torch.float32)
    cell = ShapeCell("train_tiny", 24, 4, "train")
    monkeypatch.setattr(dryrun, "sharding_policy",
                        lambda shard, kind: contextlib.nullcontext())
    ranks = on_ranks(2, lambda sh: dryrun.run_cell(cfg, cell, sh,
                                                   device="cpu", steps=2))
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    step = steps.make_train_step(model, OptConfig(lr=3e-3, warmup_steps=0,
                                                  total_steps=2))
    state = adamw_init(params)
    want = []
    for s in range(2):
        parts = [SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=24,
                                 global_batch=4, seed=5, process_index=r,
                                 process_count=2).batch_at(s)
                 for r in range(2)]
        params, state, m = step(params, state, train.batch_on(
            SMOKE.concat_batches(parts), "cpu"))
        want.append(float(m["loss"]))
    for r, (rec, outs) in enumerate(ranks):
        assert (rec["policy"], rec["degree"], rec["rank"]) == ("fsdp", 2, r)
        assert rec["kind"] == "train" and rec["steps"] == 2
        assert rec["step_device_ms"] == "not measured"
        assert rec["sent_bytes"]["weights"] > 0
        assert rec["sent_bytes"]["reduce_scatter"] > 0
        assert rec["losses"] == ranks[0][0]["losses"]
    np.testing.assert_allclose(ranks[0][0]["losses"], want, rtol=STEP_RTOL)


@pytest.mark.parametrize("arch,batch", [("mamba2-130m", 3),
                                        ("whisper-large-v3", 3)])
def test_tp_sp_train_cells_are_refused(arch, batch, monkeypatch):
    """An odd batch trains under tp_sp, for every stack (the name is the
    case's older one): ``run_cell`` trains the cell of an ssm and an
    audio stack on two thread ranks, its exchanges counted (an SSD
    layer's halo and carry, the encoder's and memories' gathers), the
    same losses on every rank, within STEP_RTOL of the one-card step on
    the same batches."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=torch.float32)
    cell = ShapeCell("train_tiny", 24, batch, "train")
    monkeypatch.setattr(dryrun, "sharding_policy",
                        lambda shard, kind: contextlib.nullcontext())
    ranks = tp_sp_ranks(2, lambda sh: dryrun.run_cell(cfg, cell, sh,
                                                      device="cpu", steps=2))
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    step = steps.make_train_step(model, OptConfig(lr=3e-3, warmup_steps=0,
                                                  total_steps=2))
    state = adamw_init(params)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=24,
                           global_batch=batch, seed=5,
                           frontend_tokens=cfg.num_frontend_tokens
                           if cfg.frontend else 0, d_model=cfg.d_model)
    want = []
    for i in range(2):
        params, state, m = step(params, state,
                                train.batch_on(data.batch_at(i), "cpu"))
        want.append(float(m["loss"]))
    kinds = ("halo", "carry") if cfg.ssm is not None else ("gather",)
    for r, (rec, _) in enumerate(ranks):
        assert (rec["policy"], rec["degree"], rec["rank"]) == ("tp_sp", 2, r)
        assert all(rec["sent_bytes"][k] > 0 for k in kinds)
        assert rec["losses"] == ranks[0][0]["losses"]
    np.testing.assert_allclose(ranks[0][0]["losses"], want, rtol=STEP_RTOL)


def test_the_launcher_refuses_tp_sp_across_ranks(monkeypatch):
    """The launcher trains under tp_sp across ranks a hybrid stack at an
    odd batch and a dense one at a sequence the degree does not divide
    (the name is the case's older one): on two thread ranks (the group's
    rank and ``SeqShard`` the thread's), every rank the same losses,
    within STEP_RTOL of one process's."""
    def thread_shard():
        return getattr(TP_SP_LOCAL, "shard", None)

    monkeypatch.setattr(train, "sharding_policy",
                        lambda shard, kind: contextlib.nullcontext())
    monkeypatch.setattr(train, "join_group", lambda device: (
        (thread_shard().rank, 2, False) if thread_shard() else (0, 1, False)))
    monkeypatch.setattr(train, "SeqShard", lambda group, rank, degree: (
        thread_shard() or ctx.SeqShard(group, rank, degree)))
    for argv in (["--arch", "recurrentgemma-9b", "--seq", "32"],
                 ["--arch", "qwen3-1.7b", "--seq", "25"]):
        argv = argv + ["--smoke", "--steps", "2", "--batch", "3",
                       "--device", "cpu"]
        want = train.main(argv)
        got = tp_sp_ranks(2, lambda sh: train.main(argv))
        assert got[0] == got[1] and len(got[0]) == 2
        np.testing.assert_allclose(got[0], want, rtol=STEP_RTOL)


def test_an_moe_forward_under_fsdp_is_refused():
    cfg = get_smoke("deepseek-moe-16b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with ctx.sharding_policy(ctx.SeqShard(None, 0, 1), "fsdp"), \
            pytest.raises(NotImplementedError, match="item 3b"):
        model.forward(params, torch.ones((1, 4), dtype=torch.long), cfg)


def test_local_opt_state_cuts_the_moments_as_the_params():
    params = _pair().tparams
    state = adamw_init(params)
    state["err"] = init_error_feedback(params)
    got = local_opt_state(state, rank=1, degree=4)
    want = local_params(params, rank=1, degree=4, policy="fsdp")
    for key in ("mu", "nu", "err"):
        for (pa, a), (pb, b) in zip(leaves_with_paths(got[key]),
                                    leaves_with_paths(want)):
            assert pa == pb and a.shape == b.shape
    assert got["step"] is state["step"]


# ---------------------------------------------------------------------------
# checkpoints and plan_remesh
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trained_state():
    """(the whole state after one fsdp step at degree 4, assembled from
    the ranks' blocks, and each rank's blocks)."""
    model = _port_model()
    batch = train.batch_on(_data().batch_at(0), "cpu")

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair().tparams),
                              rank=shard.rank, degree=4, policy="fsdp")
        state = adamw_init(params)
        state["err"] = init_error_feedback(params)
        params, state, _ = steps.make_train_step(
            model, OptConfig(**OPT), "int8")(params, state,
                                             _rows(batch, shard))
        return {"params": tree_map(lambda t: t.detach(), params),
                "opt": state}

    parts = on_ranks(4, rank)
    flat = _whole(parts)
    whole = tree_map(lambda _: None, parts[0])

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix[:-1]]

    return fill(whole), parts


def _on_threads(fn, managers: list) -> None:
    """``fn(rank, manager)`` on a thread a rank, every manager opened
    first (the barrier the launcher puts between opening and saving)."""
    threads = [threading.Thread(target=fn, args=(r, m))
               for r, m in enumerate(managers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def _save_sharded(directory: str, parts: list, whole: dict) -> None:
    """Each rank's blocks saved asynchronously from its own thread."""
    def rank(r, mgr):
        mgr.save(3, parts[r], blocking=False,
                 shardings=fsdp_blocks(whole, rank=r, degree=len(parts)))
        mgr.wait()

    _on_threads(rank, [CheckpointManager(directory, rank=r,
                                         degree=len(parts))
                       for r in range(len(parts))])


def test_a_degree_4_save_restores_at_3_2_and_1_bit_for_bit(tmp_path):
    whole, parts = _trained_state()
    _save_sharded(str(tmp_path), parts, whole)
    assert latest_step(str(tmp_path)) == 3
    files = os.listdir(tmp_path / "step_000000003")
    assert not any(f.startswith("done.") for f in files)
    assert sum(f.endswith(".s3.npy") for f in files) > 0
    for degree in (3, 2, 1):
        for r in range(degree):
            got = CheckpointManager(str(tmp_path), rank=r,
                                    degree=degree).restore(
                3, whole, device="cpu",
                shardings=fsdp_blocks(whole, rank=r, degree=degree))
            want = {"params": local_params(whole["params"], rank=r,
                                           degree=degree, policy="fsdp"),
                    "opt": local_opt_state(whole["opt"], rank=r,
                                           degree=degree)}
            for (pa, a), (pb, b) in zip(leaves_with_paths(got),
                                        leaves_with_paths(want)):
                assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    one = CheckpointManager(str(tmp_path)).restore(3, whole, device="cpu")
    for (pa, a), (_, b) in zip(leaves_with_paths(one),
                               leaves_with_paths(whole)):
        assert torch.equal(a, b), pa


def test_the_reference_restores_a_port_sharded_checkpoint(tmp_path):
    """The reference's ``CheckpointManager.restore`` reads the port's
    sharded save into the whole arrays of the port's one-process save."""
    whole, parts = _trained_state()
    _save_sharded(str(tmp_path / "sharded"), parts, whole)
    CheckpointManager(str(tmp_path / "one")).save(3, whole)
    target = tree_map(lambda t: np.zeros(0), whole)
    got = JaxCheckpointManager(str(tmp_path / "sharded")).restore(3, target)
    want = JaxCheckpointManager(str(tmp_path / "one")).restore(3, target)
    flat_got = dict(leaves_with_paths(jax.tree.map(np.asarray, got)))
    for path, w in leaves_with_paths(jax.tree.map(np.asarray, want)):
        assert flat_got[path].dtype == w.dtype
        np.testing.assert_array_equal(flat_got[path], w, err_msg=path)
    np.testing.assert_array_equal(
        flat_got["params/embed"], whole["params"]["embed"].numpy())


def test_no_half_written_step_is_seen(tmp_path):
    """Rank 0's writer waits for every rank's mark; until the last rank
    has written its blocks the step is not there."""
    whole, parts = _trained_state()
    mgrs = [CheckpointManager(str(tmp_path), rank=r, degree=4)
            for r in range(4)]
    for r in (0, 1, 2):
        mgrs[r].save(3, parts[r], blocking=False,
                     shardings=fsdp_blocks(whole, rank=r, degree=4))
    for r in (1, 2):
        mgrs[r].wait()
    assert latest_step(str(tmp_path)) is None
    mgrs[3].save(3, parts[3], shardings=fsdp_blocks(whole, rank=3,
                                                    degree=4))
    mgrs[0].wait()
    assert latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("prefer_model", [16, 8, 4])
def test_plan_remesh_is_the_reference(prefer_model):
    for n in range(1, 1025):
        assert plan_remesh(n, prefer_model=prefer_model) == \
            jax_plan_remesh(n, prefer_model=prefer_model), n


def test_a_second_save_of_a_step_does_not_wait_on_the_first(tmp_path):
    """The launcher saves its last step twice (every ``--save-every``
    steps and at the end): each save of a rank writes into a directory of
    its own, so a rank's second save never lands in the first's, which
    rank 0 renames, and neither waits forever."""
    whole, parts = _trained_state()

    def rank(r, mgr):
        blocks = fsdp_blocks(whole, rank=r, degree=4)
        mgr.save(3, parts[r], blocking=False, shardings=blocks)
        mgr.save(3, parts[r], shardings=blocks)
        mgr.wait()

    _on_threads(rank, [CheckpointManager(str(tmp_path), rank=r, degree=4)
                       for r in range(4)])
    assert os.listdir(tmp_path) == ["step_000000003"]
    got = CheckpointManager(str(tmp_path)).restore(3, whole, device="cpu")
    for (pa, a), (_, b) in zip(leaves_with_paths(got),
                               leaves_with_paths(whole)):
        assert torch.equal(a, b), pa
