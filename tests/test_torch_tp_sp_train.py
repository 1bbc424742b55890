"""Training across ranks under the tp_sp policy, with no spawn.

Ranks are threads of this process, each with its own ``A2AThreadShard``
(``ThreadShard`` of ``tests/test_torch_seqcarry.py`` with an
all-to-all: every exchange through a hub, sums in rank order) seen
through a per-thread stand-in for ``distributed/ctx.seq_shard_state``.
The batch is whole on every rank; the sequence splits over the ranks:

* the backwards of ``SeqShard.halo`` and ``SeqShard.carry`` (a causal
  conv's halo, one wider than a rank's block, the RG-LRU and SSD scans'
  carries) against the one-card gradient of the composed op at degrees
  2 and 4;
* the tp_sp train step of deepseek-moe-smoke and moonshot-smoke at
  degrees 2 and 4, at the config's capacity factor and at one where the
  groups drop assignments, compression none and int8, of
  internlm2-smoke at a global batch of 3, and of mamba2, recurrentgemma
  (degrees 2 and 4), whisper and internvl2 (degree 2) smoke at a global
  batch of 3, each from the rank's ``local_params(policy="tp_sp")``
  split against the reference's jitted ``make_train_step`` under its
  tp_sp grouping (``test_torch_seqshard.reference_policy``) over 4
  steps: losses, grad norms and lr within ``STEP_RTOL``, every leaf (the
  ranks' blocks put together along their dims) within it of its norm,
  every rank the same metrics;
* the gradients before any update against the port's one-card
  gradients under ``ctx.grouped_as`` (the same MoE groups), for every
  stack and for sequences the degree does not divide (the rows whole on
  every rank, each rank's loss a share of the label columns);
* ``Model.loss_fn`` of every stack and of a sequence the degree does not
  divide: the ranks' terms sum to the one-card loss;
* ``chip_smoke.py``'s tp_sp gates pass the clean runs and reject each of
  ``TP_SP_FAULTS``, and the bytes by kind equal ``chip_smoke.tp_sp_bytes``;
* ``run_cell`` trains an MoE cell, and degree-4 sharded checkpoints of
  a tp_sp state (an MoE and a hybrid stack) restore at 2 and on one rank
  bit for bit.

The multi-process runs (``launch/train.main`` over two gloo ranks,
resumed, and on a hybrid stack at an odd batch) are in
``tests/test_torch_sharded.py``'s spawns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMData as JaxData
from repro.distributed.compression import init_error_feedback as jax_err
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeCell, get_smoke
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import ctx
from repro_torch.distributed.compression import init_error_feedback
from repro_torch.distributed.sharding import (
    local_opt_state,
    local_params,
    tp_sp_blocks,
)
from repro_torch.launch import dryrun, steps, train
from repro_torch.models import rglru, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves_with_paths, tree_map
from repro_torch.weights import params_from_jax
from test_torch_harness import model_pair
from test_torch_seqcarry import SMOKE, ThreadShard, _Hub, _rnd
from test_torch_seqshard import reference_policy
from test_torch_train_step import OPT, STEP_RTOL, STEPS

GRAD_RTOL = 1e-5
SEQ = 32
MOE_ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
DENSE = "internlm2-1.8b"
DROP_CF = 1.0        # a capacity factor at which the groups drop
# int8: an element whose code differs from the reference's at some step
# must have sat on a rounding edge there (its two error feedbacks sum to
# within EDGE_RTOL of their difference, one code step: the other order of
# the ranks' sums, and after an earlier flip its Adam step's effect on
# the other gradients, move a value by at most ~5e-3 of a code step in
# these cases, where an element off the edges would give up to 1), and
# such elements are at most FLIP_SHARE of all (1.7e-4 at most here)
EDGE_RTOL = 1e-2
FLIP_SHARE = 1e-3
# An element on Adam's edge: its first update g / (|g| + eps) moves by
# 1% of the rate or more when g moves by 1e-6 of its leaf's largest
# gradient (the rounding of sums at the leaf's scale), i.e.
# (|g| + eps)^2 <= ADAM_EDGE * eps * max |g|
ADAM_EDGE = 1e-6 / 1e-2
# The stacks whose last leaves are held to the port's one-card step: an
# Adam edge at the first step (mamba2-smoke's layer-0 norm, a gradient
# of 1.2e-8) moves the rest by up to 1.4e-4 of a leaf's norm (layer 0's
# dt_bias after 4 steps) between the port's one-card step and the
# reference's, at the same scan chunk
ONE_CARD_LAST = ("mamba2-130m",)
BATCH = {"moe": 2, "dense": 3}
# the stacks beyond dense and MoE, whose tp_sp training runs through the
# halo and carry exchanges or the frontend rows (at an odd global batch)
OTHER_STACKS = ("mamba2-130m", "recurrentgemma-9b", "whisper-large-v3",
           "internvl2-2b")
ODD_SEQ = 30         # a sequence degree 4 does not divide (nor 4 + F)

_LOCAL = threading.local()


@dataclasses.dataclass
class A2AThreadShard(ThreadShard):
    """``ThreadShard`` with ``all_to_all``: block j of dim 0 to rank j,
    through the hub, counted as ``SeqShard``'s."""

    def all_to_all(self, x, kind="a2a"):
        if self.degree == 1:
            return x
        parts = self.hub.exchange(self.rank, x.contiguous())
        per = x.shape[0] // self.degree
        n = x.numel() * x.element_size() * (self.degree - 1) // self.degree
        self._count(kind, n, n)
        return torch.cat([p[self.rank * per:(self.rank + 1) * per]
                          for p in parts])


@contextlib.contextmanager
def thread_tp_sp():
    """While active, ``ctx.seq_shard_state`` (and the transformer's
    import of it) gives each thread its own shard (``_LOCAL.shard``, set
    by ``on_ranks``); with no policy set the kind is ``tp_sp``. This
    edits no file."""
    real = ctx.seq_shard_state

    def state():
        return getattr(_LOCAL, "shard", None)

    ctx.seq_shard_state = tfm.seq_shard_state = state
    try:
        yield
    finally:
        ctx.seq_shard_state = tfm.seq_shard_state = real


def on_ranks(degree: int, fn) -> list:
    """``fn(shard)`` on ``degree`` threads, one a rank, each under the
    tp_sp policy of its own ``A2AThreadShard`` -> their results in rank
    order; a rank's exception is raised here."""
    hub = _Hub(degree)
    out, errors = [None] * degree, []

    def run(rank):
        _LOCAL.shard = A2AThreadShard(None, rank, degree, hub=hub)
        try:
            out[rank] = fn(_LOCAL.shard)
        except BaseException as exc:      # re-raised below
            errors.append(exc)
            hub.barrier.abort()
        finally:
            _LOCAL.shard = None

    threads = [threading.Thread(target=run, args=(r,)) for r in range(degree)]
    with thread_tp_sp():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _whole(parts: list, like) -> dict:
    """The ranks' trees (rank order) as one whole tree by path: each
    leaf's blocks put together along the dim where they differ from
    ``like``'s whole leaf (``tp_sp_blocks``), a whole leaf as rank 0
    holds it."""
    shapes = {p: t.shape for p, t in leaves_with_paths(like)}
    flat = [dict(leaves_with_paths(p)) for p in parts]
    out = {}
    for path, leaf in flat[0].items():
        blocks = [f[path].detach() for f in flat]
        dims = [d for d in range(leaf.dim())
                if leaf.shape[d] != shapes[path][d]]
        out[path] = torch.cat(blocks, dims[0]) if dims else blocks[0]
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
def _pair(arch: str, cf: float | None):
    pair = model_pair(arch, jax_impl="xla_full")
    if cf is None:
        return pair
    jcfg = dataclasses.replace(pair.jcfg, moe=dataclasses.replace(
        pair.jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(pair.tcfg, moe=dataclasses.replace(
        pair.tcfg.moe, capacity_factor=cf))
    return dataclasses.replace(pair, jcfg=jcfg, tcfg=tcfg,
                               jmodel=dataclasses.replace(pair.jmodel,
                                                          cfg=jcfg))


def _batch_size(arch: str) -> int:
    return BATCH["moe" if "moe" in get_smoke(arch).family else "dense"]


def _data(arch: str, seq: int = SEQ):
    """The reference's data (the port's draws the same batches): a
    frontend stack's batches add stub frames or patch embeddings."""
    cfg = _pair(arch, None).jcfg
    return JaxData(vocab_size=cfg.vocab_size, seq_len=seq,
                   global_batch=_batch_size(arch), seed=17,
                   frontend_tokens=cfg.num_frontend_tokens
                   if cfg.frontend else 0, d_model=cfg.d_model)


def _one_card_model(model, seq: int, degree: int):
    """The one-card yardstick of a tp_sp run at ``degree``: ``model``,
    an SSD stack's scan at the chunk a rank's block runs (min(chunk,
    S/n) where the degree splits the rows): the chunked scan's rounding
    moves a_log's gradient ~1.3e-5 of its norm from chunk 32 to 16 on one
    card alone, which would hide the split's own error of ~7e-7."""
    cfg = model.cfg
    if cfg.ssm is None or seq % degree:
        return model
    return build_model(dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=min(cfg.ssm.chunk, seq // degree))))


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, cf, degree: int, compression) -> tuple:
    """The reference's jitted step under its tp_sp grouping at
    ``degree`` over STEPS steps: (metrics a step, its params after the
    first step and after the last, its int8 error feedback after each
    step, as the port's trees). An SSD stack's scan runs at the chunk a
    rank's block of the SEQ rows runs (``_one_card_model``)."""
    pair = _pair(arch, cf)
    if pair.jcfg.ssm is not None:
        jcfg = dataclasses.replace(pair.jcfg, ssm=dataclasses.replace(
            pair.jcfg.ssm, chunk=min(pair.jcfg.ssm.chunk, SEQ // degree)))
        pair = dataclasses.replace(pair, jcfg=jcfg, jmodel=dataclasses.replace(
            pair.jmodel, cfg=jcfg))
    jstep = jax.jit(jax_make_train_step(pair.jmodel, JaxOptConfig(**OPT),
                                        compression))
    jparams, jopt = pair.jparams, jax_adamw_init(pair.jparams)
    if compression == "int8":
        jopt["err"] = jax_err(jparams)
    out, trained, errs = [], [], []
    with reference_policy(degree, "tp_sp"):
        for step in range(STEPS):
            jbatch = {k: jnp.asarray(v)
                      for k, v in _data(arch).batch_at(step).items()}
            jparams, jopt, jm = jstep(jparams, jopt, jbatch)
            out.append(_metrics(jm))
            if step in (0, STEPS - 1):
                trained.append(params_from_jax(
                    jax.tree.map(np.asarray, jparams), pair.tcfg,
                    device="cpu"))
            if compression == "int8":
                errs.append(params_from_jax(
                    jax.tree.map(np.asarray, jopt["err"]), pair.tcfg,
                    device="cpu"))
    return out, trained, errs


def _port_model(arch: str, cf=None):
    cfg = dataclasses.replace(_pair(arch, cf).tcfg, attn_impl="chunked",
                              attn_chunk=8)
    return build_model(cfg)


def _tp_sp_run(model, whole, batches, degree: int, compression,
               opt=OPT) -> list:
    """The tp_sp step on ``degree`` thread ranks, each from its split of
    ``whole`` on every one of ``batches`` (whole tensor dicts) -> each
    rank's (metrics a step, trained split, shard, split after the first
    step, int8 error feedback after each step)."""
    def rank(shard):
        params = local_params(tree_map(torch.clone, whole), rank=shard.rank,
                              degree=degree, policy="tp_sp")
        state = adamw_init(params)
        if compression == "int8":
            state["err"] = init_error_feedback(params)
        step = steps.make_train_step(model, OptConfig(**opt), compression)
        ms, first, errs = [], None, []
        for batch in batches:
            params, state, m = step(params, state, batch)
            ms.append(_metrics(m))
            first = first or tree_map(lambda t: t.detach().clone(), params)
            if compression == "int8":
                errs.append(tree_map(torch.clone, state["err"]))
        return ms, params, shard, first, errs

    return on_ranks(degree, rank)


def _step_cases():
    """Each MoE stack at each degree at the config's capacity factor
    without compression and at DROP_CF with int8; the dense stack at an
    odd batch with either."""
    return [(arch, degree, cf, comp) for arch in MOE_ARCHS
            for degree in (2, 4) for cf, comp in ((None, None),
                                                  (DROP_CF, "int8"))] \
        + [(DENSE, 2, None, comp) for comp in (None, "int8")] \
        + [(arch, degree, None, None) for arch in OTHER_STACKS[:2]
           for degree in (2, 4)] \
        + [(arch, 2, None, None) for arch in OTHER_STACKS[2:]]


def _adam_edges(model, whole, batch) -> dict:
    """The elements on Adam's edge (ADAM_EDGE) by the one-card gradient
    on the first batch: AdamW's first update leaves them at the mercy of
    their gradient's rounding (one that is zero but for rounding:
    mamba2-smoke's first layer norm has one at 1.4e-8 in the port and
    1.1e-8 in the reference, whose updates then differ by 11% of the
    rate, on one card as across ranks). They must be at most FLIP_SHARE
    of the elements. -> {path: mask}."""
    _, grads = steps.make_loss_and_grads(model)(tree_map(torch.clone,
                                                         whole), batch)
    eps = OptConfig(**OPT).eps
    edges = {p: (g.abs() + eps) ** 2 <= ADAM_EDGE * eps * g.abs().max()
             for p, g in leaves_with_paths(grads)}
    total = sum(m.numel() for m in edges.values())
    assert sum(int(m.sum()) for m in edges.values()) <= FLIP_SHARE * total
    return edges


def _one_card_run(model, whole, batches):
    """The port's one-card train step from ``whole`` over ``batches`` ->
    the trained weights."""
    params = tree_map(torch.clone, whole)
    state = adamw_init(params)
    step = steps.make_train_step(model, OptConfig(**OPT))
    for batch in batches:
        params, state, _ = step(params, state, batch)
    return params


def _masked(got: dict, masks: dict, want) -> dict:
    """``got`` (leaves by path) with the masked elements taken from
    ``want``'s."""
    want = dict(leaves_with_paths(want))
    return {p: torch.where(masks[p], want[p].detach(), t)
            for p, t in got.items()}


def _code_flips(got_errs: list, want_errs: list) -> dict:
    """Each leaf's elements whose int8 code differs from the reference's
    at some step, found from the error feedback after each step (a code
    apart moves it by one code step, about twice the leaf's largest
    feedback; otherwise the two agree to rounding), each checked at the
    step it first differs to have sat on a rounding edge: there the two
    feedbacks are the edge's two sides, so their sum is within EDGE_RTOL
    of their difference. -> {path: mask}."""
    flips = {}
    for got, want in zip(got_errs, want_errs, strict=True):
        for path, w in leaves_with_paths(want):
            w, g = w.double(), got[path].double()
            apart = (g - w).abs() > 0.5 * float(w.abs().max())
            seen = flips.get(path, torch.zeros_like(apart))
            first = apart & ~seen
            edge = (g + w).abs() <= EDGE_RTOL * (g - w).abs()
            assert bool(edge[first].all()), (path, (g + w)[first & ~edge])
            flips[path] = seen | apart
    return flips


@pytest.mark.parametrize("arch,degree,cf,compression", _step_cases())
def test_tp_sp_step_matches_the_reference(arch, degree, cf, compression):
    """Metrics at every step and the leaves after the first and after the
    last within STEP_RTOL. With int8 the elements whose code took the
    other side of a rounding edge (``_code_flips``: the ranks' partial
    sums add in another order, so an element within ~1e-7 of an edge may
    round the other way, and Adam turns that into a step of its own) are
    left out of the last step's leaves, and they must be at most
    FLIP_SHARE of the elements. For the stacks beyond dense and MoE the
    elements on Adam's edge (``_adam_edges``) are left out of both
    leaves' comparisons; mamba2's last leaves are held to the port's
    one-card step (``_one_card_model``) instead, as its own last leaves
    miss the reference's by more than STEP_RTOL (``ONE_CARD_LAST``)."""
    cfg = _pair(arch, cf).tcfg
    # the reference's step depends on the degree only through its MoE
    # groups and (``_reference_run``) an SSD scan's chunk
    ref_degree = degree if cfg.moe is not None or cfg.ssm is not None else 2
    want, (want_first, want_last), want_errs = _reference_run(
        arch, cf, ref_degree, compression)
    batches = [train.batch_on(_data(arch).batch_at(s), "cpu")
               for s in range(STEPS)]
    model = _port_model(arch, cf)
    ranks = _tp_sp_run(model, _pair(arch, cf).tparams, batches, degree,
                       compression)
    for step in range(STEPS):
        got = ranks[0][0][step]
        assert all(r[0][step] == got for r in ranks), step
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want[step][key],
                                       rtol=STEP_RTOL,
                                       err_msg=f"{step} {key}")
    first = _whole([r[3] for r in ranks], want_first)
    last = _whole([r[1] for r in ranks], want_last)
    if arch in OTHER_STACKS:
        one_card = _one_card_model(model, SEQ, degree)
        edges = _adam_edges(one_card, _pair(arch, cf).tparams, batches[0])
        if arch in ONE_CARD_LAST:
            want_last = _one_card_run(one_card, _pair(arch, cf).tparams,
                                      batches)
        first, last = (_masked(t, edges, w) for t, w in (
            (first, want_first), (last, want_last)))
    _assert_leaves_close(first, want_first, STEP_RTOL)
    if compression == "int8":
        flips = _code_flips([_whole([r[4][s] for r in ranks], want_last)
                             for s in range(STEPS)], want_errs)
        total = sum(m.numel() for m in flips.values())
        assert sum(int(m.sum()) for m in flips.values()) <= FLIP_SHARE * total
        want_by_path = dict(leaves_with_paths(want_last))
        last = {p: torch.where(flips[p], want_by_path[p].detach(), t)
                for p, t in last.items()}
    _assert_leaves_close(last, want_last, STEP_RTOL)


@pytest.mark.parametrize("arch,degree,grad_accum", [
    (MOE_ARCHS[0], 2, 1), (MOE_ARCHS[0], 4, 1), (MOE_ARCHS[0], 2, 2),
    (DENSE, 2, 1)])
def test_tp_sp_gradients_match_one_card(arch, degree, grad_accum):
    """``make_loss_and_grads`` under tp_sp: the rank's blocks of the
    global gradient (split leaves reduce-scattered, experts complete,
    whole leaves all-reduced), before any update, within 1e-5 of each
    leaf's norm of the port's one-card gradient under
    ``ctx.grouped_as(degree)`` (the same MoE groups), at DROP_CF where
    the groups drop assignments; with ``grad_accum`` 2 each microbatch's
    loss over its own label count, as the reference's scan."""
    cf = DROP_CF if arch != DENSE else None
    model = _port_model(arch, cf)
    batch = train.batch_on(_data(arch).batch_at(0), "cpu")
    grads_fn = steps.make_loss_and_grads(model, grad_accum)
    with ctx.grouped_as(degree):
        loss, want = grads_fn(tree_map(torch.clone, _pair(arch, cf).tparams),
                              batch)
        if arch != DENSE:
            dropped = SMOKE.moe_routes(lambda: model.loss_fn(
                _pair(arch, cf).tparams, batch))[1]
            assert sum(int((~r.keep).sum()) for r in dropped) > 0

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair(arch, cf).tparams),
                              rank=shard.rank, degree=degree, policy="tp_sp")
        return grads_fn(params, batch)

    ranks = on_ranks(degree, rank)
    assert all(float(r[0]) == float(ranks[0][0]) for r in ranks)
    np.testing.assert_allclose(float(ranks[0][0]), float(loss),
                               rtol=GRAD_RTOL)
    _assert_leaves_close(_whole([r[1] for r in ranks], want), want,
                         GRAD_RTOL)


def _every_stack_grad_cases():
    """The stacks beyond dense and MoE at the step test's degrees, then
    sequences degree 4 does not divide: a dense, an ssm and an MoE
    stack."""
    return [(arch, degree, SEQ) for arch in OTHER_STACKS[:2]
            for degree in (2, 4)] \
        + [(arch, 2, SEQ) for arch in OTHER_STACKS[2:]] \
        + [(arch, 4, ODD_SEQ) for arch in (DENSE, OTHER_STACKS[0],
                                           MOE_ARCHS[0])]


@pytest.mark.parametrize("arch,degree,seq", _every_stack_grad_cases())
def test_tp_sp_gradients_of_every_stack_match_one_card(arch, degree, seq):
    """``make_loss_and_grads`` under tp_sp for the ssm, hybrid, audio and
    vision stacks (their halo and carry backwards, the split encoder and
    memories, the patch rows in the row split) and at sequences the
    degree does not divide (the rows whole on every rank, each rank's loss
    its share of the label columns): the global gradient before any
    update within GRAD_RTOL of each leaf's norm of the port's one-card
    gradient (``_one_card_model``, under ``ctx.grouped_as(degree)``),
    and every rank the same loss, within GRAD_RTOL of one card's. An SSD
    stack whose rows stay whole is held to the one-card gradients of the
    ranks' terms summed in rank order (``_share_grads``): splitting the
    sum alone moves mamba2-smoke's a_log gradient by 8e-5 of its norm at
    30 rows over 4 ranks (its terms cancel, and the chunked scan's
    rounding of it is ~1e-5 of its norm in any order)."""
    model = _port_model(arch)
    batch = train.batch_on(_data(arch, seq).batch_at(0), "cpu")
    whole = _pair(arch, None).tparams
    one_card = _one_card_model(model, seq, degree)
    with ctx.grouped_as(degree):
        loss, want = steps.make_loss_and_grads(one_card)(
            tree_map(torch.clone, whole), batch)
    if model.cfg.ssm is not None and seq % degree:
        want = _share_grads(one_card, whole, batch, degree)
    grads_fn = steps.make_loss_and_grads(model)

    def rank(shard):
        params = local_params(tree_map(torch.clone, whole), rank=shard.rank,
                              degree=degree, policy="tp_sp")
        return grads_fn(params, batch)

    ranks = on_ranks(degree, rank)
    assert all(float(r[0]) == float(ranks[0][0]) for r in ranks)
    np.testing.assert_allclose(float(ranks[0][0]), float(loss),
                               rtol=GRAD_RTOL)
    _assert_leaves_close(_whole([r[1] for r in ranks], want), want,
                         GRAD_RTOL)


def _share_grads(model, whole, batch, degree: int):
    """The one-card gradients of the ranks' loss terms where the rows stay
    whole (each term its share of the label columns over the batch's
    whole label count, ``tfm.tp_sp_rows``), summed in rank order."""
    labels = batch["labels"]
    count = float((labels >= 0).sum())
    total = None
    for r in range(degree):
        _, cols, _ = tfm.tp_sp_rows(labels.shape[1], labels.shape[1],
                                    ctx.SeqShard(None, r, degree))
        mine = torch.full_like(labels, -1)
        mine[:, cols] = labels[:, cols]
        params = tree_map(lambda t: t.clone().requires_grad_(True), whole)
        term = model.loss_fn(params, {**batch, "labels": mine})
        (term * float((mine >= 0).sum()) / count).backward()
        grads = tree_map(lambda t: t.grad, params)
        total = grads if total is None else tree_map(torch.add, total,
                                                     grads)
    return total


HALO_ROWS = 16      # the rows of the collectives' case


def _halo_case(degree: int, width: int):
    """A depthwise causal conv of ``width`` over (2, HALO_ROWS, 3) rows
    (``ssm._causal_conv``): its inputs, weights and the loss's weights;
    the one-card op and a rank's op on its rows through ``halo``."""
    x, w, g = _rnd(1, 2, HALO_ROWS, 3), _rnd(2, width, 3), _rnd(3, 2,
                                                                HALO_ROWS, 3)

    def one(x):
        return (ssm._causal_conv(x, w)[0] * g).sum()

    def split(shard, x, rows):
        before, _ = shard.halo(x, width - 1)
        y = ssm._causal_conv(x, w, ctx.zero_front(before, width - 1))[0]
        return (y * g[:, rows]).sum()

    return (x,), one, split


def _rglru_case(degree: int):
    """The RG-LRU scan over (2, HALO_ROWS, 3): log decays and inputs, the
    one-card ``affine_scan`` and a rank's ``affine_scan_split``."""
    log_a = -torch.rand((2, HALO_ROWS, 3),
                        generator=torch.Generator().manual_seed(4))
    b, g = _rnd(5, 2, HALO_ROWS, 3), _rnd(6, 2, HALO_ROWS, 3)

    def one(log_a, b):
        return (rglru.affine_scan(torch.exp(log_a), b) * g).sum()

    def split(shard, log_a, b, rows):
        h, _ = rglru.affine_scan_split(torch.exp(log_a), log_a, b, shard)
        return (h * g[:, rows]).sum()

    return (log_a, b), one, split


def _ssd_case(degree: int):
    """The SSD scan over (2, HALO_ROWS, 2 heads) of P 3, N 4, at the chunk
    a rank's block runs: the one-card ``ssd_chunked`` and a rank's
    ``ssd_scan_split``."""
    chunk = HALO_ROWS // degree
    x, bm, cm = (_rnd(7 + i, 2, HALO_ROWS, 2, n)
                 for i, n in enumerate((3, 4, 4)))
    a = -torch.rand((2, HALO_ROWS, 2),
                    generator=torch.Generator().manual_seed(10))
    g = _rnd(11, 2, HALO_ROWS, 2, 3)

    def one(x, a, bm, cm):
        return (ssm.ssd_chunked(x, a, bm, cm, chunk)[0] * g).sum()

    def split(shard, x, a, bm, cm, rows):
        y, _ = ssm.ssd_scan_split(ssm.ssd_chunked, x, a, bm, cm, chunk,
                                  shard)
        return (y * g[:, rows]).sum()

    return (x, a, bm, cm), one, split


@pytest.mark.parametrize("degree", (2, 4))
@pytest.mark.parametrize("case", ("conv_halo", "wide_halo", "rglru_carry",
                                  "ssd_carry"))
def test_halo_and_carry_backwards_match_one_card(case, degree):
    """The gradient of a split op's loss (its output times fixed random
    weights, summed over the ranks) with respect to its inputs, each rank
    running its block of rows through ``SeqShard.halo`` or ``carry`` and
    their backwards, the ranks' blocks put together, within GRAD_RTOL of
    each input's norm of the one-card op's: a conv of width 4 (a halo of
    3 rows), one whose halo of 2·S/n + 1 rows is wider than two blocks,
    the RG-LRU scan's carry and the SSD scan's."""
    inputs, one, split = {
        "conv_halo": lambda: _halo_case(degree, 4),
        "wide_halo": lambda: _halo_case(degree, 2 * HALO_ROWS // degree + 2),
        "rglru_carry": lambda: _rglru_case(degree),
        "ssd_carry": lambda: _ssd_case(degree)}[case]()
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    one(*leaves).backward()
    per = HALO_ROWS // degree

    def rank(shard):
        rows = slice(shard.rank * per, (shard.rank + 1) * per)
        mine = [t[:, rows].clone().requires_grad_(True) for t in inputs]
        split(shard, *mine, rows).backward()
        return [t.grad for t in mine], dict(shard.sent)

    ranks = on_ranks(degree, rank)
    for i, want in enumerate(leaves):
        got = torch.cat([r[0][i] for r in ranks], 1)
        err = float(torch.linalg.vector_norm(got.double()
                                             - want.grad.double()))
        assert err <= GRAD_RTOL * float(torch.linalg.vector_norm(
            want.grad.double())), (i, err)
    kind = case.split("_")[1]
    assert all(r[1][kind] > 0 and r[1][f"{kind}_grad"] > 0 for r in ranks)


def test_loss_terms_sum_to_the_one_card_loss():
    """Each rank's loss (its rows' masked sum over the whole batch's
    label count, plus its aux term) sums to the one-card loss under the
    same grouping; with labels masked on the last rank's columns only the
    terms differ."""
    model = _port_model(MOE_ARCHS[0])
    batch = train.batch_on(_data(MOE_ARCHS[0]).batch_at(0), "cpu")
    batch["labels"][:, SEQ // 2:] = -1
    with ctx.grouped_as(2), torch.no_grad():
        want = float(model.loss_fn(_pair(MOE_ARCHS[0], None).tparams, batch))

    def rank(shard):
        with torch.no_grad():
            return float(model.loss_fn(_pair(MOE_ARCHS[0], None).tparams,
                                       batch))

    got = on_ranks(2, rank)
    np.testing.assert_allclose(sum(got), want, rtol=1e-6)
    assert abs(got[0] - got[1]) > 1e-2


# ---------------------------------------------------------------------------
# every stack, any sequence
# ---------------------------------------------------------------------------


def _loss_terms(cfg, seq: int, degree: int) -> tuple:
    """``Model.loss_fn`` of ``cfg``'s model (its own fp32 init) on one
    seeded batch of ``seq`` tokens (and frames or patches): (the one-card
    loss under ``ctx.grouped_as(degree)``, each thread rank's term under
    tp_sp, which it differentiates)."""
    model = build_model(dataclasses.replace(cfg, attn_impl="chunked",
                                            attn_chunk=8))
    params = model.init(0, device="cpu", dtype=torch.float32)
    batch = train.batch_on(SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1, seed=3,
        frontend_tokens=cfg.num_frontend_tokens if cfg.frontend else 0,
        d_model=cfg.d_model).batch_at(0), "cpu")
    with ctx.grouped_as(degree), torch.no_grad():
        want = float(model.loss_fn(params, batch))

    def rank(shard):
        mine = tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss = model.loss_fn(mine, batch)
        loss.backward()
        return float(loss.detach())

    return want, on_ranks(degree, rank)


@pytest.mark.parametrize("arch", OTHER_STACKS)
def test_other_stacks_raise_under_tp_sp_training(arch):
    """The ssm, hybrid, audio and vision stacks train under tp_sp
    (``Model.loss_fn`` through ``transformer.tp_sp_forward``, a backward
    on every rank): on two thread ranks the ranks' terms sum to the
    one-card loss."""
    want, got = _loss_terms(get_smoke(arch), 8, 2)
    np.testing.assert_allclose(sum(got), want, rtol=1e-5)


def test_a_sequence_the_degree_does_not_divide_raises():
    """A sequence the degree does not divide trains under tp_sp: every
    rank keeps the rows whole (a vision input's F patch rows too) and
    its loss covers its share of the label columns, the shares disjoint
    and covering every column (``tp_sp_rows``); on two thread ranks an
    MoE stack's terms at 25 tokens sum to the one-card loss."""
    for total, texts in ((25, 25), (33, 25)):
        parts = [tfm.tp_sp_rows(total, texts, ctx.SeqShard(None, r, 2))
                 for r in range(2)]
        assert all(rows == slice(0, total) for rows, _, _ in parts)
        assert [(c.start, c.stop) for _, c, _ in parts] == [(0, 12), (12, 25)]
        assert all(k.start - c.start == total - texts and
                   k.stop - k.start == c.stop - c.start
                   for _, c, k in parts)
    want, got = _loss_terms(get_smoke(MOE_ARCHS[0]), 25, 2)
    np.testing.assert_allclose(sum(got), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# chip_smoke.py's gates, the planted faults and the bytes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gate_setup():
    """deepseek-moe-smoke in fp32 with random norm scales at DROP_CF, 2
    steps of the whole batch: (model, whole weights, batches, the
    one-card metrics and trained weights under ``ctx.grouped_as(4)``)."""
    pair = model_pair(MOE_ARCHS[0], jax_impl="xla_full", norm_std=2.0)
    cfg = dataclasses.replace(pair.tcfg, attn_impl="chunked", attn_chunk=8,
                              moe=dataclasses.replace(pair.tcfg.moe,
                                                      capacity_factor=DROP_CF))
    model = build_model(cfg)
    batches = [train.batch_on(_data(MOE_ARCHS[0]).batch_at(s), "cpu")
               for s in range(2)]
    step = steps.make_train_step(model, OptConfig(**OPT))
    params = tree_map(torch.clone, pair.tparams)
    state = adamw_init(params)
    want = []
    with ctx.grouped_as(4):
        for batch in batches:
            params, state, m = step(params, state, batch)
            want.append(_metrics(m))
    return model, pair.tparams, batches, want, params


@functools.lru_cache(maxsize=None)
def _recurrent_gate_setup():
    """recurrentgemma-smoke (conv halos, scan carries and a window's K/V
    halo) in fp32 with random norm scales, 2 steps of a global batch of
    3: (model, whole weights, batches, the one-card metrics and trained
    weights)."""
    arch = OTHER_STACKS[1]
    pair = model_pair(arch, jax_impl="xla_full", norm_std=2.0)
    model = build_model(dataclasses.replace(pair.tcfg, attn_impl="chunked",
                                            attn_chunk=8))
    batches = [train.batch_on(_data(arch).batch_at(s), "cpu")
               for s in range(2)]
    step = steps.make_train_step(model, OptConfig(**OPT))
    params = tree_map(torch.clone, pair.tparams)
    state = adamw_init(params)
    want = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        want.append(_metrics(m))
    return model, pair.tparams, batches, want, params


def _gated_run(fault=None, recurrent: bool = False) -> dict:
    model, whole, batches, want, want_params = (
        _recurrent_gate_setup() if recurrent else _gate_setup())

    def rank(shard):
        params = local_params(tree_map(torch.clone, whole), rank=shard.rank,
                              degree=4, policy="tp_sp")
        state = adamw_init(params)
        step = steps.make_train_step(model, OptConfig(**OPT))
        ms = []
        for batch in batches:
            params, state, m = step(params, state, batch)
            ms.append(_metrics(m))
        return ms, SMOKE.fsdp_leaf_errs(torch, params, want_params, shard)

    ctx_ = (SMOKE.planted_tp_sp_fault(fault, model.cfg) if fault
            else contextlib.nullcontext())
    with ctx_:
        ranks = on_ranks(4, rank)
    steps_limit, leaf_limit = SMOKE.TRAIN_TP_SP_GATES["fp32"]
    return {"steps": SMOKE.fsdp_step_gate(ranks[0][0], want, steps_limit),
            "leaves": SMOKE.fsdp_leaves_gate(ranks[0][1], leaf_limit)}


def test_the_tp_sp_gates_pass_the_clean_run():
    gates = _gated_run()
    assert not gates["steps"]["failures"], gates["steps"]
    assert not gates["leaves"]["failures"], gates["leaves"]


def test_the_tp_sp_gates_pass_the_clean_recurrent_run():
    gates = _gated_run(recurrent=True)
    assert not gates["steps"]["failures"], gates["steps"]
    assert not gates["leaves"]["failures"], gates["leaves"]


@pytest.mark.parametrize("fault", SMOKE.TP_SP_FAULTS)
def test_the_tp_sp_gates_reject_each_planted_fault(fault):
    """Each fault rejected; the recurrent layers' (planted into the hybrid
    stack's run) by at least ``FAULT_MARGIN`` times a gate's limit, as
    the card requires."""
    recurrent = fault in SMOKE.RECURRENT_FAULTS
    gates = _gated_run(fault, recurrent)
    assert gates["steps"]["failures"] or gates["leaves"]["failures"], gates
    if recurrent:
        assert SMOKE.gate_margin(gates["steps"], gates["leaves"]) \
            >= SMOKE.FAULT_MARGIN, gates


@pytest.mark.parametrize("arch,degree,compression,grad_accum",
                         [(MOE_ARCHS[0], 4, "int8", 1),
                          (MOE_ARCHS[1], 2, None, 2), (DENSE, 2, "int8", 1)])
def test_bytes_by_kind_are_the_shapes(arch, degree, compression,
                                      grad_accum):
    """One step's bytes a rank by kind, sent and received, equal
    ``chip_smoke.tp_sp_bytes``' arithmetic on the shapes."""
    model = _port_model(arch)
    batch = train.batch_on(JaxData(
        vocab_size=model.cfg.vocab_size, seq_len=SEQ, global_batch=2
        * grad_accum if arch != DENSE else 3, seed=17).batch_at(0), "cpu")

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair(arch, None).tparams),
                              rank=shard.rank, degree=degree, policy="tp_sp")
        state = adamw_init(params)
        if compression:
            state["err"] = init_error_feedback(params)
        steps.make_train_step(model, OptConfig(**OPT), compression,
                              grad_accum)(params, state, batch)
        return dict(shard.sent), dict(shard.received)

    want = SMOKE.tp_sp_bytes(model.cfg, degree, batch["tokens"].shape[0],
                             SEQ, int8=compression == "int8",
                             grad_accum=grad_accum)
    for sent, received in on_ranks(degree, rank):
        assert {k: sent[k] for k in want} == want
        assert {k: received[k] for k in want} == want
        assert sum(sent.values()) == sum(want.values())


@pytest.mark.parametrize("arch,degree,seq,grad_accum", [
    (OTHER_STACKS[0], 4, SEQ, 1), (OTHER_STACKS[1], 4, SEQ, 1),
    (OTHER_STACKS[1], 2, SEQ, 3), (OTHER_STACKS[2], 2, SEQ, 1),
    (OTHER_STACKS[3], 2, SEQ, 1), (OTHER_STACKS[0], 4, ODD_SEQ, 1),
    (MOE_ARCHS[0], 4, ODD_SEQ, 1), (OTHER_STACKS[2], 4, ODD_SEQ + 1, 1)])
def test_bytes_of_every_stack_are_the_shapes(arch, degree, seq,
                                             grad_accum):
    """One int8 step's bytes a rank by kind, sent and received, equal
    ``chip_smoke.tp_sp_bytes``' arithmetic: the halo and carry kinds and
    their backwards (a hybrid's window halo wider than a rank's block at
    degree 4), whisper's encoder and memory gathers, internvl2's rows of
    the F + S, and with the rows whole (a sequence the degree does not
    divide) no row exchange but an MoE layer's expert outputs."""
    model = _port_model(arch)
    batch = train.batch_on(_data(arch, seq).batch_at(0), "cpu")

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair(arch, None).tparams),
                              rank=shard.rank, degree=degree, policy="tp_sp")
        state = adamw_init(params)
        state["err"] = init_error_feedback(params)
        steps.make_train_step(model, OptConfig(**OPT), "int8",
                              grad_accum)(params, state, batch)
        return dict(shard.sent), dict(shard.received)

    want = SMOKE.tp_sp_bytes(model.cfg, degree, batch["tokens"].shape[0],
                             seq, int8=True, grad_accum=grad_accum)
    for sent, received in on_ranks(degree, rank):
        assert {k: sent[k] for k in want} == want
        assert {k: received[k] for k in want} == want
        assert sum(sent.values()) == sum(want.values())


# ---------------------------------------------------------------------------
# run_cell and checkpoints
# ---------------------------------------------------------------------------


def test_run_cell_trains_an_moe_cell_under_tp_sp(monkeypatch):
    """A train cell of deepseek-moe-smoke on 2 thread ranks: the tp_sp
    policy, the whole batch on every rank, the same losses on every rank,
    equal to the one-card step under the same grouping."""
    cfg = dataclasses.replace(get_smoke(MOE_ARCHS[0]),
                              compute_dtype=torch.float32)
    cell = ShapeCell("train_tiny", 24, 2, "train")
    monkeypatch.setattr(dryrun, "sharding_policy",
                        lambda shard, kind: contextlib.nullcontext())
    ranks = on_ranks(2, lambda sh: dryrun.run_cell(cfg, cell, sh,
                                                   device="cpu", steps=2))
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    step = steps.make_train_step(model, OptConfig(lr=3e-3, warmup_steps=0,
                                                  total_steps=2))
    state = adamw_init(params)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=24,
                           global_batch=2, seed=5)
    want = []
    with ctx.grouped_as(2):
        for s in range(2):
            params, state, m = step(params, state,
                                    train.batch_on(data.batch_at(s), "cpu"))
            want.append(float(m["loss"]))
    for r, (rec, outs) in enumerate(ranks):
        assert (rec["policy"], rec["degree"], rec["rank"]) == ("tp_sp", 2, r)
        assert rec["kind"] == "train" and rec["steps"] == 2
        assert rec["sent_bytes"]["a2a"] > 0
        assert rec["sent_bytes"]["weights"] > 0
        assert rec["losses"] == ranks[0][0]["losses"]
    np.testing.assert_allclose(ranks[0][0]["losses"], want, rtol=STEP_RTOL)


def test_a_degree_4_tp_sp_save_restores_at_2_and_1_bit_for_bit(tmp_path):
    """The ranks' tp_sp states after one int8 step of moonshot-smoke,
    saved sharded (``train.state_blocks(..., "tp_sp")``), restore at
    degree 2 as ``local_params``/``local_opt_state`` cut the whole state
    and on one rank as the whole state, bit for bit."""
    _save_restores(MOE_ARCHS[1], tmp_path)


def test_a_degree_4_tp_sp_save_of_a_hybrid_restores_at_2_and_1(tmp_path):
    """The same for recurrentgemma-smoke at a global batch of 3 (its
    RG-LRU, windowed attention and GELU MLP leaves cut by their own
    rules), bit for bit."""
    _save_restores(OTHER_STACKS[1], tmp_path)


def _save_restores(arch: str, tmp_path) -> None:
    model = _port_model(arch)
    batch = train.batch_on(_data(arch).batch_at(0), "cpu")

    def rank(shard):
        params = local_params(tree_map(torch.clone, _pair(arch, None).tparams),
                              rank=shard.rank, degree=4, policy="tp_sp")
        state = adamw_init(params)
        state["err"] = init_error_feedback(params)
        params, state, _ = steps.make_train_step(
            model, OptConfig(**OPT), "int8")(params, state, batch)
        return {"params": tree_map(lambda t: t.detach(), params),
                "opt": state}

    parts = on_ranks(4, rank)
    like = {"params": _pair(arch, None).tparams,
            "opt": {"mu": _pair(arch, None).tparams,
                    "nu": _pair(arch, None).tparams,
                    "err": _pair(arch, None).tparams,
                    "step": parts[0]["opt"]["step"]}}
    flat = _whole(parts, like)
    whole = tree_map(lambda _: None, parts[0])

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix[:-1]]

    whole = fill(whole)
    managers = [CheckpointManager(str(tmp_path), rank=r, degree=4)
                for r in range(4)]
    threads = [threading.Thread(target=lambda r=r: managers[r].save(
        3, parts[r], shardings=train.state_blocks(model.cfg, "int8", r, 4,
                                                  "tp_sp")))
               for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for r in range(2):
        got = CheckpointManager(str(tmp_path), rank=r, degree=2).restore(
            3, whole, device="cpu",
            shardings=train.state_blocks(model.cfg, "int8", r, 2, "tp_sp"))
        want = {"params": local_params(whole["params"], rank=r, degree=2,
                                       policy="tp_sp"),
                "opt": local_opt_state(whole["opt"], rank=r, degree=2,
                                       policy="tp_sp")}
        for (pa, a), (pb, b) in zip(leaves_with_paths(got),
                                    leaves_with_paths(want)):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    one = CheckpointManager(str(tmp_path)).restore(3, whole, device="cpu")
    for (pa, a), (_, b) in zip(leaves_with_paths(one),
                               leaves_with_paths(whole)):
        assert torch.equal(a, b), pa


def test_tp_sp_blocks_name_each_leaf_s_split():
    cfg = get_smoke(MOE_ARCHS[0])
    shapes = tfm.init(cfg, device="meta")
    blocks = dict(leaves_with_paths(tp_sp_blocks(shapes, rank=1, degree=4)))
    assert blocks["layers/0/ffn/w_gate"] == (0, 1, 4)
    assert blocks["layers/0/ffn/w_down"] == (0, 1, 4)
    assert blocks["layers/0/attn/wq"] == (1, 1, 4)
    assert blocks["layers/0/attn/wo"] == (0, 1, 4)
    assert blocks["embed"] == (0, 1, 4)
    assert blocks["layers/0/ffn/router"] is None
    assert blocks["layers/0/attn/norm"] is None
