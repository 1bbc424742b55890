"""whisper's and internvl2's parts of the sequence-sharding policy, with
no spawn.

Ranks are threads of this process sharing a ``test_torch_seqcarry``
hub: ``RingThreadShard`` adds the ring's passes to its all-gather, and
each thread sees its own shard where the model reads the policy's state
(``thread_policies`` stands a per-thread value in for
``distributed/ctx.seq_shard_state`` for the test's duration), so no
process group is needed:

* the split encoder (``transformer.encode`` under the policy) at fp32:
  each rank's rows within 1e-5 of the one-rank encoder's rows, F / n a
  rank where n divides F (all F where it does not), its K/V gathered
  whole once a layer;
* a prefill cross block on a rank's rows and memory block
  (``_seq_cross``) and a decode step's (``cross_attn_decode``) against
  the one-rank block, the memory block kept in the cache, the bytes the
  shapes'; ``_seq_memory`` on a whole and on a rank's memory;
* the frontend rows (``_input_rows``, ``_seq_embed``): each rank's rows
  of patches and tokens bitwise the one-rank embedding's, a rank holding
  patch rows only;
* the cache blocks (``rank_cache``, ``launch/dryrun.seeded_cache``):
  every leaf, the memories included, the block the reference's
  ``cache_specs`` gives on a stand-in mesh, ``mem_replicated`` where the
  degree does not divide the frames;
* each fault of ``chip_smoke.FRONTEND_FAULTS`` rejected by
  ``chip_smoke.split_rows_gate``, the gate the card runs.

The whole models against the reference, across processes, are in
``tests/test_torch_seqshard.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_smoke
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import SeqShard
from repro_torch.launch.dryrun import seeded_cache
from repro_torch.models import transformer as tfm
from repro_torch.models.api import build_model
from test_torch_seqcarry import SMOKE, ThreadShard, _Hub
from test_torch_seqshard import StandInMesh, _reference_blocks

WHISPER, INTERNVL = "whisper-large-v3", "internvl2-2b"
TOL = 1e-5
B = 2


@dataclasses.dataclass
class RingThreadShard(ThreadShard):
    """``ThreadShard`` with the ring's passes: each tensor all-gathered
    through the hub, rank - 1's kept, counted as ``SeqShard.ring_pass``
    counts them."""

    def ring_pass(self, tensors, kind="ring"):
        if self.degree == 1:
            return lambda: tensors
        n = sum(t.numel() * t.element_size() for t in tensors)
        self._count(kind, n, n)
        got = [self.hub.exchange(self.rank, t.contiguous())[self.rank - 1]
               for t in tensors]
        return lambda: got


_LOCAL = threading.local()


@contextlib.contextmanager
def thread_policies():
    """While active, the policy's shard is each thread's own
    (``_LOCAL.shard``, set by ``on_ranks``): ``ctx.seq_shard_state`` and
    the model's reference to it return it (this edits no file)."""
    real = ctx.seq_shard_state

    def state():
        return getattr(_LOCAL, "shard", None)

    ctx.seq_shard_state = tfm.seq_shard_state = state
    try:
        yield
    finally:
        ctx.seq_shard_state = tfm.seq_shard_state = real


def on_ranks(degree: int, fn) -> list:
    """``fn(shard)`` on ``degree`` threads, one a rank, each under its own
    shard (``thread_policies``) -> their results in rank order; a rank's
    exception is raised here."""
    hub = _Hub(degree)
    out, errors = [None] * degree, []

    def run(rank):
        shard = RingThreadShard(None, rank, degree, hub=hub)
        _LOCAL.shard = shard
        try:
            out[rank] = fn(shard)
        except BaseException as exc:      # re-raised below
            errors.append(exc)
            hub.barrier.abort()
        finally:
            _LOCAL.shard = None

    threads = [threading.Thread(target=run, args=(r,)) for r in range(degree)]
    with thread_policies(), torch.no_grad():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _rnd(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _model(arch: str, **overrides):
    """fp32 smoke ``arch`` on the CPU (plain attention), seed-0 weights
    with norm scales from N(0, 4) so that rows differ."""
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32, **overrides)
    params = build_model(cfg).init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    stack = params["layers"] + params.get("encoder", [])
    for blk in [params] + [b for layer in stack for b in layer.values()]:
        for key in ("norm", "final_norm", "enc_final_norm"):
            if key in blk:
                blk[key] = 2.0 * torch.randn(blk[key].shape, generator=gen)
    return cfg, params


def _block(x: torch.Tensor, shard, whole: int, dim: int = 1):
    """The rank's block of a dim of ``whole`` rows, all of them where the
    degree does not divide it."""
    if whole % shard.degree:
        return x
    per = whole // shard.degree
    return x.narrow(dim, shard.rank * per, per)


# ---------------------------------------------------------------------------
# the split encoder and the cross blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree,frames", [(2, 16), (4, 16), (4, 18)])
def test_split_encoder_rows_match_one_rank(degree, frames):
    """Each rank's encoder output rows (its F / n frames, all F where n
    does not divide F) within 1e-5 of the one-rank encoder's; each layer
    gathers the rank's K/V block once (kind ``gather``), none when the
    frames stay whole."""
    cfg, params = _model(WHISPER, num_frontend_tokens=frames)
    x = _rnd(1, B, frames, cfg.d_model)
    with torch.no_grad():
        want = tfm.encode(params, x, cfg)
    outs = on_ranks(degree, lambda sh: (tfm.encode(params, x, cfg),
                                        dict(sh.sent)))
    split = frames % degree == 0
    for r, (got, sent) in enumerate(outs):
        shard = SeqShard(None, r, degree)
        torch.testing.assert_close(got, _block(want, shard, frames),
                                   atol=TOL, rtol=TOL)
        per = frames // degree if split else 0
        assert sent == dict(dict.fromkeys(ctx.KINDS, 0), gather=(
            cfg.encoder_layers * (degree - 1) * 2 * B * cfg.num_kv_heads
            * per * cfg.hd * 4))


@pytest.mark.parametrize("degree", [2, 4])
def test_cross_blocks_on_rank_blocks(degree):
    """A prefill cross block on a rank's decoder rows and memory block
    (``_seq_cross``: the block projected, kept in the cache block,
    gathered whole) and a decode step's (``cross_attn_decode``: the
    ranks' partials combined in rank order) against the one-rank cross
    block within 1e-5, the decode output the same bits on every rank;
    one gather of the memory block and one combine of the partials."""
    cfg, params = _model(WHISPER)
    cross = params["layers"][0]["cross"]
    f, s = cfg.num_frontend_tokens, 24
    x, x1 = _rnd(2, B, s, cfg.d_model), _rnd(3, B, 1, cfg.d_model)
    mem = _rnd(4, B, f, cfg.d_model)
    with torch.no_grad():
        mem_k, mem_v = tfm.cross_memory(cross, mem, cfg)
        want = tfm.cross_attn_block(cross, x, cfg, mem_k=mem_k, mem_v=mem_v)
        want1 = tfm.cross_attn_block(cross, x1, cfg, mem_k=mem_k,
                                     mem_v=mem_v)

    def rank(sh):
        blk = tfm.rank_cache(cfg, B, s, sh, device="cpu", mem_len=f)[
            "layers"][0]
        rows = tfm._seq_cross(cross, _block(x, sh, s), cfg,
                              _block(mem, sh, f), f, blk)
        prefill_sent = dict(sh.sent)
        sh.reset_counts()
        one = tfm.cross_attn_decode(cross, x1, cfg, mem_k=blk["mem_k"],
                                    mem_v=blk["mem_v"])
        return rows, blk, one, prefill_sent, dict(sh.sent)

    outs = on_ranks(degree, rank)
    per = f // degree
    for r, (rows, blk, one, pre, dec) in enumerate(outs):
        shard = SeqShard(None, r, degree)
        torch.testing.assert_close(rows, _block(want, shard, s), atol=TOL,
                                   rtol=TOL)
        torch.testing.assert_close(blk["mem_k"], _block(mem_k, shard, f, 2),
                                   atol=TOL, rtol=TOL)
        torch.testing.assert_close(one, want1, atol=TOL, rtol=TOL)
        assert torch.equal(one, outs[0][2])
        assert pre["gather"] == ((degree - 1) * 2 * B * cfg.num_kv_heads
                                 * per * cfg.hd * 4)
        assert dec["combine"] == ((degree - 1) * B * cfg.num_heads
                                  * (cfg.hd + 2) * 4)


def test_seq_memory_takes_a_whole_or_a_rank_memory():
    """``_seq_memory`` cuts a whole memory (F rows) to the rank's block,
    passes a rank's block through, and refuses rows that are neither; a
    stack with no encoder has none."""
    cfg, _ = _model(WHISPER)
    f = cfg.num_frontend_tokens
    mem = _rnd(5, B, f, cfg.d_model)
    shard = SeqShard(None, 1, 4)
    with thread_policies():
        _LOCAL.shard = shard
        try:
            got, rows = tfm._seq_memory(mem, cfg, shard)
            assert rows == f and torch.equal(got, mem[:, f // 4:f // 2])
            assert tfm._seq_memory(got, cfg, shard)[0] is got
            with pytest.raises(ValueError, match="neither"):
                tfm._seq_memory(mem[:, :5], cfg, shard)
        finally:
            _LOCAL.shard = None
    vcfg, _ = _model(INTERNVL)
    assert tfm._seq_memory(None, vcfg, shard) == (None, 0)


# ---------------------------------------------------------------------------
# the frontend rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree,tokens", [(2, 24), (4, 8), (4, 25)])
def test_patch_rows_in_the_row_split(degree, tokens):
    """Each rank's rows of F patch rows then the tokens' embeddings
    (``_input_rows``, ``_seq_embed``) are the one-rank embedding's rows
    bit for bit: 8 patches and 8 tokens over 4 ranks leave ranks 0 and 1
    patch rows only, and 33 rows stay whole on every rank."""
    cfg, params = _model(INTERNVL)
    f = cfg.num_frontend_tokens
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        3, cfg.vocab_size, size=(B, tokens)))
    patches = _rnd(7, B, f, cfg.d_model)
    with torch.no_grad():
        want = tfm._embed(params, ids, cfg, patches)
    s = f + tokens

    def rank(sh):
        rows = ctx.seq_slice(s)
        front, mine = tfm._input_rows(ids, patches, rows)
        return (front, mine, tfm._seq_embed(params, mine, cfg, sh,
                                            rows.start, front))

    for r, (front, mine, got) in enumerate(on_ranks(degree, rank)):
        assert torch.equal(got, _block(want, SeqShard(None, r, degree), s))
        if s % degree == 0 and (r + 1) * s // degree <= f:
            assert mine.shape == (B, 0)
        if s % degree == 0 and r * s // degree >= f:
            assert front is None


# ---------------------------------------------------------------------------
# the cache blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree,frames", [(2, 16), (4, 16), (4, 18)])
@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_cache_blocks_match_reference(arch, degree, frames):
    """Every leaf of a rank's cache (``rank_cache``), the memories
    included, has the block shape the reference's ``cache_specs`` gives
    on a stand-in mesh; memories the degree does not divide are whole
    and marked ``mem_replicated``; a rank's seeded cache holds the whole
    seeded cache's blocks, its memories' every row drawn."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=torch.float32,
                              num_frontend_tokens=frames)
    mem_len = frames if cfg.encoder_layers else 0
    jcfg = dataclasses.replace(jax_get_smoke(arch), num_frontend_tokens=frames)
    ref = jax.eval_shape(lambda: jax_build_model(jcfg).make_cache(
        B, 40, mem_len=mem_len))
    want = _reference_blocks(ref, degree)
    whole = seeded_cache(cfg, B, 40, 30, seed=2, device="cpu")
    for r in range(degree):
        shard = SeqShard(None, r, degree)
        cache = tfm.rank_cache(cfg, B, 40, shard, device="cpu",
                               mem_len=mem_len)
        mine: dict = {}
        for blk in cache["layers"]:
            for name, t in blk.items():
                mine.setdefault(name, set()).add(tuple(t.shape))
        assert mine == want
        assert cache.get("mem_replicated", False) == bool(
            mem_len % degree)
        seeded = seeded_cache(cfg, B, 40, 30, seed=2, device="cpu",
                              shard=shard)
        for a, w in zip(seeded["layers"], whole["layers"]):
            for name in a:
                dim = 2 if name in ("k", "v", "mem_k", "mem_v") else None
                size = w[name].shape[2]
                assert torch.equal(a[name], _block(w[name], shard, size, dim)
                                   if dim is not None else w[name]), name
        if mem_len:
            assert all(w["mem_k"].abs().amax(-1).gt(0).all()
                       for w in whole["layers"])


# ---------------------------------------------------------------------------
# the planted faults
# ---------------------------------------------------------------------------


def _fault_rows(fault: str, degree: int) -> tuple:
    """(each rank's rows of the faulted step, its rows under ``fault``,
    the one-rank rows at those positions)."""
    if fault == "patch_rows_unshifted":
        cfg, params = _model(INTERNVL)
        f, tokens = cfg.num_frontend_tokens, 56
        ids = torch.from_numpy(np.random.default_rng(8).integers(
            3, cfg.vocab_size, size=(B, tokens)))
        patches = _rnd(9, B, f, cfg.d_model)
        s = f + tokens
        layer = params["layers"][0]
        with torch.no_grad():
            x = tfm._embed(params, ids, cfg, patches)
            want = tfm.attn_block(layer["attn"], x, cfg,
                                  positions=torch.arange(s))[0]

        def step(sh):
            rows = ctx.seq_slice(s)
            front, mine = tfm._input_rows(ids, patches, rows)
            xr = tfm._seq_embed(params, mine, cfg, sh, rows.start, front)
            return tfm._seq_mixer(layer, xr, cfg, sh,
                                  torch.arange(rows.start, rows.stop),
                                  True, s)
        return step, lambda r: _block(want, SeqShard(None, r, degree), s)
    cfg, params = _model(WHISPER)
    f, s = cfg.num_frontend_tokens, 24
    if fault == "encoder_own_frames":
        frames = _rnd(10, B, f, cfg.d_model)
        attn = params["encoder"][0]["attn"]
        with torch.no_grad():
            want = tfm.attn_block(attn, frames, cfg,
                                  positions=torch.arange(f), causal=False)[0]

        def step(sh):
            rows = ctx.seq_slice(f)
            return tfm.attn_block(attn, frames[:, rows], cfg,
                                  positions=torch.arange(rows.start,
                                                         rows.stop),
                                  causal=False, kv_rows=f)[0]
        return step, lambda r: _block(want, SeqShard(None, r, degree), f)
    cross = params["layers"][0]["cross"]
    x = _rnd(11, B, 1 if fault == "cross_partial_dropped" else s,
             cfg.d_model)
    mem = _rnd(12, B, f, cfg.d_model)
    with torch.no_grad():
        mem_k, mem_v = tfm.cross_memory(cross, mem, cfg)
        want = tfm.cross_attn_block(cross, x, cfg, mem_k=mem_k, mem_v=mem_v)
    if fault == "cross_own_memory":
        def step(sh):
            return tfm._seq_cross(cross, _block(x, sh, s), cfg,
                                  _block(mem, sh, f), f)
        return step, lambda r: _block(want, SeqShard(None, r, degree), s)

    def step(sh):
        k, v = tfm.cross_memory(cross, _block(mem, sh, f), cfg)
        return tfm.cross_attn_decode(cross, x, cfg, mem_k=k, mem_v=v)
    return step, lambda r: want


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("fault", SMOKE.FRONTEND_FAULTS)
def test_frontend_faults_rejected_by_the_rows_gate(fault, degree):
    """Each rank's rows of the step a fault plants in (whisper's encoder
    layer, a prefill cross block, a decode step's cross block; internvl2's
    layer 0 with its patch rows, every rank holding tokens) within 1e-4 of
    the one-rank rows, and ``chip_smoke.split_rows_gate`` passes them and
    rejects the rows under ``planted_frontend_fault`` on every rank it
    touches."""
    step, want = _fault_rows(fault, degree)
    good = on_ranks(degree, step)
    with SMOKE.planted_frontend_fault(fault):
        bad = on_ranks(degree, step)
    for r in range(degree):
        torch.testing.assert_close(good[r], want(r), atol=1e-4, rtol=1e-4)
        assert SMOKE.fault_touches(fault, r, degree)
        check = SMOKE.split_rows_gate(good[r], want(r), {fault: bad[r]})
        assert check["ok"], check
        assert check["faults"][fault] > SMOKE.BF16_ROW_RTOL
