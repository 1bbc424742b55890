"""The port's paged cache manager and ``ContinuousBatchingEngine`` against
the JAX package's.

* The page manager is driven op by op beside the reference's manager
  (admissions, appends, releases, exhaustion and page reuse, double
  frees): after every op both give the same table, ``kv_lens`` and free
  list, and raise the same typed errors.
* Both engines serve the same requests over the same fp32 weights (random
  norm scales, so the token streams vary): the reference on
  ``attn_impl="xla_full"``, the port on its kernels' plain versions (and
  on its plain and its chunked attention), and the port's wave engine
  beside them. Tokens
  must agree token for token: uncontended, under scripted pool
  exhaustion at several append indices, with a cancellation mid-decode,
  and with one slot's logits reported non-finite. Deadlines expire queued
  and live requests, and the ``PoolAuditor`` catches a seeded double
  free, leak and duplicate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core.autotune import tune_pool_headroom as jax_headroom
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import PagedKVCacheManager as JaxManager
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving.lifecycle import Request as JaxRequest
from repro.serving.paged_cache import (
    page_footprint_bytes as jax_page_footprint,
)
from repro_torch.core.autotune import tune_pool_headroom, tune_prefill_chunk
from repro_torch.models.api import build_model
from repro_torch.obs.trace import Tracer
from repro_torch.serving import (
    NO_FAULTS,
    ContinuousBatchingEngine,
    PageAccountingError,
    PagedKVCacheManager,
    PagePoolExhausted,
    PoolAuditError,
    PoolAuditor,
    Request,
    RequestState,
    ScriptedFaults,
    SeededFaults,
    ServingEngine,
    page_footprint_bytes,
)
from test_torch_harness import model_pair, prompts

MAX_LEN = 40
ENGINE = dict(max_len=MAX_LEN, batch_size=2, page_size=4, chunk_size=8)
SPEC = [(5, 4), (9, 3), (13, 2), (21, 4), (30, 6)]


# ---------------------------------------------------------------------------
# the page manager, op by op beside the reference's
# ---------------------------------------------------------------------------


def _apply(mgr, op):
    kind, slot, arg = op
    try:
        if kind == "admit":
            mgr.admit(slot, arg[0], reserve=arg[1])
        elif kind == "append":
            mgr.append(slot)
        else:
            mgr.release(slot)
    except Exception as exc:  # noqa: BLE001 - compared by type below
        return type(exc).__name__
    return None


def _same_state(jm, tm, what):
    np.testing.assert_array_equal(tm.table(), jm.table(), err_msg=what)
    np.testing.assert_array_equal(tm.kv_lens(), jm.kv_lens(), err_msg=what)
    assert tm.free_pages() == jm.free_pages(), what
    assert tm.owned_pages() == jm.owned_pages(), what
    assert tm.pages_used == jm.pages_used, what
    assert tm.admit_plan(7, 3) == jm.admit_plan(7, 3, None), what


def _both(num_pages=10):
    kw = dict(num_slots=3, max_pages_per_seq=4)
    return JaxManager(num_pages, 4, **kw), PagedKVCacheManager(num_pages, 4,
                                                               **kw)


def test_manager_exhaustion_and_reuse_like_the_reference():
    jm, tm = _both()
    ops = [("admit", 0, (6, 2)), ("admit", 1, (9, 0)), ("append", 0, None),
           ("append", 0, None), ("append", 1, None), ("admit", 2, (10, 4)),
           ("append", 1, None), ("append", 1, None), ("append", 1, None),
           ("append", 1, None), ("release", 0, None), ("release", 0, None),
           ("admit", 2, (10, 4)), ("admit", 0, (4, 0)), ("release", 5, None),
           ("admit", 2, (4, 0)), ("release", 1, None), ("admit", 1, (17, 0))]
    errors = []
    for i, op in enumerate(ops):
        got, want = _apply(tm, op), _apply(jm, op)
        assert got == want, (i, op)
        errors.append(got)
        _same_state(jm, tm, f"op {i} {op}")
    assert "PagePoolExhausted" in errors and "PageAccountingError" in errors
    assert "ValueError" in errors          # more pages than a sequence holds


@pytest.mark.parametrize("seed", range(4))
def test_manager_random_ops_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    jm, tm = _both(num_pages=9)
    for i in range(60):
        kind = ("admit", "append", "append", "release")[rng.integers(4)]
        arg = (int(rng.integers(1, 12)), int(rng.integers(0, 4)))
        op = (kind, int(rng.integers(3)), arg)
        assert _apply(tm, op) == _apply(jm, op), (i, op)
        _same_state(jm, tm, f"seed {seed} op {i} {op}")


def test_auditor_catches_seeded_corruption():
    aud = PoolAuditor()
    mgr = PagedKVCacheManager(6, 4, num_slots=2, max_pages_per_seq=4)
    ids = mgr.admit(0, prompt_len=8)
    aud.check(mgr)                          # a healthy pool passes
    mgr._free.append(ids[0])                # double free: owned and free
    with pytest.raises(PoolAuditError, match="free and owned"):
        aud.check(mgr)
    mgr._free.pop()
    lost = mgr._free.pop()                  # leak: the page vanishes
    with pytest.raises(PoolAuditError, match="leak"):
        aud.check(mgr)
    mgr._free.append(lost)
    mgr._free.append(mgr._free[0])          # free-list duplicate
    with pytest.raises(PoolAuditError, match="duplicates"):
        aud.check(mgr)
    mgr._free.pop()
    with pytest.raises(PoolAuditError, match="position"):
        aud.check(mgr, expected_lens={0: 99})
    with pytest.raises(PageAccountingError):
        mgr.release(1)                      # never admitted
    mgr.release(0)
    aud.final_check(mgr)                    # drained: no leak
    mgr.admit(1, prompt_len=4)
    with pytest.raises(PoolAuditError, match="survived"):
        aud.final_check(mgr)


# ---------------------------------------------------------------------------
# the engine beside the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=3, jax_impl="xla_full",
                      norm_std=2.0)


@pytest.fixture(scope="module")
def jax_engine(pair):
    # one instance: its jitted steps compile once for the whole module
    return JaxEngine(pair.jmodel, pair.jparams, **ENGINE)


@pytest.fixture(scope="module")
def engine(pair):
    return ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    **ENGINE)


def _requests(cls, vocab, spec, **kw):
    return [cls(rid=i, prompt=prompts(40 + i, 1, n, vocab)[0],
                max_new_tokens=m, eos_id=-2, **kw)
            for i, (n, m) in enumerate(spec)]


def _serve(eng, reqs, injector=NO_FAULTS, auditor=None):
    eng.injector, eng.auditor = injector, auditor
    try:
        return eng.serve(reqs)
    finally:
        eng.injector, eng.auditor = NO_FAULTS, None


def _both_serve(pair, jax_engine, engine, spec, jax_inj=NO_FAULTS,
                inj=NO_FAULTS, auditor=None):
    vocab = pair.tcfg.vocab_size
    jout = _serve(jax_engine, _requests(JaxRequest, vocab, spec), jax_inj)
    tout = _serve(engine, _requests(Request, vocab, spec), inj, auditor)
    assert set(tout) == set(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]),
                                      err_msg=f"rid {rid}")
        assert (engine.results[rid].state.value
                == jax_engine.results[rid].state.value)
    return jout, tout


@pytest.mark.parametrize("impl", ["kernel", "plain", "chunked"])
def test_engine_matches_reference_and_wave_engine(pair, jax_engine, impl):
    tmodel = build_model(dataclasses.replace(pair.tcfg, attn_impl=impl))
    eng = ContinuousBatchingEngine(tmodel, pair.tparams, device="cpu",
                                   **ENGINE)
    jout, tout = _both_serve(pair, jax_engine, eng, SPEC)
    assert len({t for v in tout.values() for t in v.tolist()}) > 5
    wave = ServingEngine(tmodel, pair.tparams, max_len=MAX_LEN, batch_size=2,
                         device="cpu").serve(
        _requests(Request, pair.tcfg.vocab_size, SPEC))
    for rid in tout:
        np.testing.assert_array_equal(tout[rid], wave[rid])
    kinds = {k: eng.metrics.histogram(f"engine.step_s.{k}").count
             for k in ("decode", "chunk", "chunk+decode")}
    assert all(kinds.values()), kinds
    assert eng.step_log == jax_engine.step_log
    assert eng.metrics.counter("serving.tokens_generated").value == sum(
        len(v) for v in tout.values())


def test_chunk_steps_pack_their_span_into_the_step_array(pair, jax_engine,
                                                        engine):
    """Each chunk step's (q_offset, kv_len, last live row) rides at the
    end of the step's one int32 array, which reaches the kernels as a
    slice of the step's device copy, and the tokens stay the reference's:
    whole first and middle chunks and ragged last ones (prompts of 5-30
    tokens at chunk 8)."""
    spans = []
    step = engine._step

    def recording(cache, host, decode, prefill):
        if prefill:
            q0, kv_len, last = (int(v) for v in host[-3:])
            assert last == kv_len - q0 - 1
            spans.append((q0, kv_len - q0))
        return step(cache, host, decode, prefill)

    engine._step = recording
    try:
        _both_serve(pair, jax_engine, engine, SPEC)
    finally:
        del engine._step
    chunk = ENGINE["chunk_size"]
    want = [(q0, min(chunk, n - q0)) for n, _ in SPEC
            for q0 in range(0, n, chunk)]
    assert sorted(spans) == sorted(want)
    assert (16, 5) in spans and (8, 8) in spans


@pytest.mark.parametrize("appends", [{0}, {2, 6, 7}, {3, 4, 5}, {11}])
def test_preemption_matches_reference_under_scripted_exhaustion(
        pair, jax_engine, engine, appends):
    base = _serve(engine, _requests(Request, pair.tcfg.vocab_size, SPEC))
    aud = PoolAuditor()
    jout, tout = _both_serve(
        pair, jax_engine, engine, SPEC,
        JaxScriptedFaults(exhaust_at_appends=frozenset(appends)),
        ScriptedFaults(exhaust_at_appends=frozenset(appends)), aud)
    for rid in base:
        np.testing.assert_array_equal(tout[rid], base[rid])
    # the port appends a slot's page before the step that writes its row,
    # the reference after it (ROADMAP C4), so the burst may land a step
    # apart and evict a request holding one token fewer
    assert engine.preemption_count >= 1 and jax_engine.preemption_count >= 1
    assert engine.recompute_tokens > 0
    assert aud.steps_checked > 0 and engine._mgr.pages_used == 0
    assert all(r.state is RequestState.FINISHED
               for r in engine.results.values())


@pytest.mark.parametrize("batch,spec,num_pages,frac", [
    (2, [(9, 12), (13, 12)], 9, 0.15),
    (3, [(9, 12), (13, 12), (5, 20)], 12, 0.2),
    (3, [(20, 15), (3, 25), (11, 10), (7, 7)], 14, 0.3),
])
def test_overcommitted_pool_preempts_and_keeps_greedy_tokens(
        pair, batch, spec, num_pages, frac):
    """A pool run hot exhausts naturally; the youngest request is preempted
    and recomputed, and every request still gets the uncontended tokens.
    (The reference fails this: it writes the first row of each page past
    the decode reservation into the scratch page, ROADMAP C4.)"""
    kw = dict(ENGINE, batch_size=batch)
    hot = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   num_pages=num_pages,
                                   decode_reserve_frac=frac,
                                   headroom_pages=0, **kw)
    out = _serve(hot, _requests(Request, pair.tcfg.vocab_size, spec),
                 auditor=PoolAuditor())
    assert hot.preemption_count >= 1
    base = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    **kw).serve(
        _requests(Request, pair.tcfg.vocab_size, spec))
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])


def test_cancellation_mid_decode_matches_reference(pair, jax_engine, engine):
    spec = [(5, 12), (9, 4)]

    def cancel_at_6(eng, step):
        if step == 6:
            eng.cancel(0)

    jout, tout = _both_serve(pair, jax_engine, engine, spec,
                             JaxScriptedFaults(on_step=cancel_at_6),
                             ScriptedFaults(on_step=cancel_at_6),
                             PoolAuditor())
    rec = engine.results[0]
    assert rec.state is RequestState.CANCELLED and 0 < len(rec.tokens) < 12
    assert engine.results[1].state is RequestState.FINISHED
    assert engine._mgr.pages_used == 0


def test_nan_isolation_matches_reference(pair, jax_engine, engine):
    spec = [(5, 10), (9, 4)]
    _serve(engine, _requests(Request, pair.tcfg.vocab_size, spec))
    step = next(i for i, e in enumerate(engine.step_log)
                if e["live_decode"] == 2)
    jout, tout = _both_serve(
        pair, jax_engine, engine, spec,
        JaxScriptedFaults(nan_at=frozenset({(step, 0)})),
        ScriptedFaults(nan_at=frozenset({(step, 0)})), PoolAuditor())
    r0, r1 = engine.results[0], engine.results[1]
    assert r0.state is RequestState.FAILED and "finite" in r0.error
    assert len(tout[0]) < 10 and r1.state is RequestState.FINISHED
    assert engine.metrics.counter("serving.nan_guard_trips").value == 1


def test_deadline_expiry_frees_pages(pair, engine):
    vocab = pair.tcfg.vocab_size
    base = _serve(engine, _requests(Request, vocab, [(5, 30), (9, 2)]))
    reqs = _requests(Request, vocab, [(5, 30), (9, 2)])
    reqs[0].deadline_s = 0.25
    reqs[1].deadline_s = 0.0    # expires before it can be admitted
    out = _serve(engine, reqs, ScriptedFaults(slow_steps={3: 0.4}),
                 PoolAuditor())
    r0, r1 = engine.results[0], engine.results[1]
    assert r0.state is RequestState.CANCELLED and "deadline" in r0.error
    assert 0 < len(out[0]) < 30
    np.testing.assert_array_equal(out[0], base[0][:len(out[0])])
    assert r1.state is RequestState.CANCELLED and len(out[1]) == 0
    assert engine._mgr.pages_used == 0


def test_malformed_requests_and_seeded_chaos(pair, jax_engine, engine):
    vocab = pair.tcfg.vocab_size
    reqs = [Request(rid=0, prompt=np.array([], np.int32), max_new_tokens=3),
            Request(rid=1, prompt=prompts(1, 1, 30, vocab)[0],
                    max_new_tokens=20),
            Request(rid=2, prompt=prompts(2, 1, 6, vocab)[0],
                    max_new_tokens=3, eos_id=-2)]
    out = engine.serve(reqs)
    assert engine.results[0].state is RequestState.FAILED
    assert engine.results[1].state is RequestState.FAILED
    assert len(out[0]) == len(out[1]) == 0 and len(out[2]) == 3
    base = _serve(engine, _requests(Request, vocab, SPEC))
    aud = PoolAuditor()
    out = _serve(engine, _requests(Request, vocab, SPEC),
                 SeededFaults(7, p_exhaust=0.2, p_reject=0.2), aud)
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])
    assert aud.steps_checked > 0


def test_engine_trace_and_unported_options(pair):
    tracer = Tracer(enabled=True)
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, tracer=tracer,
                                   device="cpu", **ENGINE)
    eng.serve(_requests(Request, pair.tcfg.vocab_size, SPEC[:2]))
    names = {ev["name"] for ev in tracer.export()["traceEvents"]}
    assert {"request", "prefilling", "decoding", "step"} <= names
    cfg = pair.tcfg
    assert page_footprint_bytes(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        page_size=4, head_dim=cfg.hd, itemsize=4) == jax_page_footprint(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        page_size=4, head_dim=cfg.hd, kv_dtype="float32")
    assert page_footprint_bytes(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        page_size=4, head_dim=cfg.hd, itemsize=1) == jax_page_footprint(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        page_size=4, head_dim=cfg.hd, kv_dtype="int8")
    # speculative decoding and prefix sharing are ported
    assert ContinuousBatchingEngine(pair.tmodel, pair.tparams, spec_depth=2,
                                    device="cpu").spec_depth == 2
    shared = ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                      prefix_cache=True, device="cpu",
                                      **ENGINE)
    reqs = _requests(Request, pair.tcfg.vocab_size, SPEC[:2])
    reqs[1].prompt = reqs[0].prompt[:4].copy()   # resident whole: a full hit
    out = shared.serve(reqs)
    assert all(len(out[r.rid]) == r.max_new_tokens for r in reqs)
    assert shared.prefix_stats["cow_copies"] == 1
    mgr = PagedKVCacheManager(4, 4, num_slots=1, max_pages_per_seq=1,
                              prefix_cache=True)
    mgr.admit_prefix(0, 4, match=mgr.match_prefix([5, 6, 7, 8]))
    assert mgr.publish_prefix(0, [5, 6, 7, 8]) == 1
    with pytest.raises(PagePoolExhausted):
        PagedKVCacheManager(3, 4, num_slots=1, max_pages_per_seq=4).admit(
            0, 9)


class _HookedEngine(ContinuousBatchingEngine):
    """The engine with every hook of the sharded engine's seams taken
    through an override that records its calls and defers to the base."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = {"make_cache": 0, "host_result": 0, "clock": 0,
                      "observe": []}

    def _make_cache(self):
        self.calls["make_cache"] += 1
        return super()._make_cache()

    def _host_result(self, packed):
        self.calls["host_result"] += 1
        return super()._host_result(packed)

    def _deadline_clock(self):
        self.calls["clock"] += 1
        return super()._deadline_clock()

    def _observe_step(self, kind, t0, t1, chunk_tokens, live):
        assert t1 >= t0
        self.calls["observe"].append((kind, chunk_tokens, live))
        super()._observe_step(kind, t0, t1, chunk_tokens, live)


@pytest.mark.parametrize("spec_depth", [None, 3])
def test_engine_hooks_are_no_ops_on_one_card(pair, jax_engine, monkeypatch,
                                             spec_depth):
    """The hooks (``_make_cache``, ``_host_result``, ``_deadline_clock``,
    ``_observe_step``) leave the single-card engine's tokens, steps,
    kernel calls and launch counts as they were, and are each called
    where the sharded engine needs them: one cache a serve, one result a
    step, the clock a turn of the loop only while a request has a
    deadline."""
    from repro_torch.kernels import ops

    calls = []
    for name in ("paged_decode_attention", "paged_verify_attention",
                 "paged_prefill_attention"):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    vocab = pair.tcfg.vocab_size
    runs = {}
    for cls in (ContinuousBatchingEngine, _HookedEngine):
        eng = cls(pair.tmodel, pair.tparams, device="cpu",
                  spec_depth=spec_depth, **ENGINE)
        calls.clear()
        ops.reset_launch_counts()
        out = eng.serve(_requests(Request, vocab, SPEC))
        runs[cls] = (out, list(eng.step_log), list(calls),
                     ops.launch_counts(), eng)
    (base, log, kcalls, counts, _), (out, hlog, hcalls, hcounts, hooked) = (
        runs[ContinuousBatchingEngine], runs[_HookedEngine])
    for rid in base:
        np.testing.assert_array_equal(out[rid], base[rid])
    assert hlog == log and hcalls == kcalls and hcounts == counts
    if spec_depth is None:
        jout = _serve(jax_engine, _requests(JaxRequest, vocab, SPEC))
        for rid in jout:
            np.testing.assert_array_equal(out[rid], np.asarray(jout[rid]))
    c = hooked.calls
    assert c["make_cache"] == 1 and c["clock"] == 0
    assert c["host_result"] == len(c["observe"]) == len(log)
    kinds = [k for k, _, _ in c["observe"]]
    assert [live for _, _, live in c["observe"]] == [
        e["live_decode"] for e in log]
    assert all((chunk > 0) == e["prefill_in_flight"] for (_, chunk, _), e
               in zip(c["observe"], log))
    assert ("verify" in kinds) == (spec_depth is not None)
    hooked.serve([Request(rid=0, prompt=np.arange(3, 9, dtype=np.int32),
                          max_new_tokens=3, eos_id=-2, deadline_s=60.0)])
    # once a turn of the scheduler's loop: every step and the last turn,
    # which finds nothing left
    assert hooked.calls["clock"] == len(hooked.step_log) + 1 > 1


@pytest.mark.parametrize("num_slots,chunk_pages,rate", [
    (2, 2, 0.25), (8, 32, 0.25), (8, 32, 0.0), (5, 3, 0.6)])
def test_pool_headroom_matches_reference(num_slots, chunk_pages, rate):
    kw = dict(num_slots=num_slots, chunk_pages=chunk_pages,
              preempt_rate=rate)
    assert tune_pool_headroom(**kw) == jax_headroom(**kw)


def test_prefill_chunk_is_page_aligned_and_bounded_by_the_step_target():
    kw = dict(b_h=16, n_ctx=4096, e=128, page=16)
    # at the H100's rates the full-width step fits the target whole
    assert tune_prefill_chunk(**kw) == 4096
    tight = tune_prefill_chunk(**kw, step_seconds_target=1e-4)
    assert 16 <= tight < 4096 and tight % 16 == 0
    # a target no step can meet floors at one page
    assert tune_prefill_chunk(**kw, step_seconds_target=1e-6) == 16


def test_engine_headroom_and_chunk_defaults(pair):
    def engine(**kw):
        return ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                        device="cpu", max_len=MAX_LEN,
                                        batch_size=2, page_size=4, **kw)

    full = engine()
    assert full.headroom_pages == 0
    assert full.chunk_size % 4 == 0 and 4 <= full.chunk_size <= MAX_LEN
    hot = engine(decode_reserve_frac=0.5, chunk_size=8)
    assert hot.headroom_pages == tune_pool_headroom(num_slots=2,
                                                    chunk_pages=2)
    with pytest.raises(ValueError):
        engine(decode_reserve_frac=0.0)
