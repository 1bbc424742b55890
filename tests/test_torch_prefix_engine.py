"""The port's ``ContinuousBatchingEngine(prefix_cache=True)`` against the JAX
package's.

Both engines serve the same requests over the same fp32 weights (random
norm scales, so the token streams vary): the reference on
``attn_impl="xla_full"``, the port on its kernels' plain versions. Greedy
tokens must agree token for token with the reference's prefix-cache
engine and with the port's engine with the cache off, and
``prefix_stats`` with the reference's: a prompt resident whole (a full
hit: one page copied on write, no prefill chunk) at every divergence
offset within a page, on fp32 and int8 pools; a prompt sharing 12 + d
tokens, then diverging (a partial hit at whole pages, prefill resuming at
token 12); a full hit preempted mid-decode; cached prefixes evicted
before any live request is preempted; a seeded exhaustion burst over a
shared prefix; and a speculative serve with sharing, on fp32 and int8
pools. The port's
``PoolAuditor`` checks every step and the drain. The copy-on-write copy
carries K, V and an int8 pool's scales; the trace and the metrics carry
the prefix counters. ``chip_smoke.py``'s shared-prefix traffic has the
shape its phase states, and its watcher catches each request's
first-token logits as the engine draws the token.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving import SeededFaults as JaxSeededFaults
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.obs.trace import Tracer
from repro_torch.serving import (
    NO_FAULTS,
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
    RequestState,
    ScriptedFaults,
    SeededFaults,
)
from test_torch_harness import model_pair, prompts

ENGINE = dict(max_len=40, batch_size=2, page_size=4, chunk_size=8,
              cache_reserve_frac=0.5)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=3, jax_impl="xla_full",
                      norm_std=2.0)


@pytest.fixture(scope="module")
def engines(pair):
    """One instance of each engine a pool dtype (the reference's jitted
    steps compile once a module): the reference's and the port's with
    the prefix cache on, the port's with it off."""
    out = {}
    for name, kv_dtype in (("fp32", None), ("int8", "int8")):
        out[name] = (
            JaxEngine(pair.jmodel, pair.jparams, kv_dtype=kv_dtype,
                      prefix_cache=True, **ENGINE),
            ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                     device="cpu", kv_dtype=kv_dtype,
                                     prefix_cache=True, **ENGINE),
            ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                     device="cpu", kv_dtype=kv_dtype,
                                     **ENGINE))
    return out


def _prompt(vocab, n, seed):
    return prompts(seed, 1, n, vocab)[0]


def _serve(eng, reqs, injector=NO_FAULTS, auditor=None):
    eng.injector, eng.auditor = injector, auditor
    try:
        return eng.serve(reqs)
    finally:
        eng.injector, eng.auditor = NO_FAULTS, None


def _requests(cls, ps, new):
    return [cls(rid=i, prompt=p.copy(), max_new_tokens=n, eos_id=-2)
            for i, (p, n) in enumerate(zip(ps, new))]


def _same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")


def _like_reference(engines, dtype, ps, new, jax_inj=NO_FAULTS,
                    inj=NO_FAULTS):
    """Serve ``ps`` on the reference's and the port's prefix-cache engines
    (the port's under the auditor) and on the port's cacheless engine;
    tokens agree across all three and ``prefix_stats`` across the first
    two. Returns the port's prefix-cache engine."""
    jeng, eng, cold = engines[dtype]
    jout = _serve(jeng, _requests(JaxRequest, ps, new), jax_inj)
    aud = PoolAuditor()
    out = _serve(eng, _requests(Request, ps, new), inj, aud)
    _same_tokens(out, jout)
    assert eng.prefix_stats == jeng.prefix_stats
    assert aud.steps_checked > 0      # final_check ran inside serve()
    _same_tokens(_serve(cold, _requests(Request, ps, new)), out)
    assert cold.prefix_stats["hits"] == cold.prefix_stats["misses"] == 0
    for rid, rec in eng.results.items():
        assert rec.state is RequestState.FINISHED
        assert rec.prefix_hit_tokens == jeng.results[rid].prefix_hit_tokens
    return eng


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_full_hit_at_every_offset_like_the_reference(pair, engines, dtype):
    """A prompt that is a proper prefix of a published one is a full hit:
    no prefill chunk, one page copied (on int8 pools its scales too), and
    the tokens of the cold serve, at every divergence offset."""
    vocab = pair.tcfg.vocab_size
    p = _prompt(vocab, 16, seed=3)
    for d in range(4):
        blen = 12 + d
        eng = _like_reference(engines, dtype, [p, p[:blen]], [4, 4])
        st = eng.prefix_stats
        assert st["misses"] == 1 and st["hits"] == 1, (d, st)
        assert st["cow_copies"] == 1 and st["hit_tokens"] == blen, (d, st)
        assert eng.results[1].prefix_hit_tokens == blen
        # the full hit never enters the prefill stream: two requests,
        # chunk steps for the publisher's 16 tokens only
        chunks = sum(e["prefill_in_flight"] for e in eng.step_log)
        assert chunks == 2, (d, chunks)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_divergent_suffix_at_every_offset_like_the_reference(pair, engines,
                                                             dtype):
    """12 + d shared tokens then a suffix: a partial hit at whole pages, so
    prefill resumes at token 12 and the d shared tokens past the last
    full page are computed again."""
    vocab = pair.tcfg.vocab_size
    p = _prompt(vocab, 16, seed=3)
    for d in range(4):
        b = np.concatenate([p[:12 + d], _prompt(vocab, 6, seed=40 + d)])
        eng = _like_reference(engines, dtype, [p, b], [4, 4])
        st = eng.prefix_stats
        assert st["hits"] == 1 and st["cow_copies"] == 0, (d, st)
        assert st["hit_tokens"] == 12, (d, st)


# The port appends a slot's page before the step that writes its row, the
# reference after it (ROADMAP C4), so an injected exhaustion may preempt a
# request one token earlier. Where it does, the preempted request resumes
# with a shorter prompt and its re-admission maps another prefix:
# ``prefix_stats`` then differ from the reference's as stated beside each
# case, while tokens still agree.


@pytest.mark.parametrize("k", [1, 4, 7])
def test_full_hit_preempted_mid_decode_like_the_reference(pair, engines, k):
    """A full hit preempted at the k-th append re-prefills through the
    chunk path, where it may hit the cache again; tokens stay the
    uncontended cold serve's and the reference's."""
    vocab = pair.tcfg.vocab_size
    p = _prompt(vocab, 16, seed=3)
    jeng, eng, cold = engines["fp32"]
    want = _serve(cold, _requests(Request, [p, p[:14]], [6, 6]))
    jout = _serve(jeng, _requests(JaxRequest, [p, p[:14]], [6, 6]),
                  JaxScriptedFaults(exhaust_at_appends=frozenset({k})))
    out = _serve(eng, _requests(Request, [p, p[:14]], [6, 6]),
                 ScriptedFaults(exhaust_at_appends=frozenset({k})),
                 PoolAuditor())
    _same_tokens(out, want)
    _same_tokens(jout, want)
    assert eng.preemption_count >= 1 and jeng.preemption_count >= 1
    if k == 1:
        # C4: the port's full hit is preempted holding no token, resumes
        # with its 14-token prompt and is a full hit again (a second
        # copy); the reference's holds one token and maps 12 tokens
        assert eng.results[1].prefix_hit_tokens == 14 + 14
        assert jeng.results[1].prefix_hit_tokens == 14 + 12
        assert (eng.prefix_stats["cow_copies"],
                jeng.prefix_stats["cow_copies"]) == (2, 1)
    else:
        assert eng.prefix_stats == jeng.prefix_stats
        assert eng.prefix_stats["cow_copies"] == 1
    # a resumed request is billed only the tokens it prefilled again
    assert eng.recompute_tokens <= sum(
        len(r.resume_prompt()) for r in eng.results.values())


def test_cache_eviction_precedes_live_preemption(pair, engines):
    """Pool pressure from retained prefixes is absorbed by LRU eviction
    inside ``alloc``: evictions, no preemption, the cold serve's tokens."""
    vocab = pair.tcfg.vocab_size
    shared = _prompt(vocab, 8, seed=3)
    ps = [np.concatenate([shared, _prompt(vocab, 4, seed=50 + i)])
          for i in range(4)] + [_prompt(vocab, 12, seed=84),
                                _prompt(vocab, 12, seed=85)]
    eng = _like_reference(engines, "fp32", ps, [4] * 6)
    st = eng.prefix_stats
    assert st["hits"] >= 1 and st["evictions"] >= 1, st
    assert eng.preemption_count == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_fault_burst_with_sharing(pair, engines, seed):
    """Seeded exhaustion over a shared-prefix mix: preemptions among hits,
    copies and evictions; the auditor stays green every step, the drain
    leaks nothing, and tokens are the reference's and the cold serve's."""
    vocab = pair.tcfg.vocab_size
    shared = _prompt(vocab, 8, seed=3)
    ps = [np.concatenate([shared, _prompt(vocab, 4 + 2 * i, seed=60 + i)])
          for i in range(4)]
    new = [3 + i % 2 for i in range(4)]
    jeng, eng, cold = engines["fp32"]
    want = _serve(cold, _requests(Request, ps, new))
    jout = _serve(jeng, _requests(JaxRequest, ps, new),
                  JaxSeededFaults(seed, p_exhaust=0.08))
    aud = PoolAuditor()
    out = _serve(eng, _requests(Request, ps, new),
                 SeededFaults(seed, p_exhaust=0.08), aud)
    _same_tokens(out, want)
    _same_tokens(jout, want)
    assert aud.steps_checked > 0 and eng.prefix_stats["hits"] >= 1
    if seed == 1:
        # C4: the port preempts rid 3 with a token left to emit, so it is
        # admitted again (one more hit, on its own published pages); the
        # reference's had emitted its last token
        assert jeng.results[3].preemptions == eng.results[3].preemptions == 1
        assert eng.prefix_stats["hits"] == jeng.prefix_stats["hits"] + 1
        assert eng.results[3].prefix_hit_tokens == 8 + 16
        assert jeng.results[3].prefix_hit_tokens == 8
    else:
        assert eng.prefix_stats == jeng.prefix_stats
    # a rejection-heavy burst still drains leak-free
    aud2 = PoolAuditor()
    _serve(eng, _requests(Request, ps, new),
           SeededFaults(seed, p_exhaust=0.05, p_reject=0.2), aud2)
    assert aud2.steps_checked > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_speculative_serve_with_sharing_like_the_reference(pair, kv_dtype):
    """``spec_depth=2`` with the prefix cache, on fp32 and int8 pools:
    verify steps read shared pages; tokens, ``prefix_stats`` and
    ``spec_stats`` are the reference's, tokens the cold plain serve's."""
    vocab = pair.tcfg.vocab_size
    span = _prompt(vocab, 4, seed=9)
    p = np.resize(span, 16).astype(np.int32)
    ps = [p, p[:13], np.concatenate([p[:8], _prompt(vocab, 5, seed=11)])]
    new = [8, 8, 8]
    kw = dict(ENGINE, spec_depth=2, prefix_cache=True, kv_dtype=kv_dtype)
    jeng = JaxEngine(pair.jmodel, pair.jparams, **kw)
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   **kw)
    jout = _serve(jeng, _requests(JaxRequest, ps, new))
    out = _serve(eng, _requests(Request, ps, new), auditor=PoolAuditor())
    _same_tokens(out, jout)
    assert eng.prefix_stats == jeng.prefix_stats
    assert eng.spec_stats == jeng.spec_stats
    assert eng.prefix_stats["cow_copies"] == 1
    assert eng.spec_stats["drafted"] > 0
    cold = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    kv_dtype=kv_dtype, **ENGINE)
    _same_tokens(cold.serve(_requests(Request, ps, new)), out)


def test_cow_copies_every_pool_and_scale(pair):
    """``_cow`` sets page dst from page src in every layer's K and V and
    an int8 pool's scales, and leaves every other page alone."""
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   kv_dtype="int8", **ENGINE)
    cache = pair.tmodel.make_cache(2, 40, device="cpu", cache_layout="paged",
                                   page_size=4, num_pages=9,
                                   kv_dtype="int8")
    gen = np.random.default_rng(0)
    for blk in cache["layers"]:
        for t in blk.values():
            t.copy_(type(t)(gen.integers(-100, 100, size=tuple(t.shape)))
                    .to(t.dtype))
    before = [{k: t.clone() for k, t in blk.items()}
              for blk in cache["layers"]]
    eng._cow(cache, 3, 7)
    for blk, old in zip(cache["layers"], before):
        assert set(blk) == {"k", "v", "k_scale", "v_scale"}
        for name, t in blk.items():
            assert (t[:, 7] == old[name][:, 3]).all(), name
            keep = [i for i in range(9) if i != 7]
            assert (t[:, keep] == old[name][:, keep]).all(), name


def test_prefix_telemetry_trace_and_occupancy(pair):
    """The ``prefix.*`` counters, the resident-page gauge, the occupancy
    log and the ``prefix_hit`` trace instants."""
    vocab = pair.tcfg.vocab_size
    p = _prompt(vocab, 16, seed=3)
    tracer = Tracer(enabled=True)
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   tracer=tracer, prefix_cache=True,
                                   **ENGINE)
    ps = [p, p[:14], np.concatenate([p[:8], _prompt(vocab, 3, seed=5)])]
    eng.serve(_requests(Request, ps, [3, 3, 3]))
    st = eng.prefix_stats
    assert st == {"hits": 2, "misses": 1, "hit_rate": 2 / 3,
                  "hit_tokens": 14 + 8, "cow_copies": 1,
                  "evictions": st["evictions"],
                  "pages_deduped": st["pages_deduped"]}
    assert st["pages_deduped"] >= 3 + 1 + 2
    assert len(eng.occupancy_log) == len(eng.step_log) > 0
    resident = eng.metrics.gauge("prefix.resident_cache_pages")
    assert max(resident.series) >= 4
    assert resident.value == len(eng._mgr.cached_pages())
    hits = [ev for ev in tracer.export()["traceEvents"]
            if ev["name"] == "prefix_hit"]
    assert sorted(ev["args"]["tokens"] for ev in hits) == [8, 14]
    assert any("cow_src" in ev["args"] for ev in hits)
    assert [eng.results[i].prefix_hit_tokens for i in range(3)] == [0, 14, 8]
    # the reserve: "auto" on a cache-off engine is 0, on a cache-on one
    # the tuner's
    off = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   max_len=40, batch_size=2, page_size=4)
    assert off.cache_reserve_frac == 0.0 and off.prefix_stats["hits"] == 0
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                 prefix_cache=True, cache_reserve_frac=2.0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_shared_prefix_traffic_has_its_stated_shape():
    smoke = _chip_smoke()
    ps = smoke.shared_prefix_prompts(92544)
    page = smoke.CONT["page_size"]
    assert len(ps) == 16 and len(ps[0]) == smoke.PREFIX_PUBLISHER == 3000
    for p, n in zip(ps[1:3], smoke.PREFIX_FULL_HITS):
        np.testing.assert_array_equal(p, ps[0][:n])
    assert 2500 % page and not 2400 % page  # mid-page, on a boundary
    suffixes = ps[3:14]
    for p in suffixes:
        np.testing.assert_array_equal(p[:2008], ps[0][:2008])
        assert 16 <= len(p) - 2008 <= 1500
        assert not np.array_equal(p[2000:2016], ps[0][2000:2016])
    # the suffix requests map 125 pages and prefill from q_offset 2000,
    # which is not a multiple of B5's 64-row blocks
    assert smoke.PREFIX_SHARED // page * page == 2000 and 2000 % 64
    for p in ps[14:]:
        assert not np.array_equal(p[:page], ps[0][:page])


def test_chip_smoke_catches_first_token_logits(pair):
    """The watcher keeps the logits each token is drawn from: the last
    chunk's row, or a full hit's first decode row; a hit's caught logits
    match the cold serve's, and a planted difference fails the check."""
    smoke = _chip_smoke()
    vocab = pair.tcfg.vocab_size
    p = _prompt(vocab, 16, seed=3)
    ps = {0: p, 1: p[:14], 2: np.concatenate([p[:8], _prompt(vocab, 5, 5)])}
    caught, out = {}, {}
    for name, kw in (("on", dict(prefix_cache=True)), ("off", {})):
        eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                       device="cpu", **dict(ENGINE, **kw))
        caught[name] = smoke.watch_first_logits(pair.tmodel, eng, ps, {1})
        out[name] = eng.serve(_requests(Request, list(ps.values()),
                                        [3, 3, 3]))
        assert sorted(caught[name]) == [0, 1, 2]
        for rid, logits in caught[name].items():
            assert int(logits.argmax()) == int(out[name][rid][0])
    rows = smoke.logits_vs(caught["on"], caught["off"], [1, 2], 1e-4)
    assert all(r["argmax_equal"] for r in rows)
    wrong = {rid: t + 1.0 for rid, t in caught["off"].items()}
    with pytest.raises(AssertionError, match="first-token logits"):
        smoke.logits_vs(caught["on"], wrong, [1, 2], 1e-4)
