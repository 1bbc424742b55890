"""The port's speculative ``ContinuousBatchingEngine`` against the JAX
package's, and against plain greedy decode.

Both engines serve the same requests over the same fp32 weights (random
norm scales, so the token streams vary): the reference on
``attn_impl="xla_full"``, the port on its kernels' plain versions. The
prompts tile a short random span, so the prompt-lookup drafter finds
matches. Tokens must agree token for token with the reference's
speculative engine and with the port's plain engine, on fp32 and int8
pools, and the ``spec_stats`` counters with the reference's. A drafter
that reads the plain run's future (with every third draft spoiled) makes
verify steps accept multi-token prefixes; an adversarial drafter whose
drafts all lose costs verify rows only; a burst of injected pool
exhaustion preempts mid-speculation; the trace carries the verify steps.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.obs.trace import Tracer
from repro_torch.serving import (
    NO_FAULTS,
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
    RequestState,
    ScriptedFaults,
)
from test_torch_harness import model_pair

ENGINE = dict(max_len=40, batch_size=2, page_size=4, chunk_size=8)
SPEC = [(9, 8), (13, 6), (6, 9), (17, 5), (8, 7)]


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=3, jax_impl="xla_full",
                      norm_std=2.0)


def _requests(cls, vocab, spec=SPEC, period=4):
    rng = np.random.default_rng(7)
    out = []
    for i, (n, m) in enumerate(spec):
        span = rng.integers(3, vocab, size=(period,))
        out.append(cls(rid=i, prompt=np.resize(span, n).astype(np.int32),
                       max_new_tokens=m, eos_id=-2))
    return out


class OracleDrafter:
    """Drafts the plain run's next tokens for the context's prompt, with
    every third draft replaced by a wrong token: verify steps then accept
    prefixes of every length."""

    def __init__(self, plain: dict, reqs):
        self.future = {tuple(r.prompt.tolist()): list(plain[r.rid])
                       for r in reqs}

    def draft(self, context, k):
        for prompt, toks in self.future.items():
            n = len(prompt)
            if tuple(context[:n].tolist()) == prompt:
                done = len(context) - n
                out = list(toks[done:done + k])
                return [t if (done + i) % 3 else t + 1
                        for i, t in enumerate(out)]
        return []


class BadDrafter:
    def draft(self, context, k):
        return [3] * k if k > 0 else []


def _serve(eng, reqs, *, injector=NO_FAULTS, auditor=None, drafter=None):
    eng.injector, eng.auditor = injector, auditor
    if drafter is not None:
        eng._drafter = drafter
    try:
        return eng.serve(reqs)
    finally:
        eng.injector, eng.auditor = NO_FAULTS, None


def _same_tokens(got, want, what):
    assert set(got) == set(want), what
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"{what}: rid {rid}")


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("depth", [1, 3, 4])
def test_speculative_tokens_match_reference_and_plain(pair, kv_dtype, depth):
    vocab = pair.tcfg.vocab_size
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    plain = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                     **kw).serve(_requests(Request, vocab))
    jeng = JaxEngine(pair.jmodel, pair.jparams, spec_depth=depth, **kw)
    jout = jeng.serve(_requests(JaxRequest, vocab))
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   spec_depth=depth, **kw)
    aud = PoolAuditor()
    out = _serve(eng, _requests(Request, vocab), auditor=aud)
    _same_tokens(out, jout, "reference")
    _same_tokens(out, plain, "plain greedy")
    assert eng.spec_stats == jeng.spec_stats
    assert eng.step_log == jeng.step_log
    assert len({t for v in out.values() for t in v.tolist()}) > 5
    assert aud.steps_checked > 0 and eng._mgr.pages_used == 0
    verify = eng.metrics.histogram("engine.step_s.verify").count
    assert verify > 0
    if depth == 1:
        assert eng.spec_stats["drafted"] == 0      # k = 1 never drafts


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_accepted_drafts_match_reference_and_plain(pair, kv_dtype):
    vocab = pair.tcfg.vocab_size
    kw = dict(ENGINE, kv_dtype=kv_dtype, spec_depth=4)
    plain = ContinuousBatchingEngine(
        pair.tmodel, pair.tparams, device="cpu",
        **dict(ENGINE, kv_dtype=kv_dtype)).serve(_requests(Request, vocab))
    reqs = _requests(Request, vocab)
    jeng = JaxEngine(pair.jmodel, pair.jparams, **kw)
    jout = _serve(jeng, _requests(JaxRequest, vocab),
                  drafter=OracleDrafter(plain, reqs))
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   **kw)
    out = _serve(eng, reqs, auditor=PoolAuditor(),
                 drafter=OracleDrafter(plain, reqs))
    _same_tokens(out, jout, "reference")
    _same_tokens(out, plain, "plain greedy")
    st = eng.spec_stats
    assert st == jeng.spec_stats
    assert 0 < st["accepted"] < st["drafted"]
    # multi-token steps: fewer verify steps than tokens decoded after the
    # first (which comes out of prefill)
    decoded = sum(len(v) - 1 for v in out.values())
    steps = eng.metrics.histogram("engine.step_s.verify").count
    assert steps < decoded


def test_adversarial_drafter_costs_only_verify_rows(pair):
    vocab = pair.tcfg.vocab_size
    kw = dict(ENGINE, spec_depth=4)
    plain = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                     **ENGINE).serve(_requests(Request,
                                                               vocab))
    jeng = JaxEngine(pair.jmodel, pair.jparams, **kw)
    jout = _serve(jeng, _requests(JaxRequest, vocab), drafter=BadDrafter())
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   **kw)
    out = _serve(eng, _requests(Request, vocab), auditor=PoolAuditor(),
                 drafter=BadDrafter())
    _same_tokens(out, jout, "reference")
    _same_tokens(out, plain, "plain greedy")
    assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_stats["drafted"] > 0 and eng.spec_stats["accepted"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("appends", [{5, 11}, {2, 3, 4}, {14}])
def test_exhaustion_burst_mid_speculation(pair, kv_dtype, appends):
    """In fp32 every request keeps the uncontended tokens and the
    reference's. An int8 re-prefill quantizes whole pages where the
    uncontended run requantized them row by row, so a preempted request
    may continue on other tokens, and the port evicts a step earlier than
    the reference (it allocates before the step that writes a row,
    ROADMAP C4); there the requests that were never preempted keep the
    uncontended tokens."""
    vocab = pair.tcfg.vocab_size
    kw = dict(ENGINE, kv_dtype=kv_dtype, spec_depth=4)
    plain = ContinuousBatchingEngine(
        pair.tmodel, pair.tparams, device="cpu",
        **dict(ENGINE, kv_dtype=kv_dtype)).serve(_requests(Request, vocab))
    jeng = JaxEngine(pair.jmodel, pair.jparams, **kw)
    jout = _serve(jeng, _requests(JaxRequest, vocab),
                  injector=JaxScriptedFaults(
                      exhaust_at_appends=frozenset(appends)))
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   **kw)
    aud = PoolAuditor()
    out = _serve(eng, _requests(Request, vocab), auditor=aud,
                 injector=ScriptedFaults(exhaust_at_appends=frozenset(
                     appends)))
    if kv_dtype is None:
        _same_tokens(out, jout, "reference")
        _same_tokens(out, plain, "plain greedy")
    else:
        kept = {rid for rid, rec in eng.results.items()
                if rec.preemptions == 0}
        assert kept
        _same_tokens({r: out[r] for r in kept}, {r: plain[r] for r in kept},
                     "plain greedy, never preempted")
    assert eng.spec_stats == jeng.spec_stats
    assert eng.preemption_count >= 1 and eng.recompute_tokens > 0
    assert aud.steps_checked > 0 and eng._mgr.pages_used == 0
    assert all(r.state is RequestState.FINISHED
               for r in eng.results.values())


def test_reservation_preempts_on_a_hot_pool(pair):
    """A pool run hot: the verify reservation itself exhausts the pool
    and preempts the youngest request; every request still gets the
    uncontended tokens."""
    vocab = pair.tcfg.vocab_size
    spec = [(9, 12), (13, 12), (5, 20)]
    kw = dict(ENGINE, batch_size=3)
    base = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    **kw).serve(_requests(Request, vocab,
                                                          spec))
    hot = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   num_pages=12, decode_reserve_frac=0.2,
                                   headroom_pages=0, spec_depth=4, **kw)
    out = _serve(hot, _requests(Request, vocab, spec),
                 auditor=PoolAuditor())
    _same_tokens(out, base, "uncontended")
    assert hot.preemption_count >= 1


def test_speculative_trace_metrics_and_options(pair):
    vocab = pair.tcfg.vocab_size
    tracer = Tracer(enabled=True)
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   spec_depth=4, tracer=tracer, **ENGINE)
    _serve(eng, _requests(Request, vocab, SPEC[:3]), drafter=BadDrafter())
    events = tracer.export()["traceEvents"]
    kinds = {(e.get("args") or {}).get("kind") for e in events
             if e.get("name") == "step"}
    assert "verify" in kinds
    names = {e["name"] for e in events}
    assert {"draft", "verify", "speculation"} <= names
    assert all("accepted" in e["args"] for e in events
               if e["name"] == "speculation")
    assert eng.metrics.series("spec.acceptance_rate").by_key
    plain = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                     **ENGINE)
    plain.serve(_requests(Request, vocab, SPEC[:1]))
    assert "engine.step_s.verify" not in json.dumps(plain.metrics.to_json())
    assert plain.spec_stats == {"drafted": 0, "accepted": 0,
                                "acceptance_rate": 0.0}
    auto = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    spec_depth="auto", **ENGINE)
    assert 1 <= auto.spec_depth <= 8
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                 spec_depth=0, **ENGINE)
