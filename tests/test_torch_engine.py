"""The port's wave ``ServingEngine`` against the JAX ``ServingEngine``.

Both engines serve the same requests over the same fp32 weights (the
reference with ``attn_impl="pallas"`` in interpret mode, the port with
its kernels' plain versions on the CPU). Tokens must agree token for
token, and the logits of every prefill and decode step within 1e-4,
across mixed prompt lengths, a wave padded with a dummy row, an EOS stop,
``max_new_tokens=0`` and malformed requests that end FAILED.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.obs.trace import Tracer
from repro_torch.serving import (
    FaultInjector,
    Request,
    RequestState,
    ServingEngine,
)
from test_torch_harness import LOGITS_ATOL, as_numpy, model_pair, prompts

MAX_LEN = 48


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=1)


def _requests(cls, specs):
    return [cls(rid=i, prompt=p, max_new_tokens=n, eos_id=eos)
            for i, (p, n, eos) in enumerate(specs)]


def _capture_jax(eng, log):
    prefill, decode = eng._prefill_fn, eng._decode

    def cap_prefill(p, t):
        out = prefill(p, t)
        log.append(("prefill", as_numpy(out[0])))
        return out

    def cap_decode(p, c, t, pos):
        out = decode(p, c, t, pos)
        log.append(("decode", as_numpy(out[0])))
        return out

    eng._prefill_fn, eng._decode = cap_prefill, cap_decode


def _capture_torch(eng, log):
    prefill, decode = eng._prefill, eng._decode

    def cap_prefill(t):
        out = prefill(t)
        log.append(("prefill", as_numpy(out[0])))
        return out

    def cap_decode(c, t, pos):
        out = decode(c, t, pos)
        log.append(("decode", as_numpy(out[0])))
        return out

    eng._prefill, eng._decode = cap_prefill, cap_decode


def _serve_both(pair, specs, batch_size=2):
    jeng = JaxServingEngine(pair.jmodel, pair.jparams, max_len=MAX_LEN,
                            batch_size=batch_size)
    teng = ServingEngine(pair.tmodel, pair.tparams, max_len=MAX_LEN,
                         batch_size=batch_size, device="cpu")
    jlog, tlog = [], []
    _capture_jax(jeng, jlog)
    _capture_torch(teng, tlog)
    jout = jeng.serve(_requests(JaxRequest, specs))
    tout = teng.serve(_requests(Request, specs))
    return jeng, teng, jout, tout, jlog, tlog


def _specs(pair, lengths, budgets, eos=None):
    vocab = pair.tcfg.vocab_size
    eos = eos or {}
    return [(prompts(100 + i, 1, n, vocab)[0], m, eos.get(i, -2))
            for i, (n, m) in enumerate(zip(lengths, budgets))]


def test_engine_matches_reference_tokens_and_step_logits(pair):
    # lengths 5 | 9 9 | 9 | 12: two waves padded with a dummy row
    lengths, budgets = [5, 9, 9, 9, 12], [4, 6, 0, 3, 5]
    probe = _serve_both(pair, _specs(pair, lengths, budgets))[2]
    # stop request 1 at its second token with an EOS
    eos = {1: int(probe[1][1])}
    jeng, teng, jout, tout, jlog, tlog = _serve_both(
        pair, _specs(pair, lengths, budgets, eos))
    assert set(tout) == set(jout) == set(range(5))
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
        assert teng.results[rid].state.value == jeng.results[rid].state.value
        assert teng.results[rid].tokens == jeng.results[rid].tokens
    assert len(tout[1]) <= 2 and tout[1][-1] == eos[1]
    assert len(tout[2]) == 0
    assert teng.results[2].state is RequestState.FINISHED
    assert [kind for kind, _ in tlog] == [kind for kind, _ in jlog]
    for (kind, got), (_, want) in zip(tlog, jlog):
        np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0,
                                   err_msg=kind)
    assert teng.metrics.counter("serving.tokens_generated").value == sum(
        len(v) for v in tout.values())


def test_malformed_requests_fail_like_the_reference(pair):
    vocab = pair.tcfg.vocab_size
    specs = [(np.array([], np.int32), 3, -2),                # empty prompt
             (prompts(1, 1, 40, vocab)[0], 20, -2),           # past max_len
             (prompts(2, 1, 6, vocab)[0], 3, -2)]
    jeng, teng, jout, tout, jlog, tlog = _serve_both(pair, specs)
    for rid in (0, 1):
        assert teng.results[rid].state is RequestState.FAILED
        assert jeng.results[rid].state.value == "failed"
        assert teng.results[rid].error == jeng.results[rid].error
        assert len(tout[rid]) == 0
    np.testing.assert_array_equal(tout[2], np.asarray(jout[2]))
    for (_, got), (_, want) in zip(tlog, jlog):
        np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_greedy_output_matches_forward_rollout(pair):
    vocab = pair.tcfg.vocab_size
    ps = [prompts(7, 1, 9, vocab)[0], prompts(8, 1, 9, vocab)[0],
          prompts(9, 1, 5, vocab)[0]]
    eng = ServingEngine(pair.tmodel, pair.tparams, max_len=MAX_LEN,
                        batch_size=2, device="cpu")
    out = eng.serve([Request(rid=i, prompt=p, max_new_tokens=4, eos_id=-2)
                     for i, p in enumerate(ps)])
    toks = ps[2].tolist()
    for _ in range(4):
        logits, _ = pair.tmodel.forward(pair.tparams,
                                        torch.tensor([toks]), pair.tcfg)
        toks.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(out[2], np.array(toks[5:], np.int32))


class _NanAtStep(FaultInjector):
    def corrupt_step_ok(self, step, ok):
        ok = ok.copy()
        if step == 1:
            ok[0] = False
        return ok


def test_nan_guard_deadline_and_trace(pair):
    vocab = pair.tcfg.vocab_size
    tracer = Tracer(enabled=True)
    eng = ServingEngine(pair.tmodel, pair.tparams, max_len=MAX_LEN,
                        batch_size=2, tracer=tracer, device="cpu")
    eng.injector = _NanAtStep()
    reqs = [Request(rid=0, prompt=prompts(3, 1, 6, vocab)[0],
                    max_new_tokens=5, eos_id=-2),
            Request(rid=1, prompt=prompts(4, 1, 6, vocab)[0],
                    max_new_tokens=5, eos_id=-2),
            Request(rid=2, prompt=prompts(5, 1, 7, vocab)[0],
                    max_new_tokens=5, eos_id=-2, deadline_s=0.0)]
    out = eng.serve(reqs)
    assert eng.results[0].state is RequestState.FAILED
    assert eng.results[0].error == "non-finite logits" and len(out[0]) == 1
    assert eng.results[1].state is RequestState.FINISHED and len(out[1]) == 5
    assert eng.results[2].state is RequestState.CANCELLED
    assert eng.metrics.counter("serving.nan_guard_trips").value == 1
    names = {ev["name"] for ev in tracer.export()["traceEvents"]}
    assert {"request", "prefilling", "decoding", "step"} <= names
    assert len(eng.token_walltimes[1]) == 5


def test_engine_refuses_params_on_another_device(pair):
    meta = dict(pair.tparams, embed=pair.tparams["embed"].to("meta"))
    with pytest.raises(ValueError):
        ServingEngine(pair.tmodel, meta, device="cpu")
