"""The MoE archs through the port's engines against the JAX package's.

deepseek-moe-smoke (2 shared experts) and moonshot-smoke (none), fp32
weights with random norm scales, eight slots: the wave ``ServingEngine``
(waves padded with dummy rows), ``ContinuousBatchingEngine`` on fp32 and
int8 pools, with ``spec_depth=2`` and with ``prefix_cache=True``, each
token for token with the same engine of the reference (``xla_full``),
``spec_stats`` and ``prefix_stats`` too.

Every call routes all its rows, and an expert takes at most its capacity
of them in token-major order, so padding rows, idle decode slots and a
chunk's padded tail take capacity ahead of later rows. At the smoke
configs' capacity factor of 8 nothing is dropped; at ``DROP_CF`` the
reference drops assignments in every serve (counted inside its jitted
steps), and the port must drop the same ones to give its tokens. A port
that pads idle slots with token 1 instead of 0 must lose the reference's
tokens there: the tests see drop order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_tfm
from repro.models.api import build_model as jax_build_model
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model
from repro_torch.serving import (
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
    ServingEngine,
)
from test_torch_harness import model_pair, prompts

ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b"]
DROP_CF = 1.0
ENGINE = dict(max_len=40, batch_size=8, page_size=4, chunk_size=8)
# (prompt length, new tokens): slots free at different steps, so idle
# slots sit before live ones in later decode steps
SPEC = [(3, 8), (5, 8), (4, 9), (6, 8), (3, 10), (3, 24), (13, 5)]
WAVES = [(9, 5), (9, 3), (9, 6), (9, 4), (9, 2), (5, 7), (5, 3)]

_DROPS = {"dropped": 0, "assignments": 0}


def _count_drops(keep):
    _DROPS["dropped"] += int((~np.asarray(keep)).sum())
    _DROPS["assignments"] += int(np.asarray(keep).size)


@pytest.fixture(scope="module", autouse=True)
def reference_drop_counter():
    """The reference's ``moe_ffn`` as its blocks call it, with a callback
    that counts the assignments its capacity drops (its own routing, run
    inside the jitted steps)."""
    real = jax_tfm.moe_ffn

    def counted(params, x, cfg):
        m = cfg.moe
        t = x.shape[0] * x.shape[1]
        cap = max(4, int(m.capacity_factor * t * m.top_k / m.num_experts))
        logits = x.reshape(t, -1).astype(jnp.float32) @ params[
            "router"].astype(jnp.float32)
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
        flat = ids.reshape(-1)
        pos = jnp.cumsum(jax.nn.one_hot(flat, m.num_experts,
                                        dtype=jnp.int32), axis=0) - 1
        pos = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
        jax.debug.callback(_count_drops, pos < cap)
        return real(params, x, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tfm, "moe_ffn", counted)
        yield


_PAIRS: dict = {}


def _models(arch: str, cf: float):
    """(reference model, reference params, port model, port params) of the
    arch's smoke at capacity factor ``cf``."""
    if arch not in _PAIRS:
        _PAIRS[arch] = model_pair(arch, seed=3, jax_impl="xla_full",
                                  norm_std=2.0)
    p = _PAIRS[arch]

    def at(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))

    return (jax_build_model(at(p.jcfg)), p.jparams,
            build_model(at(p.tcfg)), p.tparams)


def _requests(cls, vocab, spec, seed=40):
    return [cls(rid=i, prompt=prompts(seed + i, 1, n, vocab)[0],
                max_new_tokens=m, eos_id=-2)
            for i, (n, m) in enumerate(spec)]


def _same_tokens(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"{what} rid {rid}")


def _reference(serve):
    """Run the reference's ``serve``; returns (tokens, assignments it
    dropped)."""
    _DROPS.update(dropped=0, assignments=0)
    out = serve()
    jax.effects_barrier()
    assert _DROPS["assignments"] > 0
    return out, _DROPS["dropped"]


def _port_drops(serve):
    """Run the port's ``serve`` counting the assignments it drops."""
    real, seen = tmoe.moe_route, []

    def counted(params, tokens, cfg):
        r = real(params, tokens, cfg)
        seen.append(int((~r.keep).sum()))
        return r

    tmoe.moe_route = counted
    try:
        return serve(), sum(seen)
    finally:
        tmoe.moe_route = real


def _check_drops(cf, ref_dropped, port_dropped):
    assert port_dropped == ref_dropped
    if cf == DROP_CF:
        assert ref_dropped > 0
    else:
        assert ref_dropped == 0


@pytest.mark.parametrize("cf", [8.0, DROP_CF])
@pytest.mark.parametrize("arch", ARCHS)
def test_wave_engine_matches_reference(arch, cf):
    """Waves of 5 and 2 requests padded with dummy rows to eight."""
    jmodel, jparams, tmodel, tparams = _models(arch, cf)
    vocab = tmodel.cfg.vocab_size
    kw = dict(max_len=ENGINE["max_len"], batch_size=ENGINE["batch_size"])
    jout, ref_dropped = _reference(
        lambda: JaxServingEngine(jmodel, jparams, **kw).serve(
            _requests(JaxRequest, vocab, WAVES)))
    out, dropped = _port_drops(
        lambda: ServingEngine(tmodel, tparams, device="cpu", **kw).serve(
            _requests(Request, vocab, WAVES)))
    _same_tokens(out, jout)
    _check_drops(cf, ref_dropped, dropped)
    assert len({t for v in out.values() for t in v.tolist()}) > 5


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("cf", [8.0, DROP_CF])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_reference(arch, cf, kv_dtype):
    jmodel, jparams, tmodel, tparams = _models(arch, cf)
    vocab = tmodel.cfg.vocab_size
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    jeng = JaxEngine(jmodel, jparams, **kw)
    jout, ref_dropped = _reference(
        lambda: jeng.serve(_requests(JaxRequest, vocab, SPEC)))
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw)
    eng.auditor = PoolAuditor()
    out, dropped = _port_drops(
        lambda: eng.serve(_requests(Request, vocab, SPEC)))
    _same_tokens(out, jout)
    _check_drops(cf, ref_dropped, dropped)
    assert eng.step_log == jeng.step_log
    if cf == 8.0 and kv_dtype is None:
        # nothing dropped: every row's tokens are its own, so the wave
        # engine, one request a wave, gives them too
        wave = ServingEngine(tmodel, tparams, device="cpu",
                             max_len=ENGINE["max_len"], batch_size=1)
        _same_tokens(wave.serve(_requests(Request, vocab, SPEC)), out,
                     "wave")


@pytest.mark.parametrize("cf", [8.0, DROP_CF])
@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_matches_reference(arch, cf):
    """``spec_depth=2`` on prompts that repeat a 4-token span (drafts are
    found): tokens and ``spec_stats`` are the reference's."""
    jmodel, jparams, tmodel, tparams = _models(arch, cf)
    vocab = tmodel.cfg.vocab_size
    rng = np.random.default_rng(7)
    ps = [np.resize(rng.integers(3, vocab, size=(4,)), n).astype(np.int32)
          for n, _ in SPEC]

    def reqs(cls):
        return [cls(rid=i, prompt=p.copy(), max_new_tokens=m, eos_id=-2)
                for i, (p, (_, m)) in enumerate(zip(ps, SPEC))]

    kw = dict(ENGINE, spec_depth=2)
    jeng = JaxEngine(jmodel, jparams, **kw)
    jout, ref_dropped = _reference(lambda: jeng.serve(reqs(JaxRequest)))
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw)
    out, dropped = _port_drops(lambda: eng.serve(reqs(Request)))
    _same_tokens(out, jout)
    _check_drops(cf, ref_dropped, dropped)
    assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_stats["drafted"] > 0
    if cf == 8.0:
        plain = ContinuousBatchingEngine(tmodel, tparams, device="cpu",
                                         **ENGINE).serve(reqs(Request))
        _same_tokens(out, plain, "plain")


@pytest.mark.parametrize("cf", [8.0, DROP_CF])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_cache_engine_matches_reference(arch, cf):
    """``prefix_cache=True``: a publisher, a full hit and a suffix hit;
    tokens and ``prefix_stats`` are the reference's."""
    jmodel, jparams, tmodel, tparams = _models(arch, cf)
    vocab = tmodel.cfg.vocab_size
    p = prompts(9, 1, 16, vocab)[0]
    ps = [p, p[:13], np.concatenate([p[:8], prompts(11, 1, 5, vocab)[0]]),
          prompts(12, 1, 7, vocab)[0]]
    new = [8, 6, 7, 5]

    def reqs(cls):
        return [cls(rid=i, prompt=q.copy(), max_new_tokens=n, eos_id=-2)
                for i, (q, n) in enumerate(zip(ps, new))]

    kw = dict(ENGINE, prefix_cache=True, cache_reserve_frac=0.5)
    jeng = JaxEngine(jmodel, jparams, **kw)
    jout, ref_dropped = _reference(lambda: jeng.serve(reqs(JaxRequest)))
    eng = ContinuousBatchingEngine(tmodel, tparams, device="cpu", **kw)
    eng.auditor = PoolAuditor()
    out, dropped = _port_drops(lambda: eng.serve(reqs(Request)))
    _same_tokens(out, jout)
    _check_drops(cf, ref_dropped, dropped)
    assert eng.prefix_stats == jeng.prefix_stats
    assert eng.prefix_stats["hits"] >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_wrong_idle_padding_breaks_the_dropping_case(arch):
    """The port with idle decode slots fed token 1 instead of 0 (the
    model's decode step sees them at position 0): at the smoke capacity
    factor its tokens stay the reference's, at ``DROP_CF`` they do not."""
    for cf, same in ((8.0, True), (DROP_CF, False)):
        jmodel, jparams, tmodel, tparams = _models(arch, cf)
        real = tmodel.paged_decode_step

        def wrong(params, cfg, token, cache, table, positions):
            token = torch.where(positions[:, None] == 0, 1, token)
            return real(params, cfg, token, cache, table, positions)

        bad = dataclasses.replace(tmodel, paged_decode_step=wrong)
        vocab = tmodel.cfg.vocab_size
        jout, _ = _reference(lambda: JaxEngine(jmodel, jparams, **ENGINE)
                             .serve(_requests(JaxRequest, vocab, SPEC)))
        out = ContinuousBatchingEngine(bad, tparams, device="cpu",
                                       **ENGINE).serve(
            _requests(Request, vocab, SPEC))
        assert all(np.array_equal(out[rid], jout[rid])
                   for rid in jout) == same, cf
