"""The port's mamba2 (SSM) slice against the JAX package.

* B8's plain version (``ssd_intra_chunk_plain``) against the Pallas
  kernel ``ssd_intra_chunk`` in interpret mode, atol 3e-5 (fp32 sums in
  another order);
* the chunked scan, the plain oracle ``models.ssm.ssd_chunked`` and the
  kernel route ``ssd_chunked_kernel``, with and without an initial state,
  against the reference's ``ssd_chunked`` and ``ssd_chunked_pallas``
  (interpret mode), and a ragged length (40 at chunk 32, padded to a whole
  chunk) against the reference at chunk 8, which divides it;
* ``ssd_block``, chunked and streaming (on each ``attn_impl``:
  ``"chunked"`` takes the plain scan), and the model's logits (forward,
  prefill, teacher-forced decode) against the JAX model, atol 1e-4;
* the wave ``ServingEngine``'s tokens against the JAX engine's, with
  random norm scales so that greedy tokens vary, also on
  ``kv_dtype="int8"`` (which leaves SSD state as it is), and a ragged
  prompt the reference cannot serve at its own chunk (ROADMAP C5);
* ``ContinuousBatchingEngine`` and the paged functions refuse the SSM
  stack, as the reference's paged cache does.

Inputs come from numpy seeds; both packages run in fp32.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ssd_scan as jssd
from repro.models.api import build_model as jax_build_model
from repro.models import ssm as jssm
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.configs import get_arch, get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm
from repro_torch.models.api import build_model
from repro_torch.serving import (
    ContinuousBatchingEngine,
    Request,
    RequestState,
    ServingEngine,
)
from test_torch_harness import (
    FP32_ATOL,
    LOGITS_ATOL,
    as_numpy,
    assert_close,
    model_pair,
    prompts,
    rand,
    to_jax,
    to_torch,
)

ARCH = "mamba2-130m"
SCAN_ATOL = 1e-4     # the scan's y and final state, fp32, other op order
MAX_LEN = 80


def _inputs(seed: int, d0: int, d1: int, d2: int, p: int, n: int):
    """x (d0, d1, d2, p), a (d0, d1, d2), b and c (d0, d1, d2, n), as the
    reference's kernel test draws them: x ~ N(0, 1), a = -0.1 |N(0, 1)|,
    b and c ~ 0.3 N(0, 1). B8 takes (BH, NC, Q, F), the scan (B, L, H,
    F)."""
    x = rand(seed, (d0, d1, d2, p))
    a = -np.abs(rand(seed + 1, (d0, d1, d2))) * 0.1
    b = rand(seed + 2, (d0, d1, d2, n), 0.3)
    c = rand(seed + 3, (d0, d1, d2, n), 0.3)
    return x, a, b, c


@pytest.mark.parametrize("bh,nc,q,p,n", [(2, 3, 64, 16, 32),
                                         (3, 2, 32, 8, 16)])
def test_intra_chunk_plain_matches_pallas(bh, nc, q, p, n):
    x, a, b, c = _inputs(bh * 10 + q, bh, nc, q, p, n)
    want_y, want_s = jssd.ssd_intra_chunk(*map(to_jax, (x, a, b, c)),
                                          interpret=True)
    got_y, got_s = tssd.ssd_intra_chunk_plain(*map(to_torch, (x, a, b, c)))
    assert got_y.dtype == got_s.dtype == torch.float32
    assert_close(got_y, want_y, FP32_ATOL)
    assert_close(got_s, want_s, FP32_ATOL)
    # the CPU wrapper runs the plain version and counts no launch
    ops.reset_launch_counts()
    y, s = tssd.ssd_intra_chunk(*map(to_torch, (x, a, b, c)))
    assert torch.equal(y, got_y) and torch.equal(s, got_s)
    assert ops.launch_counts()["ssd_intra_chunk"] == 0


def test_sequential_cumsum_adds_in_order():
    a = to_torch(rand(3, (4, 5, 37)))
    got = tssd.cumsum_sequential(a)
    want = a.clone()
    for t in range(1, 37):
        want[..., t] = want[..., t - 1] + a[..., t]
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_scan_matches_reference(with_state):
    b, length, h, p, n, chunk = 2, 64, 3, 16, 32, 32
    x, a, bm, cm = _inputs(40, b, length, h, p, n)
    s0 = rand(45, (b, h, p, n), 0.2) if with_state else None
    jargs = [to_jax(t) for t in (x, a, bm, cm)]
    jinit = None if s0 is None else to_jax(s0)
    want = jssm.ssd_chunked(*jargs, chunk, initial_state=jinit)
    pallas = jssd.ssd_chunked_pallas(*jargs, chunk, initial_state=jinit,
                                     interpret=True)
    targs = [to_torch(t) for t in (x, a, bm, cm)]
    tinit = None if s0 is None else to_torch(s0)
    for fn in (tssm.ssd_chunked, tssd.ssd_chunked_kernel, ops.ssd_chunked):
        y, final = fn(*targs, chunk, initial_state=tinit)
        assert y.shape == (b, length, h, p) and final.shape == (b, h, p, n)
        for ref in (want, pallas):
            assert_close(y, ref[0], SCAN_ATOL)
            assert_close(final, ref[1], SCAN_ATOL)


@pytest.mark.parametrize("fn", [tssm.ssd_chunked, tssd.ssd_chunked_kernel],
                         ids=["plain", "kernel"])
def test_ragged_length_is_padded_to_a_whole_chunk(fn):
    """40 rows at chunk 32: the reference asserts; the port pads the tail
    and equals the reference at chunk 8, the same maths."""
    b, length, h, p, n = 2, 40, 3, 16, 32
    x, a, bm, cm = _inputs(50, b, length, h, p, n)
    s0 = rand(55, (b, h, p, n), 0.2)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(to_jax, (x, a, bm, cm)), 32)
    want_y, want_s = jssm.ssd_chunked(*map(to_jax, (x, a, bm, cm)), 8,
                                      initial_state=to_jax(s0))
    y, final = fn(*map(to_torch, (x, a, bm, cm)), 32,
                  initial_state=to_torch(s0))
    assert y.shape == (b, length, h, p)
    assert_close(y, want_y, SCAN_ATOL)
    assert_close(final, want_s, SCAN_ATOL)


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH)


@pytest.fixture(scope="module")
def varied():
    return model_pair(ARCH, seed=1, norm_std=2.0)


def _layer(pair, i: int):
    """Layer ``i``'s SSD params in both packages."""
    jblk = jax.tree.map(lambda t: t[i], pair.jparams["units"]["b0"]["ssd"])
    return jblk, pair.tparams["layers"][i]["ssd"]


@pytest.mark.parametrize("impl", ["kernel", "plain", "chunked"])
def test_ssd_block_chunked_and_streaming_match_reference(pair, impl):
    jp, tp = _layer(pair, 1)
    tcfg = dataclasses.replace(pair.tcfg, attn_impl=impl)
    x = rand(60, (2, 64, pair.tcfg.d_model))
    want, (jconv, jstate) = jssm.ssd_block(jp, to_jax(x), pair.jcfg)
    got, (tconv, tstate) = tssm.ssd_block(tp, to_torch(x), tcfg)
    assert_close(got, want, LOGITS_ATOL)
    assert_close(tconv, jconv, FP32_ATOL)
    assert_close(tstate, jstate, LOGITS_ATOL)
    # one streaming step on from those states
    x1 = rand(61, (2, 1, pair.tcfg.d_model))
    want, (jconv, jstate) = jssm.ssd_block(
        jp, to_jax(x1), pair.jcfg, conv_state=jconv, ssm_state=jstate,
        streaming=True)
    got, (tconv, tstate) = tssm.ssd_block(
        tp, to_torch(x1), tcfg, conv_state=tconv, ssm_state=tstate,
        streaming=True)
    assert_close(got, want, LOGITS_ATOL)
    assert_close(tconv, jconv, FP32_ATOL)
    assert_close(tstate, jstate, LOGITS_ATOL)


@pytest.mark.parametrize("length", [1, 9, 64])
def test_forward_logits_match_reference(pair, length):
    toks = prompts(length, 2, length, pair.tcfg.vocab_size)
    want, _ = pair.jmodel.forward(pair.jparams, jnp.asarray(toks), pair.jcfg)
    got, aux = pair.tmodel.forward(pair.tparams, torch.from_numpy(toks),
                                   pair.tcfg)
    assert got.shape == tuple(want.shape) and aux == 0.0
    assert_close(got, want, LOGITS_ATOL)


def test_prefill_and_teacher_forced_decode_match_reference(pair):
    p = pair
    b, s, k = 2, 44, 36       # a 36-token prompt: a chunk and a ragged tail
    toks = prompts(11, b, s, p.tcfg.vocab_size)
    full, _ = p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg)
    # the reference's prompt at a chunk that divides it (36 = 4 x 9)
    jcfg = dataclasses.replace(
        p.jcfg, ssm=dataclasses.replace(p.jcfg.ssm, chunk=9))
    jl, jcache = p.jmodel.prefill(p.jparams, jcfg, jnp.asarray(toks[:, :k]),
                                  s)
    tl, tcache = p.tmodel.prefill(p.tparams, p.tcfg,
                                  torch.from_numpy(toks[:, :k]), s)
    assert_close(tl, jl, LOGITS_ATOL)
    assert_close(tl[:, 0], full[:, k - 1], LOGITS_ATOL)
    for i, blk in enumerate(tcache["layers"]):
        assert blk["conv"].dtype == p.tcfg.compute_dtype
        assert blk["state"].dtype == torch.float32
        assert_close(blk["conv"], jcache["units"]["b0"]["conv"][i],
                     FP32_ATOL)
        assert_close(blk["state"], jcache["units"]["b0"]["state"][i],
                     LOGITS_ATOL)
    states = [blk["state"] for blk in tcache["layers"]]
    for i in range(k, s):
        tok = toks[:, i:i + 1]
        jl, jcache = p.jmodel.decode_step(p.jparams, p.jcfg, jnp.asarray(tok),
                                          jcache, jnp.int32(i))
        tl, tcache = p.tmodel.decode_step(p.tparams, p.tcfg,
                                          torch.from_numpy(tok), tcache, i)
        assert_close(tl, jl, LOGITS_ATOL)
        assert_close(tl[:, 0], full[:, i], LOGITS_ATOL)
    # decode updates the cache's tensors in place
    assert all(blk["state"] is st
               for blk, st in zip(tcache["layers"], states))


def test_make_cache_and_paged_functions(pair):
    cfg = pair.tcfg
    cache = pair.tmodel.make_cache(3, 100, device="cpu", kv_dtype="int8")
    s = cfg.ssm
    di = s.expand * cfg.d_model
    assert len(cache["layers"]) == cfg.num_layers
    for blk in cache["layers"]:
        assert set(blk) == {"conv", "state"}
        assert blk["conv"].shape == (3, s.conv_width - 1,
                                     di + 2 * s.n_groups * s.d_state)
        assert blk["conv"].dtype == cfg.compute_dtype
        assert blk["state"].shape == (3, di // s.head_dim, s.head_dim,
                                      s.d_state)
        assert blk["state"].dtype == torch.float32
    with pytest.raises(ValueError):
        pair.tmodel.make_cache(1, 8, device="cpu", kv_dtype="fp8")
    with pytest.raises(NotImplementedError):
        pair.tmodel.make_cache(1, 8, device="cpu", cache_layout="paged")
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu")


def _serve_both(pair, specs, *, jcfg=None, batch_size=2, kv_dtype=None):
    jmodel = pair.jmodel if jcfg is None else jax_build_model(jcfg)
    jeng = JaxServingEngine(jmodel, pair.jparams, max_len=MAX_LEN,
                            batch_size=batch_size,
                            kv_dtype=None if kv_dtype is None else jnp.int8)
    teng = ServingEngine(pair.tmodel, pair.tparams, max_len=MAX_LEN,
                         batch_size=batch_size, kv_dtype=kv_dtype,
                         device="cpu")
    jout = jeng.serve([JaxRequest(rid=i, prompt=p, max_new_tokens=m,
                                  eos_id=-2) for i, (p, m) in
                       enumerate(specs)])
    tout = teng.serve([Request(rid=i, prompt=p, max_new_tokens=m, eos_id=-2)
                       for i, (p, m) in enumerate(specs)])
    return teng, jout, tout


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_tokens_match_reference(varied, kv_dtype):
    """Prompts of 64 tokens (two chunks), a wave padded with a dummy row."""
    vocab = varied.tcfg.vocab_size
    specs = [(prompts(200 + i, 1, 64, vocab)[0], 8) for i in range(3)]
    teng, jout, tout = _serve_both(varied, specs, kv_dtype=kv_dtype)
    for rid in jout:
        assert len(tout[rid]) == 8
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
        assert teng.results[rid].state is RequestState.FINISHED
    assert len({int(t) for v in tout.values() for t in v}) > 3


def test_ragged_prompt_is_served_with_the_dividing_chunk_tokens(varied):
    """A 40-token prompt at chunk 32 (the reference asserts and kills the
    serve there); its tokens equal the reference's at chunk 8."""
    vocab = varied.tcfg.vocab_size
    specs = [(prompts(300 + i, 1, 40, vocab)[0], 6) for i in range(2)]
    with pytest.raises(AssertionError):
        JaxServingEngine(varied.jmodel, varied.jparams, max_len=MAX_LEN,
                         batch_size=2).serve(
            [JaxRequest(rid=0, prompt=specs[0][0], max_new_tokens=2)])
    jcfg = dataclasses.replace(
        varied.jcfg, ssm=dataclasses.replace(varied.jcfg.ssm, chunk=8))
    teng, jout, tout = _serve_both(varied, specs, jcfg=jcfg)
    for rid in jout:
        assert teng.results[rid].state is RequestState.FINISHED
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))


def test_seeded_init_and_param_count():
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    a = model.init(seed=3, device="cpu")
    b = model.init(seed=3, device="cpu")
    n = a["embed"].numel() + a["final_norm"].numel() + sum(
        t.numel() for layer in a["layers"] for blk in layer.values()
        for t in blk.values())
    assert n == cfg.param_count()
    blk = a["layers"][1]["ssd"]
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert torch.equal(blk["w_in"], b["layers"][1]["ssd"]["w_in"])
    assert not torch.equal(blk["w_in"], a["layers"][0]["ssd"]["w_in"])
    assert not blk["norm"].any() and not blk["gate_norm"].any()
    assert torch.allclose(blk["a_log"],
                          torch.log(torch.linspace(1.0, 16.0, nh)))
    assert torch.equal(blk["d_skip"], torch.ones(nh))
    assert cfg.layer_kinds == ("ssd",) * cfg.num_layers


def test_full_width_config_matches_reference():
    mine, ref = get_arch(ARCH), jax_get_arch(ARCH)
    for field in ("num_layers", "d_model", "vocab_size", "norm_eps",
                  "family", "layer_kinds"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
    assert mine.attn_impl == "kernel"
    # the reference's count leaves out each layer's gate norm, a_log and
    # the conv weights of its B/C channels
    s = mine.ssm
    di = s.expand * mine.d_model
    missing = mine.num_layers * (di + di // s.head_dim
                                 + s.conv_width * 2 * s.n_groups * s.d_state)
    assert mine.param_count() == ref.param_count() + missing
    assert 128e6 < mine.param_count() < 130e6
