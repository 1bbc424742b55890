"""The port's int8 KV caches against the JAX package's.

* ``quantize_q8`` / ``dequantize_q8`` give the reference's int8 values
  and scales exactly, all-zero groups included.
* The plain versions of the int8 branches of B4 (dense decode), B5
  (paged prefill) and B6 (paged decode) match the Pallas kernels in
  interpret mode, and the ``plain`` attention twins match the
  reference's XLA twins, at atol 3e-5 in fp32.
* ``_paged_append_requant`` leaves pools and scales equal to the
  reference's page by page, on reused pages that hold stale bytes.
* The int8 wave engine and the int8 continuous engine emit the JAX
  engines' tokens, token for token, at fp32.

Inputs are drawn with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving import ContinuousBatchingEngine as JaxContinuous
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
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
    span,
)

HKV, E, N_PAGES = 2, 16, 24


def _q8_both(x: np.ndarray, dims):
    """(values, scales) from both packages, as numpy."""
    jv, js = jcommon.quantize_q8(jnp.asarray(x), dims)
    tv, ts = tcommon.quantize_q8(torch.from_numpy(x), dims)
    return (np.asarray(jv), np.asarray(js)), (tv.numpy(), ts.numpy())


@pytest.mark.parametrize("dims", [-1, (-2, -1), (1, 3)])
def test_quantize_q8_is_the_reference_exactly(dims):
    x = rand(0, (3, 4, 5, 16), scale=3.0)
    x[1, 2] = 0.0                 # all-zero groups: scale 0, values 0
    x[:, :, 3] = 0.0
    x[0, 0, 0, 0] = 127.5 * np.abs(x[0, 0]).max() / 127.0   # a .5 tie
    (jv, js), (tv, ts) = _q8_both(x, dims)
    assert tv.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)
    assert (ts == 0).any()
    back = tcommon.dequantize_q8(torch.from_numpy(tv), torch.from_numpy(ts),
                                 dims).numpy()
    want = np.asarray(jcommon.dequantize_q8(jnp.asarray(jv), jnp.asarray(js),
                                            dims))
    np.testing.assert_array_equal(back, want)
    np.testing.assert_allclose(back, x, atol=float(np.abs(x).max()) / 127)


def _int8_pools(seed: int, page: int):
    """Random pools quantized per page, identically for both packages:
    (k, v, k_scales, v_scales) as numpy."""
    out = []
    for i in range(2):
        (v, s), _ = _q8_both(rand(seed + i, (HKV, N_PAGES, page, E), 2.0),
                             (-2, -1))
        out.append((v, s))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _jt(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("kv_len", [1, 37, 64, 130])
def test_int8_dense_decode_matches_pallas(group, kv_len):
    b, s_len = 2, 192
    q = rand(1, (b, HKV * group, E))
    kq, ks = [], []
    for i in range(2):
        (v, sc), _ = _q8_both(rand(10 + i, (b, HKV, s_len, E), 2.0), -1)
        kq.append(v)
        ks.append(sc)
    (jq, jk, jv, jks, jvs), (tq, tk, tv, tks, tvs) = _jt(q, *kq, *ks)
    want = jops.decode_attention(jq, jk, jv, kv_len, k_scale=jks,
                                 v_scale=jvs, interpret=True)
    got = tops.decode_attention(tq, tk, tv, kv_len, k_scale=tks, v_scale=tvs)
    assert_close(got, want, FP32_ATOL)
    # the plain version at the split a bf16 query takes (the tensor-core
    # form's), in fp32
    bh, s_len = b * HKV, tk.shape[2]
    n_split, tps = tdec.decode_split_plan(torch.bfloat16, bh, s_len)
    short = tdec.decode_attention_plain(
        tq.reshape(bh, group, E), tk.reshape(bh, s_len, E),
        tv.reshape(bh, s_len, E), torch.full((bh,), kv_len),
        n_split=n_split, tiles_per_split=tps,
        k_scale=tks.reshape(bh, s_len), v_scale=tvs.reshape(bh, s_len))
    assert_close(short.reshape(got.shape), want, FP32_ATOL)
    # the plain twin: the reference's XLA twin of the int8 branch
    twin = jattn.decode_attention(jq, jk, jv, kv_len, impl="xla",
                                  k_scale=jks, v_scale=jvs)
    plain = tattn.decode_attention(tq, tk, tv, kv_len, impl="plain",
                                   k_scale=tks, v_scale=tvs)
    assert_close(plain, twin, FP32_ATOL)
    # a ragged batch through the kernel's plain version, row by row
    lens = torch.tensor([kv_len, max(1, kv_len // 3)], dtype=torch.int32)
    ragged = tops.decode_attention(tq, tk, tv, lens, k_scale=tks,
                                   v_scale=tvs)
    for i in range(b):
        one = tattn.decode_attention(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                                     int(lens[i]), impl="plain",
                                     k_scale=tks[i:i + 1],
                                     v_scale=tvs[i:i + 1])
        assert_close(ragged[i:i + 1], one, FP32_ATOL)


def _table(seed: int, batch: int, max_pages: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    return perm[:batch * max_pages].reshape(batch, max_pages)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("page", [4, 8])
def test_int8_paged_decode_matches_pallas(group, page):
    k, v, ks, vs = _int8_pools(20, page)
    table = _table(21, 3, 6)
    lens = np.array([0, 9, 6 * page - 1], np.int32)
    q = rand(22, (3, HKV * group, E))
    (jq, jk, jv, jks, jvs, jt, jl), (tq, tk, tv, tks, tvs, tt, tl) = _jt(
        q, k, v, ks, vs, table, lens)
    want = jops.paged_decode_attention(jq, jk, jv, jt, jl, k_scales=jks,
                                       v_scales=jvs, interpret=True)
    got = tops.paged_decode_attention(tq, tk, tv, tt, tl, k_scales=tks,
                                      v_scales=tvs)
    assert_close(got, want, FP32_ATOL)
    twin = jattn.paged_decode_attention(jq, jk, jv, jt, jl, impl="xla",
                                        k_scales=jks, v_scales=jvs)
    plain = tattn.paged_decode_attention(tq, tk, tv, tt, tl, impl="plain",
                                         k_scales=tks, v_scales=tvs)
    assert_close(plain[1:], twin[1:], FP32_ATOL)   # kv_len 0 is garbage
    assert float(got[0].abs().max()) == 0.0          # the kernel gives 0


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("q0,kv_len,chunk", [(0, 8, 8), (8, 21, 16),
                                             (12, 13, 4), (0, 0, 8)])
def test_int8_paged_prefill_matches_pallas(group, q0, kv_len, chunk):
    k, v, ks, vs = _int8_pools(30, 4)
    table = _table(31, 1, 8)[0]
    q = rand(32, (HKV * group, chunk, E))
    (jq, jk, jv, jks, jvs, jt), (tq, tk, tv, tks, tvs, tt) = _jt(
        q, k, v, ks, vs, table)
    want = jops.paged_prefill_attention(
        jq, jk, jv, jt, jnp.int32(q0), jnp.int32(kv_len), k_scales=jks,
        v_scales=jvs, interpret=True)
    got = tops.paged_prefill_attention(tq, tk, tv, tt, span(q0, kv_len),
                                       k_scales=tks, v_scales=tvs)
    live = max(0, kv_len - q0)
    assert_close(got[:, :live], want[:, :live], FP32_ATOL)
    twin = jattn.paged_prefill_attention(
        jq, jk, jv, jt, jnp.int32(q0), jnp.int32(kv_len), impl="xla",
        k_scales=jks, v_scales=jvs)
    plain = tattn.paged_prefill_attention(tq, tk, tv, tt, span(q0, kv_len),
                                          impl="plain", k_scales=tks,
                                          v_scales=tvs)
    assert_close(plain[:, :live], twin[:, :live], FP32_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_paged_append_requant_matches_reference_on_stale_pages(seed):
    """Reused pages keep stale bytes past each sequence's slot; the
    requant must leave them out of both the absmax and the rewrite, and a
    page whose scale did not change must keep its int8 values."""
    rng = np.random.default_rng(seed)
    page = 4
    k, _, ks, _ = _int8_pools(40 + seed, page)
    ids = rng.permutation(np.arange(1, N_PAGES))[:3].astype(np.int32)
    slots = np.array([0, 2, 3], np.int32)
    row = rand(50 + seed, (HKV, 3, E), 0.5)
    row[:, 1] *= 100.0          # this row grows its page's scale
    (jk, jks, jids, jslots, jrow), (tk, tks, tids, tslots, trow) = _jt(
        k.copy(), ks.copy(), ids, slots, row)
    wk, wks = jtfm._paged_append_requant(jk, jks, jids, jslots, jrow)
    ttfm._paged_append_requant(tk, tks, tids, tslots, trow)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(wks))
    # slot 1's page: the big row grew its scale
    assert bool((tks[:, ids[1]] > torch.from_numpy(ks[:, ids[1]])).all())
    # where a page's scale came out unchanged, its old live rows keep
    # their int8 values exactly
    same = 0
    for h in range(HKV):
        for page, slot in zip(ids, slots):
            if float(tks[h, page]) == float(ks[h, page]):
                np.testing.assert_array_equal(tk[h, page, :slot].numpy(),
                                              k[h, page, :slot])
                same += 1
    assert same > 0


# ---------------------------------------------------------------------------
# the model and the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=3, jax_impl="xla_full",
                      norm_std=2.0)


def test_int8_dense_prefill_and_decode_match_reference(pair):
    toks = prompts(5, 2, 9, pair.tcfg.vocab_size)
    jl, jc = pair.jmodel.prefill(pair.jparams, pair.jcfg, jnp.asarray(toks),
                                 16, kv_dtype=jnp.int8)
    tl, tc = pair.tmodel.prefill(pair.tparams, pair.tcfg,
                                 torch.from_numpy(toks).long(), 16,
                                 kv_dtype="int8")
    assert_close(tl, jl, LOGITS_ATOL)
    blk = tc["layers"][0]
    assert blk["k"].dtype == torch.int8 and blk["k_scale"].shape == (
        2, pair.tcfg.num_kv_heads, 16)
    for layer, tblk in enumerate(tc["layers"]):
        for which in ("k", "v"):
            want = np.asarray(jcommon.dequantize_q8(
                jc["units"]["b0"][which][layer],
                jc["units"]["b0"][f"{which}_scale"][layer], -1))
            got = tcommon.dequantize_q8(tblk[which], tblk[f"{which}_scale"],
                                        -1)
            # one int8 step where the projections round apart
            np.testing.assert_allclose(
                got.numpy(), want,
                atol=float(tblk[f"{which}_scale"].max()) + 1e-6)
    token = np.argmax(as_numpy(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for pos in range(9, 12):
        jl, jc = pair.jmodel.decode_step(pair.jparams, pair.jcfg,
                                         jnp.asarray(token), jc,
                                         jnp.int32(pos))
        tl, tc = pair.tmodel.decode_step(pair.tparams, pair.tcfg,
                                         torch.from_numpy(token).long(), tc,
                                         pos)
        assert_close(tl, jl, LOGITS_ATOL)
        token = np.argmax(as_numpy(jl)[:, -1], axis=-1).astype(np.int32)[
            :, None]


def _requests(cls, vocab, spec):
    return [cls(rid=i, prompt=prompts(60 + i, 1, n, vocab)[0],
                max_new_tokens=m, eos_id=-2)
            for i, (n, m) in enumerate(spec)]


def test_int8_wave_engine_matches_reference_tokens(pair):
    spec = [(6, 7), (6, 5), (6, 9), (11, 6)]
    vocab = pair.tcfg.vocab_size
    want = JaxServingEngine(pair.jmodel, pair.jparams, max_len=24,
                            batch_size=2, kv_dtype="int8").serve(
        _requests(JaxRequest, vocab, spec))
    eng = ServingEngine(pair.tmodel, pair.tparams, max_len=24, batch_size=2,
                        kv_dtype="int8", device="cpu")
    got = eng.serve(_requests(Request, vocab, spec))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    assert len({t for v in got.values() for t in v.tolist()}) > 5
    with pytest.raises(ValueError):
        ServingEngine(pair.tmodel, pair.tparams, kv_dtype="fp8",
                      device="cpu")


def test_int8_continuous_engine_matches_reference_tokens(pair):
    spec = [(5, 4), (9, 6), (13, 3), (21, 5), (30, 6)]
    vocab = pair.tcfg.vocab_size
    kw = dict(max_len=40, batch_size=2, page_size=4, chunk_size=8,
              kv_dtype="int8")
    want = JaxContinuous(pair.jmodel, pair.jparams, **kw).serve(
        _requests(JaxRequest, vocab, spec))
    eng = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                   **kw)
    eng.auditor = PoolAuditor()
    got = eng.serve(_requests(Request, vocab, spec))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    assert eng._mgr.pages_used == 0
    # an int8 page pins half the bytes of a bf16 one, plus two fp32 scales
    cfg = pair.tcfg
    assert eng.kv_bytes_per_page() == cfg.num_layers * (
        2 * cfg.num_kv_heads * 4 * cfg.hd + 2 * cfg.num_kv_heads * 4)
