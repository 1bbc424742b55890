"""The port's speculative-verify pieces against the JAX package's.

* B7's plain version (``paged_verify_attention_plain``, through
  ``ops.paged_verify_attention``) against the Pallas kernel in interpret
  mode, fp32 and int8 pools: ragged candidate rows (0, 1, k), a start
  that straddles a page, kv_len 0, GQA groups 1, 2 and 4, depths 1-4, a
  hypothesis sweep; k = 1 equals B6. Rows of a slot that verifies no row
  at all are compared with the reference's XLA twin, whose mask is exact
  (the Pallas kernel leaves one column of such a slot unmasked when
  ``q_start + 1`` ends a page); atol 3e-5.
* ``NgramDrafter`` proposes the reference's drafts on random and
  repetitive contexts.
* ``ensure_capacity`` / ``append_n`` driven op by op beside the
  reference's manager.
* ``_paged_append_n`` leaves pools and scales equal to the reference's
  page by page on reused pages holding stale bytes, fp32 and int8.
* ``paged_verify_step`` gives the reference's logits (fp32, atol 1e-4)
  and pools, fp32 and int8.
* ``tune_spec_depth`` grows with the acceptance rate.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving import NgramDrafter as JaxDrafter
from repro.serving import PagedKVCacheManager as JaxManager
from repro_torch.core.autotune import tune_spec_depth
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import paged_verify_attention as tpver
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving import NgramDrafter, PagedKVCacheManager
from test_torch_harness import (
    FP32_ATOL,
    LOGITS_ATOL,
    as_numpy,
    assert_close,
    chunk_span,
    model_pair,
    prompts,
    rand,
)

HKV, E, N_PAGES = 2, 16, 40


def _pools(seed: int, page: int, quantized: bool):
    """(k, v, k_scales, v_scales) as numpy; scales None for fp32 pools.
    int8 pools are quantized per page by the reference's helper."""
    k = rand(seed, (HKV, N_PAGES, page, E), 2.0)
    v = rand(seed + 1, (HKV, N_PAGES, page, E), 2.0)
    if not quantized:
        return k, v, None, None
    from repro.kernels.common import quantize_q8

    (kq, ks), (vq, vs) = (quantize_q8(jnp.asarray(x), (-2, -1))
                          for x in (k, v))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


def _both(*arrays):
    """Each array for JAX and for torch (None stays None)."""
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    t = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
         for a in arrays]
    return j, t


def _verify_both(q, k, v, ks, vs, table, lens, starts):
    (jq, jk, jv, jks, jvs, jt, jl, js), (tq, tk, tv, tks, tvs, tt, tl,
                                         ts) = _both(q, k, v, ks, vs, table,
                                                     lens, starts)
    pallas = jops.paged_verify_attention(jq, jk, jv, jt, jl, js,
                                         k_scales=jks, v_scales=jvs,
                                         interpret=True)
    twin = jattn.paged_verify_attention(jq, jk, jv, jt, jl, js, impl="xla",
                                        k_scales=jks, v_scales=jvs)
    got = tops.paged_verify_attention(tq, tk, tv, tt, tl, ts, k_scales=tks,
                                      v_scales=tvs)
    plain = tattn.paged_verify_attention(tq, tk, tv, tt, tl, ts,
                                         impl="plain", k_scales=tks,
                                         v_scales=tvs)
    return as_numpy(got), as_numpy(pallas), as_numpy(twin), as_numpy(plain)


def _check_verify(q, k, v, ks, vs, table, starts, n_rows):
    lens = (starts + n_rows).astype(np.int32)
    got, pallas, twin, plain = _verify_both(q, k, v, ks, vs, table, lens,
                                            starts)
    live = n_rows > 0
    np.testing.assert_allclose(got[live], pallas[live], atol=FP32_ATOL,
                               rtol=0)
    # the kernel's plain version at the split a bf16 query takes (the
    # tensor-core form's), in fp32
    b, spec, hq, e = q.shape
    n_split, tps = tdec.decode_split_plan(torch.bfloat16, b * HKV,
                                          table.shape[1] * k.shape[2])
    qg = q.reshape(b, spec, HKV, hq // HKV, e).transpose(0, 2, 1, 3, 4)
    tq, tk, tv, tks, tvs, tt, tl, ts = _both(
        qg.reshape(b, HKV, spec * hq // HKV, e), k, v, ks, vs, table, lens,
        starts)[1]
    short = tpver.paged_verify_attention_plain(
        tq, tk, tv, tt, tl, ts, spec=spec, n_split=n_split,
        tiles_per_split=tps, k_scales=tks, v_scales=tvs)
    short = as_numpy(short.reshape(b, HKV, spec, hq // HKV, e)
                     .permute(0, 2, 1, 3, 4).reshape(q.shape))
    np.testing.assert_allclose(short[live], pallas[live], atol=FP32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[~live & (lens > 0)],
                               twin[~live & (lens > 0)], atol=FP32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(plain, twin, atol=FP32_ATOL, rtol=0)
    assert not got[lens == 0].any()        # kv_len 0 gives zeros
    return got


def _table(seed: int, batch: int, max_pages: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    return perm[:batch * max_pages].reshape(batch, max_pages)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("spec", [1, 2, 3, 4])
def test_verify_matches_pallas(quantized, group, spec):
    page = 4
    k, v, ks, vs = _pools(spec + 10 * group, page, quantized)
    table = _table(group, 5, 7)
    # a full block mid-page, one row, none (kv_len 0), a block straddling
    # a page from q_start 6, and a block ending at the table's capacity
    starts = np.array([5, 11, 0, 6, 28 - spec], np.int32)
    n_rows = np.array([spec, 1, 0, spec, spec], np.int32)
    q = rand(spec, (5, spec, HKV * group, E))
    got = _check_verify(q, k, v, ks, vs, table, starts, n_rows)
    if spec == 1:
        # one position is B6 exactly
        (_, _, _, _, _, _), (tq, tk, tv, tks, tvs, tt) = _both(
            q, k, v, ks, vs, table)
        lens = torch.from_numpy(starts + n_rows)
        dec = tops.paged_decode_attention(tq[:, 0], tk, tv, tt, lens,
                                          k_scales=tks, v_scales=tvs)
        np.testing.assert_array_equal(got[:, 0], as_numpy(dec))


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 16), spec=st.integers(1, 4),
       group=st.sampled_from([1, 2]), page=st.sampled_from([4, 8]),
       quantized=st.booleans())
def test_verify_hypothesis_sweep(seed, spec, group, page, quantized):
    rng = np.random.default_rng(seed)
    b, max_pages = 3, 4
    k, v, ks, vs = _pools(seed % 97, page, quantized)
    table = _table(seed, b, max_pages)
    cap = max_pages * page
    n_rows = rng.integers(0, spec + 1, size=b).astype(np.int32)
    starts = np.array([rng.integers(0, cap - spec + 1) for _ in range(b)],
                      np.int32)
    q = rand(seed, (b, spec, HKV * group, E))
    _check_verify(q, k, v, ks, vs, table, starts, n_rows)


def test_ngram_drafter_matches_reference():
    rng = np.random.default_rng(0)
    mine, ref = NgramDrafter(ngram=3), JaxDrafter(ngram=3)
    cycle = rng.integers(3, 50, size=5)
    contexts = [np.tile(cycle, 4)[:17], rng.integers(3, 9, size=40),
                rng.integers(3, 1000, size=30), np.array([7]),
                np.array([4, 4]), np.array([1, 2, 3, 1, 2])]
    drafts = 0
    for ctx in contexts:
        for k in (0, 1, 3, 6):
            got = mine.draft(ctx, k)
            assert got == ref.draft(ctx, k), (ctx, k)
            assert len(got) <= k
            drafts += len(got)
    assert drafts > 0
    assert mine.draft(np.tile(cycle, 3), 4) == list(np.tile(cycle, 2)[:4])
    with pytest.raises(ValueError):
        NgramDrafter(ngram=0)


def _manager_op(mgr, op):
    kind, slot, n = op
    try:
        if kind == "admit":
            mgr.admit(slot, n, reserve=1)
        elif kind == "ensure":
            mgr.ensure_capacity(slot, n)
        elif kind == "append_n":
            mgr.append_n(slot, n)
        else:
            mgr.release(slot)
    except Exception as exc:  # noqa: BLE001 - compared by type below
        return type(exc).__name__
    return None


@pytest.mark.parametrize("seed", range(4))
def test_capacity_and_append_n_match_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(num_slots=3, max_pages_per_seq=5)
    jm, tm = JaxManager(11, 4, **kw), PagedKVCacheManager(11, 4, **kw)
    errors = set()
    for i in range(80):
        kind = ("admit", "ensure", "ensure", "append_n", "append_n",
                "release")[rng.integers(6)]
        op = (kind, int(rng.integers(3)), int(rng.integers(0, 9)))
        got, want = _manager_op(tm, op), _manager_op(jm, op)
        assert got == want, (i, op)
        errors.add(got)
        np.testing.assert_array_equal(tm.table(), jm.table())
        np.testing.assert_array_equal(tm.kv_lens(), jm.kv_lens())
        assert tm.free_pages() == jm.free_pages(), (i, op)
    assert "PagePoolExhausted" in errors
    # all or nothing: a failed reservation leaves the sequence as it was
    tm = PagedKVCacheManager(4, 4, num_slots=1, max_pages_per_seq=8)
    tm.admit(0, 5)
    before = (tm.table().copy(), tm.free_pages())
    with pytest.raises(Exception, match="need 3 pages"):
        tm.ensure_capacity(0, 12)
    with pytest.raises(Exception, match="need 3 pages"):
        tm.append_n(0, 12)
    assert (tm.table() == before[0]).all() and tm.free_pages() == before[1]
    tm.ensure_capacity(0, 3)          # grows into one page, length kept
    assert tm.kv_lens()[0] == 5 and len(tm.seq_pages(0)) == 2
    tm.append_n(0, 3)                 # alloc-free commit
    assert tm.kv_lens()[0] == 8 and tm.available == 1


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("spec", [2, 4, 6])
def test_paged_append_n_matches_reference_on_stale_pages(quantized, spec):
    page = 4
    k, _, ks, _ = _pools(70 + spec, page, quantized)
    table = _table(71, 4, 6)
    # starts mid-page and on a boundary; a window crossing one or two
    # pages; an idle slot; surplus candidates past n_valid
    positions = np.array([5, 8, 0, 14], np.int32)
    n_valid = np.array([spec, spec - 1, 0, 1], np.int32)
    rows = rand(72, (HKV, 4, spec, E), 3.0)
    (jk, jks, jt, jp, jr, jn), (tk, tks, tt, tp, tr, tn) = _both(
        k.copy(), None if ks is None else ks.copy(), table, positions, rows,
        n_valid)
    wk, wks = jtfm._paged_append_n(jk, jks, jt, jp, jr, jn, spec=spec)
    ttfm._paged_append_n(tk, tks, tt, tp, tr, tn, spec=spec)
    wk = np.asarray(wk)
    touched = 0
    for page_id in range(1, N_PAGES):    # scratch page 0 aside
        np.testing.assert_array_equal(tk[:, page_id].numpy(), wk[:, page_id],
                                      err_msg=f"page {page_id}")
        if quantized:
            np.testing.assert_array_equal(tks[:, page_id].numpy(),
                                          np.asarray(wks)[:, page_id])
        touched += not np.array_equal(wk[:, page_id], k[:, page_id])
    assert touched >= 3


# ---------------------------------------------------------------------------
# the model's verify step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return model_pair("internlm2-1.8b", seed=4, norm_std=2.0)


@pytest.fixture(scope="module", params=["phi4-mini-3.8b", "deepseek-coder-33b",
                                        "deepseek-moe-16b",
                                        "moonshot-v1-16b-a3b"])
def arch_pair(request):
    return model_pair(request.param, seed=4, norm_std=2.0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_verify_step_matches_reference(pair, kv_dtype):
    _verify_step_parity(pair, kv_dtype, int8_atol=LOGITS_ATOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_verify_step_matches_reference_at_other_archs(arch_pair,
                                                            kv_dtype):
    """GQA groups 3 and 7, untied embeddings and the MoE FFN. On int8
    pools an fp32 difference of ~1e-7 between the packages can round one
    K or V element to the neighbouring int8 step (deepseek-moe-smoke: one
    key in layer 1 at the second step), which moves that row's logits by
    ~2e-4: the pools are held within one step, the logits within 1e-3."""
    _verify_step_parity(arch_pair, kv_dtype, int8_atol=1e-3)


def _verify_step_parity(pair, kv_dtype, int8_atol):
    """Prefill two prompts into shuffled pages, then two verify steps of
    depth 3 with ragged rows (3, 1 and an idle slot), on both packages;
    logits (fp32 pools: atol 3e-5; int8: ``int8_atol``) and then the pools
    must agree."""
    atol = FP32_ATOL if kv_dtype is None else int8_atol
    page, n_pages, mp, spec = 4, 20, 6, 3
    vocab = pair.tcfg.vocab_size
    kw = dict(cache_layout="paged", page_size=page, num_pages=n_pages)
    jdt = None if kv_dtype is None else jnp.int8
    jc = pair.jmodel.make_cache(1, mp * page, kv_dtype=jdt, **kw)
    tc = pair.tmodel.make_cache(1, mp * page, device="cpu", kv_dtype=kv_dtype,
                                **kw)
    perm = np.random.default_rng(5).permutation(
        np.arange(1, n_pages)).astype(np.int32)
    table = np.zeros((3, mp), np.int32)
    table[0], table[1, :4] = perm[:mp], perm[mp:mp + 4]
    lens = {0: 7, 1: 4}
    for slot, n in lens.items():
        toks = np.ones((1, 8), np.int32)
        toks[0, :n] = prompts(30 + slot, 1, n, vocab)[0]
        cpages = table[slot, :2]
        jl, jc = pair.jmodel.prefill_chunk(
            pair.jparams, pair.jcfg, jnp.asarray(toks), jc,
            jnp.asarray(table[slot]), jnp.asarray(cpages), jnp.int32(0),
            jnp.int32(n))
        tl, tc = pair.tmodel.prefill_chunk(
            pair.tparams, pair.tcfg, torch.from_numpy(toks), tc,
            torch.from_numpy(table[slot]), torch.from_numpy(cpages),
            chunk_span(0, n))
        assert_close(tl, jl, atol)
    positions = np.array([7, 4, 0], np.int32)
    for step, n_rows in enumerate(([3, 1, 0], [2, 3, 0])):
        n_rows = np.array(n_rows, np.int32)
        toks = prompts(40 + step, 3, spec, vocab)
        jl, jc = pair.jmodel.paged_verify_step(
            pair.jparams, pair.jcfg, jnp.asarray(toks), jc,
            jnp.asarray(table), jnp.asarray(positions), jnp.asarray(n_rows))
        tl, tc = pair.tmodel.paged_verify_step(
            pair.tparams, pair.tcfg, torch.from_numpy(toks).long(), tc,
            torch.from_numpy(table), torch.from_numpy(positions),
            torch.from_numpy(n_rows))
        assert tl.shape == tuple(jl.shape)
        for b in range(2):             # the rows each slot verified
            np.testing.assert_allclose(
                as_numpy(tl)[b, :n_rows[b]], as_numpy(jl)[b, :n_rows[b]],
                atol=atol, rtol=0)
        positions = positions + n_rows
    for layer, tblk in enumerate(tc["layers"]):
        jblk = {key: np.asarray(val[layer])
                for key, val in jc["units"]["b0"].items()}
        for which in ("k", "v"):
            got, want = tblk[which], jblk[which]
            if kv_dtype is not None:
                got = tcommon.dequantize_q8(got, tblk[f"{which}_scale"],
                                            (-2, -1)).numpy()
                want = np.asarray(want, np.float32) * jblk[
                    f"{which}_scale"][:, :, None, None]
                atol = float(tblk[f"{which}_scale"].max()) + 1e-6
            else:
                got, atol = got.numpy(), FP32_ATOL
            for page_id in range(1, n_pages):
                np.testing.assert_allclose(
                    got[:, page_id], want[:, page_id], atol=atol, rtol=0,
                    err_msg=f"layer {layer} {which} page {page_id}")


def test_tune_spec_depth_grows_with_acceptance():
    kw = dict(b_h=16, n_ctx=4096, e=128, page=16)
    for kv_itemsize in (None, 1):
        depths = [tune_spec_depth(**kw, kv_itemsize=kv_itemsize,
                                  accept_rate=p)
                  for p in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0)]
        assert depths == sorted(depths)
        assert depths[0] == 1 and depths[-1] == 8
    assert tune_spec_depth(**kw, max_depth=3) == 3
