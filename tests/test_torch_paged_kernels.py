"""The port's paged attention kernels (B5, B6) against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernels in interpret mode and, separately, its
XLA twins in ``models/attention.py``. Same inputs, made from a seed with
numpy: shuffled page tables, dead pages holding large finite garbage that
only masking keeps out, ragged ``kv_lens`` including 0, a ``q_offset``
mid-prompt and ragged last chunks, GQA groups 1 and 2. Tolerance atol
3e-5 in fp32 (sums in another order). ``three_band_select`` must equal
the reference's helper exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as tpdec
from repro_torch.kernels import paged_prefill_attention as tppre
from repro_torch.kernels import paged_verify_attention as tpver
from repro_torch.models import attention as tattn
from test_torch_harness import (
    FP32_ATOL,
    assert_close,
    rand,
    span,
    to_jax,
    to_torch,
)

HKV, E = 2, 16
N_PAGES = 24


def _pools(seed: int, page: int):
    """K/V pools whose every page is random; pages no sequence owns get
    garbage 100x larger, so a dead page that leaks into a sum shows."""
    k = rand(seed, (HKV, N_PAGES, page, E))
    v = rand(seed + 1, (HKV, N_PAGES, page, E))
    return k, v


def _tables(seed: int, batch: int, max_pages: int, lens, page: int):
    """Shuffled distinct pages for the live span of each sequence; the
    entries past it point at other, garbage-filled pages."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, N_PAGES))
    table = np.zeros((batch, max_pages), np.int32)
    used = 0
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, :live] = perm[used:used + live]
        used += live
    dead = perm[used:]
    for b, n in enumerate(lens):
        live = -(-n // page)
        table[b, live:] = np.resize(dead if len(dead) else [0],
                                    max_pages - live)
    return table, dead


def _spoil(pools, pages):
    for pool in pools:
        pool[:, pages] *= 100.0


# ---------------------------------------------------------------------------
# three_band_select: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q0,col0,kv_len,rows_per_pos", [
    (0, 0, 8, 1), (3, 2, 6, 1), (5, 0, 20, 2), (16, 12, 19, 4),
    (7, 8, 7, 1), (0, 4, 0, 2),
])
def test_three_band_select_matches_reference(q0, col0, kv_len,
                                             rows_per_pos):
    s = rand(q0 + col0, (8, 8))
    want = np.asarray(jcommon.three_band_select(
        to_jax(s), jnp.int32(q0), jnp.int32(col0), jnp.int32(kv_len),
        rows_per_pos=rows_per_pos))
    got = tcommon.three_band_select(to_torch(s), q0, col0, kv_len,
                                    rows_per_pos=rows_per_pos).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_pages_follows_the_table():
    k, _ = _pools(0, 4)
    table = np.array([[3, 1], [2, 5]], np.int32)
    got = tcommon.gather_pages(to_torch(k), torch.from_numpy(table))
    assert got.shape == (2, HKV, 8, E)
    np.testing.assert_array_equal(got[1, :, 4:].numpy(), k[:, 5])
    one = tcommon.gather_pages(to_torch(k), torch.from_numpy(table[0]))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


# ---------------------------------------------------------------------------
# B6: paged decode
# ---------------------------------------------------------------------------

DECODE_CASES = [  # (group, page, max_pages, kv_lens)
    (2, 4, 6, [0, 1, 7, 24]),
    (1, 4, 6, [5, 16, 0, 3]),
    (2, 8, 3, [9, 24, 1, 17]),
    (2, 4, 20, [70, 1, 0, 2]),
]


@pytest.mark.parametrize("group,page,max_pages,lens", DECODE_CASES)
def test_paged_decode_matches_pallas_and_twin(group, page, max_pages, lens):
    seed = page * 31 + max_pages + group
    b = len(lens)
    k, v = _pools(seed, page)
    table, dead = _tables(seed, b, max_pages, lens, page)
    _spoil((k, v), dead)
    q = rand(seed + 2, (b, HKV * group, E))
    kv = np.asarray(lens, np.int32)
    want = jops.paged_decode_attention(
        to_jax(q), to_jax(k), to_jax(v), jnp.asarray(table), jnp.asarray(kv),
        interpret=True)
    got = tops.paged_decode_attention(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table),
        torch.from_numpy(kv))
    assert got.shape == tuple(want.shape)
    assert_close(got, want, FP32_ATOL)
    # the XLA twin has no l == 0 guard: a kv_len 0 row is the mean of its
    # gathered rows there, zeros in the kernels, so compare live rows only
    twin = jattn.paged_decode_attention(
        to_jax(q), to_jax(k), to_jax(v), jnp.asarray(table), jnp.asarray(kv),
        impl="xla")
    plain = tattn.paged_decode_attention(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table),
        torch.from_numpy(kv), impl="plain")
    assert_close(plain, twin, FP32_ATOL)
    live = kv > 0
    assert_close(got[torch.from_numpy(live)], np.asarray(twin)[live],
                 FP32_ATOL)
    if not live.all():
        assert float(got[torch.from_numpy(~live)].abs().max()) == 0.0


def test_paged_decode_split_covers_the_table_capacity():
    # 32 (b, kv head) rows over 80 pages of 16: the split of either form
    # is planned over the 1280 rows of the table without reading kv_lens
    for dtype in (torch.float32, torch.bfloat16):
        n_split, tps = tdec.decode_split_plan(dtype, 4 * 8, 80 * 16)
        assert n_split * tps * 64 >= 80 * 16 > (n_split - 1) * tps * 64
    # and the merge of three one-tile splits equals one three-tile split
    k, v = _pools(3, 8)
    table = np.random.default_rng(3).integers(1, N_PAGES, size=(2, 20),
                                              dtype=np.int32)
    q = rand(4, (2, HKV, 2, E))
    lens = torch.tensor([70, 150], dtype=torch.int32)
    args = (to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table),
            lens)
    whole = tpdec.paged_decode_attention_plain(*args, n_split=1,
                                               tiles_per_split=3)
    split = tpdec.paged_decode_attention_plain(*args, n_split=3,
                                               tiles_per_split=1)
    assert_close(split, whole, FP32_ATOL)
    want = tattn.paged_decode_attention(
        to_torch(q).reshape(2, HKV * 2, E), *args[1:],
        impl="plain").reshape(2, HKV, 2, E)
    assert_close(split, want, FP32_ATOL)


def test_paged_decode_plan_follows_the_form_q_picks():
    """The tensor-core forms of B4, B6 and B7 (a bf16 q, on bf16 and on
    int8 caches) take the short splits: at the continuous engine's shape
    (8 sequences x 8 kv heads over a 4096-row table) 16 splits of 4
    tiles. An fp32 q keeps split_plan (5 splits of 13). The plain version
    gives one answer under either plan, on bf16 and on int8 pools, and
    the CPU wrapper takes the form's plan."""
    assert tdec.decode_split_plan(torch.bfloat16, 64, 4096) == (16, 4)
    assert tdec.decode_split_plan(torch.float32, 64, 4096) == \
        tdec.split_plan(64, 4096) == (5, 13)
    assert tpdec.entry_point(torch.bfloat16, True) == \
        "paged_decode_int8_launch"
    # 32 sequences x 2 kv heads over 84 pages of 16: the plans differ,
    # (6, 4) against (5, 5)
    b, page, max_pages = 32, 16, 84
    rng = np.random.default_rng(20)
    k, v = (to_torch(rng.standard_normal((HKV, b * max_pages + 1, page, E),
                                         dtype=np.float32))
            for _ in range(2))
    table = torch.from_numpy(rng.permutation(b * max_pages).astype(np.int32)
                             .reshape(b, max_pages) + 1)
    lens = torch.from_numpy(rng.integers(0, max_pages * page + 1, size=b)
                            .astype(np.int32))
    q = to_torch(rand(22, (b, HKV, 2, E)))
    plans = [tdec.decode_split_plan(dtype, b * HKV, max_pages * page)
             for dtype in (torch.bfloat16, torch.float32)]
    assert plans == [(6, 4), (5, 5)]
    (k8, ks), (v8, vs) = (tcommon.quantize_q8(x, (-2, -1)) for x in (k, v))
    for kp, vp, sc in ((k, v, {}), (k8, v8, {"k_scales": ks,
                                              "v_scales": vs})):
        outs = [tpdec.paged_decode_attention_plain(
            q, kp, vp, table, lens, n_split=n, tiles_per_split=t, **sc)
            for n, t in plans]
        assert_close(outs[0], outs[1], 1e-5)
        qb = q.bfloat16()
        assert torch.equal(
            tpdec.paged_decode_attention_flat(qb, kp, vp, table, lens, **sc),
            tpdec.paged_decode_attention_plain(
                qb, kp, vp, table, lens, n_split=plans[0][0],
                tiles_per_split=plans[0][1], **sc))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["decode", "paged_decode", "verify"])
def test_int8_wrappers_plan_by_the_query_dtype(monkeypatch, kernel,
                                               q_dtype):
    """B4's, B6's and B7's wrappers on int8 caches split as the form q's
    dtype picks: ``decode_split_plan(torch.bfloat16, ...)``'s short
    splits for a bf16 q (the tensor-core forms), ``split_plan`` for an
    fp32 q (the CUDA-core ones). 32 (b, kv head) rows over 4096 rows:
    (16, 4) against (8, 8). The CPU wrapper hands its plan to the plain
    version, which this test watches."""
    b, page, max_pages, e = 16, 16, 256, 16
    rng = np.random.default_rng(30)
    taken = []

    def watch(module, name):
        plain = getattr(module, name)

        def spy(*args, **kw):
            taken.append((kw["n_split"], kw["tiles_per_split"]))
            return plain(*args, **kw)
        monkeypatch.setattr(module, name, spy)

    if kernel == "decode":
        (k, ks), (v, vs) = (tcommon.quantize_q8(to_torch(rng.standard_normal(
            (b * HKV, max_pages * page, e), dtype=np.float32)), -1)
            for _ in range(2))
        q = to_torch(rng.standard_normal((b * HKV, 2, e), dtype=np.float32))
        lens = torch.full((b * HKV,), 100, dtype=torch.int32)
        watch(tdec, "decode_attention_plain")
        out = tdec.decode_attention_flat(q.to(q_dtype), k, v, lens,
                                         k_scale=ks, v_scale=vs)
    else:
        (k, ks), (v, vs) = (tcommon.quantize_q8(to_torch(rng.standard_normal(
            (HKV, b * max_pages + 1, page, e), dtype=np.float32)), (-2, -1))
            for _ in range(2))
        table = torch.from_numpy(rng.permutation(b * max_pages).astype(
            np.int32).reshape(b, max_pages) + 1)
        lens = torch.full((b,), 100, dtype=torch.int32)
        sc = {"k_scales": ks, "v_scales": vs}
        if kernel == "paged_decode":
            q = to_torch(rng.standard_normal((b, HKV, 2, e), dtype=np.float32))
            watch(tpdec, "paged_decode_attention_plain")
            out = tpdec.paged_decode_attention_flat(q.to(q_dtype), k, v,
                                                    table, lens, **sc)
        else:
            q = to_torch(rng.standard_normal((b, HKV, 8, e), dtype=np.float32))
            watch(tpver, "paged_verify_attention_plain")
            out = tpver.paged_verify_attention_flat(
                q.to(q_dtype), k, v, table, lens, lens - 4, spec=4, **sc)
    want = (16, 4) if q_dtype == torch.bfloat16 else (8, 8)
    assert taken == [want]
    assert tdec.decode_split_plan(q_dtype, b * HKV, max_pages * page) == want
    assert out.dtype == q_dtype and bool(out.float().isfinite().all())


# ---------------------------------------------------------------------------
# B5: paged prefill
# ---------------------------------------------------------------------------

PREFILL_CASES = [  # (group, page, chunk, q_offset, kv_len)
    (2, 4, 8, 0, 8),       # first chunk, full
    (2, 4, 8, 8, 13),      # later chunk, ragged
    (1, 4, 8, 12, 20),     # mid-prompt, page-unaligned offset
    (2, 8, 16, 0, 5),      # a short prompt in one ragged chunk
    (2, 4, 16, 64, 80),    # past the first 64-row tile
    (1, 8, 8, 40, 41),     # one live row
    (2, 4, 8, 0, 0),       # nothing live
]


@pytest.mark.parametrize("group,page,chunk,q0,kv_len", PREFILL_CASES)
def test_paged_prefill_matches_pallas_and_twin(group, page, chunk, q0,
                                              kv_len):
    seed = page + chunk + q0 + kv_len + group
    max_pages = -(-(q0 + chunk) // page) + 1
    k, v = _pools(seed, page)
    table, dead = _tables(seed, 1, max_pages, [kv_len], page)
    _spoil((k, v), dead)
    q = rand(seed + 2, (HKV * group, chunk, E))
    want = jops.paged_prefill_attention(
        to_jax(q), to_jax(k), to_jax(v), jnp.asarray(table[0]),
        jnp.int32(q0), jnp.int32(kv_len), interpret=True)
    got = tops.paged_prefill_attention(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table[0]),
        span(q0, kv_len))
    assert got.shape == tuple(want.shape)
    # pad rows at or past kv_len too: both see every live key there
    assert_close(got, want, FP32_ATOL)
    if kv_len == 0:
        return  # the twin's softmax over nothing is not defined alike
    twin = jattn.paged_prefill_attention(
        to_jax(q), to_jax(k), to_jax(v), jnp.asarray(table[0]),
        jnp.int32(q0), jnp.int32(kv_len), impl="xla")
    plain = tattn.paged_prefill_attention(
        to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(table[0]),
        span(q0, kv_len), impl="plain")
    assert_close(plain, twin, FP32_ATOL)
    live = kv_len - q0
    assert_close(got[:, :live], np.asarray(twin)[:, :live], FP32_ATOL)


@pytest.mark.parametrize("group,page,chunk,q0,kv_len", [
    (2, 8, 100, 100, 180),   # 64 divides neither the chunk nor q_offset
    (1, 4, 64, 64, 122),     # one 64-row block, ending mid-page
    (2, 16, 40, 0, 40),      # a short first chunk padded to the block
])
def test_paged_prefill_plain_at_the_bf16_block_matches_pallas(
        group, page, chunk, q0, kv_len):
    """B5's plain version at the bf16 form's 64-row block (the rows padded
    to it, as ``ops`` pads them) against the Pallas kernel in interpret
    mode, on shuffled pages whose unused neighbours hold garbage."""
    seed = 100 + page + chunk + q0
    n_pages = 64
    rng = np.random.default_rng(seed)
    k = rand(seed, (HKV, n_pages, page, E))
    v = rand(seed + 1, (HKV, n_pages, page, E))
    max_pages = -(-(q0 + chunk) // page) + 1
    perm = rng.permutation(np.arange(1, n_pages))
    live = -(-kv_len // page)
    table = perm[:max_pages].astype(np.int32)
    for pool in (k, v):
        pool[:, perm[live:]] *= 100.0
    q = rand(seed + 2, (HKV * group, chunk, E))
    want = jops.paged_prefill_attention(
        to_jax(q), to_jax(k), to_jax(v), jnp.asarray(table), jnp.int32(q0),
        jnp.int32(kv_len), interpret=True)
    bq = tops.paged_prefill_blk_q(chunk, torch.bfloat16)
    assert bq == 64
    qp = torch.nn.functional.pad(to_torch(q), (0, 0, 0, (-chunk) % bq))
    got = tppre.paged_prefill_attention_plain(
        qp, to_torch(k), to_torch(v), torch.from_numpy(table),
        span(q0, kv_len), blk_q=bq)[:, :chunk]
    assert_close(got, want, FP32_ATOL)


def test_paged_prefill_block_height_follows_the_dtype():
    """bf16 chunks run the wgmma form's 64-row blocks, fp32 chunks the
    CUDA-core form's blocks of up to 32 rows (8 for a short chunk)."""
    for chunk in (1, 40, 512):
        assert tops.paged_prefill_blk_q(chunk, torch.bfloat16) == 64
    assert tops.paged_prefill_blk_q(512, torch.float32) == 32
    assert tops.paged_prefill_blk_q(5, torch.float32) == 8
    assert tops.paged_prefill_blk_q(20) == 24


def test_paged_prefill_plain_reads_live_tiles_only():
    # a table covering only the live rows suffices: dead tiles are never
    # gathered, as the kernel never loads them
    k, v = _pools(5, 4)
    q = to_torch(rand(6, (HKV, 8, E)))
    short = torch.tensor([3, 7, 1], dtype=torch.int32)      # 12 rows
    got = tppre.paged_prefill_attention_plain(
        q, to_torch(k), to_torch(v), short, span(4, 12), blk_q=8)
    assert tppre.live_tiles(12) == 1 and tppre.live_tiles(0) == 0
    want = tattn.paged_prefill_attention(q, to_torch(k), to_torch(v), short,
                                         span(4, 12), impl="plain")
    assert_close(got, want, FP32_ATOL)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def test_paged_int8_pools_give_attention_over_the_dequantized_pools():
    """With int8 pools and per-page scales, B5 and B6 give attention over
    the dequantized pools, and the wrappers refuse scales without int8
    pools or int8 pools without scales."""
    k, v = (to_torch(x) for x in _pools(0, 4))
    (kq, ks), (vq, vs) = (tcommon.quantize_q8(x, (-2, -1)) for x in (k, v))
    kd, vd = (tcommon.dequantize_q8(x, s, (-2, -1))
              for x, s in ((kq, ks), (vq, vs)))
    table = torch.tensor([[3, 7]], dtype=torch.int32)
    lens = torch.tensor([6], dtype=torch.int32)
    q = to_torch(rand(1, (1, HKV, E)))
    got = tops.paged_decode_attention(q, kq, vq, table, lens, k_scales=ks,
                                      v_scales=vs)
    assert_close(got, tops.paged_decode_attention(q, kd, vd, table, lens),
                 FP32_ATOL)
    qp = to_torch(rand(2, (HKV, 8, E)))
    got = tops.paged_prefill_attention(qp, kq, vq, table[0], span(2, 6),
                                       k_scales=ks, v_scales=vs)
    want = tops.paged_prefill_attention(qp, kd, vd, table[0], span(2, 6))
    assert_close(got[:, :4], want[:, :4], FP32_ATOL)
    with pytest.raises(ValueError, match="int8"):
        tpdec.check_scales(k, v, ks, vs, tuple(ks.shape))
    with pytest.raises(ValueError, match="scales"):
        tpdec.check_scales(kq, vq, None, None, tuple(ks.shape))


def test_paged_wrappers_refuse_other_devices_and_bad_shapes():
    k, v = (to_torch(x).to("meta") for x in _pools(0, 4))
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.paged_decode_attention(torch.zeros(1, HKV, E, device="meta"),
                                    k, v, table, lens)
    with pytest.raises(ValueError, match="device"):
        tops.paged_prefill_attention(torch.zeros(HKV, 8, E, device="meta"),
                                     k, v, table[0], span(0, 1, "meta"))
    kc, vc = (to_torch(x) for x in _pools(0, 4))
    with pytest.raises(ValueError, match="cover"):
        tops.paged_prefill_attention(torch.zeros(HKV, 8, E), kc, vc,
                                     torch.zeros(2, dtype=torch.int32),
                                     span(0, 9))
    with pytest.raises(ValueError, match="kv_lens"):
        tops.paged_decode_attention(torch.zeros(2, HKV, E), kc, vc,
                                    torch.zeros((2, 2), dtype=torch.int32),
                                    torch.ones(3, dtype=torch.int32))
