"""The port's attention kernels (B1-B4) against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernels in interpret mode. Same inputs, made
from a seed with numpy. Tolerances: atol 3e-5 in fp32, 3e-2 in bf16.
The mask helpers must match the reference's exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import policy
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mas_attention as tmas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_harness import (
    DTYPES,
    FP32_ATOL,
    assert_close,
    atol_for,
    rand,
    span,
    to_jax,
    to_torch,
)

# (b, hq, hkv, nq, nkv, e); the second is ragged (padded under kv_len)
SHAPES = [
    (1, 4, 2, 128, 128, 64),
    (2, 4, 2, 100, 100, 32),
    (1, 4, 4, 64, 192, 16),
]
METHODS = ["mas_resident", "mas_streamed", "flash"]


def _qkv(shape, seed):
    b, hq, hkv, nq, nkv, e = shape
    return (rand(seed, (b, hq, nq, e)), rand(seed + 1, (b, hkv, nkv, e)),
            rand(seed + 2, (b, hkv, nkv, e)))


# ---------------------------------------------------------------------------
# mask helpers: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blk_q,blk_kv,row0,col0", [
    (8, 16, 0, 0), (16, 8, 24, 16), (32, 64, 64, 96), (8, 8, 5, 0),
])
def test_causal_tile_mask_matches_reference(blk_q, blk_kv, row0, col0):
    want = np.asarray(jcommon.causal_tile_mask(blk_q, blk_kv, row0, col0))
    got = tcommon.causal_tile_mask(blk_q, blk_kv, row0, col0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("blk_q,blk_kv,nkv", [
    (8, 16, 4), (32, 64, 5), (64, 32, 9), (16, 16, 3),
])
def test_causal_tile_bounds_match_reference(blk_q, blk_kv, nkv):
    for iq in range(12):
        want = tuple(int(x) for x in
                     jcommon.causal_tile_bounds(iq, blk_q, blk_kv, nkv))
        assert tcommon.causal_tile_bounds(iq, blk_q, blk_kv, nkv) == want
        got = tcommon.causal_tile_bounds(torch.tensor(iq), blk_q, blk_kv, nkv)
        assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("col0,kv_len", [(0, 5), (16, 20), (32, 8), (8, 200)])
def test_mask_kv_tail_matches_reference(col0, kv_len):
    s = rand(0, (4, 16))
    want = np.asarray(jcommon.mask_kv_tail(to_jax(s), col0, kv_len))
    got = tcommon.mask_kv_tail(to_torch(s), col0, kv_len).numpy()
    np.testing.assert_array_equal(got, want)
    assert tcommon.NEG_INF == jcommon.NEG_INF == tref.NEG_INF


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,kv_len", [
    (False, None, None), (True, None, None), (True, 7, None),
    (False, None, 29),
])
def test_ref_attention_matches_reference(causal, window, kv_len):
    q, k, v = _qkv((2, 4, 2, 24, 40, 16), seed=3)
    want = jref.attention(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                          window=window, kv_len=kv_len)
    got = tref.attention(to_torch(q), to_torch(k), to_torch(v),
                         causal=causal, window=window, kv_len=kv_len)
    assert_close(got, want, FP32_ATOL)


def test_ref_decode_and_tiled_oracles_match_reference():
    q, k, v = _qkv((2, 4, 2, 32, 64, 16), seed=4)
    want = jref.decode_attention(to_jax(q[:, :, 0]), to_jax(k), to_jax(v), 37)
    got = tref.decode_attention(to_torch(q[:, :, 0]), to_torch(k),
                                to_torch(v), 37)
    assert_close(got, want, FP32_ATOL)
    for causal in (False, True):
        want = jref.mas_attention_tiled(to_jax(q), to_jax(k[:, :, :32]),
                                        to_jax(v[:, :, :32]), blk_q=8,
                                        blk_kv=16, causal=causal)
        got = tref.mas_attention_tiled(to_torch(q), to_torch(k[:, :, :32]),
                                       to_torch(v[:, :, :32]), blk_q=8,
                                       blk_kv=16, causal=causal)
        assert_close(got, want, FP32_ATOL)


# ---------------------------------------------------------------------------
# B1-B3 through ops.attention vs the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("method", METHODS)
def test_prefill_kernels_match_pallas(method, shape, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(shape, seed=sum(shape))
    want = jops.attention(to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt),
                          method=method, causal=causal, blk_q=32, blk_kv=128,
                          interpret=True)
    got = tops.attention(to_torch(q, tdt), to_torch(k, tdt),
                         to_torch(v, tdt), method=method, causal=causal)
    assert got.dtype == tdt and got.shape == tuple(want.shape)
    assert_close(got, want, atol_for(dtype))


@pytest.mark.parametrize("window", [5, 33, 80])
def test_flash_window_matches_pallas(window):
    q, k, v = _qkv((1, 4, 2, 90, 90, 32), seed=window)
    want = jops.attention(to_jax(q), to_jax(k), to_jax(v), method="flash",
                          causal=True, window=window, blk_q=32, blk_kv=128,
                          interpret=True)
    got = tops.attention(to_torch(q), to_torch(k), to_torch(v),
                         method="flash", causal=True, window=window)
    assert_close(got, want, FP32_ATOL)
    # a window sends the MAS methods to flash, as in the reference
    got_mas = tops.attention(to_torch(q), to_torch(k), to_torch(v),
                             method="mas_resident", causal=True,
                             window=window)
    assert_close(got_mas, want, FP32_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mas_plain_matches_tiled_oracle(causal):
    q, k, v = _qkv((1, 4, 2, 64, 128, 16), seed=11)
    want = jref.mas_attention_tiled(to_jax(q), to_jax(k), to_jax(v),
                                    blk_q=16, blk_kv=64, causal=causal)
    b, hq, nq, e = q.shape
    got = tmas.mas_attention_plain(
        to_torch(q).reshape(b * hq, nq, e),
        to_torch(k).reshape(b * 2, 128, e),
        to_torch(v).reshape(b * 2, 128, e), blk_q=16, blk_kv=64,
        causal=causal)
    assert_close(got.reshape(b, hq, nq, e), want, FP32_ATOL)


def test_flash_q_offset_matches_oracle():
    q, k, v = _qkv((1, 2, 1, 32, 96, 16), seed=12)
    want = jref.attention(to_jax(q), to_jax(k), to_jax(v), causal=True,
                          q_offset=50)
    got = tflash.flash_attention_flat(
        to_torch(q).reshape(2, 32, 16), to_torch(k).reshape(1, 96, 16),
        to_torch(v).reshape(1, 96, 16), blk_q=16, blk_kv=32, causal=True,
        q_offset=50)
    assert_close(got.reshape(1, 2, 32, 16), want, FP32_ATOL)


# ---------------------------------------------------------------------------
# B4 decode vs the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s_len,kv_len", [(64, 64), (200, 77), (300, 1),
                                          (256, 129)])
def test_decode_kernel_matches_pallas(s_len, kv_len, dtype):
    jdt, tdt = DTYPES[dtype]
    b, hq, hkv, e = 2, 4, 2, 32
    q = rand(s_len, (b, hq, e))
    k, v = rand(s_len + 1, (b, hkv, s_len, e)), rand(s_len + 2,
                                                     (b, hkv, s_len, e))
    want = jops.decode_attention(to_jax(q, jdt), to_jax(k, jdt),
                                 to_jax(v, jdt), kv_len, blk_kv=128,
                                 interpret=True)
    got = tops.decode_attention(to_torch(q, tdt), to_torch(k, tdt),
                                to_torch(v, tdt), kv_len)
    assert got.dtype == tdt
    assert_close(got, want, atol_for(dtype))


def test_decode_ragged_batch_matches_pallas_row_by_row():
    b, hq, hkv, e, s_len = 3, 4, 2, 16, 150
    q = rand(0, (b, hq, e))
    k, v = rand(1, (b, hkv, s_len, e)), rand(2, (b, hkv, s_len, e))
    lens = [1, 64, 150]
    got = tops.decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                torch.tensor(lens))
    for i, n in enumerate(lens):
        want = jops.decode_attention(to_jax(q[i:i + 1]), to_jax(k[i:i + 1]),
                                     to_jax(v[i:i + 1]), n, interpret=True)
        assert_close(got[i:i + 1], want, FP32_ATOL)


@pytest.mark.parametrize("bh,n_kv", [(1, 64), (4, 8256), (32, 8256),
                                     (64, 100), (3, 1)])
def test_decode_split_plan_covers_the_cache(bh, n_kv):
    n_split, tps = tdec.split_plan(bh, n_kv)
    n_tiles = -(-n_kv // policy.KV_TILE)
    assert n_split * tps >= n_tiles > (n_split - 1) * tps
    assert n_split <= -(-tdec.TARGET_BLOCKS // bh)
    # the plain version gives one answer whatever the split
    q, k, v = (rand(5, (bh, 2, 16)), rand(6, (bh, 80, 16)),
               rand(7, (bh, 80, 16)))
    lens = torch.tensor(np.random.default_rng(bh).integers(0, 81, size=bh))
    one = tdec.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                      lens, n_split=1, tiles_per_split=2)
    two = tdec.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                      lens, n_split=2, tiles_per_split=1)
    assert_close(one, two, 1e-6)


@pytest.mark.parametrize("bh,n_kv", [(1, 64), (4, 8256), (32, 8256),
                                     (64, 100), (3, 1), (64, 4096),
                                     (32, 271)])
def test_bf16_decode_split_plan_covers_the_cache(bh, n_kv):
    """The tensor-core forms of B4, B6 and B7 (a bf16 q) take short splits
    of their own (1 to TC_MAX_TILES tiles) that cover the cache; an fp32 q
    keeps split_plan, and the plain version gives one answer on either."""
    n_split, tps = tdec.decode_split_plan(torch.bfloat16, bh, n_kv)
    n_tiles = -(-n_kv // policy.KV_TILE)
    assert n_split * tps >= n_tiles > (n_split - 1) * tps
    assert 1 <= tps <= tdec.TC_MAX_TILES
    if tps > 1:             # no shorter split keeps the grid to the target
        assert -(-n_tiles // (tps - 1)) * bh > tdec.TARGET_BLOCKS
    assert tdec.decode_split_plan(torch.float32, bh, n_kv) == \
        tdec.split_plan(bh, n_kv)
    q, k, v = (rand(8, (bh, 2, 16)), rand(9, (bh, n_kv, 16)),
               rand(10, (bh, n_kv, 16)))
    lens = torch.tensor(np.random.default_rng(bh).integers(0, n_kv + 1,
                                                           size=bh))
    short = tdec.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                        lens, n_split=n_split,
                                        tiles_per_split=tps)
    n_split, tps = tdec.split_plan(bh, n_kv)
    long = tdec.decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                       lens, n_split=n_split,
                                       tiles_per_split=tps)
    assert_close(short, long, 1e-6)


def test_bf16_plan_spreads_the_longest_sequence_over_every_sm():
    """At the ragged batch chip_smoke.py times (kv_lens 1, 300, 2060, 8207
    of an 8256-row cache, 8 kv heads), the longest sequence's live splits
    fill the H100's 132 SMs; split_plan gave it 72 blocks."""
    kv_lens, hkv, s_len = (1, 300, 2060, 8207), 8, 8256
    bh = len(kv_lens) * hkv
    for dtype, least in ((torch.bfloat16, 132), (torch.float32, 72)):
        n_split, tps = tdec.decode_split_plan(dtype, bh, s_len)
        span = tps * policy.KV_TILE
        live = [min(n_split, -(-n // span)) * hkv for n in kv_lens]
        assert max(live) >= least
    assert (n_split, tps) == (9, 15)


def test_decode_int8_cache_gives_attention_over_the_dequantized_cache():
    """int8 caches with per-row scales give attention over the dequantized
    caches, and scales without int8 caches are refused."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 16, generator=gen)
    k, v = torch.randn(2, 32, 16, generator=gen), torch.randn(
        2, 32, 16, generator=gen)
    (kq, ks), (vq, vs) = (tcommon.quantize_q8(x, -1) for x in (k, v))
    lens = torch.tensor([3, 30])
    got = tdec.decode_attention_flat(q, kq, vq, lens, k_scale=ks, v_scale=vs)
    want = tdec.decode_attention_flat(q, tcommon.dequantize_q8(kq, ks, -1),
                                      tcommon.dequantize_q8(vq, vs, -1), lens)
    assert float((got - want).abs().max()) <= 3e-5
    with pytest.raises(ValueError, match="int8"):
        tdec.decode_attention_flat(q, k, v, lens, k_scale=ks, v_scale=vs)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(2, 32, 16, device="meta")
    with pytest.raises(ValueError):
        tmas.mas_attention_flat(q, q, q, blk_q=32, blk_kv=32)
    with pytest.raises(ValueError):
        tflash.flash_attention_flat(q, q, q, blk_q=32, blk_kv=32)
    with pytest.raises(ValueError):
        tcommon.check_prefill_tile(12, 128)


# ---------------------------------------------------------------------------
# the shared-memory policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,method,blk_q", [
    (1, "mas_resident", 32), (256, "mas_resident", 32),
    (320, "mas_resident", 32), (321, "mas_streamed", 32),
    (1536, "mas_streamed", 32), (1537, "mas_streamed", 16),
    (3200, "mas_streamed", 16), (3201, "mas_streamed", 8),
    (6528, "mas_streamed", 8), (6529, "flash", 64), (8192, "flash", 64),
])
def test_policy_regimes_at_e128_bf16(n, method, blk_q):
    d = policy.choose_attention_method(n_kv=n, e=128, itemsize=2)
    assert (d.method, d.blk_q) == (method, blk_q)
    assert d.smem_bytes <= policy.DEFAULT_SMEM_BUDGET
    assert tops.resolve_method(4096, n, 128, 2)[0] == method


def test_policy_footprints_and_forced_modes():
    # the footprints are the kernels' dynamic shared memory
    assert policy.mas_smem_bytes(32, 64, 256, 128, 2, True) == 184_320
    assert policy.mas_smem_bytes(16, 64, 2048, 128, 2, False) == 156_160
    assert policy.flash_smem_bytes(64, 64, 128, 2) == 82_944
    # a named kernel is run as asked, at the default block height (the
    # bf16 flash kernel at its own)
    assert tops.resolve_method(64, 64, 128, 2, method="flash") == ("flash", 64)
    assert tops.resolve_method(
        64, 64, 128, 2, method="mas_streamed") == ("mas_streamed", 32)
    # a window always goes to flash; unknown methods are refused
    assert tops.resolve_method(64, 64, 128, 2, window=16)[0] == "flash"
    for method in ("mas", "ref"):
        with pytest.raises(ValueError):
            tops.resolve_method(64, 64, 128, 2, method=method)
    # past the (8, N) score row the policy gives way to flash (paper §5.6)
    d = policy.choose_attention_method(n_kv=10_000, e=128)
    assert d.method == "flash" and "§5.6" in d.reason
    # a short prompt gets a block no taller than itself, rounded to 8
    assert tops.resolve_method(5, 5, 128, 2) == ("mas_resident", 8)


def test_launch_counts_only_count_kernel_launches():
    tops.reset_launch_counts()
    q, k, v = _qkv((1, 4, 2, 32, 32, 16), seed=9)
    tops.attention(to_torch(q), to_torch(k), to_torch(v), causal=True)
    tops.decode_attention(to_torch(q[:, :, 0]), to_torch(k), to_torch(v), 9)
    pool = to_torch(k).reshape(2, 8, 4, 16)
    table = torch.arange(8, dtype=torch.int32)
    lens = torch.tensor([9], dtype=torch.int32)
    tops.paged_decode_attention(to_torch(q[:, :, 0]), pool, pool,
                                table[None], lens)
    tops.paged_prefill_attention(to_torch(q[0]), pool, pool, table,
                                 span(0, 32))
    tops.paged_verify_attention(to_torch(q[:, :, :2].transpose(0, 2, 1, 3)),
                                pool, pool, table[None], lens, lens - 2)
    x = to_torch(k).reshape(1, 32, 4, 8)              # (B, L, H, P)
    tops.ssd_chunked(x, -x[..., 0].abs(), x, x, 16)
    assert tops.launch_counts() == {
        "mas_resident": 0, "mas_streamed": 0, "flash": 0, "decode": 0,
        "decode_int8": 0, "paged_decode": 0, "paged_decode_int8": 0,
        "paged_prefill": 0, "paged_prefill_int8": 0, "paged_verify": 0,
        "paged_verify_int8": 0, "ssd_intra_chunk": 0}
