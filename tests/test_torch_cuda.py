"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs a CUDA device, is marked ``gpu`` and skips itself
elsewhere; the file imports no JAX, so it runs on a GPU host that has
only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel runs in fp32 against its plain version on the same CUDA
tensors (atol 3e-5: fp32 sums in another order), the int8 branches of
B4-B7 on int8 caches with their scales, and the wave, continuous and
speculative engines serve a smoke model on the card with the same tokens
as on the CPU, on bf16-free fp32 and on int8 caches. B5 takes its
(q_offset, kv_len) as an int32 pair on the device, and its launch path
runs with PyTorch's synchronizing calls made errors. The bf16 forms of
B1, B2, B3, B5 (tensor cores; B5 on bf16 and int8 pools), B4, B6 and B7
(tensor cores, on bf16 and int8 caches, on their own short splits) are
held per output row within
4e-3 of the row's L2 norm, the limit ``chip_smoke.py`` uses, and a
planted zeroed V tile, V page or V scale must break it. B8 (the SSD
intra-chunk step) and the chunked scan around it are held row by row
(L2 error within 1e-4 of the row's norm: y grows with the rows a decay
lets through, so an absolute limit does not fit), at a full-width cell
count, on a ragged tail, and against a planted zeroed X tile; its bf16
form (tensor cores) also on short and ragged chunks with its launch path
free of host syncs, and refusing a chunk past 256 rows; the wave engine
serves the mamba2 smoke model on the card with the CPU's tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import mas_attention as mas
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.kernels import paged_prefill_attention as ppre
from repro_torch.kernels import paged_verify_attention as pver
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm
from repro_torch.kernels.common import quantize_q8
from repro_torch.models.api import build_model
from repro_torch.serving import (
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
    ScriptedFaults,
    ServingEngine,
)

FP32_ATOL = 3e-5
SSD_ROW_RTOL = 1e-4
BF16_ROW_RTOL = 4e-3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("resident", [True, False])
def test_mas_kernels_match_plain(cuda, resident, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _rand(g, 8, 160, 64), _rand(g, 4, 192, 64), _rand(g, 4, 192, 64)
    got = mas.mas_attention_flat(q, k, v, blk_q=32, causal=causal,
                                 kv_resident=resident, kv_len=170)
    want = mas.mas_attention_plain(q, k, v, blk_q=32, blk_kv=64,
                                   causal=causal, kv_len=170)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


@pytest.mark.parametrize("window", [None, 40])
def test_flash_kernel_matches_plain(cuda, window):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = _rand(g, 4, 128, 128), _rand(g, 2, 256, 128), \
        _rand(g, 2, 256, 128)
    got = fl.flash_attention_flat(q, k, v, blk_q=16, causal=True,
                                  window=window, q_offset=100, kv_len=230)
    want = fl.flash_attention_plain(q, k, v, blk_q=16, blk_kv=64, causal=True,
                                    window=window, q_offset=100, kv_len=230)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def _bf16(gen, *shape):
    return _rand(gen, *shape).to(torch.bfloat16)


def _span(q_offset: int, kv_len: int, device) -> torch.Tensor:
    """B5's (q_offset, kv_len) pair on the device."""
    return torch.tensor([q_offset, kv_len], dtype=torch.int32, device=device)


def _no_host_sync(fn):
    """``fn()`` with PyTorch's synchronizing calls (``int()``, ``.item()``
    of a CUDA tensor) made errors: B5's and B8's launch paths read nothing
    of the device back."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _zero_v_tile(v, tile: int):
    out = v.clone()
    out[:, tile * 64:(tile + 1) * 64] = 0
    return out


def _held_per_row(got, want, faulty):
    """Each row of ``got`` within BF16_ROW_RTOL of ``want``'s, and the
    planted fault ``faulty`` beyond it."""
    err, fault = _row_rel(got, want), _row_rel(faulty, want)
    assert err <= BF16_ROW_RTOL, (err, fault)
    assert fault > BF16_ROW_RTOL, (err, fault)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("blk_q,e", [(8, 128), (16, 128), (32, 128),
                                     (24, 128), (8, 64), (16, 64)])
def test_mas_streamed_bf16_kernel_matches_plain_per_row(cuda, blk_q, e,
                                                        causal):
    """B2 on the tensor cores: blk_q 8 is the transposed form, 16 one m16
    tile, 24 and 32 two; GQA group 2 and a kv_len tail inside the last
    tile (330 of 384)."""
    g = torch.Generator(device=cuda).manual_seed(20 + blk_q + e)
    q = _bf16(g, 8, 192, e)
    k, v = _bf16(g, 4, 384, e), _bf16(g, 4, 384, e)
    kw = dict(blk_q=blk_q, causal=causal, kv_len=330)
    got = mas.mas_attention_flat(q, k, v, kv_resident=False, **kw)
    want = mas.mas_attention_plain(q, k, v, blk_kv=64, **kw)
    faulty = mas.mas_attention_plain(q, k, _zero_v_tile(v, 1), blk_kv=64,
                                     **kw)
    torch.cuda.synchronize()
    _held_per_row(got, want, faulty)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_bf16_kernel_matches_plain_per_row(cuda, window):
    """B3 on the tensor cores, in 64-row blocks: rows at positions 150-405
    (q_offset), a kv_len tail at 420 of 448, GQA group 2."""
    e = 128
    g = torch.Generator(device=cuda).manual_seed(30 + e)
    q = _bf16(g, 4, 256, e)
    k, v = _bf16(g, 2, 448, e), _bf16(g, 2, 448, e)
    kw = dict(blk_q=64, causal=True, window=window, q_offset=150,
              kv_len=420)
    got = fl.flash_attention_flat(q, k, v, **kw)
    want = fl.flash_attention_plain(q, k, v, blk_kv=64, **kw)
    faulty = fl.flash_attention_plain(q, k, _zero_v_tile(v, 4), blk_kv=64,
                                      **kw)
    torch.cuda.synchronize()
    _held_per_row(got, want, faulty)


def test_short_windowed_bf16_prompt_pads_to_the_flash_block(cuda):
    """A 20-token windowed prompt: the bf16 flash kernel's 64-row block,
    the query rows padded to it, against the same call on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(40)
    q = _bf16(g, 1, 4, 20, 128)
    k, v = _bf16(g, 1, 2, 20, 128), _bf16(g, 1, 2, 20, 128)
    assert ops.resolve_method(20, 20, 128, 2, window=8) == ("flash", 64)
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal=True, window=8)
    assert ops.launch_counts()["flash"] == 1
    want = ops.attention(q.cpu(), k.cpu(), v.cpu(), causal=True, window=8)
    faulty = ops.attention(q.cpu(), k.cpu(), torch.zeros_like(v.cpu()),
                           causal=True, window=8)
    torch.cuda.synchronize()
    _held_per_row(got.cpu(), want, faulty)


def test_bf16_prefill_kernels_refuse_what_they_do_not_take(cuda):
    """A bf16 tensor runs the tensor-core kernels or raises: no block
    height or head dim they are not built for reaches another kernel.
    Head dim 64 is taken by all of them, and matches the plain version."""
    g = torch.Generator(device=cuda).manual_seed(41)
    q, k = _bf16(g, 2, 128, 32), _bf16(g, 2, 128, 32)
    ops.reset_launch_counts()
    for resident in (False, True):
        with pytest.raises(ValueError, match="bf16"):
            mas.mas_attention_flat(q, k, k, blk_q=16, kv_resident=resident)
    with pytest.raises(ValueError, match="bf16"):
        fl.flash_attention_flat(q, k, k, blk_q=64)
    q = _bf16(g, 2, 128, 128)
    with pytest.raises(ValueError, match="bf16"):
        fl.flash_attention_flat(q, q, q, blk_q=32)
    pool, table = _bf16(g, 2, 8, 16, 128), torch.arange(
        8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        ppre.paged_prefill_attention_flat(q, pool, pool, table,
                                          _span(0, 128, cuda), blk_q=32)
    assert sum(ops.launch_counts().values()) == 0
    q64, k64, v64 = (_bf16(g, 2, 128, 64) for _ in range(3))
    kw = dict(blk_q=64, causal=True)
    got = fl.flash_attention_flat(q64, k64, v64, **kw)
    want = fl.flash_attention_plain(q64, k64, v64, blk_kv=64, **kw)
    faulty = fl.flash_attention_plain(q64, k64, _zero_v_tile(v64, 0),
                                      blk_kv=64, **kw)
    torch.cuda.synchronize()
    _held_per_row(got, want, faulty)


@pytest.mark.parametrize("q_offset", [0, 100])
def test_flash_bf16_kernel_at_head_dim_64_matches_plain_per_row(cuda,
                                                                q_offset):
    """B3's wgmma form at E 64 (S and P V both m64n64k16): three KV tiles
    a block, so both stages are used and one is reused, a random V,
    non-causal (every tile live) and causal."""
    g = torch.Generator(device=cuda).manual_seed(42 + q_offset)
    q = _bf16(g, 4, 128, 64)
    k, v = _bf16(g, 2, 256, 64), _bf16(g, 2, 256, 64)
    for causal in (False, True):
        kw = dict(blk_q=64, causal=causal, q_offset=q_offset, kv_len=230)
        got = fl.flash_attention_flat(q, k, v, **kw)
        want = fl.flash_attention_plain(q, k, v, blk_kv=64, **kw)
        faulty = fl.flash_attention_plain(q, k, _zero_v_tile(v, 1),
                                          blk_kv=64, **kw)
        torch.cuda.synchronize()
        _held_per_row(got, want, faulty)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,blk_q,e", [(64, 8, 128), (128, 16, 128),
                                       (256, 32, 128), (320, 24, 128),
                                       (192, 32, 64), (320, 8, 64)])
def test_mas_resident_bf16_kernel_matches_plain_per_row(cuda, n, blk_q, e,
                                                        causal):
    """B1 on the tensor cores, K and V resident: N 64 to 320, blk_q 8 (the
    transposed form), 16, 24 and 32, GQA group 2, a kv_len tail 13 rows
    short of N."""
    g = torch.Generator(device=cuda).manual_seed(50 + n + blk_q + e)
    q = _bf16(g, 4, 192, e)
    k, v = _bf16(g, 2, n, e), _bf16(g, 2, n, e)
    kw = dict(blk_q=blk_q, causal=causal, kv_len=n - 13)
    ops.reset_launch_counts()
    got = mas.mas_attention_flat(q, k, v, kv_resident=True, **kw)
    assert ops.launch_counts()["mas_resident"] == 1
    want = mas.mas_attention_plain(q, k, v, blk_kv=64, **kw)
    faulty = mas.mas_attention_plain(q, k, _zero_v_tile(v, 0), blk_kv=64,
                                     **kw)
    torch.cuda.synchronize()
    _held_per_row(got, want, faulty)


def _bf16_pools(gen, quantized: bool, hkv: int = 2, n_pages: int = 256,
                e: int = 128):
    """bf16 pools of 16-row pages, or int8 pools with per-page scales,
    and a shuffled page table over them: (k, v, table, scales)."""
    k, v = (_rand(gen, hkv, n_pages, 16, e) for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=gen, device=gen.device) + 1
    table = perm.to(torch.int32).contiguous()
    if not quantized:
        return k.bfloat16(), v.bfloat16(), table, {}
    (k, ks), (v, vs) = quantize_q8(k, (-2, -1)), quantize_q8(v, (-2, -1))
    return k, v, table, {"k_scales": ks, "v_scales": vs}


def _paged_bf16_case(cuda, seed, quantized, group, q0, kv_len, chunk, e):
    g = torch.Generator(device=cuda).manual_seed(seed)
    k, v, table, sc = _bf16_pools(g, quantized, e=e)
    q = _bf16(g, 2 * group, chunk, e)
    fault_page = int(table[(kv_len - 1) // 16 // 2])
    ops.reset_launch_counts()
    span = _span(q0, kv_len, cuda)
    # through ops: a ragged chunk's rows padded to the 64-row block
    got = _no_host_sync(
        lambda: ops.paged_prefill_attention(q, k, v, table, span, **sc))
    counts = ops.launch_counts()
    assert counts["paged_prefill_int8" if quantized else "paged_prefill"] \
        == 1

    def plain(v=v, vs=sc.get("v_scales")):
        kw = dict(sc, v_scales=vs) if quantized else {}
        qp = torch.nn.functional.pad(q, (0, 0, 0, (-chunk) % 64))
        return ppre.paged_prefill_attention_plain(
            qp, k, v, table, span, blk_q=64, **kw)[:, :chunk]

    if quantized:
        vs = sc["v_scales"].clone()
        vs[:, fault_page] = 0
        faulty = plain(vs=vs)
    else:
        vz = v.clone()
        vz[:, fault_page] = 0
        faulty = plain(v=vz)
    torch.cuda.synchronize()
    # rows at or past kv_len are pad rows the caller drops
    live = min(chunk, kv_len - q0)
    _held_per_row(got[:, :live], plain()[:, :live], faulty[:, :live])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("q0,kv_len,chunk", [
    (0, 200, 256), (64, 250, 192), (100, 300, 200), (3072, 3333, 512),
    (1000, 1400, 512)])
def test_paged_prefill_bf16_kernel_matches_plain_per_row(
        cuda, quantized, group, q0, kv_len, chunk):
    """B5's wgmma form on bf16 and int8 pools: shuffled pages, at least
    three live tiles (more than the ring's three stages, so stages are
    reused), q_offset 0, 64, 100 and 1000 (not multiples of 64) and 3072,
    kv_len ending mid-page, GQA 1 and 2, a random V, ragged chunks padded
    to the 64-row block through ops, pad rows past kv_len."""
    _paged_bf16_case(cuda, 60 + q0 + group, quantized, group, q0, kv_len,
                     chunk, 128)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_bf16_kernel_at_head_dim_64(cuda, quantized):
    _paged_bf16_case(cuda, 70, quantized, 2, 100, 300, 200, 64)


def test_decode_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = _rand(g, 4, 4, 128), _rand(g, 4, 500, 128), _rand(g, 4, 500, 128)
    lens = torch.tensor([0, 64, 65, 500], dtype=torch.int32, device=cuda)
    got = dec.decode_attention_flat(q, k, v, lens)
    n_split, tps = dec.decode_split_plan(q.dtype, 4, 500)
    want = dec.decode_attention_plain(q, k, v, lens, n_split=n_split,
                                      tiles_per_split=tps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def test_decode_kernel_int8_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    q = _rand(g, 4, 4, 128)
    (k, ks), (v, vs) = (quantize_q8(_rand(g, 4, 500, 128), -1)
                        for _ in range(2))
    lens = torch.tensor([0, 64, 65, 500], dtype=torch.int32, device=cuda)
    got = dec.decode_attention_flat(q, k, v, lens, k_scale=ks, v_scale=vs)
    n_split, tps = dec.decode_split_plan(q.dtype, 4, 500)
    want = dec.decode_attention_plain(q, k, v, lens, n_split=n_split,
                                      tiles_per_split=tps, k_scale=ks,
                                      v_scale=vs)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def _dense_bf16_kv(g, quantized, *shape):
    """bf16 K and V of ``shape``, or int8 with per-row scales: (k, v,
    {"k_scale": ..., "v_scale": ...} or {})."""
    k, v = _bf16(g, *shape), _bf16(g, *shape)
    if not quantized:
        return k, v, {}
    (k, ks), (v, vs) = (quantize_q8(x.float(), -1) for x in (k, v))
    return k, v, {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("e", [64, 128])
@pytest.mark.parametrize("group", [2, 4, 8])
def test_decode_bf16_kernel_matches_plain_per_row(cuda, e, group,
                                                  quantized):
    """B4's tensor-core form on bf16 caches and on int8 caches with
    per-row scales (bf16 q), on a ragged batch: kv_len 0, 1, a tile edge
    (64) and one row past it, lengths mid-cache, and the cache's capacity,
    on a cache long enough for four tiles a split (each warp walks four
    slices through its ring of three slots); a random V, the fault a
    zeroed V tile or, on int8 caches, its V scales."""
    g = torch.Generator(device=cuda).manual_seed(80 + e + group)
    s_len, kv = 6400, [0, 1, 64, 65, 1000, 3001, 6399, 6400]
    bh = len(kv)
    q = _bf16(g, bh, group, e)
    k, v, sc = _dense_bf16_kv(g, quantized, bh, s_len, e)
    lens = torch.tensor(kv, dtype=torch.int32, device=cuda)
    n_split, tps = dec.decode_split_plan(q.dtype, bh, s_len)
    assert tps == dec.TC_MAX_TILES
    ops.reset_launch_counts()
    got = dec.decode_attention_flat(q, k, v, lens, **sc)
    assert ops.launch_counts()[
        "decode_int8" if quantized else "decode"] == 1

    def plain(v=v, vs=sc.get("v_scale")):
        kw = dict(sc, v_scale=vs) if quantized else {}
        return dec.decode_attention_plain(q, k, v, lens, n_split=n_split,
                                          tiles_per_split=tps, **kw)

    if quantized:
        vs = sc["v_scale"].clone()
        vs[:, 40 * 64:41 * 64] = 0
        faulty = plain(vs=vs)
    else:
        faulty = plain(_zero_v_tile(v, 40))
    torch.cuda.synchronize()
    assert float(got[0].abs().max()) == 0.0       # kv_len 0 gives zeros
    _held_per_row(got, plain(), faulty)


@pytest.mark.parametrize("kv_len", [1, 271, 2063])
def test_decode_bf16_kernel_through_ops_at_wave_lengths(cuda, kv_len):
    """B4's bf16 form as the wave engine calls it: one kv_len for the whole
    batch, known on the host, so the split fits the live rows (one tile a
    block at the first wave's lengths)."""
    g = torch.Generator(device=cuda).manual_seed(kv_len)
    b, hq, hkv, e, s_len = 4, 16, 8, 128, 2112
    q = _bf16(g, b, hq, e)
    k, v = _bf16(g, b, hkv, s_len, e), _bf16(g, b, hkv, s_len, e)
    n_split, tps = dec.decode_split_plan(torch.bfloat16, b * hkv, kv_len)
    lens = torch.full((b * hkv,), kv_len, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, kv_len)

    def plain(v=v):
        return dec.decode_attention_plain(
            q.view(b * hkv, hq // hkv, e), k.view(b * hkv, s_len, e),
            v.reshape(b * hkv, s_len, e), lens, n_split=n_split,
            tiles_per_split=tps).view(b, hq, e)

    vz = v.clone()                                # the last live tile
    vz[:, :, (kv_len - 1) // 64 * 64:(kv_len - 1) // 64 * 64 + 64] = 0
    faulty = plain(vz)
    torch.cuda.synchronize()
    _held_per_row(got, plain(), faulty)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("e", [64, 128])
@pytest.mark.parametrize("spec,group", [(1, 2), (4, 2), (8, 2), (3, 4),
                                        (8, 4), (2, 8), (4, 8)])
def test_paged_verify_bf16_kernel_matches_plain_per_row(cuda, e, spec,
                                                        group, quantized):
    """B7's tensor-core form on bf16 pools and on int8 pools with per-page
    scales (bf16 q): k 1-8 positions of G 2, 4 and 8 heads (k G up to 32
    rows, two m16 tiles), on shuffled 16-row pages of a table long enough
    for four tiles a split. Slots: a start mid-page, a block straddling a
    64-row tile, kv_len 0, one written row of k (kv_len 64), one short of
    k (rows past kv_len see the live context), and blocks ending deep in
    the table and at its capacity; a random V, the fault a zeroed V page
    or, on int8 pools, its V scale."""
    g = torch.Generator(device=cuda).manual_seed(90 + e + 10 * spec + group)
    b, hkv, page, max_pages = 8, 2, 16, 256
    n_pages, cap = b * max_pages + 1, max_pages * page
    k, v = (_bf16(g, hkv, n_pages, page, e) for _ in range(2))
    sc = {}
    if quantized:
        (k, ks), (v, vs) = (quantize_q8(x.float(), (-2, -1)) for x in (k, v))
        sc = {"k_scales": ks, "v_scales": vs}
    table = (torch.randperm(n_pages - 1, generator=g, device=cuda) + 1).view(
        b, max_pages).to(torch.int32).contiguous()
    starts = torch.tensor([5, 62, 0, 63, 1000, 2047, cap - spec, 3000],
                          dtype=torch.int32, device=cuda)
    rows = torch.tensor([spec, spec, 0, 1, max(spec - 1, 1), spec, spec,
                         spec], dtype=torch.int32, device=cuda)
    lens = starts + rows
    q = _bf16(g, b, hkv, spec * group, e)
    n_split, tps = dec.decode_split_plan(q.dtype, b * hkv, cap)
    assert tps == dec.TC_MAX_TILES
    ops.reset_launch_counts()
    got = pver.paged_verify_attention_flat(q, k, v, table, lens, starts,
                                           spec=spec, **sc)
    assert ops.launch_counts()[
        "paged_verify_int8" if quantized else "paged_verify"] == 1

    def plain(v=v, vs=sc.get("v_scales")):
        kw = dict(sc, v_scales=vs) if quantized else {}
        return pver.paged_verify_attention_plain(
            q, k, v, table, lens, starts, spec=spec, n_split=n_split,
            tiles_per_split=tps, **kw)

    fault = int(table[7, 100])                    # rows 1600-1615 of slot 7
    if quantized:
        vs = sc["v_scales"].clone()
        vs[:, fault] = 0
        faulty = plain(vs=vs)
    else:
        vz = v.clone()
        vz[:, fault] = 0
        faulty = plain(vz)
    torch.cuda.synchronize()
    assert float(got[2].abs().max()) == 0.0       # kv_len 0 gives zeros
    _held_per_row(got, plain(), faulty)


def _paged_decode_bf16_inputs(g, quantized, *, b, hkv, group, page,
                              max_pages, e):
    """bf16 q (b, hkv, group, e); bf16 pools, or int8 pools with their
    per-page scales, of b * max_pages + 1 pages; a shuffled table."""
    n_pages = b * max_pages + 1
    k, v = (_bf16(g, hkv, n_pages, page, e) for _ in range(2))
    sc = {}
    if quantized:
        (k, ks), (v, vs) = (quantize_q8(x.float(), (-2, -1)) for x in (k, v))
        sc = {"k_scales": ks, "v_scales": vs}
    table = (torch.randperm(n_pages - 1, generator=g, device=g.device)
             + 1).view(b, max_pages).to(torch.int32).contiguous()
    return _bf16(g, b, hkv, group, e), k, v, table, sc


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("e", [64, 128])
def test_paged_decode_bf16_kernel_matches_plain_per_row(cuda, e, group,
                                                        page, quantized):
    """B6's tensor-core form on bf16 pools and on int8 pools (bf16 q):
    G 1-16 (one m16 tile), pages of 4, 8 and 16 rows (a 16-row slice
    spans four, two or one page, so the int8 scales are looked up per
    column), kv_lens 0, 1, 15, 16, 17, 64, 65 and the table's capacity
    (4096 rows: four tiles a split, more slices a warp than ring slots); a
    random V, the fault a zeroed V page or, on int8 pools, V scale."""
    g = torch.Generator(device=cuda).manual_seed(100 + e + group + page)
    cap = 4096
    q, k, v, table, sc = _paged_decode_bf16_inputs(
        g, quantized, b=8, hkv=2, group=group, page=page,
        max_pages=cap // page, e=e)
    lens = torch.tensor([0, 1, 15, 16, 17, 64, 65, cap], dtype=torch.int32,
                        device=cuda)
    n_split, tps = dec.decode_split_plan(q.dtype, 16, cap)
    assert tps == dec.TC_MAX_TILES
    ops.reset_launch_counts()
    got = pdec.paged_decode_attention_flat(q, k, v, table, lens, **sc)
    assert ops.launch_counts()[
        "paged_decode_int8" if quantized else "paged_decode"] == 1

    def plain(v=v, vs=sc.get("v_scales")):
        kw = dict(sc, v_scales=vs) if quantized else {}
        return pdec.paged_decode_attention_plain(
            q, k, v, table, lens, n_split=n_split, tiles_per_split=tps, **kw)

    fault = int(table[7, 1000 // page])            # rows 1000.. of slot 7
    if quantized:
        vs = sc["v_scales"].clone()
        vs[:, fault] = 0
        faulty = plain(vs=vs)
    else:
        vz = v.clone()
        vz[:, fault] = 0
        faulty = plain(v=vz)
    torch.cuda.synchronize()
    assert float(got[0].abs().max()) == 0.0       # kv_len 0 gives zeros
    _held_per_row(got, plain(), faulty)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_bf16_kernel_through_ops_at_continuous_shapes(
        cuda, quantized):
    """B6 as the continuous engine calls it: ``ops.paged_decode_attention``
    on (8, 2049, 16, 128) pools, 16 query and 8 kv heads, a 4096-row table
    a sequence, ``chip_smoke.py``'s kv_lens; 16 splits of 4 tiles."""
    g = torch.Generator(device=cuda).manual_seed(110 + quantized)
    b, hq, hkv, e, page, max_pages = 8, 16, 8, 128, 16, 256
    q, k, v, table, sc = _paged_decode_bf16_inputs(
        g, quantized, b=b, hkv=hkv, group=hq // hkv, page=page,
        max_pages=max_pages, e=e)
    lens = torch.tensor([1, 17, 300, 1000, 1777, 2500, 3100, 3600],
                        dtype=torch.int32, device=cuda)
    n_split, tps = dec.decode_split_plan(q.dtype, b * hkv,
                                         max_pages * page)
    assert (n_split, tps) == (16, 4)
    ops.reset_launch_counts()
    got = ops.paged_decode_attention(q.view(b, hq, e), k, v, table, lens,
                                     **sc)
    assert ops.launch_counts()[
        "paged_decode_int8" if quantized else "paged_decode"] == 1

    def plain(v=v, vs=sc.get("v_scales")):
        kw = dict(sc, v_scales=vs) if quantized else {}
        return pdec.paged_decode_attention_plain(
            q, k, v, table, lens, n_split=n_split, tiles_per_split=tps,
            **kw).view(b, hq, e)

    fault = int(table[7, 3500 // page])
    if quantized:
        vs = sc["v_scales"].clone()
        vs[:, fault] = 0
        faulty = plain(vs=vs)
    else:
        vz = v.clone()
        vz[:, fault] = 0
        faulty = plain(v=vz)
    torch.cuda.synchronize()
    _held_per_row(got, plain(), faulty)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_paged_verify_bf16_of_one_position_is_paged_decode(cuda, group,
                                                           quantized):
    """On one core and one plan, B7's tensor-core form with k = 1 and
    q_starts = kv_len - 1 masks exactly what B6's does (every row sees the
    live context), on bf16 pools and on int8 pools: the two kernels give
    one output bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(120 + group)
    q, k, v, table, sc = _paged_decode_bf16_inputs(
        g, quantized, b=8, hkv=2, group=group, page=16, max_pages=256, e=128)
    lens = torch.tensor([0, 1, 17, 300, 1000, 2047, 3100, 4096],
                        dtype=torch.int32, device=cuda)
    got = pver.paged_verify_attention_flat(q, k, v, table, lens,
                                           (lens - 1).clamp(min=0), spec=1,
                                           **sc)
    want = pdec.paged_decode_attention_flat(q, k, v, table, lens, **sc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["decode", "decode_int8", "verify",
                                    "verify_int8", "paged_decode",
                                    "paged_decode_int8"])
def test_bf16_decode_kernels_repeat_bit_for_bit(cuda, kernel):
    """B4's, B6's and B7's tensor-core forms merge their warps and splits
    in a fixed order, so 300 calls on one input give one output bit for
    bit; a race in a warp's ring or in the merge of the live splits would
    not. The shapes are ``chip_smoke.py``'s: B4's ragged batch (kv_lens 1,
    300, 2060, 8207 of an 8256-row cache, 16 query and 8 kv heads of 128)
    on bf16 and int8 caches, B6's eight sequences (kv_lens 1-3600, G 2)
    and B7's eight slots (k 4, G 2) on (8, 2049, 16, 128) bf16 and int8
    pools."""
    g = torch.Generator(device=cuda).manual_seed(7)
    hkv, e = 8, 128
    quantized = kernel.endswith("_int8")
    if kernel.startswith("paged_decode"):
        q, k, v, table, sc = _paged_decode_bf16_inputs(
            g, quantized, b=8, hkv=hkv, group=2, page=16, max_pages=256,
            e=e)
        lens = torch.tensor([1, 17, 300, 1000, 1777, 2500, 3100, 3600],
                            dtype=torch.int32, device=cuda)

        def call():
            return pdec.paged_decode_attention_flat(q, k, v, table, lens,
                                                    **sc)
    elif kernel.startswith("decode"):
        s_len, kv = 8256, [1, 300, 2060, 8207]
        q = _bf16(g, len(kv) * hkv, 2, e)
        k, v, sc = _dense_bf16_kv(g, quantized, len(kv) * hkv, s_len, e)
        lens = torch.tensor(kv, dtype=torch.int32,
                            device=cuda).repeat_interleave(hkv)

        def call():
            return dec.decode_attention_flat(q, k, v, lens, **sc)
    else:
        b, page, max_pages, spec = 8, 16, 256, 4
        _, k, v, table, sc = _paged_decode_bf16_inputs(
            g, quantized, b=b, hkv=hkv, group=2, page=page,
            max_pages=max_pages, e=e)
        lens = torch.tensor([1, 17, 300, 1000, 1777, 2500, 3100, 3600],
                            dtype=torch.int32, device=cuda)
        starts = (lens - lens.clamp(max=spec)).contiguous()
        q = _bf16(g, b, hkv, spec * 2, e)

        def call():
            return pver.paged_verify_attention_flat(q, k, v, table, lens,
                                                    starts, spec=spec, **sc)
    first = call()
    outs = [call() for _ in range(300)]
    torch.cuda.synchronize()
    assert bool(first.isfinite().all())
    assert all(torch.equal(first, out) for out in outs)


def test_bf16_decode_kernels_refuse_what_they_do_not_take(cuda):
    """A bf16-q decode, paged decode or verify, on bf16 or int8 caches,
    runs the tensor-core kernels or raises: head dim 32, more than 16
    heads a group or 32 rows a kv head, and operands off 16-byte alignment
    reach no kernel."""
    g = torch.Generator(device=cuda).manual_seed(42)
    lens = torch.tensor([10, 20], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    # B4, on bf16 caches and on int8 caches with per-row scales
    for e, group, match in ((32, 2, "bf16"), (128, 17, "G=17")):
        q, k = _bf16(g, 2, group, e), _bf16(g, 2, 64, e)
        k8, s8 = quantize_q8(k.float(), -1)
        with pytest.raises(ValueError, match=match):
            dec.decode_attention_flat(q, k, k, lens)
        with pytest.raises(ValueError, match=match):
            dec.decode_attention_flat(q, k8, k8, lens, k_scale=s8,
                                      v_scale=s8)
    q = _bf16(g, 2 * 2 * 128 + 1)[1:].view(2, 2, 128)
    with pytest.raises(ValueError, match="aligned"):
        dec.decode_attention_flat(q, k, k, lens)
    with pytest.raises(ValueError, match="aligned"):
        dec.decode_attention_flat(q, k8, k8, lens, k_scale=s8, v_scale=s8)
    # B7, on bf16 pools and on int8 pools with per-page scales
    table = torch.arange(16, dtype=torch.int32, device=cuda).view(2, 8)
    starts = lens - 1
    for e, spec, group, match in ((32, 2, 2, "bf16"), (128, 8, 8, "rows"),
                                  (128, 1, 32, "G=32")):
        pool = _bf16(g, 2, 17, 16, e)
        pool8, sc8 = quantize_q8(pool.float(), (-2, -1))
        q = _bf16(g, 2, 2, spec * group, e)
        with pytest.raises(ValueError, match=match):
            pver.paged_verify_attention_flat(q, pool, pool, table, lens,
                                             starts, spec=spec)
        with pytest.raises(ValueError, match=match):
            pver.paged_verify_attention_flat(q, pool8, pool8, table, lens,
                                             starts, spec=spec,
                                             k_scales=sc8, v_scales=sc8)
    q = _bf16(g, 2 * 2 * 8 * 128 + 1)[1:].view(2, 2, 8, 128)
    with pytest.raises(ValueError, match="aligned"):
        pver.paged_verify_attention_flat(q, pool, pool, table, lens, starts,
                                         spec=4)
    with pytest.raises(ValueError, match="aligned"):
        pver.paged_verify_attention_flat(q, pool8, pool8, table, lens,
                                         starts, spec=4, k_scales=sc8,
                                         v_scales=sc8)
    # B6, on bf16 pools and on int8 pools with a bf16 q
    for e, group, match in ((32, 2, "bf16"), (128, 17, "G=17")):
        pool = _bf16(g, 2, 17, 16, e)
        (pool8, sc8) = quantize_q8(pool.float(), (-2, -1))
        q = _bf16(g, 2, 2, group, e)
        with pytest.raises(ValueError, match=match):
            pdec.paged_decode_attention_flat(q, pool, pool, table, lens)
        with pytest.raises(ValueError, match=match):
            pdec.paged_decode_attention_flat(q, pool8, pool8, table, lens,
                                             k_scales=sc8, v_scales=sc8)
    q = _bf16(g, 2 * 2 * 2 * 128 + 1)[1:].view(2, 2, 2, 128)
    with pytest.raises(ValueError, match="aligned"):
        pdec.paged_decode_attention_flat(q, pool, pool, table, lens)
    assert sum(ops.launch_counts().values()) == 0


def _paged_pools(gen, hkv=2, n_pages=64, page=16, e=64, quantized=False):
    """Pools and a shuffled (6, 8) page table over them; int8 pools come
    with their per-page scales, (k, v, table, k_scales, v_scales)."""
    k, v = _rand(gen, hkv, n_pages, page, e), _rand(gen, hkv, n_pages, page, e)
    perm = torch.randperm(n_pages - 1, generator=gen, device=gen.device) + 1
    table = perm[:6 * 8].view(6, 8).to(torch.int32).contiguous()
    if not quantized:
        return k, v, table
    (k, ks), (v, vs) = quantize_q8(k, (-2, -1)), quantize_q8(v, (-2, -1))
    return k, v, table, ks, vs


def test_paged_decode_kernel_int8_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    k, v, table, ks, vs = _paged_pools(g, quantized=True)
    lens = torch.tensor([0, 1, 9, 16, 65, 128], dtype=torch.int32,
                        device=cuda)
    q = _rand(g, 6, 2, 2, 64)
    got = pdec.paged_decode_attention_flat(q, k, v, table, lens, k_scales=ks,
                                           v_scales=vs)
    n_split, tps = dec.split_plan(12, 8 * 16)
    want = pdec.paged_decode_attention_plain(q, k, v, table, lens,
                                             n_split=n_split,
                                             tiles_per_split=tps,
                                             k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


@pytest.mark.parametrize("q0,kv_len,chunk", [(0, 64, 64), (64, 121, 64),
                                             (0, 0, 32)])
def test_paged_prefill_kernel_int8_matches_plain(cuda, q0, kv_len, chunk):
    g = torch.Generator(device=cuda).manual_seed(14)
    k, v, table, ks, vs = _paged_pools(g, quantized=True)
    q = _rand(g, 4, chunk, 64)
    kw = dict(blk_q=32, k_scales=ks, v_scales=vs)
    span = _span(q0, kv_len, cuda)
    got = _no_host_sync(lambda: ppre.paged_prefill_attention_flat(
        q, k, v, table[2], span, **kw))
    want = ppre.paged_prefill_attention_plain(q, k, v, table[2], span, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("spec,group", [(1, 2), (4, 2), (3, 4), (8, 4)])
def test_paged_verify_kernel_matches_plain(cuda, quantized, spec, group):
    g = torch.Generator(device=cuda).manual_seed(15)
    k, v, table, *scales = _paged_pools(g, quantized=quantized)
    kw = dict(zip(("k_scales", "v_scales"), scales))
    # ragged rows (k, 1, 0, k, part, k): a start mid-page, one straddling
    # a 64-row tile, kv_len 0 and a block ending at the table's capacity
    starts = torch.tensor([5, 63, 0, 60, 100, 128 - spec], dtype=torch.int32,
                          device=cuda)
    rows = torch.tensor([spec, 1, 0, spec, max(spec - 1, 1), spec],
                        dtype=torch.int32, device=cuda)
    lens = starts + rows
    q = _rand(g, 6, 2, spec * group, 64)
    got = pver.paged_verify_attention_flat(q, k, v, table, lens, starts,
                                           spec=spec, **kw)
    n_split, tps = dec.decode_split_plan(q.dtype, 12, 8 * 16)
    want = pver.paged_verify_attention_plain(
        q, k, v, table, lens, starts, spec=spec, n_split=n_split,
        tiles_per_split=tps, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL
    assert float(got[2].abs().max()) == 0.0       # kv_len 0 gives zeros
    if spec == 1:      # one position is B6 exactly
        dec1 = pdec.paged_decode_attention_flat(q, k, v, table, lens, **kw)
        assert torch.equal(got, dec1)


def test_paged_decode_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    k, v, table = _paged_pools(g)
    lens = torch.tensor([0, 1, 9, 16, 65, 128], dtype=torch.int32,
                        device=cuda)
    q = _rand(g, 6, 2, 2, 64)
    got = pdec.paged_decode_attention_flat(q, k, v, table, lens)
    n_split, tps = dec.split_plan(12, 8 * 16)
    want = pdec.paged_decode_attention_plain(q, k, v, table, lens,
                                             n_split=n_split,
                                             tiles_per_split=tps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL
    assert float(got[0].abs().max()) == 0.0       # kv_len 0 gives zeros


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("q0,kv_len,chunk", [(0, 64, 64), (64, 121, 64),
                                             (32, 33, 32), (0, 0, 32)])
def test_paged_prefill_kernel_matches_plain(cuda, group, q0, kv_len, chunk):
    g = torch.Generator(device=cuda).manual_seed(4)
    k, v, table = _paged_pools(g)
    q = _rand(g, 2 * group, chunk, 64)
    span = _span(q0, kv_len, cuda)
    got = _no_host_sync(lambda: ppre.paged_prefill_attention_flat(
        q, k, v, table[2], span, blk_q=32))
    want = ppre.paged_prefill_attention_plain(q, k, v, table[2], span,
                                              blk_q=32)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def _smoke_on_both(cuda):
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"), attn_impl="kernel",
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    gpu_params = {"embed": cpu_params["embed"].to(cuda),
                  "final_norm": cpu_params["final_norm"].to(cuda),
                  "layers": [{blk: {k: t.to(cuda) for k, t in p.items()}
                              for blk, p in layer.items()}
                             for layer in cpu_params["layers"]]}
    return cfg, model, cpu_params, gpu_params


def test_continuous_engine_on_the_card_matches_the_cpu(cuda):
    cfg, model, cpu_params, gpu_params = _smoke_on_both(cuda)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=6, eos_id=-1)
            for i, n in enumerate([7, 30, 90, 5])]
    kw = dict(max_len=128, batch_size=2, page_size=16, chunk_size=32)
    ops.reset_launch_counts()
    eng = ContinuousBatchingEngine(model, gpu_params, device=cuda,
                                   decode_reserve_frac=0.5, **kw)
    eng.injector = ScriptedFaults(exhaust_at_appends=frozenset({3}))
    eng.auditor = PoolAuditor()
    on_gpu = eng.serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ContinuousBatchingEngine(model, cpu_params, device="cpu",
                                      **kw).serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    assert eng.preemption_count >= 1
    assert counts["paged_prefill"] > 0 and counts["paged_decode"] > 0


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg, model, cpu_params, gpu_params = _smoke_on_both(cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=6, eos_id=-1)
            for i, n in enumerate([7, 7, 30])]
    ops.reset_launch_counts()
    on_gpu = ServingEngine(model, gpu_params, max_len=64, batch_size=2,
                           device=cuda).serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ServingEngine(model, cpu_params, max_len=64, batch_size=2,
                           device="cpu").serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    assert counts["mas_resident"] > 0 and counts["decode"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_speculative_engine_on_the_card_matches_the_cpu(cuda, kv_dtype):
    cfg, model, cpu_params, gpu_params = _smoke_on_both(cuda)
    rng = np.random.default_rng(2)
    # prompts that tile a short span, so the drafter finds matches
    reqs = [Request(rid=i, prompt=np.resize(
                rng.integers(3, cfg.vocab_size, size=(5,)), n)
                .astype(np.int32), max_new_tokens=8, eos_id=-1)
            for i, n in enumerate([7, 30, 90, 5])]
    kw = dict(max_len=128, batch_size=2, page_size=16, chunk_size=32,
              kv_dtype=kv_dtype)
    ops.reset_launch_counts()
    eng = ContinuousBatchingEngine(model, gpu_params, device=cuda,
                                   spec_depth=4, **kw)
    eng.auditor = PoolAuditor()
    on_gpu = eng.serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ContinuousBatchingEngine(model, cpu_params, device="cpu",
                                      **kw).serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    branch = "_int8" if kv_dtype else ""
    assert counts["paged_verify" + branch] > 0
    assert counts["paged_prefill" + branch] > 0


def test_int8_wave_engine_on_the_card_matches_the_cpu(cuda):
    cfg, model, cpu_params, gpu_params = _smoke_on_both(cuda)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=6, eos_id=-1)
            for i, n in enumerate([7, 7, 30])]
    kw = dict(max_len=64, batch_size=2, kv_dtype="int8")
    ops.reset_launch_counts()
    on_gpu = ServingEngine(model, gpu_params, device=cuda, **kw).serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ServingEngine(model, cpu_params, device="cpu", **kw).serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    assert counts["decode_int8"] > 0 and counts["decode"] == 0


def _row_rel(got, want) -> float:
    err = (got.float() - want.float()).norm(dim=-1)
    return float((err / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def _ssd_cells(gen, bh, nc, q, p, n, dtype=torch.float32, a_scale=0.01):
    """B8's inputs: x, b, c ~ N(0, 1); a = -a_scale softplus(N(0, 1)) A_h
    with A_h = linspace(1, 16) over 24 heads (1% of the model's decay:
    every off-diagonal tile counts)."""
    a_h = torch.linspace(1.0, 16.0, 24, device=gen.device).repeat(
        -(-bh // 24))[:bh]
    a = -a_scale * torch.nn.functional.softplus(
        _rand(gen, bh, nc, q)) * a_h[:, None, None]
    return (_rand(gen, bh, nc, q, p).to(dtype), a,
            _rand(gen, bh, nc, q, n).to(dtype),
            _rand(gen, bh, nc, q, n).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_at_full_width_cells(cuda, dtype):
    """The 4 x 2048 wave's 768 cells (96 heads of 8 chunks of 256 rows,
    head_dim 64, d_state 128), at the model's decay and at 1% of it."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for a_scale in (1.0, 0.01):
        x, a, b, c = _ssd_cells(g, 96, 8, 256, 64, 128, dtype, a_scale)
        ops.reset_launch_counts()
        got = ssd.ssd_intra_chunk(x, a, b, c)
        assert ops.launch_counts()["ssd_intra_chunk"] == 1
        want = ssd.ssd_intra_chunk_plain(x, a, b, c)
        torch.cuda.synchronize()
        for g_t, w_t in zip(got, want):
            assert g_t.dtype == torch.float32
            assert _row_rel(g_t, w_t) <= SSD_ROW_RTOL


@pytest.mark.parametrize("q,p,n", [(100, 16, 16), (64, 64, 128), (1, 8, 8),
                                   (320, 32, 64)])
def test_ssd_kernel_matches_plain_on_ragged_chunks(cuda, q, p, n):
    g = torch.Generator(device=cuda).manual_seed(9)
    x, a, b, c = _ssd_cells(g, 5, 3, q, p, n)
    got = ssd.ssd_intra_chunk(x, a, b, c)
    want = ssd.ssd_intra_chunk_plain(x, a, b, c)
    torch.cuda.synchronize()
    for g_t, w_t in zip(got, want):
        assert _row_rel(g_t, w_t) <= SSD_ROW_RTOL


@pytest.mark.parametrize("length", [600, 100, 512])
def test_ssd_chunked_kernel_matches_plain_scan(cuda, length):
    """A ragged tail padded to a whole chunk (600 = 2 x 256 + 88), a prompt
    shorter than the chunk, and whole chunks; with an initial state."""
    g = torch.Generator(device=cuda).manual_seed(10)
    bsz, h, p, n = 2, 4, 64, 128
    x, a, b, c = _ssd_cells(g, bsz, length, h, p, n)  # (B, L, H, F)
    s0 = 0.1 * _rand(g, bsz, h, p, n)
    chunk = min(256, length)
    got = ssd.ssd_chunked_kernel(x, a, b, c, chunk, initial_state=s0)
    want = ssm.ssd_chunked(x, a, b, c, chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert got[0].shape == (bsz, length, h, p)
    for g_t, w_t in zip(got, want):
        assert _row_rel(g_t, w_t) <= SSD_ROW_RTOL


@pytest.mark.parametrize("q,p,n", [(100, 16, 16), (32, 16, 16),
                                   (256, 64, 128), (200, 40, 24)])
@pytest.mark.parametrize("a_scale", [1.0, 0.01])
def test_ssd_bf16_kernel_matches_plain(cuda, q, p, n, a_scale):
    """The tensor-core form: a chunk shorter than the tile set and not a
    multiple of 16, one of 32 rows (N = P = 16), a whole 256-row chunk,
    and N, P that are multiples of 8 but not of 16; at the model's decay
    and at 1% of it. Nothing on its launch path reads the device."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x, a, b, c = _ssd_cells(g, 6, 3, q, p, n, torch.bfloat16, a_scale)
    ops.reset_launch_counts()
    got = _no_host_sync(lambda: ssd.ssd_intra_chunk(x, a, b, c))
    assert ops.launch_counts()["ssd_intra_chunk"] == 1
    want = ssd.ssd_intra_chunk_plain(x, a, b, c)
    torch.cuda.synchronize()
    for g_t, w_t in zip(got, want):
        assert g_t.dtype == torch.float32
        assert _row_rel(g_t, w_t) <= SSD_ROW_RTOL


@pytest.mark.parametrize("bh,nc,q", [(96, 8, 256), (7, 3, 100), (1, 1, 256),
                                     (200, 2, 192)])
def test_ssd_bf16_kernel_gives_the_same_bits_launch_after_launch(
        cuda, bh, nc, q):
    """The tensor-core form is persistent: a block walks several cells and
    its warpgroups hand each tile set's slot on to the next set's copies.
    Forty launches back to back give the same bits as the first, which
    holds to the plain version: more cells than blocks (768, 400), fewer
    (21), one."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x, a, b, c = _ssd_cells(g, bh, nc, q, 64, 128, torch.bfloat16, 1.0)
    first = ssd.ssd_intra_chunk(x, a, b, c)
    for _ in range(40):
        got = ssd.ssd_intra_chunk(x, a, b, c)
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    want = ssd.ssd_intra_chunk_plain(x, a, b, c)
    for f_t, w_t in zip(first, want):
        assert _row_rel(f_t, w_t) <= SSD_ROW_RTOL


def test_ssd_bf16_kernel_refuses_a_chunk_past_256_rows(cuda):
    g = torch.Generator(device=cuda).manual_seed(13)
    x, a, b, c = _ssd_cells(g, 2, 1, 512, 64, 128, torch.bfloat16)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="Q <= 256"):
        ssd.ssd_intra_chunk(x, a, b, c)
    assert ops.launch_counts()["ssd_intra_chunk"] == 0
    # the fp32 form takes it
    got = ssd.ssd_intra_chunk(x.float(), a, b.float(), c.float())
    want = ssd.ssd_intra_chunk_plain(x.float(), a, b.float(), c.float())
    torch.cuda.synchronize()
    for g_t, w_t in zip(got, want):
        assert _row_rel(g_t, w_t) <= SSD_ROW_RTOL


def test_ssd_limit_rejects_a_zeroed_x_tile(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    x, a, b, c = _ssd_cells(g, 24, 2, 256, 64, 128, torch.bfloat16, 1.0)
    got = ssd.ssd_intra_chunk(x, a, b, c)
    bad = x.clone()
    bad[7, 1, 192:256] = 0
    faulty = ssd.ssd_intra_chunk_plain(bad, a, b, c)
    torch.cuda.synchronize()
    for g_t, f_t in zip(got, faulty):
        assert _row_rel(g_t, f_t) > 100 * SSD_ROW_RTOL


def test_mamba2_wave_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_smoke("mamba2-130m"), attn_impl="kernel",
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in cpu_params["layers"]:       # varied tokens
        for key in ("norm", "gate_norm"):
            layer["ssd"][key] = 2.0 * torch.randn(
                layer["ssd"][key].shape, generator=gen)
    gpu_params = {"embed": cpu_params["embed"].to(cuda),
                  "final_norm": cpu_params["final_norm"].to(cuda),
                  "layers": [{"ssd": {k: t.to(cuda) for k, t in
                                      layer["ssd"].items()}}
                             for layer in cpu_params["layers"]]}
    rng = np.random.default_rng(4)
    # 40 rows at chunk 32: a ragged tail; 64: two whole chunks
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=6, eos_id=-1)
            for i, n in enumerate([40, 40, 64, 7])]
    ops.reset_launch_counts()
    on_gpu = ServingEngine(model, gpu_params, max_len=80, batch_size=2,
                           device=cuda).serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ServingEngine(model, cpu_params, max_len=80, batch_size=2,
                           device="cpu").serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    # one launch a layer a wave: three waves (40 x 2, 64, 7)
    assert counts["ssd_intra_chunk"] == 3 * cfg.num_layers
