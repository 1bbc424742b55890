"""The rounding of the bf16 tensor-core kernels (the bf16 forms of B1,
B2, B3, B4, B5, B6 and B7), and of a tensor-core B8, emulated on the CPU
and held to their plain versions.

The kernels read Q, K and V in bf16, sum S = Q K^T in fp32 (exact bf16
products, fp32 sums), feed P to P·V as bf16 and round the output to bf16.
``chip_smoke.py`` holds them to the plain versions on the card per output
row: the L2 error of a row within 4e-3 of the row's norm. This file
emulates those rounding points in PyTorch, on inputs made with numpy from
a seed, at head_dim 128 and a few hundred keys, and predicts the row
error on the card:

* P as one bf16 product moves a row by about the limit itself: a bf16
  rounding of P is up to 2^-8 of it, and the output's own rounding to
  bf16 turns such a shift into a whole bf16 step of some elements;
* P as two bf16 products, hi = bf16(P) and lo = bf16(P - hi), which is
  what the kernels do (``csrc/mma.cuh``), leaves room under the limit.

B1 and B2 share one emulation (MAS: the fp32 score row, one exact
softmax), held to the plain version at B1's block height (32) and B2's
(16). At head dim 256 (recurrentgemma-9b) B3 is emulated windowed (16
query heads on one kv head, a 100-token window over 320 keys: its two
warpgroups each compute S whole and one half of the output columns,
which rounds as one warpgroup would), and B4 at G = 16 on four
sequences over a full ring of 2048 rows, bf16 and int8. B5 is B3's online softmax over a chunk at a ``q_offset`` of a
paged pool; on an int8 pool its tiles hold the int8 values as bf16
(exact: every value in -127..127 has 8 significant bits), the K scale
multiplies the score and the V scale multiplies P after the row sum and
before the split. B4, B6 and B7 (``csrc/decode_tc.cuh``) cut the keys
into short splits of 1-4 64-row tiles (``decode_split_plan``); each of a
block's four warps walks 16-row slices with an online softmax of its
own, the block merges its warps and a second pass the splits, in fp32.
B4's case is one query row on each of 32 (b, kv head) rows over 1900
live keys of a 2000-row cache, B7's eight position-major rows (k = 4,
G = 2) ending at 1000 keys of shuffled 16-row pages, B6's two rows (G =
2) over 1900 keys of shuffled 16-row pages; each on bf16 K/V and on int8
K/V (B4 with one scale a cache row, B6 and B7 one a page): an int8
slice holds the int8 values as bf16, the K scale of each column
multiplies the score and the V scale multiplies P after the row sum and
before the split. The int8 cases' fault is a zeroed V scale: a 64-row
tile's rows for B4, a page for B6 and B7.

B8 (the SSD intra-chunk step) in bf16 runs on the tensor cores and is
held to a tighter limit, 1e-4 of each output row's norm
(``tests/test_torch_cuda.py``): S = C B^T is exact, and S . L (in y's
product with X) and the decay-scaled x (in the state's product with
B^T) round once to bf16 (about 4e-3 and 2e-3: they fail it) or enter as
hi + lo (under 1e-5), at the model's decay and at 1% of it; the form as
built, S summed in k16 steps with its diagonal summed apart in k order,
fits it too.

Run as a script, it prints the row errors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mas_attention as tmas
from repro_torch.kernels import paged_decode_attention as tpdec
from repro_torch.kernels import paged_prefill_attention as tppre
from repro_torch.kernels import paged_verify_attention as tpver
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.common import (
    NEG_INF,
    gather_pages,
    page_scales,
    quantize_q8,
)

BF16_ROW_RTOL = 4e-3     # chip_smoke.py's per-row limit for bf16 kernels
N, E, HEADS, BLK_KV = 320, 128, 4, 64


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((HEADS, N, E),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _pv(p, v, split: bool):
    """P V with P rounded to bf16 (one product) or as hi + lo (two)."""
    hi = p.to(torch.bfloat16).float()
    out = hi @ v.float()
    if split:
        out = out + (p - hi).to(torch.bfloat16).float() @ v.float()
    return out


def _causal_scores(q, k):
    s = (q.float() @ k.float().transpose(1, 2)) * E ** -0.5
    keep = torch.ones(N, N, dtype=torch.bool).tril()
    return torch.where(keep, s, NEG_INF)


def mas_emulated(q, k, v, *, split: bool):
    """B2's bf16 form: the fp32 score row, one exact softmax (P = exp(s -
    m) over the row, its sum l), P V divided by l."""
    s = _causal_scores(q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (_pv(p, v, split) / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)


def online_emulated(q, k, v, *, split: bool, q_offset: int = 0,
                    kv_len: int = N, k_scale=None, v_scale=None,
                    window: int | None = None):
    """B3's and B5's bf16 forms: online max and sum over 64-column tiles,
    query row i at position q_offset + i seeing the keys at positions <=
    it (and, with ``window``, after it - window) and below kv_len; P =
    exp(s - m) unnormalized into P V (times the column's V scale after
    the row sum, before the split), the sum l taken from fp32 P. k, v:
    (H, S, E) bf16 values (int8 values held as bf16 for an int8 pool),
    scales (H, S) per column."""
    heads, nq, e = q.shape
    s_all = (q.float() @ k.float().transpose(1, 2)) * e ** -0.5
    if k_scale is not None:
        s_all = s_all * k_scale[:, None, :]
    rows = torch.arange(nq).view(nq, 1) + q_offset
    cols = torch.arange(k.shape[1]).view(1, -1)
    keep = (cols <= rows) & (cols < kv_len)
    if window is not None:
        keep = keep & (cols > rows - window)
    s_all = torch.where(keep, s_all, NEG_INF)
    m = torch.full((heads, nq, 1), NEG_INF)
    l = torch.zeros((heads, nq, 1))
    acc = torch.zeros((heads, nq, e))
    for c0 in range(0, -(-kv_len // BLK_KV) * BLK_KV, BLK_KV):
        s = s_all[..., c0:c0 + BLK_KV]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale[:, None, c0:c0 + BLK_KV]
        acc = acc * alpha + _pv(p, v[:, c0:c0 + BLK_KV], split)
        m = m_new
    return (acc / l).to(torch.bfloat16)


def flash_emulated(q, k, v, *, split: bool):
    """B3's bf16 form over the causal (N, N) call."""
    return online_emulated(q, k, v, split=split)


# B5's case: a 128-row chunk at q_offset 200 of a 320-row sequence on
# shuffled 16-row pages, GQA group 1
PAGE, Q0, CHUNK = 16, 192, 128


def _paged_inputs(seed: int, quantized: bool):
    """q (HEADS, CHUNK, E) bf16; pools (HEADS, pages, PAGE, E), bf16 or
    int8 with per-page scales; a shuffled table covering N rows."""
    rng = np.random.default_rng(seed)
    n_pages = N // PAGE + 1
    q = torch.from_numpy(rng.standard_normal((HEADS, CHUNK, E),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal(
        (HEADS, n_pages, PAGE, E), dtype=np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.permutation(n_pages - 1)[:N // PAGE] + 1
                             ).to(torch.int32)
    if not quantized:
        return q, k.bfloat16(), v.bfloat16(), table, {}
    (k, ks), (v, vs) = quantize_q8(k, (-2, -1)), quantize_q8(v, (-2, -1))
    return q, k, v, table, {"k_scales": ks, "v_scales": vs}


def paged_emulated(q, k_pages, v_pages, table, *, split: bool,
                   k_scales=None, v_scales=None):
    """B5's bf16 form: the pages gathered through the table (int8 values
    as bf16), then the online step of ``online_emulated``."""
    k = gather_pages(k_pages, table).bfloat16()
    v = gather_pages(v_pages, table).bfloat16()
    ks = vs = None
    if k_scales is not None:
        ks = page_scales(k_scales, table, PAGE)
        vs = page_scales(v_scales, table, PAGE)
    return online_emulated(q, k, v, split=split, q_offset=Q0, kv_len=N,
                           k_scale=ks, v_scale=vs)


# B4's and B7's cases: B4's (b, kv head) rows, keys of its cache and live
# keys; B7's live keys, k and G
DEC_BH, DEC_S, DEC_LEN = 32, 2000, 1900
VER_LEN, VER_SPEC, VER_G = 1000, 4, 2
SLICE, WARPS = 16, 4


def _merge(parts):
    """(m, l, acc) partials merged: M = max m, L = sum l e^(m - M),
    acc = sum acc e^(m - M)."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    w = [torch.exp(p[0] - m) for p in parts]
    return (m, sum(p[1] * wi for p, wi in zip(parts, w)),
            sum(p[2] * wi for p, wi in zip(parts, w)))


def split_emulated(q, k, v, *, split: bool, kv_len: int, tiles: int,
                   q_pos=None, k_scale=None, v_scale=None):
    """B4's, B6's and B7's bf16 forms: q (H, R, E), k, v (H, S, E) bf16
    (an int8 pool's values held as bf16, with (H, S) per-column scales);
    row r sees the keys below kv_len (and at or before q_pos[r]). Splits
    of ``tiles`` 64-row tiles (``decode_split_plan``'s); warp w of a
    split takes its 16-row slices w, w + 4, ..., each with an online
    softmax whose P (zero where masked; times the column's V scale after
    the row sum) enters P V as one bf16 product or as hi + lo; the warps,
    then the splits, are merged in fp32, and the output rounded to
    bf16."""
    heads, rows, e = q.shape
    s_all = (q.float() @ k.float().transpose(1, 2)) * e ** -0.5
    if k_scale is not None:
        s_all = s_all * k_scale[:, None, :]
    cols = torch.arange(k.shape[1]).view(1, -1)
    keep = cols < kv_len
    if q_pos is not None:
        keep = keep & (cols <= q_pos.view(-1, 1))
    s_all = torch.where(keep, s_all, NEG_INF)
    span = tiles * BLK_KV
    splits = []
    for row0 in range(0, kv_len, span):
        warps = []
        for w in range(WARPS):
            m = torch.full((heads, rows, 1), NEG_INF)
            l = torch.zeros((heads, rows, 1))
            acc = torch.zeros((heads, rows, e))
            for c0 in range(row0 + w * SLICE, min(row0 + span, kv_len),
                            WARPS * SLICE):
                s = s_all[..., c0:c0 + SLICE]
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.where(s == NEG_INF, 0.0, torch.exp(s - m_new))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                if v_scale is not None:
                    p = p * v_scale[:, None, c0:c0 + SLICE]
                acc = acc * alpha + _pv(p, v[:, c0:c0 + SLICE], split)
                m = m_new
            warps.append((m, l, acc))
        splits.append(_merge(warps))
    _, l, acc = _merge(splits)
    return (acc / l).to(torch.bfloat16)


def _kv_pair(rng, shape, quantized: bool, dims):
    """K and V of ``shape`` from ``rng``: bf16, or int8 quantized over
    ``dims`` with their scales ({} for bf16)."""
    k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(2))
    if not quantized:
        return k.bfloat16(), v.bfloat16(), {}
    (k, ks), (v, vs) = quantize_q8(k, dims), quantize_q8(v, dims)
    return k, v, {"k_scales": ks, "v_scales": vs}


# B3's and B4's cases at head dim 256 (recurrentgemma-9b): 16 query heads
# on one kv head; B3 over 320 keys under a 100-token window, B4 on four
# sequences over a full ring of 2048 rows
E256, G256, WINDOW256, RING, RING_BH = 256, 16, 100, 2048, 4


def _flash_e256_case(seed: int):
    """B3's head-dim-256 case: (emulate, plain output, (v, {}))."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((G256, N, E256),
                                             dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((1, N, E256),
                                                 dtype=np.float32))
            .bfloat16() for _ in range(2))
    want = tflash.flash_attention_plain(q, k, v, blk_q=64, blk_kv=BLK_KV,
                                        causal=True, window=WINDOW256)

    def emulate(split, v_=None, vs=None):
        vv = v if v_ is None else v_
        return online_emulated(q, k.expand(G256, -1, -1),
                               vv.expand(G256, -1, -1), split=split,
                               window=WINDOW256)
    return emulate, want, (v, {})


def _decode_case(seed: int, quantized: bool, e: int = E):
    """B4's case on a bf16 cache or an int8 cache with per-row scales, at
    head dim 128 (one query row on each of 32 (b, kv head) rows) or 256
    (G = 16 query rows on each of 4 over a full ring): (emulate, plain
    version's output, (v, scales))."""
    rng = np.random.default_rng(seed)
    bh, g, s_len, kv_len = ((DEC_BH, 1, DEC_S, DEC_LEN) if e == E
                            else (RING_BH, G256, RING, RING))
    q = torch.from_numpy(rng.standard_normal((bh, g, e),
                                             dtype=np.float32)).bfloat16()
    k, v, sc = _kv_pair(rng, (bh, s_len, e), quantized, -1)
    lens = torch.full((bh,), kv_len, dtype=torch.int32)
    n_split, tps = tdec.decode_split_plan(q.dtype, bh, s_len)
    want = tdec.decode_attention_plain(
        q, k, v, lens, n_split=n_split, tiles_per_split=tps,
        k_scale=sc.get("k_scales"), v_scale=sc.get("v_scales"))

    def emulate(split, v_=None, vs=None):
        kw = {}
        if quantized:
            kw = {"k_scale": sc["k_scales"],
                  "v_scale": sc["v_scales"] if vs is None else vs}
        return split_emulated(q, k.bfloat16(),
                              (v if v_ is None else v_).bfloat16(),
                              split=split, kv_len=kv_len, tiles=tps, **kw)
    return emulate, want, (v, sc)


def _paged_split_case(seed: int, quantized: bool, spec: int, kv_len: int):
    """B6's (spec 0: G rows seeing the live context) or B7's (spec k: k G
    position-major rows, the last k positions ending at kv_len) case on
    shuffled 16-row pages, bf16 or int8 with per-page scales: (emulate,
    plain output, (v_pages, scales))."""
    rng = np.random.default_rng(seed)
    n_pages = kv_len // PAGE + (3 if spec else 8)
    rows = max(spec, 1) * VER_G
    q = torch.from_numpy(rng.standard_normal((1, HEADS, rows, E),
                                             dtype=np.float32)).bfloat16()
    k, v, sc = _kv_pair(rng, (HEADS, n_pages, PAGE, E), quantized, (-2, -1))
    table = torch.from_numpy(rng.permutation(n_pages - 1) + 1).to(
        torch.int32)[None]
    lens = torch.tensor([kv_len], dtype=torch.int32)
    n_split, tps = tdec.decode_split_plan(q.dtype, HEADS,
                                          table.shape[1] * PAGE)
    q_pos = None
    if spec:
        starts = lens - spec
        want = tpver.paged_verify_attention_plain(
            q, k, v, table, lens, starts, spec=spec, n_split=n_split,
            tiles_per_split=tps, **sc)[0]
        q_pos = tpver.row_positions(starts, spec, VER_G)[0]
    else:
        want = tpdec.paged_decode_attention_plain(
            q, k, v, table, lens, n_split=n_split, tiles_per_split=tps,
            **sc)[0]

    def emulate(split, v_=None, vs=None):
        kw = {}
        if quantized:
            kw = {"k_scale": page_scales(sc["k_scales"], table[0], PAGE),
                  "v_scale": page_scales(sc["v_scales"] if vs is None
                                         else vs, table[0], PAGE)}
        vp = v if v_ is None else v_
        return split_emulated(q[0], gather_pages(k, table[0]).bfloat16(),
                              gather_pages(vp, table[0]).bfloat16(),
                              split=split, kv_len=kv_len, tiles=tps,
                              q_pos=q_pos, **kw)
    return emulate, want, (v, sc)


def row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


KERNELS = ["mas", "mas_resident", "flash", "paged", "paged_int8", "decode",
           "decode_int8", "verify", "verify_int8", "paged_decode",
           "paged_decode_int8", "flash_e256", "decode_e256",
           "decode_e256_int8"]


def _case(kernel: str, seed: int):
    """(emulate(split, v=None, v_scales=None), plain version's output,
    (v, scales)) of ``kernel`` on the inputs of ``seed``."""
    quantized = kernel.endswith("_int8")
    if kernel == "flash_e256":
        return _flash_e256_case(seed)
    if kernel.startswith("decode"):
        return _decode_case(seed, quantized,
                            E256 if "e256" in kernel else E)
    if kernel.startswith("verify"):
        return _paged_split_case(seed, quantized, VER_SPEC, VER_LEN)
    if kernel.startswith("paged_decode"):
        return _paged_split_case(seed, quantized, 0, DEC_LEN)
    if kernel.startswith("paged"):
        q, k, v, table, sc = _paged_inputs(seed, quantized)
        want = tppre.paged_prefill_attention_plain(
            q, k, v, table, torch.tensor([Q0, N], dtype=torch.int32),
            blk_q=64, **sc)

        def emulate(split, v_=None, vs=None):
            kw = dict(sc, v_scales=vs) if vs is not None else sc
            return paged_emulated(q, k, v if v_ is None else v_, table,
                                  split=split, **kw)
        return emulate, want, (v, sc)
    q, k, v = _inputs(seed)
    if kernel.startswith("mas"):
        blk_q = 32 if kernel == "mas_resident" else 16
        want = tmas.mas_attention_plain(q, k, v, blk_q=blk_q, blk_kv=BLK_KV,
                                        causal=True)
        fn = mas_emulated
    else:
        want = tflash.flash_attention_plain(q, k, v, blk_q=64,
                                            blk_kv=BLK_KV, causal=True)
        fn = flash_emulated

    def emulate(split, v_=None, vs=None):
        return fn(q, k, v if v_ is None else v_, split=split)
    return emulate, want, (v, {})


def emulated_errors(kernel: str) -> dict[str, float]:
    """Row error of the emulation against the plain version, with P in one
    bf16 product and as hi + lo."""
    emulate, want, _ = _case(kernel, 0)
    return {kind: row_rel_err(emulate(kind == "hi_lo"), want)
            for kind in ("bf16", "hi_lo")}


@pytest.mark.parametrize("kernel", KERNELS)
def test_hi_lo_p_fits_the_bf16_row_limit_with_room(kernel):
    errs = emulated_errors(kernel)
    assert 0 < errs["hi_lo"] <= BF16_ROW_RTOL / 2, errs
    # one bf16 product of P moves rows by several times more
    assert errs["bf16"] > 2 * errs["hi_lo"], errs


@pytest.mark.parametrize("kernel", KERNELS)
def test_emulation_sees_a_skipped_v_tile(kernel):
    emulate, _, (v, sc) = _case(kernel, 1)
    want = emulate(True)
    if kernel.endswith("_int8"):  # a page's (B4: a tile's) V scales zeroed
        vs = sc["v_scales"].clone()
        if kernel.startswith("decode"):
            vs[:, BLK_KV:2 * BLK_KV] = 0
        else:
            vs[:, 3] = 0
        faulty = emulate(True, vs=vs)
    else:                         # a 64-row V tile (or its pages) zeroed
        v_bad = v.clone()
        if kernel in ("paged", "verify", "paged_decode"):
            v_bad[:, 3] = 0
        else:
            v_bad[:, BLK_KV:2 * BLK_KV] = 0
        faulty = emulate(True, v_=v_bad)
    assert row_rel_err(faulty, want) > 10 * BF16_ROW_RTOL


def test_every_int8_value_is_exact_in_bf16():
    """B5's int8 tiles are held as bf16: -127..127 survive the conversion
    exactly, so the int8 pool's products differ from the bf16 pool's only
    by the scales."""
    values = torch.arange(-127, 128, dtype=torch.int8)
    assert torch.equal(values.float().bfloat16().float(), values.float())
    assert torch.equal(values.bfloat16().to(torch.int8), values)


# ---------------------------------------------------------------------------
# B8: the SSD intra-chunk step on the tensor cores. S = C B^T is exact bf16
# products summed in fp32; S . L enters the product with X, and
# the decay-scaled x_t the state's product with B^T, either as one bf16
# rounding or as hi + lo. B8 is held to 1e-4 of each row's norm
# (tests/test_torch_cuda.py), at the model's decay (a·dt of -0.7 to -11 a
# step) and at 1% of it, where the off-diagonal tiles count.

SSD_ROW_RTOL = 1e-4
SSD_HEADS, SSD_Q, SSD_P, SSD_N = 24, 256, 64, 128


def _ssd_inputs(seed: int, a_scale: float):
    """One 256-row chunk for each of 24 heads: bf16 x, b, c ~ N(0, 1) and
    a = -a_scale softplus(N(0, 1)) A_h, A_h = linspace(1, 16) by head."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(torch.bfloat16)

    x = bf16(SSD_HEADS, 1, SSD_Q, SSD_P)
    b, c = bf16(SSD_HEADS, 1, SSD_Q, SSD_N), bf16(SSD_HEADS, 1, SSD_Q, SSD_N)
    a_h = torch.linspace(1.0, 16.0, SSD_HEADS).view(-1, 1, 1)
    a = -a_scale * torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((SSD_HEADS, 1, SSD_Q), dtype=np.float32))) * a_h
    return x, a, b, c


def _times_rounded(lhs, m, split: bool):
    """lhs @ m with lhs exact and m rounded to bf16 once, or as hi + lo."""
    hi = m.to(torch.bfloat16).float()
    out = lhs @ hi
    if split:
        out = out + lhs @ (m - hi).to(torch.bfloat16).float()
    return out


def ssd_emulated(x, a, b, c, *, split: bool):
    """B8 on the tensor cores: (y, state) with S . L and the decay-scaled
    x as one bf16 product or as hi + lo."""
    a_cum = tssd.cumsum_sequential(a)
    below = torch.ones((SSD_Q, SSD_Q), dtype=torch.bool).tril()
    lmat = torch.exp(torch.where(below, a_cum[..., :, None]
                                 - a_cum[..., None, :], NEG_INF))
    s = c.float() @ b.float().transpose(-1, -2)
    y = _pv(s * lmat, x, split)
    decay = torch.exp(a_cum[..., -1:] - a_cum)
    state = _times_rounded(b.float().transpose(-1, -2),
                           x.float() * decay[..., None], split)
    return y, state


def ssd_scores_tensor_core(c, b):
    """S = C B^T as B8's bf16 form sums it: off the diagonal, each k16
    step's 16 exact products summed (here exactly, in float64) and added
    to the fp32 sum of the steps before; on the diagonal, c_i . b_i as a
    chain of fp32 FMAs in k order (the order of the card's fp32 matrix
    product, which the plain version runs), each bf16 product exact."""
    c, b = c.float(), b.float()
    s = torch.zeros(c.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, c.shape[-1], 16):
        step = c[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16].double(
        ).transpose(-1, -2)
        s = s + step.float()
    diag = torch.zeros(c.shape[:-1])
    for k in range(c.shape[-1]):
        diag = diag + c[..., k] * b[..., k]
    return s.diagonal_scatter(diag, dim1=-2, dim2=-1)


def ssd_k_order_errors(a_scale: float) -> dict[str, float]:
    """Row errors of B8's bf16 form as built: S by ``ssd_scores_tensor_core``
    (k16 steps, the diagonal in k order), S . L and the decay-scaled x as
    hi + lo, against the plain version."""
    x, a, b, c = _ssd_inputs(7, a_scale)
    want = tssd.ssd_intra_chunk_plain(x, a, b, c)
    a_cum = tssd.cumsum_sequential(a)
    below = torch.ones((SSD_Q, SSD_Q), dtype=torch.bool).tril()
    lmat = torch.exp(torch.where(below, a_cum[..., :, None]
                                 - a_cum[..., None, :], NEG_INF))
    y = _pv(ssd_scores_tensor_core(c, b) * lmat, x, True)
    decay = torch.exp(a_cum[..., -1:] - a_cum)
    state = _times_rounded(b.float().transpose(-1, -2),
                           x.float() * decay[..., None], True)
    return {"y": row_rel_err(y, want[0]), "state": row_rel_err(state, want[1])}


def ssd_emulated_errors(a_scale: float) -> dict[str, float]:
    """Row errors of y and the state against the plain version, with one
    bf16 rounding and with hi + lo."""
    x, a, b, c = _ssd_inputs(7, a_scale)
    want = tssd.ssd_intra_chunk_plain(x, a, b, c)
    errs = {}
    for kind in ("bf16", "hi_lo"):
        y, state = ssd_emulated(x, a, b, c, split=kind == "hi_lo")
        errs[f"y_{kind}"] = row_rel_err(y, want[0])
        errs[f"state_{kind}"] = row_rel_err(state, want[1])
    return errs


@pytest.mark.parametrize("a_scale", [1.0, 0.01])
def test_ssd_needs_hi_lo_to_fit_its_row_limit(a_scale):
    """One bf16 rounding of S . L, or of the decay-scaled x, breaks B8's
    1e-4 row limit (by about 40 and 20 times); hi + lo fits it with
    room."""
    errs = ssd_emulated_errors(a_scale)
    assert errs["y_bf16"] > SSD_ROW_RTOL, errs
    assert errs["state_bf16"] > SSD_ROW_RTOL, errs
    assert 0 < errs["y_hi_lo"] <= SSD_ROW_RTOL / 4, errs
    assert 0 < errs["state_hi_lo"] <= SSD_ROW_RTOL / 4, errs


@pytest.mark.parametrize("a_scale", [1.0, 0.01])
def test_ssd_tensor_core_form_with_a_k_order_diagonal_fits(a_scale):
    """B8's bf16 form as built, S summed in k16 steps with its diagonal in
    k order, fits the 1e-4 row limit at the model's decay and at 1% of
    it."""
    errs = ssd_k_order_errors(a_scale)
    assert 0 < errs["y"] <= SSD_ROW_RTOL, errs
    assert 0 < errs["state"] <= SSD_ROW_RTOL, errs


if __name__ == "__main__":
    for name in KERNELS:
        print(name, emulated_errors(name))
    for a_scale in (1.0, 0.01):
        print("ssd", a_scale, ssd_emulated_errors(a_scale))
        print("ssd k-order diagonal", a_scale, ssd_k_order_errors(a_scale))
