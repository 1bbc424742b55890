"""The rounding of the bf16 tensor-core kernels (B2's and B3's bf16
forms), emulated on the CPU and held to their plain versions.

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

Run as a script, it prints the four row errors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mas_attention as tmas
from repro_torch.kernels.common import NEG_INF

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


def flash_emulated(q, k, v, *, split: bool):
    """B3's bf16 form: online max and sum over 64-column tiles, P = exp(s
    - m) unnormalized into P V, the sum l taken from fp32 P."""
    s_all = _causal_scores(q, k)
    m = torch.full((HEADS, N, 1), NEG_INF)
    l = torch.zeros((HEADS, N, 1))
    acc = torch.zeros((HEADS, N, E))
    for c0 in range(0, N, BLK_KV):
        s = s_all[..., c0:c0 + BLK_KV]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _pv(p, v[:, c0:c0 + BLK_KV], split)
        m = m_new
    return (acc / l).to(torch.bfloat16)


def row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def emulated_errors(kernel: str) -> dict[str, float]:
    """Row error of the emulation against the plain version, with P in one
    bf16 product and as hi + lo."""
    q, k, v = _inputs()
    if kernel == "mas":
        want = tmas.mas_attention_plain(q, k, v, blk_q=16, blk_kv=BLK_KV,
                                        causal=True)
        emulate = mas_emulated
    else:
        want = tflash.flash_attention_plain(q, k, v, blk_q=64,
                                            blk_kv=BLK_KV, causal=True)
        emulate = flash_emulated
    return {kind: row_rel_err(emulate(q, k, v, split=kind == "hi_lo"), want)
            for kind in ("bf16", "hi_lo")}


@pytest.mark.parametrize("kernel", ["mas", "flash"])
def test_hi_lo_p_fits_the_bf16_row_limit_with_room(kernel):
    errs = emulated_errors(kernel)
    assert 0 < errs["hi_lo"] <= BF16_ROW_RTOL / 2, errs
    # one bf16 product of P moves rows by several times more
    assert errs["bf16"] > 2 * errs["hi_lo"], errs


@pytest.mark.parametrize("kernel", ["mas", "flash"])
def test_emulation_sees_a_skipped_v_tile(kernel):
    q, k, v = _inputs(1)
    v_bad = v.clone()
    v_bad[:, BLK_KV:2 * BLK_KV] = 0
    emulate = mas_emulated if kernel == "mas" else flash_emulated
    want = emulate(q, k, v, split=True)
    assert row_rel_err(emulate(q, k, v_bad, split=True),
                       want) > 10 * BF16_ROW_RTOL


if __name__ == "__main__":
    for name in ("mas", "flash"):
        print(name, emulated_errors(name))
