"""Static memory policy — the paper's §4.3 guard, budgeted in Hopper SMEM.

Port of ``repro/core/policy.py``. The reference budgets the TPU core's
VMEM; on Hopper the scarce on-chip store is a thread block's shared
memory (SMEM): at most 232,448 bytes (227 KB) of dynamic shared memory a
block, opted into with ``cudaFuncSetAttribute``. Given that budget the
policy chooses, in the paper's order:

  mas_resident — K and V staged whole in SMEM next to the fp32
                 (blk_q, N) score row (the paper's ideal regime);
  mas_streamed — K tiles stream through one SMEM buffer and the V tiles
                 are re-read from device memory for the P·V pass (the
                 overwrite/reload regime), first at the default blk_q,
                 then with blk_q halved down to 8;
  flash        — online softmax once even a (8, N) fp32 score row does
                 not fit (the paper's §5.6 sequence-length limit); its
                 bf16 form runs blocks of its own height,
                 ``FLASH_BLK_Q_BF16`` rows.

The footprints below are exactly the dynamic SMEM the port's CUDA
kernels request (``kernels/csrc``): the MAS kernels' score rows and Q
block are fp32 and their tile buffer holds ``KV_TILE`` K/V rows padded
by ``KV_ROW_PAD`` elements against bank conflicts (B2's bf16 form holds
two unpadded, swizzled 32-row half tiles and its rows' maxima and sums
in those same bytes). N is the kv length padded to a whole number of
tiles, which is what the kernel holds.

At E = 128 in bf16 with the defaults (blk_q 32, budget 231,424 B) this
gives, by padded N: resident up to 320, streamed at blk_q 32 up to 1,536,
at blk_q 16 up to 3,200, at blk_q 8 up to 6,528, flash beyond.
"""

from __future__ import annotations

import dataclasses

# Dynamic shared memory one H100 thread block may opt into.
SMEM_PER_BLOCK = 232_448
# Kept free for static shared memory and the runtime's own use.
SMEM_HEADROOM = 1_024
DEFAULT_SMEM_BUDGET = SMEM_PER_BLOCK - SMEM_HEADROOM

# The paper's tiling factors: N_KV, the K/V rows of a tile in every
# prefill and decode kernel, and N_Q, the query rows of a block.
KV_TILE = 64
DEFAULT_BLK_Q = 32
MIN_BLK_Q = 8
KV_ROW_PAD = 4   # elements of padding per staged K/V row in SMEM
# Q rows of a block of the flash kernel's bf16 form: 4 warps of 16.
FLASH_BLK_Q_BF16 = 64


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    method: str  # "mas_resident" | "mas_streamed" | "flash"
    blk_q: int
    smem_bytes: int
    reason: str


def padded_kv(n_kv: int, blk_kv: int = KV_TILE) -> int:
    return -(-n_kv // blk_kv) * blk_kv


def mas_smem_bytes(blk_q: int, blk_kv: int, n: int, e: int, itemsize: int,
                   kv_resident: bool) -> int:
    """Dynamic SMEM of the MAS kernels for a padded kv length ``n``."""
    s_row = 4 * blk_q * n                      # fp32 full score row (Alg. 3)
    q_blk = 4 * blk_q * e                      # Q block, fp32
    row = (e + KV_ROW_PAD) * itemsize
    if kv_resident:
        kv = 2 * n * row                       # K and V staged whole
    else:
        kv = blk_kv * row                      # one tile buffer, K then V
    return s_row + q_blk + kv


def flash_blk_q(itemsize: int, blk_q: int = DEFAULT_BLK_Q) -> int:
    """Q rows of a flash block: the bf16 form's own height, else blk_q."""
    return FLASH_BLK_Q_BF16 if itemsize == 2 else blk_q


def flash_smem_bytes(blk_q: int, blk_kv: int, e: int, itemsize: int) -> int:
    """Dynamic SMEM of the flash kernel. bf16 form: the Q block and two
    stages of one K and one V tile, all unpadded, and 1 KB to align them
    to 1024 bytes (``wgmma``'s swizzled tiles); fp32 form: P tile, Q
    block, m/l/alpha rows, one K and one V tile."""
    if itemsize == 2:
        return 2 * blk_q * e + 2 * 2 * blk_kv * e * 2 + 1024
    return (4 * blk_q * blk_kv + 4 * blk_q * e + 3 * 4 * blk_q
            + 2 * blk_kv * (e + KV_ROW_PAD) * itemsize)


def choose_attention_method(*, n_kv: int, e: int,
                            itemsize: int = 2) -> PolicyDecision:
    """Pick the kernel variant for an attention call over ``n_kv`` keys, in
    the paper's order: resident -> streamed (blk_q halved down to 8) ->
    flash."""
    blk_kv, blk_q = KV_TILE, DEFAULT_BLK_Q
    n = padded_kv(n_kv, blk_kv)
    budget = DEFAULT_SMEM_BUDGET

    resident = mas_smem_bytes(blk_q, blk_kv, n, e, itemsize, True)
    if resident <= budget:
        return PolicyDecision(
            "mas_resident", blk_q, resident,
            f"K/V ({2 * n * e * itemsize} B) + row buffer fit SMEM")

    bq = blk_q
    while True:
        streamed = mas_smem_bytes(bq, blk_kv, n, e, itemsize, False)
        if streamed <= budget:
            return PolicyDecision(
                "mas_streamed", bq, streamed,
                "K/V streamed per tile (proactive overwrite); row buffer "
                f"fits at blk_q {bq}")
        if bq <= MIN_BLK_Q:
            break
        bq = max(bq // 2, MIN_BLK_Q)

    bq = flash_blk_q(itemsize, blk_q)
    return PolicyDecision(
        "flash", bq, flash_smem_bytes(bq, blk_kv, e, itemsize),
        f"a ({MIN_BLK_Q}, {n}) fp32 score row does not fit the {budget} B "
        "SMEM budget (paper §5.6): online softmax")
