"""MAS-Attention: kernels B1 (K/V resident) and B2 (K/V streamed).

Port of ``repro/kernels/mas_attention.py`` (``mas_attention_flat``).
One CUDA thread block owns one (b·h, Q row block of ``blk_q`` rows) and
holds that block's FULL fp32 (blk_q, N) score row in dynamic shared
memory: the S tiles fill it (paper Alg. 2), one exact row softmax runs
over it with no online rescale (Alg. 3), and P·V accumulates over the V
tiles (Alg. 4). Causal calls prune in three bands (``causal_tile_bounds``).

* B1, ``kv_resident=True`` (``csrc/mas_attention.cu``): the block
  stages its K and V rows whole in shared memory next to the score row —
  the paper's ideal regime.
* B2, ``kv_resident=False``: K tiles stream through the shared tile
  buffer for the S pass, and the P·V pass reads the V tiles AGAIN from
  device memory — the §4.3 proactive-overwrite regime, whose extra reads
  ``sim/`` models as read inflation.

In bf16 (``mas_resident_bf16_launch``, ``mas_streamed_bf16_launch``)
both run their products on the tensor cores, keeping the fp32 score row
and its one exact softmax; B1 copies Q, each K tile and V at once by
``cp.async`` and starts on a K tile as it lands, B2 streams its tiles
through registers. In fp32 (``mas_resident_fp32_launch``,
``mas_streamed_fp32_launch``) they keep the CUDA-core kernels.
``entry_point`` makes that choice, by dtype; a bf16 tensor the
tensor-core kernels do not take raises.

``core/policy.py`` picks the regime and ``blk_q`` from the shared-memory
footprint. Inputs are pre-flattened to (B·H, N, E) by ``ops.py``; query
row block ``bh`` reads kv head ``bh // group``.

``mas_attention_plain`` computes the same function in PyTorch with the
kernels' tile order and masking; the wrapper runs it for CPU tensors
only. B1 and B2 differ only in where K/V live between loads, so one plain
version serves both.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import KV_TILE, SMEM_PER_BLOCK, mas_smem_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    NEG_INF,
    causal_tile_bounds,
    causal_tile_mask,
    check_prefill_tile,
    mask_kv_tail,
)

# Launches of each CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = {"mas_resident": 0, "mas_streamed": 0}


def mas_attention_plain(q, k, v, *, blk_q: int, blk_kv: int,
                        causal: bool = False, sm_scale: float | None = None,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: (BHq, Nq, E); k, v: (BHkv, Nkv, E); Nq % blk_q == Nkv % blk_kv == 0.

    Every Q row block is computed at once; the loops run over KV tiles in
    the kernels' order. A block's dead tiles (j >= n_needed) are never
    written to its score row, which starts at NEG_INF like the stale tail
    the kernels mask, and add nothing to its P·V sum.
    """
    bhq, nq, e = q.shape
    bhkv, n, _ = k.shape
    group = bhq // bhkv
    nqb, nkv = nq // blk_q, n // blk_kv
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    dev = q.device
    kf = k.float().repeat_interleave(group, dim=0)   # row bh reads bh // group
    vf = v.float().repeat_interleave(group, dim=0)
    qb = q.float().reshape(bhq, nqb, blk_q, e)
    iq = torch.arange(nqb, device=dev)
    if causal:
        n_full, n_needed = causal_tile_bounds(iq, blk_q, blk_kv, nkv)
    else:
        n_full = n_needed = torch.full((nqb,), nkv, device=dev)
    row0 = (iq * blk_q).view(nqb, 1, 1)

    # Alg. 2: S tiles into the full (blk_q, N) row of every block.
    s_row = torch.full((bhq, nqb, blk_q, n), NEG_INF, device=dev)
    for j in range(nkv):
        live = (j < n_needed).view(nqb, 1, 1)
        if not bool(live.any()):
            break
        cols = slice(j * blk_kv, (j + 1) * blk_kv)
        s = torch.einsum("bnqe,bke->bnqk", qb, kf[:, cols]) * scale
        if causal:
            straddles = (j >= n_full).view(nqb, 1, 1)
            visible = causal_tile_mask(blk_q, blk_kv, row0, j * blk_kv,
                                       device=dev)
            s = torch.where(straddles & ~visible, NEG_INF, s)
        if kv_len is not None:
            s = mask_kv_tail(s, j * blk_kv, kv_len)
        s_row[..., cols] = torch.where(live, s, s_row[..., cols])

    # Alg. 3: one exact softmax over each full row.
    m = s_row.amax(dim=-1, keepdim=True)
    p = torch.exp(s_row - m)
    p = p / p.sum(dim=-1, keepdim=True)

    # Alg. 4: P·V over the live V tiles.
    acc = torch.zeros((bhq, nqb, blk_q, e), device=dev)
    for j in range(nkv):
        live = (j < n_needed).view(nqb, 1, 1)
        if not bool(live.any()):
            break
        cols = slice(j * blk_kv, (j + 1) * blk_kv)
        part = torch.einsum("bnqk,bke->bnqe", p[..., cols], vf[:, cols])
        acc = acc + torch.where(live, part, 0.0)
    return acc.reshape(bhq, nq, e).to(q.dtype)


# The bf16 forms: the head dims and Q block heights they are built for.
BF16_HEAD_DIMS = (64, 128)
BF16_BLK_Q = (8, 16, 24, 32)


def entry_point(dtype, kv_resident: bool) -> str:
    """The C function a CUDA tensor of ``dtype`` launches: B1 or B2 on the
    tensor cores in bf16, on the CUDA cores in fp32. Nothing falls back
    from one to the other."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the MAS kernels take float32 or bfloat16, "
                        f"not {dtype}")
    form = "bf16" if dtype == torch.bfloat16 else "fp32"
    return f"mas_{'resident' if kv_resident else 'streamed'}_{form}_launch"


def check_bf16(q, k, v, blk_q: int) -> None:
    """Raise unless the bf16 MAS kernels take these operands."""
    e = q.shape[-1]
    if e not in BF16_HEAD_DIMS or blk_q not in BF16_BLK_Q:
        raise ValueError(f"the bf16 MAS kernels take E in {BF16_HEAD_DIMS} "
                         f"and blk_q in {BF16_BLK_Q}, not E={e}, "
                         f"blk_q={blk_q}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 MAS kernels copy 16-byte chunks: q, k "
                         "and v must be 16-byte aligned")


def _launch(kv_resident: bool, q, k, v, *, blk_q, blk_kv, causal, sm_scale,
            kv_len) -> torch.Tensor:
    bhq, nq, e = q.shape
    bhkv, n, _ = k.shape
    if blk_kv != KV_TILE:
        raise ValueError(f"the CUDA kernels use {KV_TILE}-row KV tiles, "
                         f"not {blk_kv}")
    check_prefill_tile(blk_q, e)
    name = entry_point(q.dtype, kv_resident)
    if q.dtype == torch.bfloat16:
        check_bf16(q, k, v, blk_q)
    smem = mas_smem_bytes(blk_q, blk_kv, n, e, q.element_size(), kv_resident)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{smem} B of shared memory needed, a block has "
                         f"{SMEM_PER_BLOCK}: see core/policy.py")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device:
        raise ValueError("q, k and v must share one dtype and device")
    lib = _build.library("mas_attention")
    o = torch.empty_like(q)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bhq, nq, n,
        e, bhq // bhkv, blk_q, int(causal),
        n if kv_len is None else int(kv_len), float(scale),
        _build.stream_handle(q.device))
    _build.check(lib, err, name)
    LAUNCHES["mas_resident" if kv_resident else "mas_streamed"] += 1
    return o


def mas_attention_flat(q, k, v, *, blk_q: int, blk_kv: int = KV_TILE,
                       causal: bool = False, sm_scale: float | None = None,
                       kv_resident: bool = True,
                       kv_len: int | None = None) -> torch.Tensor:
    """MAS attention on (BHq, Nq, E) x (BHkv, Nkv, E).

    A CUDA tensor launches B1 or B2; a CPU tensor runs the plain version.
    ``kv_len`` masks the padded kv columns at and past it.
    """
    bhq, nq, _ = q.shape
    bhkv, n, _ = k.shape
    if bhq % bhkv or nq % blk_q or n % blk_kv:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do not "
                         f"tile by ({blk_q}, {blk_kv})")
    if kv_len is not None and kv_len >= n:
        kv_len = None
    if q.device.type == "cpu":
        return mas_attention_plain(q, k, v, blk_q=blk_q, blk_kv=blk_kv,
                                   causal=causal, sm_scale=sm_scale,
                                   kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(kv_resident, q, k, v, blk_q=blk_q, blk_kv=blk_kv,
                   causal=causal, sm_scale=sm_scale, kv_len=kv_len)
