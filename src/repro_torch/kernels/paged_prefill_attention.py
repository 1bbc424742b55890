"""Chunked prefill attention over a paged KV pool: kernel B5.

Port of ``repro/kernels/paged_prefill_attention.py``
(``paged_prefill_attention_flat``). One
sequence's prompt chunk, q (Hq, chunk, E) with row ``i`` at absolute
position ``q_offset + i``, attends causally to the sequence's first
``kv_len`` logical rows: all earlier context and the chunk's own rows,
which the caller writes into their pages just before the call. The rows
are read from the pool (Hkv, P, page, E) through the sequence's page
table (max_pages,); query head ``h`` reads kv head ``h // group``.

The TPU kernel holds a (chunk, E) fp32 accumulator per head on chip,
which at chunk 512 is more than a CUDA block's shared memory. So the
CUDA kernels (``csrc/paged_prefill_attention.cu``) run one block per
(query head, block of Q rows), walking 64-row tiles of logical kv rows
with an online softmax in the TPU kernel's three bands: tiles wholly
visible to the block run unmasked, tiles that straddle the causal
diagonal or the ``kv_len`` tail take the fused select of
``three_band_select``, dead tiles are never loaded. ``q_offset`` and
``kv_len`` come as one int32 pair on the device, ``span``, which every
block reads at its start, as the TPU kernel reads them by scalar
prefetch: nothing on the launch path reads a device value on the host,
so the chunk step's launches do not change from one chunk to the next.
The kernels cut a ``kv_len`` past the table's rows to them, as the TPU
kernel's grid ends at the table; the plain version, which reads the pair
on the host, refuses it. Pad rows at or past ``kv_len`` see every live
key and return values the caller drops.

Two forms, chosen by ``entry_point`` from q's dtype, with nothing
falling back from one to the other:

* bf16 q (``paged_prefill_bf16_launch``, a bf16 or an int8 pool, head
  dim 64 or 128): the products on the tensor cores by ``wgmma`` in
  64-row blocks (``BLK_Q_BF16``, one consumer warpgroup), S and P in
  registers, while a producer warpgroup keeps three tiles' gathers in
  flight.
* fp32 q (``paged_prefill_fp32_launch``): the CUDA-core kernel at the
  caller's ``blk_q``.

An int8 pool carries one fp32 scale per (kv head, page),
``k_scales``/``v_scales`` (Hkv, P), which the kernels read per tile
column through the table: the K scale multiplies the score, the V scale
folds into P after the row sum, in the TPU kernel's order.

``paged_prefill_attention_plain`` computes the same function in PyTorch:
the live tiles gathered through the table, then B3's plain version with
its tile order and masks (a dead tile it would visit is left out, as the
kernel leaves it out). The wrapper runs it for CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import (
    FLASH_BLK_Q_BF16,
    KV_TILE,
    SMEM_PER_BLOCK,
)
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_prefill_tile,
    gather_pages,
    page_scales,
)
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.paged_decode_attention import check_paged

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# by branch: bf16/fp32 caches and int8 caches.
LAUNCHES = {"paged_prefill": 0, "paged_prefill_int8": 0}
# The bf16 form: its block height (one warpgroup, as B3's) and head dims.
BLK_Q_BF16 = FLASH_BLK_Q_BF16
BF16_HEAD_DIMS = (64, 128)


def live_tiles(kv_len: int, blk_kv: int = KV_TILE) -> int:
    """64-row tiles of logical kv rows that hold a live row."""
    return -(-max(kv_len, 0) // blk_kv)


def entry_point(dtype) -> str:
    """The C function a CUDA q of ``dtype`` launches: the tensor-core
    kernel for bf16, the CUDA-core kernel for fp32."""
    if dtype == torch.bfloat16:
        return "paged_prefill_bf16_launch"
    if dtype == torch.float32:
        return "paged_prefill_fp32_launch"
    raise TypeError(f"the paged prefill kernel takes float32 or bfloat16, "
                    f"not {dtype}")


def bf16_smem_bytes(e: int, quantized: bool, max_pages: int) -> int:
    """Shared memory of a block of the bf16 form (``launch_bf16``): the Q
    tile, three ring stages of K and V tiles (and an int8 pool's scales),
    their barriers, the page ids of the whole table row, and 1 KB to
    align the base."""
    stage = 2 * KV_TILE * e * 2 + (1024 if quantized else 0)
    return BLK_Q_BF16 * e * 2 + 3 * stage + 8 * 3 + 4 * max_pages + 1024


def check_bf16(q, k_pages, v_pages, page_table, blk_q: int,
               quantized: bool) -> None:
    """Raise unless the bf16 form takes these operands."""
    e = q.shape[-1]
    if blk_q != BLK_Q_BF16 or e not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 paged prefill kernel takes blk_q "
                         f"{BLK_Q_BF16} and E in {BF16_HEAD_DIMS}, not "
                         f"blk_q={blk_q}, E={e}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the bf16 paged prefill kernel copies 16-byte "
                         "chunks: q and the pools must be 16-byte aligned")
    smem = bf16_smem_bytes(e, quantized, page_table.shape[0])
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"the bf16 paged prefill kernel holds the table's "
                         f"{page_table.shape[0]} page ids: {smem} bytes of "
                         f"shared memory, past {SMEM_PER_BLOCK}")


def check_span(span, device) -> None:
    """Raise unless ``span`` is the (q_offset, kv_len) int32 pair on
    ``device``."""
    if (not isinstance(span, torch.Tensor) or span.shape != (2,)
            or span.dtype != torch.int32 or span.device != device):
        raise ValueError(f"span must be the (q_offset, kv_len) pair as a "
                         f"(2,) int32 tensor on {device}, not {span!r}")


def paged_prefill_attention_plain(q, k_pages, v_pages, page_table, span, *,
                                  blk_q: int, blk_kv: int = KV_TILE,
                                  sm_scale: float | None = None,
                                  k_scales=None, v_scales=None
                                  ) -> torch.Tensor:
    """q: (Hq, Nq, E), Nq % blk_q == 0; pools: (Hkv, P, page, E), int8
    with ``k_scales``/``v_scales`` (Hkv, P); page_table: (max_pages,);
    span: (q_offset, kv_len), read on the host here. Returns (Hq, Nq,
    E)."""
    q_offset, kv_len = (int(v) for v in span.tolist())
    page = k_pages.shape[2]
    if page_table.shape[0] * page < kv_len:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not "
                         f"cover kv_len {kv_len}")
    n = live_tiles(kv_len, blk_kv) * blk_kv
    if n == 0:
        return torch.zeros_like(q)

    def rows(x):          # (Hkv, S, ...) cut or zero-padded to n rows
        pad = (0, 0) * (x.dim() - 2) + (0, max(0, n - x.shape[1]))
        return torch.nn.functional.pad(x, pad)[:, :n]

    ks = vs = None
    if k_scales is not None:
        ks = rows(page_scales(k_scales, page_table, page))
        vs = rows(page_scales(v_scales, page_table, page))
    return flash_attention_plain(
        q, rows(gather_pages(k_pages, page_table)),
        rows(gather_pages(v_pages, page_table)), blk_q=blk_q, blk_kv=blk_kv,
        causal=True, sm_scale=sm_scale, q_offset=q_offset,
        kv_len=kv_len if kv_len < n else None, k_scale=ks, v_scale=vs)


def paged_prefill_attention_flat(q, k_pages, v_pages, page_table, span, *,
                                 blk_q: int, sm_scale: float | None = None,
                                 k_scales=None, v_scales=None
                                 ) -> torch.Tensor:
    """One prompt chunk, q (Hq, Nq, E) with Nq % blk_q == 0, against the
    page pools through ``page_table`` (max_pages,), an int32 tensor on q's
    device. ``span`` is the (q_offset, kv_len) int32 pair on q's device;
    the caller makes sure the table covers ``kv_len`` rows. Int8 pools
    come with their (Hkv, P) fp32 ``k_scales``/``v_scales``. A CUDA tensor
    launches B5; a CPU tensor runs the plain version."""
    hq, nq, e = q.shape
    hkv, n_pages, page_size, e_p = k_pages.shape
    if hq % hkv or e_p != e or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if nq % blk_q:
        raise ValueError(f"{nq} query rows do not tile by {blk_q}")
    if page_table.dim() != 1:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not one "
                         "sequence's row")
    check_span(span, q.device)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, page_table, span, blk_q=blk_q,
            sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    name = entry_point(q.dtype)
    quantized = check_paged(q, k_pages, v_pages, page_table, k_scales,
                            v_scales)
    lib = _build.library("paged_prefill_attention")
    o = torch.empty_like(q)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    pools = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _build.ptr(k_scales), _build.ptr(v_scales),
             page_table.data_ptr(), span.data_ptr(), o.data_ptr())
    stream = _build.stream_handle(q.device)
    max_pages = page_table.shape[0]
    if name == "paged_prefill_bf16_launch":
        check_bf16(q, k_pages, v_pages, page_table, blk_q, quantized)
        err = lib.paged_prefill_bf16_launch(
            *pools, hq, nq, e, hq // hkv, n_pages, page_size, max_pages,
            float(scale), int(quantized), stream)
    else:
        check_prefill_tile(blk_q, e)
        err = lib.paged_prefill_fp32_launch(
            *pools, hq, nq, e, hq // hkv, blk_q, n_pages, page_size,
            max_pages, float(scale), int(quantized), stream)
    _build.check(lib, err, name)
    LAUNCHES["paged_prefill_int8" if quantized else "paged_prefill"] += 1
    return o
