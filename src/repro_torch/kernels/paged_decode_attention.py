"""Split-KV one-token decode over a paged KV pool: kernel B6.

Port of ``repro/kernels/paged_decode_attention.py``
(``paged_decode_attention_flat``). The KV
cache lives in fixed-size pages of a global pool (Hkv, P, page, E); a
page table (B, max_pages) maps each sequence's logical page to a
physical one, and ``kv_lens`` (B,) holds each sequence's live tokens.
For each (b, kv head) the G query heads of its GQA group attend to the
sequence's first ``kv_lens[b]`` logical rows.

The CUDA kernels (``csrc/paged_decode_attention.cu``) read the table and
``kv_lens`` from device memory themselves, so a decode step needs no host
sync. They cut the logical rows into 64-row tiles, split the tiles over
``n_split`` blocks per (b, kv head) as B4 does (B·Hkv blocks alone would
leave most SMs idle; the split is planned over the table's capacity),
gather each live tile through the table, never load a page at or past
``kv_len`` and merge the partial (m, l, acc) in a second pass.
``kv_len == 0`` gives zeros. The TPU's padding of the GQA group to 8 rows
does not carry over.

An int8 pool carries one fp32 scale per (kv head, page),
``k_scales``/``v_scales`` (Hkv, P), read through the page table per
column: the K scale multiplies the score, the V scale P after the row
sum.

Three forms, chosen by ``entry_point`` from the dtypes, with nothing
falling back from one to another:

* a bf16 q on bf16 pools (``paged_decode_bf16_launch``) or on int8 pools
  (``paged_decode_int8_launch``), head dim 64 or 128, G <= 16: the
  tensor-core design of ``csrc/decode_tc.cuh``, shared with the bf16-q
  forms of B4 and B7, on ``decode_split_plan``'s short splits; an int8
  page is converted to bf16 (exactly) in shared memory. A bf16 shape it
  does not take raises.
* an fp32 q (``paged_decode_fp32_launch``, or ``paged_decode_int8_launch``
  on int8 pools): the CUDA-core kernel of ``csrc/paged_split.cuh`` on
  ``split_plan``, shared with B7's fp32-q forms.

``decode_attention.decode_split_plan`` of q's dtype gives each form its
plan.

``paged_decode_attention_plain`` computes the same function in PyTorch:
the dense gather of the table's pages followed by B4's plain version,
which has the kernel's split, tile order, masking and merge. The wrapper
runs it for CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import gather_pages, page_scales
from repro_torch.kernels.decode_attention import (
    MAX_E,
    MAX_G,
    check_bf16,
    check_scales,
    decode_attention_plain,
    decode_split_plan,
)

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# by branch: bf16/fp32 caches and int8 caches.
LAUNCHES = {"paged_decode": 0, "paged_decode_int8": 0}


def entry_point(dtype, quantized: bool) -> str:
    """The C function a CUDA q of ``dtype`` launches: the int8 one for int8
    pools (tensor cores for a bf16 q, CUDA cores for fp32), else the
    tensor-core one for bf16 and the CUDA-core one for fp32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the paged decode kernel takes float32 or "
                        f"bfloat16, not {dtype}")
    if quantized:
        return "paged_decode_int8_launch"
    return ("paged_decode_bf16_launch" if dtype == torch.bfloat16
            else "paged_decode_fp32_launch")


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_lens, *,
                                 n_split: int, tiles_per_split: int,
                                 sm_scale: float | None = None,
                                 k_scales=None, v_scales=None,
                                 q_pos=None) -> torch.Tensor:
    """q: (B, Hkv, R, E); pools: (Hkv, P, page, E), int8 with
    ``k_scales``/``v_scales`` (Hkv, P); page_table: (B, max_pages);
    kv_lens: (B,); ``q_pos`` (B, R), when given, the position of each
    query row (B7). Returns (B, Hkv, R, E)."""
    b, hkv, g, e = q.shape
    page = k_pages.shape[2]
    k = gather_pages(k_pages, page_table)           # (B, Hkv, S, E)
    v = gather_pages(v_pages, page_table)
    s_len = k.shape[2]
    lens = kv_lens.to(q.device).repeat_interleave(hkv)
    ks = vs = None
    if k_scales is not None:
        ks = page_scales(k_scales, page_table, page).reshape(b * hkv, s_len)
        vs = page_scales(v_scales, page_table, page).reshape(b * hkv, s_len)
    if q_pos is not None:
        q_pos = q_pos.to(q.device).repeat_interleave(hkv, dim=0)
    o = decode_attention_plain(
        q.reshape(b * hkv, g, e), k.reshape(b * hkv, s_len, e),
        v.reshape(b * hkv, s_len, e), lens, n_split=n_split,
        tiles_per_split=tiles_per_split, sm_scale=sm_scale, k_scale=ks,
        v_scale=vs, q_pos=q_pos)
    return o.reshape(b, hkv, g, e)


def check_paged(q, k_pages, v_pages, page_table, k_scales, v_scales,
                *int_args) -> bool:
    """The kernel-side checks of B5-B7: contiguous operands on q's
    device, int32 index tensors, a pool of q's dtype or int8 with its
    scales. Returns whether the pool is int8."""
    _, n_pages = k_pages.shape[:2]
    quantized = check_scales(k_pages, v_pages, k_scales, v_scales,
                             (k_pages.shape[0], n_pages))
    if quantized and q.shape[-1] % 16:
        raise ValueError(f"int8 pools need E % 16 == 0, got {q.shape[-1]}")
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("q, the pools and page_table must be contiguous")
    if k_pages.device != q.device or v_pages.device != q.device or (
            not quantized and (k_pages.dtype != q.dtype
                               or v_pages.dtype != q.dtype)):
        raise ValueError("q and the pools must share one device, and one "
                         "dtype unless the pools are int8")
    for t in (page_table,) + int_args:
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError("page tables, lengths and starts must be "
                             "int32 on q's device")
    return quantized


def paged_decode_attention_flat(q, k_pages, v_pages, page_table, kv_lens, *,
                                sm_scale: float | None = None,
                                k_scales=None, v_scales=None,
                                plan_kv_heads: int | None = None
                                ) -> torch.Tensor:
    """One-token decode: q (B, Hkv, G, E) against the page pools.

    ``page_table`` (B, max_pages) and ``kv_lens`` (B,) are int32 tensors on
    q's device. The split is planned over the table's capacity
    (max_pages·page rows), so no host sync is needed; blocks past a
    sequence's ``kv_len`` exit at once. Int8 pools come with their
    (Hkv, P) fp32 ``k_scales``/``v_scales``. ``decode_split_plan`` plans
    the split for the form q's dtype picks, over B·``plan_kv_heads`` rows
    (default the pools' Hkv): a rank holding some of a model's KV heads
    passes the model's count, so each head is split, and summed, as on
    one card. A CUDA tensor launches B6; a CPU tensor runs the plain
    version with the same split.
    """
    b, hkv, g, e = q.shape
    hkv_p, n_pages, page_size, e_p = k_pages.shape
    if hkv_p != hkv or e_p != e or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be ({b}, max_pages), got "
                         f"{tuple(page_table.shape)}")
    if kv_lens.shape != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    max_pages = page_table.shape[1]
    n_split, tps = decode_split_plan(q.dtype, b * (plan_kv_heads or hkv),
                                     max_pages * page_size)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, kv_lens, n_split=n_split,
            tiles_per_split=tps, sm_scale=sm_scale, k_scales=k_scales,
            v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if g > MAX_G or e > MAX_E or e % 4:
        raise ValueError(f"unsupported decode shape: G={g}, E={e}")
    quantized = check_paged(q, k_pages, v_pages, page_table, k_scales,
                            v_scales, kv_lens)
    name = entry_point(q.dtype, quantized)
    if q.dtype == torch.bfloat16:
        check_bf16(g, e, q, k_pages, v_pages)
    lib = _build.library("paged_decode_attention")
    o = torch.empty_like(q)
    m_part = torch.empty((b * hkv, n_split, g), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * hkv, n_split, g, e), dtype=torch.float32,
                           device=q.device)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quantized:
        args += [k_scales.data_ptr(), v_scales.data_ptr()]
    args += [page_table.data_ptr(), kv_lens.data_ptr(), o.data_ptr(),
             m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), b,
             hkv, g, n_pages, page_size, max_pages, e, n_split, tps,
             float(scale)]
    if quantized:
        args.append(_build.dtype_code(q.dtype))
    err = getattr(lib, name)(*args, _build.stream_handle(q.device))
    _build.check(lib, err, name)
    LAUNCHES["paged_decode_int8" if quantized else "paged_decode"] += 1
    return o
