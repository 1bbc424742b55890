"""Speculative-verify attention over a paged KV pool: kernel B7.

Port of ``repro/kernels/paged_verify_attention.py``
(``paged_verify_attention_flat``), with both its bf16/fp32 and its int8
pool branches. Each live slot has written k candidate K/V rows (its last
emitted token and up to k - 1 drafted ones) into its pages, and its k
query positions attend to all prior context in one pass, so the pages
are read once for k positions instead of once per decode step.

q is (B, Hkv, k·G, E), position-major: row ``i`` is query head ``i % G``
of position ``q_starts[b] + i // G``. ``kv_lens`` = ``q_starts`` +
the candidate rows actually written, which may stop short of k; the
surplus rows then sit past ``kv_len``, attend the whole live context and
are dropped by the host. The mask treats them like any other row.

The forms (``csrc/paged_verify_attention.cu``), chosen by
``entry_point`` from the dtypes, with nothing falling back from one to
another:

* a bf16 q on bf16 pools (``paged_verify_bf16_launch``) or on int8 pools
  (``paged_verify_int8_launch``), head dim 64 or 128, at most 32 rows:
  the tensor-core design of ``csrc/decode_tc.cuh``, shared with B4's and
  B6's bf16-q forms, on ``decode_split_plan``'s short splits over the
  table's capacity; an int8 page is converted to bf16 (exactly) in
  shared memory. A bf16 shape it does not take raises.
* an fp32 q (``paged_verify_fp32_launch``, or ``paged_verify_int8_launch``
  on int8 pools): the CUDA-core split-KV design (``csrc/paged_split.cuh``)
  on ``split_plan``, which B6's fp32-q forms share.

With k = 1 and ``q_starts = kv_len - 1`` each form gives B6's output of
the same dtypes exactly: one plan (``decode_split_plan`` of q's dtype),
one core.

Both split the table's capacity (no host sync) and band the tiles as B5
does: tiles wholly below ``min(q_starts + 1, kv_len)`` run unmasked,
tiles that straddle the block's diagonal or the kv tail take the fused
select with row position ``q_starts + i // G``, dead tiles are never
loaded. ``kv_len == 0`` gives zeros. Int8 pools carry per-page (Hkv, P)
fp32 scales, read per tile column through the table. The TPU's padding
of the group to 8 rows does not carry over.

``paged_verify_attention_plain`` computes the same function in PyTorch:
B6's plain version (the gather, then B4's split, tile order and merge)
with each row's position in its mask. The wrapper runs it for CPU tensors
only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    MAX_E,
    check_bf16,
    decode_split_plan,
)
from repro_torch.kernels.paged_decode_attention import (
    check_paged,
    paged_decode_attention_plain,
)

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# by branch: bf16/fp32 caches and int8 caches.
LAUNCHES = {"paged_verify": 0, "paged_verify_int8": 0}

MAX_ROWS = 32     # k·G query rows per (b, kv head) the kernel holds


def entry_point(dtype, quantized: bool) -> str:
    """The C function a CUDA q of ``dtype`` launches: the int8 one for int8
    pools (tensor cores for a bf16 q, CUDA cores for fp32), else the
    tensor-core one for bf16 and the CUDA-core one for fp32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the verify kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    if quantized:
        return "paged_verify_int8_launch"
    return ("paged_verify_bf16_launch" if dtype == torch.bfloat16
            else "paged_verify_fp32_launch")


def row_positions(q_starts: torch.Tensor, spec: int,
                  group: int) -> torch.Tensor:
    """(B,) starts -> (B, k·G) positions of the position-major rows."""
    offs = torch.arange(spec * group, device=q_starts.device) // group
    return q_starts.long()[:, None] + offs[None, :]


def paged_verify_attention_plain(q, k_pages, v_pages, page_table, kv_lens,
                                 q_starts, *, spec: int, n_split: int,
                                 tiles_per_split: int,
                                 sm_scale: float | None = None,
                                 k_scales=None, v_scales=None
                                 ) -> torch.Tensor:
    """q: (B, Hkv, k·G, E) position-major; pools: (Hkv, P, page, E), int8
    with ``k_scales``/``v_scales`` (Hkv, P); page_table: (B, max_pages);
    kv_lens, q_starts: (B,). Returns (B, Hkv, k·G, E)."""
    rows = q.shape[2]
    q_pos = row_positions(q_starts.to(q.device), spec, rows // spec)
    return paged_decode_attention_plain(
        q, k_pages, v_pages, page_table, kv_lens, n_split=n_split,
        tiles_per_split=tiles_per_split, sm_scale=sm_scale,
        k_scales=k_scales, v_scales=v_scales, q_pos=q_pos)


def paged_verify_attention_flat(q, k_pages, v_pages, page_table, kv_lens,
                                q_starts, *, spec: int,
                                sm_scale: float | None = None,
                                k_scales=None, v_scales=None,
                                plan_kv_heads: int | None = None
                                ) -> torch.Tensor:
    """k-position verify: q (B, Hkv, k·G, E), position-major, against the
    page pools. ``page_table`` (B, max_pages), ``kv_lens`` and
    ``q_starts`` (B,) are int32 tensors on q's device; the candidate rows
    must already be in their pages. The split is planned over the table's
    capacity, so no host sync is needed, and over B·``plan_kv_heads`` rows
    (default the pools' Hkv), as B6's. A CUDA tensor launches B7; a CPU
    tensor runs the plain version."""
    b, hkv, rows, e = q.shape
    hkv_p, n_pages, page_size, e_p = k_pages.shape
    if rows % spec:
        raise ValueError(f"{rows} query rows do not split into {spec} "
                         f"positions")
    if hkv_p != hkv or e_p != e or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be ({b}, max_pages), got "
                         f"{tuple(page_table.shape)}")
    if kv_lens.shape != (b,) or q_starts.shape != (b,):
        raise ValueError(f"kv_lens and q_starts must be ({b},), got "
                         f"{tuple(kv_lens.shape)}, {tuple(q_starts.shape)}")
    max_pages = page_table.shape[1]
    n_split, tps = decode_split_plan(q.dtype, b * (plan_kv_heads or hkv),
                                     max_pages * page_size)
    if q.device.type == "cpu":
        return paged_verify_attention_plain(
            q, k_pages, v_pages, page_table, kv_lens, q_starts, spec=spec,
            n_split=n_split, tiles_per_split=tps, sm_scale=sm_scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if rows > MAX_ROWS or e > MAX_E or e % 4:
        raise ValueError(f"unsupported verify shape: {rows} rows, E={e}")
    quantized = check_paged(q, k_pages, v_pages, page_table, k_scales,
                            v_scales, kv_lens, q_starts)
    name = entry_point(q.dtype, quantized)
    if q.dtype == torch.bfloat16:
        check_bf16(rows // spec, e, q, k_pages, v_pages)
    lib = _build.library("paged_verify_attention")
    o = torch.empty_like(q)
    m_part = torch.empty((b * hkv, n_split, rows), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * hkv, n_split, rows, e), dtype=torch.float32,
                           device=q.device)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quantized:
        args += [k_scales.data_ptr(), v_scales.data_ptr()]
    args += [page_table.data_ptr(), kv_lens.data_ptr(), q_starts.data_ptr(),
             o.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
             acc_part.data_ptr(), b, hkv, rows, rows // spec, n_pages,
             page_size, max_pages, e, n_split, tps, float(scale)]
    if quantized:
        args.append(_build.dtype_code(q.dtype))
    err = getattr(lib, name)(*args, _build.stream_handle(q.device))
    _build.check(lib, err, name)
    LAUNCHES["paged_verify_int8" if quantized else "paged_verify"] += 1
    return o
