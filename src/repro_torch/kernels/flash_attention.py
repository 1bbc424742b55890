"""Online-softmax attention: kernel B3.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_flat``).
One CUDA thread block (``csrc/flash_attention.cu``) owns one (b·h, Q row
block) and walks the KV tiles in order with a running max and sum, so
its working set is one (blk_q, blk_kv) tile rather than a full score row.
It serves rows too long for the MAS row buffer and every sliding-window
call. Whole tiles above the causal diagonal or outside the window are
skipped; only boundary tiles are masked; query row i sits at absolute
position ``q_offset + i``; rows that saw no key (l == 0) divide by 1.

The fp32 form (``flash_attention_fp32_launch``) runs its products on the
CUDA cores at the caller's ``blk_q``. The bf16 form
(``flash_attention_bf16_launch``, head dim 64, 128 or 256) runs them on
the tensor cores by ``wgmma``, with S and P in registers and K/V tiles
double-buffered by ``cp.async``, in blocks of its own height,
``FLASH_BLK_Q_BF16`` (64) rows, to which ``ops.attention`` pads the query
rows; at head dim 256 a block is two warpgroups, each with one half of
the output columns. ``entry_point`` chooses by dtype; a bf16 tensor the
tensor-core kernel does not take raises.

``flash_attention_plain`` computes the same function in PyTorch with the
kernel's tile order, skips and masks; the wrapper runs it for CPU
tensors only. For each KV tile it computes only the Q blocks that run it
(a contiguous range under the causal and window skips), so a windowed
call costs the window's work, not the whole score matrix.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import FLASH_BLK_Q_BF16, KV_TILE
from repro_torch.kernels import _build
from repro_torch.kernels.common import NEG_INF, check_prefill_tile

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts):
# the bf16 form at head dim 256 (its own kernel) apart from the rest.
LAUNCHES = {"flash": 0, "flash_e256": 0}
# The bf16 form's head dims.
BF16_HEAD_DIMS = (64, 128, 256)


def launch_key(dtype, e: int) -> str:
    """The ``LAUNCHES`` entry a launch of ``dtype`` at head dim ``e``
    counts in."""
    return "flash_e256" if dtype == torch.bfloat16 and e == 256 else "flash"


def check_bf16(blk_q: int, e: int, *tensors) -> None:
    """Raise unless the bf16 form takes blocks of ``blk_q`` rows at head
    dim ``e`` in these tensors."""
    if blk_q != FLASH_BLK_Q_BF16 or e not in BF16_HEAD_DIMS:
        raise ValueError(f"the bf16 flash kernel takes blk_q "
                         f"{FLASH_BLK_Q_BF16} and E in {BF16_HEAD_DIMS}, "
                         f"not blk_q={blk_q}, E={e}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bf16 flash kernel copies 16-byte chunks: "
                         "q, k and v must be 16-byte aligned")


def entry_point(dtype) -> str:
    """The C function a CUDA tensor of ``dtype`` launches: the tensor-core
    kernel in bf16, the CUDA-core kernel in fp32. Nothing falls back from
    one to the other."""
    if dtype == torch.bfloat16:
        return "flash_attention_bf16_launch"
    if dtype == torch.float32:
        return "flash_attention_fp32_launch"
    raise TypeError(f"the flash kernel takes float32 or bfloat16, not {dtype}")


def flash_attention_plain(q, k, v, *, blk_q: int, blk_kv: int,
                          causal: bool = False, window: int | None = None,
                          sm_scale: float | None = None, q_offset: int = 0,
                          kv_len: int | None = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """q: (BHq, Nq, E); k, v: (BHkv, Nkv, E), int8 with
    ``k_scale``/``v_scale`` (BHkv, Nkv) per-row fp32 scales (B5's int8
    branch). The Q row blocks advance together through the KV tiles; a
    block skips a tile by keeping its running (m, l, acc) unchanged, and
    only the blocks that run a tile, a contiguous range, compute it."""
    bhq, nq, e = q.shape
    bhkv, n, _ = k.shape
    group = bhq // bhkv
    nqb, nkv = nq // blk_q, n // blk_kv
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    dev = q.device
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    quantized = k_scale is not None
    if quantized:
        ks = k_scale.float().repeat_interleave(group, dim=0)[:, None, None]
        vs = v_scale.float().repeat_interleave(group, dim=0)[:, None, None]
    qb = q.float().reshape(bhq, nqb, blk_q, e)
    row0 = torch.arange(nqb) * blk_q + q_offset                 # (nqb,)
    rows = (row0.view(nqb, 1) + torch.arange(blk_q)).view(
        nqb, blk_q, 1).to(dev)
    banded = causal or window is not None

    m = torch.full((bhq, nqb, blk_q, 1), NEG_INF, device=dev)
    l = torch.zeros((bhq, nqb, blk_q, 1), device=dev)
    acc = torch.zeros((bhq, nqb, blk_q, e), device=dev)
    for j in range(nkv):
        col0 = j * blk_kv
        # the blocks that run tile j (on the host: row0 is arithmetic)
        run = torch.ones((nqb,), dtype=torch.bool)
        if banded:
            run = col0 <= row0 + blk_q - 1
        if window is not None:
            run = run & (col0 + blk_kv - 1 > row0 - window)
        live = torch.nonzero(run).view(-1)
        if live.numel() == 0:
            continue
        blocks = slice(int(live[0]), int(live[-1]) + 1)
        cols = slice(col0, col0 + blk_kv)
        s = torch.einsum("bnqe,bke->bnqk", qb[:, blocks], kf[:, cols]) * scale
        if quantized:
            s = s * ks[..., cols]
        col = torch.arange(col0, col0 + blk_kv, device=dev).view(1, 1, blk_kv)
        r = rows[blocks]
        keep = torch.ones(s.shape[1:], dtype=torch.bool, device=dev)
        if banded:
            keep = keep & (col <= r)
        if window is not None:
            keep = keep & (col > r - window)
        if kv_len is not None:
            keep = keep & (col < kv_len)
        s = torch.where(keep, s, NEG_INF)
        m_old = m[:, blocks]
        m_new = torch.maximum(m_old, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_old - m_new)
        l[:, blocks] = l[:, blocks] * alpha + p.sum(dim=-1, keepdim=True)
        if quantized:
            p = p * vs[..., cols]            # V scales fold into P
        acc[:, blocks] = (acc[:, blocks] * alpha
                          + torch.einsum("bnqk,bke->bnqe", p, vf[:, cols]))
        m[:, blocks] = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(bhq, nq, e).to(q.dtype)


def flash_attention_flat(q, k, v, *, blk_q: int, blk_kv: int = KV_TILE,
                         causal: bool = False, window: int | None = None,
                         sm_scale: float | None = None, q_offset: int = 0,
                         kv_len: int | None = None) -> torch.Tensor:
    """Online-softmax attention on (BHq, Nq, E) x (BHkv, Nkv, E).

    A CUDA tensor launches B3; a CPU tensor runs the plain version.
    """
    bhq, nq, e = q.shape
    bhkv, n, _ = k.shape
    if bhq % bhkv or nq % blk_q or n % blk_kv:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} do not "
                         f"tile by ({blk_q}, {blk_kv})")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if kv_len is not None and kv_len >= n:
        kv_len = None
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, blk_q=blk_q, blk_kv=blk_kv, causal=causal,
            window=window, sm_scale=sm_scale, q_offset=q_offset,
            kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if blk_kv != KV_TILE:
        raise ValueError(f"the CUDA kernel uses {KV_TILE}-row KV tiles, "
                         f"not {blk_kv}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device:
        raise ValueError("q, k and v must share one dtype and device")
    name = entry_point(q.dtype)
    shape = [bhq, nq, n, e, bhq // bhkv, blk_q]
    if name == "flash_attention_bf16_launch":
        check_bf16(blk_q, e, q, k, v)
        shape.pop()         # its block height is its own
    else:
        check_prefill_tile(blk_q, e)    # the CUDA-core form's thread layout
    lib = _build.library("flash_attention")
    o = torch.empty_like(q)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *shape,
        int(causal), 0 if window is None else int(window), int(q_offset),
        n if kv_len is None else int(kv_len), float(scale),
        _build.stream_handle(q.device))
    _build.check(lib, err, name)
    LAUNCHES[launch_key(q.dtype, e)] += 1
    return o
