"""Split-KV one-token decode attention: kernel B4.

Port of ``repro/kernels/decode_attention.py`` (``decode_attention_flat``),
the bf16/fp32 cache branch. For each (b, kv head) the G query heads of
its GQA group attend to the dense cache rows [0, kv_len), with one
``kv_len`` per row of the batch read from a device tensor. The CUDA
kernel (``csrc/decode_attention.cu``) splits the KV tiles over
``n_split`` blocks per (b, kv head); each walks its tiles with an online
max and sum, skipping tiles at or past ``kv_len``, and a second pass
merges the partial (m, l, acc) triples.

The int8 branch of the TPU kernel (``k_scale``/``v_scale``) is not
ported yet: the wrapper raises ``NotImplementedError`` when given scales.

``decode_attention_plain`` computes the same function in PyTorch with the
kernel's split, tile order, masking and merge; the wrapper runs it for
CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import KV_TILE
from repro_torch.kernels import _build
from repro_torch.kernels.common import NEG_INF

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = {"decode": 0}

# Enough (b·h, split) blocks to give each of the H100's 132 SMs two.
TARGET_BLOCKS = 264
MAX_G = 16
MAX_E = 256


def split_plan(bh: int, n_kv: int, blk_kv: int = KV_TILE) -> tuple[int, int]:
    """(n_split, tiles_per_split) covering ``n_kv`` cache rows."""
    n_tiles = max(1, -(-n_kv // blk_kv))
    n_split = min(n_tiles, max(1, -(-TARGET_BLOCKS // bh)))
    tiles_per_split = -(-n_tiles // n_split)
    n_split = -(-n_tiles // tiles_per_split)
    return n_split, tiles_per_split


def decode_attention_plain(q, k, v, kv_lens, *, n_split: int,
                           tiles_per_split: int, blk_kv: int = KV_TILE,
                           sm_scale: float | None = None) -> torch.Tensor:
    """q: (BH, G, E); k, v: (BH, S, E); kv_lens: (BH,) int. Split ``sp``
    covers tiles [sp·tps, (sp+1)·tps); all splits advance together."""
    bh, g, e = q.shape
    s_len = k.shape[1]
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    dev = q.device
    span = tiles_per_split * blk_kv
    pad = n_split * span - s_len
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, max(pad, 0)))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, max(pad, 0)))
    kf = kf[:, :n_split * span].reshape(bh, n_split, span, e)
    vf = vf[:, :n_split * span].reshape(bh, n_split, span, e)
    kv_len = kv_lens.to(dev).clamp(max=s_len).view(bh, 1, 1, 1)
    qf = q.float()

    m = torch.full((bh, n_split, g, 1), NEG_INF, device=dev)
    l = torch.zeros((bh, n_split, g, 1), device=dev)
    acc = torch.zeros((bh, n_split, g, e), device=dev)
    split0 = torch.arange(n_split, device=dev).view(1, n_split, 1, 1) * span
    for t in range(tiles_per_split):
        cols = slice(t * blk_kv, (t + 1) * blk_kv)
        col = split0 + t * blk_kv + torch.arange(blk_kv, device=dev).view(
            1, 1, 1, blk_kv)                             # absolute kv position
        live = (split0 + t * blk_kv) < kv_len            # tile has a live row
        if not bool(live.any()):
            break
        s = torch.einsum("bge,bske->bsgk", qf, kf[:, :, cols]) * scale
        s = torch.where(col < kv_len, s, NEG_INF)
        # rows past kv_len are zero-filled before the P·V product
        vt = torch.where((col < kv_len).transpose(-1, -2), vf[:, :, cols], 0.0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bsgk,bske->bsge", p, vt)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)

    # Merge the splits: M = max m, L = sum l e^(m - M),
    # O = sum acc e^(m - M) / L.
    m_max = m.amax(dim=1, keepdim=True)
    w = torch.exp(m - m_max)
    l_tot = (l * w).sum(dim=1)
    num = (acc * w).sum(dim=1)
    l_tot = torch.where(l_tot == 0.0, 1.0, l_tot)
    return (num / l_tot).to(q.dtype)


def decode_attention_flat(q, k, v, kv_lens, *, sm_scale: float | None = None,
                          max_kv_len: int | None = None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """One-token decode: q (BH, G, E) against caches (BH, S, E).

    ``kv_lens`` is a (BH,) int32 tensor on q's device. ``max_kv_len``, when
    the caller knows it on the host, sizes the split to the live rows
    instead of the whole cache. A CUDA tensor launches B4; a CPU tensor
    runs the plain version.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the int8 branch of decode attention is not ported yet")
    bh, g, e = q.shape
    s_len = k.shape[1]
    if k.shape != (bh, s_len, e) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv_lens.shape != (bh,):
        raise ValueError(
            f"kv_lens must be ({bh},), got {tuple(kv_lens.shape)}")
    n_kv = s_len if max_kv_len is None else min(max_kv_len, s_len)
    n_split, tps = split_plan(bh, n_kv)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_lens, n_split=n_split,
                                      tiles_per_split=tps, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if g > MAX_G or e > MAX_E or e % 4:
        raise ValueError(f"unsupported decode shape: G={g}, E={e}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device:
        raise ValueError("q, k and v must share one dtype and device")
    if kv_lens.dtype != torch.int32 or kv_lens.device != q.device:
        raise ValueError("kv_lens must be int32 on q's device")
    lib = _build.library("decode_attention")
    o = torch.empty_like(q)
    m_part = torch.empty((bh, n_split, g), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((bh, n_split, g, e), dtype=torch.float32,
                           device=q.device)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lens.data_ptr(),
        o.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        acc_part.data_ptr(), bh, g, s_len, e, n_split, tps, float(scale),
        _build.dtype_code(q.dtype), _build.stream_handle(q.device))
    _build.check(lib, err, "decode_attention_launch")
    LAUNCHES["decode"] += 1
    return o
