"""Split-KV one-token decode attention: kernel B4.

Port of ``repro/kernels/decode_attention.py`` (``decode_attention_flat``).
For each (b, kv head) the G query heads of its GQA group attend to the
dense cache rows [0, kv_len), with one ``kv_len`` per row of the batch
read from a device tensor. The CUDA kernels (``csrc/decode_attention.cu``)
split the KV tiles over ``n_split`` blocks per (b, kv head); each walks
its tiles with an online max and sum, skipping rows at or past
``kv_len``, and a second pass merges the partial (m, l, acc) triples.

The forms, chosen by ``entry_point`` from the dtypes, with nothing
falling back from one to another:

* a bf16 q on bf16 caches (``decode_bf16_launch``) or on int8 caches
  (``decode_int8_launch``), head dim 64 or 128, G <= 16: the tensor-core
  design of ``csrc/decode_tc.cuh`` on short splits of 1-4 tiles
  (``decode_split_plan``), so the longest sequence of a ragged batch
  spreads over every SM; an int8 slice is converted to bf16 (exactly) in
  shared memory. A bf16 shape it does not take raises.
* an fp32 q (``decode_fp32_launch``, or ``decode_int8_launch`` on int8
  caches): the CUDA-core kernel on ``split_plan``.

An int8 cache carries one fp32 scale per row (``k_scale``/``v_scale``,
(B·Hkv, S)): the K scale multiplies the score column after q·k, the V
scale folds into P after the row sum and before the P·V product, as the
TPU kernel does.

``decode_attention_plain`` computes the same function in PyTorch with the
kernel's split, tile order, masking and merge; the wrapper runs it for
CPU tensors only. It also serves the paged kernels B6 and B7 (through a
gather of the pages), whose rows may sit at their own positions.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy import KV_TILE
from repro_torch.kernels import _build
from repro_torch.kernels.common import NEG_INF

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts),
# by branch: bf16/fp32 caches and int8 caches.
LAUNCHES = {"decode": 0, "decode_int8": 0}

# Enough (b·h, split) blocks to give each of the H100's 132 SMs two.
TARGET_BLOCKS = 264
MAX_G = 16
MAX_E = 256


def check_scales(k, v, k_scale, v_scale, scale_shape) -> bool:
    """Whether the caches are int8 with scales; raises unless either both
    scales of ``scale_shape`` come with int8 caches, or none do with
    caches of the query's kind."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k and v scales, or neither")
    if k_scale is None:
        if k.dtype == torch.int8 or v.dtype == torch.int8:
            raise ValueError("int8 caches need their scales")
        return False
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("scales come with int8 caches only")
    for t in (k_scale, v_scale):
        if (tuple(t.shape) != tuple(scale_shape) or t.dtype != torch.float32
                or t.device != k.device or not t.is_contiguous()):
            raise ValueError(f"scales must be contiguous fp32 "
                             f"{tuple(scale_shape)} on the caches' device")
    return True


# The bf16 forms of B4, B6 and B7: the head dims they are built for, and
# the most 64-row tiles a split of theirs takes.
BF16_HEAD_DIMS = (64, 128)
TC_MAX_TILES = 4


def split_plan(bh: int, n_kv: int, blk_kv: int = KV_TILE) -> tuple[int, int]:
    """(n_split, tiles_per_split) covering ``n_kv`` cache rows."""
    n_tiles = max(1, -(-n_kv // blk_kv))
    n_split = min(n_tiles, max(1, -(-TARGET_BLOCKS // bh)))
    tiles_per_split = -(-n_tiles // n_split)
    n_split = -(-n_tiles // tiles_per_split)
    return n_split, tiles_per_split


def decode_split_plan(q_dtype, bh: int, n_kv: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) of B4, B6 and B7 covering ``n_kv`` rows
    of ``bh`` (b, kv head) rows of a cache (dense or paged). The form, and
    so the plan, follows the query's dtype, on bf16 and on int8 caches
    alike. A bf16 q: the short splits of the tensor-core forms, as few
    tiles a block as keep the grid near ``TARGET_BLOCKS`` blocks, at least
    1 and at most ``TC_MAX_TILES``. An fp32 q: ``split_plan``."""
    if q_dtype != torch.bfloat16:
        return split_plan(bh, n_kv)
    n_tiles = max(1, -(-n_kv // KV_TILE))
    tps = min(TC_MAX_TILES, max(1, -(-n_tiles * bh // TARGET_BLOCKS)))
    return -(-n_tiles // tps), tps


def entry_point(dtype, quantized: bool) -> str:
    """The C function a CUDA q of ``dtype`` launches: the int8 one for int8
    caches (tensor cores for a bf16 q, CUDA cores for fp32), else the
    tensor-core one for bf16 and the CUDA-core one for fp32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the decode kernel takes float32 or bfloat16, "
                        f"not {dtype}")
    if quantized:
        return "decode_int8_launch"
    return ("decode_bf16_launch" if dtype == torch.bfloat16
            else "decode_fp32_launch")


def check_bf16(group: int, e: int, *tensors) -> None:
    """Raise unless the tensor-core form of B4, B6 or B7 takes GQA groups
    of ``group`` heads of head dim ``e`` in these tensors."""
    if e not in BF16_HEAD_DIMS or group > MAX_G:
        raise ValueError(f"the bf16 decode kernels take E in "
                         f"{BF16_HEAD_DIMS} and G <= {MAX_G}, not E={e}, "
                         f"G={group}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bf16 decode kernels copy 16-byte chunks: "
                         "their operands must be 16-byte aligned")


def _split_rows(x: torch.Tensor, n_split: int, span: int) -> torch.Tensor:
    """(BH, S, ...) fp32, zero-padded or cut to n_split·span rows, as
    (BH, n_split, span, ...)."""
    pad = max(0, n_split * span - x.shape[1])
    x = torch.nn.functional.pad(x.float(), (0, 0) * (x.dim() - 2) + (0, pad))
    return x[:, :n_split * span].reshape(x.shape[0], n_split, span,
                                         *x.shape[2:])


def decode_attention_plain(q, k, v, kv_lens, *, n_split: int,
                           tiles_per_split: int, blk_kv: int = KV_TILE,
                           sm_scale: float | None = None, k_scale=None,
                           v_scale=None, q_pos=None) -> torch.Tensor:
    """q: (BH, R, E); k, v: (BH, S, E), int8 with ``k_scale``/``v_scale``
    (BH, S) per-row fp32 scales; kv_lens: (BH,) int. Row r of q sees the
    keys at positions <= min(q_pos[:, r], kv_len - 1); without ``q_pos``
    every row sees the whole live context. Split ``sp`` covers tiles
    [sp·tps, (sp+1)·tps); all splits advance together."""
    bh, g, e = q.shape
    s_len = k.shape[1]
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    dev = q.device
    span = tiles_per_split * blk_kv
    kf = _split_rows(k, n_split, span)
    vf = _split_rows(v, n_split, span)
    quantized = k_scale is not None
    if quantized:
        ksf = _split_rows(k_scale, n_split, span)    # (BH, n_split, span)
        vsf = _split_rows(v_scale, n_split, span)
    kv_len = kv_lens.to(dev).clamp(max=s_len).view(bh, 1, 1, 1)
    pos = (q_pos.to(dev).view(bh, 1, g, 1) if q_pos is not None
           else kv_len - 1)
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
        if quantized:
            s = s * ksf[:, :, None, cols]
        s = torch.where((col < kv_len) & (col <= pos), s, NEG_INF)
        # rows past kv_len are zero-filled before the P·V product
        vt = torch.where((col < kv_len).transpose(-1, -2), vf[:, :, cols], 0.0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        if quantized:
            p = p * vsf[:, :, None, cols]     # V scales fold into P
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
    """One-token decode: q (BH, G, E) against caches (BH, S, E), of q's
    dtype, or int8 with ``k_scale``/``v_scale`` (BH, S) fp32 per-row
    scales.

    ``kv_lens`` is a (BH,) int32 tensor on q's device. ``max_kv_len``, when
    the caller knows it on the host, sizes the split to the live rows
    instead of the whole cache; ``decode_split_plan`` plans it for the
    form q's dtype chooses. A CUDA tensor launches B4; a CPU tensor runs
    the plain version with the same split.
    """
    bh, g, e = q.shape
    s_len = k.shape[1]
    if k.shape != (bh, s_len, e) or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv_lens.shape != (bh,):
        raise ValueError(
            f"kv_lens must be ({bh},), got {tuple(kv_lens.shape)}")
    quantized = check_scales(k, v, k_scale, v_scale, (bh, s_len))
    n_kv = s_len if max_kv_len is None else min(max_kv_len, s_len)
    n_split, tps = decode_split_plan(q.dtype, bh, n_kv)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_lens, n_split=n_split,
                                      tiles_per_split=tps, sm_scale=sm_scale,
                                      k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if g > MAX_G or e > MAX_E or e % (16 if quantized else 4):
        raise ValueError(f"unsupported decode shape: G={g}, E={e}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device or (
            not quantized and (k.dtype != q.dtype or v.dtype != q.dtype)):
        raise ValueError("q, k and v must share one device, and one dtype "
                         "unless the caches are int8")
    if kv_lens.dtype != torch.int32 or kv_lens.device != q.device:
        raise ValueError("kv_lens must be int32 on q's device")
    name = entry_point(q.dtype, quantized)
    if q.dtype == torch.bfloat16:
        check_bf16(g, e, q, k, v)
    lib = _build.library("decode_attention")
    o = torch.empty_like(q)
    m_part = torch.empty((bh, n_split, g), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((bh, n_split, g, e), dtype=torch.float32,
                           device=q.device)
    scale = (e ** -0.5) if sm_scale is None else sm_scale
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if quantized:
        args += [k_scale.data_ptr(), v_scale.data_ptr()]
    args += [kv_lens.data_ptr(), o.data_ptr(), m_part.data_ptr(),
             l_part.data_ptr(), acc_part.data_ptr(), bh, g, s_len, e,
             n_split, tps, float(scale)]
    if quantized:
        args.append(_build.dtype_code(q.dtype))
    err = getattr(lib, name)(*args, _build.stream_handle(q.device))
    _build.check(lib, err, name)
    LAUNCHES["decode_int8" if quantized else "decode"] += 1
    return o
