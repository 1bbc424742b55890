"""Attention backends used inside the model, selected by ``attn_impl``.

Port of the dense part of ``repro/models/attention.py``:

* ``kernel`` — ``kernels/ops.py``: the policy-routed MAS / flash kernels
  for full sequences and the split-KV decode kernel, as CUDA kernels on
  a CUDA tensor and their plain versions on a CPU tensor (the
  reference's ``pallas``);
* ``plain`` — the exact oracle in ``kernels/ref.py`` (the reference's
  ``xla_full``).

All functions take q: (B, Hq, Nq, E), k/v: (B, Hkv, Nkv, E).
"""

from __future__ import annotations

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

IMPLS = ("kernel", "plain")


def attention(q, k, v, *, impl: str = "kernel", causal: bool = True,
              window: int | None = None):
    if impl == "kernel":
        return kops.attention(q, k, v, causal=causal, window=window)
    if impl == "plain":
        return kref.attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attn impl {impl!r}")


def decode_attention(q, k_cache, v_cache, kv_len, *, impl: str = "kernel"):
    """q: (B, Hq, E) against dense caches (B, Hkv, S, E), masked at
    ``kv_len`` (an int, or a (B,) tensor)."""
    if impl == "kernel":
        return kops.decode_attention(q, k_cache, v_cache, kv_len)
    if impl == "plain":
        return kref.decode_attention(q, k_cache, v_cache, kv_len)
    raise ValueError(f"unknown attn impl {impl!r}")
