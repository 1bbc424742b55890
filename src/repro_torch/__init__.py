"""PyTorch + CUDA port of the MAS-Attention serving stack.

``repro_torch`` mirrors the layout of the JAX package ``repro`` (which
stays the reference) for the slice that serves a dense GQA decoder:
configs, the dense transformer, the attention kernels behind
``kernels/ops.py`` and the wave ``ServingEngine``. Every Pallas kernel on
that path has a hand-written CUDA kernel for Hopper (``kernels/csrc``)
with a plain PyTorch version beside it; a wrapper runs the plain version
only for tensors on the CPU.

Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA
on a machine without it raises instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
