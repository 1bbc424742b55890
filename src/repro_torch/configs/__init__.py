"""Registry of the architectures the port serves.

Mirrors ``repro/configs``: ``get_arch`` gives the published widths,
``get_smoke`` the tiny test configuration of the same family.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-130m": "mamba2_130m",
}


def get_arch(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def get_smoke(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE
