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
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-2b": "internvl2_2b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_arch(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def get_smoke(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE
