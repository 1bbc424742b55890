"""Registry of the architectures the port serves and their shape cells.

Mirrors ``repro/configs``: ``get_arch`` gives the published widths,
``get_smoke`` the tiny test configuration of the same family;
``SHAPES`` are the reference's (arch x shape) cells, which
``analysis/flops.py`` counts.
"""

from __future__ import annotations

import dataclasses
import importlib

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "internvl2-2b": "internvl2_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-130m": "mamba2_130m",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS = tuple(_MODULES)

# archs whose attention is sub-quadratic in cache/state (long_500k runs)
SUBQUADRATIC = ("recurrentgemma-9b", "mamba2-130m")


def get_arch(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH


def get_smoke(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(arch_id: str, shape_id: str) -> tuple[bool, str]:
    """Apply the assignment's skip rules."""
    if shape_id == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, "skipped (pure full attention; needs sub-quadratic)"
    return True, ""


def all_cells():
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = cell_is_runnable(a, s)
            yield a, s, ok, why
