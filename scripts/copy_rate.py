#!/usr/bin/env python3
"""Measure how fast a thread block pulls L2-resident data into shared
memory on the card, by copy mechanism (``scripts/copy_rate.cu``):
cp.async 16 bytes a thread, one TMA bulk copy a stage, loads through
registers (synchronous, and two stages ahead). One block an SM (132
blocks) and two (264). Prints one JSON line a case: bytes a clock a
block (from each block's SM clock) and the card's aggregate TB/s, then
the card's name and power limit.

    python3 scripts/copy_rate.py

Needs a CUDA card and ``nvcc``; builds into ``build/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODES = {0: "cp.async 16 B", 1: "TMA bulk 8 KB", 2: "registers, sync",
         3: "registers, 2 ahead"}
ITERS, WINDOW, STAGE = 2000, 128, 8192   # 128 stages of 8 KB: 1 MB


def main() -> int:
    sys.path.insert(0, str(REPO / "src"))
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    out = REPO / "build" / "libcopy_rate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(out), str(REPO / "scripts" / "copy_rate.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.copy_rate_run.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    src = torch.randn(WINDOW * STAGE // 4, device="cuda")
    clocks = torch.zeros(1024, dtype=torch.int64, device="cuda")
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    ms = ctypes.c_float()
    for blocks in (132, 264):
        for mode, name in MODES.items():
            for stages in ((2, 3) if mode < 2 else (2,)):
                err = lib.copy_rate_run(mode, src.data_ptr(), blocks, 256,
                                        ITERS, stages, WINDOW,
                                        clocks.data_ptr(), sink.data_ptr(),
                                        ctypes.byref(ms))
                torch.cuda.synchronize()
                if err:
                    print(f"error: {name}: CUDA error {err}", file=sys.stderr)
                    return 1
                clk = float(clocks[:blocks].double().mean())
                print(json.dumps({
                    "blocks": blocks, "mode": name, "stages": stages,
                    "bytes_per_clock_a_block": ITERS * STAGE / clk,
                    "aggregate_tb_s": blocks * ITERS * STAGE
                    / (ms.value * 1e-3) / 1e12}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
