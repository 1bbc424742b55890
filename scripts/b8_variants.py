#!/usr/bin/env python3
"""Time builds of B8's bf16 form from several versions of its source,
side by side in one process.

Each argument is ``name=path``, or ``name=path:-DFLAG,-DFLAG`` to build
``path`` with preprocessor flags, a version of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` whose
``ssd_intra_chunk_bf16_launch`` takes (x, a, b, c, y, states, cells, Q,
N, P, stream); the first is the baseline. Each is compiled by ``nvcc``
with the port's flags into a library of its own and loaded by
``ctypes``. Every version runs ``chip_smoke.py``'s B8 row, the 4 x 2048
wave of full-width mamba2-130m (768 cells of 256 rows, head_dim 64,
d_state 128; bf16 x, b, c and fp32 a at the model's decay), and is timed,
11 rounds in rotating order, over single calls each behind a device-side
wait (``device_ms``, as ``chip_smoke.py`` times device time). Prints one
JSON line with each version's median device time, its ratio to the
baseline's and its output's largest row error against the plain version
(a version that leaves work out on purpose shows it there), then the
card, its power limit and each version's registers and spills.
Libraries and logs go to ``build/b8_variants/``. Run from the repository
root on a machine with a CUDA card and ``nvcc`` (~30 s):

    python3 scripts/b8_variants.py \\
        base=src/repro_torch/kernels/csrc/ssd_scan.cu \\
        other=path/to/ssd_scan.cu:-DSOME_FLAG
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
BATCH, HEADS, NC, Q, P, N = 4, 24, 8, 256, 64, 128
ROUNDS = 11


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    sys.path.insert(0, str(REPO))
    from chip_smoke import hidden_ms, ptxas_report, row_rel_err, ssd_inputs

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    versions = {}
    for arg in argv:
        name, spec = arg.split("=", 1)
        path, _, defines = spec.partition(":")
        versions[name] = (path, [d for d in defines.split(",") if d])
    out = REPO / "build" / "b8_variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *flags, *defines, "-o", str(out / f"lib{name}.so"),
         path], stdout=open(out / f"{name}.log", "w"),
        stderr=subprocess.STDOUT)
        for name, (path, defines) in versions.items()}
    launch = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            print((out / f"{name}.log").read_text()[-3000:], file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).ssd_intra_chunk_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(6)
    x, a, b, c = ssd_inputs(torch, gen, BATCH, HEADS, NC, Q, P, N,
                            torch.bfloat16)
    cells = BATCH * HEADS * NC
    want = ssd.ssd_intra_chunk_plain(x, a, b, c)
    outs = {name: (torch.empty_like(want[0]), torch.empty_like(want[1]))
            for name in versions}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        y, states = outs[name]
        err = launch[name](x.data_ptr(), a.data_ptr(), b.data_ptr(),
                           c.data_ptr(), y.data_ptr(), states.data_ptr(),
                           cells, Q, N, P, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    names = list(versions)
    for name in names:
        call(name)
    torch.cuda.synchronize()
    errs = {n: max(row_rel_err(g, w) for g, w in zip(outs[n], want))
            for n in names}
    device = {n: [] for n in names}
    for rnd in range(ROUNDS):
        k = rnd % len(names)
        for name in names[k:] + names[:k]:
            device[name].append(hidden_ms(torch, lambda n=name: call(n),
                                          20)[0])
    med = {n: sorted(t)[len(t) // 2] for n, t in device.items()}
    print(json.dumps({
        "cells": cells, "q": Q, "n": N, "p": P, "median_device_ms": med,
        "from_baseline": {n: med[n] / med[names[0]] for n in names},
        "row_rel_err": errs, "device_ms": device}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    for name in names:
        report = ptxas_report((out / f"{name}.log").read_text())
        print(json.dumps({"version": name, "ptxas": {
            k: v for k, v in report.items() if "bf16" in k}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
