#!/usr/bin/env python3
"""Time builds of B5's bf16 form from several versions of its source,
side by side in one process.

Each argument is ``name=path`` to a version of
``src/repro_torch/kernels/csrc/paged_prefill_attention.cu`` (the first is
the baseline). Each is compiled by ``nvcc`` with the port's flags into a
library of its own and loaded by ``ctypes``; a version whose
``paged_prefill_bf16_launch`` takes ``q_offset`` and ``kv_len`` as
launch integers (before they moved to the device) is called so, a later
one with the pair on the device. Every version runs the paged prefill
rows of ``chip_smoke.py`` (16 query and 8 kv heads of 128, a 512-row
chunk at q_offset 3072 and 0, pools of 2049 pages of 16 rows, 256 table
pages) on bf16 and on int8 pools, must give the baseline's bits, and is
timed, 11 rounds in rotating order, by CUDA events over a loop of 200
calls back to back (``ms``) and, as ``chip_smoke.py`` times device time,
over single calls each behind a device-side wait (``device_ms``). Libraries and logs go to ``build/b5_variants/``. Prints one JSON
line a shape with each version's median ``ms`` and ``device_ms`` and
their differences from the baseline, then the card, its power limit and each version's registers.
Run from the repository root on a machine with a CUDA card and ``nvcc``
(~30 s), for example with the parent's source unpacked into ``build/``:

    python3 scripts/b5_variants.py \
        parent=build/parent/src/repro_torch/kernels/csrc/paged_prefill_attention.cu \
        change=src/repro_torch/kernels/csrc/paged_prefill_attention.cu
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
SHAPES = ((3072, 3584), (0, 512))          # (q_offset, kv_len)
HQ, HKV, E, PAGE, N_PAGES, MAX_PAGES, NQ = 16, 8, 128, 16, 2049, 256, 512
ROUNDS, CALLS = 11, 200


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels import _build

    sys.path.insert(0, str(REPO))
    from chip_smoke import hidden_ms, ptxas_report

    if not torch.cuda.is_available() or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    versions = dict(a.split("=", 1) for a in argv)
    out = REPO / "build" / "b5_variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *flags, "-o", str(out / f"lib{name}.so"), path],
        stdout=open(out / f"{name}.log", "w"), stderr=subprocess.STDOUT)
        for name, path in versions.items()}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch, on_device = {}, {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            print((out / f"{name}.log").read_text()[-3000:], file=sys.stderr)
            return 1
        on_device[name] = "const void* span" in Path(
            versions[name]).read_text()
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).paged_prefill_bf16_launch
        fn.argtypes = ([P] * 8 + [I] * 7 if on_device[name]
                       else [P] * 7 + [I] * 8) + [F, I, P]
        fn.restype = ctypes.c_int
        launch[name] = fn

    torch.manual_seed(0)
    pools = {False: [torch.randn(HKV, N_PAGES, PAGE, E, device="cuda")
                     .bfloat16() for _ in range(2)],
             True: [torch.randint(-127, 128, (HKV, N_PAGES, PAGE, E),
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2)]}
    scales = [torch.rand(HKV, N_PAGES, device="cuda") * 0.02
              for _ in range(2)]
    table = (torch.randperm(N_PAGES - 1, device="cuda")[:MAX_PAGES] + 1
             ).to(torch.int32)
    q = torch.randn(HQ, NQ, E, device="cuda").bfloat16()
    outs = {name: torch.empty_like(q) for name in versions}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, quantized, q0, kv_len, span):
        k, v = pools[quantized]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                scales[0].data_ptr() if quantized else None,
                scales[1].data_ptr() if quantized else None,
                table.data_ptr()]
        if on_device[name]:
            args += [span.data_ptr(), outs[name].data_ptr(), HQ, NQ, E,
                     HQ // HKV, N_PAGES, PAGE, MAX_PAGES]
        else:
            args += [outs[name].data_ptr(), HQ, NQ, E, HQ // HKV, N_PAGES,
                     PAGE, q0, kv_len]
        err = launch[name](*args, E ** -0.5, int(quantized), stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    names = list(versions)
    base = names[0]
    for quantized in (False, True):
        for q0, kv_len in SHAPES:
            span = torch.tensor([q0, kv_len], dtype=torch.int32,
                                device="cuda")
            for name in names:
                call(name, quantized, q0, kv_len, span)
            torch.cuda.synchronize()
            same = {n: bool(torch.equal(outs[n], outs[base])) for n in names}
            times = {n: [] for n in names}
            device = {n: [] for n in names}
            for rnd in range(ROUNDS):
                k = rnd % len(names)
                for name in names[k:] + names[:k]:
                    for _ in range(5):
                        call(name, quantized, q0, kv_len, span)
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    for _ in range(CALLS):
                        call(name, quantized, q0, kv_len, span)
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / CALLS)
                    device[name].append(hidden_ms(
                        torch, lambda name=name: call(
                            name, quantized, q0, kv_len, span), 20)[0])
            med = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
            dmed = {n: sorted(t)[len(t) // 2] for n, t in device.items()}
            print(json.dumps({
                "pool": "int8" if quantized else "bf16", "q_offset": q0,
                "kv_len": kv_len, "median_ms": med,
                "from_baseline": {n: med[n] / med[base] - 1 for n in names},
                "median_device_ms": dmed,
                "device_from_baseline": {
                    n: dmed[n] / dmed[base] - 1 for n in names},
                "same_bits": same, "ms": times, "device_ms": device}),
                flush=True)
            if not all(same.values()):
                return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    for name in names:
        report = ptxas_report((out / f"{name}.log").read_text())
        print(json.dumps({"version": name, "ptxas": {
            k: v for k, v in report.items()
            if "paged_prefill_bf16_kernel" in k}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
