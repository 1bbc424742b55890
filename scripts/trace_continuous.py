#!/usr/bin/env python3
"""Trace the serving paths of the PyTorch port on one GPU.

Serves full-width internlm2-1.8b (bf16, random weights from seed 0) on
six paths and full-width mamba2-130m on one more, each once to warm up,
once untraced and once under ``torch.profiler``, and prints one JSON
line a path:

* ``continuous``: the requests of ``chip_smoke.py``'s continuous phase
  (16 requests with prompts of 32-3500 tokens from
  ``numpy.random.default_rng(0)`` and 32 new tokens each; batch 8,
  4096-token budget, 16-token pages, 512-token chunks): B5 and B6;
* ``int8_continuous``: the same requests on int8 pools
  (``kv_dtype="int8"``): B5's and B6's int8 forms and the requantizing
  appends;
* ``speculative``: the same lengths as ``chip_smoke.py``'s speculative
  phase (prompts that repeat one random 64-token span, seed 2), served
  with ``spec_depth=4``: B7 on its verify steps;
* ``speculative_int8``: the same on int8 pools: B7's int8 form;
* ``wave``: ``chip_smoke.py``'s 4 x 2048 wave through ``ServingEngine``
  (16 new tokens): B2 on the prefill, B4 on the decode steps;
* ``int8_wave``: the same wave on an int8 cache (``kv_dtype="int8"``):
  B4's int8 form;
* ``ssm_wave``: ``chip_smoke.py``'s main-path wave of mamba2-130m (bf16,
  random weights from seed 0), 4 x 2048 through ``ServingEngine`` with
  16 new tokens: B8 once a layer on the prefill (group ``B8
  ssd_intra_chunk``, both forms, also reported as ``b8``: launches and
  device ms), the one-token recurrence in PyTorch on the decode steps.

Each line holds the serve's wall time untraced and traced, the device's
busy share over the traced serve, the busy share and time of each step
kind (``decode``, ``chunk``, ``chunk+decode``, ``verify``; the wave's
``prefill`` and ``wave_decode``), and device time by kernel group and by
kernel. Kernels are grouped by name alone. The tensor-core forms of B4,
B6 and B7 (bf16 and int8 caches alike) and their merge passes have names
of their own; the CUDA-core pass 1 of B4's fp32-q forms
(``decode_split_kernel``, grouped with B4), of B6's and B7's
(``paged_split_kernel``) and the merge pass of every CUDA-core form
(``split_combine_kernel``) are groups of their own, which none of these
paths reaches (in trees before the int8 forms' move to the tensor cores
they held B4 int8, B6 and B7 int8); the per-kernel list keeps each
kernel's template arguments.
Tracing slows the host, not the device, so the device time is also set
against the untraced serve's wall time.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/trace_continuous.py [PATH ...]

Naming paths traces only those (each path takes minutes of the card).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CONT = dict(batch_size=8, max_len=4096, page_size=16, chunk_size=512)
REQUESTS, NEW_TOKENS, PROMPT_LENS = 16, 32, (32, 3500)
SPEC_DEPTH, SPEC_SPAN = 4, 64
WAVE, WAVE_NEW_TOKENS, WAVE_MAX_LEN = (4, 2048), 16, 8256
SSM_ARCH, SSM_WAVE = "mamba2-130m", (4, 2048)
PATHS = ("continuous", "int8_continuous", "speculative", "speculative_int8",
         "wave", "int8_wave", "ssm_wave")
DENSE = PATHS[:-1]
B8 = "B8 ssd_intra_chunk"
# kernel name fragments -> group, first match wins
GROUPS = (("paged_prefill", "B5 paged_prefill"),
          ("paged_verify", "B7 paged_verify"),
          ("paged_decode", "B6 paged_decode"),
          ("paged_split", "paged_split (CUDA-core B6 and B7 forms)"),
          ("split_combine", "split_combine (merge of the CUDA-core forms)"),
          ("decode_bf16", "B4 decode"), ("decode_split", "B4 decode"),
          ("mas_resident", "B1 mas_resident"),
          ("mas_streamed", "B2 mas_streamed"), ("flash", "B3 flash"),
          ("ssd_chunk", B8),
          ("gemm", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
          ("cutlass", "matmul"), ("Memcpy", "copies"), ("Memset", "copies"))


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "elementwise and other"


def merged(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def marked(torch, fn, kind_of):
    """``fn`` with each call inside a ``step:<kind>`` profiler range: its
    device work ends before the next step starts (every step ends in a
    device->host copy)."""
    def step(*args, **kw):
        with torch.profiler.record_function(f"step:{kind_of(*args, **kw)}"):
            return fn(*args, **kw)
    return step


def traced(torch, serve) -> tuple[float, float, dict]:
    """``serve`` warmed up, timed untraced, then traced: (untraced wall s,
    traced wall s, profile)."""
    serve()                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve()                               # the untraced time
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return untraced, wall, prof


def summary(torch, untraced: float, wall: float, prof) -> dict:
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device events, without the device-side copies of the step marks
    kernels = [e for e in events
               if e.device_type == cuda and not e.name.startswith("step:")]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    steps = sorted((e.time_range.start, e.name.split(":", 1)[1])
                   for e in events
                   if e.name.startswith("step:") and e.device_type != cuda)
    end_all = max(e for _, e in spans) if spans else 0.0
    by_kind: dict[str, dict] = {}
    for i, (start, kind) in enumerate(steps):
        stop = steps[i + 1][0] if i + 1 < len(steps) else end_all
        busy = merged([(max(s, start), min(e, stop)) for s, e in spans
                       if e > start and s < stop])
        row = by_kind.setdefault(kind, {"steps": 0, "wall_ms": 0.0,
                                        "device_ms": 0.0})
        row["steps"] += 1
        row["wall_ms"] += (stop - start) / 1e3
        row["device_ms"] += busy / 1e3
    for row in by_kind.values():
        row["busy_share"] = row["device_ms"] / row["wall_ms"]
        row["wall_ms_per_step"] = row["wall_ms"] / row["steps"]
        row["device_ms_per_step"] = row["device_ms"] / row["steps"]
    per_kernel: dict[str, list] = {}
    groups: dict[str, list] = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        entry = per_kernel.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += ms
        entry = groups.setdefault(group_of(e.name), [0, 0.0])
        entry[0] += 1
        entry[1] += ms
    device_ms = merged(spans) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "untraced_wall_s": untraced, "traced_wall_s": wall,
        "device_busy_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        # device time hardly changes under tracing, host time does
        "device_busy_share_of_untraced": device_ms / (untraced * 1e3),
        "kernel_launches": len(kernels), "by_step_kind": by_kind,
        "device_ms_by_group": {g: {"launches": n, "ms": ms}
                               for g, (n, ms) in groups.items()},
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms}
                        for n, (c, ms) in top],
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    paths = set(sys.argv[1:]) or set(PATHS)
    if paths - set(PATHS):
        print(f"error: unknown paths {sorted(paths - set(PATHS))}, "
              f"known: {PATHS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        Request,
        ServingEngine,
    )

    _build.build_all()
    if paths & set(DENSE):
        trace_dense(torch, np, paths, get_arch, build_model,
                    ContinuousBatchingEngine, Request, ServingEngine)
    if "ssm_wave" in paths:
        trace_ssm(torch, np, get_arch, build_model, Request, ServingEngine)
    return 0


def trace_wave(torch, eng, reqs, header: dict) -> None:
    """One traced wave serve, its steps marked ``prefill`` and
    ``wave_decode``; prints its JSON line."""
    eng._prefill = marked(torch, eng._prefill, lambda *a: "prefill")
    eng._decode = marked(torch, eng._decode, lambda *a: "wave_decode")
    out = traced(torch, lambda: eng.serve(reqs()))
    line = {**header, **summary(torch, *out)}
    if B8 in line["device_ms_by_group"]:
        line["b8"] = line["device_ms_by_group"][B8]   # launches and ms
    print(json.dumps(line), flush=True)


def trace_ssm(torch, np, get_arch, build_model, Request, ServingEngine):
    cfg = get_arch(SSM_ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    batch, n = SSM_WAVE
    rng = np.random.default_rng(5)
    wave = [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
            for _ in range(batch)]
    eng = ServingEngine(model, params, max_len=n + WAVE_NEW_TOKENS,
                        batch_size=batch, device="cuda")
    trace_wave(torch, eng, lambda: [
        Request(rid=i, prompt=p, max_new_tokens=WAVE_NEW_TOKENS, eos_id=-1)
        for i, p in enumerate(wave)],
        {"path": "ssm_wave", "arch": SSM_ARCH,
         "device": torch.cuda.get_device_name(0), "batch": batch,
         "prompt": n, "new_tokens": WAVE_NEW_TOKENS})


def trace_dense(torch, np, paths, get_arch, build_model,
                ContinuousBatchingEngine, Request, ServingEngine):
    cfg = get_arch("internlm2-1.8b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    plens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=REQUESTS)
    prompts = [rng.integers(3, cfg.vocab_size, size=(int(n),))
               .astype(np.int32) for n in plens]
    span = np.random.default_rng(2).integers(3, cfg.vocab_size,
                                             size=(SPEC_SPAN,))
    spec_prompts = [np.resize(span, int(n)).astype(np.int32) for n in plens]

    def requests(ps, new):
        return [Request(rid=i, prompt=p, max_new_tokens=new, eos_id=-1)
                for i, p in enumerate(ps)]

    def paged_kind(cache, host, decode, prefill):
        # prefill: whether the step carries a chunk (a chunk's (q_offset,
        # chunk_len), or None, in trees before it moved into the step's
        # array)
        return ("decode" if not prefill
                else "chunk+decode" if decode else "chunk")

    header = {"device": torch.cuda.get_device_name(0), **CONT,
              "requests": REQUESTS, "new_tokens": NEW_TOKENS}
    for path, ps, spec, kv_dtype in (
            ("continuous", prompts, None, None),
            ("int8_continuous", prompts, None, "int8"),
            ("speculative", spec_prompts, SPEC_DEPTH, None),
            ("speculative_int8", spec_prompts, SPEC_DEPTH, "int8")):
        if path not in paths:
            continue
        eng = ContinuousBatchingEngine(model, params, device="cuda",
                                       spec_depth=spec, kv_dtype=kv_dtype,
                                       **CONT)
        eng._step = marked(torch, eng._step, paged_kind)
        eng._verify = marked(torch, eng._verify, lambda *a: "verify")
        out = traced(torch, lambda: eng.serve(requests(ps, NEW_TOKENS)))
        print(json.dumps({"path": path, **header, "spec_depth": spec,
                          "kv_dtype": kv_dtype or "bf16",
                          **summary(torch, *out)}), flush=True)
        del eng
        torch.cuda.empty_cache()

    batch, n = WAVE
    wave = [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
            for _ in range(batch)]
    for path, kv_dtype in (("wave", None), ("int8_wave", "int8")):
        if path not in paths:
            continue
        eng = ServingEngine(model, params, max_len=WAVE_MAX_LEN,
                            batch_size=batch, kv_dtype=kv_dtype,
                            device="cuda")
        trace_wave(torch, eng, lambda: requests(wave, WAVE_NEW_TOKENS),
                   {"path": path, "device": header["device"],
                    "batch": batch, "prompt": n,
                    "new_tokens": WAVE_NEW_TOKENS,
                    "kv_dtype": kv_dtype or "bf16"})
        del eng
        torch.cuda.empty_cache()
    del model, params
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
