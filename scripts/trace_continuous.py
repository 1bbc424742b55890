#!/usr/bin/env python3
"""Trace the serving paths of the PyTorch port on one GPU.

Serves full-width internlm2-1.8b (bf16, random weights from seed 0) on
seven paths, full-width mamba2-130m on one more, full-width
deepseek-moe-16b on two, full-width recurrentgemma-9b on one and drives
full-width whisper-large-v3 through its model API on one, each once to
warm up, once untraced and once under ``torch.profiler``, and prints one
JSON line a path:

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
* ``shared_prefix``: ``chip_smoke.py``'s shared-prefix traffic (its
  ``shared_prefix_prompts``: a publisher, two prompts resident whole in
  its pages, eleven that share its 2008-token system prompt, two cold;
  32 new tokens each) served with ``prefix_cache=True`` and again with
  the cache off, one line each (``prefix_cache``): B5 on the chunks,
  which resume at q_offset 2000 for the suffix requests, B6 on the
  decode steps, among them the full hits' first tokens over their
  copied pages; each line adds ``b5``/``b6`` (launches and device ms)
  and the serve's ``prefix_stats``;
* ``wave``: ``chip_smoke.py``'s 4 x 2048 wave through ``ServingEngine``
  (16 new tokens): B2 on the prefill, B4 on the decode steps;
* ``int8_wave``: the same wave on an int8 cache (``kv_dtype="int8"``):
  B4's int8 form;
* ``ssm_wave``: ``chip_smoke.py``'s main-path wave of mamba2-130m (bf16,
  random weights from seed 0), 4 x 2048 through ``ServingEngine`` with
  16 new tokens: B8 once a layer on the prefill (group ``B8
  ssd_intra_chunk``, both forms, also reported as ``b8``: launches and
  device ms), the one-token recurrence in PyTorch on the decode steps;
* ``moe_wave`` and ``moe_continuous``: full-width, full-depth
  deepseek-moe-16b (bf16, random weights from seed 0 with the experts'
  down projections scaled as ``chip_smoke.py`` scales them, capacity
  factor 1.25), a 4 x 2048 wave (16 new tokens) and the continuous requests
  above, the traffic of ``chip_smoke.py``'s moe phase. Each line adds
  ``moe_ffn``: the MoE FFN's
  device time split into ``routing`` (``moe_route``: the router matmul,
  softmax, top-k, the cumulative count), ``expert products`` (the
  matmuls of the routed and the shared experts) and ``dispatch and
  combine`` (the scatter into the capacity buffers, the gather back, the
  gate weighting), from profiler ranges around ``moe_ffn`` and
  ``moe_route`` as the device ran them;
* ``hybrid_wave``: full-width, full-depth recurrentgemma-9b (bf16,
  random weights from seed 0; 26 RG-LRU and 12 windowed MQA layers of
  head dim 256), ``chip_smoke.py``'s 4 x 2048 hybrid wave (16 new
  tokens): B3's head-dim-256 form on the prefill, B4's on the decode
  steps (also reported as ``b3`` and ``b4``: launches and device ms), and
  ``rglru``: the device time of the RG-LRU block's doubling scan
  (``rglru.affine_scan``) and its causal conv (``rglru.causal_conv``),
  from profiler ranges around them;
* ``encdec``: full-width, full-depth whisper-large-v3 (bf16, random
  weights from seed 0) as ``chip_smoke.py``'s encdec phase drives it:
  4 clips of 1500 random stub frames (``numpy.random.default_rng(11)``)
  through ``encode``, a 4-token prompt through ``prefill`` and 31
  greedy ``decode_step``s (32 new tokens), each step ending in a
  synchronize (step kinds ``encode``, ``prefill``, ``decode``). It adds
  ``decode_step_split``: a decode step's device time split into its 32
  B2 cross-attention calls, B4, matmuls and elementwise work (every
  other kernel, copies included), from the kernels that run inside the
  decode steps.

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
MOE_ARCH = "deepseek-moe-16b"
DENSE = ("continuous", "int8_continuous", "speculative", "speculative_int8",
         "shared_prefix", "wave", "int8_wave")
MOE = ("moe_wave", "moe_continuous")
HYBRID_ARCH, HYBRID_WAVE = "recurrentgemma-9b", (4, 2048)
ENCDEC_ARCH, ENCDEC_CLIPS, ENCDEC_PROMPT = "whisper-large-v3", 4, 4
ENCDEC_NEW_TOKENS = 32
PATHS = DENSE + ("ssm_wave",) + MOE + ("hybrid_wave", "encdec")
# profiler ranges put around functions, not kernels
MARKS = ("step:", "moe:", "rglru:")
B8 = "B8 ssd_intra_chunk"
B5, B6 = "B5 paged_prefill", "B6 paged_decode"
# kernel name fragments -> group, first match wins
GROUPS = (("paged_prefill", B5),
          ("paged_verify", "B7 paged_verify"),
          ("paged_decode", B6),
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


def ranged(torch, fn, name: str):
    """``fn`` with each call inside a profiler range ``name``."""
    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return call


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
    kernels = [e for e in events if e.device_type == cuda
               and not e.name.startswith(MARKS)]
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


def moe_split(torch, prof) -> dict:
    """Device ms and launches of the MoE FFN's kernels by part: each
    kernel inside a device-side ``moe:route`` range is routing; inside a
    ``moe:ffn`` range, a matmul is an expert product and any other kernel
    dispatch and combine."""
    import bisect

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    marks = {}
    for e in events:
        if e.device_type == cuda and e.name.startswith("moe:"):
            marks.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    if "moe:ffn" not in marks:
        return {"not measured": "no device-side moe:ffn ranges in the "
                                "trace"}
    spans = {name: sorted(v) for name, v in marks.items()}
    starts = {name: [a for a, _ in v] for name, v in spans.items()}

    def inside(name, t):
        i = bisect.bisect_right(starts.get(name, []), t) - 1
        return i >= 0 and spans[name][i][1] >= t

    parts: dict[str, list] = {}
    for e in events:
        if e.device_type != cuda or e.name.startswith(MARKS):
            continue
        t = e.time_range.start
        if inside("moe:route", t):
            part = "routing"
        elif inside("moe:ffn", t):
            part = ("expert products" if group_of(e.name) == "matmul"
                    else "dispatch and combine")
        else:
            continue
        entry = parts.setdefault(part, [0, 0.0])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    return {part: {"launches": n, "ms": ms}
            for part, (n, ms) in parts.items()}


def range_times(torch, prof, prefix: str) -> dict:
    """Device ms and launches of the kernels inside each device-side
    profiler range whose name starts with ``prefix``, by range name
    (without the prefix)."""
    import bisect

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans: dict[str, list] = {}
    for e in events:
        if e.device_type == cuda and e.name.startswith(prefix):
            spans.setdefault(e.name[len(prefix):], []).append(
                (e.time_range.start, e.time_range.end))
    if not spans:
        return {"not measured": f"no device-side {prefix} ranges in the "
                                "trace"}
    spans = {name: sorted(v) for name, v in spans.items()}
    starts = {name: [a for a, _ in v] for name, v in spans.items()}
    out = {name: [0, 0.0] for name in spans}
    for e in events:
        if e.device_type != cuda or e.name.startswith(MARKS):
            continue
        t = e.time_range.start
        for name, v in spans.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and v[i][1] >= t:
                out[name][0] += 1
                out[name][1] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: {"launches": n, "ms": ms} for name, (n, ms) in out.items()}


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
    if paths & set(MOE):
        trace_moe(torch, np, paths, get_arch, build_model,
                  ContinuousBatchingEngine, Request, ServingEngine)
    if "hybrid_wave" in paths:
        trace_hybrid(torch, np, get_arch, build_model, Request,
                     ServingEngine)
    if "encdec" in paths:
        trace_encdec(torch, np, get_arch, build_model)
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
    if header["path"] in MOE:
        line["moe_ffn"] = moe_split(torch, out[2])
    if header["path"] == "hybrid_wave":
        groups = line["device_ms_by_group"]
        line["b3"], line["b4"] = groups.get("B3 flash"), groups.get(
            "B4 decode")
        line["rglru"] = range_times(torch, out[2], "rglru:")
    print(json.dumps(line), flush=True)


def paged_kind(cache, host, decode, prefill):
    # prefill: whether the step carries a chunk (a chunk's (q_offset,
    # chunk_len), or None, in trees before it moved into the step's array)
    return "decode" if not prefill else "chunk+decode" if decode else "chunk"


def continuous_prompts(np, vocab):
    """``chip_smoke.py``'s continuous requests' prompts in ``vocab``."""
    rng = np.random.default_rng(0)
    plens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=REQUESTS)
    return [rng.integers(3, vocab, size=(int(n),)).astype(np.int32)
            for n in plens], rng


def trace_moe(torch, np, paths, get_arch, build_model,
              ContinuousBatchingEngine, Request, ServingEngine):
    from repro_torch.models import moe

    sys.path.insert(0, str(REPO))
    from chip_smoke import bounded_moe

    cfg = get_arch(MOE_ARCH)
    model = build_model(cfg)
    params = bounded_moe(model.init(seed=0, device="cuda",
                                    dtype=torch.bfloat16))
    for name in ("moe_ffn", "moe_route"):
        setattr(moe, name, ranged(torch, getattr(moe, name),
                                  f"moe:{name[4:]}"))
    header = {"arch": MOE_ARCH, "device": torch.cuda.get_device_name(0),
              "capacity_factor": cfg.moe.capacity_factor}

    def requests(ps, new):
        return [Request(rid=i, prompt=p, max_new_tokens=new, eos_id=-1)
                for i, p in enumerate(ps)]

    prompts, _ = continuous_prompts(np, cfg.vocab_size)
    if "moe_continuous" in paths:
        eng = ContinuousBatchingEngine(model, params, device="cuda", **CONT)
        eng._step = marked(torch, eng._step, paged_kind)
        out = traced(torch, lambda: eng.serve(requests(prompts,
                                                       NEW_TOKENS)))
        print(json.dumps({"path": "moe_continuous", **header, **CONT,
                          "requests": REQUESTS, "new_tokens": NEW_TOKENS,
                          **summary(torch, *out),
                          "moe_ffn": moe_split(torch, out[2])}),
              flush=True)
        del eng
        torch.cuda.empty_cache()
    if "moe_wave" in paths:
        batch, n = WAVE
        rng = np.random.default_rng(0)
        wave = [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
                for _ in range(batch)]
        eng = ServingEngine(model, params, max_len=n + WAVE_NEW_TOKENS,
                            batch_size=batch, device="cuda")
        trace_wave(torch, eng, lambda: requests(wave, WAVE_NEW_TOKENS),
                   {"path": "moe_wave", **header, "batch": batch,
                    "prompt": n, "new_tokens": WAVE_NEW_TOKENS})
        del eng
    del model, params
    torch.cuda.empty_cache()


def trace_hybrid(torch, np, get_arch, build_model, Request, ServingEngine):
    from repro_torch.models import rglru

    cfg = get_arch(HYBRID_ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    for name, mark in (("affine_scan", "scan"), ("causal_conv", "conv")):
        setattr(rglru, name, ranged(torch, getattr(rglru, name),
                                    f"rglru:{mark}"))
    batch, n = HYBRID_WAVE
    rng = np.random.default_rng(7)
    wave = [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
            for _ in range(batch)]
    eng = ServingEngine(model, params, max_len=n + WAVE_NEW_TOKENS,
                        batch_size=batch, device="cuda")
    trace_wave(torch, eng, lambda: [
        Request(rid=i, prompt=p, max_new_tokens=WAVE_NEW_TOKENS, eos_id=-1)
        for i, p in enumerate(wave)],
        {"path": "hybrid_wave", "arch": HYBRID_ARCH,
         "device": torch.cuda.get_device_name(0), "batch": batch,
         "prompt": n, "new_tokens": WAVE_NEW_TOKENS,
         "window": cfg.window})
    del eng, model, params
    torch.cuda.empty_cache()


def step_split(torch, prof, kind: str) -> dict:
    """Device ms and launches a step of kind ``kind``, by kernel group:
    the kernels that start inside the host's ``step:<kind>`` ranges (each
    step ends in a synchronize, so its kernels run inside it)."""
    import bisect

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == f"step:{kind}" and e.device_type != cuda)
    if not spans:
        return {"not measured": f"no step:{kind} ranges in the trace"}
    starts = [a for a, _ in spans]
    parts: dict[str, list] = {}
    for e in events:
        if e.device_type != cuda or e.name.startswith(MARKS):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or spans[i][1] < e.time_range.start:
            continue
        group = group_of(e.name)
        if group not in ("B2 mas_streamed", "B4 decode", "matmul"):
            group = "elementwise and other"
        entry = parts.setdefault(group, [0, 0.0])
        entry[0] += 1
        entry[1] += (e.time_range.end - e.time_range.start) / 1e3
    total = sum(ms for _, ms in parts.values())
    return {"steps": len(spans), "device_ms_per_step": total / len(spans),
            **{g: {"launches_per_step": n / len(spans),
                   "ms_per_step": ms / len(spans), "share": ms / total}
               for g, (n, ms) in parts.items()}}


def trace_encdec(torch, np, get_arch, build_model):
    cfg = get_arch(ENCDEC_ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.standard_normal(
        (ENCDEC_CLIPS, cfg.num_frontend_tokens, cfg.d_model))
        .astype(np.float32)).to("cuda", torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, size=(ENCDEC_CLIPS, ENCDEC_PROMPT))).cuda()
    n, new = ENCDEC_PROMPT, ENCDEC_NEW_TOKENS

    def step(kind, fn):
        with torch.profiler.record_function(f"step:{kind}"):
            out = fn()
            torch.cuda.synchronize()
        return out

    def serve():
        enc = step("encode", lambda: model.encode(params, frames))
        logits, cache = step("prefill", lambda: model.prefill(
            params, cfg, prompt, n + new, encoder_out=enc))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(new - 1):
            logits, cache = step("decode", lambda: model.decode_step(
                params, cfg, tok, cache, n + i))
            tok = logits[:, -1].argmax(-1, keepdim=True)

    out = traced(torch, serve)
    line = {"path": "encdec", "arch": ENCDEC_ARCH,
            "device": torch.cuda.get_device_name(0), "clips": ENCDEC_CLIPS,
            "frames": cfg.num_frontend_tokens, "prompt": n,
            "new_tokens": new, **summary(torch, *out),
            "decode_step_split": step_split(torch, out[2], "decode")}
    print(json.dumps(line), flush=True)
    del model, params
    torch.cuda.empty_cache()


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
    prompts, rng = continuous_prompts(np, cfg.vocab_size)
    span = np.random.default_rng(2).integers(3, cfg.vocab_size,
                                             size=(SPEC_SPAN,))
    spec_prompts = [np.resize(span, len(p)).astype(np.int32)
                    for p in prompts]

    def requests(ps, new):
        return [Request(rid=i, prompt=p, max_new_tokens=new, eos_id=-1)
                for i, p in enumerate(ps)]

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

    if "shared_prefix" in paths:
        sys.path.insert(0, str(REPO))
        from chip_smoke import shared_prefix_prompts

        shared = shared_prefix_prompts(cfg.vocab_size)
        for prefix_cache in (True, False):
            eng = ContinuousBatchingEngine(model, params, device="cuda",
                                           prefix_cache=prefix_cache, **CONT)
            eng._step = marked(torch, eng._step, paged_kind)
            out = traced(torch,
                         lambda: eng.serve(requests(shared, NEW_TOKENS)))
            line = {"path": "shared_prefix", **header,
                    "requests": len(shared), "kv_dtype": "bf16",
                    "prefix_cache": prefix_cache, **summary(torch, *out),
                    "prefix_stats": eng.prefix_stats,
                    "peak_pages": eng._mgr.peak_pages_used}
            groups = line["device_ms_by_group"]
            line["b5"], line["b6"] = groups.get(B5), groups.get(B6)
            print(json.dumps(line), flush=True)
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
