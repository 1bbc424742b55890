#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card, the software versions, and the ``nvcc`` build of
   every kernel from ``src/repro_torch/kernels/csrc``;
2. fp32 checks — each kernel against its plain version in fp32 on small
   ragged shapes (padding, kv tails, a sliding window, ragged decode);
3. kernels — each kernel against its plain version at the shapes the main
   path gives it (internlm2-1.8b widths, bf16; decode also through
   ``ops.decode_attention`` at each wave's kv_len, as the model calls
   it), every output row within about one bf16 rounding of its norm,
   with its time, the plain version's, the bound for its work on the
   card, and one PyTorch call computing the same function (timed as a
   yardstick only);
4. main path — full-width internlm2-1.8b (24 layers, random weights from
   a seed) served by the port's ``ServingEngine`` in three waves whose
   prompts the shared-memory policy routes to the resident MAS, streamed
   MAS and flash kernels; every kernel's launch count must rise, and each
   wave's prefill logits are held to the plain attention path.

The last three lines are the kernel table, the card's name and power
limit, and the result. TF32 is switched off for matrix products and
convolutions so fp32 comparisons see fp32 arithmetic. The script exits
non-zero, printing no result, when there is no CUDA device or no port
beside it, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

ARCH = "internlm2-1.8b"
BATCH = 4
NEW_TOKENS = 16
MAX_LEN = 8256
# Prompt lengths the shared-memory policy routes to each prefill kernel
# at E = 128 in bf16 (core/policy.py): <= 320 resident, <= 6528 streamed.
WAVES = (("mas_resident", 256, BATCH), ("mas_streamed", 2048, BATCH),
         ("flash", 8192, 1))
DECODE_KV_LENS = (1, 300, 2060, 8207)   # a ragged decode batch

# bf16 kernels against their plain versions: both sum in fp32 and round
# once to bf16, so a row differs by at most about one bf16 rounding
# (2^-8) of its L2 norm. The limit is relative to each row because an
# attention output shrinks as its row sees more keys (|o| ~ 1/sqrt(keys)
# for random v): an absolute limit sized for the early rows would pass a
# late row that lost a KV tile. Every check also plants that fault (one V
# tile zeroed) and fails unless the limit rejects it.
BF16_ROW_RTOL = 4e-3
FP32_ATOL = 3e-5     # fp32 sums taken in another order
# Prefill logits of the kernel path vs the plain attention path: bf16
# activations through 24 layers; the two paths round attention outputs
# at the same points, so they differ by a few bf16 ulps of the logits.
LOGITS_RTOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(got, want) -> float:
    """Largest L2 error of an output row (last axis), relative to that row
    of ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).norm(dim=-1)
    return float((err / want.norm(dim=-1).clamp_min(1e-30)).max())


def drop_v_tile(v, tile: int, blk_kv: int = 64):
    """``v`` with KV tile ``tile`` zeroed along its row axis (dim -2): what
    a kernel that skipped that tile's P·V product would compute with."""
    out = v.clone()
    out[..., tile * blk_kv:(tile + 1) * blk_kv, :] = 0
    return out


def held_to_plain(got, want, faulty) -> dict:
    """``got`` against ``want`` within BF16_ROW_RTOL, and the planted fault
    ``faulty`` outside it."""
    check = {"max_abs_err": max_err(got, want),
             "row_rel_err": row_rel_err(got, want),
             "fault_row_rel_err": row_rel_err(faulty, want)}
    require(check["fault_row_rel_err"] > BF16_ROW_RTOL,
            f"a skipped KV tile passes the limit: {check}")
    return check


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def library_call(torch, q, k, v, *, causal: bool, mask=None):
    F = torch.nn.functional
    fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)
    try:
        fn()
    except TypeError:   # no enable_gqa: expand the kv heads beforehand
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, is_causal=causal)
    return fn


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in build.SOURCES:
        lines = [ln.split(":", 1)[-1].strip()
                 for ln in build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[name] = lines[:12]
    info = {
        "phase": "device",
        "nvidia_smi": nvidia_smi(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "ptxas": ptxas,
    }
    emit(info)
    return info


def phase_fp32(torch) -> dict:
    """Every kernel against its plain version in fp32 on ragged shapes."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import mas_attention as mas

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    errs = {}
    # (B·Hq, Nq, E) x (B·Hkv, Nkv, E): group 2, kv tail at 200 of 256
    q, k, v = rnd(8, 224, 64), rnd(4, 256, 64), rnd(4, 256, 64)
    for causal in (False, True):
        for resident in (True, False):
            name = f"{'mas_resident' if resident else 'mas_streamed'}" \
                   f"{'_causal' if causal else ''}"
            out = mas.mas_attention_flat(q, k, v, blk_q=32, causal=causal,
                                         kv_resident=resident, kv_len=200)
            ref = mas.mas_attention_plain(q, k, v, blk_q=32, blk_kv=64,
                                          causal=causal, kv_len=200)
            errs[name] = max_err(out, ref)
        out = fl.flash_attention_flat(q, k, v, blk_q=16, causal=causal,
                                      kv_len=200)
        ref = fl.flash_attention_plain(q, k, v, blk_q=16, blk_kv=64,
                                       causal=causal, kv_len=200)
        errs[f"flash{'_causal' if causal else ''}"] = max_err(out, ref)
    out = fl.flash_attention_flat(q, k, v, blk_q=32, causal=True, window=70,
                                  q_offset=16, kv_len=200)
    ref = fl.flash_attention_plain(q, k, v, blk_q=32, blk_kv=64, causal=True,
                                   window=70, q_offset=16, kv_len=200)
    errs["flash_window"] = max_err(out, ref)
    qd, kd, vd = rnd(6, 4, 64), rnd(6, 333, 64), rnd(6, 333, 64)
    lens = torch.tensor([0, 1, 63, 64, 200, 333], dtype=torch.int32,
                        device=dev)
    out = dec.decode_attention_flat(qd, kd, vd, lens)
    n_split, tps = dec.split_plan(6, 333)
    ref = dec.decode_attention_plain(qd, kd, vd, lens, n_split=n_split,
                                     tiles_per_split=tps)
    errs["decode"] = max_err(out, ref)
    torch.cuda.synchronize()
    report = {"phase": "fp32", "atol": FP32_ATOL, "max_abs_err": errs}
    emit(report)
    for name, err in errs.items():
        require(err <= FP32_ATOL, f"fp32 {name}: {err} > {FP32_ATOL}")
    return report


def phase_kernels(torch) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes (bf16)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops

    cfg = get_arch(ARCH)
    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = hq // hkv
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf16)

    rows = []
    for method, n, b in WAVES:
        kind, bq = ops.resolve_method(n, n, e, 2)
        require(kind == method, f"policy routes N={n} to {kind}, not {method}")
        q, k, v = rnd(b * hq, n, e), rnd(b * hkv, n, e), rnd(b * hkv, n, e)
        if method == "flash":
            kern = lambda: fl.flash_attention_flat(  # noqa: E731
                q, k, v, blk_q=bq, causal=True)
            plain = lambda v=v: fl.flash_attention_plain(  # noqa: E731
                q, k, v, blk_q=bq, blk_kv=KV_TILE, causal=True)
            source = "src/repro_torch/kernels/csrc/flash_attention.cu"
            replaces = "src/repro/kernels/flash_attention.py:25"
        else:
            resident = method == "mas_resident"
            kern = lambda: mas.mas_attention_flat(  # noqa: E731
                q, k, v, blk_q=bq, causal=True, kv_resident=resident)
            plain = lambda v=v: mas.mas_attention_plain(  # noqa: E731
                q, k, v, blk_q=bq, blk_kv=KV_TILE, causal=True)
            source = "src/repro_torch/kernels/csrc/mas_attention.cu"
            replaces = ("src/repro/kernels/mas_attention.py:"
                        + ("55" if resident else "121"))
        # the fault: the second-last KV tile skipped, seen by late rows only
        check = held_to_plain(kern(), plain(),
                              plain(drop_v_tile(v, n // KV_TILE - 2)))
        lib = library_call(torch, q.view(b, hq, n, e), k.view(b, hkv, n, e),
                           v.view(b, hkv, n, e), causal=True)
        pairs = n * (n + 1) // 2          # causal (query, key) pairs a head
        flops = 4.0 * e * pairs * b * hq
        nbytes = 2.0 * (2 * b * hq * n * e + 2 * b * hkv * n * e)
        bms, by = bound(flops, nbytes)
        rows.append({
            "name": method, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, **check,
            "ms": cuda_ms(torch, kern, 20),
            "plain_ms": cuda_ms(torch, plain, 2),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(torch, lib, 20),
            "shape": {"b": b, "hq": hq, "hkv": hkv, "n": n, "e": e,
                      "blk_q": bq, "causal": True, "dtype": "bf16"},
        })

    # decode through ops.decode_attention, as the model calls it: an int
    # kv_len sizes the split to the live rows, at each wave's first and
    # last decode step against the engine's dense cache
    decode_checks = []
    for _, n, b in WAVES:
        qd = rnd(b, hq, e)
        kc, vc = rnd(b, hkv, MAX_LEN, e), rnd(b, hkv, MAX_LEN, e)
        for kv_len in (n + 1, n + NEW_TOKENS - 1):
            n_split, tps = dec.split_plan(b * hkv, kv_len)
            lens = torch.full((b * hkv,), kv_len, dtype=torch.int32,
                              device="cuda")

            def plain(vc=vc):
                return dec.decode_attention_plain(
                    qd.view(b * hkv, grp, e), kc.view(b * hkv, MAX_LEN, e),
                    vc.view(b * hkv, MAX_LEN, e), lens, n_split=n_split,
                    tiles_per_split=tps).view(b, hq, e)

            check = held_to_plain(
                ops.decode_attention(qd, kc, vc, kv_len), plain(),
                plain(drop_v_tile(vc, (kv_len - 1) // KV_TILE - 1)))
            decode_checks.append({"b": b, "kv_len": kv_len,
                                  "n_split": n_split, "tiles_per_split": tps,
                                  **check})

    # decode: a ragged batch against the whole dense cache
    b = len(DECODE_KV_LENS)
    q, k, v = rnd(b * hkv, grp, e), rnd(b * hkv, MAX_LEN, e), \
        rnd(b * hkv, MAX_LEN, e)
    kv = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device="cuda")
    lens = kv.repeat_interleave(hkv)
    n_split, tps = dec.split_plan(b * hkv, MAX_LEN)
    kern = lambda: dec.decode_attention_flat(q, k, v, lens)  # noqa: E731
    plain = lambda v=v: dec.decode_attention_plain(  # noqa: E731
        q, k, v, lens, n_split=n_split, tiles_per_split=tps)
    check = held_to_plain(kern(), plain(), plain(drop_v_tile(
        v, max(DECODE_KV_LENS) // KV_TILE - 1)))
    decode_checks.append({"b": b, "kv_lens": list(DECODE_KV_LENS),
                          "n_split": n_split, "tiles_per_split": tps,
                          **check})
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < kv[:, None]).view(b, 1, 1, MAX_LEN)
    lib = library_call(torch, q.view(b, hq, 1, e),
                       k.view(b, hkv, MAX_LEN, e), v.view(b, hkv, MAX_LEN, e),
                       causal=False, mask=mask)
    live = float(sum(DECODE_KV_LENS))
    flops = 4.0 * e * hq * live
    nbytes = 2.0 * (2 * b * hq * e + 2 * hkv * live * e)
    bms, by = bound(flops, nbytes)
    rows.append({
        "name": "decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:32",
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in decode_checks),
        "row_rel_err": max(c["row_rel_err"] for c in decode_checks),
        "fault_row_rel_err": min(c["fault_row_rel_err"]
                                 for c in decode_checks),
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 50),
        "shape": {"b": b, "hq": hq, "hkv": hkv, "s": MAX_LEN, "e": e,
                  "kv_lens": list(DECODE_KV_LENS), "n_split": n_split,
                  "dtype": "bf16"},
        "checks": decode_checks,
    })
    emit({"phase": "kernels", "row_rtol": BF16_ROW_RTOL, "kernels": rows})
    for row in rows:
        require(row["row_rel_err"] <= BF16_ROW_RTOL,
                f"{row['name']}: row_rel_err {row['row_rel_err']} > "
                f"{BF16_ROW_RTOL}")
    return rows


def phase_main_path(torch) -> dict:
    """Full-width internlm2-1.8b served in three waves on the card."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request, RequestState

    cfg = get_arch(ARCH)
    require(cfg.attn_impl == "kernel", "the main path runs the kernels")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in
                   [params["embed"], params["final_norm"]]
                   + [t for layer in params["layers"]
                      for blk in layer.values() for t in blk.values()])
    engines = {b: ServingEngine(model, params, max_len=MAX_LEN, batch_size=b,
                                device="cuda") for b in {BATCH, 1}}
    rng = np.random.default_rng(0)

    def requests(n: int, b: int, rid0: int) -> list:
        return [Request(rid=rid0 + i,
                        prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                        .astype(np.int32),
                        max_new_tokens=NEW_TOKENS, eos_id=-1)
                for i in range(b)]

    # warm-up: cuBLAS handles and the kernels' first loads, then reset
    engines[BATCH].serve(requests(32, BATCH, 1000))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    waves = []
    for i, (method, n, b) in enumerate(WAVES):
        reqs = requests(n, b, 100 * i)
        eng = engines[b]
        before = ops.launch_counts()
        t_wave = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_wave
        after = ops.launch_counts()
        stamps = eng.token_walltimes
        ttft = [stamps[r.rid][0] - eng.serve_t0 for r in reqs]
        tokens = sum(len(out[r.rid]) for r in reqs)
        for r in reqs:
            toks = out[r.rid]
            require(len(toks) == NEW_TOKENS,
                    f"rid {r.rid}: {len(toks)} tokens")
            require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                    f"rid {r.rid}: token out of range")
            require(eng.results[r.rid].state is RequestState.FINISHED,
                    f"rid {r.rid}: {eng.results[r.rid].state}")
        waves.append({
            "route": method, "prompt_len": n, "batch": b, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": max(ttft),
            "launches": {k: after[k] - before[k] for k in after},
        })
        require(after[method] > before[method],
                f"wave {n}: the {method} kernel was not launched")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, count in counts.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # prefill logits: kernel path vs plain attention, one request a wave
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    logits_check = []
    for method, n, _ in WAVES:
        prompt = torch.from_numpy(
            rng.integers(3, cfg.vocab_size, size=(1, n))).to("cuda")
        got, _ = model.prefill(params, cfg, prompt, n)
        want, _ = plain_model.prefill(params, plain_model.cfg, prompt, n)
        got, want = got.float(), want.float()
        require(bool(torch.isfinite(got).all()),
                f"{method}: logits not finite")
        scale = float(want.abs().max())
        err = max_err(got, want)
        logits_check.append({
            "route": method, "prompt_len": n, "max_abs_err": err,
            "max_abs_logit": scale, "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all()),
        })
        require(err <= LOGITS_RTOL * max(1.0, scale),
                f"{method} prefill logits: {err} vs plain")
    report = {
        "phase": "main_path", "arch": ARCH, "params": n_params,
        "layers": cfg.num_layers, "dtype": "bf16", "init_s": init_s,
        "max_len": MAX_LEN, "new_tokens": NEW_TOKENS, "waves": waves,
        "launches": counts, "peak_mem_bytes": peak,
        "prefill_vs_plain": logits_check,
    }
    emit(report)
    return report


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"error: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch, build)
    phase_fp32(torch)
    rows = phase_kernels(torch)
    main_path = phase_main_path(torch)
    for row in rows:
        row["launches"] = main_path["launches"][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
