#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card, the software versions, and the ``nvcc`` build of
   every kernel from ``src/repro_torch/kernels/csrc``;
2. fp32 checks — each kernel against its plain version in fp32 on small
   ragged shapes (padding, kv tails, a sliding window, ragged decode; for
   the paged kernels shuffled page tables, kv_len 0, 1 and mid-page, a
   later chunk's q_offset, a ragged last chunk, GQA group 2);
3. kernels — each kernel against its plain version at the shapes the main
   paths give it (internlm2-1.8b widths, bf16; decode also through
   ``ops.decode_attention`` at each wave's kv_len, as the model calls it;
   paged decode over a batch of 8 whose kv_lens spread over 1-3600 of a
   4096-token budget, paged prefill of 512-row chunks at q_offset 0 and
   3072, on pools of 2049 pages), every output row within about one bf16
   rounding of its norm, with its time, the plain version's, the bound
   for its work on the card, and one PyTorch call computing the same
   function (timed as a yardstick only);
4. main path (waves) — full-width internlm2-1.8b (random weights from a
   seed) served by the port's ``ServingEngine`` in three waves whose
   prompts the shared-memory policy routes to the resident MAS, streamed
   MAS and flash kernels; every kernel's launch count must rise, and each
   wave's prefill logits are held to the plain attention path;
5. continuous — the same model served by ``ContinuousBatchingEngine``
   (batch 8, 4096-token budget, 16-token pages, 512-token chunks, the
   default pool of 2049 pages): 16 requests of 32 tokens with prompts of
   32-3500 tokens must all finish through the paged prefill and decode
   kernels, two first-token logits are held to the plain attention path,
   the same requests are served again under an injected pool-exhaustion
   burst with a pool auditor (a preemption, no failure, no leaked page),
   and at full width with 2 layers in fp32 the continuous engine on the
   kernels, on plain attention, under the burst, and the wave engine must
   emit the same greedy tokens. It prints TTFT and inter-token gaps,
   tokens/s, steps by kind, peak memory and launches.

The last three lines are the kernel table (B1-B6), the card's name and
power limit, and the result. TF32 is switched off for matrix products and
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
WAVE_KERNELS = ("mas_resident", "mas_streamed", "flash", "decode")
PAGED_KERNELS = ("paged_decode", "paged_prefill")

# The continuous engine's configuration and traffic.
CONT = dict(batch_size=8, max_len=4096, page_size=16, chunk_size=512)
CONT_REQUESTS = 16
CONT_NEW_TOKENS = 32
PROMPT_LENS = (32, 3500)            # drawn from default_rng(0), inclusive
BURST = frozenset({40, 41, 42, 43})  # appends that report exhaustion
FP32_LAYERS = 2
FP32_REQUESTS = 6
FP32_NEW_TOKENS = 16
FP32_PROMPT_MAX = 1500     # several 512-token chunks, three kernel routes
# Paged kernel shapes on the main path: 8 sequences over 2049 pages.
PAGED_DECODE_KV_LENS = (1, 17, 300, 1000, 1777, 2500, 3100, 3600)
PAGED_PREFILL = ((0, 512), (3072, 3584))   # (q_offset, kv_len), 512 rows

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


def drop_v_page(v_pages, page: int):
    """``v_pages`` (Hkv, P, page, E) with physical page ``page`` zeroed:
    what a paged kernel that skipped that page's P·V product would
    compute with."""
    out = v_pages.clone()
    out[:, page] = 0
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
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre

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

    # paged: 6 sequences of up to 10 pages of 16 rows on shuffled pages of
    # a 64-page pool, GQA group 2; table entries past a sequence's live
    # rows point at other sequences' pages, which masking must keep out
    kp, vp = rnd(2, 64, 16, 64), rnd(2, 64, 16, 64)
    table = (torch.randperm(63, generator=g, device=dev) + 1)[:60].view(
        6, 10).to(torch.int32).contiguous()
    lens = torch.tensor([0, 1, 9, 16, 100, 160], dtype=torch.int32,
                        device=dev)
    qd = rnd(6, 2, 2, 64)
    out = pdec.paged_decode_attention_flat(qd, kp, vp, table, lens)
    n_split, tps = dec.split_plan(12, 160)
    ref = pdec.paged_decode_attention_plain(qd, kp, vp, table, lens,
                                            n_split=n_split,
                                            tiles_per_split=tps)
    errs["paged_decode"] = max_err(out, ref)
    # prefill chunks: the first, a later one ending mid-page (ragged, 86
    # live rows of 96), and one live row
    for q0, kv_len, chunk in ((0, 64, 64), (64, 150, 96), (0, 1, 32)):
        qp = rnd(4, chunk, 64)
        out = ppre.paged_prefill_attention_flat(
            qp, kp, vp, table[5], q_offset=q0, kv_len=kv_len, blk_q=32)
        ref = ppre.paged_prefill_attention_plain(
            qp, kp, vp, table[5], q_offset=q0, kv_len=kv_len, blk_q=32)
        errs[f"paged_prefill_{q0}_{kv_len}"] = max_err(out, ref)
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
    rows += paged_kernel_rows(torch, rnd, cfg)
    emit({"phase": "kernels", "row_rtol": BF16_ROW_RTOL, "kernels": rows})
    for row in rows:
        require(row["row_rel_err"] <= BF16_ROW_RTOL,
                f"{row['name']}: row_rel_err {row['row_rel_err']} > "
                f"{BF16_ROW_RTOL}")
    return rows


def paged_library_call(torch, q, k_pages, v_pages, table, mask):
    """The yardstick of a paged kernel: the pages gathered dense through
    ``table`` (one indexing op each for K and V), then one
    ``scaled_dot_product_attention`` call. q: (B, Hq, Nq, E)."""
    from repro_torch.kernels.common import gather_pages

    F = torch.nn.functional
    rep = q.shape[1] // k_pages.shape[0]

    def call():
        k, v = gather_pages(k_pages, table), gather_pages(v_pages, table)
        if k.dim() == 3:
            k, v = k[None], v[None]
        try:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        except TypeError:   # no enable_gqa: expand the kv heads
            k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    return call


def paged_kernel_rows(torch, rnd, cfg) -> list[dict]:
    """B6 and B5 against their plain versions at the continuous engine's
    shapes: bf16 pools of 2049 pages of 16 rows, 8 sequences on shuffled
    pages (256 pages each, 4096 tokens of budget)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre

    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    page, b = CONT["page_size"], CONT["batch_size"]
    max_pages = CONT["max_len"] // page
    n_pages = b * max_pages + 1
    kp, vp = rnd(hkv, n_pages, page, e), rnd(hkv, n_pages, page, e)
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).view(b, max_pages).to(torch.int32).contiguous()
    rows = []

    # B6: one decode step of the batch
    lens = torch.tensor(PAGED_DECODE_KV_LENS, dtype=torch.int32,
                        device="cuda")
    qd = rnd(b, hq, e)
    n_split, tps = dec.split_plan(b * hkv, max_pages * page)
    kern = lambda: ops.paged_decode_attention(  # noqa: E731
        qd, kp, vp, table, lens)

    def plain(vp=vp):
        return pdec.paged_decode_attention_plain(
            qd.view(b, hkv, hq // hkv, e), kp, vp, table, lens,
            n_split=n_split, tiles_per_split=tps).view(b, hq, e)

    longest = max(range(b), key=lambda i: PAGED_DECODE_KV_LENS[i])
    fault_page = int(table[longest, (PAGED_DECODE_KV_LENS[longest] - 1)
                           // page - 1])
    check = held_to_plain(kern(), plain(), plain(drop_v_page(vp, fault_page)))
    live = float(sum(PAGED_DECODE_KV_LENS))
    flops = 4.0 * e * hq * live
    nbytes = 2.0 * (2 * hkv * live * e + 2 * b * hq * e)
    bms, by = bound(flops, nbytes)
    mask = (torch.arange(max_pages * page, device="cuda")[None, :]
            < lens[:, None].long()).view(b, 1, 1, -1)
    lib = paged_library_call(torch, qd.view(b, hq, 1, e), kp, vp, table,
                             mask)
    rows.append({
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:43",
        "launches": 0, **check,
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 20),
        "shape": {"b": b, "hq": hq, "hkv": hkv, "pages": n_pages,
                  "page": page, "max_pages": max_pages, "e": e,
                  "kv_lens": list(PAGED_DECODE_KV_LENS), "n_split": n_split,
                  "dtype": "bf16"},
    })

    # B5: 512-row chunks of the longest sequence, first and late
    chunk = CONT["chunk_size"]
    bq = ops.paged_prefill_blk_q(chunk)
    seq_table = table[longest]
    checks = []
    for q0, kv_len in PAGED_PREFILL:
        qp = rnd(hq, chunk, e)
        kern = lambda qp=qp, q0=q0, kv_len=kv_len: (  # noqa: E731
            ops.paged_prefill_attention(qp, kp, vp, seq_table, q0, kv_len))

        def plain(vp=vp, qp=qp, q0=q0, kv_len=kv_len):
            return ppre.paged_prefill_attention_plain(
                qp, kp, vp, seq_table, q_offset=q0, kv_len=kv_len, blk_q=bq)

        fault_page = int(seq_table[kv_len // page - 2])
        check = held_to_plain(kern(), plain(),
                              plain(drop_v_page(vp, fault_page)))
        # visible (query, key) pairs: row i sees min(q0 + i + 1, kv_len)
        pairs = float(sum(min(q0 + i + 1, kv_len) for i in range(chunk)))
        flops = 4.0 * e * hq * pairs
        nbytes = 2.0 * (2 * hkv * kv_len * e + 2 * hq * chunk * e)
        bms, by = bound(flops, nbytes)
        cols = torch.arange(max_pages * page, device="cuda")
        mask = ((cols[None, :] <= q0 + torch.arange(chunk, device="cuda")
                 [:, None]) & (cols[None, :] < kv_len)).view(1, 1, chunk, -1)
        lib = paged_library_call(torch, qp[None], kp, vp, seq_table, mask)
        checks.append({"q_offset": q0, "kv_len": kv_len, **check,
                       "ms": cuda_ms(torch, kern, 20),
                       "plain_ms": cuda_ms(torch, plain, 2),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": cuda_ms(torch, lib, 20)})
    late = checks[-1]
    rows.append({
        "name": "paged_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": "src/repro/kernels/paged_prefill_attention.py:52",
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "row_rel_err": max(c["row_rel_err"] for c in checks),
        "fault_row_rel_err": min(c["fault_row_rel_err"] for c in checks),
        "ms": late["ms"], "plain_ms": late["plain_ms"],
        "bound_ms": late["bound_ms"], "bound_by": late["bound_by"],
        "library_ms": late["library_ms"],
        "shape": {"hq": hq, "hkv": hkv, "chunk": chunk, "blk_q": bq,
                  "q_offset": late["q_offset"], "kv_len": late["kv_len"],
                  "page": page, "e": e, "dtype": "bf16"},
        "checks": checks,
    })
    return rows


def full_width_model(torch) -> dict:
    """Full-width internlm2-1.8b in bf16 with random weights from seed 0."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    cfg = get_arch(ARCH)
    require(cfg.attn_impl == "kernel", "the main path runs the kernels")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return {"model": model, "params": params,
            "init_s": time.perf_counter() - t0,
            "n_params": sum(p.numel() for p in
                            [params["embed"], params["final_norm"]]
                            + [t for layer in params["layers"]
                               for blk in layer.values()
                               for t in blk.values()])}


def phase_main_path(torch, full: dict) -> dict:
    """Full-width internlm2-1.8b served in three waves on the card."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request, RequestState

    model, params = full["model"], full["params"]
    cfg = model.cfg
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
    for name in WAVE_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the wave path")

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
        "phase": "main_path", "arch": ARCH, "params": full["n_params"],
        "layers": cfg.num_layers, "dtype": "bf16", "init_s": full["init_s"],
        "max_len": MAX_LEN, "new_tokens": NEW_TOKENS, "waves": waves,
        "launches": counts, "peak_mem_bytes": peak,
        "prefill_vs_plain": logits_check,
    }
    emit(report)
    return report


def percentiles(values) -> dict:
    import numpy as np

    v = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "n": int(v.size)}


def phase_continuous(torch, full: dict) -> dict:
    """Full-width internlm2-1.8b served by the continuous engine on the page
    pool, then under an exhaustion burst, then fp32 token parity."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        PoolAuditor,
        Request,
        RequestState,
        ScriptedFaults,
        ServingEngine,
    )

    model, params = full["model"], full["params"]
    cfg = model.cfg
    rng = np.random.default_rng(0)
    plens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                         size=CONT_REQUESTS)
    prompts = [rng.integers(3, cfg.vocab_size, size=(int(n),))
               .astype(np.int32) for n in plens]

    def requests(ps=prompts, new=CONT_NEW_TOKENS) -> list:
        return [Request(rid=i, prompt=p, max_new_tokens=new, eos_id=-1)
                for i, p in enumerate(ps)]

    def served(eng, reqs, out, new=CONT_NEW_TOKENS) -> None:
        for r in reqs:
            toks = out[r.rid]
            require(eng.results[r.rid].state is RequestState.FINISHED,
                    f"rid {r.rid}: {eng.results[r.rid].state}")
            require(len(toks) == new, f"rid {r.rid}: {len(toks)} tokens")
            require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                    f"rid {r.rid}: token out of range")

    eng = ContinuousBatchingEngine(model, params, device="cuda", **CONT)
    # warm-up: cuBLAS handles and the kernels' first loads
    eng.serve([Request(rid=100 + i, prompt=prompts[i][:40], max_new_tokens=2,
                       eos_id=-1) for i in range(2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    reqs = requests()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    served(eng, reqs, out)
    for name in PAGED_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the continuous path")
    num_pages = eng.num_pages
    stamps = eng.token_walltimes
    ttft = [stamps[r.rid][0] - eng.serve_t0 for r in reqs]
    gaps = [g for r in reqs for g in np.diff(stamps[r.rid])]
    tokens = sum(len(out[r.rid]) for r in reqs)
    steps = {k: eng.metrics.histogram(f"engine.step_s.{k}").summary()
             for k in ("decode", "chunk", "chunk+decode")}

    # first-token logits: the kernel path's chunked prefill vs the plain
    # attention path's monolithic prefill, two requests
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    page, chunk = CONT["page_size"], CONT["chunk_size"]
    logits_check = []
    for rid in (0, 1):
        p = prompts[rid]
        n = len(p)
        cache = model.make_cache(1, n, device="cuda", cache_layout="paged",
                                 page_size=page)
        n_pg = -(-n // page)
        table = torch.arange(1, n_pg + 1, dtype=torch.int32, device="cuda")
        for q0 in range(0, n, chunk):
            clen = min(chunk, n - q0)
            toks = torch.ones((1, chunk), dtype=torch.long, device="cuda")
            toks[0, :clen] = torch.from_numpy(p[q0:q0 + clen]).cuda()
            cpages = torch.tensor(
                [j + 1 if j < n_pg else 0
                 for j in range(q0 // page, (q0 + chunk) // page)],
                dtype=torch.int32, device="cuda")
            got, cache = model.prefill_chunk(params, cfg, toks, cache, table,
                                             cpages, q0, clen)
        del cache
        want, _ = plain_model.prefill(
            params, plain_model.cfg,
            torch.from_numpy(p[None].astype(np.int64)).cuda(), n)
        got, want = got.float(), want[:, 0].float()
        require(bool(torch.isfinite(got).all()), f"rid {rid}: logits")
        scale = float(want.abs().max())
        err = max_err(got, want)
        logits_check.append({
            "rid": rid, "prompt_len": n, "max_abs_err": err,
            "max_abs_logit": scale, "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all()),
            "engine_first_token_equal": int(got.argmax()) == int(out[rid][0]),
        })
        require(err <= LOGITS_RTOL * max(1.0, scale),
                f"rid {rid} first-token logits: {err} vs plain")

    # the same requests on a hot pool, under an exhaustion burst
    hot = ContinuousBatchingEngine(model, params, device="cuda",
                                   decode_reserve_frac=0.5, **CONT)
    auditor = PoolAuditor()
    hot.injector = ScriptedFaults(exhaust_at_appends=BURST)
    hot.auditor = auditor     # final_check raises on a leaked page
    t0 = time.perf_counter()
    fout = hot.serve(requests())
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    failed = sum(r.state is RequestState.FAILED for r in hot.results.values())
    served(hot, reqs, fout)
    require(hot.preemption_count >= 1, "the burst preempted nothing")
    require(failed == 0, f"{failed} requests failed under the burst")
    require(hot._mgr.pages_used == 0, "pages leaked")
    agree = sum(int((fout[r.rid] == out[r.rid]).sum()) for r in reqs)
    faulted = {
        "decode_reserve_frac": 0.5, "burst_appends": sorted(BURST),
        "preemptions": hot.preemption_count,
        "recompute_tokens": hot.recompute_tokens, "failed": failed,
        "pages_leaked": hot._mgr.pages_used,
        "steps_audited": auditor.steps_checked, "wall_s": fwall,
        "tokens_agreeing": agree / tokens,
    }
    del eng, hot

    # fp32 parity at full width, 2 layers: kernels, plain attention, the
    # wave engine and the burst give the same greedy tokens
    cfg32 = dataclasses.replace(cfg, num_layers=FP32_LAYERS,
                                compute_dtype=torch.float32)
    m32 = build_model(cfg32)
    p32 = m32.init(seed=0, device="cuda", dtype=torch.float32)
    # norm scales from N(0, 4) so that greedy tokens vary
    gen = torch.Generator(device="cuda").manual_seed(0)
    for blk in [p32] + [b for layer in p32["layers"] for b in layer.values()]:
        for key in ("norm", "final_norm"):
            if key in blk:
                blk[key] = 2.0 * torch.randn(blk[key].shape, generator=gen,
                                             device="cuda")
    rng32 = np.random.default_rng(1)
    ps32 = [rng32.integers(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
            for n in rng32.integers(PROMPT_LENS[0], FP32_PROMPT_MAX,
                                    size=FP32_REQUESTS)]

    def reqs32():
        return requests(ps32, FP32_NEW_TOKENS)

    runs = {}
    ops.reset_launch_counts()
    runs["continuous_kernel"] = ContinuousBatchingEngine(
        m32, p32, device="cuda", **CONT).serve(reqs32())
    fp32_counts = ops.launch_counts()
    runs["continuous_plain"] = ContinuousBatchingEngine(
        build_model(dataclasses.replace(cfg32, attn_impl="plain")), p32,
        device="cuda", **CONT).serve(reqs32())
    runs["wave_kernel"] = ServingEngine(
        m32, p32, max_len=CONT["max_len"], batch_size=1,
        device="cuda").serve(reqs32())
    burst = ContinuousBatchingEngine(m32, p32, device="cuda",
                                     decode_reserve_frac=0.5, **CONT)
    burst.injector = ScriptedFaults(exhaust_at_appends=frozenset({5, 6, 7}))
    burst.auditor = PoolAuditor()
    runs["continuous_burst"] = burst.serve(reqs32())
    require(burst.preemption_count >= 1, "the fp32 burst preempted nothing")
    ref = runs["continuous_kernel"]
    require(all(len(ref[rid]) == FP32_NEW_TOKENS for rid in ref),
            "fp32: a request did not get all its tokens")
    mismatch = {name: [rid for rid in ref
                       if not np.array_equal(run[rid], ref[rid])]
                for name, run in runs.items()}
    fp32 = {"layers": FP32_LAYERS, "requests": FP32_REQUESTS,
            "prompt_lens": [len(p) for p in ps32],
            "new_tokens": FP32_NEW_TOKENS,
            "distinct_tokens": len({t for v in ref.values() for t in v}),
            "burst_preemptions": burst.preemption_count,
            "launches": fp32_counts, "mismatched_rids": mismatch}
    for name, rids in mismatch.items():
        require(not rids, f"fp32 {name}: tokens differ for rids {rids}")
    for name in PAGED_KERNELS:
        require(fp32_counts[name] > 0, f"fp32: kernel {name} not launched")

    report = {
        "phase": "continuous", "arch": ARCH, "layers": cfg.num_layers,
        "dtype": "bf16", **CONT, "num_pages": num_pages,
        "requests": CONT_REQUESTS, "new_tokens": CONT_NEW_TOKENS,
        "prompt_lens": [int(n) for n in plens], "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "ttft_s": percentiles(ttft), "itl_s": percentiles(gaps),
        "steps": {k: {"count": v["count"], "mean_s": v["mean"],
                      "p50_s": v["p50"], "p95_s": v["p95"]}
                  for k, v in steps.items()},
        "peak_mem_bytes": peak, "launches": counts,
        "first_token_vs_plain": logits_check, "faulted": faulted,
        "fp32_parity": fp32,
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
    full = full_width_model(torch)
    main_path = phase_main_path(torch, full)
    continuous = phase_continuous(torch, full)
    for row in rows:
        path = continuous if row["name"] in PAGED_KERNELS else main_path
        row["launches"] = path["launches"][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
