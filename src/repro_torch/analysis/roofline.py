"""Roofline of a measured step on one H100.

Port of ``repro/analysis/roofline.py``, restated for the card. The
reference reads XLA dry-run artifacts of a TPU v5e pod; here a record is
a step that ran on the card, as ``chip_smoke.py`` prints it in its
``{"phase": "roofline", ...}`` lines:

    compute_s      = model_flops(causal=True) / PEAK_BF16_FLOPS   [s]
    memory_s       = least_bytes / PEAK_BYTES_PER_S               [s]
    bound_s        = max(compute_s, memory_s)
    mfu            = model_flops(causal=True) / (device_s * PEAK_BF16_FLOPS)
    roofline_share = bound_s / device_s

``least_bytes`` reads every input once and writes every output once, so
neither share can rightly read above 1. One card: no collective term
(multi-GPU serving is ROADMAP A10).

Usage:
    PYTHONPATH=src python -m repro_torch.analysis.roofline RUN.log \
        [--out roofline.md]
reads the ``roofline`` lines of a ``chip_smoke.py`` output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.analysis.flops import least_bytes, model_flops
from repro_torch.configs import ShapeCell, get_arch

# NVIDIA H100 SXM5 data sheet, dense (no sparsity) rates at the 700 W
# power limit: bf16 tensor-core FLOP/s and HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _cell(cell) -> ShapeCell:
    return cell if isinstance(cell, ShapeCell) else ShapeCell(**cell)


def cell_roofline(rec: dict) -> dict:
    """Roofline terms of one measured step. ``rec``: ``arch`` (an arch
    id), ``cell`` (the ``ShapeCell`` of the traffic actually run, or its
    dict), ``device_s`` (the step's time on the card), and
    ``peak_memory_bytes``; optional ``layers`` (the depth run, where cut)
    and ``kv_bytes`` (the KV cache's itemsize, default 2)."""
    cfg = get_arch(rec["arch"])
    if rec.get("layers") is not None:
        cfg = dataclasses.replace(cfg, num_layers=rec["layers"])
    cell = _cell(rec["cell"])
    device_s = rec["device_s"]
    mf = model_flops(cfg, cell, causal=True)
    kv_bytes = rec.get("kv_bytes", 2)
    mb = least_bytes(cfg, cell, kv_bytes=kv_bytes)
    compute_s = mf / PEAK_BF16_FLOPS
    memory_s = mb["total"] / PEAK_BYTES_PER_S
    bound_s = max(compute_s, memory_s)
    return {
        "arch": rec["arch"],
        "cell": dataclasses.asdict(cell),
        "layers": cfg.num_layers,
        "kv_bytes": kv_bytes,
        "device_s": device_s,
        "peak_memory_bytes": rec["peak_memory_bytes"],
        "model_flops": mf,
        "least_bytes": mb["total"],
        "bytes_breakdown": mb,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "dominant": "compute" if compute_s >= memory_s else "memory",
        "bound_s": bound_s,
        "mfu": mf / (device_s * PEAK_BF16_FLOPS),
        "roofline_share": bound_s / device_s,
    }


def to_markdown(rows: list[dict]) -> str:
    """A table of ``cell_roofline`` rows."""
    out = ["| arch | cell | b x s | device ms | compute ms | memory ms | "
           "dominant | mfu | roofline share | peak GB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        c = r["cell"]
        out.append(
            f"| {r['arch']} | {c['name']} ({c['kind']}) | "
            f"{c['global_batch']} x {c['seq_len']} | "
            f"{r['device_s'] * 1e3:.3f} | {r['compute_s'] * 1e3:.4f} | "
            f"{r['memory_s'] * 1e3:.4f} | {r['dominant']} | "
            f"{r['mfu']:.2%} | {r['roofline_share']:.2%} | "
            f"{r['peak_memory_bytes'] / 1e9:.2f} |")
    return "\n".join(out)


def load_records(path: str) -> list[dict]:
    """The ``{"phase": "roofline", ...}`` lines of a ``chip_smoke.py``
    output (other lines are skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if obj.get("phase") == "roofline":
                rows.append(obj)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("log", help="a chip_smoke.py output")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = [cell_roofline(r) for r in load_records(args.log)]
    md = to_markdown(rows)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
        with open(args.out.replace(".md", ".json"), "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
