"""Sim-vs-measured join: the calibration dataset (DESIGN.md §8).

The tuner's cycle charges are hand-derived constants; the serving
benchmarks measure real walltimes for the very phases the simulator
prices (one decode step over the live batch, one prompt chunk through
the paged gather). This module joins the two: per-phase measured
walltime (from a serving Chrome trace's ``step`` events, grouped by
their ``kind`` arg) against simulated cycles for a matching scenario,
emitting the measured/simulated ratio per phase — the dataset
ROADMAP's "calibrated cost model" item will fit ``sim/hw.py``
parameters to, in the observed-timing-driven modeling style of
Context-Driven Performance Modeling for NPUs (PAPERS.md).

Port of ``repro/obs/compare.py``, unchanged in what it computes. Here
the measured side is the port's engine on an H100 and the simulated
side the paper's 3.75 GHz edge NPU (``sim/hw.py``), so the ratio
measures how far the card sits from the simulated device on the same
step; it is not expected to be ~1. What a run checks is that the ratio
exists, is finite and comes from a schema-valid trace.
"""

from __future__ import annotations

import json

__all__ = [
    "compare_report",
    "measured_phase_stats",
    "write_report",
    "DEFAULT_KIND_TO_PHASE",
]

# engine step kinds -> compare phases. A "chunk+decode" step carries a
# prompt chunk AND the live decode slots — exactly what the sim's
# chunked-prefill schedule charges per chunk (interleaved decode step
# included), so both chunk kinds land in the prefill_chunk phase. A
# "verify" step is the speculative engine's multi-token dispatch
# (DESIGN.md §9), priced by the sim's speculative-decode schedule.
DEFAULT_KIND_TO_PHASE = {
    "decode": "decode",
    "chunk": "prefill_chunk",
    "chunk+decode": "prefill_chunk",
    "wave_decode": "decode",
    "verify": "verify",
}


def measured_phase_stats(trace: dict, *, event: str = "step",
                         kind_to_phase: dict | None = None) -> dict:
    """Aggregate a serving trace's per-step spans into per-phase
    walltime stats.

    ``trace`` is an exported Chrome trace dict (or one loaded from
    disk). Complete ("X") events named ``event`` are grouped by
    ``args.kind`` through ``kind_to_phase``; per phase, returns
    ``{"count", "mean_us", "p50_us", "total_us"}``.
    """
    kind_to_phase = kind_to_phase or DEFAULT_KIND_TO_PHASE
    durs: dict[str, list[float]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("name") != event:
            continue
        kind = (ev.get("args") or {}).get("kind")
        phase = kind_to_phase.get(kind)
        if phase is None:
            continue
        durs.setdefault(phase, []).append(float(ev["dur"]))
    out: dict[str, dict] = {}
    for phase, d in durs.items():
        d = sorted(d)
        out[phase] = {
            "count": len(d),
            "mean_us": sum(d) / len(d),
            "p50_us": d[len(d) // 2],
            "total_us": sum(d),
        }
    return out


def compare_report(measured: dict, sim_cycles_per_step: dict,
                   freq_ghz: float, *, meta: dict | None = None) -> dict:
    """Join measured per-phase stats against simulated per-step cycles.

    ``measured`` is ``measured_phase_stats`` output (or a trace dict,
    which is converted first); ``sim_cycles_per_step`` maps phase name
    -> simulated cycles for ONE step of that phase; ``freq_ghz`` is the
    simulated device clock that converts cycles to microseconds.

    Per phase present on both sides the report carries the simulated
    step time and ``measured_over_sim`` ratios (mean and p50); phases
    present on one side only are listed so a scenario mismatch is
    visible rather than silently dropped.
    """
    if "traceEvents" in measured:
        measured = measured_phase_stats(measured)
    phases: dict[str, dict] = {}
    for phase in sorted(set(measured) | set(sim_cycles_per_step)):
        m = measured.get(phase)
        cyc = sim_cycles_per_step.get(phase)
        row: dict = {}
        if m is not None:
            row.update(m)
        if cyc is not None:
            row["sim_cycles"] = cyc
            row["sim_us"] = cyc / (freq_ghz * 1e3)
        if m is not None and cyc is not None and row["sim_us"] > 0:
            row["measured_over_sim_mean"] = m["mean_us"] / row["sim_us"]
            row["measured_over_sim_p50"] = m["p50_us"] / row["sim_us"]
        else:
            row["measured_over_sim_mean"] = None
            row["measured_over_sim_p50"] = None
        phases[phase] = row
    matched = [p for p, r in phases.items()
               if r["measured_over_sim_mean"] is not None]
    report = {
        "freq_ghz": freq_ghz,
        "phases": phases,
        "matched_phases": matched,
        "unmatched_phases": sorted(set(phases) - set(matched)),
    }
    if meta:
        report["meta"] = meta
    return report


def write_report(report: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
