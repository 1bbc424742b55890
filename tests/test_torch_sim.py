"""The port's copy of the paper's simulator and the sim-vs-measured join
against the JAX package's (``repro/sim``, ``repro/obs/compare.py``).

The copy must give the reference's results exactly: every field of
``SimResult`` for the six methods of §5 on two of the paper's networks
and for each serving workload kind, the tiling spaces, the four search
strategies' tiling, evaluation count and history at one seed, the
Chrome rendering of a timeline, and the compare report on the same
trace. The port's continuous engine's ``step`` events must map through
``DEFAULT_KIND_TO_PHASE``; ``python -m repro_torch.obs.validate`` must
pass a good trace and fail a corrupted one.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
import repro.sim as ref_sim
import repro.sim.schedules as ref_schedules
import repro.sim.search as ref_search
import repro.sim.workload as ref_workload
import repro_torch.obs as obs
import repro_torch.sim as sim
import repro_torch.sim.schedules as schedules
import repro_torch.sim.search as search
import repro_torch.sim.workload as workload
from repro_torch.configs import get_smoke
from repro_torch.models.api import build_model
from repro_torch.obs import validate
from repro_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(1)

NETWORKS = ("bert-small", "vit-b-14")
TILING = dict(hh=1, nq=64, nkv=256)


def as_dict(result) -> dict:
    return dataclasses.asdict(result)


def both(method, ref_w, w, ref_t, t, **kw):
    """(reference, port) ``SimResult`` of one schedule."""
    ref = ref_sim.simulate(ref_sim.build_schedule(method, ref_w, ref_t,
                                                  ref_sim.EDGE_HW),
                           ref_sim.EDGE_HW, **kw)
    mine = sim.simulate(sim.build_schedule(method, w, t, sim.EDGE_HW),
                        sim.EDGE_HW, **kw)
    return ref, mine


def test_copy_keeps_the_paper_device_and_methods():
    assert sim.METHODS == ref_sim.METHODS
    assert as_dict(sim.EDGE_HW) == as_dict(ref_sim.EDGE_HW)
    assert {k: as_dict(v) for k, v in sim.PAPER_NETWORKS.items()} == \
        {k: as_dict(v) for k, v in ref_sim.PAPER_NETWORKS.items()}


@pytest.mark.parametrize("network", NETWORKS)
@pytest.mark.parametrize("method", ref_sim.METHODS)
def test_methods_simulate_as_reference(method, network):
    ref_w, w = ref_sim.PAPER_NETWORKS[network], sim.PAPER_NETWORKS[network]
    if method == "fusemax":
        ref_t, t = ref_search.fusemax_tiling(ref_w), search.fusemax_tiling(w)
    else:
        ref_t, t = ref_sim.Tiling(**TILING), sim.Tiling(**TILING)
    assert as_dict(ref_t) == as_dict(t)
    ref, mine = both(method, ref_w, w, ref_t, t)
    assert as_dict(mine) == as_dict(ref)
    assert mine.cycles > 0 and mine.utilization == ref.utilization


def _serving_workloads(pkg):
    """One workload of each serving kind, in ``pkg`` (a ``sim.workload``
    module), at the sizes of the reference's own tests."""
    return {
        "paged_decode": pkg.PagedDecodeWorkload(
            "d", heads=8, emb=64, group=4, kv_lens=(100, 700, 33, 512)),
        "chunked_prefill": pkg.ChunkedPrefillWorkload(
            "admit", heads=8, emb=64, group=4, prompt=200,
            decode_kv_lens=(64, 300, 17)),
        "speculative_decode": pkg.SpeculativeDecodeWorkload(
            "v", heads=8, emb=64, group=2, kv_lens=(96, 80, 64),
            new_tokens=4),
        "shared_prefix": pkg.SharedPrefixWorkload(
            name="px-t", heads=8, emb=64, prompt=96, prefix=64,
            pool_pages=32, n_requests=4, hit_rate=0.9, new_tokens=4,
            group=4),
        "sharded_serving": pkg.ShardedServingWorkload(
            "shard-w", heads=8, emb=64, kv_lens=(512,) * 4, group=4,
            n_steps=8),
    }


@pytest.mark.parametrize("kind", ["paged_decode", "chunked_prefill",
                                  "speculative_decode", "shared_prefix",
                                  "sharded_serving"])
def test_serving_workloads_simulate_as_reference(kind):
    ref_w = _serving_workloads(ref_workload)[kind]
    w = _serving_workloads(workload)[kind]
    assert as_dict(w) == as_dict(ref_w)
    ref_space = ref_schedules.tiling_space(ref_w, ref_sim.EDGE_HW)
    space = schedules.tiling_space(w, sim.EDGE_HW)
    assert [as_dict(t) for t in space] == [as_dict(t) for t in ref_space]
    # the first, middle and last points of the space
    for i in sorted({0, len(space) // 2, len(space) - 1}):
        ref, mine = both(kind, ref_w, w, ref_space[i], space[i])
        assert as_dict(mine) == as_dict(ref), (kind, space[i])


@pytest.mark.parametrize("strategy", ["grid", "random", "mcts", "ga"])
def test_search_strategies_as_reference(strategy):
    kw = {} if strategy == "grid" else {"iters": 60, "seed": 3}
    ref = ref_sim.search_tiling("mas", ref_sim.PAPER_NETWORKS["bert-small"],
                                ref_sim.EDGE_HW, strategy, **kw)
    mine = sim.search_tiling("mas", sim.PAPER_NETWORKS["bert-small"],
                             sim.EDGE_HW, strategy, **kw)
    assert as_dict(mine.tiling) == as_dict(ref.tiling)
    assert mine.evals == ref.evals
    assert mine.history == ref.history
    assert as_dict(mine.result) == as_dict(ref.result)


def test_timeline_renders_as_reference():
    ref_w, w = (ref_sim.PAPER_NETWORKS["bert-small"],
                sim.PAPER_NETWORKS["bert-small"])
    ref, mine = both("mas", ref_w, w, ref_sim.Tiling(**TILING),
                     sim.Tiling(**TILING), return_timeline=True)
    assert [as_dict(t) for t in mine.timeline] == \
        [as_dict(t) for t in ref.timeline]
    freq = sim.EDGE_HW.freq_ghz
    trace = obs.tasks_to_chrome(mine.timeline, freq_ghz=freq)
    assert trace == ref_obs.tasks_to_chrome(ref.timeline, freq_ghz=freq)
    assert obs.validate_chrome_trace(trace) == []


def _step_trace(tracer_cls, kind_durs):
    tr = tracer_cls(clock=iter(range(10 ** 6)).__next__)
    ts = 0.0
    for kind, dur in kind_durs:
        tr.complete("step", ts, dur, track="engine", args={"kind": kind})
        ts += dur
    return tr.export()


STEPS = [("decode", 100.0), ("decode", 140.0), ("chunk", 300.0),
         ("chunk+decode", 320.0), ("verify", 90.0), ("wave_decode", 70.0),
         ("unknown_kind", 7.0)]


def test_compare_report_as_reference():
    trace = _step_trace(obs.Tracer, STEPS)
    assert trace == _step_trace(ref_obs.Tracer, STEPS)
    assert obs.DEFAULT_KIND_TO_PHASE == ref_obs.DEFAULT_KIND_TO_PHASE
    stats = obs.measured_phase_stats(trace)
    assert stats == ref_obs.measured_phase_stats(trace)
    assert stats["decode"]["count"] == 3          # wave_decode included
    # the sim side: the serving phases priced on the edge device
    kw = dict(heads=8, emb=64, group=2, batch=4, spec=4)
    cycles = {}
    for pkg, pw in ((sim, workload), (ref_sim, ref_workload)):
        phases = pw.serving_phase_workloads("x", [48, 8, 24, 16, 5], 16, **kw)
        methods = {"decode": "paged_decode",
                   "prefill_chunk": "chunked_prefill",
                   "verify": "speculative_decode"}
        cycles[pkg] = {
            p: pkg.search_tiling(methods[p], w, pkg.EDGE_HW,
                                 "grid").result.cycles
            for p, w in phases.items()}
    assert cycles[sim] == cycles[ref_sim]
    freq = sim.EDGE_HW.freq_ghz
    report = obs.compare_report(trace, cycles[sim], freq,
                                meta={"scenario": "toy"})
    assert report == ref_obs.compare_report(trace, cycles[sim], freq,
                                            meta={"scenario": "toy"})
    assert report["matched_phases"] == ["decode", "prefill_chunk", "verify"]
    assert all(math.isfinite(report["phases"][p]["measured_over_sim_mean"])
               for p in report["matched_phases"])


def test_continuous_engine_steps_map_to_compare_phases(tmp_path):
    cfg = get_smoke("internlm2-1.8b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    tracer = obs.Tracer()
    eng = ContinuousBatchingEngine(model, params, max_len=40, batch_size=2,
                                   page_size=4, chunk_size=8, tracer=tracer,
                                   device="cpu")
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=m, eos_id=-2)
            for i, (n, m) in enumerate([(5, 4), (13, 3), (9, 2)])]
    eng.serve(reqs)
    trace = tracer.export()
    assert obs.validate_chrome_trace(trace) == []
    steps = [e for e in trace["traceEvents"]
             if e["ph"] == "X" and e["name"] == "step"]
    kinds = [e["args"]["kind"] for e in steps]
    assert kinds and set(kinds) <= set(obs.DEFAULT_KIND_TO_PHASE)
    stats = obs.measured_phase_stats(trace)
    assert stats == ref_obs.measured_phase_stats(trace)
    assert set(stats) == {"decode", "prefill_chunk"}
    assert sum(s["count"] for s in stats.values()) == len(steps)
    # written and read back through the report writer
    path = tmp_path / "report.json"
    obs.write_report(obs.compare_report(trace, {"decode": 1e5}, 3.75), path)
    assert json.loads(path.read_text())["matched_phases"] == ["decode"]


def test_validate_cli(tmp_path, capsys):
    tr = obs.Tracer(clock=iter(range(10 ** 6)).__next__)
    with tr.span("outer", track="t"):
        with tr.span("inner", track="t"):
            pass
    good = tr.export()
    bad = copy.deepcopy(good)
    bad["traceEvents"].reverse()          # no longer time-sorted
    del bad["traceEvents"][0]["ts"]
    paths = {}
    for name, trace in (("good", good), ("bad", bad)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(trace))
    assert validate.main([str(paths["good"])]) == 0
    assert "OK" in capsys.readouterr().out
    assert validate.main([str(paths["good"]), str(paths["bad"])]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert validate.main([str(tmp_path / "missing.json")]) == 1
    assert validate.main([]) == 2
