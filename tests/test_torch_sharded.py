"""The port's KV-head-sharded continuous serving against the JAX
package's single-chip engine and the port's single-card engine.

Ranks are spawned processes in one gloo group on the CPU
(``test_torch_sharded_ranks.Ranks``): two ranks serve internlm2-smoke
(4 query / 2 KV heads) on fp32 and int8 pools, qwen3-smoke, a speculative
serve (``spec_depth=3``) and an injected exhaustion burst with the pool
auditor; four ranks serve deepseek-moe-smoke (4 KV heads) on fp32 and
int8 pools, and an internlm2 engine of degree 2, for which ranks 2 and 3
take no part. Every rank's tokens must equal the reference's
(``attn_impl="xla_full"``) and the port's single-card engine's, with no
step whose result differed from rank 0's, and its all-gathers must have
moved the bytes the gathered shapes give. Also: the per-rank trace
tracks and the degree gauge, the split plan B6 and B7 take under
sharding, ``shard="auto"`` and the refusals, ``cache_specs`` against the
reference's, a rank's slice of a cache, ``tune_shard_degree`` against
the reference's closed form, and the router.

The head-block ring (``chunk_route="ring"``) runs in the same two
spawns: internlm2 on fp32 and int8 pools at degree 2 and
deepseek-moe-smoke on both at degree 4 serve the reference's and the
single card's tokens, with the ring's passes and slab bytes those the
shapes give; and ``ring_paged_prefill`` itself, on the reference test's
shape and on a chunk the degree divides, fp32 and int8, matches the
reference's single-chip ``paged_prefill_attention`` within 1e-6 and the
port's one-card call bit for bit (``tests/test_torch_paged_ring.py``
holds the ring's tests that need no group).

Training across ranks under the fsdp policy runs in the same spawns too:
at degrees 2 and 4 the ranks train internlm2-smoke (int8 compression)
as the one-process step on their batches concatenated, with the bytes
by kind the shapes give, and their async sharded save restores whole;
and two ranks resume ``launch/train.main`` from a one-rank checkpoint
(``tests/test_torch_fsdp.py`` holds the rest, on threads). Under the
tp_sp policy the 2-rank spawn trains deepseek-moe-smoke on the whole
batch as the one-process step under the same MoE groups, with the bytes
``tp_sp_bytes`` gives, its sharded save restoring whole bit for bit;
and runs ``launch/train.main`` on moonshot-smoke over the two ranks to
step 10, then resumed from that sharded checkpoint to step 20, and on
recurrentgemma-smoke at an odd batch
(``tests/test_torch_tp_sp_train.py`` holds the rest, on threads).

The 4-rank spawn also runs the GPipe pipeline (``distributed/pipeline.
pipelined_apply``) over ``SeqShard``'s own ring and broadcast: bit for
bit ``sequential_apply`` on each microbatch, with the bytes by kind the
shapes give (``tests/test_torch_pipeline.py`` holds the rest, on
threads).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke as jax_get_smoke
from repro.core import autotune as jax_autotune
from repro.models.api import build_model as jax_build_model
from repro.distributed.sharding import cache_specs as jax_cache_specs
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import NO_FAULTS as JaxNoFaults
from repro.serving import LeastLoadedRouter as JaxRouter
from repro.serving import ScriptedFaults as JaxScriptedFaults
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.configs import get_smoke as torch_get_smoke
from repro_torch.data import SyntheticLMData
from repro_torch.launch import steps, train
from repro_torch.core import autotune
from repro_torch.distributed.ctx import KVShard, kv_shard, kv_shard_state
from repro_torch.distributed.paged import head_sharded, replicated
from repro_torch.distributed.sharding import cache_specs, local_cache
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.serving import (
    ContinuousBatchingEngine,
    LeastLoadedRouter,
    PoolAuditor,
    ScriptedFaults,
    ShardedContinuousBatchingEngine,
)
from repro_torch.tree import leaves_with_paths
from test_torch_harness import model_pair
from test_torch_paged_ring import RING_SHAPES, RING_TOL, ring_inputs, ring_want
from test_torch_sharded_ranks import Ranks, port_model, requests

# the reference test's shapes (tests/test_distributed_serving.py)
ENGINE_KW = dict(max_len=96, batch_size=3, page_size=8, chunk_size=16)
LENS = (5, 19, 33, 12, 26, 7)
MAX_NEW = 8
BURST = (2, 5, 6)
SPEC_DEPTH = 3
ARCHS = ("internlm2-1.8b", "qwen3-1.7b", "deepseek-moe-16b")


def _prompts(vocab: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=n).astype(np.int32) for n in LENS]


def _spec_prompts(vocab: int) -> list:
    """Prompts that repeat a short random span, where the prompt-lookup
    drafter finds matches."""
    rng = np.random.default_rng(7)
    return [np.resize(rng.integers(3, vocab, size=(4,)), n).astype(np.int32)
            for n in LENS]


@pytest.fixture(scope="module")
def pairs():
    return {arch: model_pair(arch, seed=0, jax_impl="xla_full", norm_std=2.0)
            for arch in ARCHS}


@pytest.fixture(scope="module")
def weights(pairs):
    return {arch: jax.tree.map(np.asarray, p.jparams)
            for arch, p in pairs.items()}


def _case(name, arch, shard, prompts, **kw):
    engine_kw = dict(ENGINE_KW, **kw.pop("engine_kw", {}))
    return dict(name=name, arch=arch, shard=shard, prompts=prompts,
                max_new=MAX_NEW, engine_kw=engine_kw, **kw)


def _ring_fn_names(degree: int) -> list:
    return [f"ring_fn-{degree}-{shape}-{dt}" for shape in RING_SHAPES
            for dt in ("fp32", "int8")]


def _ring_fn_cases(degree: int) -> list:
    return [dict(name=name, kind="ring_fn", shard=degree,
                 inputs=ring_inputs(name.split("-")[2],
                                    name.endswith("int8")))
            for name in _ring_fn_names(degree)]


FSDP_STEPS = 3
FSDP_OPT = dict(lr=5e-3, warmup_steps=1, total_steps=FSDP_STEPS)
# train.main resumed over two ranks from a one-rank checkpoint at step 10
RESUME_ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--total-steps", "20",
               "--batch", "4", "--seq", "32", "--save-every", "10",
               "--device", "cpu"]


def _fsdp_cases(degree: int, root) -> list:
    return [dict(name=f"fsdp-{degree}", kind="fsdp", degree=degree,
                 arch="internlm2-1.8b", steps=FSDP_STEPS, opt=FSDP_OPT,
                 batch=4, seq=16, ckpt=str(root / f"fsdp-{degree}"))]


def _resume_case(root) -> dict:
    return dict(name="resume", kind="resume", argv=RESUME_ARGS + [
        "--steps", "20", "--ckpt-dir", str(root / "resume")])


# tp_sp over the 2-rank spawn: deepseek-moe-smoke's train steps saved
# sharded, and train.main on moonshot-smoke to step 10 (saved sharded)
# then resumed to 20
TP_SP_RESUME_ARGS = ["--arch", "moonshot-v1-16b-a3b", "--smoke", "--total-steps", "20",
                     "--batch", "2", "--seq", "32", "--save-every", "10",
                     "--device", "cpu"]


# and train.main on recurrentgemma-smoke at an odd batch, which takes tp_sp
# (the conv halos, scan carries and window halo through their backwards)
TP_SP_HYBRID_ARGS = ["--arch", "recurrentgemma-9b", "--smoke", "--steps", "4",
                     "--batch", "3", "--seq", "32", "--device", "cpu"]


def _tp_sp_cases(root) -> list:
    return [dict(name="tp_sp-2", kind="fsdp", policy="tp_sp", degree=2,
                 arch="deepseek-moe-16b", steps=FSDP_STEPS, opt=FSDP_OPT, batch=2,
                 seq=16, ckpt=str(root / "tp_sp-2"))] + [
        dict(name=f"tp_sp_resume-{n}", kind="resume",
             argv=TP_SP_RESUME_ARGS + ["--steps", str(n), "--ckpt-dir",
                                       str(root / "tp_sp_resume")])
        for n in (10, 20)] + [
        dict(name="tp_sp_hybrid", kind="resume", argv=TP_SP_HYBRID_ARGS)]


def _cases2(vocab, root):
    p, sp = _prompts(vocab), _spec_prompts(vocab)
    return [
        _case("fp32", "internlm2-1.8b", 2, p, trace=True),
        _case("int8", "internlm2-1.8b", 2, p, engine_kw={"kv_dtype": "int8"}),
        _case("qwen3", "qwen3-1.7b", 2, p),
        _case("spec", "internlm2-1.8b", 2, sp,
              engine_kw={"spec_depth": SPEC_DEPTH}, spy=True),
        _case("burst", "internlm2-1.8b", 2, p, burst=BURST, audit=True),
        _case("burst_int8", "internlm2-1.8b", 2, p, burst=BURST, audit=True,
              engine_kw={"kv_dtype": "int8"}),
        # expiring mid-serve on rank 0's clock: the ranks kill alike
        _case("deadlines", "internlm2-1.8b", 2, p,
              deadlines={1: 0.0, 3: 0.05, 5: 0.15}),
        _case("ring_fp32", "internlm2-1.8b", 2, p, chunk_route="ring",
              like="fp32"),
        _case("ring_int8", "internlm2-1.8b", 2, p, chunk_route="ring",
              like="int8", engine_kw={"kv_dtype": "int8"}),
    ] + _ring_fn_cases(2) + _fsdp_cases(2, root) + [_resume_case(root)] \
        + _tp_sp_cases(root)


def _cases4(vocab, root):
    p = _prompts(vocab)
    return [
        _case("moe_fp32", "deepseek-moe-16b", 4, p),
        _case("moe_int8", "deepseek-moe-16b", 4, p,
              engine_kw={"kv_dtype": "int8"}),
        _case("degree2_of_4", "internlm2-1.8b", 2, p),
        _case("ring_moe_fp32", "deepseek-moe-16b", 4, p, chunk_route="ring",
              like="moe_fp32"),
        _case("ring_moe_int8", "deepseek-moe-16b", 4, p, chunk_route="ring",
              like="moe_int8", engine_kw={"kv_dtype": "int8"}),
    ] + _ring_fn_cases(4) + _fsdp_cases(4, root) + [_pipeline_case()]


def _pipeline_case() -> dict:
    """8 layers of ``tanh(h @ w)`` at D 16 over the 4 ranks as stages, a
    batch of 8 in 4 microbatches (the reference test's case)."""
    rng = np.random.default_rng(0)
    return dict(name="pipeline-4", kind="pipeline", microbatches=4,
                layers=(rng.standard_normal((8, 16, 16)) * 0.2).astype(
                    np.float32),
                x=rng.standard_normal((8, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The checkpoints' directory of the fsdp and resume cases."""
    return tmp_path_factory.mktemp("fsdp")


@pytest.fixture(scope="module")
def cases(pairs, root):
    vocab = pairs["internlm2-1.8b"].tcfg.vocab_size
    return {c["name"]: c for c in _cases2(vocab, root) + _cases4(vocab, root)}


@pytest.fixture(scope="module")
def ranks(pairs, weights, cases, expected, root):
    """Both spawns' results (world 2, world 4), every serving case's
    expected tokens computed here while the ranks run. The resume case's
    one-rank run to its step-10 checkpoint runs here first."""
    vocab = pairs["internlm2-1.8b"].tcfg.vocab_size
    train.main(RESUME_ARGS + ["--steps", "10", "--ckpt-dir",
                              str(root / "resume")])
    spawns = {2: Ranks(2, _cases2(vocab, root), weights),
              4: Ranks(4, _cases4(vocab, root), weights)}
    try:
        for name, case in cases.items():
            if case.get("kind") is None:
                expected(case, reference=name != "burst_int8")
        yield {world: r.results() for world, r in spawns.items()}
    finally:
        for r in spawns.values():
            r.close()


@pytest.fixture(scope="module")
def two_ranks(ranks):
    return ranks[2]


@pytest.fixture(scope="module")
def four_ranks(ranks):
    return ranks[4]


@pytest.fixture(scope="module")
def expected(pairs):
    """case -> (the reference's tokens, the port's single-card engine
    after serving it), each computed once. One reference engine an (arch,
    kv_dtype) serves every case of it, so its steps compile once; it
    serves a speculative case plainly, as speculation emits the plain
    greedy stream."""
    jax_engines, out = {}, {}

    def get(case, reference: bool = True):
        name = case.get("like", case["name"])   # a ring case: its twin's
        if name in out:
            return out[name]
        pair = pairs[case["arch"]]
        kw = dict(case["engine_kw"])
        want = None
        if reference:
            kw.pop("spec_depth", None)
            key = (case["arch"], kw.get("kv_dtype"))
            if key not in jax_engines:
                jax_engines[key] = JaxEngine(pair.jmodel, pair.jparams, **kw)
            jeng = jax_engines[key]
            jeng.injector = (JaxScriptedFaults(
                exhaust_at_appends=frozenset(case["burst"]))
                if case.get("burst") else JaxNoFaults)
            jout = jeng.serve([JaxRequest(rid=i, prompt=p,
                                          max_new_tokens=MAX_NEW, eos_id=-2)
                               for i, p in enumerate(case["prompts"])])
            want = {rid: np.asarray(t) for rid, t in jout.items()}
        single = ContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                          device="cpu", **case["engine_kw"])
        if case.get("burst"):
            single.injector = ScriptedFaults(
                exhaust_at_appends=frozenset(case["burst"]))
            single.auditor = PoolAuditor()
        single.out = single.serve(requests(case["prompts"], MAX_NEW))
        out[name] = want, single
        return out[name]

    return get


def _gather_bytes(pair, case, step_log) -> int:
    """Bytes a rank's all-gathers receive over a serve, from the shapes:
    a layer gathers the other ranks' (rows, Hq/n, E) outputs, rows the
    chunk's (padded) rows plus B decode rows or B·k verify rows."""
    cfg, kw, n = pair.tcfg, case["engine_kw"], case["shard"]
    b, spec = kw["batch_size"], kw.get("spec_depth")
    rows = 0
    for step in step_log:
        if step["prefill_in_flight"]:
            rows += kw["chunk_size"] + (b if step["live_decode"] else 0)
        else:
            rows += b * spec if spec else b
    per_row = cfg.num_heads // n * cfg.hd * 4 * (n - 1)
    return rows * per_row * cfg.num_layers


def _ring_counts(pair, case, step_log) -> tuple[int, int]:
    """(passes, slab bytes received) of a rank's head-block ring over a
    serve, from the shapes: n - 1 passes a layer a chunk step, each of
    the rank's K and V slabs of max_pages pages of Hkv/n heads (int8:
    with their fp32 scales)."""
    cfg, kw, n = pair.tcfg, case["engine_kw"], case["shard"]
    chunks = sum(1 for step in step_log if step["prefill_in_flight"])
    hops = chunks * cfg.num_layers * (n - 1)
    pages = kw["max_len"] // kw["page_size"]
    heads = cfg.num_kv_heads // n
    if kw.get("kv_dtype") == "int8":
        slab = 2 * heads * pages * (kw["page_size"] * cfg.hd + 4)
    else:
        slab = 2 * heads * pages * kw["page_size"] * cfg.hd * 4
    return hops, hops * slab


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"{what}: rid {rid}")


def _check_parity(pairs, expected, case, ranks, reference: bool = True):
    pair = pairs[case["arch"]]
    want, single = expected(case, reference)
    served = [r[case["name"]] for r in ranks if r[case["name"]]["member"]]
    assert len(served) == case["shard"]
    for rank, res in enumerate(served):
        what = f"{case['name']} rank {rank}"
        _same(res["tokens"], single.out, f"{what} vs single card")
        if want is not None:
            _same(res["tokens"], want, f"{what} vs reference")
        assert res["step_log"] == single.step_log, what
        st = res["shard_stats"]
        assert st["degree"] == case["shard"]
        assert st["result_mismatch"] == 0, what
        if case.get("chunk_route") == "ring":
            hops, ring_bytes = _ring_counts(pair, case, res["step_log"])
            assert (st["ring_hops"], st["ring_bytes"]) == (hops, ring_bytes)
            assert hops > 0, what
        else:
            assert st["ring_hops"] == st["ring_bytes"] == 0
        assert st["allgather_bytes"] == _gather_bytes(
            pair, case, res["step_log"]) > 0, what
    assert len({t for v in single.out.values() for t in v.tolist()}) > 5
    return single, served


@pytest.mark.parametrize("name", ["fp32", "int8", "qwen3", "spec", "burst"])
def test_two_ranks_serve_the_reference_and_single_card_tokens(
        pairs, expected, cases, two_ranks, name):
    _check_parity(pairs, expected, cases[name], two_ranks)


def test_two_ranks_burst_on_int8_pools_serve_the_single_card_tokens(
        pairs, expected, cases, two_ranks):
    """An int8 re-prefill requantizes whole pages and the port preempts a
    step earlier than the reference (ROADMAP C4), so only the port's
    single-card engine under the same burst is the yardstick."""
    single, served = _check_parity(pairs, expected, cases["burst_int8"],
                                   two_ranks, reference=False)
    assert single.preemption_count >= 1
    assert {r["preemptions"] for r in served} == {single.preemption_count}


def test_burst_preempts_as_the_single_card_and_audits_clean(
        pairs, expected, cases, two_ranks):
    single, served = _check_parity(pairs, expected, cases["burst"],
                                   two_ranks)
    assert single.preemption_count >= 1
    for res in served:
        assert res["preemptions"] == single.preemption_count
        assert res["audited"] > 0 and res["pages_left"] == 0


def test_speculation_drafts_as_the_single_card(pairs, expected, cases,
                                               two_ranks):
    single, served = _check_parity(pairs, expected, cases["spec"], two_ranks)
    assert single.spec_stats["drafted"] > 0
    for res in served:
        assert res["spec_stats"] == single.spec_stats


@pytest.mark.parametrize("name", ["moe_fp32", "moe_int8"])
def test_four_ranks_serve_the_reference_and_single_card_tokens(
        pairs, expected, cases, four_ranks, name):
    _check_parity(pairs, expected, cases[name], four_ranks)


@pytest.mark.parametrize("name", ["ring_fp32", "ring_int8", "ring_moe_fp32",
                                  "ring_moe_int8"])
def test_ring_route_serves_the_reference_and_single_card_tokens(
        pairs, expected, cases, ranks, name):
    """``chunk_route="ring"``: every chunk through the head-block ring
    (B5's plain version a hop), the tokens the reference's and the
    single card's, the ring's passes and slab bytes the shapes'."""
    case = cases[name]
    _check_parity(pairs, expected, case, ranks[case["shard"]])


@pytest.mark.parametrize("name", _ring_fn_names(2) + _ring_fn_names(4))
def test_ring_paged_prefill_matches_reference_and_one_card(cases, ranks,
                                                           name):
    """Every rank's output within 1e-6 of the reference's single-chip
    twin and bit for bit the port's one-card call on the same route (hops
    fill disjoint head slots: no combine); n - 1 passes of the rank's K
    and V slabs (6 pages of Hkv/n heads, int8 with their scales) and one
    all-gather of the (Hq, chunk / n, E) rows."""
    case = cases[name]
    n = case["shard"]
    want, one = ring_want(case["inputs"])
    hq, chunk, e = case["inputs"]["q"].shape
    page = case["inputs"]["k"].shape[2]
    heads = case["inputs"]["k"].shape[0] // n
    slab = 2 * heads * 6 * page * e * case["inputs"]["k"].itemsize
    if "k_scales" in case["inputs"]:
        slab += 2 * heads * 6 * 4
    for res in (rk[name] for rk in ranks[n]):
        for impl, got in res["out"].items():
            np.testing.assert_allclose(got, want, atol=RING_TOL,
                                       rtol=0, err_msg=impl)
            np.testing.assert_array_equal(got, one[impl], err_msg=impl)
        assert res["ring_hops"] == n - 1
        assert res["ring_bytes"] == (n - 1) * slab
        assert res["gathered_bytes"] == (n - 1) * hq * -(-chunk // n) * e * 4


def test_ranks_past_the_degree_take_no_part(pairs, expected, cases,
                                            four_ranks):
    case = cases["degree2_of_4"]
    _check_parity(pairs, expected, case, four_ranks)
    for rank in (2, 3):
        res = four_ranks[rank][case["name"]]
        assert not res["member"] and res["tokens"] == {}


def test_ranks_sweep_deadlines_on_rank_0s_clock(two_ranks):
    """Deadlines expire by wall clock, which no two ranks share: each
    rank sweeps them against rank 0's, so the schedulers kill the same
    requests at the same step and every step's collectives still pair."""
    first, second = (r["deadlines"] for r in two_ranks)
    assert first["states"] == second["states"]
    assert first["states"][1] == "cancelled"
    _same(second["tokens"], first["tokens"], "deadlines")
    assert first["step_log"] == second["step_log"]
    for res in (first, second):
        assert res["shard_stats"]["result_mismatch"] == 0


def test_rank_pools_hold_their_kv_heads(cases, two_ranks, four_ranks):
    pages = 3 * 12 + 1          # batch 3 x 96 // 8 pages + scratch
    for ranks, name, heads in ((two_ranks, "fp32", 1),
                               (two_ranks, "int8", 1),
                               (four_ranks, "moe_int8", 1)):
        for res in ranks:
            shapes = res[name]["pool_shapes"]
            assert shapes["k"] == shapes["v"] == (heads, pages, 8, 16)
            if "int8" in name:
                assert shapes["k_scale"] == shapes["v_scale"] == (heads,
                                                                  pages)


def test_rank_spans_and_degree_gauge(two_ranks):
    tracks = set()
    for rank, ranks in enumerate(two_ranks):
        trace = ranks["fp32"]["trace"]
        names = {ev["tid"]: ev["args"]["name"] for ev in trace["traceEvents"]
                 if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
        spans = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"
                 and names.get(ev["tid"]) == f"shard{rank}"]
        assert spans and all(ev["args"]["shard"] == rank for ev in spans)
        tracks |= set(names.values())
        assert ranks["fp32"]["degree_gauge"][-1] == 2
    assert {"shard0", "shard1"} <= tracks


def test_sharded_b6_b7_plan_from_the_models_kv_heads(pairs, two_ranks):
    """B6 (the chunk+decode steps) and B7 (the verify steps) plan their
    split from B·Hkv of the model, 3·2, not from the rank's 3·1."""
    cfg = pairs["internlm2-1.8b"].tcfg
    want = ENGINE_KW["batch_size"] * cfg.num_kv_heads
    for res in two_ranks:
        assert res["spec"]["split_plans"] == [("B6", want), ("B7", want)]


def test_auto_is_one_and_serves_the_single_card_tokens(pairs, expected,
                                                       cases):
    pair = pairs["internlm2-1.8b"]
    eng = ShardedContinuousBatchingEngine(pair.tmodel, pair.tparams,
                                          shard="auto", device="cpu",
                                          **ENGINE_KW)
    assert eng.shard == 1 and eng.member
    out = eng.serve(requests(cases["fp32"]["prompts"], MAX_NEW))
    _same(out, expected(cases["fp32"])[1].out, "auto")
    assert eng.shard_stats == {"degree": 1, "allgather_bytes": 0,
                               "ring_hops": 0, "ring_bytes": 0,
                               "result_mismatch": 0}


def test_degrees_are_validated(pairs, two_ranks):
    pair = pairs["internlm2-1.8b"]

    def build(shard):
        return ShardedContinuousBatchingEngine(
            pair.tmodel, pair.tparams, shard=shard, device="cpu",
            **ENGINE_KW)

    for bad in (0, -1, True, "two", 1.0):
        with pytest.raises(ValueError, match="bad shard degree"):
            build(bad)
    with pytest.raises(ValueError, match="does not divide"):
        build(4)                    # 2 kv heads
    with pytest.raises(RuntimeError, match="process group"):
        build(2)                    # no group in this process
    for res in two_ranks:
        kind, msg = res["_refusals"][4]
        assert kind == "ValueError" and "> 2 ranks" in msg
        assert res["_refusals"]["auto"] == ("ok", 1)


def test_head_sharded_and_replicated_without_a_group():
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).view(2, 6, 3)
    shard = KVShard(None, 2, 3)
    np.testing.assert_array_equal(head_sharded(x, shard, dim=1),
                                  x[:, 4:6])
    with pytest.raises(ValueError):
        head_sharded(x, shard, dim=0)       # 2 rows over 3 ranks
    one = KVShard(None, 0, 1)
    assert replicated(x, one, dim=1) is x and one.gathered_bytes == 0
    with pytest.raises(ValueError):
        KVShard(None, 3, 3)
    assert kv_shard_state() is None
    with kv_shard(shard):
        assert kv_shard_state() is shard
        with kv_shard(one):
            assert kv_shard_state() is one
        assert kv_shard_state() is shard
    assert kv_shard_state() is None


# ---------------------------------------------------------------------------
# cache_specs and a rank's slice
# ---------------------------------------------------------------------------


def _jax_dims(tree) -> dict:
    """leaf name -> the dims the reference's ``cache_specs`` shards on a
    one-device 'model' mesh, in the port's unstacked layout."""
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("model",))
    layout = tree.pop("_layout")
    specs = jax_cache_specs(tree, mesh, layout=layout)
    out: dict = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for kp, spec in flat:
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        stacked = names[0] == "units"
        dims = [i - stacked for i, a in enumerate(tuple(spec)) if a]
        out.setdefault(names[-1], set()).add(dims[0] if dims else None)
    return out


def _port_dims(tree, layout) -> dict:
    out: dict = {}
    specs = cache_specs(tree, layout=layout)
    for path, dim in leaves_with_paths(specs):
        out.setdefault(path.split("/")[-1], set()).add(dim)
    return out


def _stacked(leaves: dict) -> dict:
    """The reference's stacked tree of two layers of ``leaves``, and the
    port's list of two layers."""
    return ({"units": {"b0": {k: jnp.zeros((2,) + s, jnp.float32)
                              for k, s in leaves.items()}}},
            {"layers": [{k: torch.zeros(s) for k, s in leaves.items()}
                        for _ in range(2)]})


@pytest.mark.parametrize("layout,leaves", [
    ("paged", {"k": (4, 8, 4, 16), "v": (4, 8, 4, 16), "k_scale": (4, 8),
               "v_scale": (4, 8)}),
    ("dense", {"k": (2, 4, 32, 16), "v": (2, 4, 32, 16)}),
])
def test_cache_specs_match_the_reference_on_its_trees(layout, leaves):
    jtree, ttree = _stacked(leaves)
    jtree["_layout"] = layout
    want = _jax_dims(jtree)
    assert _port_dims(ttree, layout) == want
    assert want["k"] == {0 if layout == "paged" else 2}


@pytest.mark.parametrize("arch,layout,kv_dtype", [
    ("internlm2-1.8b", "paged", "int8"),
    ("internlm2-1.8b", "dense", "int8"),
    ("mamba2-130m", "dense", None),
    ("recurrentgemma-9b", "dense", None),
])
def test_cache_specs_match_the_reference_on_real_caches(arch, layout,
                                                         kv_dtype):
    kw = dict(cache_layout=layout, kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(page_size=4, num_pages=8)
    jtree = jax_build_model(jax_get_smoke(arch)).make_cache(2, 32, **kw)
    jtree["_layout"] = layout
    ttree = torch_build_model(torch_get_smoke(arch)).make_cache(
        2, 32, device="cpu", **kw)
    assert _port_dims(ttree, layout) == _jax_dims(jtree)


def test_cache_specs_keep_a_dim_the_degree_does_not_divide_whole():
    cache = {"layers": [{"k": torch.zeros(4, 8, 4, 16),
                         "k_scale": torch.zeros(4, 8)}]}
    assert cache_specs(cache, layout="paged", degree=2) == {
        "layers": [{"k": 0, "k_scale": 0}]}
    assert cache_specs(cache, layout="paged", degree=3) == {
        "layers": [{"k": None, "k_scale": None}]}
    with pytest.raises(KeyError):
        cache_specs(cache, layout="ring")


def test_local_cache_is_the_ranks_slice(pairs):
    model = pairs["deepseek-moe-16b"].tmodel
    kw = dict(cache_layout="paged", page_size=8, num_pages=5,
              kv_dtype="int8")
    full = model.make_cache(2, 32, device="cpu", **kw)
    for blk in full["layers"]:
        for t in blk.values():
            t.copy_(torch.randn(t.shape).to(t.dtype) if t.is_floating_point()
                    else torch.randint(-9, 9, t.shape, dtype=t.dtype))
    meta = model.make_cache(2, 32, device="meta", **kw)
    for rank in range(2):
        cut = local_cache(full, rank=rank, degree=2)
        zeros = local_cache(meta, rank=rank, degree=2, device="cpu")
        for got, zero, want in zip(cut["layers"], zeros["layers"],
                                   full["layers"]):
            for key, t in want.items():
                part = t[2 * rank:2 * rank + 2]
                assert torch.equal(got[key], part)
                assert got[key].data_ptr() != part.data_ptr()
                assert zero[key].shape == part.shape
                assert zero[key].dtype == t.dtype
                assert not zero[key].any() and zero[key].device.type == "cpu"
    with pytest.raises(ValueError):
        local_cache(full, rank=2, degree=2)


# ---------------------------------------------------------------------------
# the shard-degree tuner and the router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads_kv", [2, 4, 6, 8, 16])
def test_tune_shard_degree_is_the_references_at_its_constants(
        monkeypatch, heads_kv):
    for name, value in (("TENSOR_FLOPS", jax_autotune.MXU_FLOPS),
                        ("HBM_BW", jax_autotune.HBM_BW),
                        ("CUDA_CORE_FLOPS", jax_autotune.VPU_FLOPS),
                        ("CHUNK_STEP_OVERHEAD_S",
                         jax_autotune.CHUNK_STEP_OVERHEAD_S)):
        monkeypatch.setattr(autotune, name, value)
    mine = autotune.tune_shard_degree.__wrapped__
    theirs = jax_autotune.tune_shard_degree.__wrapped__
    picks = set()
    for n_ctx in (112, 4096, 32768):
        for link in (1e-4, 75.0, 450.0):
            for kw in (dict(group=4, e=128), dict(group=2, e=16, batch=3,
                                                  itemsize=4, page=8),
                       dict(group=2, e=128, kv_itemsize=1)):
                args = dict(heads_kv=heads_kv, n_ctx=n_ctx, link_gbps=link,
                            link_setup_s=jax_autotune.LINK_SETUP_S, **kw)
                got = mine(**args)
                assert got == theirs(**args), args
                picks.add(got)
    assert 1 in picks
    if heads_kv >= 4:
        assert len(picks) > 1


def test_tune_shard_degree_at_the_cards_constants():
    """internlm2-1.8b (8 KV heads, group 2, head dim 128) at a 32k
    context, batch 4, bf16: NVLink's 450 GB/s and the assumed 5 µs a hop
    buy all 8 degrees; a dead link buys none; the smoke model none."""
    kw = dict(heads_kv=8, group=2, n_ctx=32768, e=128)
    assert autotune.LINK_GBPS == 450.0 and autotune.LINK_SETUP_S == 5e-6
    assert autotune.tune_shard_degree(**kw) == 8
    assert autotune.tune_shard_degree(**kw, link_gbps=1e-4) == 1
    assert autotune.tune_shard_degree(heads_kv=2, group=2, n_ctx=96,
                                      e=16) == 1


class _Replica:
    """An engine stand-in: serve() answers each request with its rid."""

    def serve(self, reqs):
        return {r.rid: np.asarray([r.rid]) for r in reqs}


def test_router_routes_and_balances_as_the_reference(pairs):
    cfg = pairs["internlm2-1.8b"].tcfg
    lens = [30, 5, 6, 7, 41, 2, 18]
    prompts = _prompts(cfg.vocab_size)[:1] + [
        np.full(n, 3, np.int32) for n in lens]
    mine = LeastLoadedRouter([_Replica() for _ in range(3)])
    theirs = JaxRouter([_Replica() for _ in range(3)])
    reqs = requests(prompts, 4)
    jreqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=4)
             for r in reqs]
    shares, load = mine.route(reqs)
    jshares, jload = theirs.route(jreqs)
    assert load == jload
    assert [[r.rid for r in s] for s in shares] == [
        [r.rid for r in s] for s in jshares]
    assert set(mine.serve(reqs)) == set(theirs.serve(jreqs))
    assert mine.stats == theirs.stats and mine.stats["balance"] >= 1.0
    with pytest.raises(ValueError):
        LeastLoadedRouter([])


def test_router_over_engines_serves_one_engines_tokens(pairs):
    pair = pairs["internlm2-1.8b"]
    kw = dict(max_len=64, batch_size=2, page_size=8)
    prompts = _prompts(pair.tcfg.vocab_size)[:4]
    router = LeastLoadedRouter([
        ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                 **kw) for _ in range(2)])
    out = router.serve(requests(prompts, 4))
    solo = ContinuousBatchingEngine(pair.tmodel, pair.tparams, device="cpu",
                                    **kw).serve(requests(prompts, 4))
    _same(out, solo, "router")
    assert sum(router.stats["requests"]) == 4


def test_rank_models_are_the_harness_models(pairs):
    """``port_model`` (what the ranks build) is the harness's port model:
    the same config and the same weights."""
    pair = pairs["qwen3-1.7b"]
    model, params = port_model("qwen3-1.7b",
                               jax.tree.map(np.asarray, pair.jparams))
    assert model.cfg == pair.tcfg == dataclasses.replace(
        pair.tcfg, attn_impl="kernel")
    for (pa, a), (pb, b) in zip(leaves_with_paths(params),
                                leaves_with_paths(pair.tparams)):
        assert pa == pb and torch.equal(a, b)


# ---------------------------------------------------------------------------
# training across ranks (the fsdp policy) in the same spawns
# ---------------------------------------------------------------------------


def _fsdp_one_card(pairs, case) -> tuple:
    """The case's steps on one process: the port's ``make_train_step`` on
    the ranks' batches concatenated (tp_sp: on the whole batch, its MoE
    tokens in the ranks' groups, ``ctx.grouped_as``) -> (metrics a step,
    trained params, optimizer state)."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.tree import tree_map

    from test_torch_sharded_ranks import fsdp_model

    model, whole = fsdp_model(case, {case["arch"]: jax.tree.map(
        np.asarray, pairs[case["arch"]].jparams)})
    params = tree_map(torch.clone, whole)
    state = adamw_init(params)
    state["err"] = init_error_feedback(params)
    step = steps.make_train_step(model, OptConfig(**case["opt"]), "int8")
    metrics = []
    split = case.get("policy", "fsdp") == "fsdp"
    with ctx.grouped_as(1 if split else case["degree"]):
        for i in range(case["steps"]):
            parts = [SyntheticLMData(
                vocab_size=model.cfg.vocab_size, seq_len=case["seq"],
                global_batch=case["batch"], seed=17, process_index=r,
                process_count=case["degree"] if split else 1).batch_at(i)
                for r in range(case["degree"] if split else 1)]
            batch = {k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}
            params, state, m = step(params, state,
                                    train.batch_on(batch, "cpu"))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params, state


@pytest.mark.parametrize("degree", [2, 4])
def test_fsdp_ranks_train_as_one_card(pairs, cases, ranks, degree):
    """gloo ranks under the fsdp policy: every rank the same metrics,
    within 1e-4 of the one-process step on their batches concatenated,
    their blocks put together within 1e-4 of each trained leaf's norm,
    and the last step's bytes by kind those the shapes give."""
    import importlib.util
    from pathlib import Path

    from repro_torch.tree import leaves_with_paths

    case = cases[f"fsdp-{degree}"]
    got = [r[case["name"]] for r in ranks[degree]]
    want, params, _ = _fsdp_one_card(pairs, case)
    for res in got:
        assert res["metrics"] == got[0]["metrics"]
    for s, w in enumerate(want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[0]["metrics"][s][key], w[key],
                                       rtol=1e-4, err_msg=f"{s} {key}")
    for path, w in leaves_with_paths(params):
        blocks = [res["params"][path] for res in got]
        whole = blocks[0] if blocks[0].shape == tuple(w.shape) \
            else np.concatenate(blocks)
        err = np.linalg.norm(whole.astype(np.float64)
                             - w.detach().double().numpy())
        assert err <= 1e-4 * float(w.detach().double().norm()), path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from test_torch_sharded_ranks import fsdp_model

    model, _ = fsdp_model(case, {case["arch"]: jax.tree.map(
        np.asarray, pairs[case["arch"]].jparams)})
    bytes_ = smoke.fsdp_bytes(model.cfg, degree, 1, int8=True)
    for res in got:
        assert {k: res["sent"][k] for k in bytes_} == bytes_
        assert {k: res["received"][k] for k in bytes_} == bytes_


@pytest.mark.parametrize("degree", [2, 4])
def test_fsdp_ranks_save_sharded_and_it_restores_whole(pairs, cases, ranks,
                                                       degree):
    """The ranks' async sharded save, each rank writing its blocks, holds
    after its manifest every rank's blocks: restored whole on one process
    the parameters and first moments are the ranks' blocks put together,
    bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.tree import leaves_with_paths

    case = cases[f"fsdp-{degree}"]
    got = [r[case["name"]] for r in ranks[degree]]
    assert latest_step(case["ckpt"]) == case["steps"]
    _, params, state = _fsdp_one_card(pairs, case)
    restored = CheckpointManager(case["ckpt"]).restore(
        case["steps"], {"params": params, "opt": state}, device="cpu")
    for key, tree in (("params", restored["params"]),
                      ("mu", restored["opt"]["mu"])):
        for path, t in leaves_with_paths(tree):
            blocks = [res[key][path] for res in got]
            whole = blocks[0] if blocks[0].shape == tuple(t.shape) \
                else np.concatenate(blocks)
            np.testing.assert_array_equal(t.numpy(), whole,
                                          err_msg=f"{key} {path}")
    assert int(restored["opt"]["step"]) == case["steps"]


def test_train_main_resumes_over_two_ranks_from_a_one_rank_checkpoint(
        cases, ranks, root):
    """``launch/train.main`` over two gloo ranks restores the one-rank
    step-10 checkpoint onto the two ranks' fsdp blocks and trains to step
    20 on their data: every rank the same losses, those of the
    uninterrupted run on one process (the checkpoint's state, then steps
    10-19 on the two ranks' batches concatenated) within 5e-3, as the
    one-card resume test holds them; the two-rank save at step 20 is
    whole again on one process."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.configs import get_smoke as smoke
    from repro_torch.models.transformer import init
    from repro_torch.optim import OptConfig

    got = [r["resume"]["losses"] for r in ranks[2]]
    assert len(got[0]) == 10 and got[0] == got[1]
    cfg = smoke("internlm2-1.8b")
    shapes = init(cfg, device="meta")
    target = {"params": shapes, "opt": {"mu": shapes, "nu": shapes,
                                        "step": torch.zeros(())}}
    state = CheckpointManager(str(root / "resume")).restore(10, target,
                                                            device="cpu")
    step = steps.make_train_step(
        torch_build_model(cfg),
        OptConfig(lr=3e-3, warmup_steps=2, total_steps=20))
    params, opt, want = state["params"], state["opt"], []
    for i in range(10, 20):
        parts = [SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=4, seed=17, process_index=r,
                                 process_count=2).batch_at(i)
                 for r in range(2)]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        params, opt, m = step(params, opt, train.batch_on(batch, "cpu"))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got[0], want, atol=5e-3)
    assert latest_step(str(root / "resume")) == 20
    whole = CheckpointManager(str(root / "resume")).restore(20, target,
                                                            device="cpu")
    assert whole["params"]["embed"].shape == shapes["embed"].shape
    assert (root / "resume" / "hb" / "hb_proc1.json").exists()


# ---------------------------------------------------------------------------
# training across ranks under tp_sp in the 2-rank spawn
# ---------------------------------------------------------------------------


def _blocks_whole(blocks: list, shape) -> np.ndarray:
    """The ranks' blocks of a leaf put together along the dim where they
    differ from the whole ``shape``; a whole leaf as rank 0 holds it."""
    dims = [d for d, n in enumerate(blocks[0].shape) if n != shape[d]]
    return np.concatenate(blocks, dims[0]) if dims else blocks[0]


def test_tp_sp_ranks_train_as_one_card(pairs, cases, ranks):
    """gloo ranks under tp_sp (deepseek-moe-smoke, the whole batch on each,
    int8 compression): every rank the same metrics, within 1e-4 of the
    one-process step under the same MoE groups, their blocks put together
    within 1e-4 of each trained leaf's norm, and the last step's bytes by
    kind those ``chip_smoke.tp_sp_bytes`` gives."""
    import importlib.util
    from pathlib import Path

    from repro_torch.tree import leaves_with_paths

    from test_torch_sharded_ranks import fsdp_model

    case = cases["tp_sp-2"]
    got = [r[case["name"]] for r in ranks[2]]
    want, params, _ = _fsdp_one_card(pairs, case)
    for res in got:
        assert res["metrics"] == got[0]["metrics"]
    for s, w in enumerate(want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[0]["metrics"][s][key], w[key],
                                       rtol=1e-4, err_msg=f"{s} {key}")
    for path, w in leaves_with_paths(params):
        whole = _blocks_whole([res["params"][path] for res in got], w.shape)
        err = np.linalg.norm(whole.astype(np.float64)
                             - w.detach().double().numpy())
        assert err <= 1e-4 * float(w.detach().double().norm()), path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model, _ = fsdp_model(case, {case["arch"]: jax.tree.map(
        np.asarray, pairs[case["arch"]].jparams)})
    bytes_ = smoke.tp_sp_bytes(model.cfg, 2, case["batch"], case["seq"],
                               int8=True)
    for res in got:
        assert {k: res["sent"][k] for k in bytes_} == bytes_
        assert {k: res["received"][k] for k in bytes_} == bytes_


def test_a_degree_2_tp_sp_save_restores_on_one_rank_bit_for_bit(
        pairs, cases, ranks):
    """The two ranks' async tp_sp save restores whole on one process: the
    parameters and first moments are the ranks' blocks put together along
    their split dims, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.tree import leaves_with_paths

    case = cases["tp_sp-2"]
    got = [r[case["name"]] for r in ranks[2]]
    assert latest_step(case["ckpt"]) == case["steps"]
    _, params, state = _fsdp_one_card(pairs, case)
    restored = CheckpointManager(case["ckpt"]).restore(
        case["steps"], {"params": params, "opt": state}, device="cpu")
    for key, tree in (("params", restored["params"]),
                      ("mu", restored["opt"]["mu"])):
        for path, t in leaves_with_paths(tree):
            whole = _blocks_whole([res[key][path] for res in got], t.shape)
            np.testing.assert_array_equal(t.numpy(), whole,
                                          err_msg=f"{key} {path}")
    assert int(restored["opt"]["step"]) == case["steps"]


def test_train_main_trains_an_moe_stack_over_two_ranks_and_resumes(
        cases, ranks, root):
    """``launch/train.main`` on moonshot-smoke over two gloo ranks takes
    tp_sp: to step 10, saved sharded, then resumed from that checkpoint
    to step 20. Every rank the same losses; the resumed ones within 5e-3
    of one process continuing the checkpoint (restored whole) on the same
    batches under the same MoE groups."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.configs import get_smoke as smoke
    from repro_torch.distributed import ctx
    from repro_torch.models.transformer import init
    from repro_torch.optim import OptConfig

    first = [r["tp_sp_resume-10"]["losses"] for r in ranks[2]]
    got = [r["tp_sp_resume-20"]["losses"] for r in ranks[2]]
    assert len(first[0]) == 10 and first[0] == first[1]
    assert len(got[0]) == 10 and got[0] == got[1]
    cfg = smoke("moonshot-v1-16b-a3b")
    shapes = init(cfg, device="meta")
    target = {"params": shapes, "opt": {"mu": shapes, "nu": shapes,
                                        "step": torch.zeros(())}}
    directory = str(root / "tp_sp_resume")
    state = CheckpointManager(directory).restore(10, target, device="cpu")
    step = steps.make_train_step(
        torch_build_model(cfg),
        OptConfig(lr=3e-3, warmup_steps=2, total_steps=20))
    params, opt, want = state["params"], state["opt"], []
    with ctx.grouped_as(2):
        for i in range(10, 20):
            batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2, seed=17).batch_at(i)
            params, opt, m = step(params, opt, train.batch_on(batch, "cpu"))
            want.append(float(m["loss"]))
    np.testing.assert_allclose(got[0], want, atol=5e-3)
    assert latest_step(directory) == 20


def test_train_main_trains_a_hybrid_stack_over_two_ranks(ranks):
    """``launch/train.main`` on recurrentgemma-smoke at a global batch of 3
    over two gloo ranks takes tp_sp, each rank its rows of the sequence
    (the halo and carry exchanges and their backwards over gloo): every
    rank the same losses, within 5e-3 of one process's, as the resumed
    moonshot run (the launcher's rate of 3e-3 with no warmup at 4 steps:
    the first two steps agree within 4e-5, the fourth within 2.5e-4)."""
    got = [r["tp_sp_hybrid"]["losses"] for r in ranks[2]]
    assert len(got[0]) == 4 and got[0] == got[1]
    np.testing.assert_allclose(got[0], train.main(TP_SP_HYBRID_ARGS),
                               atol=5e-3)


def test_pipeline_over_four_gloo_ranks_is_sequential_bit_for_bit(cases,
                                                                 four_ranks):
    """``pipelined_apply`` over four gloo ranks, ``SeqShard``'s own ring
    and broadcast: every rank's output is ``sequential_apply`` on each
    microbatch bit for bit, with (M + S - 1) microbatches each way a rank
    (kind ``pipe``) and the last stage's outputs broadcast (``bcast``)."""
    from repro_torch.distributed.pipeline import sequential_apply

    case = cases["pipeline-4"]
    layers = list(torch.from_numpy(case["layers"]))
    x = torch.from_numpy(case["x"])
    m, s = case["microbatches"], 4
    per = x.shape[0] // m
    want = torch.cat([sequential_apply(layers, x[i * per:(i + 1) * per],
                                       lambda w, h: torch.tanh(h @ w))
                      for i in range(m)])
    whole = x.numel() * 4
    for rank, res in enumerate(four_ranks):
        got = res["pipeline-4"]
        assert np.array_equal(got["out"], want.numpy()), rank
        pipe = (m + s - 1) * per * x.shape[1] * 4
        assert got["sent"]["pipe"] == got["received"]["pipe"] == pipe
        last = rank == s - 1
        assert got["sent"]["bcast"] == (whole * (s - 1) if last else 0)
        assert got["received"]["bcast"] == (0 if last else whole)
