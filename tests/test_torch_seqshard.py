"""The port's sequence-sharding policy (the reference's ``sp_rep``/``tp_sp``
serving policy) against the JAX package.

Ranks are spawned processes in one gloo group on the CPU
(``test_torch_sharded_ranks.Ranks`` with ``test_torch_seqshard_ranks``'s
target): one 2-rank and one 4-rank spawn, each running all of its cases
while this process computes the reference's results. The cases:
``ring_attention`` against ``kernels/ref.attention`` (causal or not,
``kv_len`` and ``q_offset``) at the reference's own tolerance (2e-5,
``tests/test_distributed_serving.py``); ``sharded_decode_attention``,
fp32 and int8, against the reference's with no policy
(``tests/test_policies.py``); internlm2-smoke, qwen3-smoke and
deepseek-moe-smoke through ``prefill``, 8 greedy ``decode_step``s and
``forward``, on prompts the degree divides and does not, with caches
whose blocks differ from the row split (whisper-smoke after ``encode``,
its memory split or, at 18 frames over 4 ranks, whole; internvl2-smoke
with its patch rows in the row split, a rank holding patch rows only),
against the reference (an MoE
under its ``tp_sp`` policy on one CPU device, its ``constrain``
patched to the identity: a constraint only places values) at 1e-4 and
equal greedy tokens; the bytes each rank's collectives moved against
the shapes; each slice again on the rank's ``tp_sp`` split of the
weights (gathered layer by layer on use), bit for bit the whole-weight
run, with the ``weights`` bytes the shapes give; a cache whose
``max_len`` the degree does not divide, served replicated; and
``launch/dryrun.run_cell`` (whisper's and internvl2's cells too). In
this process: ``_token_groups``,
``param_specs`` (where the port's ``unembed`` rule departs from the
reference's, C17), ``opt_specs``, ``batch_specs`` and ``choose_policy``
against the reference's, ``local_params``' cuts under both policies,
the replicated ``seeded_cache``, the rows rule of ``distributed/ctx``,
and the policies the model refuses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_smoke as jax_get_smoke
from repro.distributed import ctx as jctx
from repro.distributed import sharding as jsharding
from repro.kernels import ref as jref
from repro.kernels.common import quantize_q8 as jax_quantize_q8
from repro.launch.steps import choose_policy as jax_choose_policy
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro.models.attention import sharded_decode_attention as jax_decode
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCell, get_arch
from repro_torch.configs import get_smoke
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import SeqShard, sharding_policy
from repro_torch.distributed.sharding import (
    batch_specs,
    fit_dim,
    local_cache,
    local_params,
    opt_specs,
    param_spec,
    param_specs,
    split_specs,
)
from repro_torch.launch.dryrun import (
    cell_frames,
    cell_tokens,
    decode_steps,
    seeded_cache,
)
from repro_torch.launch.steps import choose_policy, make_prefill_step
from repro_torch.models import moe as tmoe
from repro_torch.models.api import build_model
from repro_torch.tree import leaves_with_paths
from repro_torch.weights import reference_leaf
from test_torch_harness import model_pair
from test_torch_seqshard_ranks import seq_rank_main
from test_torch_sharded_ranks import Ranks

ARCHS = ("internlm2-1.8b", "qwen3-1.7b", "deepseek-moe-16b", "mamba2-130m",
         "recurrentgemma-9b")
MOE = "deepseek-moe-16b"
DROP_CF = 1.0           # a capacity factor at which the groups drop
TOL = 1e-4
INT8_TOL = 2e-2         # int8 caches: a row's rounding flips move logits
RING_TOL = 2e-5         # the reference's ring and decode tolerance
BATCH, STEPS = 2, 8
LENS = (24, 25)         # a prompt both degrees divide, and one neither does
MAX_LEN = 40            # blocks of 20 / 10 rows against rows of 12 / 6
# The recurrent stacks' prompts (arch -> (length, max_len)): mamba2's 160
# splits in rank blocks of 80 / 40 rows, 2.5 / 1.25 of its 32-row chunks;
# recurrentgemma's window of 32 takes a halo from two ranks at 96 rows
# over 4 (24 rows a rank) and from one at 256 over 2 (128), and its ring
# of 30 slots at max_len 30 is split over 2 ranks and whole over 4; 25
# rows neither degree divides.
RECURRENT_LENS = {"mamba2-130m": ((160, 168), (25, MAX_LEN)),
                  "recurrentgemma-9b": ((96, 104), (256, 264), (25, MAX_LEN),
                                        (22, 30))}
REPLICATED_LEN = {2: 41, 4: 42}   # a cache the degree does not divide
# The frontend archs' prompts (arch -> (text tokens, F)): whisper's 16
# frames split in blocks of 8 / 4 against 24 decoder rows (12 / 6) or 25
# (whole), and 18 frames that 2 divides and 4 does not (the memory held
# whole, ``mem_replicated``); internvl2's 8 patch rows before 24 tokens
# (32 rows: 16 / 8 a rank), 23 (31: whole; 31 + 8 steps fill the cache of
# 40), and 8 (16 rows: over 4 ranks, ranks 0 and 1 hold patch rows only).
FRONTEND_LENS = {"whisper-large-v3": ((24, 16), (25, 16), (24, 18)),
                 "internvl2-2b": ((24, 8), (23, 8), (8, 8))}
FRONTEND = tuple(FRONTEND_LENS)
RING = dict(b=2, hq=4, hkv=2, s=32, e=16)
DEC = dict(b=2, hq=8, hkv=2, s=96, e=32)
KV_LENS_RING = (None, 13, 27)
KV_LENS_DEC = (1, 40, 96)
REFUSED = FRONTEND      # archs the fsdp policy is refused for
CELLS = (ShapeCell("prefill_tiny", 24, 2, "prefill"),
         ShapeCell("decode_tiny", 40, 2, "decode"),
         ShapeCell("train_tiny", 24, 4, "train"))
# the recurrent stacks' cells: a prompt of 64 rows (two mamba2 chunks,
# blocks of 32 and 16), a decode past recurrentgemma's window of 32
RECURRENT_CELLS = (ShapeCell("prefill_tiny", 64, 2, "prefill"),
                   ShapeCell("decode_tiny", 48, 2, "decode"))


class StandInMesh:
    """The two fields the reference's policy, ``_token_groups`` and
    ``fit_spec`` read from a mesh: a 'model' axis of ``degree``."""

    def __init__(self, degree: int):
        self.axis_names = ("model",)
        self.devices = np.empty((degree,), dtype=object)


@contextlib.contextmanager
def reference_policy(degree: int, kind: str = "tp_sp"):
    """The reference under its ``kind`` policy on one device, its
    ``constrain`` the identity (this edits no file of the JAX package)."""
    real = jctx.constrain
    jctx.constrain = lambda x, spec_builder: x
    try:
        with jctx.sharding_policy(StandInMesh(degree), kind):
            yield
    finally:
        jctx.constrain = real


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def _ring_cases(degree: int) -> list:
    r = RING
    q = _rng(1, r["b"], r["hq"], r["s"], r["e"])
    k = _rng(2, r["b"], r["hkv"], r["s"], r["e"])
    v = _rng(3, r["b"], r["hkv"], r["s"], r["e"])
    return [dict(name=f"ring-{degree}-{causal}-{kv_len}-{off}", kind="ring",
                 degree=degree, q=q, k=k, v=v, causal=causal, kv_len=kv_len,
                 q_offset=off)
            for causal in (True, False) for kv_len in KV_LENS_RING
            for off in (0, 3)]


def _decode_inputs(quantized: bool) -> dict:
    d = DEC
    out = {"q": _rng(4, d["b"], d["hq"], d["e"])}
    for i, n in enumerate(("k", "v")):
        x = _rng(5 + i, d["b"], d["hkv"], d["s"], d["e"])
        if quantized:
            xq, sc = jax_quantize_q8(jnp.asarray(x), -1)
            out[n], out[n + "_scale"] = np.asarray(xq), np.asarray(sc)
        else:
            out[n] = x
    return out


def _decode_cases(degree: int) -> list:
    return [dict(name=f"decode-{degree}-{dt}-{kv_len}", kind="decode",
                 degree=degree, kv_len=kv_len, **_decode_inputs(dt == "int8"))
            for dt in ("fp32", "int8") for kv_len in KV_LENS_DEC]


def _slice_cases(degree: int) -> list:
    out = []
    for arch in ARCHS:
        cfs = (None, DROP_CF) if arch == MOE else (None,)
        lens = RECURRENT_LENS.get(arch, [(s, MAX_LEN) for s in LENS])
        for s, max_len in lens:
            for cf in cfs:
                prompt = np.random.default_rng(s).integers(
                    3, 512, size=(BATCH, s)).astype(np.int32)
                out.append(dict(name=f"slice-{degree}-{arch}-{s}-{cf}",
                                kind="slice", degree=degree, arch=arch,
                                prompt=prompt, max_len=max_len, steps=STEPS,
                                capacity_factor=cf))
    out.append(dict(out[0], name=f"slice-{degree}-int8", kv_dtype="int8"))
    out.append(dict(out[0], name=f"slice-{degree}-replicated",
                    max_len=REPLICATED_LEN[degree]))
    for arch, lens in FRONTEND_LENS.items():
        for s, f in lens:
            rng = np.random.default_rng(1000 + s + f)
            out.append(dict(
                name=f"slice-{degree}-{arch}-{s}-f{f}", kind="slice",
                degree=degree, arch=arch, max_len=MAX_LEN, steps=STEPS,
                capacity_factor=None, frontend_tokens=f,
                prompt=rng.integers(3, 512, size=(BATCH, s)).astype(np.int32),
                frames=rng.standard_normal(
                    (BATCH, f, get_smoke(arch).d_model)).astype(np.float32)))
    return out


def _cell_cases(degree: int) -> list:
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              compute_dtype=torch.float32)
    out = [dict(name=f"cell-{degree}-{c.kind}", kind="cell", degree=degree,
                cfg=cfg, cell=c, steps=3) for c in CELLS]
    for arch in RECURRENT_LENS:
        rcfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                                   compute_dtype=torch.float32)
        out += [dict(name=f"cell-{degree}-{arch}-{c.kind}", kind="cell",
                     degree=degree, cfg=rcfg, cell=c, steps=3)
                for c in RECURRENT_CELLS]
    for arch in FRONTEND:
        fcfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                                   compute_dtype=torch.float32)
        out += [dict(name=f"cell-{degree}-{arch}-{c.kind}", kind="cell",
                     degree=degree, cfg=fcfg, cell=c, steps=3)
                for c in CELLS[:2]]
    return out


def _cases(world: int) -> list:
    cases = (_ring_cases(world) + _decode_cases(world) + _slice_cases(world)
             + _cell_cases(world))
    if world == 4:      # a group of two of the four ranks
        cases.append(dict(_slice_cases(2)[0], name="slice-2of4"))
    return cases


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    return {arch: model_pair(arch, seed=0, jax_impl="xla_full", norm_std=2.0)
            for arch in ARCHS + FRONTEND}


@pytest.fixture(scope="module")
def results(pairs):
    """case name -> (every rank's result, in rank order); the reference's
    results (``reference``) are computed while the ranks run."""
    weights = {a: jax.tree.map(np.asarray, p.jparams)
               for a, p in pairs.items()}
    cases = {2: _cases(2), 4: _cases(4)}
    spawns = {w: Ranks(w, c, weights, target=seq_rank_main)
              for w, c in cases.items()}
    try:
        want = _references(pairs, cases)
        got = {}
        for world, spawn in spawns.items():
            ranks = spawn.results()
            for c in cases[world]:
                got[c["name"]] = (c, [rk[c["name"]] for rk in ranks
                                      if c["name"] in rk])
        yield got, want
    finally:
        for spawn in spawns.values():
            spawn.close()


def _jax_slice_model(pair, cf):
    cfg = pair.jcfg
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg, jax_build_model(cfg)


def _frontend_kwargs(cfg, model, params, case, asarray) -> tuple:
    """(the prompt's rows before its tokens, the keyword arguments of
    ``prefill`` and ``forward``): a case's frames encoded
    (``encoder_out``) or its patch embeddings (``frontend_embeds``)."""
    if "frames" not in case:
        return 0, {}
    frames = asarray(case["frames"])
    if cfg.encoder_layers:
        return 0, {"encoder_out": model.encode(params, frames)}
    return frames.shape[1], {"frontend_embeds": frames}


def _reference_slice(pair, case, decode) -> dict:
    """The reference's prefill, greedy decode and forward of a slice case,
    under its tp_sp policy at the case's degree (an encoder-decoder's
    frames encoded first)."""
    cfg, model = _jax_slice_model(pair, case["capacity_factor"])
    prompt = jnp.asarray(case["prompt"])
    kv_dtype = jnp.int8 if case.get("kv_dtype") == "int8" else None
    with reference_policy(case["degree"]):
        f, kw = _frontend_kwargs(cfg, model, pair.jparams, case, jnp.asarray)
        s = prompt.shape[1] + f
        logits, cache = model.prefill(pair.jparams, cfg, prompt,
                                      case["max_len"], kv_dtype=kv_dtype,
                                      **kw)
        fwd, aux = model.forward(pair.jparams, prompt, cfg, **kw)
        steps, toks = [logits[:, 0]], []
        for i in range(case["steps"]):
            tok = jnp.argmax(steps[-1], -1)[:, None].astype(jnp.int32)
            toks.append(tok[:, 0])
            logits, cache = decode[case["capacity_factor"], case["arch"]](
                pair.jparams, tok, cache, jnp.int32(s + i))
            steps.append(logits[:, 0])
    out = {"logits": np.asarray(jnp.stack(steps)),
           "tokens": np.asarray(jnp.stack(toks, 1)),
           "forward": np.asarray(fwd), "aux": float(aux),
           "cache_blocks": _reference_blocks(cache, case["degree"])}
    if "encoder_out" in kw:
        out["encoded"] = np.asarray(kw["encoder_out"])
    return out


def _reference_blocks(cache, degree: int) -> dict:
    """Leaf name -> the block shapes a rank holds by the reference's
    ``cache_specs`` (dense layout) fitted on a stand-in mesh of
    ``degree``: each dim its 'model' axis splits divided by the degree,
    the stacked unit axis taken off."""
    specs = jsharding.cache_specs(cache, StandInMesh(degree), layout="dense")
    out: dict = {}
    for (kp, leaf), (_, spec) in zip(
            jax.tree_util.tree_flatten_with_path(cache)[0],
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]):
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        dims = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        shape = tuple(size // degree if axes is not None and "model" in (
            (axes,) if isinstance(axes, str) else axes) else size
            for size, axes in zip(leaf.shape, dims))
        out.setdefault(names[-1], set()).add(
            shape[1:] if names[0] == "units" else shape)
    return out


def _emulated_prefill(pair, case) -> np.ndarray:
    """The port on one device dispatching in the case's groups
    (``ctx.grouped_as``): the single-card yardstick of a sharded run."""
    cfg = pair.tcfg
    if case["capacity_factor"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    with torch.no_grad(), ctx.grouped_as(case["degree"]):
        _, kw = _frontend_kwargs(cfg, pair.tmodel, pair.tparams, case,
                                 torch.from_numpy)
        logits, _ = pair.tmodel.prefill(
            pair.tparams, cfg, torch.from_numpy(case["prompt"]).long(),
            case["max_len"], kv_dtype=case.get("kv_dtype"), **kw)
    return logits[:, 0].numpy()


def _references(pairs, cases) -> dict:
    decode = {}
    for arch, pair in pairs.items():
        for cf in ((None, DROP_CF) if arch == MOE else (None,)):
            cfg, model = _jax_slice_model(pair, cf)
            decode[cf, arch] = jax.jit(
                lambda p, t, c, pos, cfg=cfg, model=model:
                model.decode_step(p, cfg, t, c, pos))
    out = {}
    for case in cases[2] + cases[4]:
        if case["name"] in out:
            continue
        if case["kind"] == "ring":
            out[case["name"]] = np.asarray(jref.attention(
                *(jnp.asarray(case[n]) for n in ("q", "k", "v")),
                causal=case["causal"], kv_len=case["kv_len"],
                q_offset=case["q_offset"]))
        elif case["kind"] == "decode":
            out[case["name"]] = np.asarray(jax_decode(
                *(jnp.asarray(case[n]) for n in ("q", "k", "v")),
                jnp.int32(case["kv_len"]),
                k_scale=case.get("k_scale"), v_scale=case.get("v_scale")))
        elif case["kind"] == "slice":
            pair = pairs[case["arch"]]
            out[case["name"]] = dict(_reference_slice(pair, case, decode),
                                     emulated=_emulated_prefill(pair, case))
    return out


def _of(kind: str, world: int):
    return [c["name"] for c in _cases(world) if c["kind"] == kind]


# ---------------------------------------------------------------------------
# ring attention and the decode combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _of("ring", 2) + _of("ring", 4))
def test_ring_attention_matches_reference(results, name):
    """Each rank's block of the output within 2e-5 of the oracle's; every
    block visits every rank once, its own first, unchanged; a rank sends
    and receives its K/V bytes n - 1 times."""
    got, want = results
    case, ranks = got[name]
    n = case["degree"]
    out = np.concatenate([rk["out"] for rk in ranks], axis=2)
    np.testing.assert_allclose(out, want[name], atol=RING_TOL, rtol=RING_TOL)
    kv_bytes = 2 * case["k"].nbytes // n
    for r, rk in enumerate(ranks):
        assert [src for src, _ in rk["seen"]] == [(r - t) % n
                                                  for t in range(n)]
        assert all(same for _, same in rk["seen"])
        assert rk["sent"]["ring"] == rk["received"]["ring"] \
            == (n - 1) * kv_bytes
        assert sum(rk["sent"].values()) == rk["sent"]["ring"]


@pytest.mark.parametrize("name", _of("decode", 2) + _of("decode", 4))
def test_sharded_decode_attention_matches_reference(results, name):
    """Every rank's combined output within 2e-5 of the reference's
    single-device ``sharded_decode_attention``, the same bits on every
    rank; the combine all-gathers one (B, Hkv, G, E + 2) fp32 partial."""
    got, want = results
    case, ranks = got[name]
    for rk in ranks:
        np.testing.assert_allclose(rk["out"], want[name], atol=RING_TOL,
                                   rtol=RING_TOL)
        np.testing.assert_array_equal(rk["out"], ranks[0]["out"])
        d = DEC
        assert rk["sent"]["combine"] == ((case["degree"] - 1) * d["b"]
                                         * d["hq"] * (d["e"] + 2) * 4)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _of("slice", 2) + _of("slice", 4))
def test_slice_matches_reference(results, pairs, name):
    """prefill + 8 greedy decode steps: every rank's logits within 1e-4
    (an int8 cache: 2e-2) of the reference's (under its tp_sp grouping),
    its greedy tokens the
    reference's, the same bits on every rank; forward's logits and aux
    too; the single-card grouped run (``grouped_as``) is the reference's
    prefill within 1e-4; each cache leaf is the block the reference's
    ``cache_specs`` give a rank (K/V: max_len / n rows or ring slots;
    conv channels, SSD heads, RG-LRU width; cross memories: F / n rows,
    all F where n does not divide F, marked ``mem_replicated``); a rank
    holds its E / n experts; a rank's encoder rows are the reference's
    encoder output at those rows within 1e-4."""
    got, want = results
    case, ranks = got[name]
    ref = want[name]
    n = case["degree"]
    assert len(ranks) == n
    cfg = pairs[case["arch"]].tcfg
    tol = INT8_TOL if case.get("kv_dtype") else TOL
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["logits"], ref["logits"], atol=tol,
                                   rtol=tol)
        np.testing.assert_array_equal(rk["tokens"], ref["tokens"])
        np.testing.assert_array_equal(rk["logits"], ranks[0]["logits"])
        np.testing.assert_allclose(rk["forward"], ref["forward"], atol=TOL,
                                   rtol=TOL)
        assert abs(rk["aux"] - ref["aux"]) <= TOL * max(1.0, abs(ref["aux"]))
        mine: dict = {}
        for blk in rk["cache_shapes"]:
            for name, shape in blk.items():
                mine.setdefault(name, set()).add(shape)
        for name in ("k_scale", "v_scale"):
            # the port cuts an int8 cache's per-row scales with their rows
            # (the reference's specs leave them whole)
            if name in mine:
                assert mine.pop(name) == {s[:3] for s in mine[name[0]]}
        assert mine == {k: v for k, v in ref["cache_blocks"].items()
                        if not k.endswith("_scale")}
        if "k" in mine:
            rows, replicated = _cache_rows(
                min(case["max_len"], cfg.attn_window or case["max_len"]), n)
            assert mine["k"] == {(BATCH, cfg.num_kv_heads, rows, cfg.hd)}
            assert rk["replicated"] == replicated
        if cfg.moe is not None:
            assert rk["expert_shape"][0] == cfg.moe.num_experts // n
        if cfg.encoder_layers:
            f = case["frontend_tokens"]
            rows, replicated = _cache_rows(f, n)
            assert mine["mem_k"] == {(BATCH, cfg.num_kv_heads, rows, cfg.hd)}
            assert rk["mem_replicated"] == replicated
            block = slice(0, f) if replicated else slice(r * rows,
                                                         (r + 1) * rows)
            np.testing.assert_allclose(rk["encoded"],
                                       ref["encoded"][:, block], atol=TOL,
                                       rtol=TOL)
        else:
            assert not rk["mem_replicated"]
    np.testing.assert_allclose(ref["emulated"], ref["logits"][0], atol=TOL,
                               rtol=TOL)


def _cache_rows(max_len: int, n: int) -> tuple[int, bool]:
    """A rank's dense cache rows, and whether it is replicated: max_len /
    n where n divides max_len, else all of them (``fit_spec``'s rule)."""
    return (max_len // n, False) if max_len % n == 0 else (max_len, True)


@pytest.mark.parametrize("name", _of("slice", 2) + _of("slice", 4))
def test_split_weights_are_the_whole_weights_route(results, name):
    """The same slice on the rank's tp_sp split of the weights, each
    layer's split leaves gathered whole before the layer: logits, tokens,
    forward and aux bit for bit the whole-weight run's, the same cache."""
    got, _ = results
    _, ranks = got[name]
    for rk in ranks:
        split = rk["split"]
        for key in ("logits", "tokens", "forward"):
            np.testing.assert_array_equal(split[key], rk[key], err_msg=key)
        assert split["aux"] == rk["aux"]
        assert split["cache_shapes"] == rk["cache_shapes"]
        assert split["replicated"] == rk["replicated"]
        assert split["mem_replicated"] == rk["mem_replicated"]


def _slice_bytes(cfg, case, rank: int) -> tuple[dict, dict]:
    """(prefill, decode) bytes a rank's collectives send, from the shapes
    (a prefill: an encoder-decoder's ``encode`` and ``prefill``)."""
    n, s = case["degree"], case["prompt"].shape[1]
    f32, steps = 4, case["steps"]
    f = case["frames"].shape[1] if "frames" in case else 0
    if not cfg.encoder_layers:
        s += f                  # the patch rows count toward the prompt
    split = s % n == 0
    rows = s // n
    pre = dict.fromkeys(ctx.KINDS, 0)
    dec = dict.fromkeys(ctx.KINDS, 0)
    if split and rank == n - 1:
        pre["bcast"] = (n - 1) * BATCH * cfg.vocab_size * f32
    combine = steps * (n - 1) * BATCH * cfg.num_heads * (cfg.hd + 2) * f32

    def gathered(size: int, per_rank: int) -> int:
        # a decode step's all-gather of a rank's block of ``size`` entries
        return 0 if size % n else steps * (n - 1) * per_rank * size // n

    for kind in cfg.layer_kinds:
        if kind == "ssd":
            m = cfg.ssm
            nh = m.expand * cfg.d_model // m.head_dim
            conv = m.expand * cfg.d_model + 2 * m.n_groups * m.d_state
            if split:
                pre["halo"] += (n - 1) * BATCH * min(m.conv_width - 1,
                                                     rows) * conv * f32
                pre["carry"] += (n - 1) * BATCH * nh * (
                    m.head_dim * m.d_state + 1) * f32
            dec["gather"] += (gathered(conv, BATCH * f32)
                              + gathered(nh, BATCH * m.head_dim * f32))
        elif kind == "rec":
            w = cfg.lru_width or cfg.d_model
            if split:
                pre["halo"] += (n - 1) * BATCH * min(3, rows) * w * f32
                pre["carry"] += (n - 1) * 2 * BATCH * w * f32
            dec["gather"] += 2 * gathered(w, BATCH * f32)
        elif cfg.attn_window:
            if split:
                pre["halo"] += (n - 1) * 2 * BATCH * cfg.num_kv_heads * min(
                    cfg.attn_window, rows) * cfg.hd * f32
            if min(case["max_len"], cfg.attn_window) % n == 0:
                dec["combine"] += combine
        else:
            if split:
                pre["ring"] += (n - 1) * 2 * BATCH * cfg.num_kv_heads * rows \
                    * cfg.hd * f32
            if not _cache_rows(case["max_len"], n)[1]:
                dec["combine"] += combine
    if cfg.encoder_layers and f % n == 0:
        # each encoder layer's K/V and each cross block's memories
        # gathered whole once; a decode step's cross partials combined
        pre["gather"] += ((cfg.encoder_layers + cfg.num_layers) * (n - 1)
                          * 2 * BATCH * cfg.num_kv_heads * f // n * cfg.hd
                          * f32)
        dec["combine"] += cfg.num_layers * combine
    layers = cfg.num_layers
    m = cfg.moe
    if m is not None:
        cf = case["capacity_factor"] or m.capacity_factor
        e_loc = m.num_experts // n

        def cap(t):
            return max(4, int(cf * t * m.top_k / m.num_experts))

        d = cfg.d_model
        if split:
            buf = m.num_experts * cap(BATCH * s // n) * d * f32
            pre["a2a"] = layers * 2 * buf * (n - 1) // n
            pre["gather"] = layers * (n - 1) * 2 * m.num_experts * f32
        else:
            pre["gather"] = layers * (n - 1) * e_loc * cap(BATCH * s) * d * f32
        dec["gather"] = (case["steps"] * layers * (n - 1) * e_loc
                         * cap(BATCH) * d * f32)
    return pre, dec


@pytest.mark.parametrize("name", _of("slice", 2) + _of("slice", 4))
def test_slice_bytes_match_shapes(results, pairs, name):
    """Each rank's bytes by kind: the ring's n - 1 K/V blocks a layer, the
    last row's logits broadcast by their owner, the decode combine (the
    cross blocks' too), an encoder's and the cross blocks' K/V gathered
    whole where the degree divides the frames, and for the MoE the two
    expert all-to-alls and the aux terms' gather (or, ungrouped, the
    expert outputs' gather); a recurrent layer's conv halo
    of 3 rows and its carry (state and decay) a prefill, a windowed
    layer's K/V halo of min(W, rows) rows, and a decode step's gathers of
    the conv output and the heads' y (SSD) or h (RG-LRU)."""
    got, _ = results
    case, ranks = got[name]
    cfg = pairs[case["arch"]].tcfg
    for r, rk in enumerate(ranks):
        pre, dec = _slice_bytes(cfg, case, r)
        assert rk["prefill_sent"] == pre
        assert rk["decode_sent"] == dec


def _weights_bytes(params, n: int, encoder: bool = True) -> int:
    """Bytes a rank's gathers receive to make the whole weights of one
    pass (embedding, every layer, the unembedding or, tied, the
    embedding again; an encoder's layers unless ``encoder`` is false)
    from its tp_sp split: (n - 1) / n of each leaf that param_specs
    splits, the routed experts excepted (they stay split)."""
    specs = dict(leaves_with_paths(param_specs(params, policy="tp_sp",
                                               degree=n)))
    total = 0
    for path, leaf in leaves_with_paths(params):
        if specs[path] is None or (leaf.ndim == 3 and "ffn/w_" in path):
            continue
        if not encoder and path.startswith("encoder/"):
            continue
        nbytes = leaf.numel() * leaf.element_size() * (n - 1) // n
        total += nbytes * (2 if path == "embed" and "unembed" not in params
                           else 1)
    return total


@pytest.mark.parametrize("name", _of("slice", 2) + _of("slice", 4))
def test_split_weight_bytes_match_shapes(results, pairs, name):
    """On split weights each pass gathers the whole weights once (kind
    ``weights``: the prefill, an encoder's layers with it, each decode
    step, forward); every other kind's bytes are the whole-weight
    run's."""
    got, _ = results
    case, ranks = got[name]
    params = pairs[case["arch"]].tparams
    n = case["degree"]
    w, w_dec = _weights_bytes(params, n), _weights_bytes(params, n, False)
    for rk in ranks:
        split = rk["split"]
        for key, passes, per in (("prefill_sent", 1, w),
                                 ("decode_sent", STEPS, w_dec),
                                 ("forward_sent", 1, w_dec)):
            assert split[key]["weights"] == passes * per, key
            assert rk[key]["weights"] == 0, key
            assert dict(split[key], weights=0) == rk[key], key


# ---------------------------------------------------------------------------
# run_cell
# ---------------------------------------------------------------------------


def _one_card_cell(cell, steps: int, cfg=None) -> np.ndarray:
    """The cell's logits on one device with no policy (internlm2-smoke at
    fp32 unless ``cfg``), from run_cell's seeds at seed 0."""
    cfg = cfg or dataclasses.replace(get_smoke("internlm2-1.8b"),
                                     compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = cell.global_batch, cell.seq_len
    with torch.no_grad():
        if cell.kind == "prefill":
            batch = {}
            if cfg.frontend is not None:
                batch["frontend"] = cell_frames(cfg, b, seed=4, device="cpu")
            f = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
            batch["tokens"] = cell_tokens(cfg, b, s - f, seed=1,
                                          device="cpu")
            return make_prefill_step(model, s)(params, batch)[0].numpy()
        cache = seeded_cache(cfg, b, s, s - steps, seed=2, device="cpu")
        tokens = cell_tokens(cfg, b, steps, seed=3, device="cpu")
        return decode_steps(model, params, cache, tokens, s - steps,
                            torch.device("cpu"))[0].numpy()


def _one_card_train(cell, steps: int, degree: int) -> list:
    """The losses of ``steps`` one-device train steps of internlm2-smoke
    at fp32 from run_cell's seeds at seed 0, on the ``degree`` ranks'
    batches concatenated."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.optim import OptConfig, adamw_init

    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    state = adamw_init(params)
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=0,
                                            total_steps=steps))
    losses = []
    for i in range(steps):
        parts = [SyntheticLMData(
            vocab_size=cfg.vocab_size, seq_len=cell.seq_len,
            global_batch=cell.global_batch, seed=5, process_index=r,
            process_count=degree).batch_at(i) for r in range(degree)]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        params, state, m = step(params, state, batch_on(batch, "cpu"))
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_run_cell(results, world, kind):
    """A prefill and a decode cell on the ranks give the one-device
    logits within 1e-4 and record the policy, degree, model flops and
    bytes by kind (device numbers "not measured" on the CPU); a train
    cell trains under fsdp, its losses within 1e-4 of the one-device
    step's on the ranks' batches concatenated."""
    from repro_torch.analysis.flops import model_flops

    got, _ = results
    case, ranks = got[f"cell-{world}-{kind}"]
    if kind == "train":
        want = _one_card_train(case["cell"], case["steps"], world)
        for r, rk in enumerate(ranks):
            rec = rk["record"]
            np.testing.assert_allclose(rec["losses"], want, rtol=TOL)
            assert rec["losses"] == ranks[0]["record"]["losses"]
            assert (rec["policy"], rec["degree"], rec["rank"]) == (
                "fsdp", world, r)
            assert rec["model_flops"] == model_flops(case["cfg"],
                                                     case["cell"],
                                                     causal=True)
            assert rec["step_device_ms"] == "not measured"
            assert len(rec["step_wall_s"]) == case["steps"]
            assert rec["sent_bytes"]["weights"] > 0
            assert rec["sent_bytes"]["reduce_scatter"] > 0
        return
    want = _one_card_cell(case["cell"], case["steps"])
    for r, rk in enumerate(ranks):
        rec = rk["record"]
        np.testing.assert_allclose(rk["logits"], want, atol=TOL, rtol=TOL)
        assert rec["policy"] == ("sp_rep" if kind == "prefill" else "tp_sp")
        assert (rec["degree"], rec["rank"]) == (world, r)
        assert rec["model_flops"] == model_flops(case["cfg"], case["cell"],
                                                 causal=True)
        assert rec["peak_mem_bytes"] == "not measured"
        assert rec["step_device_ms"] == "not measured"
        assert len(rec["step_wall_s"]) == (1 if kind == "prefill" else 3)
        key = "ring" if kind == "prefill" else "combine"
        assert rec["sent_bytes"][key] > 0
        # a tp_sp cell runs on the rank's split weights, gathered on use
        assert (rec["sent_bytes"]["weights"] > 0) == (kind == "decode")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", list(RECURRENT_LENS))
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_run_cell_recurrent(results, world, arch, kind):
    """mamba2 and recurrentgemma cells on the ranks: the one-device
    logits within 1e-4, the same bits on every rank; a prefill (sp_rep)
    exchanges halos and carries, a decode (tp_sp, a seeded cache cut to
    each rank's states and ring slots) gathers channels and heads."""
    got, _ = results
    case, ranks = got[f"cell-{world}-{arch}-{kind}"]
    want = _one_card_cell(case["cell"], case["steps"], case["cfg"])
    for r, rk in enumerate(ranks):
        rec = rk["record"]
        np.testing.assert_allclose(rk["logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(rk["logits"], ranks[0]["logits"])
        assert rec["policy"] == ("sp_rep" if kind == "prefill" else "tp_sp")
        assert (rec["degree"], rec["rank"]) == (world, r)
        keys = ("halo", "carry") if kind == "prefill" else ("gather",)
        assert all(rec["sent_bytes"][k] > 0 for k in keys), rec["sent_bytes"]
        assert rec["sent_bytes"]["ring"] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", FRONTEND)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_run_cell_frontend(results, world, arch, kind):
    """whisper and internvl2 cells on the ranks: a prefill (sp_rep; the
    frames encoded on each rank's block, or the patch rows in the row
    split) and a decode (tp_sp, a seeded cache with each rank's block of
    the memories) give the one-device logits within 1e-4, the same bits
    on every rank, and each rank's bytes by kind are the shapes'. The
    model flops count the encoder on the prefill only, as the
    reference's: a deeper encoder changes a prefill's, not a decode's."""
    from repro_torch.analysis.flops import model_flops

    got, _ = results
    case, ranks = got[f"cell-{world}-{arch}-{kind}"]
    cfg, cell, steps = case["cfg"], case["cell"], case["steps"]
    want = _one_card_cell(cell, steps, cfg)
    f = cfg.num_frontend_tokens
    b = cell.global_batch
    as_slice = dict(degree=world, capacity_factor=None, steps=steps,
                    max_len=cell.seq_len, frames=np.zeros((b, f, 1)),
                    prompt=np.zeros((b, cell.seq_len - (
                        0 if cfg.encoder_layers else f))))
    flops = model_flops(cfg, cell, causal=True)
    if cfg.encoder_layers:
        deeper = dataclasses.replace(cfg,
                                     encoder_layers=2 * cfg.encoder_layers)
        assert (model_flops(deeper, cell, causal=True) > flops) == (
            kind == "prefill")
    w_dec = _weights_bytes(build_model(cfg).init(0, device="cpu"), world,
                           False)
    for r, rk in enumerate(ranks):
        rec = rk["record"]
        np.testing.assert_allclose(rk["logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(rk["logits"], ranks[0]["logits"])
        assert rec["policy"] == ("sp_rep" if kind == "prefill" else "tp_sp")
        assert (rec["degree"], rec["rank"]) == (world, r)
        assert rec["model_flops"] == flops
        pre, dec = _slice_bytes(cfg, as_slice, r)
        if kind == "prefill":
            assert rec["sent_bytes"] == pre
        else:
            assert rec["sent_bytes"] == dict(dec, weights=steps * w_dec)


@pytest.mark.parametrize("arch", FRONTEND)
def test_run_cell_refuses_long_500k_for_the_frontend_archs(arch):
    from repro_torch.launch.dryrun import run_cell

    with pytest.raises(ValueError, match="sub-quadratic"):
        run_cell(arch, "long_500k", SeqShard(None, 0, 1), device="cpu")


def test_run_cell_honours_cell_is_runnable():
    """long_500k runs for the sub-quadratic archs only, as the
    reference's ``cell_is_runnable`` says; the refusal comes before any
    weight is drawn."""
    from repro_torch.launch.dryrun import run_cell

    with pytest.raises(ValueError, match="sub-quadratic"):
        run_cell("internlm2-1.8b", "long_500k", SeqShard(None, 0, 1),
                 device="cpu")


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("kind", ["tp_sp", "sp_rep", "fsdp"])
def test_token_groups_match_reference(degree, kind):
    """(g_b, g_s) for batches and lengths the degree divides or not."""
    for b in (1, 2, 4, 6):
        for s in (1, 12, 25, 32):
            with jctx.sharding_policy(StandInMesh(degree), kind):
                want = jmoe._token_groups(b, s)
            with sharding_policy(SeqShard(None, 0, degree), kind):
                assert tmoe._token_groups(b, s) == want
            assert tmoe.token_groups(b, s, degree, kind) == want
    with ctx.grouped_as(degree):
        assert tmoe._token_groups(2, 32) == (1, degree)
    assert tmoe._token_groups(2, 32) == (1, 1)


def _ref_model_dim(spec, shift: int):
    for dim, axes in enumerate(tuple(spec)):
        names = (axes,) if isinstance(axes, str) else (axes or ())
        if "model" in names:
            return dim - shift
    return None


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("policy", ["tp_sp", "sp_rep", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, policy, degree):
    """Every parameter's split dim is the one the reference's fitted spec
    gives its 'model' axis (its stacked axis taken off); the optimizer
    moments follow; the batch is whole outside fsdp."""
    jcfg = jax_get_smoke(arch)
    shapes = jax.eval_shape(
        lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    jspecs = jsharding.param_specs(shapes, StandInMesh(degree), policy)
    want = {}
    for kp, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        stacked = path.startswith("units/") or "encoder/" in path
        want[path] = _ref_model_dim(spec, int(stacked))
    tcfg = get_smoke(arch)
    params = build_model(tcfg).init(0, device="cpu")
    specs = param_specs(params, policy=policy, degree=degree)
    got = dict(leaves_with_paths(specs))
    for path, leaf in leaves_with_paths(params):
        if path == "unembed" and policy == "tp_sp":
            # C17: the port's own rule splits the vocabulary columns;
            # the reference's embed$ rule splits the d_model rows
            assert want[path] == fit_dim(0, leaf.shape, degree)
            assert got[path] == fit_dim(1, leaf.shape, degree)
            continue
        assert got[path] == want[reference_leaf(path, tcfg)], path
    opt = opt_specs(specs)
    assert opt["mu"] is specs and opt["nu"] is specs and opt["step"] is None
    ref_batch = jsharding.batch_specs(StandInMesh(degree))
    assert all(_ref_model_dim(s, 0) is None for s in ref_batch.values())
    assert batch_specs(policy=policy) == {
        "tokens": 0 if policy == "fsdp" else None,
        "labels": 0 if policy == "fsdp" else None}
    assert batch_specs(policy="fsdp", batch=3, degree=degree)["tokens"] \
        is None


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_policy_matches_reference(arch, shape):
    assert choose_policy(get_arch(arch), SHAPES[shape]) == \
        jax_choose_policy(jax_get_arch(arch), JAX_SHAPES[shape])


def test_local_params_cut_the_experts_only():
    cfg = get_smoke(MOE)
    params = build_model(cfg).init(0, device="cpu")
    mine = local_params(params, rank=1, degree=4)
    e = cfg.moe.num_experts
    for (path, p), (_, q) in zip(leaves_with_paths(params),
                                 leaves_with_paths(mine)):
        if path.endswith(("ffn/w_gate", "ffn/w_up", "ffn/w_down")):
            assert torch.equal(q, p[e // 4:e // 2])
        else:
            assert q is p
    with pytest.raises(ValueError, match="experts do not split"):
        local_params(params, rank=0, degree=3)


def test_rows_rule():
    """A rank's rows: its block where the degree divides, all rows where
    it does not; fsdp splits the batch; no policy is the identity."""
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    heads = torch.arange(4 * 2 * 8 * 1).reshape(4, 2, 8, 1)
    assert ctx.seq_sharded_activations(x) is x
    with sharding_policy(SeqShard(None, 1, 4)):
        assert torch.equal(ctx.seq_sharded_activations(x), x[:, 2:4])
        assert torch.equal(ctx.seq_sharded_heads(heads), heads[:, :, 2:4])
        assert ctx.replicated_heads(heads) is heads
        assert ctx.seq_slice(6) == slice(0, 6)
        assert ctx.batch_axes() == () and ctx.policy_kind() == "tp_sp"
        with sharding_policy(SeqShard(None, 1, 4), "fsdp"):
            assert torch.equal(ctx.seq_sharded_activations(heads), heads[1:2])
            assert torch.equal(ctx.replicated_heads(heads), heads[1:2])
            assert ctx.batch_axes() == ("model",)
        assert ctx.policy_kind() == "tp_sp"
    assert ctx.seq_shard_state() is None
    with pytest.raises(ValueError, match="unknown sharding policy"):
        with sharding_policy(SeqShard(None, 0, 1), "dp"):
            pass


@pytest.mark.parametrize("arch", REFUSED)
def test_policy_refuses_other_archs(arch):
    """whisper and internvl2 serve under tp_sp and sp_rep; fsdp, which
    splits the batch for training (``forward`` and ``encode``), is
    refused for their prefill before any collective."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.long)
    frames = torch.ones((1, cfg.num_frontend_tokens, cfg.d_model))
    kwargs = ({"encoder_out": model.encode(params, frames)}
              if cfg.encoder_layers else {"frontend_embeds": frames})
    with sharding_policy(SeqShard(None, 0, 1), "fsdp"):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            model.prefill(params, cfg, tokens, 16, **kwargs)


def test_policy_refuses_fsdp_and_training():
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.long)
    with sharding_policy(SeqShard(None, 0, 1), "fsdp"), pytest.raises(
            NotImplementedError, match="fsdp"):
        model.prefill(params, cfg, tokens, 8)
    params["embed"].requires_grad_(True)
    with sharding_policy(SeqShard(None, 0, 1)), pytest.raises(
            NotImplementedError, match="training across devices"):
        model.forward(params, tokens, cfg)


def test_unembed_takes_the_embed_rule_as_in_the_reference():
    """C17, repaired: the reference's first-match rules give an untied
    unembedding (D, V) the embedding's ("model", None), so its d_model
    rows split; the port puts ``unembed$`` first, so its vocabulary
    columns split, as the rule written for it says. The reference's
    ``param_spec`` still returns the embedding's rule."""
    cfg = get_smoke("deepseek-coder-33b")
    assert not cfg.tie_embeddings
    params = build_model(cfg).init(0, device="cpu")
    assert param_specs(params, degree=2)["unembed"] == 1
    assert param_specs(params, degree=2)["embed"] == 0
    assert param_spec("unembed", 2, is_moe_expert=False) == (None, "model")
    assert jsharding.param_spec("unembed", 2, is_moe_expert=False) == \
        jax.sharding.PartitionSpec("model", None)


def _cat_ranks(parts: list, dim) -> torch.Tensor:
    return parts[0] if dim is None else torch.cat(parts, dim)


@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_sp_local_params_are_the_fitted_blocks(arch, degree):
    """Under tp_sp a rank holds each leaf's block along its fitted
    param_specs dim (whole where none or the degree does not divide):
    the ranks' blocks concatenated are the whole tree, and split_specs
    marks every split leaf but the experts with (dim, whole size)."""
    cfg = get_smoke(arch)
    params = build_model(cfg).init(0, device="cpu")
    dims = dict(leaves_with_paths(param_specs(params, policy="tp_sp",
                                              degree=degree)))
    ranks = [dict(leaves_with_paths(local_params(
        params, rank=r, degree=degree, policy="tp_sp")))
        for r in range(degree)]
    gathered = {path: spec for path, spec in leaves_with_paths(
        split_specs(cfg, degree)) if spec is not None}
    for path, leaf in leaves_with_paths(params):
        dim = dims[path]
        assert torch.equal(_cat_ranks([rk[path] for rk in ranks], dim), leaf)
        if dim is not None:
            assert ranks[0][path].shape[dim] * degree == leaf.shape[dim]
        expert = leaf.ndim == 3 and "ffn/w_" in path
        want = None if dim is None or expert else (dim, leaf.shape[dim])
        assert gathered.get(path) == want, path


def test_local_params_in_place_releases_the_whole_leaves():
    """``in_place``: the blocks replace the leaves in the tree itself and
    no whole leaf outlives its cut (the draw a rank cuts on the card)."""
    cfg = get_smoke("deepseek-coder-33b")
    params = build_model(cfg).init(0, device="cpu")
    copy = build_model(cfg).init(0, device="cpu")
    refs = {path: weakref.ref(leaf) for path, leaf in
            leaves_with_paths(params)}
    want = local_params(copy, rank=1, degree=2, policy="tp_sp")
    got = local_params(params, rank=1, degree=2, policy="tp_sp",
                       in_place=True)
    assert got is params
    gc.collect()
    split = {path for path, d in leaves_with_paths(param_specs(
        copy, policy="tp_sp", degree=2)) if d is not None}
    assert split and all(refs[p]() is None for p in split)
    for (pa, a), (pb, b) in zip(leaves_with_paths(got),
                                leaves_with_paths(want)):
        assert pa == pb and torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown policy"):
        local_params(copy, rank=0, degree=2, policy="dp")


@pytest.mark.parametrize("degree,rank", [(4, 1), (4, 3), (2, 0)])
def test_seeded_cache_the_degree_does_not_divide_is_replicated(degree,
                                                               rank):
    """A rank's seeded cache of a length the degree does not divide is
    the whole cache, marked replicated; of one it divides, its block."""
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              compute_dtype=torch.float32)
    shard = SeqShard(None, rank, degree)
    for max_len in (42, 40):
        whole = seeded_cache(cfg, 2, max_len, 30, seed=2, device="cpu")
        mine = seeded_cache(cfg, 2, max_len, 30, seed=2, device="cpu",
                            shard=shard)
        replicated = max_len % degree != 0
        rows = max_len if replicated else max_len // degree
        c0 = 0 if replicated else rank * rows
        assert mine.get("replicated", False) == replicated
        for a, b in zip(mine["layers"], whole["layers"]):
            for name in ("k", "v"):
                assert a[name].shape[2] == rows
                assert torch.equal(a[name], b[name][:, :, c0:c0 + rows])


@pytest.mark.parametrize("degree,rank", [(4, 1), (4, 3), (2, 0)])
@pytest.mark.parametrize("arch", list(RECURRENT_LENS))
def test_seeded_cache_cuts_states_and_ring_slots(arch, degree, rank):
    """A rank's seeded cache of a recurrent stack is the whole seeded
    cache cut to the rank's ``cache_specs`` blocks (conv channels, SSD
    heads, RG-LRU width, a window's ring slots), the same values; the
    ring's slots past kv_len stay zero."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=torch.float32)
    shard = SeqShard(None, rank, degree)
    for kv_len in (20, 36):
        whole = seeded_cache(cfg, 2, 40, kv_len, seed=2, device="cpu")
        mine = seeded_cache(cfg, 2, 40, kv_len, seed=2, device="cpu",
                            shard=shard)
        want = local_cache(whole, rank=rank, degree=degree, layout="dense")
        assert "replicated" not in mine
        for a, b, full in zip(mine["layers"], want["layers"],
                              whole["layers"]):
            assert a.keys() == b.keys()
            for name in a:
                assert torch.equal(a[name], b[name]), name
                assert full[name].abs().sum() > 0, name
            if "k" in full:
                assert not full["k"][:, :, kv_len:].any()
