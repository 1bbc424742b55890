"""The head-block ring of a prompt chunk on a KV-head-sharded pool
(``distributed/paged.ring_paged_prefill``), in this process.

Its runs across ranks share the two spawns of ``tests/test_torch_sharded.py``
(the function at degrees 2 and 4 against the reference's single-chip
twin and the port's one-card call; the sharded engine with
``chunk_route="ring"`` against the reference's and the single card's
tokens, with its passes and slab bytes). Here, with no group: the ring
at degree 1 against the reference's single-chip
``paged_prefill_attention`` (impl ``xla``) within 1e-6 and the port's
one-card call bit for bit, on the reference test's shape and a chunk
both degrees divide, fp32 and int8; what a hop hands its attention (an
identity table of the slab's pages on the device, the span moved to the
rank's first row); the model's chunk step on the ring route against the
local route; and the routes' validation. This file also gives
``tests/test_torch_sharded.py`` its inputs and yardsticks
(``ring_inputs``, ``ring_want``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import quantize_q8 as jax_quantize_q8
from repro.models.attention import (
    paged_prefill_attention as jax_paged_prefill,
)
from repro_torch.configs import get_smoke
from repro_torch.distributed.ctx import KVShard, kv_shard
from repro_torch.distributed.paged import ring_paged_prefill
from repro_torch.models.api import build_model
from repro_torch.models.attention import paged_prefill_attention
from repro_torch.serving import ShardedContinuousBatchingEngine

# the reference test's shape (tests/test_distributed_serving.py: Hq 8,
# Hkv 4, E 16, page 8, a permuted 6-page table of a 12-page pool, chunk
# 10 at q_offset 20, kv_len 30) and a chunk of 12 rows, which degrees 2
# and 4 divide, at q_offset 16, kv_len 28: (chunk, q_offset, kv_len)
RING_SHAPES = {"ref": (10, 20, 30), "even": (12, 16, 28)}
RING_TOL = 1e-6         # the reference test's is bitwise, between two jits
HQ, HKV, E, PAGE, NPAGES, TABLE = 8, 4, 16, 8, 12, 6


def ring_inputs(shape: str, quant: bool) -> dict:
    """One chunk's numpy inputs from ``default_rng(0)``: q (Hq, chunk,
    E), the pools (quantized per page with their scales when ``quant``),
    the table and the (q_offset, kv_len) span."""
    chunk, q_offset, kv_len = RING_SHAPES[shape]
    rng = np.random.default_rng(0)
    out = {"q": rng.standard_normal((HQ, chunk, E)).astype(np.float32)}
    for n in ("k", "v"):
        x = rng.standard_normal((HKV, NPAGES, PAGE, E)).astype(np.float32)
        if quant:
            xq, sc = jax_quantize_q8(jnp.asarray(x), (-2, -1))
            out[n], out[n + "_scales"] = np.array(xq), np.array(sc)
        else:
            out[n] = x
    out["table"] = rng.permutation(NPAGES)[:TABLE].astype(np.int32)
    out["span"] = np.asarray([q_offset, kv_len], np.int32)
    return out


def _tensors(x: dict) -> dict:
    return {n: torch.from_numpy(v) for n, v in x.items()}


def ring_want(x: dict) -> tuple:
    """The reference's single-chip ``paged_prefill_attention`` (impl
    ``xla``) of the inputs, and the port's one-card call on the
    ``kernel`` route (B5's plain version on the CPU) and the ``plain``
    twin."""
    scales = {n: jnp.asarray(x[n]) for n in ("k_scales", "v_scales")
              if n in x}
    want = np.asarray(jax_paged_prefill(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "table")),
        jnp.int32(x["span"][0]), jnp.int32(x["span"][1]), **scales))
    t = _tensors(x)
    one = {impl: paged_prefill_attention(
        t["q"], t["k"], t["v"], t["table"], t["span"], impl=impl,
        k_scales=t.get("k_scales"), v_scales=t.get("v_scales")).numpy()
        for impl in ("kernel", "plain")}
    return want, one


CASES = [(shape, quant) for shape in RING_SHAPES for quant in (False, True)]


@pytest.mark.parametrize("shape,quant", CASES)
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_ring_at_degree_one_matches_reference_and_one_card(shape, quant,
                                                           impl):
    """One rank holds every head: one hop, no pass, no gather."""
    x = ring_inputs(shape, quant)
    want, one = ring_want(x)
    t = _tensors(x)
    shard = KVShard(None, 0, 1, chunk_route="ring")
    with kv_shard(shard):
        got = paged_prefill_attention(
            t["q"], t["k"], t["v"], t["table"], t["span"], impl=impl,
            k_scales=t.get("k_scales"), v_scales=t.get("v_scales")).numpy()
    np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=0)
    np.testing.assert_array_equal(got, one[impl])
    assert shard.ring_hops == shard.ring_bytes == shard.gathered_bytes == 0


@pytest.mark.parametrize("quant", [False, True])
def test_a_hop_attends_the_slab_through_an_identity_table(quant):
    """The hop's call: every query head's rows (one rank), the rank's
    heads' pages gathered through the table in table order (int8 with
    their scales), an int32 identity table on q's device, and the span
    as given (rank 0's rows start at the chunk's)."""
    x = ring_inputs("ref", quant)
    t = _tensors(x)
    seen = []

    def attend(q, kp, vp, table, span, *, k_scales=None, v_scales=None):
        seen.append((q, kp, vp, table, span, k_scales, v_scales))
        return torch.zeros_like(q)

    ring_paged_prefill(t["q"], t["k"], t["v"], t["table"], t["span"],
                       KVShard(None, 0, 1), k_scales=t.get("k_scales"),
                       v_scales=t.get("v_scales"), attend=attend)
    (q, kp, vp, table, span, ks, vs), = seen
    ids = t["table"].long()
    assert torch.equal(q, t["q"])
    assert torch.equal(kp, t["k"][:, ids]) and torch.equal(vp, t["v"][:, ids])
    assert table.dtype == torch.int32 and table.device == q.device
    assert torch.equal(table, torch.arange(TABLE, dtype=torch.int32))
    assert torch.equal(span, t["span"]) and span is not t["span"]
    if quant:
        assert torch.equal(ks, t["k_scales"][:, ids])
        assert torch.equal(vs, t["v_scales"][:, ids])
    else:
        assert ks is None and vs is None


def _chunk_step(model, params, cache, route):
    """One 16-row chunk at q_offset 16 (kv_len 26) of a sequence whose
    first 16 rows are already in the pool, under ``kv_shard`` at degree 1
    on ``route`` -> (logits, pools)."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(3, cfg.vocab_size, (1, 16), generator=gen)
    table = torch.tensor([5, 2, 7, 1, 0, 0], dtype=torch.int32)
    span = torch.tensor([16, 26, 9], dtype=torch.int32)
    with torch.no_grad(), kv_shard(KVShard(None, 0, 1, chunk_route=route)):
        logits, cache = model.prefill_chunk(params, cfg, tokens, cache,
                                            table, table[2:4], span)
    return logits, cache


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_the_models_chunk_step_on_the_ring_route_is_the_local_routes(
        kv_dtype):
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"),
                              attn_impl="kernel",
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cpu")

    def pools():
        cache = model.make_cache(1, 48, device="cpu", cache_layout="paged",
                                 page_size=8, num_pages=8,
                                 kv_dtype=kv_dtype)
        gen = torch.Generator().manual_seed(4)
        for blk in cache["layers"]:
            for name, t in blk.items():
                t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype)
                        if name.endswith("scale") or t.is_floating_point()
                        else torch.randint(-100, 100, t.shape, generator=gen,
                                           dtype=t.dtype))
        return cache

    local = _chunk_step(model, params, pools(), "local")
    ring = _chunk_step(model, params, pools(), "ring")
    assert torch.equal(ring[0], local[0])
    for a, b in zip(ring[1]["layers"], local[1]["layers"]):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_chunk_routes_are_validated():
    cfg = get_smoke("internlm2-1.8b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="chunk route"):
        ShardedContinuousBatchingEngine(model, params, shard=1, device="cpu",
                                        chunk_route="rings", max_len=32,
                                        batch_size=2, page_size=8)
    with pytest.raises(ValueError, match="chunk route"):
        KVShard(None, 0, 1, chunk_route="")
    eng = ShardedContinuousBatchingEngine(
        model, params, shard=1, device="cpu", chunk_route="ring",
        max_len=32, batch_size=2, page_size=8)
    assert eng.chunk_route == "ring" and eng._kv.chunk_route == "ring"
