"""The port's paged model functions against the JAX model's.

``prefill_chunk`` and ``paged_decode_step`` run on both packages over the
reference's fp32 weights (with random norm scales, so the logits vary),
on the same shuffled page allocation: the reference with its Pallas
kernels in interpret mode, the port with its kernels' plain versions on
the CPU. The logits of every call must agree to atol 1e-4, and after the
run the K/V pools must agree page by page (the scratch page aside, whose
bytes depend on the order of duplicate writes). Chunked prefill, at
several chunk sizes, must give the first token of monolithic prefill.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.api import build_model
from test_torch_harness import (
    FP32_ATOL,
    LOGITS_ATOL,
    as_numpy,
    chunk_span,
    model_pair,
    prompts,
)

ARCHS = ["internlm2-1.8b", "qwen3-1.7b"]
PAGE, N_PAGES, MAX_PAGES = 4, 16, 6


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param, seed=2, norm_std=2.0)


def _caches(pair):
    kw = dict(cache_layout="paged", page_size=PAGE, num_pages=N_PAGES)
    return (pair.jmodel.make_cache(1, MAX_PAGES * PAGE, **kw),
            pair.tmodel.make_cache(1, MAX_PAGES * PAGE, device="cpu", **kw))


def _chunk(pair, jc, tc, tokens, table, q0, clen, chunk):
    """One prefill chunk on both sides; returns both last-row logits and
    the updated caches."""
    toks = np.ones((1, chunk), np.int32)
    toks[0, :clen] = tokens[q0:q0 + clen]
    p0 = q0 // PAGE
    cpages = np.array([table[p] if p < len(table) else 0
                       for p in range(p0, p0 + chunk // PAGE)], np.int32)
    jl, jc = pair.jmodel.prefill_chunk(
        pair.jparams, pair.jcfg, jnp.asarray(toks), jc, jnp.asarray(table),
        jnp.asarray(cpages), jnp.int32(q0), jnp.int32(clen))
    tl, tc = pair.tmodel.prefill_chunk(
        pair.tparams, pair.tcfg, torch.from_numpy(toks), tc,
        torch.from_numpy(table), torch.from_numpy(cpages),
        chunk_span(q0, clen))
    return jl, tl, jc, tc


def _pool_pages(jc, tc, layer: int, which: str):
    return (np.asarray(jc["units"]["b0"][which][layer]),
            tc["layers"][layer][which].numpy())


def test_prefill_chunk_and_paged_decode_match_reference(pair):
    vocab = pair.tcfg.vocab_size
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    # sequence A: 13 prompt tokens in chunks of 8 (ragged second chunk),
    # sequence B: 5 tokens in one ragged chunk; slot 2 stays idle
    seqs = {0: (prompts(11, 1, 13, vocab)[0], perm[:5]),
            1: (prompts(12, 1, 5, vocab)[0], perm[5:8])}
    jc, tc = _caches(pair)
    table = np.zeros((3, MAX_PAGES), np.int32)
    last = {}
    for slot, (toks, pages) in seqs.items():
        table[slot, :len(pages)] = pages
        for q0 in range(0, len(toks), 8):
            clen = min(8, len(toks) - q0)
            jl, tl, jc, tc = _chunk(pair, jc, tc, toks, table[slot], q0,
                                    clen, 8)
            np.testing.assert_allclose(as_numpy(tl), as_numpy(jl),
                                       atol=LOGITS_ATOL, rtol=0)
        last[slot] = int(np.argmax(as_numpy(jl)[0]))
        assert int(torch.argmax(tl[0])) == last[slot]
    token = np.array([[last[0]], [last[1]], [0]], np.int32)
    positions = np.array([13, 5, 0], np.int32)
    for _ in range(3):
        jl, jc = pair.jmodel.paged_decode_step(
            pair.jparams, pair.jcfg, jnp.asarray(token), jc,
            jnp.asarray(table), jnp.asarray(positions))
        tl, tc = pair.tmodel.paged_decode_step(
            pair.tparams, pair.tcfg, torch.from_numpy(token), tc,
            torch.from_numpy(table), torch.from_numpy(positions))
        assert tl.shape == tuple(jl.shape)
        np.testing.assert_allclose(as_numpy(tl)[:2], as_numpy(jl)[:2],
                                   atol=LOGITS_ATOL, rtol=0)
        token = np.argmax(as_numpy(jl), axis=-1).astype(np.int32)
        token[2] = 0
        positions[:2] += 1
    for layer in range(pair.tcfg.num_layers):
        for which in ("k", "v"):
            want, got = _pool_pages(jc, tc, layer, which)
            for page in range(1, N_PAGES):
                np.testing.assert_allclose(
                    got[:, page], want[:, page], atol=FP32_ATOL, rtol=0,
                    err_msg=f"layer {layer} {which} page {page}")


class _HostReads(TorchDispatchMode):
    """Counts the reads of an integer tensor's value on the host
    (``int()``, ``.item()``: ``aten._local_scalar_dense``): positions,
    lengths and page ids, which a step keeps on the device."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten._local_scalar_dense.default
                and not args[0].is_floating_point()):
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_prefill_chunk_takes_its_span_on_the_device(pair):
    """``prefill_chunk`` takes (q_offset, kv_len, last row) as one int32
    tensor, as the engine packs it: a first, a middle and a ragged last chunk of a
    20-token prompt at chunk 8 give the reference's last-row logits (fp32,
    atol 3e-5) and pages, and on plain attention no value of the pair is
    read on the host."""
    vocab = pair.tcfg.vocab_size
    toks = prompts(13, 1, 20, vocab)[0]
    table = np.random.default_rng(3).permutation(
        np.arange(1, N_PAGES))[:MAX_PAGES].astype(np.int32)
    jc, tc = _caches(pair)
    _, pc = _caches(pair)
    plain = build_model(dataclasses.replace(pair.tcfg, attn_impl="plain"))
    for q0, clen in ((0, 8), (8, 8), (16, 4)):
        jl, tl, jc, tc = _chunk(pair, jc, tc, toks, table, q0, clen, 8)
        np.testing.assert_allclose(as_numpy(tl), as_numpy(jl),
                                   atol=FP32_ATOL, rtol=0)
        ctoks = torch.ones((1, 8), dtype=torch.long)
        ctoks[0, :clen] = torch.from_numpy(toks[q0:q0 + clen])
        cpages = torch.from_numpy(table[q0 // PAGE:q0 // PAGE + 2].copy())
        with _HostReads() as reads:
            pl, pc = plain.prefill_chunk(pair.tparams, plain.cfg, ctoks, pc,
                                         torch.from_numpy(table), cpages,
                                         chunk_span(q0, clen))
        assert reads.count == 0
        np.testing.assert_allclose(as_numpy(pl), as_numpy(jl),
                                   atol=FP32_ATOL, rtol=0)
    for layer in range(pair.tcfg.num_layers):
        for which in ("k", "v"):
            want, got = _pool_pages(jc, tc, layer, which)
            np.testing.assert_allclose(got[:, table[:5]], want[:, table[:5]],
                                       atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_prefill_gives_the_monolithic_first_token(pair, chunk):
    vocab = pair.tcfg.vocab_size
    toks = prompts(21, 1, 13, vocab)[0]
    want, _ = pair.tmodel.prefill(pair.tparams, pair.tcfg,
                                  torch.from_numpy(toks[None]).long(), 24)
    jwant, _ = pair.jmodel.prefill(pair.jparams, pair.jcfg,
                                   jnp.asarray(toks[None]), 24)
    np.testing.assert_allclose(as_numpy(want), as_numpy(jwant),
                               atol=LOGITS_ATOL, rtol=0)
    _, tc = _caches(pair)
    table = np.array([9, 3, 14, 6, 1, 0], np.int32)
    for q0 in range(0, len(toks), chunk):
        clen = min(chunk, len(toks) - q0)
        p0 = q0 // PAGE
        cpages = torch.tensor([int(table[p]) for p in
                               range(p0, p0 + chunk // PAGE)],
                              dtype=torch.int32)
        ctoks = torch.ones((1, chunk), dtype=torch.long)
        ctoks[0, :clen] = torch.from_numpy(toks[q0:q0 + clen])
        got, tc = pair.tmodel.prefill_chunk(
            pair.tparams, pair.tcfg, ctoks, tc, torch.from_numpy(table),
            cpages, chunk_span(q0, clen))
    np.testing.assert_allclose(as_numpy(got), as_numpy(want[:, 0]),
                               atol=LOGITS_ATOL, rtol=0)
    assert int(torch.argmax(got)) == int(torch.argmax(want[0, 0]))
    # the ragged tail of the last page was written as zeros
    tail = tc["layers"][0]["k"][:, int(table[13 // PAGE]), 13 % PAGE:]
    assert float(tail.abs().max()) == 0.0


def test_paged_cache_shapes_and_limits(pair):
    cache = pair.tmodel.make_cache(2, 10, device="cpu",
                                   cache_layout="paged", page_size=4)
    cfg = pair.tcfg
    # default pool: full residency for the batch plus the scratch page
    assert len(cache["layers"]) == cfg.num_layers
    assert cache["layers"][0]["k"].shape == (cfg.num_kv_heads, 2 * 3 + 1, 4,
                                             cfg.hd)
    with pytest.raises(ValueError):
        pair.tmodel.make_cache(2, 10, device="cpu", cache_layout="ragged")
