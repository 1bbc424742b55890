"""The port's FLOP and byte counts, its H100 roofline and its attention
tuner, against the JAX package's (``repro/analysis/flops.py``,
``repro/core/autotune.py``).

* ``model_flops`` / ``model_bytes`` on every arch x ``SHAPES`` cell: with
  the reference's parameter count swapped in, the port's numbers are the
  reference's bit for bit (the same formulas in the same order); with its
  own count, they differ by exactly the count gap (ROADMAP C6, C10, C12,
  C13; zero for the dense archs and internvl2-2b) times the cell's
  multiplier, up to float64 rounding of the totals (relative 1e-12).
* ``model_flops`` of a smoke prefill against ``FlopCounterMode`` over the
  port's CPU forward (the stand-in for ``repro/analysis/hlo.py``'s
  compiled count): exactly equal once two terms are taken out that the
  formula charges and no matrix product computes: the norms' scales (2
  flops a token a scale) and, with untied embeddings, the embedding
  gather (2·vocab·d_model a token). Tolerance 0.
* ``least_bytes`` <= ``model_bytes`` on every cell; ``cell_roofline`` on
  a synthetic record.
* ``_score`` equals the reference's with the reference's three rates
  patched in; ``_causal_fraction`` equal on a hypothesis sweep;
  ``tune_attention`` routes as ``choose_attention_method`` and
  ``ops.resolve_method``.
"""

from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import flops as ref_flops
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.core import autotune as ref_autotune
from repro_torch.analysis import roofline
from repro_torch.analysis.flops import least_bytes, model_bytes, model_flops
from repro_torch.configs import (
    SHAPES,
    ShapeCell,
    all_cells,
    get_arch,
    get_smoke,
)
from repro_torch.core import autotune
from repro_torch.core.policy import KV_TILE, choose_attention_method
from repro_torch.kernels import ops
from repro_torch.models.api import build_model

torch.set_num_threads(1)

ARCHS = tuple(dict.fromkeys(a for a, *_ in all_cells()))
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
# archs whose port count differs from the reference's, and why
COUNT_GAPS = {"mamba2-130m": "C6", "deepseek-moe-16b": "C10",
              "moonshot-v1-16b-a3b": "C10", "recurrentgemma-9b": "C12",
              "whisper-large-v3": "C13"}


def test_registry_matches_reference():
    assert list(all_cells()) == list(ref_all_cells())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


def _with_count(cfg, count: int):
    """``cfg`` whose ``param_count`` returns ``count`` (its
    ``active_param_count`` follows)."""
    cfg = dataclasses.replace(cfg)
    object.__setattr__(cfg, "param_count", lambda: count)
    return cfg


def _multiplier(cfg, cell) -> float:
    b, s = cell.global_batch, cell.seq_len
    return {"train": 6.0 * b * s, "prefill": 2.0 * b * s,
            "decode": 2.0 * b}[cell.kind]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_equal_reference_up_to_count_gap(arch, shape):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    cell = SHAPES[shape]
    ref_cell = REF_SHAPES[shape]
    ref_mf = ref_flops.model_flops(ref_cfg, ref_cell)
    ref_mb = ref_flops.model_bytes(ref_cfg, ref_cell)
    # the reference's count in the port's formulas: bit for bit
    swapped = _with_count(cfg, ref_cfg.param_count())
    assert model_flops(swapped, cell) == ref_mf
    assert model_bytes(swapped, cell) == ref_mb
    # the port's own count: the gap times the cell's multiplier
    gap = cfg.param_count() - ref_cfg.param_count()
    assert (gap != 0) == (arch in COUNT_GAPS)
    mf = model_flops(cfg, cell)
    if cell.kind == "decode" and cfg.encoder_layers:
        # the reference's decoder share of the count, truncated to an int
        frac = cfg.num_layers / (cfg.num_layers + cfg.encoder_layers)
        want = 2.0 * cell.global_batch * (
            int(cfg.active_param_count() * frac)
            - int(ref_cfg.active_param_count() * frac))
    else:
        want = _multiplier(cfg, cell) * gap
    assert math.isclose(mf - ref_mf, want, rel_tol=0,
                        abs_tol=1e-12 * ref_mf), (mf - ref_mf, want)
    mb = model_bytes(cfg, cell)
    per_param = {"train": 40, "prefill": 4, "decode": 4}[cell.kind]
    assert mb["params"] - ref_mb["params"] == per_param * gap
    assert {k: v for k, v in mb.items() if k not in ("params", "total")} \
        == {k: v for k, v in ref_mb.items() if k not in ("params", "total")}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_least_bytes_below_baseline_bytes(arch, shape):
    cfg, cell = get_arch(arch), SHAPES[shape]
    least = least_bytes(cfg, cell)
    assert "scores" not in least and "activations" not in least
    assert 0 < least["total"] <= model_bytes(cfg, cell)["total"]
    assert least["total"] == sum(v for k, v in least.items() if k != "total")
    # int8 caches move fewer bytes; causal prompts need fewer flops
    assert least_bytes(cfg, cell, kv_bytes=1)["total"] <= least["total"]
    if not cfg.encoder_layers:    # the encoder's count moves the other way
        assert model_flops(cfg, cell, causal=True) <= model_flops(cfg, cell)


def test_causal_counts_score_pairs():
    cfg = get_arch("internlm2-1.8b")
    b, s = 4, 2048
    cell = ShapeCell("p", s, b, "prefill")
    pairs = 4.0 * b * cfg.num_heads * cfg.hd * cfg.num_layers
    assert model_flops(cfg, cell) - model_flops(cfg, cell, causal=True) == \
        pairs * (s * s - s * (s + 1) // 2)
    # a window caps the pairs at window rows a query
    hyb = get_arch("recurrentgemma-9b")
    w, n_attn = hyb.window, hyb.layer_kinds.count("attn")
    cell = ShapeCell("p", 8000, 1, "prefill")
    want = (w * (w + 1) // 2 + (8000 - w) * w)
    got = (model_flops(hyb, cell, causal=True)
           - 2.0 * hyb.active_param_count() * 8000)
    assert got == 4.0 * hyb.num_heads * hyb.hd * want * n_attn


def test_encdec_causal_counts_the_encoder_over_frames():
    cfg = get_arch("whisper-large-v3")
    f, b, s = cfg.num_frontend_tokens, 4, 4
    cell = ShapeCell("p", s, b, "prefill")
    mf = model_flops(cfg, cell, causal=True)
    # at least the encoder's matrix products over every frame
    enc = cfg.encoder_layers * (4 * cfg.d_model ** 2
                                + 2 * cfg.d_model * cfg.d_ff)
    assert mf > 2.0 * b * f * enc > model_flops(cfg, cell) / 2
    # a decode step: the decoder's parameters exactly (its layers,
    # embeddings and the cross blocks' norm, Q and O), self-attention over
    # the cache and cross-attention over the frames
    d, e, h = cfg.d_model, cfg.hd, cfg.num_heads
    decoder = (dataclasses.replace(cfg, encoder_layers=0).param_count()
               + cfg.num_layers * (2 * d * h * e + d))
    dec = model_flops(cfg, ShapeCell("d", 100, b, "decode"), causal=True)
    assert dec == 2.0 * b * decoder + 4.0 * b * h * (100 + f) * e \
        * cfg.num_layers


def _norm_params(tree, key: str = "") -> int:
    if isinstance(tree, dict):
        return sum(_norm_params(v, k) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_norm_params(v, key) for v in tree)
    return tree.numel() if key.endswith("norm") else 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-1.7b",
                                  "deepseek-coder-33b", "internvl2-2b"])
def test_model_flops_against_flop_counter(arch):
    """The port's fp32 CPU forward (the kernels' plain versions) at a
    prompt of whole 64-row tiles, so no row is padded."""
    cfg = dataclasses.replace(get_smoke(arch), attn_impl="kernel",
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    b, s = 2, 2 * KV_TILE
    tokens = torch.randint(3, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        model.forward(params, tokens, cfg)
    uncounted = _norm_params(params)
    if not cfg.tie_embeddings:
        uncounted += cfg.vocab_size * cfg.d_model     # the gather
    want = model_flops(cfg, ShapeCell("p", s, b, "prefill"))
    assert counter.get_total_flops() == want - 2 * b * s * uncounted


def test_cell_roofline_on_synthetic_record(tmp_path):
    cell = ShapeCell("wave", 2048, 4, "prefill")
    rec = {"arch": "internlm2-1.8b", "cell": cell, "device_s": 0.1,
           "peak_memory_bytes": 10 ** 9}
    r = roofline.cell_roofline(rec)
    cfg = get_arch("internlm2-1.8b")
    mf = model_flops(cfg, cell, causal=True)
    mb = least_bytes(cfg, cell)["total"]
    assert r["mfu"] == mf / (0.1 * roofline.PEAK_BF16_FLOPS)
    assert r["roofline_share"] == max(mf / roofline.PEAK_BF16_FLOPS,
                                      mb / roofline.PEAK_BYTES_PER_S) / 0.1
    assert r["dominant"] == "compute"
    assert r["mfu"] == pytest.approx(r["roofline_share"], rel=1e-12)
    dec = roofline.cell_roofline({
        "arch": "deepseek-coder-33b", "layers": 10, "device_s": 0.01,
        "cell": {"name": "d", "seq_len": 2048, "global_batch": 1,
                 "kind": "decode"}, "peak_memory_bytes": 1})
    assert dec["dominant"] == "memory" and dec["layers"] == 10
    assert dec["roofline_share"] == dec["least_bytes"] / (
        0.01 * roofline.PEAK_BYTES_PER_S)
    # the records chip_smoke.py prints round-trip through the CLI
    log = tmp_path / "run.log"
    log.write_text("noise\n" + json.dumps({"phase": "roofline", **r})
                   + "\n{\"phase\": \"kernels\"}\n")
    out = tmp_path / "roofline.md"
    assert roofline.main([str(log), "--out", str(out)]) == 0
    rows = json.loads(out.with_suffix(".json").read_text())
    assert len(rows) == 1 and rows[0]["mfu"] == r["mfu"]
    assert "internlm2-1.8b" in out.read_text()


def _ref_rates(monkeypatch):
    monkeypatch.setattr(autotune, "TENSOR_FLOPS", ref_autotune.MXU_FLOPS)
    monkeypatch.setattr(autotune, "HBM_BW", ref_autotune.HBM_BW)
    monkeypatch.setattr(autotune, "CUDA_CORE_FLOPS", ref_autotune.VPU_FLOPS)


@pytest.mark.parametrize("method", ["mas_resident", "mas_streamed", "flash"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_itemsize", [None, 1])
def test_score_equals_reference_under_its_rates(monkeypatch, method, causal,
                                                kv_itemsize):
    _ref_rates(monkeypatch)
    for blk_q, blk_kv, n_q, n_kv, e in ((32, 64, 2048, 2048, 128),
                                        (8, 64, 1, 1500, 64),
                                        (16, 128, 300, 4096, 256)):
        kw = dict(b_h=64, n_q=n_q, n_kv=n_kv, e=e, itemsize=2,
                  causal=causal, kv_itemsize=kv_itemsize)
        assert autotune._score(method, blk_q, blk_kv, **kw) == \
            ref_autotune._score(method, blk_q, blk_kv, **kw)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3000), st.integers(1, 3000),
       st.sampled_from([8, 16, 32, 64, 128]),
       st.sampled_from([64, 128, 256]))
def test_causal_fraction_equals_reference(n_q, n_kv, blk_q, blk_kv):
    assert autotune._causal_fraction(n_q, n_kv, blk_q, blk_kv) == \
        ref_autotune._causal_fraction(n_q, n_kv, blk_q, blk_kv)


@pytest.mark.parametrize("n", [1, 100, 256, 2048, 4096, 8192])
@pytest.mark.parametrize("e,itemsize", [(64, 2), (128, 2), (128, 4)])
def test_tune_attention_routes_as_policy(n, e, itemsize):
    choice = autotune.tune_attention(b_h=64, n_q=n, n_kv=n, e=e,
                                     itemsize=itemsize, causal=True)
    decision = choose_attention_method(n_kv=n, e=e, itemsize=itemsize)
    route, bq = ops.resolve_method(n, n, e, itemsize)
    assert choice.method == decision.method == route
    assert choice.blk_kv == KV_TILE and choice.blk_q <= max(bq, 8)
    assert choice.est_seconds >= max(choice.mma_s, choice.hbm_s,
                                     choice.elementwise_s) > 0
    if route == "mas_streamed":
        # the fewest K/V re-reads: the tallest block the policy admits
        assert choice.blk_q == bq
