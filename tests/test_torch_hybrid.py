"""The port's hybrid slice (recurrentgemma-9b) against the JAX package.

* The config: 26 RG-LRU and 12 attention layers in the reference's
  order, and the parameter count of what the init draws, which is the
  reference's count plus 2w² - 2w a RG-LRU layer (ROADMAP C12);
* ``params_from_jax`` maps the reference's units ``b0``-``b2`` (stacked
  over the units) and its tail ``t0``, ``t1`` onto the port's layers in
  stack order;
* logits of the whole stack (forward, prefill, teacher-forced decode)
  against the JAX model at fp32, atol 1e-4, for the smoke (head dim 16,
  window 32) and a config at head dim 256 (d_model 512, 2/1 heads of
  256, window 64, 5 layers), the reference on its Pallas kernels in
  interpret mode; prompts longer than the window whose length is not a
  multiple of it, and decode past the ring's next wrap;
* the ring caches (K/V, and their per-row scales on int8 caches) and the
  RG-LRU states equal the reference's slot by slot after the prefill and
  after the decode steps;
* the wave ``ServingEngine``'s tokens against the JAX engine's, on
  fp32 and int8 caches, prompts longer than the window;
* ``ContinuousBatchingEngine`` and the paged cache refuse the hybrid, as
  the reference's paged cache does;
* the plain versions of B3 and B4 at head dim 256 (B3 windowed, B4 at GQA
  group 16 on fp32, bf16 and int8 caches) against the Pallas kernels in
  interpret mode, and the plain B3's skipping of Q blocks outside the
  window against the dense oracle.

Inputs come from numpy seeds.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import (
    ContinuousBatchingEngine as JaxContinuousEngine,
)
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.configs import get_arch, get_smoke
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.api import build_model
from repro_torch.serving import (
    ContinuousBatchingEngine,
    Request,
    ServingEngine,
)
from repro_torch.weights import params_from_jax
from test_torch_harness import (
    DTYPES,
    FP32_ATOL,
    LOGITS_ATOL,
    as_numpy,
    assert_close,
    atol_for,
    model_pair,
    prompts,
    rand,
    to_jax,
    to_torch,
)

ARCH = "recurrentgemma-9b"
# a config at the full model's head dim: MQA over two query heads of 256
HD256 = dict(d_model=512, num_heads=2, num_kv_heads=1, head_dim=256,
             d_ff=256, lru_width=512, window=64)
CONFIGS = {"smoke": {}, "hd256": HD256}
# (prompt length, decode steps) of each config: the prompt past the
# window and not a multiple of it, the steps past the ring's next wrap
RING = {"smoke": (60, 6), "hd256": (120, 10)}
# fp32 K/V and states against the reference's after the prefill: the
# projections' sums in another order, relative to the value (hd256's K
# rows reach ~10); after the decode steps, which carry each step's fp32
# differences through the residual stream (the random norm scales of std
# 2 amplify them): still far below a slot out of place, which is O(1)
STATE_RTOL = 1e-5
DECODED_STATE_TOL = 1e-3
# decode on int8 caches: a few K/V values round to the neighbouring int8
# step in one package (3 of hd256's 32768 ring values), and one such value
# moves a hd256 logit (largest ~9) by up to 8e-3, and the states of the
# layers after it by up to 4e-3
INT8_DECODE_ATOL = 2e-2


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return request.param, model_pair(ARCH, seed=3, norm_std=2.0,
                                     **CONFIGS[request.param])


def _reference_leaves(tree) -> int:
    return sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))


def test_full_width_hybrid_config_matches_reference():
    """The reference's layer order and widths; the parameters the init
    draws, which the reference's ``param_count`` undercounts by 2w² - 2w
    a RG-LRU layer (C12): it leaves out ``w_i`` and ``w_r`` and counts 3w
    for the one ``lam`` of w."""
    mine, ref = get_arch(ARCH), jax_get_arch(ARCH)
    assert mine.layer_kinds == ref.layer_kinds
    assert mine.layer_kinds.count("rec") == 26
    assert mine.layer_kinds.count("attn") == 12
    assert mine.layer_kinds[-2:] == ("rec", "rec")
    assert mine.attn_window == ref.window == 2048
    assert (mine.hd, mine.num_heads, mine.num_kv_heads) == (256, 16, 1)
    w = mine.lru_width
    n_rec = mine.layer_kinds.count("rec")
    assert mine.param_count() == ref.param_count() + n_rec * (2 * w * w
                                                              - 2 * w)
    assert mine.param_count() == 7_483_486_208
    assert ref.param_count() == 6_611_283_968
    # the smoke: what both inits draw
    smoke, jsmoke = get_smoke(ARCH), jax_get_smoke(ARCH)
    drawn = _reference_leaves(jax_build_model(jsmoke).init(
        jax.random.PRNGKey(0)))
    params = build_model(smoke).init(seed=0, device="cpu")
    ours = sum(t.numel() for layer in params["layers"]
               for blk in layer.values() for t in blk.values())
    ours += params["embed"].numel() + params["final_norm"].numel()
    assert drawn == ours == smoke.param_count() == 208_832
    w = smoke.lru_width
    assert smoke.param_count() == jsmoke.param_count() + 4 * (2 * w * w
                                                              - 2 * w)
    assert [sorted(layer) for layer in params["layers"]] == [
        ["ffn", "rec"], ["ffn", "rec"], ["attn", "ffn"], ["ffn", "rec"],
        ["ffn", "rec"]]
    assert "w_gate" not in params["layers"][0]["ffn"]


def test_params_from_jax_maps_units_and_tail_in_stack_order():
    """Two units of (rec, rec, attn) and the (rec, rec) tail: unit u's
    block j is layer 3u + j, tail block j is layer 6 + j."""
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), num_layers=8)
    tcfg = dataclasses.replace(get_smoke(ARCH), num_layers=8)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(1)))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert len(params["layers"]) == 8
    for u in range(2):
        for j in range(3):
            blk = tree["units"][f"b{j}"]
            layer = params["layers"][3 * u + j]
            for name, sub in blk.items():
                for key, arr in sub.items():
                    np.testing.assert_array_equal(layer[name][key].numpy(),
                                                  arr[u])
    for j in range(2):
        for name, sub in tree["tail"][f"t{j}"].items():
            for key, arr in sub.items():
                np.testing.assert_array_equal(
                    params["layers"][6 + j][name][key].numpy(), arr)
    with pytest.raises(ValueError, match="tail"):
        params_from_jax({k: v for k, v in tree.items() if k != "tail"},
                        tcfg, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tree, dataclasses.replace(tcfg, num_layers=11),
                        device="cpu")


def test_forward_logits_match_reference(pair):
    name, p = pair
    toks = prompts(11, 2, RING[name][0], p.tcfg.vocab_size)
    jl, _ = p.jmodel.forward(p.jparams, jnp.asarray(toks), p.jcfg)
    tl, aux = p.tmodel.forward(p.tparams, torch.from_numpy(toks).long(),
                               p.tcfg)
    assert_close(tl, jl, LOGITS_ATOL)
    assert float(aux) == 0.0


def _ring_states_match(tcache, jcache, cfg, quantized: bool,
                       atol: float = FP32_ATOL,
                       rtol: float = STATE_RTOL) -> None:
    """Every layer's cache entry against the reference's: unit u's block j
    is layer 3u + j, the tail's block j follows."""
    n_units = (cfg.num_layers - len(cfg.pattern_tail)) // 3
    ref_blocks = [(jcache["units"][f"b{j}"], u) for u in range(n_units)
                  for j in range(3)]
    ref_blocks += [(jcache["tail"][f"t{j}"], None)
                   for j in range(len(cfg.pattern_tail))]
    for layer, (tblk, (jblk, u)) in enumerate(zip(tcache["layers"],
                                                  ref_blocks, strict=True)):
        def ref(key):
            return np.asarray(jblk[key] if u is None else jblk[key][u])

        assert set(tblk) == set(jblk), layer

        def close(got, key):
            np.testing.assert_allclose(as_numpy(got), ref(key), atol=atol,
                                       rtol=rtol,
                                       err_msg=f"layer {layer} {key}")

        if "rnn" in tblk:
            close(tblk["conv"], "conv")
            close(tblk["rnn"], "rnn")
            continue
        assert tuple(tblk["k"].shape) == ref("k").shape
        for which in ("k", "v"):
            if not quantized:
                close(tblk[which], which)
                continue
            assert tblk[which].dtype == torch.int8
            close(tblk[f"{which}_scale"], f"{which}_scale")
            got = tcommon.dequantize_q8(tblk[which], tblk[f"{which}_scale"],
                                        -1)
            want = np.asarray(jcommon.dequantize_q8(
                ref(which), ref(f"{which}_scale"), -1))
            # one int8 step where the projections round apart
            np.testing.assert_allclose(
                got.numpy(), want,
                atol=float(tblk[f"{which}_scale"].max()) + 1e-6)
            same = (tblk[which].numpy() == ref(which)).mean()
            assert same > 0.999, (layer, which, same)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_and_decode_across_the_ring_wrap_match_reference(pair,
                                                                 kv_dtype):
    """A prompt longer than the window (s % window != 0: the prefill rolls
    it into the ring), then teacher-forced decode steps past the ring's
    next wrap: logits at every step, and the rings and states slot by
    slot after the prefill and after the last step."""
    name, p = pair
    s, steps = RING[name]
    max_len = s + steps + 8
    window = p.tcfg.window
    assert s > window and s % window and s + steps > 2 * window
    toks = prompts(12, 2, s, p.tcfg.vocab_size)
    jdt = jnp.int8 if kv_dtype else None
    jl, jc = p.jmodel.prefill(p.jparams, p.jcfg, jnp.asarray(toks), max_len,
                              kv_dtype=jdt)
    tl, tc = p.tmodel.prefill(p.tparams, p.tcfg,
                              torch.from_numpy(toks).long(), max_len,
                              kv_dtype=kv_dtype)
    assert_close(tl, jl, LOGITS_ATOL)
    _ring_states_match(tc, jc, p.tcfg, kv_dtype is not None)
    assert tc["layers"][2]["k"].shape[2] == window    # the ring, not max_len
    cont = prompts(13, 2, steps, p.tcfg.vocab_size)
    for i in range(steps):
        token = cont[:, i:i + 1]
        jl, jc = p.jmodel.decode_step(p.jparams, p.jcfg, jnp.asarray(token),
                                      jc, jnp.int32(s + i))
        tl, tc = p.tmodel.decode_step(p.tparams, p.tcfg,
                                      torch.from_numpy(token).long(), tc,
                                      s + i)
        assert_close(tl, jl, LOGITS_ATOL if kv_dtype is None
                     else INT8_DECODE_ATOL)
    tol = DECODED_STATE_TOL if kv_dtype is None else INT8_DECODE_ATOL
    _ring_states_match(tc, jc, p.tcfg, kv_dtype is not None, atol=tol,
                       rtol=tol)
    if kv_dtype is None:
        # decode against the ring is the full forward's last rows
        full = np.concatenate([toks, cont], axis=1)
        fl, _ = p.tmodel.forward(p.tparams, torch.from_numpy(full).long(),
                                 p.tcfg)
        assert_close(tl[:, -1], fl[:, -1], LOGITS_ATOL)


def _requests(cls, vocab, spec, seed):
    return [cls(rid=i, prompt=prompts(seed + i, 1, n, vocab)[0],
                max_new_tokens=m, eos_id=-2)
            for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_wave_engine_matches_reference_tokens(pair, kv_dtype):
    """Prompts past the window in two buckets, one wave padded with a
    dummy row; the decode runs past the ring's next wrap."""
    name, p = pair
    window = p.tcfg.window
    spec = [(window + 9, window + 4), (window + 9, 6),
            (window + 13, window - 10)]
    max_len = 3 * window
    vocab = p.tcfg.vocab_size
    want = JaxServingEngine(p.jmodel, p.jparams, max_len=max_len,
                            batch_size=2, kv_dtype=kv_dtype).serve(
        _requests(JaxRequest, vocab, spec, 70))
    eng = ServingEngine(p.tmodel, p.tparams, max_len=max_len, batch_size=2,
                        kv_dtype=kv_dtype, device="cpu")
    got = eng.serve(_requests(Request, vocab, spec, 70))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"{name} rid {rid}")
        assert len(got[rid]) == spec[rid][1]
    assert len({t for v in got.values() for t in v.tolist()}) > 5


def test_continuous_engine_refuses_the_hybrid():
    p = model_pair(ARCH, seed=0)
    reqs = _requests(JaxRequest, p.tcfg.vocab_size, [(8, 2)], 80)
    with pytest.raises(NotImplementedError):
        JaxContinuousEngine(p.jmodel, p.jparams, max_len=64,
                            batch_size=2).serve(reqs)
    with pytest.raises(NotImplementedError, match="paged"):
        ContinuousBatchingEngine(p.tmodel, p.tparams, max_len=64,
                                 batch_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        p.tmodel.make_cache(2, 64, device="cpu", cache_layout="paged")
    cache = p.tmodel.make_cache(2, 64, device="cpu", kv_dtype="int8")
    assert [sorted(blk) for blk in cache["layers"]][:3] == [
        ["conv", "rnn"], ["conv", "rnn"], ["k", "k_scale", "v", "v_scale"]]
    assert cache["layers"][2]["k"].shape == (2, 1, 32, 16)
    assert cache["layers"][0]["rnn"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the plain versions of B3 and B4 at head dim 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,window", [(200, 64), (130, 100)])
def test_flash_plain_at_head_dim_256_matches_pallas(dtype_name, nq, window):
    """B3 windowed at E 256, MQA over 4 query heads (the hybrid's is 16),
    through ``ops.attention`` as the model calls it: a ragged length (KV
    padded under kv_len) and windows that skip whole tiles."""
    jdt, tdt = DTYPES[dtype_name]
    q, k, v = (rand(20, (1, 4, nq, 256)), rand(21, (1, 1, nq, 256)),
               rand(22, (1, 1, nq, 256)))
    want = jops.attention(to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt),
                          causal=True, window=window, method="flash",
                          interpret=True)
    got = tops.attention(to_torch(q, tdt), to_torch(k, tdt),
                         to_torch(v, tdt), causal=True, window=window)
    assert tops.resolve_method(nq, nq, 256, 2, window=window) == ("flash",
                                                                  64)
    assert_close(got, want, atol_for(dtype_name))


@pytest.mark.parametrize("q_offset,kv_len", [(0, None), (100, 430)])
def test_flash_plain_skips_only_blocks_outside_the_window(q_offset, kv_len):
    """The plain B3 computes a tile only for the Q blocks that run it; the
    result is the dense oracle's, with a window, a q_offset and a kv_len
    tail (long enough that every row sees a key: the oracle averages a row
    that sees none, the kernel writes zeros)."""
    q, k, v = rand(30, (2, 384, 256)), rand(31, (1, 448, 256)), \
        rand(32, (1, 448, 256))
    got = tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        blk_q=64, blk_kv=64, causal=True, window=70, q_offset=q_offset,
        kv_len=kv_len)
    n = 448 if kv_len is None else kv_len
    want = tref.attention(torch.from_numpy(q)[None], torch.from_numpy(k)[None],
                          torch.from_numpy(v)[None], window=70,
                          q_offset=q_offset, kv_len=n)[0]
    assert_close(got, want, FP32_ATOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 70, 256])
def test_decode_plain_at_head_dim_256_group_16_matches_pallas(
        quantized, dtype_name, kv_len):
    """B4 at E 256 and G 16 (one kv head), bf16 or fp32 q on caches of its
    dtype or int8 with per-row scales, through ``ops.decode_attention``,
    and the plain version at the split of the tensor-core form."""
    jdt, tdt = DTYPES[dtype_name]
    b, s_len = 2, 256
    q = rand(40, (b, 16, 256))
    k, v = rand(41, (b, 1, s_len, 256), 2.0), rand(42, (b, 1, s_len, 256), 2.0)
    sc, jsc = {}, {}
    if quantized:
        (k, ks), (v, vs) = (tcommon.quantize_q8(torch.from_numpy(x), -1)
                            for x in (k, v))
        k, v, ks, vs = (x.numpy() for x in (k, v, ks, vs))
        sc = {"k_scale": torch.from_numpy(ks), "v_scale": torch.from_numpy(vs)}
        jsc = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        jk, jv, tk, tv = (jnp.asarray(k), jnp.asarray(v),
                          torch.from_numpy(k), torch.from_numpy(v))
    else:
        jk, jv = to_jax(k, jdt), to_jax(v, jdt)
        tk, tv = to_torch(k, tdt), to_torch(v, tdt)
    want = jops.decode_attention(to_jax(q, jdt), jk, jv, kv_len,
                                 interpret=True, **jsc)
    got = tops.decode_attention(to_torch(q, tdt), tk, tv, kv_len, **sc)
    assert_close(got, want, atol_for(dtype_name))
    n_split, tps = tdec.decode_split_plan(torch.bfloat16, b, kv_len)
    flat = {key: t.view(b, s_len) for key, t in sc.items()}
    short = tdec.decode_attention_plain(
        to_torch(q, tdt), tk.view(b, s_len, 256), tv.view(b, s_len, 256),
        torch.full((b,), kv_len), n_split=n_split, tiles_per_split=tps,
        **flat)
    assert_close(short, want, atol_for(dtype_name))
