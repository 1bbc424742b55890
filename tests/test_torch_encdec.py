"""The port's encoder-decoder slice (whisper-large-v3) against the JAX
package.

* The full-width config's fields are the reference's; its parameter
  count is what the init draws, the reference's count plus the encoder's
  final norm (d_model) that it leaves out (ROADMAP C13), the reference's
  draw counted by ``jax.eval_shape`` of its init;
* ``params_from_jax`` maps the stacked encoder onto one dict a layer,
  each decoder layer's ``cross`` block and ``enc_final_norm``, and
  refuses a tree without a cross block or without the encoder;
* ``encode``, ``forward`` logits with ``encoder_out``, and a
  teacher-forced ``prefill`` + ``decode_step`` loop (as
  ``tests/test_arch_smoke.py`` runs it) against the JAX model at fp32,
  logits within 1e-4, for whisper-smoke with the reference on
  ``xla_full`` and on its Pallas kernels in interpret mode;
* an int8 self-attention cache keeps the cross memories at the compute
  dtype, equal to the reference's;
* the plain non-causal attention that a cross block and the encoder run
  (``ops.attention(causal=False)``, one query row and 40, a kv tail
  under ``kv_len``, head dim 64) against the reference's
  ``mas_attention_flat`` in interpret mode;
* both serving engines refuse the encoder-decoder when they are built.

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
from repro.kernels import mas_attention as jmas
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_arch, get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models import common as tcommon
from repro_torch.models.api import build_model
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine
from repro_torch.weights import params_from_jax
from test_torch_harness import (
    DTYPES,
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

ARCH = "whisper-large-v3"
# the int8 self-attention cache: a K/V value rounds to the neighbouring
# int8 step in one package where the projections' fp32 sums differ, and
# such a flip moves a logit by ~1e-3 (the hybrid's int8 tests, PR 25)
INT8_LOGITS_ATOL = 2e-2
# the fields the port's ArchConfig shares with the reference's
_FIELDS = ("name", "family", "num_layers", "encoder_layers", "d_model",
           "num_heads", "num_kv_heads", "hd", "d_ff", "vocab_size", "mlp",
           "rope", "causal", "qk_norm", "tie_embeddings", "norm_eps",
           "frontend", "num_frontend_tokens", "layer_kinds")


@pytest.fixture(scope="module", params=["xla_full", "pallas"])
def pair(request):
    return model_pair(ARCH, seed=4, jax_impl=request.param, norm_std=2.0)


def _frames(cfg, batch: int = 2, seed: int = 50) -> np.ndarray:
    return rand(seed, (batch, cfg.num_frontend_tokens, cfg.d_model))


def _drawn(tree) -> int:
    return sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))


def test_full_width_config_matches_reference_and_counts_its_draw():
    """C13: the reference counts the encoder's layers and the decoder's
    cross blocks, but not ``enc_final_norm``, which its init draws."""
    mine, ref = get_arch(ARCH), jax_get_arch(ARCH)
    for field in _FIELDS:
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.attn_impl == "kernel"
    drawn = _drawn(jax.eval_shape(
        lambda: jax_build_model(ref).init(jax.random.PRNGKey(0))))
    assert mine.param_count() == drawn == ref.param_count() + mine.d_model
    assert mine.param_count() == 1_534_602_240
    smoke, jsmoke = get_smoke(ARCH), jax_get_smoke(ARCH)
    params = build_model(smoke).init(seed=0, device="cpu")
    ours = sum(t.numel() for t in jax.tree.leaves(params))
    jdrawn = _drawn(jax.eval_shape(
        lambda: jax_build_model(jsmoke).init(jax.random.PRNGKey(0))))
    assert ours == jdrawn == smoke.param_count() == 197_376
    assert smoke.param_count() == jsmoke.param_count() + smoke.d_model
    assert sorted(params["layers"][0]) == ["attn", "cross", "ffn"]
    assert sorted(params["layers"][0]["cross"]) == ["norm", "wk", "wo", "wq",
                                                    "wv"]
    assert [sorted(layer) for layer in params["encoder"]] == [
        ["attn", "ffn"]] * smoke.encoder_layers
    assert "w_gate" not in params["encoder"][0]["ffn"]


def test_params_from_jax_maps_encoder_cross_and_final_norm():
    jcfg, tcfg = jax_get_smoke(ARCH), get_smoke(ARCH)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(2)))
    params = params_from_jax(tree, tcfg, device="cpu")
    for i, layer in enumerate(params["encoder"]):
        for blk, sub in tree["encoder"].items():
            for key, arr in sub.items():
                np.testing.assert_array_equal(layer[blk][key].numpy(), arr[i])
    for i, layer in enumerate(params["layers"]):
        for key, arr in tree["units"]["b0"]["cross"].items():
            np.testing.assert_array_equal(layer["cross"][key].numpy(),
                                          arr[i])
    np.testing.assert_array_equal(params["enc_final_norm"].numpy(),
                                  tree["enc_final_norm"])
    no_cross = dict(tree, units={"b0": {k: v for k, v in
                                        tree["units"]["b0"].items()
                                        if k != "cross"}})
    with pytest.raises(ValueError, match="cross"):
        params_from_jax(no_cross, tcfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        params_from_jax({k: v for k, v in tree.items() if k != "encoder"},
                        tcfg, device="cpu")


def test_sinusoidal_positions_match_reference():
    pos = np.array([0, 1, 7, 447, 1499])
    want = jcommon.sinusoidal_positions(jnp.asarray(pos), 64)
    got = tcommon.sinusoidal_positions(torch.from_numpy(pos), 64)
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-5)


def test_encode_and_forward_logits_match_reference(pair):
    p = pair
    frames = _frames(p.tcfg)
    jenc = p.jmodel.encode(p.jparams, jnp.asarray(frames))
    tenc = p.tmodel.encode(p.tparams, torch.from_numpy(frames))
    assert tenc.shape == (2, p.tcfg.num_frontend_tokens, p.tcfg.d_model)
    assert_close(tenc, jenc, LOGITS_ATOL)
    toks = prompts(51, 2, 9, p.tcfg.vocab_size)
    jl, _ = p.jmodel.forward(p.jparams, jnp.asarray(toks), p.jcfg,
                             encoder_out=jenc)
    tl, aux = p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg,
                               encoder_out=tenc)
    assert tl.shape == (2, 9, p.tcfg.vocab_size)
    assert_close(tl, jl, LOGITS_ATOL)
    assert float(aux) == 0.0
    with pytest.raises(ValueError, match="encoder_out"):
        p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_prefill_and_teacher_forced_decode_match_reference(pair, kv_dtype):
    """prefill(t[:k]) then decode steps at positions k.. with the true
    next tokens: every step's logits against the reference's, and (fp32
    cache) against the full forward's rows. The int8 cache keeps the
    cross memories at the compute dtype, equal to the reference's."""
    p = pair
    b, s, k = 2, 12, 7
    toks = prompts(52, b, s, p.tcfg.vocab_size)
    frames = _frames(p.tcfg, b, seed=53)
    jenc = p.jmodel.encode(p.jparams, jnp.asarray(frames))
    tenc = p.tmodel.encode(p.tparams, torch.from_numpy(frames))
    jdt = jnp.int8 if kv_dtype else None
    jl, jc = p.jmodel.prefill(p.jparams, p.jcfg, jnp.asarray(toks[:, :k]),
                              s, encoder_out=jenc, kv_dtype=jdt)
    tl, tc = p.tmodel.prefill(p.tparams, p.tcfg, torch.from_numpy(toks[:, :k]),
                              s, encoder_out=tenc, kv_dtype=kv_dtype)
    atol = LOGITS_ATOL if kv_dtype is None else INT8_LOGITS_ATOL
    assert_close(tl, jl, atol)
    for i, blk in enumerate(tc["layers"]):
        assert blk["mem_k"].dtype == blk["mem_v"].dtype == torch.float32
        assert blk["mem_k"].shape == (b, p.tcfg.num_kv_heads,
                                      p.tcfg.num_frontend_tokens, p.tcfg.hd)
        assert blk["k"].dtype == (torch.int8 if kv_dtype else torch.float32)
        for key in ("mem_k", "mem_v"):
            assert_close(blk[key], jc["units"]["b0"][key][i], LOGITS_ATOL)
    decode = jax.jit(lambda params, c, t, pos:
                     p.jmodel.decode_step(params, p.jcfg, t, c, pos))
    full = None
    if kv_dtype is None:
        full, _ = p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg,
                                   encoder_out=tenc)
        assert_close(tl[:, 0], full[:, k - 1], LOGITS_ATOL)
    for i in range(k, s):
        tok = toks[:, i:i + 1]
        jl, jc = decode(p.jparams, jc, jnp.asarray(tok), jnp.int32(i))
        tl, tc = p.tmodel.decode_step(p.tparams, p.tcfg,
                                      torch.from_numpy(tok), tc, i)
        assert_close(tl, jl, atol)
        if full is not None:
            assert_close(tl[:, 0], full[:, i], LOGITS_ATOL)


def test_make_cache_holds_cross_memories_at_the_compute_dtype():
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=torch.bfloat16)
    cache = build_model(cfg).make_cache(3, 20, 16, device="cpu",
                                        kv_dtype="int8")
    blk = cache["layers"][0]
    assert sorted(blk) == ["k", "k_scale", "mem_k", "mem_v", "v", "v_scale"]
    assert blk["k"].shape == (3, 4, 20, 16) and blk["k"].dtype == torch.int8
    assert blk["mem_k"].shape == (3, 4, 16, 16)
    assert blk["mem_k"].dtype == blk["mem_v"].dtype == torch.bfloat16


@pytest.mark.parametrize("kv_resident", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq", [1, 40])
def test_noncausal_attention_with_a_kv_tail_matches_pallas(nq, dtype_name,
                                                           kv_resident):
    """What a cross block runs: nq query rows (one: a decode step) over 200
    memory rows, padded to whole tiles and masked at kv_len 200, at head
    dim 64; the reference's B1 / B2 in interpret mode on its own padding
    (Q rows to 8, KV rows to 128)."""
    jdt, tdt = DTYPES[dtype_name]
    b, h, nkv, e = 2, 3, 200, 64
    q, k, v = (rand(60, (b, h, nq, e)), rand(61, (b, h, nkv, e)),
               rand(62, (b, h, nkv, e)))
    got = tops.attention(to_torch(q, tdt), to_torch(k, tdt), to_torch(v, tdt),
                         causal=False)
    blk_q = -(-nq // 8) * 8

    def flat(x, rows):
        x = x.reshape(b * h, x.shape[2], e)
        return np.pad(x, ((0, 0), (0, rows - x.shape[1]), (0, 0)))

    want = jmas.mas_attention_flat(
        to_jax(flat(q, blk_q), jdt), to_jax(flat(k, 256), jdt),
        to_jax(flat(v, 256), jdt), blk_q=blk_q, blk_kv=128, causal=False,
        kv_resident=kv_resident, kv_len=nkv, interpret=True)
    want = np.asarray(as_numpy(want))[:, :nq].reshape(b, h, nq, e)
    assert got.shape == (b, h, nq, e)
    assert_close(got, want, atol_for(dtype_name))


def test_both_engines_refuse_the_encoder_decoder():
    cfg = get_smoke(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        ServingEngine(model, params, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        ContinuousBatchingEngine(model, params, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        model.make_cache(2, 32, device="cpu", cache_layout="paged")
    assert model.encode is not None
    assert build_model(get_smoke("internlm2-1.8b")).encode is None
