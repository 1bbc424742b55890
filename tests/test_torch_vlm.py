"""The port's vision-frontend slice (internvl2-2b) against the JAX package.

* The full-width config's fields and parameter count are the
  reference's (the stub frontend draws no parameters);
* ``forward`` logits with ``frontend_embeds`` (stub patch embeddings
  prepended to the token embeddings) at every one of the F + S positions,
  and a ``prefill`` + teacher-forced ``decode_step`` loop at positions
  F + i (as ``tests/test_arch_smoke.py`` runs it), against the JAX model
  at fp32, logits within 1e-4, for internvl2-smoke on the reference's
  Pallas kernels in interpret mode;
* ``prefill`` refuses F + S rows past the cache;
* the wave and the continuous engines serve internvl2-smoke text-only,
  as the reference's engines do, with the reference engines' tokens.

Inputs come from numpy seeds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.serving.engine import (
    ContinuousBatchingEngine as JaxContinuousEngine,
)
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.lifecycle import Request as JaxRequest
from repro_torch.configs import get_arch
from repro_torch.serving import (
    ContinuousBatchingEngine,
    PoolAuditor,
    Request,
    ServingEngine,
)
from test_torch_harness import (
    LOGITS_ATOL,
    assert_close,
    model_pair,
    prompts,
    rand,
)

ARCH = "internvl2-2b"
_FIELDS = ("name", "family", "num_layers", "d_model", "num_heads",
           "num_kv_heads", "hd", "d_ff", "vocab_size", "mlp", "rope",
           "causal", "qk_norm", "rope_theta", "tie_embeddings", "norm_eps",
           "frontend", "num_frontend_tokens", "encoder_layers")
# (prompt length, new tokens) of the engines' requests, text only
SPEC = [(5, 6), (9, 4), (5, 7), (3, 9), (12, 5)]
ENGINE = dict(max_len=32, batch_size=2)


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, seed=5, norm_std=2.0)


def _patches(cfg, batch: int, seed: int) -> np.ndarray:
    return rand(seed, (batch, cfg.num_frontend_tokens, cfg.d_model))


def test_full_width_config_matches_reference():
    mine, ref = get_arch(ARCH), jax_get_arch(ARCH)
    for field in _FIELDS:
        assert getattr(mine, field) == getattr(ref, field), field
    assert mine.attn_impl == "kernel"
    assert mine.param_count() == ref.param_count() == 1_699_598_336


@pytest.mark.parametrize("length", [1, 11])
def test_forward_logits_with_patches_match_reference(pair, length):
    p = pair
    toks = prompts(70 + length, 2, length, p.tcfg.vocab_size)
    patches = _patches(p.tcfg, 2, 71)
    want, _ = p.jmodel.forward(p.jparams, jnp.asarray(toks), p.jcfg,
                               frontend_embeds=jnp.asarray(patches))
    got, _ = p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg,
                              frontend_embeds=torch.from_numpy(patches))
    extra = p.tcfg.num_frontend_tokens
    assert got.shape == (2, extra + length, p.tcfg.vocab_size)
    assert_close(got, want, LOGITS_ATOL)


def test_prefill_and_decode_at_frontend_offset_match_reference(pair):
    """prefill(patches + t[:k]) then decode steps at positions F + i with
    the true next tokens: every step's logits against the reference's and
    against the full forward's row F + i."""
    p = pair
    b, s, k = 2, 12, 8
    extra = p.tcfg.num_frontend_tokens
    toks = prompts(72, b, s, p.tcfg.vocab_size)
    patches = _patches(p.tcfg, b, 73)
    full, _ = p.tmodel.forward(p.tparams, torch.from_numpy(toks), p.tcfg,
                               frontend_embeds=torch.from_numpy(patches))
    jl, jc = p.jmodel.prefill(p.jparams, p.jcfg, jnp.asarray(toks[:, :k]),
                              s + extra,
                              frontend_embeds=jnp.asarray(patches))
    tl, tc = p.tmodel.prefill(p.tparams, p.tcfg, torch.from_numpy(toks[:, :k]),
                              s + extra,
                              frontend_embeds=torch.from_numpy(patches))
    assert_close(tl, jl, LOGITS_ATOL)
    assert_close(tl[:, 0], full[:, extra + k - 1], LOGITS_ATOL)
    decode = jax.jit(lambda params, c, t, pos:
                     p.jmodel.decode_step(params, p.jcfg, t, c, pos))
    for i in range(k, s):
        tok = toks[:, i:i + 1]
        jl, jc = decode(p.jparams, jc, jnp.asarray(tok), jnp.int32(extra + i))
        tl, tc = p.tmodel.decode_step(p.tparams, p.tcfg,
                                      torch.from_numpy(tok), tc, extra + i)
        assert_close(tl, jl, LOGITS_ATOL)
        assert_close(tl[:, 0], full[:, extra + i], LOGITS_ATOL)


def test_prefill_counts_the_frontend_rows_against_the_cache(pair):
    p = pair
    extra = p.tcfg.num_frontend_tokens
    toks = torch.from_numpy(prompts(74, 1, 6, p.tcfg.vocab_size))
    patches = torch.from_numpy(_patches(p.tcfg, 1, 75))
    _, cache = p.tmodel.prefill(p.tparams, p.tcfg, toks, extra + 6,
                                frontend_embeds=patches)
    assert cache["layers"][0]["k"].shape[2] == extra + 6
    with pytest.raises(ValueError, match="exceeds"):
        p.tmodel.prefill(p.tparams, p.tcfg, toks, extra + 5,
                         frontend_embeds=patches)


def _requests(cls, vocab):
    return [cls(rid=i, prompt=prompts(76 + i, 1, n, vocab)[0],
                max_new_tokens=m, eos_id=-2)
            for i, (n, m) in enumerate(SPEC)]


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_engines_serve_text_only_with_reference_tokens(pair, engine):
    p = pair
    vocab = p.tcfg.vocab_size
    if engine == "wave":
        want = JaxServingEngine(p.jmodel, p.jparams, **ENGINE).serve(
            _requests(JaxRequest, vocab))
        got = ServingEngine(p.tmodel, p.tparams, device="cpu",
                            **ENGINE).serve(_requests(Request, vocab))
    else:
        kw = dict(ENGINE, page_size=4, chunk_size=8)
        want = JaxContinuousEngine(p.jmodel, p.jparams, **kw).serve(
            _requests(JaxRequest, vocab))
        eng = ContinuousBatchingEngine(p.tmodel, p.tparams, device="cpu",
                                       **kw)
        eng.auditor = PoolAuditor()
        got = eng.serve(_requests(Request, vocab))
    for rid, (_, m) in enumerate(SPEC):
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"{engine} rid {rid}")
        assert len(got[rid]) == m
    assert len({t for v in got.values() for t in v.tolist()}) > 5
