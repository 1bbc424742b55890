"""The port's dense decoder against the JAX model.

Both packages run the reference's fp32 weights (``params_from_jax``); the
reference runs ``attn_impl="pallas"`` (its Pallas kernels in interpret
mode), the port ``attn_impl="kernel"`` (its kernels' plain versions on
the CPU). Forward, prefill and every decode step's logits must agree to
atol 1e-4: random-init greedy output tends to repeat one token, so the
logits are compared at every step, not only the tokens.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro_torch.configs import get_arch, get_smoke
from repro_torch.models import common as tcommon
from repro_torch.models.api import build_model
from test_torch_harness import (
    LOGITS_ATOL,
    as_numpy,
    assert_close,
    model_pair,
    prompts,
    rand,
    to_jax,
    to_torch,
)

ARCHS = ["internlm2-1.8b", "qwen3-1.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param)


@pytest.mark.parametrize("length", [1, 9, 40])
def test_forward_logits_match_reference(pair, length):
    toks = prompts(length, 2, length, pair.tcfg.vocab_size)
    want, _ = pair.jmodel.forward(pair.jparams, jnp.asarray(toks), pair.jcfg)
    got, aux = pair.tmodel.forward(pair.tparams, torch.from_numpy(toks),
                                   pair.tcfg)
    assert got.shape == tuple(want.shape) and aux == 0.0
    assert_close(got, want, LOGITS_ATOL)


def test_prefill_and_decode_logits_match_reference_every_step(pair):
    p = pair
    toks = prompts(7, 2, 13, p.tcfg.vocab_size)
    max_len = 32
    jl, jcache = p.jmodel.prefill(p.jparams, p.jcfg, jnp.asarray(toks),
                                  max_len)
    tl, tcache = p.tmodel.prefill(p.tparams, p.tcfg, torch.from_numpy(toks),
                                  max_len)
    assert_close(tl, jl, LOGITS_ATOL)
    for layer, blk in enumerate(tcache["layers"]):
        assert_close(blk["k"], jcache["units"]["b0"]["k"][layer], 1e-5)
    decode = jax.jit(lambda params, c, t, pos:
                     p.jmodel.decode_step(params, p.jcfg, t, c, pos))
    tok = np.argmax(as_numpy(jl)[:, -1], -1)[:, None].astype(np.int32)
    for step in range(6):
        pos = toks.shape[1] + step
        jl, jcache = decode(p.jparams, jcache, jnp.asarray(tok),
                            jnp.int32(pos))
        tl, tcache = p.tmodel.decode_step(p.tparams, p.tcfg,
                                          torch.from_numpy(tok), tcache, pos)
        assert_close(tl, jl, LOGITS_ATOL)
        want_tok = np.argmax(as_numpy(jl)[:, -1], -1)
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1], -1).numpy(), want_tok)
        tok = want_tok[:, None].astype(np.int32)


def test_kernel_and_plain_attention_agree(pair):
    """The two attention backends of the port give the same logits."""
    plain_cfg = dataclasses.replace(pair.tcfg, attn_impl="plain")
    toks = torch.from_numpy(prompts(3, 2, 21, pair.tcfg.vocab_size))
    got, _ = pair.tmodel.forward(pair.tparams, toks, pair.tcfg)
    want, _ = pair.tmodel.forward(pair.tparams, toks, plain_cfg)
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("shape,theta", [((2, 3, 5, 16), 1e4),
                                         ((1, 2, 7, 8), 1e6)])
def test_rope_and_rms_norm_match_reference(shape, theta):
    x = rand(0, shape)
    pos = np.arange(shape[-2]) + 3
    want = jcommon.apply_rope(to_jax(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(to_torch(x), torch.from_numpy(pos), theta)
    assert_close(got, want, 1e-6)
    scale = rand(1, shape[-1:])
    want = jcommon.rms_norm(to_jax(x), to_jax(scale), 1e-6)
    got = tcommon.rms_norm(to_torch(x), to_torch(scale), 1e-6)
    assert_close(got, want, 1e-6)


def test_bf16_forward_tracks_reference():
    """In bf16 compute the two packages round at the same points."""
    p = model_pair("internlm2-1.8b")
    jcfg = dataclasses.replace(p.jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(p.tcfg, compute_dtype=torch.bfloat16)
    toks = prompts(5, 2, 17, tcfg.vocab_size)
    want, _ = p.jmodel.forward(p.jparams, jnp.asarray(toks), jcfg)
    got, _ = p.tmodel.forward(p.tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(as_numpy(want)).max())
    assert float(np.abs(as_numpy(got) - as_numpy(want)).max()) < 0.05 * scale


def test_seeded_init_shapes_and_determinism():
    cfg = get_smoke("qwen3-1.7b")
    model = build_model(cfg)
    a = model.init(seed=3, device="cpu")
    b = model.init(seed=3, device="cpu")
    c = model.init(seed=4, device="cpu")
    n = a["embed"].numel() + a["final_norm"].numel() + sum(
        t.numel() for layer in a["layers"] for blk in layer.values()
        for t in blk.values())
    assert n == cfg.param_count()
    assert torch.equal(a["layers"][1]["attn"]["wq"],
                       b["layers"][1]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["layers"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2 * cfg.d_model ** -0.5 + 1e-6
    assert a["layers"][0]["attn"]["q_norm"].shape == (cfg.hd,)
    bf = model.init(seed=3, device="cpu", dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def test_full_width_config_matches_reference():
    from repro.configs import get_arch as jax_get_arch

    for arch in ARCHS:
        mine, ref = get_arch(arch), jax_get_arch(arch)
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "hd", "qk_norm", "rope_theta",
                      "norm_eps"):
            assert getattr(mine, field) == getattr(ref, field), (arch, field)
        assert mine.param_count() == ref.param_count()
        assert mine.attn_impl == "kernel"
