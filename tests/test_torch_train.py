"""The port's training loss and its gradients against the JAX package.

* ``Model.loss_fn`` and its gradients (``loss.backward()``) against
  ``jax.value_and_grad`` of the reference's ``Model.loss_fn`` at fp32
  compute, for internlm2, deepseek-moe, mamba2, recurrentgemma (window
  cut to 12 so the window's mask cuts the 30-token rows), internvl2 and
  whisper at smoke size, from the reference's init: the port's
  ``"plain"`` against the reference's ``"xla_full"``, and the port's
  ``"chunked"`` (chunks of 8 rows over 30 tokens, so the last chunk is
  padded; remat on) against the reference's ``"xla"`` at the same chunk.
  The loss within 1e-5 relative, each gradient leaf within 1e-4 of its
  norm (the L2 norm of the difference against the reference leaf's);
* ``"chunked"`` with and without ``remat`` gives the same gradients
  (1e-6 of each leaf's norm), and ``"chunked"`` attention itself equals
  the plain oracle in its forward, with ``q_offset`` too;
* the kernels' wrappers in ``kernels/ops.py`` refuse a call that
  autograd would record, on the CPU as on the card, and run under
  ``torch.no_grad()``: a ``"kernel"`` model refuses ``loss.backward``'s
  forward, and serves under ``no_grad``;
* recurrentgemma-smoke backpropagates (``rglru.affine_scan`` and the
  carried state build new tensors), and the out-of-place scan equals the
  in-place one it replaced bit for bit.

Inputs come from numpy seeds; JAX stays on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import rglru as trglru
from repro_torch.models.api import build_model
from repro_torch.tree import leaves_with_paths, tree_map
from repro_torch.weights import params_from_jax
from test_torch_harness import model_pair, rand, span, to_torch

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4      # each leaf: |g - g_ref| <= GRAD_RTOL |g_ref| (L2)
REMAT_RTOL = 1e-6
SEQ = 30
BATCH = 2
CHUNK = 8

ARCHS = {
    "internlm2-1.8b": {},
    "deepseek-moe-16b": {},
    "mamba2-130m": {},
    "recurrentgemma-9b": {"window": 12},
    "internvl2-2b": {},
    "whisper-large-v3": {},
}


def lm_batch(cfg, seed: int = 0, batch: int = BATCH,
             seq: int = SEQ) -> dict:
    """Tokens, next-token labels (the last and a few random ones masked
    with -1) and, for a frontend, stub features, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, size=(batch, seq))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[rng.random(labels.shape) < 0.1] = -1
    out = {"tokens": tokens.astype(np.int32),
           "labels": labels.astype(np.int32)}
    if cfg.frontend:
        out["frontend"] = rng.standard_normal(
            (batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss_and_grads(model, params, batch: dict):
    """(loss, grads tree) of the port's ``loss_fn`` by ``backward``."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    loss = model.loss_fn(params, torch_batch(batch))
    loss.backward()
    return float(loss.detach()), tree_map(lambda p: p.grad, params)


def assert_leaves_close(got, want, rtol: float) -> None:
    """Every leaf of ``got`` within ``rtol`` of its ``want`` leaf's L2
    norm (the difference's L2 norm)."""
    want = dict(leaves_with_paths(want))
    got = dict(leaves_with_paths(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(torch.linalg.vector_norm(got[path].double() - w.double()))
        norm = float(torch.linalg.vector_norm(w.double()))
        assert err <= rtol * norm, (path, err, norm)


_REF_CACHE: dict = {}


def reference(arch: str, jax_impl: str):
    """The pair at smoke size (fp32) and the reference's jitted loss and
    gradients on ``lm_batch``, once per (arch, impl)."""
    key = (arch, jax_impl)
    if key not in _REF_CACHE:
        pair = model_pair(arch, jax_impl=jax_impl, attn_chunk=CHUNK,
                          remat=True, **ARCHS[arch])
        batch = lm_batch(pair.tcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(pair.jmodel.loss_fn))(
            pair.jparams, jbatch)
        grads = params_from_jax(jax.tree.map(np.asarray, grads), pair.tcfg,
                                device="cpu")
        _REF_CACHE[key] = (pair, batch, float(loss), grads)
    return _REF_CACHE[key]


@pytest.mark.parametrize("impls", [("plain", "xla_full"),
                                   ("chunked", "xla")],
                         ids=["plain-vs-xla_full", "chunked-vs-xla"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch, impls):
    port_impl, jax_impl = impls
    pair, batch, want_loss, want_grads = reference(arch, jax_impl)
    model = build_model(dataclasses.replace(pair.tcfg, attn_impl=port_impl))
    loss, grads = port_loss_and_grads(model, pair.tparams, batch)
    assert np.isfinite(loss)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (
        loss, want_loss)
    assert_leaves_close(grads, want_grads, GRAD_RTOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_remat_changes_no_gradient(arch):
    pair, batch, _, _ = reference(arch, "xla")
    cfg = dataclasses.replace(pair.tcfg, attn_impl="chunked")
    _, with_remat = port_loss_and_grads(build_model(cfg), pair.tparams,
                                        batch)
    _, without = port_loss_and_grads(
        build_model(dataclasses.replace(cfg, remat=False)), pair.tparams,
        batch)
    assert_leaves_close(with_remat, without, REMAT_RTOL)


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
@pytest.mark.parametrize("chunk", [4, 7, 64])
def test_chunked_attention_equals_the_oracle(chunk, causal, window,
                                             q_offset):
    q = to_torch(rand(0, (2, 4, 19, 16)))
    k = to_torch(rand(1, (2, 2, 19 + q_offset, 16)))
    v = to_torch(rand(2, (2, 2, 19 + q_offset, 16)))
    got = tattn.chunked_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, chunk=chunk)
    want = tref.attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    torch.testing.assert_close(got, want, atol=3e-6, rtol=0)


# ------------------------------------------------------ the refusal
def _wrapper_calls(requires_grad: bool):
    """Each wrapper of ``kernels/ops.py`` that can reach a CUDA kernel,
    on small CPU tensors of which one requires grad."""
    q = to_torch(rand(0, (1, 2, 32, 16))).requires_grad_(requires_grad)
    k = to_torch(rand(1, (1, 2, 32, 16)))
    pool = k.reshape(2, 8, 4, 16)
    table = torch.arange(8, dtype=torch.int32)
    lens = torch.tensor([9], dtype=torch.int32)
    x = to_torch(rand(2, (1, 32, 4, 8))).requires_grad_(requires_grad)
    return {
        "attention": lambda: tops.attention(q, k, k, causal=True),
        "decode_attention": lambda: tops.decode_attention(
            q[:, :, 0], k, k, 9),
        "paged_decode_attention": lambda: tops.paged_decode_attention(
            q[:, :, 0], pool, pool, table[None], lens),
        "paged_prefill_attention": lambda: tops.paged_prefill_attention(
            q[0], pool, pool, table, span(0, 32)),
        "paged_verify_attention": lambda: tops.paged_verify_attention(
            q[:, :, :2].transpose(1, 2), pool, pool, table[None], lens,
            lens - 2),
        "ssd_chunked": lambda: tops.ssd_chunked(
            x, -x[..., 0].detach().abs(), x.detach(), x.detach(), 16),
    }


WRAPPERS = sorted(_wrapper_calls(False))


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_to_be_differentiated(name):
    tops.reset_launch_counts()
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        _wrapper_calls(True)[name]()
    with torch.no_grad():
        out = _wrapper_calls(True)[name]()
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all() and not out.requires_grad
    # grad on, no input that requires grad: runs as before
    _wrapper_calls(False)[name]()
    assert set(tops.launch_counts().values()) == {0}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_kernel_route_refuses_training_and_serves_under_no_grad(arch):
    pair, batch, _, _ = reference(arch, "xla")
    model = build_model(dataclasses.replace(pair.tcfg, attn_impl="kernel"))
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      pair.tparams)
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        model.loss_fn(params, torch_batch(batch))
    with torch.no_grad():
        got = model.loss_fn(params, torch_batch(batch))
    plain = build_model(dataclasses.replace(pair.tcfg, attn_impl="plain"))
    want = plain.loss_fn(pair.tparams, torch_batch(batch))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


# ------------------------------------------------------------ RG-LRU
def _inplace_affine_scan(a, b):
    """The scan as it was written before: in place on copies."""
    a, b = a.clone(), b.clone()
    d = 1
    while d < a.shape[1]:
        b[:, d:] += a[:, d:] * b[:, :-d]
        a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


@pytest.mark.parametrize("length", [1, 2, 5, 64, 100])
def test_affine_scan_equals_the_in_place_scan_bit_for_bit(length):
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.random((2, length, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, length, 24))
                         .astype(np.float32))
    got = trglru.affine_scan(a, b)
    assert torch.equal(got.view(torch.int32),
                       _inplace_affine_scan(a, b).view(torch.int32))


def test_rglru_block_backpropagates_from_a_carried_state():
    pair = model_pair("recurrentgemma-9b")
    layer = pair.tparams["layers"][0]["rec"]
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      layer)
    x = to_torch(rand(3, (2, 9, pair.tcfg.d_model))).requires_grad_(True)
    state = to_torch(rand(4, (2, pair.tcfg.lru_width or pair.tcfg.d_model)))
    y, (_, h) = trglru.rglru_block(params, x, pair.tcfg,
                                   rnn_state=state.requires_grad_(True))
    (y.square().sum() + h.sum()).backward()
    for path, p in leaves_with_paths(params):
        assert p.grad is not None and torch.isfinite(p.grad).all(), path
    assert torch.isfinite(x.grad).all() and torch.isfinite(state.grad).all()
