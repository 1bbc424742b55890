"""The port's MoE FFN against the JAX package's ``moe_ffn``.

The same parameters (the reference's init, carried over by
``params_from_jax``) and the same tokens go through both, in fp32: the
outputs and the load-balance loss must agree to atol 3e-5, and the
routing (experts, positions in each expert's buffer, which assignments
are kept) must be the reference's exactly. The smoke configs' capacity
factor of 8 never drops an assignment, so the tests also run at 1.25 and
0.5, where the reference itself drops; a row of tied router
probabilities must take the lower expert index first, as
``jax.lax.top_k`` does; a hypothesis sweep varies the token count, the
experts, top-k, the shared experts and the capacity factor.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke as jax_get_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.models import moe as tmoe
from test_torch_harness import FP32_ATOL, assert_close, model_pair, rand

ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b"]


def _with_cf(cfg, cf: float, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, **moe))


def _jax_route(params, x: np.ndarray, cfg):
    """The reference's routing at one token group (``moe.py:97-119``):
    (expert ids, positions, keep) of the token-major assignments."""
    m = cfg.moe
    t = x.shape[0]
    capacity = max(4, int(m.capacity_factor * t * m.top_k / m.num_experts))
    logits = jnp.asarray(x) @ jnp.asarray(params["router"], jnp.float32)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    flat = ids.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat, m.num_experts, dtype=jnp.int32),
                     axis=0) - 1
    pos = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
    return np.asarray(ids), np.asarray(pos), np.asarray(pos < capacity)


def _both(jparams, tparams, x: np.ndarray, jcfg, tcfg):
    """(y, aux) of both packages on x (B, S, D), the routing held equal;
    returns the reference's keep mask."""
    want, want_aux = jmoe.moe_ffn(jparams, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_close(got, want, FP32_ATOL)
    assert_close(aux, want_aux, FP32_ATOL)
    flat = x.reshape(-1, x.shape[-1])
    ids, pos, keep = _jax_route(jparams, flat, jcfg)
    r = tmoe.moe_route(tparams, torch.from_numpy(flat), tcfg)
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    np.testing.assert_array_equal(r.positions.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.capacity == max(4, int(tcfg.moe.capacity_factor * flat.shape[0]
                                    * tcfg.moe.top_k
                                    / tcfg.moe.num_experts))
    return keep


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param, seed=6)


def _ffn_params(pair, layer: int = 0):
    jffn = jax.tree.map(lambda a: a[layer],
                        pair.jparams["units"]["b0"]["ffn"])
    return jffn, pair.tparams["layers"][layer]["ffn"]


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 37)])
def test_moe_ffn_matches_reference(pair, cf, shape):
    jffn, tffn = _ffn_params(pair)
    d = pair.tcfg.d_model
    x = rand(sum(shape) + int(cf * 4), (*shape, d))
    keep = _both(jffn, tffn, x, _with_cf(pair.jcfg, cf),
                 _with_cf(pair.tcfg, cf))
    if cf == 8.0:
        assert keep.all()
    if cf == 0.5 and shape == (1, 37):
        assert not keep.all()       # the reference drops here


def test_tied_router_probabilities_take_the_lower_expert_first(pair):
    """Router columns 1, 5 and 6 zeroed: every token's logits for those
    three experts are exactly 0, so their probabilities tie, and top-k
    must take them in index order."""
    jffn, tffn = _ffn_params(pair)
    router = np.asarray(jffn["router"]).copy()
    router[:, [1, 5, 6]] = 0.0
    jffn = dict(jffn, router=jnp.asarray(router))
    tffn = dict(tffn, router=torch.from_numpy(router))
    x = rand(11, (1, 24, pair.tcfg.d_model))
    for cf in (8.0, 0.5):
        _both(jffn, tffn, x, _with_cf(pair.jcfg, cf),
              _with_cf(pair.tcfg, cf))
    ids = tmoe.moe_route(tffn, torch.from_numpy(x[0]), pair.tcfg).expert_ids
    picked = [set(row) & {1, 5, 6} for row in ids.tolist()]
    assert {1} in picked and {1, 5} in picked      # ties at the boundary
    assert all(p in (set(), {1}, {1, 5}) for p in picked)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16), tokens=st.integers(1, 40),
       experts=st.sampled_from([4, 8, 16]), top_k=st.integers(1, 4),
       shared=st.integers(0, 2),
       cf=st.sampled_from([0.25, 0.5, 1.0, 1.25, 2.0, 8.0]))
def test_moe_ffn_hypothesis_sweep(seed, tokens, experts, top_k, shared, cf):
    """The reference's ``init_moe`` at the drawn widths, carried over leaf
    by leaf (fp32), and the two FFNs on the same tokens."""
    jcfg = _with_cf(dataclasses.replace(
        jax_get_smoke("deepseek-moe-16b"), compute_dtype=jnp.float32), cf,
        num_experts=experts, top_k=top_k, num_shared=shared)
    tcfg = _with_cf(dataclasses.replace(
        get_smoke("deepseek-moe-16b"), compute_dtype=torch.float32), cf,
        num_experts=experts, top_k=top_k, num_shared=shared)
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    assert ("shared" in tparams) == bool(shared)
    x = rand(seed, (1, tokens, tcfg.d_model))
    _both(jparams, tparams, x, jcfg, tcfg)
