"""The port's RG-LRU block (``models/rglru.py``) against the JAX package's.

* ``affine_scan``, the doubling scan that replaces the reference's
  ``jax.lax.associative_scan``, against a sequential loop over the
  positions and against the reference's ``_affine_scan``;
* ``rglru_block`` in its three forms against the reference's, fp32, atol
  3e-5: the full sequence from zero states, the one-token streaming step
  chained over a sequence, and a full sequence that starts from carried
  conv and recurrent states (the second half of a sequence after its
  first half), which must also equal the whole sequence's second half;
* ``init_rglru_block`` draws the reference's shapes.

Inputs come from numpy seeds; the block's weights are the reference's
init with its norm and ``lam`` redrawn, at d_model 64 and at an LRU width
other than d_model.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import rglru as jrglru
from repro_torch.configs import get_smoke
from repro_torch.models import rglru as trglru
from test_torch_harness import FP32_ATOL, as_numpy, assert_close, rand

ARCH = "recurrentgemma-9b"
# (d_model, lru_width): the smoke's, and a width that is not d_model
WIDTHS = [(64, 64), (48, 80)]


def _cfgs(d: int, w: int):
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), d_model=d, lru_width=w,
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_smoke(ARCH), d_model=d, lru_width=w,
                               compute_dtype=torch.float32)
    return jcfg, tcfg


def _block(seed: int, d: int, w: int):
    """The reference's init with a random norm scale and lam, in both
    packages: (jcfg, tcfg, jax params, torch params)."""
    jcfg, tcfg = _cfgs(d, w)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, norm=jnp.asarray(rand(seed, (d,))),
              lam=jnp.asarray(np.abs(rand(seed + 1, (w,))) + 0.1))
    tp = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("length", [1, 2, 3, 17, 64, 100])
def test_affine_scan_matches_a_sequential_loop(length):
    a = np.abs(rand(length, (2, length, 5))) / 3.0
    b = rand(length + 1, (2, length, 5))
    got = trglru.affine_scan(torch.from_numpy(a), torch.from_numpy(b))
    h = np.zeros((2, 5), np.float64)
    want = []
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        want.append(h.copy())
    want = np.stack(want, axis=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    ref = jrglru._affine_scan(jnp.asarray(a), jnp.asarray(b))
    assert_close(got, ref, FP32_ATOL)
    # the inputs are left as they were
    np.testing.assert_array_equal(a, np.abs(rand(length, (2, length, 5)))
                                  / 3.0)


@pytest.mark.parametrize("d,w", WIDTHS)
def test_rglru_full_sequence_matches_reference(d, w):
    jcfg, tcfg, jp, tp = _block(1, d, w)
    x = rand(2, (2, 37, d))
    jy, (jconv, jrnn) = jrglru.rglru_block(jp, jnp.asarray(x), jcfg)
    ty, (tconv, trnn) = trglru.rglru_block(tp, torch.from_numpy(x), tcfg)
    assert tconv.shape == (2, 3, w) and trnn.shape == (2, w)
    assert trnn.dtype == torch.float32
    assert_close(ty, jy, FP32_ATOL)
    assert_close(tconv, jconv, FP32_ATOL)
    assert_close(trnn, jrnn, FP32_ATOL)


@pytest.mark.parametrize("d,w", WIDTHS)
def test_rglru_streaming_steps_match_reference(d, w):
    jcfg, tcfg, jp, tp = _block(3, d, w)
    x = rand(4, (2, 9, d))
    jstate = tstate = (None, None)
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        jy, jstate = jrglru.rglru_block(jp, jnp.asarray(xt), jcfg,
                                        conv_state=jstate[0],
                                        rnn_state=jstate[1], streaming=True)
        ty, tstate = trglru.rglru_block(tp, torch.from_numpy(xt), tcfg,
                                        conv_state=tstate[0],
                                        rnn_state=tstate[1], streaming=True)
        assert_close(ty, jy, FP32_ATOL)
        ys.append(as_numpy(ty))
        for got, want in zip(tstate, jstate):
            assert_close(got, want, FP32_ATOL)
    # the chained steps are the full sequence
    full, (conv, rnn) = trglru.rglru_block(tp, torch.from_numpy(x), tcfg)
    assert_close(full, np.concatenate(ys, axis=1), FP32_ATOL)
    assert_close(conv, tstate[0], FP32_ATOL)
    assert_close(rnn, tstate[1], FP32_ATOL)
    with pytest.raises(ValueError, match="one token"):
        trglru.rglru_block(tp, torch.from_numpy(x), tcfg, streaming=True)


@pytest.mark.parametrize("d,w", WIDTHS)
def test_rglru_carried_state_matches_reference(d, w):
    """A sequence's second half from the states its first half left: the
    carried conv rows and the recurrent state folded into the first
    step."""
    jcfg, tcfg, jp, tp = _block(5, d, w)
    x = rand(6, (2, 30, d))
    head, rest = x[:, :13], x[:, 13:]
    _, (conv, rnn) = trglru.rglru_block(tp, torch.from_numpy(head), tcfg)
    ty, (tconv, trnn) = trglru.rglru_block(tp, torch.from_numpy(rest), tcfg,
                                           conv_state=conv, rnn_state=rnn)
    jy, (jconv, jrnn) = jrglru.rglru_block(
        jp, jnp.asarray(rest), jcfg, conv_state=jnp.asarray(as_numpy(conv)),
        rnn_state=jnp.asarray(as_numpy(rnn)))
    assert_close(ty, jy, FP32_ATOL)
    assert_close(tconv, jconv, FP32_ATOL)
    assert_close(trnn, jrnn, FP32_ATOL)
    whole, (wconv, wrnn) = trglru.rglru_block(tp, torch.from_numpy(x), tcfg)
    assert_close(ty, whole[:, 13:], FP32_ATOL)
    assert_close(trnn, wrnn, FP32_ATOL)
    assert_close(tconv, wconv, FP32_ATOL)


@pytest.mark.parametrize("d,w", WIDTHS)
def test_rglru_init_draws_the_reference_shapes(d, w):
    jcfg, tcfg = _cfgs(d, w)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = trglru.init_rglru_block(gen, tcfg, torch.float32)
    assert set(tp) == set(jp)
    for key, want in jp.items():
        assert tuple(tp[key].shape) == tuple(want.shape), key
    assert_close(tp["lam"], jp["lam"], 1e-6)   # linspace, an ulp apart
    assert float(tp["norm"].abs().max()) == 0.0
    assert trglru.rglru_dims(tcfg) == {"conv": (3, w), "rnn": (w,)}
