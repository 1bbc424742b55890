"""The port's GPipe pipeline (``repro_torch/distributed/pipeline.py``)
against the reference's and against its own ``sequential_apply``.

* The reference's own case (8 layers of ``tanh(h @ w)`` at D 16, a batch
  of 8 in 4 microbatches over 4 stages, numpy seed 0) through the
  reference's ``pipelined_apply`` and ``sequential_apply``, run once in a
  subprocess with 4 forced host devices on a mesh of ``AxisType.Auto``
  under ``jax.set_mesh`` (the installed jax gives ``jax.make_mesh``
  Explicit axes by default, under which the reference's pipeline
  raises); the port's counterparts on 4 thread ranks within 1e-5, the
  reference test's tolerance.
* Ranks are threads sharing a ``ThreadShard`` (``test_torch_seqcarry``)
  for 1, 2 and 4 stages and 1, 4 and 8 microbatches: each microbatch's
  output bit for bit ``sequential_apply`` on that microbatch alone (one
  stage: the whole batch's), the
  bytes by kind (M + S - 1 microbatches a rank each way, kind ``pipe``;
  the last stage's outputs broadcast, kind ``bcast``).
* The refusals: stages that do not divide the layers, microbatches that
  do not divide the batch, a call autograd would record.
* internlm2-smoke's full-sequence blocks (``transformer._layer_train``)
  over 2 and 4 thread ranks at fp32: the final norm and unembedding of
  the result give ``forward``'s logits within 1e-6.

The same pipeline over four real gloo ranks runs in
``tests/test_torch_sharded.py``'s 4-rank spawn.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.distributed.pipeline import (
    pipelined_apply,
    sequential_apply,
    stage_layers,
)
from repro_torch.models import transformer as tfm
from test_torch_seqcarry import ThreadShard, on_ranks

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5              # the reference test's
LOGITS_TOL = 1e-6
L, D, B = 8, 16, 8

REFERENCE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipelined_apply, sequential_apply
    mesh = jax.make_mesh((4,), ("stage",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    rng = np.random.default_rng(0)
    L, D = 8, 16
    params = jnp.asarray(rng.standard_normal((L, D, D)) * 0.2, jnp.float32)
    x = jnp.asarray(rng.standard_normal((8, D)), jnp.float32)
    body = lambda w, h: jnp.tanh(h @ w)
    with jax.set_mesh(mesh):
        seq = sequential_apply(params, x, body)
        pp = pipelined_apply(params, x, body, mesh, num_microbatches=4)
    json.dump({"seq": np.asarray(seq).tolist(), "pp": np.asarray(pp).tolist()},
              open(sys.argv[1], "w"))
""")


def _case() -> tuple:
    """The reference test's layers (L, D, D) and batch (8, D), fp32."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return list(torch.from_numpy(w)), torch.from_numpy(x)


def _body(w, h):
    return torch.tanh(h @ w)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline") / "ref.json"
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out)], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(out.read_text()).items()}


def _pipelined(layers, x, degree: int, m: int, body=_body) -> list:
    """Each thread rank's (output, shard) of the pipeline."""
    def run(shard):
        with torch.no_grad():
            y = pipelined_apply(stage_layers(layers, shard), x, body, shard,
                                num_microbatches=m)
        return y, shard
    return on_ranks(degree, run)


def test_the_references_case_matches_the_references_pipeline(reference):
    layers, x = _case()
    np.testing.assert_allclose(sequential_apply(layers, x, _body).numpy(),
                               reference["seq"], atol=TOL, rtol=TOL)
    for y, _ in _pipelined(layers, x, 4, 4):
        np.testing.assert_allclose(y.numpy(), reference["pp"], atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(reference["pp"], reference["seq"], atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("degree", [1, 2, 4])
def test_microbatches_are_sequential_bit_for_bit_and_bytes_by_kind(degree,
                                                                   m):
    layers, x = _case()
    per = B // m
    mb_bytes = per * D * 4
    for y, shard in _pipelined(layers, x, degree, m):
        if degree == 1:         # sequential_apply of the whole batch
            assert torch.equal(y, sequential_apply(layers, x, _body))
        for i in range(m if degree > 1 else 0):
            rows = slice(i * per, (i + 1) * per)
            assert torch.equal(y[rows], sequential_apply(layers, x[rows],
                                                         _body)), (i, shard)
        pipe = (m + degree - 1) * mb_bytes if degree > 1 else 0
        assert shard.sent["pipe"] == shard.received["pipe"] == pipe
        last = shard.rank == degree - 1
        whole = B * D * 4 if degree > 1 else 0
        assert shard.sent["bcast"] == (whole * (degree - 1) if last else 0)
        assert shard.received["bcast"] == (0 if last else whole)
        assert sum(shard.sent.values()) == pipe + shard.sent["bcast"]


def test_refusals():
    layers, x = _case()
    with pytest.raises(ValueError, match="do not split into 3 stages"):
        stage_layers(layers, ThreadShard(None, 0, 3))
    shard = ThreadShard(None, 0, 2)
    with pytest.raises(ValueError, match="does not split into 3"):
        pipelined_apply(stage_layers(layers, shard), x, _body, shard,
                        num_microbatches=3)
    grad = [w.clone().requires_grad_(True) for w in layers]
    for shard in (None, ThreadShard(None, 0, 2)):
        with pytest.raises(RuntimeError, match="no backward"):
            pipelined_apply(stage_layers(grad, shard), x, _body, shard,
                            num_microbatches=2)
    with torch.no_grad():      # not recorded: runs
        y = pipelined_apply(grad, x, _body, None, num_microbatches=2)
    assert torch.equal(y, sequential_apply(layers, x, _body))


@pytest.mark.parametrize("degree", [2, 4])
def test_model_blocks_pipelined_give_the_forward_logits(degree):
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"), num_layers=4,
                              compute_dtype=torch.float32)
    params = tfm.init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg.vocab_size, size=(4, 24)))
    positions = torch.arange(tokens.shape[1])

    def body(layer, h):
        return tfm._layer_train(layer, h, cfg, positions, None)[0]

    with torch.no_grad():
        want = tfm.forward(params, tokens, cfg)[0]
        h = tfm._embed(params, tokens, cfg)
    for y, _ in _pipelined(params["layers"], h, degree, 4, body):
        got = tfm._unembed(params, y, cfg)
        torch.testing.assert_close(got, want, atol=LOGITS_TOL, rtol=0)
