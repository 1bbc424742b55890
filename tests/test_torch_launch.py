"""The port's serving launcher against the JAX package's
(``repro/launch/serve.py``).

Both launchers draw their prompts from numpy's ``default_rng(0)``; given
the reference's init (converted through numpy), the port's launcher must
serve the same prompts and emit the same greedy tokens, token for token,
on the CPU. With random norm scales in place of the init's zeros (under
which a smoke model repeats one token), handed to both launchers at fp32
compute (bf16 rounds differently in XLA and in torch, and a near tie
then parts the greedy streams), the tokens must still agree. Without
CUDA, and without ``--device``, the port's launcher raises instead of
falling back to the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro_torch.launch.serve as serve
from repro.configs import get_smoke as ref_get_smoke
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_smoke
from repro_torch.weights import params_from_jax
from tests.test_torch_harness import _vary_norms

ARGS = ["--smoke", "--requests", "5", "--prompt-len", "12", "--max-new", "6"]


def _recording(module, monkeypatch) -> list:
    """Record the requests ``module``'s launcher hands its engine."""
    seen = []
    real = module.ServingEngine

    class Recording(real):
        def serve(self, requests):
            seen.extend(requests)
            return super().serve(requests)

    monkeypatch.setattr(module, "ServingEngine", Recording)
    return seen


def _ref_init(arch: str):
    model = ref_build_model(ref_get_smoke(arch))
    return jax.jit(model.init)(jax.random.PRNGKey(0))


def _converted(tree, arch: str) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, tree), get_smoke(arch),
                           device="cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-1.7b"])
def test_launcher_matches_reference(arch, monkeypatch, capsys):
    ref_seen = _recording(ref_serve, monkeypatch)
    seen = _recording(serve, monkeypatch)
    argv = ["--arch", arch, *ARGS]
    ref_out = ref_serve.main(argv)
    out = serve.main(argv + ["--device", "cpu"],
                     params=_converted(_ref_init(arch), arch))
    assert [r.rid for r in seen] == [r.rid for r in ref_seen]
    for mine, ref in zip(seen, ref_seen):
        np.testing.assert_array_equal(mine.prompt, ref.prompt)
        assert mine.max_new_tokens == ref.max_new_tokens == 6
    assert sorted(out) == sorted(ref_out) == list(range(5))
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], np.asarray(ref_out[rid]))
    assert "[serve] 5 requests, 30 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b"])
def test_launcher_matches_reference_with_varied_norms(arch, monkeypatch):
    tree = _vary_norms(_ref_init(arch), seed=1, std=2.0)
    real_build = ref_serve.build_model

    def build_with_tree(cfg):
        return dataclasses.replace(real_build(cfg), init=lambda key: tree)

    monkeypatch.setattr(ref_serve, "build_model", build_with_tree)
    for module, dtype in ((ref_serve, jax.numpy.float32),
                          (serve, torch.float32)):
        monkeypatch.setattr(
            module, "get_smoke",
            lambda a, real=module.get_smoke, dtype=dtype:
            dataclasses.replace(real(a), compute_dtype=dtype))
    argv = ["--arch", arch, *ARGS]
    ref_out = ref_serve.main(argv)
    out = serve.main(argv + ["--device", "cpu"],
                     params=_converted(tree, arch))
    assert len({int(t) for v in out.values() for t in v}) > 5
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], np.asarray(ref_out[rid]))


def test_launcher_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "internlm2-1.8b", *ARGS])
