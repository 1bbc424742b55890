"""Shared helpers for the PyTorch port's tests (this file defines no tests).

The port's tests feed the same inputs, made from a seed with numpy, to
the JAX package (the reference) and to ``repro_torch``, and compare the
results. JAX stays on the CPU; arrays cross between the two as numpy.
The JAX Pallas kernels run in interpret mode, as ``tests/test_kernels.py``
runs them.

Torch is held to one intra-op thread: the suite runs several xdist
workers on a few cores, and torch's default of one thread per core would
starve the JAX tests that share the machine.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_smoke as torch_get_smoke
from repro_torch.models.api import build_model as torch_build_model
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

FP32_ATOL = 3e-5      # kernels in fp32: sums taken in another order
BF16_ATOL = 3e-2      # kernels in bf16: one rounding of an output near 4
LOGITS_ATOL = 1e-4    # model logits, fp32, port vs reference

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rand(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def to_jax(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def to_torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def span(q_offset: int, kv_len: int, device="cpu") -> torch.Tensor:
    """B5's (q_offset, kv_len) int32 pair on the device."""
    return torch.tensor([q_offset, kv_len], dtype=torch.int32,
                        device=device)


def chunk_span(q_offset: int, chunk_len: int) -> torch.Tensor:
    """What a chunk step takes, as the continuous engine packs it:
    (q_offset, kv_len, last live row) int32."""
    return torch.tensor([q_offset, q_offset + chunk_len, chunk_len - 1],
                        dtype=torch.int32)


def assert_close(got, want, atol: float) -> None:
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), atol=atol,
                               rtol=0)


def atol_for(dtype_name: str) -> float:
    return BF16_ATOL if dtype_name == "bfloat16" else FP32_ATOL


@dataclasses.dataclass
class Pair:
    """One smoke architecture in both packages, with the same weights."""

    jcfg: object
    jmodel: object
    jparams: object
    tcfg: object
    tmodel: object
    tparams: dict


def _vary_norms(tree, seed: int, std: float):
    """``tree`` with every norm scale drawn from N(0, std²) by numpy.

    The reference's init sets norm scales to 0, under which a smoke
    model's greedy output repeats one token; random scales make the
    token streams vary, so token-for-token comparisons mean something.
    """
    rng = np.random.default_rng(seed)

    def visit(node, key=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if key.endswith("norm"):
            return jnp.asarray(rng.standard_normal(node.shape) * std,
                               node.dtype)
        return node

    return visit(tree)


def model_pair(arch: str, seed: int = 0, *, jax_impl: str = "pallas",
               norm_std: float | None = None, **overrides) -> Pair:
    """fp32 smoke models: the reference with its Pallas kernels
    (interpret mode; ``jax_impl`` picks another of its attention
    backends), the port with its kernels' plain versions on the CPU, both
    from the reference's init (with random norm scales when ``norm_std``
    is given). ``overrides`` replace fields of both packages' smoke
    configs alike (widths, depth, window)."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), attn_impl=jax_impl,
                               compute_dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(torch_get_smoke(arch), attn_impl="kernel",
                               compute_dtype=torch.float32, **overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    if norm_std is not None:
        jparams = _vary_norms(jparams, seed, norm_std)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return Pair(jcfg, jmodel, jparams, tcfg, torch_build_model(tcfg), tparams)


def prompts(seed: int, batch: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        3, vocab, size=(batch, length)).astype(np.int32)
