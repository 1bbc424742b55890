"""The port's CUDA kernels on the card, held to their plain versions.

Every test here needs a CUDA device, is marked ``gpu`` and skips itself
elsewhere; the file imports no JAX, so it runs on a GPU host that has
only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Each kernel runs in fp32 against its plain version on the same CUDA
tensors (atol 3e-5: fp32 sums in another order), and the wave engine
serves a smoke model on the card with the same tokens as on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import mas_attention as mas
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serving import Request, ServingEngine

FP32_ATOL = 3e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("resident", [True, False])
def test_mas_kernels_match_plain(cuda, resident, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _rand(g, 8, 160, 64), _rand(g, 4, 192, 64), _rand(g, 4, 192, 64)
    got = mas.mas_attention_flat(q, k, v, blk_q=32, causal=causal,
                                 kv_resident=resident, kv_len=170)
    want = mas.mas_attention_plain(q, k, v, blk_q=32, blk_kv=64,
                                   causal=causal, kv_len=170)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


@pytest.mark.parametrize("window", [None, 40])
def test_flash_kernel_matches_plain(cuda, window):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = _rand(g, 4, 128, 128), _rand(g, 2, 256, 128), \
        _rand(g, 2, 256, 128)
    got = fl.flash_attention_flat(q, k, v, blk_q=16, causal=True,
                                  window=window, q_offset=100, kv_len=230)
    want = fl.flash_attention_plain(q, k, v, blk_q=16, blk_kv=64, causal=True,
                                    window=window, q_offset=100, kv_len=230)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def test_decode_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = _rand(g, 4, 4, 128), _rand(g, 4, 500, 128), _rand(g, 4, 500, 128)
    lens = torch.tensor([0, 64, 65, 500], dtype=torch.int32, device=cuda)
    got = dec.decode_attention_flat(q, k, v, lens)
    n_split, tps = dec.split_plan(4, 500)
    want = dec.decode_attention_plain(q, k, v, lens, n_split=n_split,
                                      tiles_per_split=tps)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FP32_ATOL


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"), attn_impl="kernel",
                              compute_dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    gpu_params = {"embed": cpu_params["embed"].to(cuda),
                  "final_norm": cpu_params["final_norm"].to(cuda),
                  "layers": [{blk: {k: t.to(cuda) for k, t in p.items()}
                              for blk, p in layer.items()}
                             for layer in cpu_params["layers"]]}
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=6, eos_id=-1)
            for i, n in enumerate([7, 7, 30])]
    ops.reset_launch_counts()
    on_gpu = ServingEngine(model, gpu_params, max_len=64, batch_size=2,
                           device=cuda).serve(reqs)
    counts = ops.launch_counts()
    on_cpu = ServingEngine(model, cpu_params, max_len=64, batch_size=2,
                           device="cpu").serve(reqs)
    for rid in on_cpu:
        np.testing.assert_array_equal(on_gpu[rid], on_cpu[rid])
    assert counts["mas_resident"] > 0 and counts["decode"] > 0
