"""The port's train step and train launcher.

* ``launch/steps.make_train_step`` against the reference's jitted
  ``make_train_step`` on the same batches (the reference's
  ``SyntheticLMData``): internlm2-smoke at fp32 from the reference's
  init, ``grad_accum`` 1 and 2, compression ``none`` and ``int8``, over 4
  steps across the end of warmup; losses and grad norms within 1e-4
  relative, each parameter leaf within 1e-4 of its norm (an Adam step on
  a gradient near 0 may take either sign, so the limit is per leaf), and
  without compression the first moments likewise. int8 shares a scale
  over the layers the reference stacks into one array, as the
  reference's per-array scale does;
* ``launch/train.main`` on the CPU, ported from the reference's
  ``tests/test_integration.py`` train tests (which fail on the reference,
  ROADMAP C2): the loss falls over 30 steps and the metrics file has a
  line a step; a run resumed from its step-10 checkpoint ends at the
  uninterrupted run's loss; int8 compression converges; a config whose
  attention is ``"kernel"`` trains on ``"chunked"`` and says so; the
  default device is CUDA, which raises without it;
* ``make_prefill_step`` and ``make_decode_step`` give the model's own
  prefill and decode logits.

Inputs come from numpy seeds; JAX stays on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMData as JaxData
from repro.distributed.compression import init_error_feedback
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import steps, train
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves_with_paths, tree_map
from repro_torch.weights import params_from_jax
from test_torch_harness import model_pair

STEP_RTOL = 1e-4
STEPS = 4
OPT = dict(lr=5e-3, warmup_steps=2, total_steps=STEPS)


def _assert_leaves_close(got, want, rtol: float) -> None:
    want = dict(leaves_with_paths(want))
    got = dict(leaves_with_paths(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = float(torch.linalg.vector_norm(
            got[path].detach().double() - w.double()))
        norm = float(torch.linalg.vector_norm(w.double()))
        assert err <= rtol * norm, (path, err, norm)


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference_over_steps(grad_accum, compression):
    pair = model_pair("internlm2-1.8b", jax_impl="xla_full")
    data = JaxData(vocab_size=pair.jcfg.vocab_size, seq_len=32,
                   global_batch=4, seed=17)
    jstep = jax.jit(jax_make_train_step(pair.jmodel, JaxOptConfig(**OPT),
                                        compression, grad_accum))
    tmodel_cfg = dataclasses.replace(pair.tcfg, attn_impl="plain")
    tstep = steps.make_train_step(
        dataclasses.replace(pair.tmodel, cfg=tmodel_cfg), OptConfig(**OPT),
        compression, grad_accum)
    jparams, jopt = pair.jparams, jax_adamw_init(pair.jparams)
    tparams = tree_map(torch.clone, pair.tparams)
    topt = adamw_init(tparams)
    if compression == "int8":
        jopt["err"] = init_error_feedback(jparams)
        topt["err"] = tcomp.init_error_feedback(tparams)
    convert = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree),
                                           pair.tcfg, device="cpu")
    for step in range(STEPS):
        batch = data.batch_at(step)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        tparams, topt, tm = tstep(tparams, topt, train.batch_on(batch, "cpu"))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL, err_msg=f"{step} {key}")
        assert int(topt["step"]) == step + 1
    _assert_leaves_close(tparams, convert(jparams), STEP_RTOL)
    if compression is None:
        # under int8 a gradient element within ~1e-7 of a code's rounding
        # edge takes the other code, which moves its moment and residual
        # by a whole code step: held at the parameters only
        _assert_leaves_close(topt["mu"], convert(jopt["mu"]), STEP_RTOL)
    # the step leaves the parameters as leaves that require grad, no .grad
    for path, p in leaves_with_paths(tparams):
        assert p.is_leaf and p.requires_grad and p.grad is None, path


def test_train_step_refuses_a_batch_that_does_not_split():
    pair = model_pair("internlm2-1.8b")
    step = steps.make_train_step(pair.tmodel, OptConfig(), None, 3)
    batch = train.batch_on(JaxData(vocab_size=512, seq_len=8,
                                   global_batch=4).batch_at(0), "cpu")
    params = tree_map(torch.clone, pair.tparams)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), batch)
    with pytest.raises(ValueError, match="compression"):
        steps.make_train_step(pair.tmodel, OptConfig(), "fp8")


def test_prefill_and_decode_steps_are_the_models():
    pair = model_pair("whisper-large-v3", jax_impl="xla_full")
    model = dataclasses.replace(
        pair.tmodel, cfg=dataclasses.replace(pair.tcfg, attn_impl="plain"))
    batch = train.batch_on(JaxData(
        vocab_size=pair.tcfg.vocab_size, seq_len=6, global_batch=2,
        frontend_tokens=pair.tcfg.num_frontend_tokens,
        d_model=pair.tcfg.d_model).batch_at(0), "cpu")
    logits, cache = steps.make_prefill_step(model, 16)(pair.tparams, batch)
    mem = model.encode(pair.tparams, batch["frontend"])
    want, _ = model.prefill(pair.tparams, model.cfg, batch["tokens"], 16,
                            encoder_out=mem)
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    token = logits.argmax(-1)
    got, _ = steps.make_decode_step(model)(pair.tparams, cache, token, 6)
    assert got.shape == (2, 1, pair.tcfg.vocab_size)
    assert torch.isfinite(got).all()


# ------------------------------------------------------------ train.main
def test_train_loss_decreases(tmp_path):
    losses = train.main([
        "--arch", "qwen3-1.7b", "--smoke", "--steps", "30",
        "--batch", "8", "--seq", "64", "--lr", "5e-3", "--device", "cpu",
        "--metrics-file", str(tmp_path / "m.jsonl"),
    ])
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[:3]
    with open(tmp_path / "m.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [m["step"] for m in lines] == list(range(30))
    assert [m["loss"] for m in lines] == losses


def test_train_restart_resumes_stream(tmp_path):
    """Train 20 steps with a checkpoint at 10; a fresh run restoring at
    10 must end at the uninterrupted run's loss."""
    common = ["--arch", "internlm2-1.8b", "--smoke", "--steps", "20",
              "--total-steps", "20", "--batch", "4", "--seq", "32",
              "--save-every", "10", "--device", "cpu"]
    full = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    first = train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps",
                        "10", "--total-steps", "20", "--batch", "4",
                        "--seq", "32", "--save-every", "10", "--device",
                        "cpu", "--ckpt-dir", str(tmp_path / "b")])
    assert first == full[:10]
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(resumed) == 10
    assert abs(full[-1] - resumed[-1]) < 5e-3, (full[-1], resumed[-1])
    assert (tmp_path / "b" / "hb" / "hb_proc0.json").exists()


def test_train_with_int8_compression_converges():
    losses = train.main([
        "--arch", "qwen3-1.7b", "--smoke", "--steps", "25",
        "--batch", "8", "--seq", "64", "--lr", "5e-3",
        "--compression", "int8", "--device", "cpu",
    ])
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_train_takes_chunked_attention_for_a_kernel_config(capsys):
    losses = train.main(["--arch", "internlm2-1.8b", "--d-model", "32",
                         "--layers", "1", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert 'attn_impl="chunked"' in capsys.readouterr().out


def test_train_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])
