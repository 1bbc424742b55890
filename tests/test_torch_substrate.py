"""The port's training substrate against the JAX package.

* AdamW (``optim/adamw.py``) against the reference's ``adamw_update`` on
  the same gradients, over internlm2-smoke's parameter tree: four steps
  across the end of warmup and past ``total_steps``, one of them
  clipped; parameters, moments (carried into the port's tree by
  ``params_from_jax``), ``grad_norm`` and ``lr`` within 1e-6; the cosine
  schedule at steps around its corners;
* compression (``distributed/compression.py``) against the reference's
  ``apply_compression``: bf16 exactly, int8 with its error feedback
  carried across steps within 1e-8, also over whole gradient trees,
  where one scale covers the layers the reference stacks into one array
  (``weights.reference_leaf``), and the train step's in-place form and
  ``compress_bf16`` / ``compress_int8_with_feedback`` equal to
  ``apply_compression``;
* ``SyntheticLMData`` equal to the reference's batch for batch
  (``np.array_equal``) over several steps, host-sliced over two
  processes, and with frontend features;
* checkpoints, ported from the reference's ``tests/test_substrate.py``
  (all but its cross-mesh case): a round trip of fp32, bf16 and an int32
  step bit for bit, keep-k and the latest step, an async save, no
  ``.tmp`` left visible and an interrupted save never taken as the
  latest;
* ``StepTimer`` and ``Watchdog``, ported from the same file.

Inputs come from numpy seeds; JAX stays on the CPU.
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMData as JaxData
from repro.distributed import compression as jcomp
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.elastic import StepTimer, Watchdog
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.weights import params_from_jax, reference_leaf
from test_torch_harness import model_pair

OPT_ATOL = 1e-6


def assert_trees_close(got, want, atol: float) -> None:
    want = dict(leaves_with_paths(want))
    got = dict(leaves_with_paths(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=path)


def _grads(jparams, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale,
                              jnp.float32), jparams)


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_matches_reference_across_warmup_and_past_the_horizon(
        clip_norm):
    pair = model_pair("internlm2-1.8b")
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=3, clip_norm=clip_norm)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), tadamw.OptConfig(**cfg_kw)
    jparams, jstate = pair.jparams, jadamw.adamw_init(pair.jparams)
    tparams = tree_map(torch.clone, pair.tparams)
    tstate = tadamw.adamw_init(tparams)
    assert int(tstate["step"]) == 0 and tstate["step"].dtype == torch.int32
    convert = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree),
                                           pair.tcfg, device="cpu")
    for step, scale in enumerate((0.01, 0.5, 0.02, 0.003)):
        jgrads = _grads(jparams, step, scale)
        jparams, jstate, jm = jax.jit(jadamw.adamw_update, static_argnums=3)(
            jgrads, jstate, jparams, jcfg)
        tparams, tstate, tm = tadamw.adamw_update(convert(jgrads), tstate,
                                                  tparams, tcfg)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=OPT_ATOL, err_msg=key)
        assert_trees_close(tparams, convert(jparams), OPT_ATOL)
        assert_trees_close(tstate["mu"], convert(jstate["mu"]), OPT_ATOL)
        assert_trees_close(tstate["nu"], convert(jstate["nu"]), OPT_ATOL)


def test_cosine_lr_matches_reference():
    cfg_kw = dict(lr=3e-3, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), tadamw.OptConfig(**cfg_kw)
    for step in (0, 1, 9, 10, 11, 30, 49, 50, 51, 500):
        np.testing.assert_allclose(float(tadamw.cosine_lr(tcfg, step)),
                                   float(jadamw.cosine_lr(jcfg, step)),
                                   rtol=OPT_ATOL, err_msg=str(step))


def test_global_norm_matches_reference():
    pair = model_pair("deepseek-moe-16b")
    g = _grads(pair.jparams, 7, 0.1)
    tg = params_from_jax(jax.tree.map(np.asarray, g), pair.tcfg,
                         device="cpu")
    np.testing.assert_allclose(float(tadamw.global_norm(tg)),
                               float(jadamw.global_norm(g)), rtol=OPT_ATOL)


# ---------------------------------------------------------- compression
def _comp_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 48)) * 0.01,
            "layers": [{"b": rng.standard_normal((17,))},
                       {"b": rng.standard_normal((17,)) * 1e-5}]}


def _both(tree):
    tg = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), tree)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return tg, jg


def _as_torch(jtree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), jtree)


@pytest.mark.parametrize("mode", ["bf16", "int8", "none"])
def test_compression_matches_reference_with_feedback_across_steps(mode):
    t_err = tcomp.init_error_feedback(_both(_comp_tree(0))[0])
    j_err = jcomp.init_error_feedback(_both(_comp_tree(0))[1])
    for step in range(4):
        tg, jg = _both(_comp_tree(step))
        t_deq, t_err = tcomp.apply_compression(tg, t_err, mode)
        j_deq, j_err = jcomp.apply_compression(jg, j_err, mode)
        atol = 0.0 if mode != "int8" else OPT_ATOL * 1e-2
        assert_trees_close(t_deq, _as_torch(j_deq), atol)
        assert_trees_close(t_err, _as_torch(j_err), atol)
    if mode == "int8":
        assert max(float(e.abs().max()) for e in tree_leaves(t_err)) > 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_int8_scales_the_layers_the_reference_stacks_together(arch):
    """Over a model's gradient tree, the port's per-layer leaves grouped
    by ``weights.reference_leaf`` quantize as the reference's stacked
    arrays do, across steps."""
    pair = model_pair(arch)
    convert = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree),
                                           pair.tcfg, device="cpu")
    group_of = lambda path: reference_leaf(path, pair.tcfg)
    j_err = jcomp.init_error_feedback(pair.jparams)
    t_err = convert(j_err)
    for step in range(3):
        jg = _grads(pair.jparams, step, 0.01)
        j_deq, j_err = jcomp.apply_compression(jg, j_err, "int8")
        t_deq, t_err = tcomp.apply_compression(convert(jg), t_err, "int8",
                                               group_of)
        assert_trees_close(t_deq, convert(j_deq), OPT_ATOL * 1e-2)
        assert_trees_close(t_err, convert(j_err), OPT_ATOL * 1e-2)
    groups = {group_of(p) for p, _ in leaves_with_paths(pair.tparams)}
    assert len(groups) == len(jax.tree.leaves(pair.jparams))


def test_reference_leaf_names_the_stacked_arrays():
    cfg = model_pair("recurrentgemma-9b").tcfg     # (rec, rec, attn) + 2
    assert [reference_leaf(f"layers/{i}/ffn/w_up", cfg) for i in range(5)] \
        == ["units/b0/ffn/w_up", "units/b1/ffn/w_up", "units/b2/ffn/w_up",
            "tail/t0/ffn/w_up", "tail/t1/ffn/w_up"]
    assert reference_leaf("params/encoder/3/attn/wq", cfg) == \
        "params/encoder/attn/wq"
    assert reference_leaf("embed", cfg) == "embed"


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_in_place_compression_equals_the_functional_form(mode):
    tg, _ = _both(_comp_tree(3))
    err = tree_map(lambda g: g * 1e-3, tg)
    want_g, want_err = tcomp.apply_compression(tg, err, mode)
    if mode == "bf16":
        assert_trees_close(tcomp.compress_bf16(tg), want_g, 0.0)
    else:
        named_g, named_err = tcomp.compress_int8_with_feedback(tg, err)
        assert_trees_close(named_g, want_g, 0.0)
        assert_trees_close(named_err, want_err, 0.0)
    grads, errs = tree_map(torch.clone, tg), tree_map(torch.clone, err)
    tcomp.apply_compression_(grads, errs, mode)
    assert_trees_close(grads, want_g, 0.0)
    assert_trees_close(errs, want_err, 0.0)


def test_int8_error_feedback_unbiased():
    """With feedback, accumulated compressed grads converge to the true
    accumulated grads (the residual stays bounded)."""
    g = {"w": torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 64)) * 0.01).float()}
    err = tcomp.init_error_feedback(g)
    acc = torch.zeros((64, 64))
    for _ in range(50):
        deq, err = tcomp.apply_compression(g, err, "int8")
        acc = acc + deq["w"]
    resid = float((acc - 50 * g["w"]).abs().max())
    assert resid <= 2 * float(g["w"].abs().max())


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=32, global_batch=4, seed=3),
    dict(vocab_size=92544, seq_len=64, global_batch=8, seed=17,
         process_index=1, process_count=2),
    dict(vocab_size=512, seq_len=16, global_batch=2, seed=5,
         frontend_tokens=8, d_model=32),
], ids=["plain", "host-slice", "frontend"])
def test_data_equals_reference_batch_for_batch(kw):
    mine, ref = SyntheticLMData(**kw), JaxData(**kw)
    assert mine.local_batch == ref.local_batch
    for step in (0, 1, 2, 17, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), (step, key)


def test_data_host_slices_partition_the_batch_and_refuse_a_ragged_split():
    parts = [SyntheticLMData(vocab_size=64, seq_len=16, global_batch=8,
                             process_index=i, process_count=4)
             for i in range(4)]
    assert all(p.local_batch == 2 for p in parts)
    b = parts[0].batch_at(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()
    with pytest.raises(ValueError):
        SyntheticLMData(vocab_size=64, seq_len=16, global_batch=6,
                        process_count=4)


# ---------------------------------------------------------- checkpoints
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((8, 16))).float(),
        "nested": {
            "b": torch.from_numpy(rng.standard_normal((4, 3))).bfloat16(),
            "step": torch.tensor(7, dtype=torch.int32)},
        "layers": [torch.from_numpy(rng.standard_normal((5,))).float()],
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_checkpoint_roundtrip_bit_for_bit(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(5, t, extra={"note": "x"})
    step, restored = mgr.restore_latest(_tree(1), device="cpu")
    assert step == 5
    got, want = dict(leaves_with_paths(restored)), dict(leaves_with_paths(t))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape
        np.testing.assert_array_equal(_bits(got[path]), _bits(w))
    with open(tmp_path / "step_000000005" / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert manifest["extra"] == {"note": "x"}
    assert manifest["leaves"]["nested/b"]["dtype"] == "bfloat16"


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(os.listdir(tmp_path))
    assert [d for d in kept if d.startswith("step_")] == [
        "step_000000003", "step_000000004"]
    assert mgr.restore_latest(_tree(), device="cpu")[0] == 4
    assert latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    want = t["a"].clone()
    mgr.save(9, t, blocking=False)
    t["a"].add_(1.0)      # the snapshot was taken when save returned
    mgr.wait()
    assert latest_step(str(tmp_path)) == 9
    restored = mgr.restore(9, t, device="cpu")
    np.testing.assert_array_equal(restored["a"].numpy(), want.numpy())


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    os.makedirs(tmp_path / "step_000000002.tmp")   # an interrupted save
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_restore_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="cuda"):
        mgr.restore(1, _tree())


# -------------------------------------------------------------- elastic
def test_watchdog_detects_stragglers(tmp_path):
    wd = Watchdog(str(tmp_path), timeout_s=0.5, dead_after=2)
    wd.beat("w0", 10)
    wd.beat("w1", 10)
    st = wd.status()
    assert not st["w0"]["straggler"] and st["w0"]["step"] == 10
    st = wd.status(now=time.time() + 0.6)
    assert st["w0"]["straggler"] and not st["w0"]["dead"]
    st = wd.status(now=time.time() + 2.0)
    assert st["w1"]["dead"]
    assert sorted(wd.live_workers(now=time.time() + 0.6)) == ["w0", "w1"]
    assert wd.live_workers(now=time.time() + 2.0) == []


def test_step_timer_flags_slow_steps():
    t = StepTimer(threshold=2.0)
    for _ in range(5):
        assert not t.observe(1.0)
    assert t.observe(5.0)  # straggler step
    assert t.slow_steps == 1
    assert abs(t.ema - 1.0) < 1e-6  # slow steps don't poison the EMA
