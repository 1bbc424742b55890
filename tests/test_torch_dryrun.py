"""The port's abstract cell specs (``launch/steps.cell_lowering_inputs``)
and dry-run command line (``launch/dryrun.main``) against the
reference's.

The reference's ``cell_lowering_inputs`` runs once, in a subprocess with
4 forced host devices, for every runnable cell on ``(1, n)`` meshes of
``AxisType.Auto`` axes under ``jax.set_mesh`` (the installed jax gives
``jax.make_mesh`` Explicit axes by default, under which the reference's
steps raise), n = 2 and 4, by ``jax.eval_shape`` only; and it compiles
three cells at ``(1, 4)`` for their ``memory_analysis()``. Here:

* leaf by leaf, each argument's global shape and dtype and a rank's
  shape (the reference's ``sharding.shard_shape``; a stacked reference
  leaf holds the port's layers that ``weights.reference_leaf`` maps to
  it, its stacked axis whole), the policy and the donated arguments; the
  one named difference is C17's ``unembed`` under ``tp_sp``;
* a rank's argument bytes against the reference's compiled
  ``argument_size_in_bytes`` in mamba2-130m decode_32k, qwen3-1.7b
  prefill_32k and train_4k, equal but for the one stated gap: the
  decode step's int32 ``pos`` scalar (4 bytes), which the reference's
  compiled arguments leave out and the port's step takes as a host int;
* on a CPU smoke step, the donated arguments are written in place (but
  AdamW's int32 step count, which the train step returns anew) and the
  others left as they were;
* ``main`` in its abstract mode over every cell of two archs, skip and
  failure records included, and ``--run`` at degrees 1 and 2 on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeCell,
    all_cells,
    get_arch,
    get_smoke,
)
from repro_torch.launch import dryrun
from repro_torch.launch.steps import argument_bytes, cell_lowering_inputs
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map
from repro_torch.weights import reference_leaf

REPO = Path(__file__).resolve().parents[1]
DEGREES = (2, 4)
CELLS = [(a, s) for a, s, ok, _ in all_cells() if ok]
MEMORY_CELLS = (("mamba2-130m", "decode_32k"), ("qwen3-1.7b", "prefill_32k"),
                ("qwen3-1.7b", "train_4k"))
# The one input whose dtype the port's step takes otherwise: a decode
# step's position, an int32 scalar in the specs (the reference's), a host
# int in ``transformer.decode_step``. Its bytes, by the argument's index.
HOST_INT = {"decode": (3, 4)}

REFERENCE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.configs import SHAPES, all_cells
    from repro.distributed.ctx import sharding_policy
    from repro.launch.steps import cell_lowering_inputs

    def mesh(n):
        return jax.make_mesh((1, n), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])

    def leaves(tree):
        out = []
        for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in kp)
            out.append([path, list(s.shape), str(s.dtype),
                        list(s.sharding.shard_shape(s.shape))])
        return out

    res = {"cells": {}, "memory": {}}
    for n in (2, 4):
        m = mesh(n)
        with jax.set_mesh(m):
            for arch, shape, ok, _ in all_cells():
                if ok:
                    _, args, donate, policy = cell_lowering_inputs(
                        arch, SHAPES[shape], m)
                    res["cells"][f"{arch}|{shape}|{n}"] = {
                        "policy": policy, "donate": list(donate),
                        "args": [leaves(a) for a in args]}
    m = mesh(4)
    for arch, shape in json.loads(sys.argv[2]):
        step, args, donate, policy = cell_lowering_inputs(
            arch, SHAPES[shape], m)
        with jax.set_mesh(m), sharding_policy(m, policy):
            c = jax.jit(step, donate_argnums=donate).lower(*args).compile()
        res["memory"][f"{arch}|{shape}"] = int(
            c.memory_analysis().argument_size_in_bytes)
    json.dump(res, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out),
         json.dumps(MEMORY_CELLS)], capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": str(REPO / "src"),
                          "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(out.read_text())


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _stacked(path: str) -> bool:
    """A reference leaf that stacks layers on its axis 0."""
    return bool({"units", "encoder"} & set(path.split("/")))


@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_the_references_leaf_by_leaf(reference, arch, shape,
                                                 degree):
    ref = reference["cells"][f"{arch}|{shape}|{degree}"]
    cfg = get_arch(arch)
    _, args, donate, policy = cell_lowering_inputs(arch, SHAPES[shape],
                                                   degree)
    assert (policy, list(donate)) == (ref["policy"], ref["donate"])
    assert len(args) == len(ref["args"])
    for arg, ref_leaves in zip(args, ref["args"]):
        want = {path: (shape_, dt, shard)
                for path, shape_, dt, shard in ref_leaves}
        groups: dict[str, list] = {}
        rank = dict(leaves_with_paths(arg.rank))
        for path, leaf in leaves_with_paths(arg.whole):
            groups.setdefault(reference_leaf(path, cfg), []).append(
                (path, leaf, rank[path]))
        assert set(groups) == set(want)
        for ref_path, mine in groups.items():
            shape_, dt, shard = want[ref_path]
            count = len(mine) if _stacked(ref_path) else None
            if count is not None:       # the stacked axis is whole
                assert shape_[0] == shard[0] == count, ref_path
                shape_, shard = shape_[1:], shard[1:]
            for path, leaf, block in mine:
                assert (list(leaf.shape), _dtype(leaf)) == (shape_, dt), path
                assert _dtype(block) == dt
                if path.endswith("unembed") and policy == "tp_sp":
                    # C17: the port splits the vocabulary columns, the
                    # reference's embed$ rule the d_model rows
                    d, v = leaf.shape
                    assert shard == [d // degree if d % degree == 0 else d,
                                     v], path
                    assert list(block.shape) == [
                        d, v // degree if v % degree == 0 else v], path
                    continue
                assert list(block.shape) == shard, (path, block.shape, shard)


@pytest.mark.parametrize("arch,shape", MEMORY_CELLS)
def test_argument_bytes_are_the_references_compiled_arguments(
        reference, arch, shape):
    cell = SHAPES[shape]
    _, args, _, _ = cell_lowering_inputs(arch, cell, 4)
    sizes = argument_bytes(args)
    gap = 0
    if cell.kind in HOST_INT:
        index, nbytes = HOST_INT[cell.kind]
        assert sizes[index] == nbytes == args[index].rank.element_size()
        gap = nbytes
    assert sum(sizes) == reference["memory"][f"{arch}|{shape}"] + gap
    rec = dryrun.abstract_cell(arch, shape, 4)
    assert rec["memory"]["argument_size_in_bytes"] == sum(sizes)
    assert sum(rec["memory"]["argument_bytes_by_part"].values()) == sum(sizes)


def _real(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    if t.dtype == torch.int32:
        return torch.randint(0, 50, t.shape, dtype=t.dtype, generator=gen)
    return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m",
                                  "whisper-large-v3"])
def test_donated_arguments_are_written_in_place(arch, kind):
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    cell = ShapeCell(kind, 16, 2, kind)
    step, args, donate, _ = cell_lowering_inputs(get_smoke(arch), cell, 1)
    vals = [tree_map(lambda t: _real(t, gen), a.rank) for a in args]
    if kind in HOST_INT:
        vals[HOST_INT[kind][0]] = 8          # the port's host int
    before = [tree_map(torch.clone, v) if isinstance(v, (dict, list))
              else v for v in vals]
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad:
        out = step(*vals)
    for i, (v, old) in enumerate(zip(vals, before)):
        if not isinstance(v, (dict, list)):
            continue
        changed = [not torch.equal(a.detach(), b)
                   for a, b in zip(tree_leaves(v), tree_leaves(old))]
        assert any(changed) == (i in donate), (i, donate)
    for i in donate:                    # the step returns the same tensors
        returned = out[i] if kind == "train" else out[1]
        for (path, a), b in zip(leaves_with_paths(returned),
                                tree_leaves(vals[i])):
            if path == "step":          # AdamW's count, returned anew
                assert int(a) == int(b) + 1 and a.dtype == torch.int32
                continue
            assert a is b, path


def _records(out: Path, degree: int) -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in (out / f"deg{degree}").glob("*.json")}


def test_main_writes_every_cells_record(tmp_path, capsys, monkeypatch):
    for arch in ("mamba2-130m", "qwen3-1.7b"):
        assert dryrun.main(["--arch", arch, "--out", str(tmp_path)]) == 0
    recs = _records(tmp_path, 4)
    assert set(recs) == {f"{a}__{s}" for a in ("mamba2-130m", "qwen3-1.7b")
                         for s in SHAPES}
    skip = recs["qwen3-1.7b__long_500k"]
    assert skip["skipped"] and not skip["ok"] and "sub-quadratic" in \
        skip["reason"]
    rec = recs["mamba2-130m__decode_32k"]
    assert rec["ok"] and rec["mesh"] == "deg4" and rec["policy"] == "tp_sp"
    assert rec["memory"]["argument_size_in_bytes"] == 741_867_780
    assert rec["memory"]["temp_size_in_bytes"] == "not measured"
    assert rec["collectives"] == "not measured"
    assert rec["fits_device_memory"] == "not measured"   # no card here
    text = capsys.readouterr().out
    assert "[skip] deg4 qwen3-1.7b long_500k" in text
    assert "dryrun done: ok=3 fail=0 skip=1" in text

    real = dryrun.abstract_cell

    def failing(arch, shape, degree, **kw):
        if shape == "prefill_32k":
            raise ValueError("planted")
        return real(arch, shape, degree, **kw)

    monkeypatch.setattr(dryrun, "abstract_cell", failing)
    assert dryrun.main(["--arch", "qwen3-1.7b", "--degree", "2", "--out",
                        str(tmp_path)]) == 1
    fail = _records(tmp_path, 2)["qwen3-1.7b__prefill_32k"]
    assert fail == {"arch": "qwen3-1.7b", "shape": "prefill_32k",
                    "mesh": "deg2", "ok": False,
                    "error": "ValueError('planted')"}
    assert "dryrun done: ok=2 fail=1 skip=1" in capsys.readouterr().out


@pytest.mark.parametrize("degree", [1, 2])
def test_main_runs_a_cut_cell_on_the_cpu(tmp_path, degree):
    assert dryrun.main(["--run", "--device", "cpu", "--arch", "mamba2-130m",
                        "--shape", "decode_32k", "--degree", str(degree),
                        "--batch", "1", "--layers", "2", "--out",
                        str(tmp_path)]) == 0
    rec = _records(tmp_path, degree)["mamba2-130m__decode_32k"]
    assert rec["ok"] and rec["degree"] == degree and rec["batch"] == 1
    assert rec["reduced"] == {"num_layers": [24, 2],
                              "global_batch": [128, 1]}
    assert rec["step_device_ms"] == "not measured"
    if degree > 1:
        assert rec["backend"] == "gloo" and len(rec["ranks"]) == degree
        assert rec["sent_bytes"]["gather"] > 0


def test_every_arch_has_cells():
    assert {a for a, _ in CELLS} == set(ARCH_IDS)
