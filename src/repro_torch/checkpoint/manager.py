"""Atomic, optionally asynchronous checkpoints of a tree of tensors.

Port of ``repro/checkpoint/manager.py`` for one process and one device,
on the reference's layout (one directory per step):

    <dir>/step_000000123/
        MANIFEST.json            # leaf paths, shapes, dtypes, shard map
        <md5(path)[:16]>.s0.npy  # one file per leaf

A leaf's path is its keys and list indices joined by "/" (``tree.py``).
bf16 leaves are stored as their raw bytes (numpy has no bf16) and
rebuilt from them bit for bit. A save writes ``step_x.tmp`` and renames
it, so an interrupted save never shadows a good one; the oldest steps
past ``keep`` are removed. ``save(..., blocking=False)`` copies the
tensors to host memory first and writes them on a thread, keeping the
train loop off the disk. ``restore(step, target, device=)`` rebuilds a
tree shaped like ``target`` on ``device``. Restoring onto another mesh
comes with multi-GPU training.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import leaves_with_paths, tree_map_with_path

# torch dtypes numpy holds, by the name the manifest records (numpy's);
# bfloat16 travels as raw bytes
_NUMPY = {torch.float32: "float32", torch.float16: "float16",
          torch.int64: "int64", torch.int32: "int32", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool",
          torch.bfloat16: "bfloat16"}
_TORCH = {v: k for k, v in _NUMPY.items()}


def _fname(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()[:16]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy on the CPU too: an async save writes
    the values of the save call); bf16 as its raw bytes (uint8)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.reshape(-1).view(torch.uint8).numpy()
    return t.numpy()


def _from_numpy(data: np.ndarray, meta: dict, device) -> torch.Tensor:
    dt = _TORCH[meta["dtype"]]
    t = torch.from_numpy(np.ascontiguousarray(data))
    if dt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(meta["shape"]).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True,
             extra: dict | None = None):
        self.wait()  # never let two writers race on the same step dir
        records = []
        for path, leaf in leaves_with_paths(tree):
            if leaf.dtype not in _NUMPY:
                raise TypeError(f"{path}: cannot store {leaf.dtype}")
            records.append((path, list(leaf.shape), _NUMPY[leaf.dtype],
                            _to_numpy(leaf)))

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": {}, "extra": extra or {}}
            for path, shape, dtype, data in records:
                h = _fname(path)
                manifest["leaves"][path] = {
                    "shape": shape, "dtype": dtype, "file": h,
                    "shards": [[[0, n] for n in shape]],
                }
                np.save(os.path.join(tmp, f"{h}.s0.npy"), data)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d))

    # ---------------------------------------------------------- restore
    def restore(self, step: int, target_tree, *, device="cuda"):
        """A tree shaped like ``target_tree`` (whose leaves only name the
        paths) rebuilt from step ``step`` on ``device``, each leaf in the
        dtype and shape it was saved with."""
        dev = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            leaves = json.load(f)["leaves"]

        def load(path, _):
            meta = leaves[path]
            data = np.load(os.path.join(d, f"{meta['file']}.s0.npy"))
            return _from_numpy(data, meta, dev)

        return tree_map_with_path(load, target_tree)

    def restore_latest(self, target_tree, *, device="cuda"):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device=device)
