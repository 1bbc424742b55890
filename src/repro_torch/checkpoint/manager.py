"""Sharded, atomic, optionally asynchronous checkpoints of a tree of
tensors, with restore onto another number of ranks.

Port of ``repro/checkpoint/manager.py`` on the reference's layout (one
directory per step):

    <dir>/step_000000123/
        MANIFEST.json            # leaf paths, shapes, dtypes, shard map
        <md5(path)[:16]>.s<k>.npy  # one file per shard of a leaf

A leaf's path is its keys and list indices joined by "/" (``tree.py``).
bf16 leaves are stored as their raw bytes (numpy has no bf16) and
rebuilt from them bit for bit.

One process (``rank=0, degree=1``) writes every leaf whole as ``.s0``.
Across the ranks of an ``fsdp`` group each rank writes only its blocks:
``save(..., shardings=)`` takes a tree of ``(dim, rank, degree)`` per
leaf (``sharding.fsdp_blocks``: the rank's block of ``dim``) or None
(whole: rank 0 writes it), and the manifest lists every shard's
``[[start, stop], ...]`` index, file ``.s<k>`` the k-th, so the
reference's ``restore`` reads it. A save writes into ``step_x.tmp<k>``
(k counts the manager's saves, alike on every rank); each rank marks its
files done there (``done.r<rank>``), and rank 0's writer
waits for every rank's mark, writes the manifest and renames the
directory, so ``latest_step`` never sees a half-written step. No
collective runs in a save: the writers are threads
(``save(..., blocking=False)`` copies the blocks to host memory first
and writes them on a thread, keeping the train loop off the disk), and
the marks are files. Rank 0 alone removes the oldest steps past
``keep``, and, when it opens the directory, the ``.tmp`` directories an
interrupted save left: the caller puts a collective (a barrier, or a
train step) between every rank's opening and any rank's first save.

``restore(step, target, device=, shardings=)`` rebuilds each leaf from
its shard files and keeps the block ``shardings`` names for it, at any
degree (a dim the degree does not divide stays whole, as ``fit_dim`` has
it), or the whole leaf without ``shardings``; it reads only the shard
files that overlap the block.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map_with_path

# torch dtypes numpy holds, by the name the manifest records (numpy's);
# bfloat16 travels as raw bytes
_NUMPY = {torch.float32: "float32", torch.float16: "float16",
          torch.int64: "int64", torch.int32: "int32", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool",
          torch.bfloat16: "bfloat16"}
_TORCH = {v: k for k, v in _NUMPY.items()}
# how long rank 0's writer waits for the other ranks' marks
MARK_TIMEOUT_S = 600.0


def _fname(path: str) -> str:
    return hashlib.md5(path.encode()).hexdigest()[:16]


def _done(name: str) -> bool:
    """A finished step's directory (not a save's ``.tmp`` one)."""
    return name.startswith("step_") and ".tmp" not in name


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if _done(d):
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


def _from_numpy(data: np.ndarray, meta: dict) -> torch.Tensor:
    """A leaf's whole value on the host, in its saved dtype and shape."""
    dt = _TORCH[meta["dtype"]]
    t = torch.from_numpy(np.ascontiguousarray(data))
    if dt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(meta["shape"])


def _fitted(block, shape) -> tuple | None:
    """``block`` (dim, rank, degree) where ``degree`` divides the dim of
    ``shape``, else None (whole)."""
    if block is None:
        return None
    dim, _, degree = block
    if dim >= len(shape) or shape[dim] % degree:
        return None
    return block


def _index(block, shape) -> list:
    """[[start, stop], ...] of a block (dim, rank, degree) of ``shape``."""
    idx = [[0, n] for n in shape]
    if block is not None:
        dim, rank, degree = block
        per = shape[dim] // degree
        idx[dim] = [rank * per, (rank + 1) * per]
    return idx


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, rank: int = 0,
                 degree: int = 1):
        if not 0 <= rank < degree:
            raise ValueError(f"rank {rank} is not in a group of {degree}")
        self.dir = directory
        self.keep = keep
        self.rank, self.degree = rank, degree
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)
        if rank == 0:
            for d in os.listdir(directory):
                if d.startswith("step_") and ".tmp" in d:
                    shutil.rmtree(os.path.join(directory, d),
                                  ignore_errors=True)
        self._thread: threading.Thread | None = None
        self._saves = 0

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True,
             extra: dict | None = None, shardings=None):
        """Write this rank's part of ``tree`` as step ``step``: with
        ``shardings`` (a tree of (dim, rank, degree) or None a leaf, the
        rank and degree this manager's) its block of each split leaf and,
        on rank 0, every whole leaf; without, every leaf whole (one
        process)."""
        self.wait()  # never let two writers race on the same step dir
        blocks = ([None] * len(leaves_with_paths(tree)) if shardings is None
                  else tree_leaves(shardings))
        records, manifest = [], {"step": step, "leaves": {},
                                 "extra": extra or {}}
        for (path, leaf), block in zip(leaves_with_paths(tree), blocks,
                                       strict=True):
            if leaf.dtype not in _NUMPY:
                raise TypeError(f"{path}: cannot store {leaf.dtype}")
            shape = list(leaf.shape)
            if block is not None:
                dim, rank, degree = block
                if (rank, degree) != (self.rank, self.degree):
                    raise ValueError(f"{path}: block of rank {rank} of "
                                     f"{degree} saved by rank {self.rank} "
                                     f"of {self.degree}")
                shape[dim] *= degree
                block = _fitted(block, shape)
                if block is None:
                    raise ValueError(f"{path}: {degree} ranks do not split "
                                     f"dim {dim} of {shape}")
            h = _fname(path)
            manifest["leaves"][path] = {
                "shape": shape, "dtype": _NUMPY[leaf.dtype], "file": h,
                "shards": ([_index(None, shape)] if block is None else
                           [_index((block[0], r, self.degree), shape)
                            for r in range(self.degree)])}
            if block is not None or self.rank == 0:
                k = 0 if block is None else self.rank
                records.append((f"{h}.s{k}.npy", _to_numpy(leaf)))

        self._saves += 1
        # every rank counts its saves alike: a save's own directory, so a
        # rank's next save of the same step never lands in this one
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp{self._saves}")

        def write():
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for name, data in records:
                np.save(os.path.join(tmp, name), data)
            with open(os.path.join(tmp, f"done.r{self.rank}"), "w"):
                pass
            if self.rank != 0:
                return
            self._wait_marks(tmp)
            for r in range(self.degree):
                os.remove(os.path.join(tmp, f"done.r{r}"))
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            return
        self._error = None

        def run():
            try:
                write()
            except BaseException as exc:     # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _wait_marks(self, tmp: str) -> None:
        """Until every rank's ``done.r<rank>`` stands in ``tmp``."""
        marks = [os.path.join(tmp, f"done.r{r}") for r in range(self.degree)]
        deadline = time.monotonic() + MARK_TIMEOUT_S
        while missing := [r for r, m in enumerate(marks)
                          if not os.path.exists(m)]:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{tmp}: ranks {missing} never marked "
                                   f"their shards done")
            time.sleep(0.01)

    def wait(self):
        """Until the last ``save(blocking=False)`` has written this rank's
        files (on rank 0: the whole step); its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._error is not None:
                raise self._error

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if _done(d))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d))

    # ---------------------------------------------------------- restore
    def restore(self, step: int, target_tree, *, device="cuda",
                shardings=None):
        """A tree shaped like ``target_tree`` (whose leaves only name the
        paths) rebuilt from step ``step`` on ``device``, each leaf in the
        dtype it was saved with: whole, or with ``shardings`` (a tree
        shaped like the target of (dim, rank, degree) or None a leaf) cut
        to that rank's block of ``dim`` where ``degree`` divides it."""
        dev = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            leaves = json.load(f)["leaves"]
        blocks = (None if shardings is None
                  else dict(leaves_with_paths(shardings)))

        def load(path, _):
            meta = leaves[path]
            shape = meta["shape"]
            block = None if blocks is None else _fitted(blocks[path], shape)
            want = _index(block, shape)     # the rows this rank keeps
            out = None
            for k, idx in enumerate(meta["shards"]):
                cut = [[max(a, c), min(b, e)]
                       for (a, b), (c, e) in zip(idx, want)]
                if any(a >= b for a, b in cut) and shape:
                    continue                # a shard outside the block
                part = _from_numpy(np.load(os.path.join(
                    d, f"{meta['file']}.s{k}.npy")), {**meta, "shape": [
                        b - a for a, b in idx]})
                if out is None:
                    out = torch.empty([b - a for a, b in want],
                                      dtype=part.dtype)
                out[tuple(slice(a - c, b - c) for (a, b), (c, _) in
                          zip(cut, want))] = part[tuple(
                              slice(a - c, b - c) for (a, b), (c, _) in
                              zip(cut, idx))]
            return out.to(dev, copy=True)

        return tree_map_with_path(load, target_tree)

    def restore_latest(self, target_tree, *, device="cuda", shardings=None):
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device=device,
                                  shardings=shardings)
