"""Elastic scaling, and straggler and failure detection on the host.

Port of ``repro/distributed/elastic.py``. ``plan_remesh`` maps a
degraded device count onto the best available (data, model) grid (model
parallelism preserved first: TP shards hold unique weight slices; data
ranks are interchangeable). A checkpoint restores onto the new grid
through ``CheckpointManager.restore(..., shardings=)``, which rebuilds
each leaf from the saved shards and cuts the new rank's block at any
degree (``sharding.fsdp_blocks``). Every worker writes a heartbeat file
a step; ``Watchdog.status`` marks a worker a straggler after
``timeout_s`` and dead after ``dead_after`` missed beats. ``StepTimer``
flags a step slower than ``threshold`` times the EMA of the steps before
it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


def plan_remesh(n_devices: int, *, prefer_model: int = 16,
                multi_pod_threshold: int = 512) -> dict:
    """Largest usable (pod, data, model) grid for ``n_devices``."""
    model = prefer_model
    while model > 1 and n_devices % model:
        model //= 2
    rest = n_devices // model
    if n_devices >= multi_pod_threshold and rest % 2 == 0:
        return {"axes": ("pod", "data", "model"),
                "shape": (2, rest // 2, model),
                "devices_used": n_devices}
    return {"axes": ("data", "model"), "shape": (rest, model),
            "devices_used": rest * model}


@dataclasses.dataclass
class Watchdog:
    directory: str
    timeout_s: float = 60.0
    dead_after: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, worker: str) -> str:
        return os.path.join(self.directory, f"hb_{worker}.json")

    def beat(self, worker: str, step: int):
        tmp = self._path(worker) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)
        os.replace(tmp, self._path(worker))

    def status(self, now: float | None = None) -> dict[str, dict]:
        now = time.time() if now is None else now
        out = {}
        for fn in os.listdir(self.directory):
            if not (fn.startswith("hb_") and fn.endswith(".json")):
                continue
            with open(os.path.join(self.directory, fn)) as f:
                hb = json.load(f)
            age = now - hb["t"]
            out[fn[3:-5]] = {
                "step": hb["step"],
                "age_s": age,
                "straggler": age > self.timeout_s,
                "dead": age > self.timeout_s * self.dead_after,
            }
        return out

    def live_workers(self, now: float | None = None) -> list[str]:
        return [w for w, s in self.status(now).items() if not s["dead"]]


@dataclasses.dataclass
class StepTimer:
    """In-process straggler detection: flags steps slower than
    ``threshold`` x the EMA of previous steps."""

    ema: float | None = None
    alpha: float = 0.1
    threshold: float = 2.0
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        if slow:
            self.slow_steps += 1
        else:
            self.ema = dt if self.ema is None else (
                (1 - self.alpha) * self.ema + self.alpha * dt
            )
        return slow
