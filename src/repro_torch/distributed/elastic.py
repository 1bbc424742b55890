"""Straggler and failure detection on the host.

Port of ``StepTimer`` and ``Watchdog`` from ``repro/distributed/
elastic.py`` (``plan_remesh``, the degraded-mesh planner, comes with
multi-GPU training). Every worker writes a heartbeat file a step;
``Watchdog.status`` marks a worker a straggler after ``timeout_s`` and
dead after ``dead_after`` missed beats. ``StepTimer`` flags a step slower
than ``threshold`` times the EMA of the steps before it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time


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
