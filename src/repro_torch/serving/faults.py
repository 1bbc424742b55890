"""Fault-injection hooks for the serving engine.

The engine consults a ``FaultInjector`` at its decision points through
no-op hooks, so the default hot path pays one attribute lookup per site.
This slice carries the no-op base class only; the scripted and seeded
injectors and the page-pool auditor belong to the paged engine.
"""

from __future__ import annotations

import numpy as np


class FaultInjector:
    """No-op default: every hook says 'no fault'. Subclass and override
    the decision points you want to perturb; keep every override
    deterministic (seed or script) so failures replay exactly."""

    def step_begin(self, engine, step: int) -> None:
        """Called at the top of every engine step (slow-step stalls,
        scripted cancellations)."""

    def alloc_fault(self, step: int, n_append: int, slot: int) -> bool:
        """True -> the engine treats this append as pool exhaustion
        (``n_append`` counts appends globally across the serve call)."""
        return False

    def admit_fault(self, step: int, rid: int) -> bool:
        """True -> this admission attempt is rejected (backpressure:
        the request stays queued and retries next step)."""
        return False

    def corrupt_step_ok(self, step: int, ok: np.ndarray) -> np.ndarray:
        """Perturb the per-slot finite-logit flags of one step (the NaN
        guard's view); flip entries False to simulate NaN/inf logits."""
        return ok


NO_FAULTS = FaultInjector()
