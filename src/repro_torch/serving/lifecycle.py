"""Per-request lifecycle for the serving engines (DESIGN.md §7).

Every request travels a small state machine::

    QUEUED -> PREFILLING -> DECODING -> FINISHED
       |           |            |
       |           +--------+---+-----> PREEMPTED -> QUEUED (requeued)
       +---------------> CANCELLED / FAILED  (terminal, any live state)

``RequestRecord`` owns the transition table (illegal moves raise
``LifecycleError`` — a scheduler bug, not a serving condition) plus the
token/accounting state a request drags through preemption: generated
tokens survive eviction, so recompute admission re-prefills
``prompt + tokens`` and greedy determinism guarantees the continuation
is token-for-token identical to an uncontended run.

``validate_request`` is the admission gate both engines share: a
malformed request (empty prompt, budget past the cache horizon) becomes
one FAILED result instead of an exception that kills the whole wave.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class LifecycleError(RuntimeError):
    """An illegal request-state transition (scheduler bug)."""


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"
    PREEMPTED = "preempted"


TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.CANCELLED, RequestState.FAILED,
})

# FINISHED from QUEUED covers zero-budget requests (nothing to generate);
# PREEMPTED is transient: the victim is requeued (-> QUEUED) in the same
# scheduler step that evicted it.
_ALLOWED = {
    RequestState.QUEUED: {
        RequestState.PREFILLING, RequestState.FINISHED,
        RequestState.CANCELLED, RequestState.FAILED,
    },
    RequestState.PREFILLING: {
        RequestState.DECODING, RequestState.FINISHED,
        RequestState.CANCELLED, RequestState.FAILED,
        RequestState.PREEMPTED,
    },
    RequestState.DECODING: {
        RequestState.FINISHED, RequestState.CANCELLED,
        RequestState.FAILED, RequestState.PREEMPTED,
    },
    RequestState.PREEMPTED: {
        RequestState.QUEUED, RequestState.CANCELLED, RequestState.FAILED,
    },
    RequestState.FINISHED: set(),
    RequestState.CANCELLED: set(),
    RequestState.FAILED: set(),
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int = 16
    eos_id: int = 2
    # wall-clock budget in seconds from serve() start; the scheduler
    # cancels the request (queued or live) once it expires
    deadline_s: float | None = None


@dataclasses.dataclass
class RequestRecord:
    """Scheduler-side view of one request across its whole lifetime."""

    request: Request
    state: RequestState = RequestState.QUEUED
    tokens: list[int] = dataclasses.field(default_factory=list)
    error: str | None = None
    preemptions: int = 0
    recompute_tokens: int = 0    # prompt+prefix tokens re-prefilled
    prefix_hit_tokens: int = 0   # prompt tokens served from shared pages
    admit_seq: int | None = None  # first-admission order (preemption age)
    # transition observer: called as (record, old_state, new_state) AFTER
    # every successful ``to()`` — how the engines drive per-request trace
    # spans off the state machine itself (DESIGN.md §8) instead of
    # sprinkling emit sites around the scheduler. None costs one truthy
    # check per transition.
    observer: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def remaining(self) -> int:
        """Decode budget left (against the ORIGINAL max_new_tokens —
        generated tokens survive preemption)."""
        return self.request.max_new_tokens - len(self.tokens)

    @property
    def resumed(self) -> bool:
        return self.preemptions > 0

    def resume_prompt(self) -> np.ndarray:
        """What (re-)admission prefills: the prompt plus every token
        already emitted, so the next token out of the last chunk's
        logits is exactly the continuation of the interrupted decode."""
        if not self.tokens:
            return self.request.prompt
        return np.concatenate([
            self.request.prompt,
            np.asarray(self.tokens, self.request.prompt.dtype),
        ])

    def to(self, new: RequestState) -> None:
        if new not in _ALLOWED[self.state]:
            raise LifecycleError(
                f"request {self.rid}: illegal transition "
                f"{self.state.value} -> {new.value}"
            )
        old, self.state = self.state, new
        if self.observer is not None:
            self.observer(self, old, new)

    def finish(self) -> None:
        self.to(RequestState.FINISHED)

    def cancel(self, reason: str = "cancelled") -> None:
        # reason is set BEFORE the transition so observers see it
        self.error = reason
        self.to(RequestState.CANCELLED)

    def fail(self, reason: str) -> None:
        self.error = reason
        self.to(RequestState.FAILED)


def validate_request(request: Request, *, max_len: int,
                     pool_pages: int | None = None,
                     page_size: int | None = None) -> str | None:
    """Admission-time validation shared by both engines.

    Returns an error string (-> FAILED result) or None. Checks are the
    conditions that would otherwise raise out of ``serve()`` mid-wave or
    silently corrupt the cache: an empty prompt, a prompt+decode budget
    past the cache horizon, or (paged engine) a budget even an empty
    pool could never hold.
    """
    plen = int(len(request.prompt))
    if plen == 0:
        return "empty prompt"
    budget = plen + max(0, request.max_new_tokens)
    if budget > max_len:
        return f"prompt+budget {budget} > max_len {max_len}"
    if pool_pages is not None and page_size is not None:
        need = -(-budget // page_size)
        if need > pool_pages:
            return (f"needs {need} pages > pool size {pool_pages}")
    return None
