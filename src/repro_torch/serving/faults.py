"""Fault injection and pool auditing for the serving engines.

Port of ``repro/serving/faults.py``. The engines consult a
``FaultInjector`` at their decision points (step start, page append,
admission, the finite-logit flags of a step) through no-op hooks, so the
default hot path pays one attribute lookup per site.
Two injectors place faults:

* ``ScriptedFaults`` — exact placement: pool exhaustion at the k-th
  append (or engine step), a NaN-guard trip at (step, slot), the first N
  admission attempts rejected, a sleep at chosen steps, and a per-step
  callback (tests cancel requests mid-decode with it);
* ``SeededFaults`` — Bernoulli faults from one seeded generator, so a
  chaos run replays exactly from its seed.

``PoolAuditor`` re-derives the page accounting from scratch after every
engine step (the free list, the per-slot mappings and the prefix index
partition the pool with a shared page counted once, page refcounts equal
the references re-derived from the tables and the index, no duplicates,
lengths within capacity, engine positions equal ``kv_lens``) and raises
``PoolAuditError`` on the first violation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping

import numpy as np

from repro_torch.serving.paged_cache import SCRATCH_PAGE, PagedKVCacheManager


class PoolAuditError(RuntimeError):
    """A page-pool invariant violated after an engine step."""


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


@dataclasses.dataclass
class ScriptedFaults(FaultInjector):
    """Exactly placed faults for parity and regression tests.

    ``exhaust_at_appends`` indexes the global append counter: appends
    happen only for live decode slots, so a scripted index always lands on
    a running sequence (a step index may fall on a prefill-only step).
    """

    exhaust_at_appends: frozenset[int] = frozenset()
    exhaust_at_steps: frozenset[int] = frozenset()
    nan_at: frozenset[tuple[int, int]] = frozenset()   # (step, slot)
    reject_admits: int = 0                             # first N attempts
    slow_steps: Mapping[int, float] | None = None      # step -> seconds
    on_step: Callable[[object, int], None] | None = None
    _admits_seen: int = dataclasses.field(default=0, repr=False)

    def step_begin(self, engine, step: int) -> None:
        if self.slow_steps and step in self.slow_steps:
            time.sleep(self.slow_steps[step])
        if self.on_step is not None:
            self.on_step(engine, step)

    def alloc_fault(self, step: int, n_append: int, slot: int) -> bool:
        return (n_append in self.exhaust_at_appends
                or step in self.exhaust_at_steps)

    def admit_fault(self, step: int, rid: int) -> bool:
        self._admits_seen += 1
        return self._admits_seen <= self.reject_admits

    def corrupt_step_ok(self, step: int, ok: np.ndarray) -> np.ndarray:
        if not self.nan_at:
            return ok
        ok = ok.copy()
        for s, slot in self.nan_at:
            if s == step and slot < len(ok):
                ok[slot] = False
        return ok


class SeededFaults(FaultInjector):
    """Bernoulli faults from one seeded generator: the whole chaos run
    replays bit for bit from the seed."""

    def __init__(self, seed: int, *, p_exhaust: float = 0.0,
                 p_nan: float = 0.0, p_reject: float = 0.0):
        self.rng = np.random.default_rng(seed)
        self.p_exhaust = p_exhaust
        self.p_nan = p_nan
        self.p_reject = p_reject

    def alloc_fault(self, step: int, n_append: int, slot: int) -> bool:
        return self.p_exhaust > 0 and self.rng.random() < self.p_exhaust

    def admit_fault(self, step: int, rid: int) -> bool:
        return self.p_reject > 0 and self.rng.random() < self.p_reject

    def corrupt_step_ok(self, step: int, ok: np.ndarray) -> np.ndarray:
        if self.p_nan <= 0:
            return ok
        flips = self.rng.random(len(ok)) < self.p_nan
        return ok & ~flips


class PoolAuditor:
    """Re-derives the page accounting from scratch after every step."""

    def __init__(self):
        self.steps_checked = 0

    def check(self, mgr: PagedKVCacheManager, *,
              expected_lens: Mapping[int, int] | None = None) -> None:
        free = mgr.free_pages()
        owned = mgr.owned_pages()
        cached = mgr.cached_pages()
        if len(set(free)) != len(free):
            dup = sorted(p for p in set(free) if free.count(p) > 1)
            raise PoolAuditError(f"free list holds duplicates: {dup}")
        # every page's references, re-derived from the tables and the
        # index: once for each slot mapping it, once more if the index
        # retains it
        derived: dict[int, int] = {}
        for slot, pages in owned.items():
            in_slot: set[int] = set()
            for p in pages:
                if p == SCRATCH_PAGE or not 0 < p < mgr.num_pages:
                    raise PoolAuditError(
                        f"slot {slot} owns invalid page id {p}")
                if p in in_slot:
                    raise PoolAuditError(
                        f"page {p} mapped twice by slot {slot}")
                in_slot.add(p)
                derived[p] = derived.get(p, 0) + 1
        for p in cached:
            if p == SCRATCH_PAGE or not 0 < p < mgr.num_pages:
                raise PoolAuditError(f"prefix index holds invalid page {p}")
            derived[p] = derived.get(p, 0) + 1
        used = set(derived)  # a shared page counts once in occupancy
        both = set(free) & used
        if both:
            raise PoolAuditError(
                f"pages both free and owned (leaked free): {sorted(both)}")
        total = len(free) + len(used)
        if total != mgr.num_pages - 1:
            raise PoolAuditError(
                f"page leak: free {len(free)} + in-use {len(used)} = "
                f"{total} != pool {mgr.num_pages - 1}")
        refs = mgr.page_refs()
        if refs != derived:
            bad = {p: (refs.get(p), derived.get(p))
                   for p in set(refs) | set(derived)
                   if refs.get(p) != derived.get(p)}
            raise PoolAuditError(
                f"refcounts disagree with re-derived references "
                f"(page: recorded, derived): {bad}")
        mgr.prefix_integrity_check()
        lens = mgr.kv_lens()
        for slot, pages in owned.items():
            n = int(lens[slot])
            if not 0 <= n <= len(pages) * mgr.page_size:
                raise PoolAuditError(
                    f"slot {slot} kv_len {n} outside its {len(pages)}-page"
                    f" capacity")
            if len(pages) > mgr.max_pages_per_seq:
                raise PoolAuditError(
                    f"slot {slot} owns {len(pages)} pages > "
                    f"max_pages_per_seq {mgr.max_pages_per_seq}")
        table = mgr.table()
        for slot, pages in owned.items():
            if list(table[slot, :len(pages)]) != pages:
                raise PoolAuditError(
                    f"table row {slot} disagrees with owned pages")
            if not (table[slot, len(pages):] == SCRATCH_PAGE).all():
                raise PoolAuditError(
                    f"table row {slot} tail not scratch-padded")
        if expected_lens is not None:
            for slot, want in expected_lens.items():
                if slot not in owned:
                    raise PoolAuditError(
                        f"live slot {slot} has no pages in the pool")
                if int(lens[slot]) != want:
                    raise PoolAuditError(
                        f"slot {slot} kv_len {int(lens[slot])} != engine "
                        f"position {want}")
        self.steps_checked += 1

    def final_check(self, mgr: PagedKVCacheManager) -> None:
        """After serve() drains: no sequence may still hold pages, and what
        is not on the free list must be exactly the retained prefixes, each
        held by the index alone (refcount 1) and within the cache reserve.
        With the prefix cache off, the whole pool is back on the free
        list."""
        self.check(mgr)
        if mgr.owned_pages():
            raise PoolAuditError(
                f"live sequences survived the drain: {mgr.owned_pages()}")
        cached = mgr.cached_pages()
        if mgr.pages_used != len(cached):
            raise PoolAuditError(
                f"{mgr.pages_used - len(cached)} pages leaked after drain "
                f"beyond the {len(cached)} cached-prefix pages")
        hot = {p: c for p, c in mgr.page_refs().items() if c != 1}
        if hot:
            raise PoolAuditError(
                f"drained pool holds pages with refcount != 1: {hot}")
        if mgr.prefix_cache and len(cached) > mgr.reserve_pages:
            raise PoolAuditError(
                f"index retains {len(cached)} pages > cache reserve "
                f"{mgr.reserve_pages}")
