"""Block-table KV-cache manager: fixed-size pages in a global pool.

Port of ``PagedKVCacheManager`` from ``repro/serving/paged_cache.py``,
without the shared-prefix index. Host-side bookkeeping for the paged
serving path; the device state it manages is split in two:

* the page *pools*, (Hkv, P, page, E) tensors per layer built by
  ``Model.make_cache(cache_layout="paged")``, which this module never
  touches;
* the page *table*, a (num_slots, max_pages) int32 array of physical
  page ids, one row per decode slot, which it owns and the engine hands
  to every paged step.

Page id 0 is a scratch page: empty table entries and idle decode slots
point at it, so masked or idle lanes of a batched step write and read
harmless bytes there instead of a live page. The free list is LIFO, so a
freed sequence's pages are reissued to the next admission, whose prefill
overwrites them. Pages carry refcounts, and ``release``/``free`` drop
them through one decrement path, so a double free or a free of a slot
never admitted is a typed ``PageAccountingError`` instead of a corrupt
free list.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCRATCH_PAGE = 0


def page_footprint_bytes(*, num_layers: int, num_kv_heads: int,
                         page_size: int, head_dim: int,
                         itemsize: int = 2) -> int:
    """Bytes one physical page pins across the whole layer stack: K and V
    values of ``itemsize`` bytes each, plus, for an int8 pool
    (``itemsize`` 1), the two fp32 per-page scales of K and V."""
    per_layer = 2 * num_kv_heads * page_size * head_dim * itemsize
    if itemsize == 1:
        per_layer += 2 * num_kv_heads * 4
    return num_layers * per_layer


class PagedCacheError(RuntimeError):
    """Base for paged-cache bookkeeping errors (typed, ``-O``-safe)."""


class PagePoolExhausted(PagedCacheError):
    """Raised when an alloc/append cannot be served from the free list."""


class PageAccountingError(PagedCacheError):
    """Refcount violation: double free, freeing a never-admitted slot, or
    admitting into an occupied slot."""


class PoolConfigError(PagedCacheError):
    """Raised when the pool is constructed with an unusable shape."""


@dataclasses.dataclass
class PagedSeq:
    pages: list[int]
    length: int  # live tokens (kv_len)

    @property
    def capacity(self) -> int:
        return len(self.pages)


class PagedKVCacheManager:
    """Per-sequence page tables over a global pool of ``num_pages``.

    Sequences are keyed by decode slot (0..num_slots-1). ``admit``
    allocates pages for a prompt plus an optional decode reservation,
    ``append`` extends a sequence one token (allocating a page on a
    boundary crossing past the reservation), ``ensure_capacity`` and
    ``append_n`` reserve and commit a speculative step's rows, ``release``
    returns its pages to the pool.
    """

    def __init__(self, num_pages: int, page_size: int, *, num_slots: int,
                 max_pages_per_seq: int, prefix_cache: bool = False):
        if prefix_cache:
            raise NotImplementedError(
                "the shared-prefix index is not ported yet")
        if num_pages <= 1:
            raise PoolConfigError(
                f"pool needs at least one page beyond scratch, got "
                f"num_pages={num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_seq = max_pages_per_seq
        # LIFO free list, scratch page 0 excluded
        self._free = list(range(num_pages - 1, 0, -1))
        self._seqs: dict[int, PagedSeq] = {}
        # page id -> live sequences mapping it
        self._ref: dict[int, int] = {}
        self.peak_pages_used = 0

    # -- pool accounting --
    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    # -- primitive alloc/free --
    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages off the free list, or raise
        ``PagePoolExhausted`` and take none."""
        if n > len(self._free):
            raise PagePoolExhausted(f"need {n} pages, {len(self._free)} free")
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            self._ref[p] = self._ref.get(p, 0) + 1
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return ids

    def _decref(self, page: int) -> None:
        """The one decrement path: drop a reference, free at zero."""
        c = self._ref.get(page)
        if c is None:
            raise PageAccountingError(
                f"double free: page {page} has no live refcount")
        if c == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = c - 1

    def page_refs(self) -> dict[int, int]:
        """page id -> refcount (auditor view)."""
        return dict(self._ref)

    def release(self, slot: int) -> None:
        """Drop ``slot``'s reference on every page it maps. A slot with no
        live sequence (double release, never admitted) raises."""
        if slot not in self._seqs:
            raise PageAccountingError(
                f"release of slot {slot} with no live sequence "
                f"(double free or never admitted)")
        seq = self._seqs.pop(slot)
        for p in reversed(seq.pages):
            self._decref(p)

    def free(self, slot: int) -> None:
        """Alias of ``release``."""
        self.release(slot)

    # -- sequence lifecycle --
    def admit_plan(self, prompt_len: int, reserve: int) -> tuple[int, int]:
        """(total pages, pages drawn from the free list) an admission of
        ``prompt_len`` tokens plus ``reserve`` decode tokens needs."""
        n = self.pages_needed(prompt_len + reserve)
        return n, n

    def admit(self, slot: int, prompt_len: int, *,
              reserve: int = 0) -> list[int]:
        """Allocate pages for ``prompt_len`` + ``reserve`` future tokens and
        return them. A full ``max_new_tokens`` reservation never needs a
        preemption; a smaller one runs the pool hot, and ``append`` may
        then raise ``PagePoolExhausted`` mid-decode."""
        if slot in self._seqs:
            raise PageAccountingError(f"slot {slot} still occupied")
        n, _ = self.admit_plan(prompt_len, reserve)
        if n > self.max_pages_per_seq:
            raise ValueError(f"request needs {n} pages > max_pages_per_seq "
                             f"{self.max_pages_per_seq}")
        ids = self.alloc(n)
        self._seqs[slot] = PagedSeq(pages=ids, length=prompt_len)
        return list(ids)

    def append(self, slot: int) -> None:
        """Record one generated token; take a page if the new position
        crosses into one the sequence does not own. Exception-safe: on
        ``PagePoolExhausted`` the sequence is unchanged."""
        self._grow(slot, 1).length += 1

    def _grow(self, slot: int, n: int) -> PagedSeq:
        """Take, all or nothing, the pages ``slot`` needs to hold ``n``
        more tokens than its length."""
        seq = self._seqs[slot]
        need = self.pages_needed(seq.length + n) - seq.capacity
        if need > 0:
            if seq.capacity + need > self.max_pages_per_seq:
                raise PagePoolExhausted(
                    f"slot {slot} exceeded max_pages_per_seq")
            seq.pages.extend(self.alloc(need))
        return seq

    def ensure_capacity(self, slot: int, n: int) -> None:
        """Allocate pages so ``n`` more tokens can land without further
        allocation: the reservation a speculative verify step takes before
        its dispatch, since the device writes the candidate rows into pages
        the table must already name. The length does not change; unused
        pages stay owned like admission reserve pages. On
        ``PagePoolExhausted`` the sequence is unchanged."""
        self._grow(slot, n)

    def append_n(self, slot: int, n: int) -> None:
        """Record ``n`` generated tokens in one update (the accepted prefix
        of a verify step), taking any pages they grow into with one
        all-or-nothing ``alloc``. On ``PagePoolExhausted`` the sequence,
        length and pages, is unchanged."""
        if n == 0:
            return
        self._grow(slot, n).length += n

    def seq_pages(self, slot: int) -> list[int]:
        """Physical page ids mapped by ``slot`` (prompt order)."""
        return list(self._seqs[slot].pages)

    # -- views --
    def owned_pages(self) -> dict[int, list[int]]:
        """slot -> page ids of every live sequence (auditor view)."""
        return {slot: list(seq.pages) for slot, seq in self._seqs.items()}

    def free_pages(self) -> list[int]:
        """Current free list (auditor view; LIFO order kept)."""
        return list(self._free)

    def table(self) -> np.ndarray:
        """(num_slots, max_pages) int32; empty entries -> scratch page."""
        t = np.full((self.num_slots, self.max_pages_per_seq), SCRATCH_PAGE,
                    np.int32)
        for slot, seq in self._seqs.items():
            t[slot, :len(seq.pages)] = seq.pages
        return t

    def kv_lens(self) -> np.ndarray:
        out = np.zeros((self.num_slots,), np.int32)
        for slot, seq in self._seqs.items():
            out[slot] = seq.length
        return out
