"""Block-table KV-cache manager: fixed-size pages in a global pool.

Port of ``PagedKVCacheManager`` from ``repro/serving/paged_cache.py``.
Host-side bookkeeping for the paged serving path; the device state it
manages is split in two:

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
overwrites them.

Shared prefixes: pages are refcounted, a page's count being the live
sequences that map it plus one while the prefix index retains it, and
``release``/``free`` and index eviction all drop references through one
decrement path (``_decref``), which frees a page at zero and turns a
double free into a typed ``PageAccountingError``. The index keys full
pages of prompt KV on a hash chain (``chain_key(parent, tokens)``):
``publish_prefix`` registers a sequence's full prompt pages as its
chunks are written, ``match_prefix`` walks the chain at admission, and
``admit_prefix`` maps the matched pages into the new sequence's table so
that chunked prefill resumes at the first page not resident. Shared pages
are never written: every append lands in a sequence's own tail, and a
prompt that is resident whole maps its last (divergence) page copy on
write (``AdmitResult.cow``: the engine copies that one page on the device
and the table names the private copy). Index-only pages are evicted LRU
inside ``alloc`` before the pool reports exhaustion, so cold cache is
reclaimed before any live request is preempted, and
``cache_reserve_frac`` bounds how much of the pool the index may keep
once its publishers drain.

Unlike the reference, ``admit_prefix`` pins the matched pages before it
allocates: the reference allocates first, and the reclaim inside
``alloc`` can evict a matched page and hand it back as a fresh one, which
the sequence then maps twice (ROADMAP C1).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

SCRATCH_PAGE = 0

# Hash-chain root: the parent key of a prompt's first page. Matches are
# checked against the stored tokens, so the digest only narrows the
# search, it never decides it.
PREFIX_ROOT = b"\x00" * 16


def chain_key(parent: bytes, tokens) -> bytes:
    """Key of the page holding ``tokens`` whose predecessor hashed to
    ``parent``: ``blake2b(parent || tokens)``. Chaining makes the key
    depend on the position, so equal token blocks at different prompt
    offsets (whose KV differs under RoPE) never collide."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


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
    """Refcount violation: double free (of a private or a shared page),
    freeing a never-admitted slot, or admitting into an occupied slot."""


class PoolConfigError(PagedCacheError):
    """Raised when the pool is constructed with an unusable shape."""


@dataclasses.dataclass
class PagedSeq:
    pages: list[int]
    length: int  # live tokens (kv_len)
    # publication watermark: pages[:pub_pages] are in the index, pub_key
    # is the chain key of the last of them (PREFIX_ROOT before any). A
    # full hit sets it past the prompt, so decode output is never
    # published as prefix.
    pub_pages: int = 0
    pub_key: bytes = PREFIX_ROOT

    @property
    def capacity(self) -> int:
        return len(self.pages)


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Resident prefix found for a prompt (``match_prefix``).

    ``pages`` covers ``tokens`` prompt tokens; ``full`` means the whole
    prompt is resident (its last page possibly in part: the page's tail
    rows belong to a longer publisher and are masked by kv_len). ``key``
    is the chain key after the matched full pages, the publication
    watermark a partial hit resumes from.
    """
    pages: tuple[int, ...]
    tokens: int
    full: bool
    key: bytes
    full_pages: int  # pages matched through whole-page chain entries


@dataclasses.dataclass(frozen=True)
class AdmitResult:
    """Outcome of ``admit_prefix``: the sequence's pages, how many prompt
    tokens the cache served, and for a full hit the one (src, dst) device
    page copy the engine makes before the first decode step writes into
    the divergence page."""
    pages: tuple[int, ...]
    prefix_tokens: int
    full_hit: bool
    cow: tuple[int, int] | None


@dataclasses.dataclass
class _PrefixEntry:
    page: int
    parent: bytes
    tokens: tuple[int, ...]  # the page's token block (collision check)
    last_use: int


class PagedKVCacheManager:
    """Per-sequence page tables over a global pool of ``num_pages``.

    Sequences are keyed by decode slot (0..num_slots-1). ``admit``
    allocates pages for a prompt plus an optional decode reservation,
    ``append`` extends a sequence one token (allocating a page on a
    boundary crossing past the reservation), ``ensure_capacity`` and
    ``append_n`` reserve and commit a speculative step's rows, ``release``
    returns its pages to the pool. With ``prefix_cache=True`` the manager
    also keeps the shared-prefix index (see the module docstring).
    """

    def __init__(self, num_pages: int, page_size: int, *, num_slots: int,
                 max_pages_per_seq: int, prefix_cache: bool = False,
                 cache_reserve_frac: float = 0.5):
        if num_pages <= 1:
            raise PoolConfigError(
                f"pool needs at least one page beyond scratch, got "
                f"num_pages={num_pages}")
        if not 0.0 <= cache_reserve_frac <= 1.0:
            raise PoolConfigError(
                f"cache_reserve_frac must be in [0, 1], got "
                f"{cache_reserve_frac}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.prefix_cache = prefix_cache
        self.cache_reserve_frac = float(cache_reserve_frac)
        # pages the index may keep pinned once no live sequence maps them
        self.reserve_pages = int(round(self.cache_reserve_frac
                                       * (num_pages - 1)))
        # LIFO free list, scratch page 0 excluded
        self._free = list(range(num_pages - 1, 0, -1))
        self._seqs: dict[int, PagedSeq] = {}
        # page id -> live sequences mapping it, +1 while the index holds it
        self._ref: dict[int, int] = {}
        # prefix index: chain key -> entry, parent key -> child keys,
        # page id -> its chain key
        self._px: dict[bytes, _PrefixEntry] = {}
        self._px_children: dict[bytes, set[bytes]] = {}
        self._px_page_key: dict[int, bytes] = {}
        self._clock = 0  # LRU tick, bumped on every index touch
        self.peak_pages_used = 0
        # prefix telemetry, mirrored into the engine's metrics registry
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.pages_deduped = 0
        self.cow_copies = 0
        self.prefix_evictions = 0

    # -- pool accounting --
    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def reclaimable(self) -> int:
        """Cached pages held only by the index (refcount 1): the pages
        eviction can return to the free list now."""
        return sum(1 for p in self._px_page_key if self._ref.get(p) == 1)

    @property
    def free_capacity(self) -> int:
        """Pages an allocation may draw on: the free list plus the cold
        cache the LRU reclaim inside ``alloc`` can take back."""
        return len(self._free) + self.reclaimable

    def admit_capacity(self, match: PrefixMatch | None = None) -> int:
        """Pages an admission with ``match`` may draw: ``free_capacity``
        without the match's own index-only pages, which ``admit_prefix``
        pins before it allocates, so the reclaim cannot take them. The
        engine's admission gate reads this, so that an admission it lets
        in never meets ``PagePoolExhausted`` inside ``admit_prefix``."""
        own = 0 if match is None else sum(
            1 for p in match.pages if self._ref.get(p) == 1)
        return self.free_capacity - own

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def can_admit(self, total_len: int) -> bool:
        n = self.pages_needed(total_len)
        return n <= min(self.free_capacity, self.max_pages_per_seq)

    # -- primitive alloc/free --
    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages off the free list, evicting cold cached prefixes
        (LRU) first if the list is short, or raise ``PagePoolExhausted``
        and take none. A live allocation outranks retained cache: the
        engine preempts only on ``PagePoolExhausted``, which this never
        raises while reclaimable cache remains."""
        cold = self.reclaimable if n > len(self._free) else 0
        while n > len(self._free) and cold > 0:
            cold -= self._evict_one()
        if n > len(self._free):
            raise PagePoolExhausted(f"need {n} pages, {len(self._free)} free")
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            self._ref[p] = self._ref.get(p, 0) + 1
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return ids

    def _incref(self, page: int) -> None:
        if page not in self._ref:
            raise PageAccountingError(
                f"incref of page {page} with no live refcount")
        self._ref[page] += 1

    def _decref(self, page: int) -> None:
        """The one decrement path (``release``, ``free``, index eviction
        and ``admit_prefix``'s pins): drop a reference, free at zero."""
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
        live sequence (double release, never admitted) raises. Pages the
        index retains survive (count 2 -> 1); the cache reserve is then
        enforced, so a drained publisher cannot leave the index holding
        more of the pool than ``cache_reserve_frac`` allows."""
        if slot not in self._seqs:
            raise PageAccountingError(
                f"release of slot {slot} with no live sequence "
                f"(double free or never admitted)")
        seq = self._seqs.pop(slot)
        for p in reversed(seq.pages):
            self._decref(p)
        self._enforce_reserve()

    def free(self, slot: int) -> None:
        """Alias of ``release``."""
        self.release(slot)

    # -- prefix index --
    def _touch(self) -> int:
        self._clock += 1
        return self._clock

    def cached_pages(self) -> list[int]:
        """Pages the prefix index retains (auditor view)."""
        return sorted(self._px_page_key)

    def match_prefix(self, prompt) -> PrefixMatch | None:
        """Longest resident prefix of ``prompt``: walk the hash chain over
        full pages, then probe the children of the last match for a page
        whose leading rows cover the rest of the prompt (KV at a position
        depends only on the tokens up to it, so a longer publisher's page
        serves any prompt that ends inside it: the full hit, copied on
        write). Matched entries are LRU-bumped."""
        if not self.prefix_cache:
            return None
        toks = tuple(int(t) for t in np.asarray(prompt).ravel())
        plen = len(toks)
        ps = self.page_size
        pages: list[int] = []
        key = PREFIX_ROOT
        nfull = 0
        while (nfull + 1) * ps <= plen:
            block = toks[nfull * ps:(nfull + 1) * ps]
            k2 = chain_key(key, block)
            e = self._px.get(k2)
            if e is None or e.tokens != block:
                break
            e.last_use = self._touch()
            pages.append(e.page)
            key = k2
            nfull += 1
        tokens = nfull * ps
        full = tokens == plen
        if not full:
            r = plen - tokens  # 1 <= r < ps
            for ck in self._px_children.get(key, ()):
                e = self._px.get(ck)
                if e is not None and e.tokens[:r] == toks[tokens:]:
                    e.last_use = self._touch()
                    pages.append(e.page)
                    tokens = plen
                    full = True
                    break
        if tokens == 0:
            return None
        return PrefixMatch(pages=tuple(pages), tokens=tokens, full=full,
                           key=key, full_pages=nfull)

    def admit_plan(self, prompt_len: int, reserve: int,
                   match: PrefixMatch | None = None) -> tuple[int, int]:
        """(total pages, pages drawn from the free list) an admission of
        ``prompt_len`` tokens plus ``reserve`` decode tokens with this
        match needs: the admission gate's arithmetic, shared with
        ``admit_prefix``."""
        n = self.pages_needed(prompt_len + reserve)
        if match is None:
            return n, n
        if match.full:
            # pages before the divergence page map shared; the divergence
            # page itself is drawn fresh (the copy's destination)
            return n, n - (prompt_len - 1) // self.page_size
        return n, n - len(match.pages)

    def admit_prefix(self, slot: int, prompt_len: int, *,
                     reserve: int = 0,
                     match: PrefixMatch | None = None) -> AdmitResult:
        """Admit ``prompt_len`` tokens plus ``reserve`` decode tokens,
        mapping the resident prefix ``match``.

        Partial hit: the matched full pages join the sequence's table
        shared, fresh pages cover the rest, and the caller resumes chunked
        prefill at token ``prefix_tokens``. Full hit: the pages before the
        divergence page (the one holding position ``prompt_len - 1``) map
        shared, the divergence page is copied into a fresh private page
        (``cow``: the engine makes the copy before its next step), and the
        sequence starts at length ``prompt_len - 1``, so its first decode
        step feeds the last prompt token again and emits the first new
        token without a prefill chunk.

        Every matched page, the copy's source included, is pinned before
        ``alloc``: its reclaim may then evict their index entries but never
        free the pages and hand them back as fresh ones (C1). On
        ``PagePoolExhausted`` the pins are dropped and nothing is mapped;
        the copy's source loses its pin once the sequence is recorded,
        since the sequence does not map it.
        """
        if slot in self._seqs:
            raise PageAccountingError(f"slot {slot} still occupied")
        n, n_new = self.admit_plan(prompt_len, reserve, match)
        if n > self.max_pages_per_seq:
            raise ValueError(f"request needs {n} pages > max_pages_per_seq "
                             f"{self.max_pages_per_seq}")
        if match is None:
            ids = self.alloc(n)
            self._seqs[slot] = PagedSeq(pages=ids, length=prompt_len)
            self.prefix_misses += 1 if self.prefix_cache else 0
            return AdmitResult(pages=tuple(ids), prefix_tokens=0,
                               full_hit=False, cow=None)
        for p in match.pages:
            self._incref(p)
        try:
            fresh = self.alloc(n_new)
        except PagePoolExhausted:
            for p in match.pages:
                self._decref(p)
            raise
        if match.full:
            div = (prompt_len - 1) // self.page_size
            mapped = list(match.pages[:div])
            cow = (match.pages[div], fresh[0])
            length = prompt_len - 1
            # never publish past the prompt: the copied page and the ones
            # after it hold decode output
            pub_pages = len(mapped) + len(fresh)
        else:
            mapped = list(match.pages)
            cow = None
            length = prompt_len
            pub_pages = match.full_pages
        self._seqs[slot] = PagedSeq(pages=mapped + fresh, length=length,
                                    pub_pages=pub_pages, pub_key=match.key)
        if cow is not None:
            self._decref(cow[0])
        self.prefix_hits += 1
        self.prefix_hit_tokens += match.tokens
        self.pages_deduped += len(mapped) + (1 if cow else 0)
        self.cow_copies += 1 if cow else 0
        self.peak_pages_used = max(self.peak_pages_used, self.pages_used)
        return AdmitResult(pages=tuple(mapped + fresh),
                           prefix_tokens=match.tokens,
                           full_hit=match.full, cow=cow)

    def publish_prefix(self, slot: int, tokens) -> int:
        """Register ``slot``'s written full prompt pages in the index
        (called as each chunk is written, with the prompt tokens prefilled
        so far). Each page published gains an index reference, so it
        survives the sequence's release. Returns the pages published by
        this call. Publication stops at a hash-chain collision (same key,
        other tokens: the resident entry wins) and when the chain's last
        entry was evicted meanwhile (no match could reach past it)."""
        if not self.prefix_cache:
            return 0
        seq = self._seqs[slot]
        toks = tuple(int(t) for t in np.asarray(tokens).ravel())
        limit = min(len(toks) // self.page_size, len(seq.pages))
        done = 0
        while seq.pub_pages < limit:
            if seq.pub_key != PREFIX_ROOT and seq.pub_key not in self._px:
                break  # the parent entry was evicted
            i = seq.pub_pages
            block = toks[i * self.page_size:(i + 1) * self.page_size]
            key = chain_key(seq.pub_key, block)
            e = self._px.get(key)
            if e is not None:
                if e.tokens != block:
                    break  # collision: leave the resident entry alone
                e.last_use = self._touch()
            else:
                page = seq.pages[i]
                self._incref(page)
                self._px[key] = _PrefixEntry(
                    page=page, parent=seq.pub_key, tokens=block,
                    last_use=self._touch())
                self._px_children.setdefault(seq.pub_key, set()).add(key)
                self._px_page_key[page] = key
                done += 1
            seq.pub_key = key
            seq.pub_pages = i + 1
        return done

    def _evict_entry(self, key: bytes) -> None:
        e = self._px.pop(key)
        kids = self._px_children.get(e.parent)
        if kids is not None:
            kids.discard(key)
            if not kids:
                del self._px_children[e.parent]
        del self._px_page_key[e.page]
        self._decref(e.page)
        self.prefix_evictions += 1

    def _evict_one(self) -> bool:
        """Drop the LRU leaf entry, preferring one whose page only the index
        holds (evicting it frees a page now). A leaf a live sequence also
        maps is evicted otherwise: that frees nothing yet but unpins the
        entries above it, and since every pass shrinks the index the
        reclaim loop in ``alloc`` ends. Returns whether a page was freed,
        which is by how much ``reclaimable`` fell: the reclaim loops count
        it down instead of recounting the index after every eviction."""
        best = None
        best_cold = None
        for key, e in self._px.items():
            if self._px_children.get(key):
                continue  # interior: children chain through it
            if best is None or e.last_use < best[1].last_use:
                best = (key, e)
            if self._ref.get(e.page) == 1 and (
                    best_cold is None
                    or e.last_use < best_cold[1].last_use):
                best_cold = (key, e)
        pick = best_cold or best
        if pick is None:  # no leaf: the index is empty
            raise PageAccountingError("prefix index has no evictable leaf")
        self._evict_entry(pick[0])
        return best_cold is not None

    def _enforce_reserve(self) -> None:
        """Shrink the index until the pages it holds alone fit the
        ``cache_reserve_frac`` budget. Pages live sequences also map do
        not count: they cost nothing beyond those sequences."""
        if not self.prefix_cache:
            return
        excess = self.reclaimable - self.reserve_pages
        while excess > 0:
            excess -= self._evict_one()

    def evict_cached_prefixes(self, n: int | None = None) -> int:
        """Drop up to ``n`` cached-prefix entries (all, when ``None``):
        tests use it to show that retained cache is the only thing left in
        a drained pool."""
        done = 0
        while self._px and (n is None or done < n):
            self._evict_one()
            done += 1
        return done

    # -- sequence lifecycle --
    def admit(self, slot: int, prompt_len: int, *,
              reserve: int = 0) -> list[int]:
        """Allocate pages for ``prompt_len`` + ``reserve`` future tokens and
        return them. A full ``max_new_tokens`` reservation never needs a
        preemption; a smaller one runs the pool hot, and ``append`` may
        then raise ``PagePoolExhausted`` mid-decode. This path maps
        nothing shared (``admit_prefix`` does)."""
        return list(self.admit_prefix(slot, prompt_len,
                                      reserve=reserve).pages)

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

    def prefix_integrity_check(self) -> None:
        """Check the index's own invariants (auditor hook): every entry's
        page is refcounted and linked back to it, every entry below the
        root chains to a live parent, and the children map mirrors the
        entries exactly. Raises ``PageAccountingError``."""
        for key, e in self._px.items():
            if self._ref.get(e.page, 0) < 1:
                raise PageAccountingError(
                    f"index entry {key.hex()} holds page {e.page} with "
                    f"no refcount")
            if self._px_page_key.get(e.page) != key:
                raise PageAccountingError(
                    f"page {e.page} back-link disagrees with entry "
                    f"{key.hex()}")
            if e.parent != PREFIX_ROOT and e.parent not in self._px:
                raise PageAccountingError(
                    f"index entry {key.hex()} chains to a dead parent")
            if key not in self._px_children.get(e.parent, ()):
                raise PageAccountingError(
                    f"parent of {key.hex()} does not list it as a child")
        for kids in self._px_children.values():
            for k in kids:
                if k not in self._px:
                    raise PageAccountingError(
                        f"children map names dead entry {k.hex()}")
        if len(self._px_page_key) != len(self._px):
            raise PageAccountingError(
                f"{len(self._px)} index entries but "
                f"{len(self._px_page_key)} page back-links")

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
