"""The port's shared-prefix index (``PagedKVCacheManager(prefix_cache=True)``),
its ``PoolAuditor`` and ``tune_cache_reserve`` against the JAX package's.

* The manager scenarios of ``tests/test_prefix_cache.py`` replay against
  the port's manager: publish, match and refcounts; typed double frees;
  copy on write at every divergence offset within a page; a partial hit
  resuming publication; a hash-chain collision; reclaim before
  exhaustion; the reserve cap; LRU eviction; the auditor's corruption
  checks and its drain proof.
* Random admit/publish/append/release/evict ops drive the port's and the
  JAX managers side by side at seeds where the reference never evicts a
  matched page: after every op both give the same tables, ``kv_lens``,
  refcounts, cached pages and free list.
* ROADMAP C1: the reference's ``admit_prefix`` allocates before it pins
  the matched pages, so its reclaim can hand a matched page back as a
  fresh one. At the seeds where the reference's auditor then raises
  ("mapped twice"), and over a hypothesis sweep, the port's auditor stays
  green and the pool drains to the retained prefixes. The admission
  gate's capacity (``admit_capacity``) leaves out the match's own cold
  pages, so a gate that admits never meets exhaustion inside
  ``admit_prefix``.
* Publication stops at a parent entry evicted meanwhile, where the
  reference chains a new entry to a dead parent.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.autotune import tune_cache_reserve as jax_tune_cache_reserve
from repro.serving import PageAccountingError as JaxAccountingError
from repro.serving import PagedKVCacheManager as JaxManager
from repro.serving import PagePoolExhausted as JaxExhausted
from repro.serving import PoolAuditError as JaxAuditError
from repro.serving import PoolAuditor as JaxAuditor
from repro.serving.paged_cache import chain_key as jax_chain_key
from repro_torch.core.autotune import tune_cache_reserve
from repro_torch.serving import (
    PageAccountingError,
    PagedKVCacheManager,
    PagePoolExhausted,
    PoolAuditError,
    PoolAuditor,
    PoolConfigError,
    chain_key,
)

PS = 4  # page size of every manager here
P16 = np.arange(100, 116, dtype=np.int32)  # four full pages
C1_SEEDS = (33, 149, 271, 284, 426)


def mk(num_pages=17, frac=0.5, cls=PagedKVCacheManager):
    return cls(num_pages, PS, num_slots=4, max_pages_per_seq=8,
               prefix_cache=True, cache_reserve_frac=frac)


def admit(mgr, slot, prompt, reserve=0):
    """The engine's admission sequence: match, map, publish."""
    prompt = np.asarray(prompt)
    res = mgr.admit_prefix(slot, len(prompt), reserve=reserve,
                           match=mgr.match_prefix(prompt))
    mgr.publish_prefix(slot, prompt)
    return res


# ---------------------------------------------------------------------------
# index mechanics: publish, match, refcounts, release retention
# ---------------------------------------------------------------------------


def test_chain_key_is_the_reference_digest():
    for parent, toks in ((b"\x00" * 16, P16[:4]), (b"k" * 16, [7, 8, 9, 10])):
        assert chain_key(parent, toks) == jax_chain_key(parent, toks)
    assert chain_key(b"\x00" * 16, P16[:4]) != chain_key(b"\x01" * 16,
                                                         P16[:4])


def test_publish_match_release_refcounts():
    mgr = mk()  # 16 usable pages, reserve 8
    res = admit(mgr, 0, P16)
    assert res.prefix_tokens == 0 and not res.full_hit
    assert mgr.prefix_misses == 1
    refs = mgr.page_refs()
    assert all(refs[p] == 2 for p in res.pages)  # the slot and the index
    assert sorted(mgr.cached_pages()) == sorted(res.pages)
    m = mgr.match_prefix(P16)
    assert m.full and m.tokens == 16 and m.full_pages == 4
    assert m.pages == res.pages
    m2 = mgr.match_prefix(np.concatenate([P16, [7, 8]]))
    assert not m2.full and m2.tokens == 16 and m2.full_pages == 4
    assert mgr.match_prefix([1, 2, 3]) is None
    mgr.release(0)  # the whole prefix stays (4 pages <= reserve 8)
    assert all(mgr.page_refs()[p] == 1 for p in res.pages)
    assert mgr.reclaimable == 4 and mgr.pages_used == 4
    assert mgr.free_capacity == 16 and mgr.can_admit(16 * PS // 2)
    assert not mgr.can_admit(9 * PS)  # past max_pages_per_seq
    assert mgr.match_prefix(P16).full
    PoolAuditor().check(mgr)


def test_double_free_is_typed_through_one_decrement_path():
    mgr = mk()
    with pytest.raises(PageAccountingError):
        mgr.release(0)  # never admitted
    admit(mgr, 0, P16[:8])
    mgr.release(0)
    with pytest.raises(PageAccountingError):
        mgr.release(0)  # double free of the slot
    with pytest.raises(PageAccountingError):
        mgr.free(0)     # free() takes the same path
    mgr2 = mk(frac=0.0)
    r2 = admit(mgr2, 0, P16[:4])
    mgr2.free(0)
    with pytest.raises(PageAccountingError):
        mgr2._decref(r2.pages[0])
    mgr3 = mk()
    mgr3.admit_prefix(0, 4)
    with pytest.raises(PageAccountingError):
        mgr3.admit_prefix(0, 4)  # slot still occupied
    with pytest.raises(PoolConfigError):
        mk(frac=1.5)


# ---------------------------------------------------------------------------
# copy on write: every divergence offset within a page
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", range(PS))
def test_full_hit_cow_at_every_offset(d):
    mgr = mk()
    a = admit(mgr, 0, P16)
    blen = 12 + d  # d = 0: a whole number of pages; else the tail probe
    m = mgr.match_prefix(P16[:blen])
    assert m is not None and m.full and m.tokens == blen
    assert m.full_pages == 3
    res = mgr.admit_prefix(1, blen, match=m)
    assert res.full_hit and res.prefix_tokens == blen
    div = (blen - 1) // PS
    assert res.pages[:div] == a.pages[:div]      # shared, read only
    assert res.cow == (a.pages[div], res.pages[div])
    assert res.pages[div] not in a.pages         # the private copy
    assert mgr.cow_copies == 1 and mgr.prefix_hits == 1
    refs = mgr.page_refs()
    assert all(refs[p] == 3 for p in res.pages[:div])  # index + 2 slots
    assert refs[res.pages[div]] == 1
    assert refs[a.pages[div]] == 2               # the copy's pin is gone
    assert int(mgr.kv_lens()[1]) == blen - 1     # the last token again
    mgr.append(1)
    assert int(mgr.kv_lens()[1]) == blen
    PoolAuditor().check(mgr)
    assert mgr.publish_prefix(1, P16[:blen]) == 0  # decode output: never
    mgr.release(1)
    mgr.release(0)
    PoolAuditor().final_check(mgr)


def test_partial_hit_maps_full_pages_and_resumes_publication():
    mgr = mk()
    a = admit(mgr, 0, P16)
    b = np.concatenate([P16[:8], np.arange(500, 512, dtype=np.int32)])
    m = mgr.match_prefix(b)
    assert m is not None and not m.full
    assert m.tokens == 8 and m.full_pages == 2  # whole pages only
    res = mgr.admit_prefix(1, len(b), match=m)
    assert not res.full_hit and res.cow is None and res.prefix_tokens == 8
    assert res.pages[:2] == a.pages[:2]
    assert mgr.pages_deduped >= 2
    assert mgr.publish_prefix(1, b) == 3  # only the suffix's pages join
    m2 = mgr.match_prefix(b)
    assert m2.full and m2.full_pages == 5
    PoolAuditor().check(mgr)


def test_hash_chain_collision_resident_entry_wins(monkeypatch):
    from repro_torch.serving import paged_cache as pc

    # every chain key on one digest: the second publisher collides (same
    # key, other tokens) and must stop instead of replacing the entry
    monkeypatch.setattr(pc, "chain_key", lambda parent, tokens: b"K" * 16)
    mgr = mk()
    a = admit(mgr, 0, P16[:8])
    other = np.arange(900, 908, dtype=np.int32)
    mgr.admit_prefix(1, 8, match=mgr.match_prefix(other))
    assert mgr.publish_prefix(1, other) == 0
    entry = mgr._px[b"K" * 16]
    assert entry.page == a.pages[0]
    assert entry.tokens == tuple(int(t) for t in P16[:4])
    assert mgr.match_prefix(other) is None  # tokens decide, not the digest
    assert mgr.match_prefix(P16[:8]) is not None
    PoolAuditor().check(mgr)


# ---------------------------------------------------------------------------
# eviction: inside alloc (before exhaustion) and at the reserve cap
# ---------------------------------------------------------------------------


def test_alloc_reclaims_cache_before_raising_exhausted():
    mgr = mk(num_pages=9, frac=1.0)  # 8 usable, reserve 8
    admit(mgr, 0, P16[:12])  # 3 pages published
    mgr.release(0)
    assert mgr.reclaimable == 3 and mgr.available == 5
    assert mgr.free_capacity == 8
    ids = mgr.alloc(7)  # two cached pages reclaimed
    assert len(ids) == 7 and mgr.prefix_evictions == 2
    m = mgr.match_prefix(P16[:12])  # leaves go first: the root stays
    assert m is not None and m.tokens == 4
    mgr.alloc(1)
    assert mgr.prefix_evictions == 3 and mgr.match_prefix(P16) is None
    with pytest.raises(PagePoolExhausted):
        mgr.alloc(1)  # only now is the pool exhausted


def test_release_enforces_reserve_cap_keeping_shallowest():
    mgr = mk(frac=2 / 16)  # reserve 2 of 16 pages
    admit(mgr, 0, P16)     # 4 published pages, shared with the slot
    assert mgr.prefix_evictions == 0
    mgr.release(0)
    assert mgr.reclaimable == 2 and mgr.prefix_evictions == 2
    m = mgr.match_prefix(P16)
    assert m is not None and not m.full and m.tokens == 8
    mgr0 = mk(frac=0.0)  # retains nothing
    admit(mgr0, 0, P16)
    mgr0.release(0)
    assert mgr0.pages_used == 0 and mgr0.match_prefix(P16) is None
    PoolAuditor().final_check(mgr0)


def test_eviction_is_lru_and_prefers_cold_leaves():
    mgr = mk(frac=1.0)
    a = np.arange(100, 108, dtype=np.int32)
    b = np.arange(200, 208, dtype=np.int32)
    admit(mgr, 0, a)
    mgr.release(0)
    admit(mgr, 0, b)
    mgr.release(0)
    mgr.match_prefix(a)  # a's chain is the most recent
    assert mgr.evict_cached_prefixes(1) == 1
    assert mgr.match_prefix(a).full
    assert mgr.match_prefix(b).tokens == 4  # b lost its leaf
    admit(mgr, 1, b)     # b's leaf again, now shared with slot 1
    mgr.match_prefix(b)
    mgr.evict_cached_prefixes(2)  # a's cold leaves go first
    assert mgr.match_prefix(b).full
    assert mgr.match_prefix(a) is None


# ---------------------------------------------------------------------------
# the auditor: re-derived refcounts, planted corruption, the drain proof
# ---------------------------------------------------------------------------


def test_auditor_rederives_shared_refcounts_and_catches_corruption():
    mgr = mk()
    admit(mgr, 0, P16)
    res = mgr.admit_prefix(1, 14, match=mgr.match_prefix(P16[:14]))
    aud = PoolAuditor()
    aud.check(mgr)
    assert aud.steps_checked == 1
    mgr._ref[res.pages[0]] += 1  # refcount drift
    with pytest.raises(PoolAuditError, match="disagree"):
        aud.check(mgr)
    mgr._ref[res.pages[0]] -= 1
    mgr._free.append(res.pages[0])  # a mapped page on the free list
    with pytest.raises(PoolAuditError, match="free and owned"):
        aud.check(mgr)
    mgr._free.pop()
    key = mgr._px_page_key[res.pages[0]]
    mgr._px_page_key[res.pages[0]] = b"\x01" * 16  # a broken back-link
    with pytest.raises(PageAccountingError, match="back-link"):
        aud.check(mgr)
    mgr._px_page_key[res.pages[0]] = key
    aud.check(mgr)


def test_final_check_proves_drain_to_exactly_retained_prefixes():
    mgr = mk()
    admit(mgr, 0, P16)
    aud = PoolAuditor()
    with pytest.raises(PoolAuditError, match="survived the drain"):
        aud.final_check(mgr)
    mgr.release(0)
    aud.final_check(mgr)  # retained cache (4 <= reserve 8) is legal
    assert mgr.pages_used == 4
    mgr._free.pop()  # a page held by neither a slot nor the index
    with pytest.raises(PoolAuditError, match="leak"):
        aud.final_check(mgr)


def test_final_check_holds_the_reserve_and_index_only_refcounts():
    mgr = mk(frac=1.0)
    admit(mgr, 0, P16)
    mgr.release(0)
    aud = PoolAuditor()
    aud.final_check(mgr)
    mgr.reserve_pages = 3  # the index now holds more than its budget
    with pytest.raises(PoolAuditError, match="cache reserve"):
        aud.final_check(mgr)
    mgr.reserve_pages = 16
    page = mgr.cached_pages()[0]
    mgr._ref[page] += 1  # a retained page with a reference too many
    with pytest.raises(PoolAuditError):
        aud.final_check(mgr)


# ---------------------------------------------------------------------------
# interleaved ops: beside the reference, and the C1 seeds
# ---------------------------------------------------------------------------


def _drive_interleaved(seed, cls=PagedKVCacheManager,
                       auditor=PoolAuditor, exhausted=PagePoolExhausted,
                       steps=120, log=None):
    """Random admit/publish/append/release/evict ops on a small pool (the
    reference test's ``_drive_interleaved``); an append that meets
    exhaustion releases its slot, as a preemption does. The auditor
    checks every op; the pool must drain to the retained prefixes and
    then to nothing."""
    rng = np.random.default_rng(seed)
    mgr = mk(num_pages=13, frac=0.5, cls=cls)  # 12 usable, reserve 6
    aud = auditor()
    shared = [np.arange(100, 108, dtype=np.int32),
              np.arange(200, 208, dtype=np.int32)]
    live: set[int] = set()
    for _ in range(steps):
        op = int(rng.integers(0, 4))
        if op == 0 and len(live) < 4:
            slot = next(s for s in range(4) if s not in live)
            pre = shared[int(rng.integers(0, 2))]
            keep = int(rng.integers(0, len(pre) + 1))
            tail = rng.integers(300, 400,
                                size=int(rng.integers(1, 8))).astype(np.int32)
            try:
                admit(mgr, slot, np.concatenate([pre[:keep], tail]))
            except exhausted:
                pass
            else:
                live.add(slot)
        elif op == 1 and live:
            slot = int(rng.choice(sorted(live)))
            mgr.release(slot)
            live.discard(slot)
        elif op == 2 and live:
            slot = int(rng.choice(sorted(live)))
            try:
                mgr.append(slot)
            except exhausted:
                mgr.release(slot)
                live.discard(slot)
        else:
            mgr.evict_cached_prefixes(int(rng.integers(0, 2)))
        aud.check(mgr)
        if log is not None:
            log.append((mgr.table(), mgr.kv_lens(), mgr.page_refs(),
                        mgr.cached_pages(), mgr.free_pages()))
    for slot in sorted(live):
        mgr.release(slot)
    aud.final_check(mgr)  # the retained prefixes only, within the reserve
    mgr.evict_cached_prefixes()
    assert mgr.pages_used == 0 and mgr.available == 12
    return mgr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaved_ops_op_by_op_like_the_reference(seed):
    want, got = [], []
    _drive_interleaved(seed, JaxManager, JaxAuditor, JaxExhausted, log=want)
    _drive_interleaved(seed, log=got)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"op {i} table")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"op {i} kv_lens")
        assert g[2:] == w[2:], f"op {i}: refcounts, cached pages, free list"


@pytest.mark.parametrize("seed", C1_SEEDS)
def test_c1_seeds_keep_the_auditor_green(seed):
    """At each seed the reference's auditor finds a page mapped twice (the
    reclaim inside ``alloc`` handed a matched page back as a fresh one);
    the port's pins the matched pages first, stays green and drains."""
    with pytest.raises(JaxAuditError, match="mapped twice"):
        _drive_interleaved(seed, JaxManager, JaxAuditor, JaxExhausted)
    _drive_interleaved(seed)


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_interleaved_ops_hypothesis(seed):
    _drive_interleaved(seed)


def _pinned_match_pool():
    """A pool whose only reclaimable pages are the ones the next prompt
    matches: a published 3-page prefix, released (index only), and the
    rest of the pool taken by a live sequence."""
    mgr = mk(num_pages=9, frac=1.0)  # 8 usable
    admit(mgr, 0, P16[:12])
    mgr.release(0)
    mgr.admit_prefix(1, 4 * 4)  # 4 of the 5 free pages
    return mgr


def test_gate_capacity_leaves_out_the_match_own_cold_pages():
    mgr = _pinned_match_pool()
    prompt = np.concatenate([P16[:12], np.arange(600, 606, dtype=np.int32)])
    m = mgr.match_prefix(prompt)
    assert m.tokens == 12 and not m.full
    total, new = mgr.admit_plan(len(prompt), 0, m)
    assert (total, new) == (5, 2)
    # the reference's gate reads free_capacity: 1 free + 3 cold = 4 >= 2;
    # but the 3 cold pages are this match's, pinned before alloc
    assert mgr.free_capacity == 4 and mgr.admit_capacity(m) == 1
    aud = PoolAuditor()
    with pytest.raises(PagePoolExhausted):
        mgr.admit_prefix(2, len(prompt), match=m)
    aud.check(mgr)  # the pins came off: nothing mapped, nothing leaked
    assert mgr.page_refs() == {**{p: 1 for p in m.pages},
                               **{p: 1 for p in mgr.seq_pages(1)}}
    assert mgr.match_prefix(prompt).pages == m.pages  # still resident
    # within the gate's capacity the admission lands and maps the prefix
    short = np.concatenate([P16[:12], [600]])
    m2 = mgr.match_prefix(short)
    _, new2 = mgr.admit_plan(len(short), 0, m2)
    assert new2 <= mgr.admit_capacity(m2)
    res = mgr.admit_prefix(2, len(short), match=m2)
    assert res.pages[:3] == m.pages
    aud.check(mgr)


def test_full_hit_copy_source_is_never_reissued_as_its_destination():
    mgr = _pinned_match_pool()
    m = mgr.match_prefix(P16[:10])  # ends inside the third page
    assert m.full and len(m.pages) == 3
    total, new = mgr.admit_plan(10, 0, m)
    assert (total, new) == (3, 1) and mgr.admit_capacity(m) == 1
    res = mgr.admit_prefix(2, 10, match=m)
    src, dst = res.cow
    assert src == m.pages[2] and dst != src and dst not in m.pages
    PoolAuditor().check(mgr)


def test_publication_stops_at_an_evicted_parent():
    """Two requests with one prompt admitted before either published: the
    second publishes only past the first's pages. The first drains, its
    pages go cold under the second's leaf; a reclaim must then evict that
    leaf to reach them. The second's next chunk must not chain an entry
    to the evicted one (the reference does, and its auditor's integrity
    walk raises)."""
    prompt = np.concatenate([P16[:8], np.arange(700, 712, dtype=np.int32)])
    for cls, auditor in ((JaxManager, JaxAuditor),
                         (PagedKVCacheManager, PoolAuditor)):
        mgr = cls(9, PS, num_slots=4, max_pages_per_seq=8,
                  prefix_cache=True, cache_reserve_frac=1.0)
        mgr.admit_prefix(0, 8)
        mgr.admit_prefix(1, 20)  # no match: nothing published yet
        mgr.publish_prefix(0, prompt[:8])
        assert mgr.publish_prefix(1, prompt[:12]) == 1  # its third page
        mgr.release(0)  # two cold interior pages under slot 1's leaf
        assert mgr.reclaimable == 2 and mgr.available == 1
        mgr.admit_prefix(2, 8)  # evicts slot 1's leaf, then a cold page
        published = mgr.publish_prefix(1, prompt[:16])
        if cls is JaxManager:
            with pytest.raises(JaxAccountingError, match="dead parent"):
                auditor().check(mgr)
        else:
            assert published == 0
            auditor().check(mgr)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool_pages,pages_per_seq,prefix_tokens,hit_rate", [
    (64, 8, 128, 0.5), (64, 8, 128, 0.0), (8, 8, 256, 0.9),
    (16, 8, 32, 0.4), (2048, 256, 1024, 0.5), (31, 10, 40, 0.7)])
def test_tune_cache_reserve_matches_reference(pool_pages, pages_per_seq,
                                              prefix_tokens, hit_rate):
    kw = dict(pool_pages=pool_pages, page=16, slots=4,
              pages_per_seq=pages_per_seq, prefix_tokens=prefix_tokens,
              hit_rate=hit_rate)
    assert tune_cache_reserve(**kw) == jax_tune_cache_reserve(**kw)
    assert 0.0 <= tune_cache_reserve(**kw) < 1.0
