"""The allocator and prefix-cache suite of ``tests/test_paged_cache.py``
(its units, its 500-case deterministic fuzz, its hypothesis fuzz and its
prefix-cache units), aimed at the port's host-side ``PageAllocator`` and
``PrefixCache`` (``repro_torch.serve.paged_cache``).

The allocator invariants under arbitrary alloc/append/share/hold/free/
preempt/truncate interleavings:
  * every live page's refcount equals table references + holds — no page
    is ever freed while still referenced,
  * free ∪ live pages always partition {1..n_pages-1} (no leaks),
  * the null page 0 is never handed out,
  * copy-on-write never mutates a shared page in place (divergent writes
    land in a private duplicate; every sharer's stream stays intact),
  * a page becomes dirty exactly when its last reference drops
    (scrub-on-last-free) and is scrubbed before its next owner writes,
  * ``slot_of`` reconstructs each request's logical KV stream exactly.
"""

from collections import Counter

import numpy as np
import pytest

from _hypo import given, settings, st
from repro_torch.serve.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    PrefixCache,
    page_hashes,
    pages_for,
)

# ------------------------------------------------------------- unit tests


def test_pages_for():
    assert pages_for(0, 8) == 0
    assert pages_for(1, 8) == 1
    assert pages_for(8, 8) == 1
    assert pages_for(9, 8) == 2


def test_allocator_validation():
    with pytest.raises(ValueError, match="page_size"):
        PageAllocator(4, 0)
    with pytest.raises(ValueError, match="null page"):
        PageAllocator(1, 8)


def test_allocator_basics():
    a = PageAllocator(5, 4)  # pages 1..4 usable
    assert a.n_free == 4
    a.alloc("r0")
    assert a.ensure("r0", 5) == [1, 2]  # low ids first, deterministic
    assert a.slot_of("r0", 0) == (1, 0)
    assert a.slot_of("r0", 5) == (2, 1)
    with pytest.raises(ValueError, match="not backed"):
        a.slot_of("r0", 8)
    with pytest.raises(ValueError, match="already allocated"):
        a.alloc("r0")
    a.alloc("r1")
    assert a.ensure("r1", 8) == [3, 4]
    with pytest.raises(ValueError, match="out of KV pages"):
        a.ensure("r1", 9)
    # failed ensure must not leak partial allocations
    assert a.n_free == 0 and a.page_table("r1") == (3, 4)
    a.free("r0")
    assert a.n_free == 2
    assert a.ensure("r1", 9) == [1]  # recycled
    assert NULL_PAGE not in a.page_table("r1")


# ------------------------------------------------- refcount / CoW units


def test_refcount_adopt_and_cow():
    a = PageAllocator(6, 4)
    a.alloc("r0")
    assert a.ensure("r0", 8) == [1, 2]
    assert a.refcount(1) == a.refcount(2) == 1
    a.alloc("r1")
    a.adopt("r1", [1, 2])  # shared-prefix adoption
    assert a.refcount(1) == a.refcount(2) == 2
    assert a.page_table("r1") == (1, 2)
    # divergent write into shared page 2 -> private duplicate
    src, dst = a.cow("r1", 1)
    assert (src, dst) == (2, 3)
    assert a.page_table("r1") == (1, 3)
    assert a.page_table("r0") == (1, 2)  # source table untouched
    assert a.refcount(2) == 1 and a.refcount(3) == 1
    assert a.cow_count == 1
    # already-private page: no duplication
    assert a.cow("r1", 1) is None
    # freeing the adopter keeps r0's pages alive (refcount > 0)
    a.free("r1")
    assert a.refcount(1) == 1 and a.page_table("r0") == (1, 2)
    assert a.dirty_pages() == {3}  # only the duplicate actually freed


def test_adopt_and_hold_validation():
    a = PageAllocator(4, 2)
    a.alloc("r0")
    a.ensure("r0", 2)
    with pytest.raises(ValueError, match="non-live"):
        a.adopt("r0", [3])
    with pytest.raises(ValueError, match="non-live"):
        a.hold(NULL_PAGE)


def test_hold_keeps_page_alive_past_owner():
    a = PageAllocator(4, 2)
    a.alloc("r0")
    (p,) = a.ensure("r0", 2)
    a.hold(p)
    a.free("r0")
    assert a.refcount(p) == 1 and a.n_free == 2  # held: not freed
    assert a.dirty_pages() == set()
    a.unhold(p)
    assert a.refcount(p) == 0 and a.n_free == 3
    assert a.dirty_pages() == {p}  # dirty exactly on last free


def test_cow_out_of_pages_has_no_side_effects():
    a = PageAllocator(3, 2)  # pages 1, 2
    a.alloc("r0")
    a.ensure("r0", 4)
    a.alloc("r1")
    a.adopt("r1", list(a.page_table("r0")))
    with pytest.raises(ValueError, match="copy-on-write"):
        a.cow("r1", 0)
    assert a.page_table("r1") == a.page_table("r0")
    assert a.refcount(1) == 2


def test_truncate_to_drops_trailing_pages():
    a = PageAllocator(6, 4)
    a.alloc("r0")
    assert a.ensure("r0", 11) == [1, 2, 3]
    # cut mid page 2: page 3 is purely rejected suffix, pages 1-2 stay
    assert a.truncate_to("r0", 6) == [3]
    assert a.page_table("r0") == (1, 2)
    assert a.refcount(3) == 0 and a.dirty_pages() == {3}
    # no-op cuts: already short enough / exact page boundary
    assert a.truncate_to("r0", 8) == []
    assert a.truncate_to("r0", 6) == []
    assert a.page_table("r0") == (1, 2)
    # dropped pages report in table order; freed low ids are handed out
    # first again (reverse-order decref)
    assert a.truncate_to("r0", 0) == [1, 2]
    assert a.ensure("r0", 1) == [1]
    with pytest.raises(ValueError, match="negative"):
        a.truncate_to("r0", -1)


def test_truncate_to_keeps_shared_and_held_pages_live():
    """Rollback drops only THIS table's reference: pages shared with
    another request or held by the prefix cache survive, and a held
    rolled-back page is still adoptable afterwards (the spec-decode /
    prefix-cache interaction)."""
    a = PageAllocator(6, 4)
    a.alloc("r0")
    a.ensure("r0", 12)  # pages 1, 2, 3
    a.alloc("r1")
    a.adopt("r1", [1, 2])
    a.hold(3)  # prefix-cache style hold on the suffix page
    assert a.truncate_to("r0", 0) == [1, 2, 3]
    assert a.refcount(1) == 1 and a.refcount(2) == 1  # r1's references
    assert a.refcount(3) == 1  # the hold
    assert a.dirty_pages() == set()  # nothing actually freed
    a.alloc("r2")
    a.adopt("r2", [3])  # rolled-back held page re-adopted
    assert a.refcount(3) == 2
    a.unhold(3)
    a.free("r2")
    assert a.refcount(3) == 0 and 3 in a.dirty_pages()


def test_scrub_bookkeeping_roundtrip():
    a = PageAllocator(4, 2)
    a.alloc("r0")
    pages = a.ensure("r0", 4)
    a.free("r0")
    assert a.dirty_pages() == set(pages)
    a.note_scrubbed(pages)
    assert a.dirty_pages() == set()


# ------------------------------------------------- fuzz harness (shared)


def _check_invariants(a: PageAllocator, streams: dict, holds: Counter):
    table_refs = Counter(p for rid in a.live() for p in a.page_table(rid))
    live_pages = set(table_refs) | {p for p, c in holds.items() if c > 0}
    assert NULL_PAGE not in live_pages, "null page allocated"
    # refcount == table references + external holds, for every live page
    for p in live_pages:
        assert a.refcount(p) == table_refs.get(p, 0) + holds.get(p, 0), p
    # no page freed while referenced; free ∪ live partitions the pool
    free = set(a._free)
    assert not (free & live_pages), "page freed while refcount > 0"
    assert a.n_free == len(free), "free list duplicates"
    assert free | live_pages == set(range(1, a.n_pages)), "pages leaked"
    # dirty pages are exactly tracked free pages, never live ones
    assert a.dirty_pages() <= free, "live page marked dirty"
    for rid, stream in streams.items():
        # reconstruct the logical stream through the page table — shared
        # or private, every sharer must still see its exact values (the
        # "CoW never mutates a shared page in place" invariant)
        for pos, val in enumerate(stream):
            page, slot = a.slot_of(rid, pos)
            assert _PHYS[(page, slot)] == val, (rid, pos)


_PHYS = {}  # (page, slot) -> last value written; fuzz-model physical memory


def _scrub(a: PageAllocator, pages, model_dirty):
    """Model the jitted step's scrub of freshly handed-out pages: stale
    physical values vanish, and the allocator is told (note_scrubbed)."""
    for p in pages:
        assert p in model_dirty or all(
            (p, s) not in _PHYS for s in range(a.page_size)
        ), f"page {p} carries stale values but was never marked dirty"
        for s in range(a.page_size):
            _PHYS.pop((p, s), None)
    a.note_scrubbed(pages)
    model_dirty.difference_update(pages)


def _run_schedule(n_pages, page_size, ops):
    """Drive the allocator through an op schedule, modelling physical
    writes (including CoW copies and scrubs), checking every invariant
    after every op.

    ops: list of (kind, arg) with kind in {"new", "append", "free",
    "share", "hold", "unhold", "preempt", "readopt", "truncate"};
    ``arg`` selects targets (modulo counts).
    ``share`` forks a new request off an existing one's full-page prefix
    (adoption); an odd ``arg`` truncates the fork's logical stream by
    one token — mimicking the full-prefix-hit recompute — so its next
    append lands inside a shared page and must copy-on-write.
    ``preempt`` models scheduler preempt-and-recompute: the victim's
    full pages are held (prefix-cache registration), the request is
    freed, and a later ``readopt`` re-admits a request that adopts those
    held pages and replays — the exact release/readopt interleaving the
    serving loop performs under pool pressure (serve/scheduler.py).
    ``truncate`` models speculative-decode rejection rollback
    (``truncate_to``): the stream is cut to an arbitrary earlier point
    and the trailing pages drop this table's reference — shared/held
    pages must stay live (and stay re-adoptable), sole-owner pages must
    return to the pool dirty.
    """
    _PHYS.clear()
    a = PageAllocator(n_pages, page_size)
    streams = {}  # rid -> list of written values (the logical stream)
    holds = Counter()  # page -> external (prefix-cache-style) holds
    model_dirty = set()  # pages freed (refcount 0) and not yet scrubbed
    cached = []  # (pages, values) published by "preempt", for "readopt"
    next_rid, next_val = 0, 0
    for kind, arg in ops:
        if kind == "new":
            a.alloc(next_rid)
            streams[next_rid] = []
            next_rid += 1
        elif kind == "append" and streams:
            rid = sorted(streams)[arg % len(streams)]
            stream = streams[rid]
            pos = len(stream)
            idx = pos // page_size
            if idx < len(a.page_table(rid)):
                # page exists; privatize before any divergent write
                if a.refcount(a.page_table(rid)[idx]) > 1:
                    try:
                        src, dst = a.cow(rid, idx)
                    except ValueError:  # no page for the duplicate
                        _check_invariants(a, streams, holds)
                        continue
                    _scrub(a, [dst], model_dirty)
                    for s in range(page_size):
                        if (src, s) in _PHYS:
                            _PHYS[(dst, s)] = _PHYS[(src, s)]
            else:
                try:
                    grown = a.ensure(rid, pos + 1)
                except ValueError:
                    _check_invariants(a, streams, holds)  # no effects
                    continue
                _scrub(a, grown, model_dirty)
            page, slot = a.slot_of(rid, pos)
            assert a.refcount(page) == 1, "write into a shared page"
            _PHYS[(page, slot)] = next_val
            stream.append(next_val)
            next_val += 1
        elif kind == "free" and streams:
            rid = sorted(streams)[arg % len(streams)]
            before = a.page_table(rid)
            a.free(rid)
            del streams[rid]
            # scrub-on-last-free: exactly the pages whose refcount hit 0
            model_dirty.update(p for p in before if a.refcount(p) == 0)
        elif kind == "share" and streams:
            src_rid = sorted(streams)[arg % len(streams)]
            n_full = len(streams[src_rid]) // page_size
            if n_full == 0:
                continue
            m = 1 + (arg // len(streams)) % n_full
            trunc = arg % 2  # odd: fork recomputes its "last token"
            if m * page_size - trunc < 1:
                continue
            a.alloc(next_rid)
            a.adopt(next_rid, a.page_table(src_rid)[:m])
            streams[next_rid] = list(
                streams[src_rid][: m * page_size - trunc]
            )
            next_rid += 1
        elif kind == "hold" and a.live():
            pages = [p for r in a.live() for p in a.page_table(r)]
            if pages:
                p = pages[arg % len(pages)]
                a.hold(p)
                holds[p] += 1
        elif kind == "unhold" and +holds:
            held = sorted(p for p, c in holds.items() if c > 0)
            p = held[arg % len(held)]
            before = a.refcount(p)
            a.unhold(p)
            holds[p] -= 1
            if before == 1:
                model_dirty.add(p)
        elif kind == "preempt" and streams:
            # scheduler preemption: publish full pages (cache holds) so
            # readmission can re-adopt, then release everything
            rid = sorted(streams)[arg % len(streams)]
            stream = streams[rid]
            n_full = len(stream) // page_size
            full_pages = list(a.page_table(rid)[:n_full])
            for p in full_pages:
                a.hold(p)
                holds[p] += 1
            if full_pages:
                cached.append((full_pages, list(stream[: n_full * page_size])))
            before = a.page_table(rid)
            a.free(rid)
            del streams[rid]
            model_dirty.update(p for p in before if a.refcount(p) == 0)
        elif kind == "truncate" and streams:
            # speculative-rejection rollback at an arbitrary point
            rid = sorted(streams)[arg % len(streams)]
            stream = streams[rid]
            n = (arg // 7) % (len(stream) + 1)
            before = a.page_table(rid)
            dropped = a.truncate_to(rid, n)
            assert sorted(dropped) == sorted(
                before[pages_for(n, page_size):]
            ), "truncate_to dropped the wrong pages"
            del stream[n:]
            model_dirty.update(p for p in dropped if a.refcount(p) == 0)
        elif kind == "readopt" and cached:
            # readmission after preemption: adopt the still-held prefix
            # pages; odd arg replays one token short (the fed-stream
            # truncation), so the next append must copy-on-write
            pages, values = cached[arg % len(cached)]
            if len(values) - (arg % 2) < 1:
                continue
            if any(holds[p] < 1 for p in pages):
                # an "unhold" evicted part of this cached prefix: without
                # the hold a sole-owner page could be rewritten in place,
                # so the entry is no longer safely adoptable (the real
                # PrefixCache deletes the entry at eviction time)
                continue
            a.alloc(next_rid)
            a.adopt(next_rid, pages)
            streams[next_rid] = list(values[: len(values) - (arg % 2)])
            next_rid += 1
        _check_invariants(a, streams, holds)
        assert a.dirty_pages() == model_dirty, "dirty-set drift"


_OP_KINDS = ["new", "append", "append", "append", "free",
             "share", "share", "hold", "unhold", "preempt", "readopt",
             "truncate", "truncate"]


def _random_ops(rng, n_ops):
    kinds = rng.choice(_OP_KINDS, n_ops)
    args = rng.integers(0, 64, n_ops)
    return list(zip(kinds.tolist(), args.tolist()))


def test_allocator_fuzz_deterministic():
    """500 seeded random alloc/append/share/hold/free interleavings over
    small pools (tight pools force recycling, CoW, and out-of-pages
    paths) — always runs, independent of hypothesis availability."""
    for seed in range(500):
        rng = np.random.default_rng(seed)
        n_pages = int(rng.integers(2, 9))
        page_size = int(rng.integers(1, 5))
        _run_schedule(n_pages, page_size, _random_ops(rng, int(rng.integers(5, 40))))


@settings(max_examples=500, deadline=None)
@given(
    n_pages=st.integers(min_value=2, max_value=8),
    page_size=st.integers(min_value=1, max_value=4),
    ops=st.lists(
        st.tuples(
            st.sampled_from(_OP_KINDS),
            st.integers(min_value=0, max_value=63),
        ),
        max_size=40,
    ),
)
def test_allocator_fuzz_hypothesis(n_pages, page_size, ops):
    """Hypothesis search over the same schedule space (shrinks failures
    to minimal interleavings); skips when hypothesis is not installed
    (tests/_hypo.py optional-skip pattern)."""
    _run_schedule(n_pages, page_size, ops)


# ----------------------------------------------------- prefix cache units


def test_page_hashes_chained():
    ps = 4
    a = np.arange(12, dtype=np.int32)
    b = a.copy()
    b[1] = 99  # diverge inside page 0
    ha, hb = page_hashes(a, ps), page_hashes(b, ps)
    assert len(ha) == 3
    # chaining: identical later pages still hash differently after an
    # earlier divergence (no cross-prompt aliasing)
    assert all(x != y for x, y in zip(ha, hb))
    # partial trailing page is never hashed
    assert len(page_hashes(a[:11], ps)) == 2
    assert page_hashes(a[:11], ps) == ha[:2]


def test_prefix_cache_match_register_evict():
    a = PageAllocator(8, 2)
    pc = PrefixCache(a)
    prompt = np.arange(6, dtype=np.int32)
    hashes = page_hashes(prompt, 2)
    a.alloc("r0")
    pages = a.ensure("r0", 6)
    for h, p in zip(hashes, pages):
        pc.register(h, p)
    assert len(pc) == 3 and all(a.refcount(p) == 2 for p in pages)
    a.free("r0")  # cache holds keep every page alive
    assert all(a.refcount(p) == 1 for p in pages)
    # full match; longest-prefix semantics on divergence
    assert pc.match(prompt) == pages
    div = prompt.copy()
    div[3] = 42
    assert pc.match(div) == pages[:1]
    # eviction respects protect and frees LRU-first
    assert pc.evict(1, protect=pages) == 0  # everything protected
    freed = pc.evict(2)
    assert freed == 2 and len(pc) == 1
    # remaining entry is the most recently used chain head... the two
    # oldest (LRU) entries were dropped and their pages are free again
    assert a.n_free == 6


def test_prefix_cache_evict_all_shared_reclaims_nothing():
    # every cached page is also referenced by a live request (refcount
    # 2): eviction must refuse to unhold any of them — shared pages cost
    # no capacity and yanking one would corrupt the running request
    a = PageAllocator(5, 2)  # 4 data pages + the null page
    pc = PrefixCache(a)
    prompt = np.arange(8, dtype=np.int32)
    a.alloc("r0")
    pages = a.ensure("r0", 8)
    for h, p in zip(page_hashes(prompt, 2), pages):
        pc.register(h, p)
    assert all(a.refcount(p) == 2 for p in pages)
    assert pc.evict(4) == 0
    assert len(pc) == 4 and a.n_free == 0
    # once the request releases its references the same call succeeds
    a.free("r0")
    assert pc.evict(4) == 4 and len(pc) == 0 and a.n_free == 4


