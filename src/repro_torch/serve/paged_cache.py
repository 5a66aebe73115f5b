"""Paged KV cache (port of ``repro.serve.paged_cache``): a host-side
free-list page allocator with refcounted copy-on-write sharing,
per-request page tables, the shared-prefix page cache, and the device
page pools.

The allocator and prefix cache are copies of the reference's numpy code
(the port imports nothing of ``repro``), with its fault-injection hook
(``PageAllocator.fault_hook``), the speculative-decode rollback
(``truncate_to``) and the snapshot export (``export_state``/
``from_state``).  Page 0 is the null page: never allocated, it pads every
page table and absorbs padding-token writes with ``pos = -1``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.attention import NULL_PAGE  # noqa: F401
from repro_torch.models.common import dtype_of


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` logical slots."""
    return max(0, -(-n_tokens // page_size))


class PageAllocator:
    """Free-list page allocator with refcounted pages and per-request
    page tables.

    Invariants: every live page's refcount equals its page-table
    references plus external holds; ``free ∪ live == {1 .. n_pages-1}``;
    the null page is never allocated; a page becomes *dirty* exactly when
    its refcount drops to zero and is scrubbed before its next owner's
    first write (:meth:`note_scrubbed` is the scheduler's receipt).
    """

    def __init__(self, n_pages: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (1 data page + the null page), got {n_pages}"
            )
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list ordered so .pop() hands out low ids first
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}
        self._dirty: set = set()
        self.cow_count = 0  # lifetime copy-on-write duplications
        # fault injection (serve/faults.py): called with the growth size
        # before any page is popped in ensure()/cow(), so an injected
        # raise leaves the allocator untouched; None in production
        self.fault_hook = None

    # ------------------------------------------------------------- queries

    @property
    def n_free(self) -> int:
        return len(self._free)

    def live(self) -> Tuple[int, ...]:
        return tuple(self._tables)

    def page_table(self, rid) -> Tuple[int, ...]:
        return tuple(self._tables[rid])

    def n_slots(self, rid) -> int:
        """Logical capacity currently backed by pages."""
        return len(self._tables[rid]) * self.page_size

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def dirty_pages(self) -> frozenset:
        return frozenset(self._dirty)

    def free_pages(self) -> Tuple[int, ...]:
        """The free list (fault injection scribbles one of these)."""
        return tuple(self._free)

    def slot_of(self, rid, pos: int) -> Tuple[int, int]:
        """Physical ``(page, slot)`` of logical position ``pos``."""
        if pos < 0:
            raise ValueError(f"negative position {pos}")
        table = self._tables[rid]
        idx = pos // self.page_size
        if idx >= len(table):
            raise ValueError(
                f"position {pos} not backed: request {rid!r} holds "
                f"{len(table)} page(s) of {self.page_size}"
            )
        return table[idx], pos % self.page_size

    # ----------------------------------------------------------- mutations

    def alloc(self, rid) -> None:
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already allocated")
        self._tables[rid] = []

    def ensure(self, rid, n_tokens: int) -> List[int]:
        """Grow ``rid``'s table to back ``n_tokens`` slots; returns the new
        page ids.  Raises without side effects when the pool is short."""
        table = self._tables[rid]
        need = pages_for(n_tokens, self.page_size) - len(table)
        if need <= 0:
            return []
        if self.fault_hook is not None:
            self.fault_hook(need)  # may raise before any page is popped
        if need > len(self._free):
            raise ValueError(
                f"out of KV pages: request {rid!r} needs {need} more, "
                f"{len(self._free)} free (pool {self.n_pages}, "
                f"page_size {self.page_size})"
            )
        new = [self._free.pop() for _ in range(need)]
        for p in new:
            self._refs[p] = 1
        table.extend(new)
        return new

    def adopt(self, rid, pages: Sequence[int]) -> None:
        """Share already-live ``pages`` into ``rid``'s table (refcount + 1)."""
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise ValueError(f"cannot adopt non-live page {p}")
        table = self._tables[rid]
        for p in pages:
            self._refs[p] += 1
            table.append(p)

    def hold(self, page: int) -> None:
        if self._refs.get(page, 0) < 1:
            raise ValueError(f"cannot hold non-live page {page}")
        self._refs[page] += 1

    def unhold(self, page: int) -> None:
        self._decref(page)

    def cow(self, rid, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write page ``idx`` of ``rid``'s table: returns the
        ``(src, dst)`` pair whose content the caller must copy before the
        divergent write, or None when the page is already private."""
        table = self._tables[rid]
        src = table[idx]
        if self._refs[src] == 1:
            return None
        if self.fault_hook is not None:
            self.fault_hook(1)
        if not self._free:
            raise ValueError(
                f"out of KV pages: request {rid!r} needs a copy-on-write "
                f"duplicate of page {src}, 0 free (pool {self.n_pages})"
            )
        dst = self._free.pop()
        self._refs[dst] = 1
        self._refs[src] -= 1
        table[idx] = dst
        self.cow_count += 1
        return src, dst

    def truncate_to(self, rid, n_tokens: int) -> List[int]:
        """Roll ``rid``'s table back to the pages backing its first
        ``n_tokens`` slots, dropping its reference on every trailing page
        (returned in table order); pages whose refcount reaches zero
        return to the pool dirty, shared ones stay live."""
        if n_tokens < 0:
            raise ValueError(f"negative truncation point {n_tokens}")
        table = self._tables[rid]
        keep = pages_for(n_tokens, self.page_size)
        dropped = table[keep:]
        del table[keep:]
        # drop in reverse so freshly freed low ids are handed out first
        for p in reversed(dropped):
            self._decref(p)
        return dropped

    def free(self, rid) -> None:
        pages = self._tables.pop(rid)
        for p in reversed(pages):
            self._decref(p)

    def note_scrubbed(self, pages: Sequence[int]) -> None:
        self._dirty.difference_update(pages)

    def _decref(self, page: int) -> None:
        r = self._refs[page] - 1
        if r > 0:
            self._refs[page] = r
            return
        del self._refs[page]
        self._free.append(page)
        self._dirty.add(page)

    def export_state(self) -> dict:
        """JSON-able allocator state.  The free list keeps its order: the
        pop order decides which page each later allocation lands on, so
        restoring it exactly keeps a resumed serve byte-identical."""
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "free": list(self._free),
            "tables": [[rid, list(t)] for rid, t in self._tables.items()],
            "refs": [[p, r] for p, r in self._refs.items()],
            "dirty": sorted(self._dirty),
            "cow_count": self.cow_count,
        }

    @classmethod
    def from_state(cls, state: dict) -> "PageAllocator":
        """An allocator from :meth:`export_state` output (possibly through
        JSON); ``fault_hook`` does not survive."""
        a = cls(int(state["n_pages"]), int(state["page_size"]))
        a._free = [int(p) for p in state["free"]]
        a._tables = {rid: [int(p) for p in t] for rid, t in state["tables"]}
        a._refs = {int(p): int(r) for p, r in state["refs"]}
        a._dirty = set(int(p) for p in state["dirty"])
        a.cow_count = int(state["cow_count"])
        live = set(a._refs)
        if set(a._free) & live or NULL_PAGE in live or NULL_PAGE in a._free:
            raise ValueError("corrupt allocator snapshot: free/live overlap")
        if set(a._free) | live != set(range(1, a.n_pages)):
            raise ValueError("corrupt allocator snapshot: pages leaked or invented")
        return a


# ------------------------------------------------------ shared-prefix cache


def page_hashes(tokens: np.ndarray, page_size: int) -> List[str]:
    """Chained SHA-256 of every *full* page of ``tokens``: each digest
    commits to the whole prefix up to and including its page."""
    out: List[str] = []
    h = hashlib.sha256(str(page_size).encode())
    for i in range(len(tokens) // page_size):
        chunk = np.ascontiguousarray(
            tokens[i * page_size : (i + 1) * page_size], dtype=np.int32
        )
        h.update(chunk.tobytes())
        out.append(h.hexdigest())
    return out


class PrefixCache:
    """Page-granularity shared-prefix cache over a :class:`PageAllocator`:
    chained prompt-page hashes -> live page ids, one allocator hold per
    entry, LRU eviction of pages only the cache keeps alive."""

    def __init__(self, allocator: PageAllocator):
        self.allocator = allocator
        self._entries: "OrderedDict[str, int]" = OrderedDict()
        self.page_lookups = 0
        self.page_hits = 0
        self.insertions = 0
        self.evictions = 0
        self.tokens_total = 0
        self.tokens_saved = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest run of cached pages covering ``prompt``'s full pages."""
        return self.match_hashes(page_hashes(prompt, self.allocator.page_size))

    def match_hashes(self, hashes: Sequence[str]) -> List[int]:
        """Longest run of cached pages for ``hashes`` (refreshes recency)."""
        pages: List[int] = []
        for h in hashes:
            page = self._entries.get(h)
            if page is None:
                break
            self._entries.move_to_end(h)
            pages.append(page)
        return pages

    def register(self, digest: str, page: int) -> None:
        if digest in self._entries:
            return
        self.allocator.hold(page)
        self._entries[digest] = page
        self.insertions += 1

    def evict(self, n_needed: int, protect: Sequence[int] = ()) -> int:
        """Unhold up to ``n_needed`` LRU entries whose page only the cache
        keeps alive, skipping ``protect``; returns pages freed."""
        if n_needed <= 0:
            return 0
        guard = set(protect)
        freed = 0
        for digest, page in list(self._entries.items()):
            if page in guard or self.allocator.refcount(page) != 1:
                continue
            del self._entries[digest]
            self.allocator.unhold(page)
            self.evictions += 1
            freed += 1
            if freed >= n_needed:
                break
        return freed

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "page_lookups": self.page_lookups,
            "page_hits": self.page_hits,
            "hit_rate": self.page_hits / max(1, self.page_lookups),
            "insertions": self.insertions,
            "evictions": self.evictions,
            "prefill_tokens_total": self.tokens_total,
            "prefill_tokens_saved": self.tokens_saved,
        }

    _STATS = ("page_lookups", "page_hits", "insertions", "evictions", "tokens_total",
              "tokens_saved")

    def export_state(self) -> dict:
        """JSON-able state: the entries in LRU to MRU order (eviction
        order is part of deterministic replay) and the lifetime stats."""
        return {"entries": [[h, p] for h, p in self._entries.items()],
                **{k: getattr(self, k) for k in self._STATS}}

    @classmethod
    def from_state(cls, allocator: PageAllocator, state: dict) -> "PrefixCache":
        """A cache over an allocator restored from the same snapshot: its
        holds are in the allocator's refcounts already, so none is taken."""
        pc = cls(allocator)
        for h, p in state["entries"]:
            page = int(p)
            if allocator.refcount(page) < 1:
                raise ValueError(f"corrupt prefix snapshot: entry on non-live page {page}")
            pc._entries[h] = page
        for k in cls._STATS:
            setattr(pc, k, int(state[k]))
        return pc


# -------------------------------------------------------------- device pools


def make_paged_cache(cfg, n_pages: int, page_size: int, device):
    """Device page pools for ``cfg``: ``k/v [L, n_pages, page_size, D]``
    and the shared ``pos [n_pages, page_size]`` table, all slots empty
    (-1).  GQA pages hold ``KV*D`` per plane; MLA's k pages hold the
    ``(c_kv ‖ k_rope)`` latent and its v pages a 1-wide zero dummy.  Under
    the int8 KV wire the planes are int8 with ``k_scale/v_scale
    [L, n_pages, page_size]`` f32 planes — MLA quantizes only the latent
    k plane (a scale plane would cost more than the dummy v it saves)."""
    kv_int8 = cfg.sparsity.kv_dtype == "int8"
    v_int8 = kv_int8 and cfg.mla is None
    native = dtype_of(cfg.dtype)
    k_shape = (cfg.n_layers, n_pages, page_size, cfg.kv_dim())
    v_shape = k_shape[:3] + (1 if cfg.mla is not None else cfg.kv_dim(),)
    cache = {
        "k": torch.zeros(k_shape, dtype=torch.int8 if kv_int8 else native, device=device),
        "v": torch.zeros(v_shape, dtype=torch.int8 if v_int8 else native, device=device),
        "pos": torch.full((n_pages, page_size), -1, dtype=torch.int32, device=device),
    }
    if kv_int8:
        cache["k_scale"] = torch.ones(k_shape[:3], dtype=torch.float32, device=device)
    if v_int8:
        cache["v_scale"] = torch.ones(k_shape[:3], dtype=torch.float32, device=device)
    return cache


def cache_nbytes(cache) -> int:
    """Total bytes of a cache's tensors (a ring or paged cache, or any
    nest of dicts and lists of them).  Reads shapes and dtypes only, so a
    full-size cache made on the ``meta`` device is measured without
    allocating it."""
    from repro_torch.core import tree

    return sum(t.numel() * t.element_size() for t in tree.leaves(cache))
