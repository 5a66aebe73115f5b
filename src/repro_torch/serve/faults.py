"""Seeded fault injection for the continuous serving loop (port of
``repro.serve.faults``).

Hooks that make the loop's "can't happen" paths happen on demand, so the
recovery machinery (preempt-and-recompute, the gather fallback, per-row
quarantine: ``serve/scheduler.py`` and ``serve/engine.py``) runs
deterministically in tests.  Four hooks share one numpy PRNG seeded from
:attr:`FaultConfig.seed`, drawn in the reference's order, so a seed fires
the same faults as the reference's:

* **Allocator failure** (``alloc_fail_p``): ``PageAllocator.ensure`` and
  ``cow`` raise :class:`InjectedAllocFault` with probability ``p`` a
  growth, before any page is popped.  The scheduler preempts the victim
  request; the engine never fails.
* **Fused-kernel failure** (``fail_fused``): the fused paged-attention
  front end (``kernels/ops.paged_attention``) raises
  :class:`FusedKernelFault` once.  The engine falls back to the gather
  path, one way, and retries the dispatch.  The reference raises at trace
  time, before any device state changes; the port runs eagerly, so the
  fault lands after the dispatch's page maintenance and its first
  layer's writes, and the retry repeats them (``Engine._guarded``).
* **NaN logits** (``nan_rids``): the engine poisons the listed requests'
  logits with NaN at their first sampling step; the watchdog quarantines
  exactly those rows, co-batched rows stay byte-identical.
* **Page-scrub corruption** (``scrub_corrupt_p``): finite garbage with
  valid-looking slot positions is scribbled into a free page between
  steps; scrub-on-hand-out makes it unobservable.

A fifth hook is a process death: **kill points** (``kill_at`` /
``kill_point``) raise :class:`SimulatedCrash` at a named site of the serve
loop (:data:`KILL_POINTS`).  The engine never catches it; recovery is
``Engine.restore`` from the last published snapshot.

The fused-kernel hook is reached from kernel code, which knows no engine,
so it reads a module-level injector that an engine activates only around
its own dispatches (:class:`scoped`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


class FaultError(RuntimeError):
    """Base class of injected faults (never raised by real code paths)."""


class InjectedAllocFault(FaultError):
    """Injected page-allocator failure (simulated pool exhaustion)."""


class FusedKernelFault(FaultError):
    """Injected fused paged-attention kernel failure."""


class SimulatedCrash(FaultError):
    """Simulated SIGKILL: the engine must not handle it.  It propagates
    out of the serve loop and leaves whatever host and device state
    existed at the kill point; the engine object is dead by contract."""


#: Named kill sites, in loop order (``Engine._run_loop``):
#: ``iteration`` — the iteration boundary before ``plan()``, where
#: snapshots are taken; ``pre_commit`` — after a dispatch, before its
#: scheduler commit (device KV advanced, host bookkeeping not);
#: ``mid_save`` — inside ``checkpoint.manager.save`` after the tmp dir is
#: written, before the atomic rename.
KILL_POINTS = ("iteration", "pre_commit", "mid_save")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """What to inject, and with which seed (see the module docstring)."""

    seed: int = 0
    alloc_fail_p: float = 0.0  # P(InjectedAllocFault) per ensure/cow growth
    fail_fused: bool = False  # force the fused kernel to fail (once)
    nan_rids: Tuple[int, ...] = ()  # rids whose first sampled logits go NaN
    scrub_corrupt_p: float = 0.0  # P(scribble a free page) per step
    # rids whose draft watchdog verdict is forced bad in their first
    # speculative round (the draft loop's logits stay inside its dispatch)
    nan_draft_rids: Tuple[int, ...] = ()
    # on the kill_at-th visit to the kill_point site, raise SimulatedCrash
    kill_at: Optional[int] = None
    kill_point: str = "iteration"

    def __post_init__(self):
        for name in ("alloc_fail_p", "scrub_corrupt_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.kill_point not in KILL_POINTS:
            raise ValueError(
                f"kill_point must be one of {KILL_POINTS}, got {self.kill_point!r}"
            )
        if self.kill_at is not None and self.kill_at < 1:
            raise ValueError(f"kill_at must be >= 1, got {self.kill_at}")


class FaultInjector:
    """The stateful side of one :class:`FaultConfig` (one PRNG stream); its
    counters record what fired (``Engine.health()``)."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._fused_pending = cfg.fail_fused
        self._poisoned: set = set()
        self._draft_poisoned: set = set()
        self.alloc_faults = 0
        self.fused_faults = 0
        self.nan_poisons = 0
        self.draft_nan_poisons = 0
        self.scribbles = 0
        self.kills = 0
        self._kill_countdown = cfg.kill_at

    def maybe_kill(self, site: str) -> None:
        """Raise :class:`SimulatedCrash` on the ``kill_at``-th visit to the
        configured site; one death per injector."""
        if self._kill_countdown is None or site != self.cfg.kill_point:
            return
        self._kill_countdown -= 1
        if self._kill_countdown <= 0:
            self._kill_countdown = None
            self.kills += 1
            raise SimulatedCrash(
                f"simulated SIGKILL at kill point {site!r} "
                f"(kill_at={self.cfg.kill_at}, seed={self.cfg.seed})"
            )

    def alloc_hook(self, need: int) -> None:
        """``PageAllocator.fault_hook``: raises before any page is popped,
        so an injected failure has no side effect."""
        if self.cfg.alloc_fail_p and self._rng.random() < self.cfg.alloc_fail_p:
            self.alloc_faults += 1
            raise InjectedAllocFault(
                f"injected allocator failure (need={need}, "
                f"p={self.cfg.alloc_fail_p}, seed={self.cfg.seed})"
            )

    def check_fused(self) -> None:
        """Called from the fused front end while this injector is scoped.
        Fires once: the fallback is one way, so a second trip could only
        mask a fault of the fallback itself."""
        if self._fused_pending:
            self._fused_pending = False
            self.fused_faults += 1
            raise FusedKernelFault(
                f"injected fused paged_attn kernel failure (seed={self.cfg.seed})"
            )

    def poison_mask(self, rows, sample_mask) -> Optional[np.ndarray]:
        """Rows of this step whose logits go NaN: listed rids, at their
        first sampling step only; None when nothing fires."""
        if not self.cfg.nan_rids:
            return None
        mask = np.zeros((len(rows),), bool)
        for slot, req in enumerate(rows):
            if (req is not None and sample_mask[slot] and req.rid in self.cfg.nan_rids
                    and req.rid not in self._poisoned):
                self._poisoned.add(req.rid)
                mask[slot] = True
                self.nan_poisons += 1
        return mask if mask.any() else None

    def draft_poison_mask(self, rows) -> Optional[np.ndarray]:
        """Rows of this speculative round whose draft verdict is forced
        bad: listed rids, at their first round only; None when nothing
        fires."""
        if not self.cfg.nan_draft_rids:
            return None
        mask = np.zeros((len(rows),), bool)
        for slot, req in enumerate(rows):
            if (req is not None and req.rid in self.cfg.nan_draft_rids
                    and req.rid not in self._draft_poisoned):
                self._draft_poisoned.add(req.rid)
                mask[slot] = True
                self.draft_nan_poisons += 1
        return mask if mask.any() else None

    def scribble_page(self, free_pages: Sequence[int]) -> Optional[int]:
        """A free page to corrupt this step, or None (never the null
        page: the free list excludes it)."""
        if not self.cfg.scrub_corrupt_p or not free_pages:
            return None
        if self._rng.random() >= self.cfg.scrub_corrupt_p:
            return None
        self.scribbles += 1
        return int(free_pages[self._rng.integers(len(free_pages))])


_ACTIVE: Optional[FaultInjector] = None


class scoped:
    """Context manager activating ``injector`` for the kernel-side hook
    (:func:`check_fused`) during one engine dispatch; ``None`` is a no-op
    scope."""

    def __init__(self, injector: Optional[FaultInjector]):
        self._injector = injector

    def __enter__(self):
        global _ACTIVE
        self._prev = _ACTIVE
        if self._injector is not None:
            _ACTIVE = self._injector
        return self._injector

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def check_fused() -> None:
    """Kernel-side hook: a no-op unless an injector is scoped and armed to
    fail the fused kernel."""
    if _ACTIVE is not None:
        _ACTIVE.check_fused()
