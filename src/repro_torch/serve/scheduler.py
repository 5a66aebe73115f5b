"""Continuous-batching scheduler (port of ``repro.serve.scheduler``).

A numpy copy of the reference's host-side scheduler: iteration-level
admission over the paged KV cache, chunked prefill interleaved with
in-flight decodes, fused multi-token decode runs, shared-prefix page
reuse with copy-on-write, aging preemption with byte-identical replay,
and typed per-request outcomes.  Every mixed step has the shape
``[max_batch, prefill_chunk]``; once no row is prefilling, decode-only
iterations batch into one :class:`DecodeRun` of up to ``decode_block``
tokens per row (``lm.paged_decode_loop``).

Each plan carries its rows' sampling knobs (``samp_*``, idle rows
greedy), and each commit streams the newly committed tokens to the
request's ``on_token`` callback.  Everything of the reference's scheduler
is here: an injected allocator fault (``serve/faults.py``) preempts its
victim (``preempt(req, fault=True)``), :meth:`Scheduler.commit_spec`
commits a speculative round with a per-row page rollback, and
:meth:`Scheduler.export_state`/:meth:`Scheduler.load_state` (with
:func:`request_state`/:func:`request_from_state`) carry the in-flight
state through an engine snapshot.

Token-stream contract: prompt positions ``0..s0-1`` are written during
(chunked) prefill and the chunk holding ``s0-1`` samples the first output
token; decode feeds generated token ``g_i`` at position ``s0+i`` and
samples ``g_{i+1}``; a request finishes after ``max_new_tokens`` samples.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.sampling import TOP_K_DISABLED, SamplingParams
from repro_torch.serve.faults import InjectedAllocFault
from repro_torch.serve.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    PrefixCache,
    page_hashes,
    pages_for,
)

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

# Terminal per-request outcomes (Request.finish_reason / RequestResult).
FINISH_LENGTH = "length"  # completed all max_new_tokens samples
FINISH_STOP = "stop"  # sampled one of the request's stop_tokens
FINISH_DEADLINE = "deadline_exceeded"
FINISH_CANCELLED = "cancelled"
FINISH_REJECTED_CAPACITY = "rejected_capacity"
FINISH_REJECTED_TOO_LARGE = "rejected_too_large"  # set by the engine
FINISH_NUMERICAL = "numerical_error"  # quarantined by the NaN watchdog

FINISH_REASONS = (
    FINISH_LENGTH,
    FINISH_STOP,
    FINISH_DEADLINE,
    FINISH_CANCELLED,
    FINISH_REJECTED_CAPACITY,
    FINISH_REJECTED_TOO_LARGE,
    FINISH_NUMERICAL,
)


class SchedulerInvariantError(RuntimeError):
    """An internal scheduler invariant was violated (a bug, not a user
    error).  Raised instead of ``assert`` so the guard survives
    ``python -O`` and names the plan state that tripped it."""


@dataclasses.dataclass
class Request:
    """One serving request (host-side bookkeeping only)."""

    rid: int
    prompt: np.ndarray  # [S0] int32
    max_new_tokens: int
    arrival: int = 0  # scheduler iteration at which the request appears
    deadline: Optional[int] = None  # last iteration it may still run
    cancel_at: Optional[int] = None  # iteration at which it is cancelled
    # per-request sampling knobs (core/sampling.py); keys derive from
    # (sampling.seed, fed-stream position), so a request's sampled output
    # never depends on batch slot, decode_block, or preemption history
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams
    )
    # sampling any of these token ids ends the request (the stop token
    # IS recorded in `out`) with finish_reason="stop"
    stop_tokens: Optional[frozenset] = None
    # -- runtime state --
    computed: int = 0  # cache positions written so far (prompt + fed decodes)
    out: List[int] = dataclasses.field(default_factory=list)
    state: str = WAITING
    cancelled: bool = False  # a host-initiated cancel (carried by snapshots)
    slot: Optional[int] = None  # batch row while RUNNING
    finish_reason: Optional[str] = None  # terminal outcome (FINISH_*)
    preemptions: int = 0  # times preempted (pages released, re-queued)
    committed: int = 0  # this request's share of the pool's committed pages
    admitted_at: int = -1  # iteration of the most recent admission
    wait_since: int = 0  # iteration it (re)entered the queue
    # -- prefix-cache state --
    hashes: Optional[List[str]] = None  # chained full-page prompt hashes
    reg_pages: int = 0  # prompt pages already published to the cache
    cow_reserved: int = 0  # admission-reserved CoW pages (full-prefix hit)
    # -- streaming delivery --
    # called as on_token(rid, tokens, start) with each newly COMMITTED run
    # of tokens (tokens == out[start:start+len(tokens)]); commits apply
    # stop and watchdog truncation before extending `out`, so a streamed
    # token is never rewound
    on_token: Optional[Callable] = None
    streamed: int = 0  # tokens of `out` already delivered via on_token
    # -- latency clock (host wall time, time.monotonic seconds) --
    t_enqueue: float = 0.0  # Scheduler.add
    t_admit: float = 0.0  # first admission to a batch row
    t_first: float = 0.0  # first committed output token
    t_finish: float = 0.0  # terminal outcome recorded

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_positions(self) -> int:
        """Cache slots the request writes over its whole lifetime: the
        prompt plus every fed decode token (the last sampled token is
        never fed back)."""
        return self.prompt_len + max(0, self.max_new_tokens - 1)

    @property
    def fed_len(self) -> int:
        """Positions of the request's *fed stream* — prompt plus every
        already-sampled token except the last (which is fed next).  After
        preemption, replay re-prefills exactly ``fed_len`` positions
        without sampling, then decode resumes feeding ``out[-1]`` here."""
        return self.prompt_len + max(0, len(self.out) - 1)

    def fed_tokens(self) -> np.ndarray:
        """``prompt ‖ out[:-1]`` — the stream replayed after preemption."""
        return np.concatenate(
            [self.prompt, np.asarray(self.out[:-1], np.int32)]
        ).astype(np.int32)

    def tokens(self) -> np.ndarray:
        """prompt ‖ generated — the stepped engine's output layout."""
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)]
        ).astype(np.int32)


def request_state(req: Request) -> dict:
    """JSON-able state of one request, everything a byte-exact resume
    needs: sampling keys derive from (seed, fed-stream position) and the
    fed stream is ``prompt ‖ out[:-1]``.  ``on_token`` is process-local and
    not captured; ``streamed`` is, so a resumed stream starts at the first
    undelivered token."""
    return {
        "rid": int(req.rid),
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "arrival": int(req.arrival),
        "deadline": req.deadline,
        "cancel_at": req.cancel_at,
        "sampling": dataclasses.asdict(req.sampling),
        "stop_tokens": (sorted(int(t) for t in req.stop_tokens)
                        if req.stop_tokens is not None else None),
        "computed": int(req.computed),
        "out": [int(t) for t in req.out],
        "state": req.state,
        "slot": req.slot,
        "finish_reason": req.finish_reason,
        "preemptions": int(req.preemptions),
        "committed": int(req.committed),
        "admitted_at": int(req.admitted_at),
        "wait_since": int(req.wait_since),
        "cancelled": bool(req.cancelled),
        "hashes": list(req.hashes) if req.hashes is not None else None,
        "reg_pages": int(req.reg_pages),
        "cow_reserved": int(req.cow_reserved),
        "streamed": int(req.streamed),
    }


def request_from_state(d: dict) -> Request:
    """The :class:`Request` of :func:`request_state` output."""
    req = Request(
        rid=int(d["rid"]), prompt=np.asarray(d["prompt"], np.int32),
        max_new_tokens=int(d["max_new_tokens"]), arrival=int(d["arrival"]),
        deadline=d["deadline"], cancel_at=d["cancel_at"],
        sampling=SamplingParams(**d["sampling"]),
        stop_tokens=frozenset(d["stop_tokens"]) if d["stop_tokens"] is not None else None,
    )
    for key in ("computed", "preemptions", "committed", "admitted_at", "wait_since",
                "reg_pages", "cow_reserved", "streamed"):
        setattr(req, key, int(d[key]))
    req.out = [int(t) for t in d["out"]]
    req.state = d["state"]
    req.slot = d["slot"]
    req.finish_reason = d["finish_reason"]
    req.cancelled = bool(d["cancelled"])
    req.hashes = list(d["hashes"]) if d["hashes"] is not None else None
    return req


@dataclasses.dataclass
class StepPlan:
    """Device-ready arrays for one mixed iteration (fixed shapes)."""

    tokens: np.ndarray  # [B, C] int32 (0-padded)
    positions: np.ndarray  # [B, C] int32, -1 = padding
    page_tables: np.ndarray  # [B, P] int32, NULL_PAGE-padded
    sample_idx: np.ndarray  # [B] int32: row's last valid chunk index
    sample_mask: np.ndarray  # [B] bool: row emits a token this step
    samp_temp: np.ndarray  # [B] f32
    samp_top_k: np.ndarray  # [B] int32 (TOP_K_DISABLED = no filter)
    samp_top_p: np.ndarray  # [B] f32
    samp_seed: np.ndarray  # [B] uint32
    rows: List[Optional[Request]]  # per-row request (None = idle)
    n_new: List[int]  # per-row positions written this step
    # pages freshly allocated this step (fixed width, NULL_PAGE-padded):
    # their slot positions must be scrubbed before the step's writes so a
    # recycled page never leaks a previous owner's stale entries
    scrub_pages: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )
    # copy-on-write (src, dst) page pairs (fixed width, (0, 0)-padded):
    # dst must receive src's full content (all KV planes + positions)
    # before this step's writes — after scrubbing, since dst is fresh
    cow_pages: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32)
    )


@dataclasses.dataclass
class DecodeRun:
    """Device-ready arrays for one fused multi-token decode run: every
    active row decodes ``n_steps`` tokens inside a single jitted
    ``lm.paged_decode_loop`` dispatch (sampling fused in-loop)."""

    tokens: np.ndarray  # [B, 1] int32: each row's last sampled token
    positions: np.ndarray  # [B] int32 first write position, -1 = idle row
    page_tables: np.ndarray  # [B, P] int32, NULL_PAGE-padded
    scrub_pages: np.ndarray  # fixed width, NULL_PAGE-padded
    cow_pages: np.ndarray  # [W, 2] (0, 0)-padded
    samp_temp: np.ndarray  # [B] f32
    samp_top_k: np.ndarray  # [B] int32 (TOP_K_DISABLED = no filter)
    samp_top_p: np.ndarray  # [B] f32
    samp_seed: np.ndarray  # [B] uint32
    n_steps: int  # tokens every active row emits this run
    rows: List[Optional[Request]]


class Scheduler:
    """Iteration-level scheduler over ``max_batch`` device rows."""

    def __init__(
        self,
        *,
        max_batch: int,
        page_size: int,
        n_pages: int,
        max_pages_per_req: int,
        prefill_chunk: int,
        decode_block: int = 1,
        allocator: Optional[PageAllocator] = None,
        prefix_cache: Optional[PrefixCache] = None,
        max_queue: Optional[int] = None,
        backpressure: str = "reject",
        preempt_after: Optional[int] = None,
    ):
        if allocator is None:
            allocator = PageAllocator(n_pages, page_size)
        elif (allocator.n_pages, allocator.page_size) != (n_pages, page_size):
            raise ValueError(
                f"allocator pool ({allocator.n_pages} pages of "
                f"{allocator.page_size}) does not match scheduler "
                f"({n_pages} pages of {page_size})"
            )
        if prefix_cache is not None and prefix_cache.allocator is not allocator:
            raise ValueError("prefix cache bound to a different allocator")
        if decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {decode_block}")
        if backpressure not in ("reject", "block"):
            raise ValueError(
                f"unknown backpressure {backpressure!r}; reject|block"
            )
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if preempt_after is not None and preempt_after < 1:
            raise ValueError(
                f"preempt_after must be >= 1, got {preempt_after}"
            )
        self.allocator = allocator
        self.prefix = prefix_cache
        self.max_batch = max_batch
        self.max_pages_per_req = max_pages_per_req
        self.prefill_chunk = prefill_chunk
        self.decode_block = decode_block
        self.max_queue = max_queue
        self.backpressure = backpressure
        self.preempt_after = preempt_after
        self.slots: List[Optional[Request]] = [None] * max_batch
        # arrival buffer (not yet visible) -> bounded queue (admissible)
        self.pending: List[Request] = []
        self.queue: List[Request] = []
        self.iteration = 0
        # pages committed to live requests but not yet allocated — the
        # admission guard that keeps on-demand growth failure-free
        self._committed = 0
        # ---- robustness stats (merged into Engine.health()) ----
        self.preemptions = 0  # total (aging + fault-driven)
        self.preemptions_fault = 0  # of which: injected allocator faults
        self.quarantines = 0  # rows finished by the NaN watchdog
        self.queue_high_water = 0  # max bounded-queue depth observed
        self.finished_by_reason: Dict[str, int] = {}
        # fixed scrub widths: a row writing n positions can cross at most
        # pages_for(n) + 1 page boundaries, bounding fresh allocations per
        # step/run for every trace shape; CoW adds at most one duplicate
        # per row (only the single recomputed position of a full-prefix
        # hit can land in a shared page)
        self.scrub_width = max_batch * (
            pages_for(prefill_chunk, page_size) + 1 + 1
        )
        self.run_scrub_width = max_batch * (
            pages_for(decode_block, page_size) + 1 + 1
        )
        self.cow_width = max_batch
        # persistent plan buffers: mutated in place every iteration
        # instead of reallocating per tick (StepPlan/DecodeRun alias
        # them; each plan must be consumed before the next is built)
        b, p, c = max_batch, max_pages_per_req, prefill_chunk
        self._tokens = np.zeros((b, c), np.int32)
        self._positions = np.full((b, c), -1, np.int32)
        self._tables = np.full((b, p), NULL_PAGE, np.int32)
        self._sample_idx = np.zeros((b,), np.int32)
        self._sample_mask = np.zeros((b,), bool)
        self._samp_temp = np.zeros((b,), np.float32)
        self._samp_top_k = np.full((b,), TOP_K_DISABLED, np.int32)
        self._samp_top_p = np.ones((b,), np.float32)
        self._samp_seed = np.zeros((b,), np.uint32)
        self._scrub = np.full((self.scrub_width,), NULL_PAGE, np.int32)
        self._cow = np.full((self.cow_width, 2), NULL_PAGE, np.int32)
        self._run_tokens = np.zeros((b, 1), np.int32)
        self._run_positions = np.full((b,), -1, np.int32)
        self._run_scrub = np.full((self.run_scrub_width,), NULL_PAGE, np.int32)
        self._run_cow = np.full((self.cow_width, 2), NULL_PAGE, np.int32)
        # per-row page-table staleness: the [B, P] buffer row is only
        # rewritten when the row's table actually changed
        self._table_stale = [True] * b

    # ------------------------------------------------------------ lifecycle

    def add(self, req: Request) -> None:
        ps = self.allocator.page_size
        need = pages_for(req.total_positions, ps)
        if need > self.max_pages_per_req:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"{req.max_new_tokens} new tokens needs {need} pages, page "
                f"table holds {self.max_pages_per_req} (page_size {ps})"
            )
        if req.t_enqueue == 0.0:
            req.t_enqueue = time.monotonic()
        self.pending.append(req)

    def cancel(self, rid: int) -> bool:
        """Request cancellation of ``rid`` (pending, queued, or running).
        Takes effect at the next reap; returns False for unknown/finished
        rids."""
        for req in self.pending + self.queue + [r for r in self.slots if r is not None]:
            if req.rid == rid:
                req.cancelled = True
                return True
        return False

    def has_work(self) -> bool:
        return (
            any(r is not None for r in self.slots)
            or bool(self.queue)
            or bool(self.pending)
        )

    def stats(self) -> Dict[str, int]:
        """Robustness counters (Engine.health() accumulates these)."""
        out = {
            "preemptions": self.preemptions,
            "preemptions_fault": self.preemptions_fault,
            "quarantines": self.quarantines,
            "queue_high_water": self.queue_high_water,
        }
        for reason in FINISH_REASONS:
            out[f"finished_{reason}"] = self.finished_by_reason.get(reason, 0)
        return out

    # ------------------------------------------------ snapshot (durability)

    def export_state(self) -> dict:
        """JSON-able state at an iteration boundary (every commit applied,
        no plan outstanding).  The plan buffers are not captured: they are
        functions of the page tables and the requests, rebuilt by the
        first plan after a restore.  Only in-flight requests are exported."""
        reqs = list(self.pending) + list(self.queue) + [r for r in self.slots if r is not None]
        return {
            "iteration": int(self.iteration),
            "committed": int(self._committed),
            "preemptions": int(self.preemptions),
            "preemptions_fault": int(self.preemptions_fault),
            "quarantines": int(self.quarantines),
            "queue_high_water": int(self.queue_high_water),
            "finished_by_reason": dict(self.finished_by_reason),
            "slots": [r.rid if r is not None else None for r in self.slots],
            "queue": [r.rid for r in self.queue],
            "pending": [r.rid for r in self.pending],
            "requests": [request_state(r) for r in reqs],
        }

    def load_state(self, state: dict) -> List[Request]:
        """Load :meth:`export_state` output into this fresh scheduler, whose
        allocator comes from the same snapshot (running rows are checked
        against its page tables).  Returns the requests ordered by rid."""
        if self.has_work() or self.iteration != 0:
            raise SchedulerInvariantError(
                "load_state requires a fresh scheduler (it has work or a non-zero "
                "iteration clock)"
            )
        if len(state["slots"]) != self.max_batch:
            raise SchedulerInvariantError(
                f"snapshot has {len(state['slots'])} batch rows, scheduler has "
                f"{self.max_batch} — ServeConfig mismatch"
            )
        by_rid = {int(d["rid"]): request_from_state(d) for d in state["requests"]}
        self.iteration = int(state["iteration"])
        self._committed = int(state["committed"])
        self.preemptions = int(state["preemptions"])
        self.preemptions_fault = int(state["preemptions_fault"])
        self.quarantines = int(state["quarantines"])
        self.queue_high_water = int(state["queue_high_water"])
        self.finished_by_reason = dict(state["finished_by_reason"])
        self.pending = [by_rid[rid] for rid in state["pending"]]
        self.queue = [by_rid[rid] for rid in state["queue"]]
        live = set(self.allocator.live())
        for slot, rid in enumerate(state["slots"]):
            if rid is None:
                continue
            req = by_rid[rid]
            if req.state != RUNNING or req.slot != slot:
                raise SchedulerInvariantError(
                    f"snapshot slot {slot} disagrees with request {rid} "
                    f"(state={req.state!r}, slot={req.slot})"
                )
            if rid not in live:
                raise SchedulerInvariantError(
                    f"running request {rid} has no page table in the restored allocator"
                )
            self.slots[slot] = req
        return [by_rid[rid] for rid in sorted(by_rid)]

    # ------------------------------------------------- abort / preempt paths

    def _abort(self, req: Request, reason: str) -> None:
        """Finish ``req`` with a non-``length`` outcome wherever it lives
        (pending, queue, or a batch row), releasing any held pages."""
        if req in self.pending:
            self.pending.remove(req)
        if req in self.queue:
            self.queue.remove(req)
        if req.state == RUNNING:
            self._register_prefix(req)  # computed prompt pages stay useful
            self.allocator.free(req.rid)
            self._committed -= req.committed
            req.committed = 0
            slot = req.slot
            self.slots[slot] = None
            self._table_stale[slot] = True
        req.state = FINISHED
        req.slot = None
        req.finish_reason = reason
        req.t_finish = time.monotonic()
        self.finished_by_reason[reason] = (
            self.finished_by_reason.get(reason, 0) + 1
        )

    def preempt(self, req: Request, *, fault: bool = False) -> None:
        """Preempt-and-recompute: publish ``req``'s fully computed prompt
        pages to the prefix cache (readmission re-adopts them), release
        every page, reset progress, and re-queue at the TAIL — so the
        victim cannot immediately reclaim the pages it just gave up."""
        if req.state != RUNNING:
            raise SchedulerInvariantError(
                f"preempt of non-running request {req.rid} "
                f"(state={req.state!r})"
            )
        self._register_prefix(req)
        self.allocator.free(req.rid)
        self._committed -= req.committed
        req.committed = 0
        slot = req.slot
        self.slots[slot] = None
        self._table_stale[slot] = True
        req.slot = None
        req.state = WAITING
        req.computed = 0
        req.cow_reserved = 0
        # pages it published are cache-held; readmission re-adopts them
        # (reg_pages is re-derived from the adoption hit count there)
        req.reg_pages = 0
        req.preemptions += 1
        req.wait_since = self.iteration
        self.preemptions += 1
        if fault:
            self.preemptions_fault += 1
        self.queue.append(req)

    def _reap(self) -> None:
        """Pre-admission housekeeping: apply cancellations and deadline
        expiries, then move arrived requests from the arrival buffer into
        the bounded queue (backpressure policy decides overflow)."""
        it = self.iteration
        for req in (
            list(self.pending)
            + list(self.queue)
            + [r for r in self.slots if r is not None]
        ):
            if req.state == FINISHED:
                continue
            if req.cancelled or (req.cancel_at is not None and it >= req.cancel_at):
                self._abort(req, FINISH_CANCELLED)
            elif req.deadline is not None and it >= req.deadline:
                self._abort(req, FINISH_DEADLINE)
        for req in list(self.pending):
            if req.arrival > it:
                continue
            if self.max_queue is not None and len(self.queue) >= self.max_queue:
                if self.backpressure == "reject":
                    self._abort(req, FINISH_REJECTED_CAPACITY)
                # "block": stays in the arrival buffer; its effective
                # arrival is delayed until the queue drains
                continue
            self.pending.remove(req)
            req.wait_since = it
            self.queue.append(req)
        self.queue_high_water = max(self.queue_high_water, len(self.queue))

    def _admission_shape(self, req: Request, hits: int):
        """(need, cow_extra) for admitting ``req`` with ``hits`` adopted
        prefix pages.  ``cap`` is the position of its first write: the
        last prompt token for a fresh request (sampling needs its
        logits), the full fed stream for a preempted replay (nothing is
        re-sampled).  A CoW duplicate is reserved only when that first
        write lands inside an adopted page."""
        ps = self.allocator.page_size
        cap = req.fed_len if req.out else req.prompt_len - 1
        need = pages_for(req.total_positions, ps) - hits
        cow_extra = 1 if hits * ps > cap else 0
        return need, cow_extra, cap

    def _preempt_for_starvation(self, waiter: Request) -> bool:
        """Aging preemption: ``waiter`` has been stuck ``preempt_after``
        iterations, so evict the youngest running request — IF its
        reclaimable pages would actually cover the waiter's shortfall,
        and it has itself run at least ``preempt_after`` iterations
        (anti-thrash: a request cannot ping-pong every round)."""
        runners = [r for r in self.slots if r is not None]
        if not runners:
            return False
        victim = max(runners, key=lambda r: (r.admitted_at, r.rid))
        if victim is waiter:
            return False
        if self.iteration - victim.admitted_at < self.preempt_after:
            return False
        a = self.allocator
        reclaim = victim.committed + sum(
            1 for p in a.page_table(victim.rid) if a.refcount(p) == 1
        )
        hits = 0
        if self.prefix is not None and waiter.hashes is not None:
            hits = len(self.prefix.match_hashes(waiter.hashes))
        need, cow_extra, _ = self._admission_shape(waiter, hits)
        short = need + cow_extra - (a.n_free - self._committed)
        if short <= 0 or reclaim < short:
            return False
        self.preempt(victim)
        return True

    def _admit(self) -> None:
        """Fill free rows from the queue (FIFO among arrived requests),
        admitting only requests whose *lifetime* page needs fit in
        free-minus-committed — growth of admitted requests never fails
        (the admission guard below).

        With a prefix cache attached, each candidate's prompt is matched
        against cached pages first: hits are adopted (shared, not
        recomputed), shrinking both the pages needed and the prefill
        work; under pool pressure, LRU cache-only pages are evicted to
        make room (never pages a running request still references).

        Requests that can never fit — even with the pool otherwise idle
        and the cache fully evicted — finish as ``rejected_capacity``
        instead of deadlocking the loop.
        """
        ps = self.allocator.page_size
        preempted_this_round = False
        for slot in range(self.max_batch):
            if self.slots[slot] is not None:
                continue
            pick, hits = None, []
            for req in self.queue:
                cand: List[int] = []
                if self.prefix is not None:
                    if req.hashes is None:
                        req.hashes = page_hashes(req.prompt, ps)
                    cand = self.prefix.match_hashes(req.hashes)
                need, cow_extra, cap = self._admission_shape(req, len(cand))
                short = (
                    need + cow_extra
                    - (self.allocator.n_free - self._committed)
                )
                if short > 0 and self.prefix is not None:
                    self.prefix.evict(short, protect=cand)
                if (
                    need + cow_extra
                    <= self.allocator.n_free - self._committed
                ):
                    pick, hits = req, cand
                    break
                if (
                    not preempted_this_round
                    and self.preempt_after is not None
                    and self.iteration - req.wait_since >= self.preempt_after
                    and self._preempt_for_starvation(req)
                ):
                    preempted_this_round = True
                    need, cow_extra, cap = self._admission_shape(
                        req, len(cand)
                    )
                    if (
                        need + cow_extra
                        <= self.allocator.n_free - self._committed
                    ):
                        pick, hits = req, cand
                        break
            if pick is None:
                continue
            self.queue.remove(pick)
            self.allocator.alloc(pick.rid)
            need, cow_extra, cap = self._admission_shape(pick, len(hits))
            if hits:
                self.allocator.adopt(pick.rid, hits)
                pick.computed = min(len(hits) * ps, cap)
                pick.reg_pages = len(hits)  # digests already published
            pick.committed = need + cow_extra
            self._committed += pick.committed
            pick.cow_reserved = cow_extra
            if self.prefix is not None:
                self.prefix.page_lookups += len(pick.hashes)
                self.prefix.page_hits += len(hits)
                self.prefix.tokens_total += pick.prompt_len
                self.prefix.tokens_saved += min(
                    pick.computed, pick.prompt_len
                )
            pick.state = RUNNING
            pick.slot = slot
            pick.admitted_at = self.iteration
            if pick.t_admit == 0.0:
                pick.t_admit = time.monotonic()
            self.slots[slot] = pick
            self._table_stale[slot] = True
        if all(s is None for s in self.slots) and self.queue:
            # nothing is running, eviction already ran dry, and no queued
            # request fits: no future release can ever help, so these are
            # typed per-request rejections — never an engine exception
            for req in list(self.queue):
                self._abort(req, FINISH_REJECTED_CAPACITY)

    # ------------------------------------------------------------- planning

    def plan(self):
        """Build the next unit of work, or None when no row has work this
        iteration (call :meth:`tick` to advance past future arrivals).

        Returns a :class:`StepPlan` while any active row is still in
        prefill (mixed step, fixed ``[B, prefill_chunk]`` shape), and a
        :class:`DecodeRun` once the whole batch is decoding (up to
        ``decode_block`` tokens per row in one fused dispatch).
        """
        self._reap()
        self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return None
        if any(r.computed < r.fed_len for r in active):
            return self._plan_mixed()
        return self._plan_decode_run(active)

    def _cow_for_write(self, req, start: int, end: int, cow_pairs, fresh):
        """Privatize (copy-on-write) every shared page the write range
        ``[start, end)`` touches, and release the admission-time CoW
        reservation once the request's first write has been planned."""
        a = self.allocator
        ps = a.page_size
        for idx in range(start // ps, (end - 1) // ps + 1):
            if a.refcount(a.page_table(req.rid)[idx]) > 1:
                pair = a.cow(req.rid, idx)
                cow_pairs.append(pair)
                # dst pops off the free list like any fresh page: scrub
                # it (clears its dirty mark) before the copy lands
                fresh.append(pair[1])
                self._table_stale[req.slot] = True
        if req.cow_reserved:
            self._committed -= req.cow_reserved
            req.committed -= req.cow_reserved
            req.cow_reserved = 0

    def _sync_table_row(self, slot: int, req: Optional[Request]) -> None:
        if not self._table_stale[slot]:
            return
        self._tables[slot] = NULL_PAGE
        if req is not None:
            t = self.allocator.page_table(req.rid)
            self._tables[slot, : len(t)] = t
        self._table_stale[slot] = False

    def _sync_samp_row(self, slot: int, req: Optional[Request]) -> None:
        """Mirror the row's sampling knobs into the plan buffers; idle rows
        reset to greedy (their samples are padding no one reads)."""
        if req is None:
            self._samp_temp[slot] = 0.0
            self._samp_top_k[slot] = TOP_K_DISABLED
            self._samp_top_p[slot] = 1.0
            self._samp_seed[slot] = 0
        else:
            sp = req.sampling
            self._samp_temp[slot] = sp.temperature
            self._samp_top_k[slot] = TOP_K_DISABLED if sp.top_k is None else sp.top_k
            self._samp_top_p[slot] = sp.top_p
            self._samp_seed[slot] = np.uint32(sp.seed)

    def _grow_for_write(self, req, end: int, fresh, cow_pairs) -> None:
        """Allocate pages backing positions up to ``end`` and privatize
        shared pages in the write range.  An injected allocator fault
        (raised before any pop, so the allocator is clean) propagates to
        the planner, which preempts the victim and drops its partial
        ``cow_pairs``: its pages are freed, and a copy into one would
        clobber a page a later row may take fresh in the same step."""
        slot = req.slot
        grown = self.allocator.ensure(req.rid, end)
        self._committed -= len(grown)
        req.committed -= len(grown)
        fresh.extend(grown)
        if grown:
            self._table_stale[slot] = True
        self._cow_for_write(req, req.computed, end, cow_pairs, fresh)

    def _plan_mixed(self) -> Optional[StepPlan]:
        b, c = self.max_batch, self.prefill_chunk
        tokens, positions = self._tokens, self._positions
        tokens[:] = 0
        positions[:] = -1
        self._sample_idx[:] = 0
        self._sample_mask[:] = False
        rows: List[Optional[Request]] = [None] * b
        n_new = [0] * b
        fresh: List[int] = []
        cow_pairs: List[tuple] = []

        for slot, req in enumerate(self.slots):
            if req is None:
                self._sync_table_row(slot, None)
                self._sync_samp_row(slot, None)
                continue
            fl = req.fed_len
            if req.computed < fl:  # chunked (re)prefill of the fed stream
                n = min(c, fl - req.computed)
                stream = (
                    req.prompt if not req.out else req.fed_tokens()
                )
                tokens[slot, :n] = stream[req.computed : req.computed + n]
                # sample only when completing a FRESH prefill: a replayed
                # fed stream's outputs are already known (preemption
                # exactness hinges on not re-sampling them)
                sample = req.computed + n == fl and not req.out
            else:  # decode: feed the last sampled token
                n = 1
                tokens[slot, 0] = req.out[-1]
                sample = True
            positions[slot, :n] = np.arange(
                req.computed, req.computed + n, dtype=np.int32
            )
            n_cow0 = len(cow_pairs)
            try:
                self._grow_for_write(req, req.computed + n, fresh, cow_pairs)
            except InjectedAllocFault:
                # fault-driven preemption: the row becomes padding, the
                # co-batched rows carry on
                del cow_pairs[n_cow0:]
                tokens[slot] = 0
                positions[slot] = -1
                self._sample_idx[slot] = 0
                self._sample_mask[slot] = False
                self.preempt(req, fault=True)
                self._sync_table_row(slot, None)
                self._sync_samp_row(slot, None)
                continue
            self._sync_table_row(slot, req)
            self._sync_samp_row(slot, req)
            self._sample_idx[slot] = n - 1
            self._sample_mask[slot] = sample
            rows[slot] = req
            n_new[slot] = n
        if len(fresh) > self.scrub_width:
            raise SchedulerInvariantError(
                f"mixed-step scrub overflow at iteration {self.iteration}: "
                f"{len(fresh)} fresh pages {fresh} exceed scrub_width "
                f"{self.scrub_width} (rows="
                f"{[r.rid if r else None for r in rows]}, n_new={n_new})"
            )
        if len(cow_pairs) > self.cow_width:
            raise SchedulerInvariantError(
                f"mixed-step CoW overflow at iteration {self.iteration}: "
                f"{len(cow_pairs)} pairs {cow_pairs} exceed cow_width "
                f"{self.cow_width} (rows="
                f"{[r.rid if r else None for r in rows]})"
            )
        if all(r is None for r in rows):
            return None  # every row was preempted mid-plan
        self._scrub[:] = NULL_PAGE
        self._scrub[: len(fresh)] = fresh
        self._cow[:] = NULL_PAGE
        if cow_pairs:
            self._cow[: len(cow_pairs)] = np.asarray(cow_pairs, np.int32)
        self.allocator.note_scrubbed(fresh)
        return StepPlan(
            tokens, positions, self._tables, self._sample_idx,
            self._sample_mask, self._samp_temp, self._samp_top_k,
            self._samp_top_p, self._samp_seed, rows, n_new,
            self._scrub, self._cow,
        )

    def _event_horizon(self) -> Optional[int]:
        """Iterations until the next schedule-visible event (arrival,
        deadline, cancel_at) — fused decode runs must not step past it,
        so run-length choice never changes admission/abort timing vs the
        one-token-at-a-time schedule."""
        it = self.iteration
        deltas = []
        everyone = (
            self.pending
            + self.queue
            + [r for r in self.slots if r is not None]
        )
        for req in self.pending:
            if req.arrival > it:
                deltas.append(req.arrival - it)
        for req in everyone:
            if req.deadline is not None and req.deadline > it:
                deltas.append(req.deadline - it)
            if req.cancel_at is not None and req.cancel_at > it:
                deltas.append(req.cancel_at - it)
        return min(deltas) if deltas else None

    def _plan_decode_run(self, active: List[Request]) -> Optional[DecodeRun]:
        b = self.max_batch
        k = min(r.max_new_tokens - len(r.out) for r in active)
        horizon = self._event_horizon()
        if horizon is not None:
            k = min(k, horizon)
        k = int(max(1, min(k, self.decode_block)))
        tokens, positions = self._run_tokens, self._run_positions
        tokens[:] = 0
        positions[:] = -1
        rows: List[Optional[Request]] = [None] * b
        fresh: List[int] = []
        cow_pairs: List[tuple] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                self._sync_table_row(slot, None)
                self._sync_samp_row(slot, None)
                continue
            tokens[slot, 0] = req.out[-1]
            positions[slot] = req.computed
            n_cow0 = len(cow_pairs)
            try:
                self._grow_for_write(req, req.computed + k, fresh, cow_pairs)
            except InjectedAllocFault:
                del cow_pairs[n_cow0:]
                tokens[slot, 0] = 0
                positions[slot] = -1
                self.preempt(req, fault=True)
                self._sync_table_row(slot, None)
                self._sync_samp_row(slot, None)
                continue
            self._sync_table_row(slot, req)
            self._sync_samp_row(slot, req)
            rows[slot] = req
        if len(fresh) > self.run_scrub_width:
            raise SchedulerInvariantError(
                f"decode-run scrub overflow at iteration {self.iteration}: "
                f"{len(fresh)} fresh pages {fresh} exceed run_scrub_width "
                f"{self.run_scrub_width} (n_steps={k}, rows="
                f"{[r.rid if r else None for r in rows]})"
            )
        if len(cow_pairs) > self.cow_width:
            raise SchedulerInvariantError(
                f"decode-run CoW overflow at iteration {self.iteration}: "
                f"{len(cow_pairs)} pairs {cow_pairs} exceed cow_width "
                f"{self.cow_width} (n_steps={k}, rows="
                f"{[r.rid if r else None for r in rows]})"
            )
        if all(r is None for r in rows):
            return None  # every row was preempted mid-plan
        self._run_scrub[:] = NULL_PAGE
        self._run_scrub[: len(fresh)] = fresh
        self._run_cow[:] = NULL_PAGE
        if cow_pairs:
            self._run_cow[: len(cow_pairs)] = np.asarray(cow_pairs, np.int32)
        self.allocator.note_scrubbed(fresh)
        return DecodeRun(
            tokens, positions, self._tables, self._run_scrub, self._run_cow,
            self._samp_temp, self._samp_top_k, self._samp_top_p,
            self._samp_seed, k, rows,
        )

    def tick(self) -> None:
        """Advance one iteration without compute (future arrivals only)."""
        self.iteration += 1

    # --------------------------------------------------------------- commit

    def _register_prefix(self, req: Request) -> None:
        """Publish every fully computed full prompt page to the prefix
        cache (idempotent; adopted pages' digests are already present)."""
        if self.prefix is None:
            return
        ps = self.allocator.page_size
        limit = min(req.computed, req.prompt_len) // ps
        table = None
        while req.reg_pages < limit:
            if table is None:
                table = self.allocator.page_table(req.rid)
            self.prefix.register(req.hashes[req.reg_pages], table[req.reg_pages])
            req.reg_pages += 1

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.state = FINISHED
        req.slot = None
        req.finish_reason = reason
        req.t_finish = time.monotonic()
        self.finished_by_reason[reason] = (
            self.finished_by_reason.get(reason, 0) + 1
        )
        self.allocator.free(req.rid)
        self._committed -= req.committed
        req.committed = 0
        self.slots[slot] = None
        self._table_stale[slot] = True

    def _note_progress(self, req: Request) -> None:
        """Post-commit per-row bookkeeping: stamp the first-token clock and
        flush newly committed tokens to the request's streaming callback.
        Called only after a commit has applied its truncation (stop rewind,
        watchdog cut) to ``req.out``, so the streamed sequence is always a
        prefix of the final output; a preempted request replays without
        sampling, so it streams only past what it already delivered."""
        if req.t_first == 0.0 and req.out:
            req.t_first = time.monotonic()
        cb = req.on_token
        if cb is not None and len(req.out) > req.streamed:
            start = req.streamed
            new = [int(t) for t in req.out[start:]]
            req.streamed = len(req.out)
            cb(req.rid, new, start)

    def _quarantine(self, slot: int, req: Request) -> None:
        """The engine's watchdog saw non-finite logits on this row: free
        and scrub its pages, finish it as ``numerical_error``.  Pages it
        published to the prefix cache in EARLIER (healthy) commits stay —
        their content predates the fault."""
        self.quarantines += 1
        self._finish(slot, req, FINISH_NUMERICAL)

    def commit(
        self,
        plan: StepPlan,
        sampled: np.ndarray,
        ok: Optional[np.ndarray] = None,
    ) -> None:
        """Apply one step's results: advance positions, record sampled
        tokens, publish finished prompt pages, retire finished requests
        (their non-shared pages return to the pool and the row frees for
        next iteration's admission).  ``ok`` is the watchdog verdict per
        row (PRE-sampling logits all finite); a False row is quarantined
        instead of extended — its garbage sample is never recorded.  A
        sampled stop token finishes the row as ``"stop"`` (taking
        precedence over a simultaneous length finish; the stop token is
        recorded in the output)."""
        self.iteration += 1
        for slot, req in enumerate(plan.rows):
            if req is None:
                continue
            req.computed += plan.n_new[slot]
            self._register_prefix(req)
            if plan.sample_mask[slot]:
                if ok is not None and not bool(ok[slot]):
                    self._quarantine(slot, req)
                else:
                    tok = int(sampled[slot])
                    req.out.append(tok)
                    if req.stop_tokens and tok in req.stop_tokens:
                        self._finish(slot, req, FINISH_STOP)
                    elif len(req.out) >= req.max_new_tokens:
                        self._finish(slot, req, FINISH_LENGTH)
            self._note_progress(req)

    def commit_run(
        self,
        run: DecodeRun,
        sampled: np.ndarray,
        bad_at: Optional[np.ndarray] = None,
    ) -> None:
        """Apply a fused decode run: every active row advances ``n_steps``
        positions and gains ``n_steps`` sampled tokens.  ``bad_at`` is
        the in-loop watchdog verdict: the first loop index whose
        (pre-sampling) logits were non-finite for that row (>= n_steps
        when clean).  A poisoned row keeps only its pre-fault tokens and
        is quarantined.

        **Stop-token rewind.**  Stop tokens are a schedule-visible event
        the planner cannot see in advance (deadlines enter the event
        horizon; a sampled token does not exist until the run executes),
        so they are enforced post-hoc: the earliest stop across the batch
        truncates the WHOLE run to ``trunc = j + 1`` iterations — every
        row keeps only ``trunc`` tokens and the clock advances ``trunc``.
        The discarded suffix is pure speculation that never happened:
        re-decoding it later reproduces the same tokens byte-for-byte
        (position-keyed sampling; KV rewrites of the same positions are
        deterministic, and stale future entries are masked by the
        ``k_pos <= q_pos`` causal guard).  The resulting schedule is
        therefore identical to ``decode_block=1`` — a stopping request
        frees its row/pages at the same iteration, so admission timing
        does not depend on run length (tests/test_sampling.py)."""
        k = run.n_steps
        trunc = k
        stop_at: Dict[int, int] = {}
        for slot, req in enumerate(run.rows):
            if req is None or not req.stop_tokens:
                continue
            bad = int(bad_at[slot]) if bad_at is not None else k
            for j in range(min(k, bad)):
                if int(sampled[slot, j]) in req.stop_tokens:
                    stop_at[slot] = j
                    trunc = min(trunc, j + 1)
                    break
        self.iteration += trunc
        for slot, req in enumerate(run.rows):
            if req is None:
                continue
            bad = int(bad_at[slot]) if bad_at is not None else k
            if bad < trunc:
                req.computed += bad
                req.out.extend(int(x) for x in sampled[slot, :bad])
                self._quarantine(slot, req)
                self._note_progress(req)
                continue
            req.computed += trunc
            req.out.extend(int(x) for x in sampled[slot, :trunc])
            self._register_prefix(req)
            if stop_at.get(slot) == trunc - 1:
                self._finish(slot, req, FINISH_STOP)
            elif len(req.out) >= req.max_new_tokens:
                self._finish(slot, req, FINISH_LENGTH)
            self._note_progress(req)

    def commit_spec(
        self,
        run: DecodeRun,
        kept: np.ndarray,
        sampled: np.ndarray,
        bad_rows: Optional[np.ndarray] = None,
    ) -> None:
        """Apply a speculative draft-then-verify round of a decode plan.

        ``sampled[slot, :k]`` holds the target's verified tokens of the
        window, ``kept[slot]`` how many of them equal solo decode (>= 1
        for a healthy row, fewer for a faulted one).  Unlike
        :meth:`commit_run`'s whole-batch rewind, truncation is per row:

        * a stop token inside the kept prefix cuts the row there (kept,
          ``"stop"``); a fault after the stop is moot;
        * ``bad_rows`` (non-finite draft or target logits): the row keeps
          its ``kept`` clean tokens and is quarantined;
        * every surviving row's page table is rolled back to its committed
          length (``PageAllocator.truncate_to``): pages backing only the
          rejected suffix return to the pool and are re-charged to the
          row's lifetime reservation, and stale in-page KV past the cut is
          causally masked until overwritten;
        * the clock advances by the largest keep (>= 1), never past the
          planner's ``n_steps``.

        Committed tokens stream through ``on_token`` as in :meth:`commit`."""
        advance = 1
        for slot, req in enumerate(run.rows):
            if req is None:
                continue
            n_keep = int(kept[slot])
            bad = bad_rows is not None and bool(bad_rows[slot])
            stopped = False
            if req.stop_tokens:
                for j in range(n_keep):
                    if int(sampled[slot, j]) in req.stop_tokens:
                        n_keep = j + 1
                        stopped = True
                        bad = False  # the fault landed after the stop
                        break
            req.computed += n_keep
            req.out.extend(int(x) for x in sampled[slot, :n_keep])
            advance = max(advance, n_keep)
            if bad:
                self._quarantine(slot, req)
                self._note_progress(req)
                continue
            self._register_prefix(req)
            if stopped:
                self._finish(slot, req, FINISH_STOP)
                self._note_progress(req)
                continue
            if len(req.out) >= req.max_new_tokens:
                self._finish(slot, req, FINISH_LENGTH)
                self._note_progress(req)
                continue
            self._note_progress(req)
            dropped = self.allocator.truncate_to(req.rid, req.computed)
            if dropped:
                # re-grown if the row runs on: re-charge them to the
                # reservation (the free pool grew by as much)
                self._committed += len(dropped)
                req.committed += len(dropped)
                self._table_stale[slot] = True
        self.iteration += advance
