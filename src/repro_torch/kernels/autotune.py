"""Launch plans of the DBB matmul kernels and the paged-attention choice
behind ``"auto"``: a cache of measured winners, then a heuristic (port of
``repro.kernels.autotune``).

Three layers, checked in order, as in the reference:

1. **Benchmark cache** — exact ``(kind, M, K, N, NNZ, BZ)`` hits from an
   earlier :func:`autotune` sweep (an in-process dict, persisted to JSON
   when ``REPRO_TORCH_AUTOTUNE_CACHE=<path>`` names a file).  An entry
   that is not a legal plan for its kernel is ignored, and a corrupt file
   never breaks a kernel.
2. **Heuristic** — today's fixed rules.
3. **Legality** — every heuristic plan is one the kernel takes, so any
   shape gets a launch.

The reference tunes a Pallas tiling ``(tm, tk, tn)``; a CUDA kernel of
the port has a fixed output tile height (int8) or width (native) chosen
from two, and a K loop split over the blocks of a thread-block cluster.
So its plan is the tc body's ``(bm, kb_per_split, n_split)`` (int8) or
``(bn, kb_per_split, n_split)`` (native).  The rules of those plans live
with the kernels (``dbb_matmul.PLAN_RULES``: ``heuristic_plan``,
``plan_error`` and ``candidate_plans``, in the places of the reference's
``heuristic_tiles`` and ``candidate_tiles``); this module keeps the
cache, the memo and the sweeps, and :func:`get_plan` (the reference's
``get_tiles``) and :func:`autotune` take the rules as an argument.  The
cache variable has its own name so a TPU tile file is never read as a
CUDA plan.  A sweep runs only when a caller asks for one
(:func:`autotune`, :func:`autotune_paged_attn`).

The kinds are the reference's: ``w`` (#1), ``aw`` (#4), ``w_int8`` (#2)
and ``aw_int8`` (#3).  A native plan is keyed with M = 0: it must be a
function of (K, N) only, so every row of a call sums in the same order
whatever M is (batch invariance, and speculative decoding's same bits at
any S).  Integer sums are exact under any split, so the int8 kinds keep
M in the key.

The paged-attention kind's tunable is the implementation, ``"gather"``
(:func:`~repro_torch.models.attention.paged_read`, then plain attention)
or ``"fused"`` (kernel #6): cache first, then the device heuristic —
fused where the compiled kernel runs (a CUDA device), gather elsewhere.
A cached ``"gather"`` verdict takes a CUDA call off kernel #6: each such
call is counted (:func:`cuda_gather_calls`) and warned of once a shape.

:func:`get_plan` runs once a launch, so a resolved plan is memoized per
key; anything that changes the cache clears the memo.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

Plan = Tuple[int, int, int]  # (bm or bn, kb_per_split, n_split)

INT8_KINDS = ("w_int8", "aw_int8")
NATIVE_KINDS = ("w", "aw")
KINDS = NATIVE_KINDS + INT8_KINDS

# (kind, m, k, n, nnz, bz) -> plan, or ("paged_attn", b, sg, ps, dk, 0) -> (impl,)
_CACHE: Dict[Tuple, Tuple] = {}
_CACHE_LOADED = False
_MEMO: Dict[Tuple, Plan] = {}  # get_plan's resolved plans, by key
_CUDA_GATHER_CALLS = 0  # "auto" calls on CUDA that a cached gather verdict took off #6


def _cache_path() -> Optional[str]:
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE") or None


def _load_cache() -> None:
    global _CACHE_LOADED
    if _CACHE_LOADED:
        return
    _CACHE_LOADED = True
    path = _cache_path()
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                raw = json.load(f)
            for k, v in raw.items():
                key = json.loads(k)
                if isinstance(key, list) and len(key) == 6 and isinstance(v, list):
                    _CACHE[tuple(key)] = tuple(v)
        except (OSError, ValueError, TypeError, AttributeError):
            pass  # a corrupt cache must never break the kernels


def _save_cache() -> None:
    path = _cache_path()
    if not path:
        return
    try:
        with open(path, "w") as f:
            json.dump({json.dumps(list(k)): list(v) for k, v in _CACHE.items()}, f)
    except OSError:
        pass


def clear_cache() -> None:
    """Forget the in-process cache, every resolved plan and the count of
    :func:`cuda_gather_calls`; the next lookup reads
    ``REPRO_TORCH_AUTOTUNE_CACHE`` again."""
    global _CACHE_LOADED, _CUDA_GATHER_CALLS
    _CACHE.clear()
    _MEMO.clear()
    _CUDA_GATHER_CALLS = 0
    _CACHE_LOADED = False


# ------------------------------------------------------------ matmul plans


class PlanRules(NamedTuple):
    """A kernel family's plan rules, which its own module owns
    (``dbb_matmul.PLAN_RULES``): ``heuristic(kind, m, k, n)`` the default
    plan, ``error(kind, plan, k, n)`` why a plan is illegal (None when it
    is legal), ``candidates(kind, m, k, n)`` a sweep's legal plans."""

    heuristic: Callable[[str, int, int, int], Plan]
    error: Callable[[str, object, int, int], Optional[str]]
    candidates: Callable[[str, int, int, int], List[Plan]]


def _key(kind: str, m: int, k: int, n: int, nnz: int, bz: int) -> Tuple:
    if kind not in KINDS:
        raise ValueError(f"unknown matmul kind {kind!r}; one of {KINDS}")
    return (kind, 0 if kind in NATIVE_KINDS else m, k, n, nnz, bz)


def _cached_plan(kind: str, key: Tuple, k: int, n: int, rules: PlanRules) -> Optional[Plan]:
    hit = _CACHE.get(key)
    return hit if hit is not None and rules.error(kind, hit, k, n) is None else None


def get_plan(kind: str, m: int, k: int, n: int, nnz: int, bz: int, rules: PlanRules) -> Plan:
    """Resolve the tc body's plan: a benchmark-cache hit that
    ``rules.error`` accepts first, then ``rules.heuristic``.  A native
    kind's key has M = 0."""
    key = _key(kind, m, k, n, nnz, bz)
    plan = _MEMO.get(key)
    if plan is None:
        _load_cache()
        plan = _cached_plan(kind, key, k, n, rules) or rules.heuristic(kind, m, k, n)
        _MEMO[key] = plan
    return plan


def _event_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """Mean device ms of ``reps`` calls of ``fn`` after one warm-up call,
    timed with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sweep(run, candidates, timer, timings):
    """Time each candidate; ``(best, its ms, how many ran)``.  A candidate
    that raises is skipped, as the reference skips an illegal tiling."""
    best, best_t, timed = None, float("inf"), 0
    for cand in candidates:
        try:
            dt = timer(run(cand))
        except Exception as err:  # a candidate this device cannot run: skip it
            if timings is not None:
                timings[cand] = err
            continue
        timed += 1
        if timings is not None:
            timings[cand] = dt
        if dt < best_t:
            best, best_t = cand, dt
    return best, timed


def autotune(
    run: Callable[[Plan], Callable[[], object]],
    m: int,
    k: int,
    n: int,
    nnz: int,
    bz: int = 8,
    kind: str = "w",
    reps: int = 3,
    *,
    rules: PlanRules,
    timer: Optional[Callable[[Callable[[], object]], float]] = None,
    timings: Optional[dict] = None,
) -> Plan:
    """Time every candidate plan (``rules.candidates``) and cache the
    winner.

    ``run(plan)`` returns a nullary callable launching the kernel with that
    plan (closed over the operands); ``timer(fn)`` gives its ms (by default
    the mean of ``reps`` calls after a warm-up, timed with CUDA events).
    ``timings``, when given, gets each candidate's ms (or the exception it
    raised).  The winner is cached only when a candidate ran; when none did
    the heuristic answers, uncached, so a later sweep on a capable device
    is not blocked."""
    _load_cache()
    key = _key(kind, m, k, n, nnz, bz)
    hit = _cached_plan(kind, key, k, n, rules)
    if hit is not None:
        return hit
    timer = timer or (lambda fn: _event_ms(fn, reps))
    best, _ = _sweep(run, rules.candidates(kind, m, k, n), timer, timings)
    if best is None:
        return rules.heuristic(kind, m, k, n)
    _CACHE[key] = best
    _MEMO.clear()
    _save_cache()
    return best


# ------------------------------------------------- paged-attention kind
#
# Kernel #6's blocks are pinned by (page size, head dim), so its tunable is
# the implementation: "gather" (paged_read + plain attention) or "fused"
# (the kernel's page-table walk).  Keys reuse the 6-tuple layout
# ((kind, b, sg, ps, dk, 0)) so one JSON file serves both kinds; values are
# 1-tuples of the implementation's name.

PAGED_ATTN_IMPLS = ("gather", "fused")


def _device_type(device) -> str:
    if device is None:
        import torch

        return "cuda" if torch.cuda.is_available() else "cpu"
    return getattr(device, "type", None) or str(device).split(":")[0]


def heuristic_paged_attn_impl(device=None) -> str:
    """Device heuristic: the fused kernel where it runs (a CUDA device:
    it walks the pages instead of materializing each window); elsewhere
    the gather path, as the reference's is off the TPU ("fused" stays
    available by name, through the kernel's plain version).  ``device`` is
    a ``torch.device`` or its type's name; None asks whether CUDA is
    available."""
    return "fused" if _device_type(device) == "cuda" else "gather"


def get_paged_attn_impl(b: int, sg: int, ps: int, dk: int, device=None) -> str:
    """Resolve the paged-attention implementation for a problem shape on
    ``device``: benchmark cache first, then the device heuristic.

    The key carries no device, so a ``"fused"`` verdict is honored only
    where the kernel runs (CUDA): a cache file tuned on the card must not
    route a CPU engine's ``"auto"`` through the kernel's plain version.
    ``"gather"`` hits hold on any device; on CUDA each is counted
    (:func:`cuda_gather_calls`) and warned of once a shape."""
    _load_cache()
    dev = _device_type(device)
    key = ("paged_attn", b, sg, ps, dk, 0)
    hit = _CACHE.get(key)
    if hit and hit[0] in PAGED_ATTN_IMPLS and (hit[0] != "fused" or dev == "cuda"):
        if hit[0] == "gather" and dev == "cuda":
            global _CUDA_GATHER_CALLS
            _CUDA_GATHER_CALLS += 1
            warnings.warn(f"the autotune cache's gather verdict for {key} takes this CUDA "
                          f"call off the fused paged-attention kernel", stacklevel=2)
        return hit[0]
    return heuristic_paged_attn_impl(dev)


def cuda_gather_calls() -> int:
    """How many :func:`get_paged_attn_impl` calls on a CUDA device a cached
    ``"gather"`` verdict answered: paged reads of ``"auto"`` that left
    kernel #6 for the gather path (0 with no cache file).  Reset by
    :func:`clear_cache`."""
    return _CUDA_GATHER_CALLS


def autotune_paged_attn(
    run: Callable[[str], Callable[[], object]],
    b: int,
    sg: int,
    ps: int,
    dk: int,
    reps: int = 3,
    *,
    timer: Optional[Callable[[Callable[[], object]], float]] = None,
    timings: Optional[dict] = None,
) -> str:
    """Time gather against fused for one shape and cache the winner.

    Same contract as :func:`autotune`.  The winner is cached only when
    every implementation ran: the key carries no device, so a partial
    sweep (a host where the kernel cannot run) answers from what it timed
    without persisting it."""
    _load_cache()
    key = ("paged_attn", b, sg, ps, dk, 0)
    hit = _CACHE.get(key)
    if hit and hit[0] in PAGED_ATTN_IMPLS:
        return hit[0]
    timer = timer or (lambda fn: _event_ms(fn, reps))
    best, timed = _sweep(run, PAGED_ATTN_IMPLS, timer, timings)
    if timed < len(PAGED_ATTN_IMPLS):
        return best if best is not None else heuristic_paged_attn_impl()
    _CACHE[key] = (best,)
    _save_cache()
    return best
