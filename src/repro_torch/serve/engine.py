"""Continuous-batching serving engine (port of the continuous half of
``repro.serve.engine``).

``Engine(params, cfg, ServeConfig(...), device=...).generate_requests(...)``
serves requests of mixed lengths with staggered arrivals over the paged
KV cache: the scheduler (``serve/scheduler.py``) plans each iteration,
``lm.paged_step`` runs mixed prefill/decode steps and
``lm.paged_decode_loop`` runs decode-only stretches, one host sync per
step or run.  Weights serve packed on the DBB wire: ``wire_dtype="native"``
(the default, values in the model dtype, kernels #1 and #4) or ``"int8"``
(kernels #2 and #3, with per-row dynamic activation scales).  Either way
every kernel sums a row in an order that does not depend on the batch,
so a request's tokens never depend on what it is batched with.  Dense
decoders with GQA or MLA attention, MoE decoders and the VLM backbone
(M-RoPE, text tokens) are served.

This is the continuous path only.  Every other setting raises
``NotImplementedError`` naming the ROADMAP item that will lift it:
other prefill modes, unpacked weights, sampled decoding, speculative
decoding, the gather attention path, snapshots and the ssm, hybrid and
encdec families.
A kernel failure raises; there is no fallback path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sampling import SamplingParams, sample_tokens, validate_sampling
from repro_torch.models import common, lm
from repro_torch.serve import paged_cache
from repro_torch.serve.scheduler import FINISH_LENGTH, DecodeRun, Request, Scheduler


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs, with the reference's names and meanings.

    ``page_size``/``max_pages``/``max_batch``/``prefill_chunk`` shape the
    paged cache and the scheduler; ``decode_block`` caps the tokens a
    decode-only run emits per dispatch; ``prefix_cache`` keeps computed
    prompt pages for reuse across calls; ``max_queue``/``backpressure``/
    ``preempt_after`` bound overload (see ``serve/scheduler.py``).

    Every field of the reference is here, with its default and its
    validation: a config the reference refuses raises ``ValueError``
    here too.  ``paged_attn``: ``"auto"`` and ``"fused"`` both run the
    fused kernel (#6), ``"gather"`` is not ported.  ``snapshot_dir``/
    ``snapshot_every``/``snapshot_keep`` are checked as the reference
    checks them, and ``snapshot_every > 0`` is not ported.
    ``hang_threshold`` is checked (> 1) and kept; the watchdog that
    reads it comes with the rest of the engine (ROADMAP queue 1, item 8).
    """

    max_seq: int = 512
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    seed: int = 0
    pack_weights: bool = True
    wire_dtype: str = "native"
    kv_dtype: str = "native"
    prefill_mode: str = "continuous"
    page_size: int = 16
    max_pages: Optional[int] = None
    max_batch: int = 4
    prefill_chunk: int = 8
    paged_attn: str = "auto"
    decode_block: int = 16
    prefix_cache: bool = True
    max_queue: Optional[int] = None
    backpressure: str = "reject"
    preempt_after: Optional[int] = None
    spec: Optional[object] = None
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    snapshot_keep: int = 3
    hang_threshold: float = 10.0

    def __post_init__(self):
        # the reference's checks first, then the limits of this port
        validate_sampling(
            self.temperature, self.top_k, self.top_p, self.seed, where="ServeConfig"
        )
        if self.wire_dtype not in ("native", "int8"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}; native|int8")
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; native|int8")
        if self.backpressure not in ("reject", "block"):
            raise ValueError(f"unknown backpressure {self.backpressure!r}; reject|block")
        if self.paged_attn not in ("auto", "gather", "fused"):
            raise ValueError(f"unknown paged_attn {self.paged_attn!r}; auto|gather|fused")
        for name in ("max_seq", "page_size", "max_batch", "prefill_chunk", "decode_block"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.preempt_after is not None and self.preempt_after < 1:
            raise ValueError(f"preempt_after must be >= 1, got {self.preempt_after}")
        if self.snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, got {self.snapshot_every}")
        if self.snapshot_every and self.snapshot_dir is None:
            raise ValueError("snapshot_every > 0 requires snapshot_dir")
        if self.snapshot_keep < 1:
            raise ValueError(f"snapshot_keep must be >= 1, got {self.snapshot_keep}")
        if self.hang_threshold <= 1.0:
            raise ValueError(f"hang_threshold must be > 1, got {self.hang_threshold}")
        if self.max_pages is not None and self.max_pages < self.pages_per_request + 1:
            raise ValueError(
                f"max_pages={self.max_pages} cannot hold one max_seq={self.max_seq} "
                f"request: need >= {self.pages_per_request} data pages + 1 null page"
            )
        if self.prefill_mode != "continuous":
            raise _not_ported(f"prefill_mode={self.prefill_mode!r}", "queue 1, item 8")
        if not self.pack_weights:
            raise _not_ported("serving unpacked (dense) weights", "queue 1, item 7")
        if self.spec is not None:
            raise _not_ported("speculative decoding (spec)", "queue 1, item 8")
        if self.paged_attn == "gather":
            raise _not_ported("the gather paged-attention path (paged_attn='gather')",
                              "queue 1, item 8")
        if self.snapshot_every:
            raise _not_ported("snapshots (snapshot_every)", "queue 1, item 8")

    @property
    def pages_per_request(self) -> int:
        return paged_cache.pages_for(self.max_seq, self.page_size)

    @property
    def total_pages(self) -> int:
        if self.max_pages is not None:
            return self.max_pages
        return self.max_batch * self.pages_per_request + 1


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome of the last :meth:`Engine.generate_requests`
    call: ``tokens`` is ``prompt ‖ generated``; the latency fields are
    host wall-clock seconds from the scheduler's ``time.monotonic`` stamps
    (enqueue -> first admission, enqueue -> first committed token, and
    generated tokens over enqueue -> finish)."""

    rid: int
    tokens: np.ndarray
    n_generated: int
    finish_reason: str
    preemptions: int = 0
    queue_time: float = 0.0
    time_to_first_token: float = 0.0
    tokens_per_second: float = 0.0


def _result(req: Request) -> RequestResult:
    queue_time = max(0.0, req.t_admit - req.t_enqueue) if req.t_admit else 0.0
    ttft = max(0.0, req.t_first - req.t_enqueue) if req.t_first else 0.0
    span = max(0.0, req.t_finish - req.t_enqueue) if req.t_finish else 0.0
    return RequestResult(
        rid=req.rid, tokens=req.tokens(), n_generated=len(req.out),
        finish_reason=req.finish_reason or FINISH_LENGTH,
        preemptions=req.preemptions, queue_time=queue_time,
        time_to_first_token=ttft,
        tokens_per_second=len(req.out) / span if span > 0 and req.out else 0.0,
    )


def pack_params_for_serving(params, cfg, wire_dtype: str = "native"):
    """Convert every DBB-eligible linear to the packed wire format of
    ``wire_dtype``; the embedding, norms, router and MLA's ``kv_up`` (its
    absorbed attention reads the raw weight per head) stay dense, and
    already-packed linears pass through."""
    sp = cfg.sparsity

    def walk(p, path=""):
        if isinstance(p, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(p)]
        if isinstance(p, dict):
            if "w" in p and getattr(p["w"], "ndim", 0) == 2:
                name = path.lower()
                eligible = (
                    not any(s in name for s in ("embed", "router", "norm", "ln", "kv_up"))
                    and p["w"].shape[-2] % sp.bz == 0
                )
                if eligible:
                    return common.pack_linear_params(p, sp, wire_dtype)
            return {k: walk(v, path + "/" + k) for k, v in p.items()}
        return p

    return walk(params)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    """Greedy continuous-batching engine over DBB-packed weights."""

    def __init__(self, params, cfg, scfg: ServeConfig, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine: no CUDA device; pass device='cpu' to serve on the CPU "
                    "with the kernels' plain versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        lm._check_family(cfg)
        if cfg.sparsity.mode not in ("wdbb", "awdbb"):
            raise ValueError(
                "packed serving needs a wdbb/awdbb sparsity mode, got "
                f"{cfg.sparsity.mode!r}"
            )
        self.scfg = scfg
        self.params = pack_params_for_serving(
            _to_device(params, self.device), cfg, scfg.wire_dtype
        )
        # per-row (per-token) activation scales on every int8-wire path make
        # the integer-exact datapath batch-invariant (the native wire
        # quantizes no activation)
        sp = dataclasses.replace(cfg.sparsity, kv_dtype=scfg.kv_dtype)
        if scfg.wire_dtype == "int8":
            sp = dataclasses.replace(sp, act_scale="per_row")
        self.cfg = dataclasses.replace(cfg, sparsity=sp)
        self.step_calls = 0  # mixed steps + decode runs dispatched
        self.decode_run_calls = 0  # decode runs among them
        self.last_results: List[RequestResult] = []
        self._cont = None  # allocator, prefix cache, device cache
        self._rid = 0

    # -------------------------------------------------------- requests

    def _validate_request(self, i: int, prompt, n_tok: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError(f"request {i}: empty prompt")
        if n_tok < 1:
            raise ValueError(f"request {i}: n_tokens must be >= 1")
        bad = (prompt < 0) | (prompt >= self.cfg.vocab)
        if bad.any():
            j = int(np.argmax(bad))
            raise ValueError(
                f"request {i}: token id {int(prompt[j])} at position {j} "
                f"is outside the vocab [0, {self.cfg.vocab})"
            )
        total = prompt.shape[0] + n_tok - 1
        if total > self.scfg.max_seq:
            raise ValueError(
                f"request {i}: prompt {prompt.shape[0]} + {n_tok} new tokens needs "
                f"{total} cache positions, max_seq={self.scfg.max_seq}"
            )
        return prompt

    @staticmethod
    def _per_request(name, val, n, default):
        out = [default if val is None else val] * n if val is None or np.isscalar(val) else list(val)
        if len(out) != n:
            raise ValueError(f"{name} has {len(out)} entries for {n} prompts")
        return out

    def _sampling_list(self, sampling, n: int) -> List[SamplingParams]:
        if sampling is None:
            return [SamplingParams(seed=self.scfg.seed)] * n
        if isinstance(sampling, SamplingParams):
            return [sampling] * n
        out = [SamplingParams(seed=self.scfg.seed) if s is None else s for s in sampling]
        if len(out) != n:
            raise ValueError(f"sampling has {len(out)} entries for {n} prompts")
        return out

    def _stop_list(self, stop_tokens, n: int) -> List[Optional[frozenset]]:
        def _set(i, seq):
            if seq is None:
                return None
            toks = frozenset(int(t) for t in seq)
            for t in toks:
                if not 0 <= t < self.cfg.vocab:
                    raise ValueError(
                        f"request {i}: stop token {t} is outside the vocab "
                        f"[0, {self.cfg.vocab})"
                    )
            return toks or None

        if stop_tokens is None:
            return [None] * n
        seq = list(stop_tokens)
        if all(isinstance(t, (int, np.integer)) for t in seq):
            return [_set(i, seq) for i in range(n)]
        if len(seq) != n:
            raise ValueError(f"stop_tokens has {len(seq)} entries for {n} prompts")
        return [_set(i, s) for i, s in enumerate(seq)]

    def generate_requests(self, prompts: Sequence[np.ndarray], n_tokens,
                          arrivals: Optional[Sequence[int]] = None, sampling=None,
                          stop_tokens=None) -> List[np.ndarray]:
        """Continuous-batched greedy generation: ``prompts`` of mixed
        lengths, ``n_tokens`` one int or one per request, ``arrivals`` the
        scheduler iteration at which each request appears (default 0).
        Returns ``prompt ‖ generated`` per request, in input order; the
        typed outcomes (finish reason, latency) land in
        :attr:`last_results`.  The whole list is validated before any
        request is queued.  The paged cache, allocator and prefix cache
        persist across calls."""
        n = len(prompts)
        n_list = self._per_request("n_tokens", n_tokens, n, None)
        arr_list = self._per_request("arrivals", arrivals, n, 0)
        samp_list = self._sampling_list(sampling, n)
        stop_list = self._stop_list(stop_tokens, n)
        clean = [self._validate_request(i, p, n_list[i]) for i, p in enumerate(prompts)]
        reqs = []
        for i, p in enumerate(clean):
            self._rid += 1
            reqs.append(Request(
                rid=self._rid, prompt=p, max_new_tokens=n_list[i],
                arrival=arr_list[i], sampling=samp_list[i], stop_tokens=stop_list[i],
            ))
        self._serve(reqs)
        self.last_results = [_result(r) for r in reqs]
        return [r.tokens() for r in reqs]

    def prefix_stats(self) -> dict:
        if self._cont is not None and self._cont["prefix"] is not None:
            return self._cont["prefix"].stats()
        return {}

    # ------------------------------------------------------- the loop

    def _ensure_cont(self) -> dict:
        scfg = self.scfg
        if self._cont is None:
            allocator = paged_cache.PageAllocator(scfg.total_pages, scfg.page_size)
            self._cont = {
                "allocator": allocator,
                "prefix": paged_cache.PrefixCache(allocator) if scfg.prefix_cache else None,
                "cache": paged_cache.make_paged_cache(
                    self.cfg, scfg.total_pages, scfg.page_size, self.device
                ),
            }
        return self._cont

    def _make_scheduler(self) -> Scheduler:
        scfg = self.scfg
        cont = self._ensure_cont()
        return Scheduler(
            max_batch=scfg.max_batch, page_size=scfg.page_size,
            n_pages=scfg.total_pages, max_pages_per_req=scfg.pages_per_request,
            prefill_chunk=scfg.prefill_chunk, decode_block=scfg.decode_block,
            allocator=cont["allocator"], prefix_cache=cont["prefix"],
            max_queue=scfg.max_queue, backpressure=scfg.backpressure,
            preempt_after=scfg.preempt_after,
        )

    def _serve(self, reqs: Sequence[Request]) -> None:
        sched = self._make_scheduler()
        for req in reqs:
            sched.add(req)
        self._run_loop(sched)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: the scheduler reuses its plan buffers
        return torch.tensor(a, device=self.device)

    def _pages(self, scrub: np.ndarray, cow: np.ndarray):
        """Drop the null-page padding of the scrub/CoW lists (scrubbing or
        copying the null page onto itself changes nothing)."""
        scrub = scrub[scrub != paged_cache.NULL_PAGE]
        cow = cow[cow[:, 1] != paged_cache.NULL_PAGE]
        return (
            self._tensor(scrub) if scrub.size else None,
            self._tensor(cow) if cow.size else None,
        )

    def _run_loop(self, sched: Scheduler) -> None:
        """Plan, dispatch and commit until every request has finished; one
        host sync per mixed step or decode run (reading its tokens)."""
        cont = self._ensure_cont()
        cache = cont["cache"]
        v = self.cfg.vocab
        while sched.has_work():
            plan = sched.plan()
            if plan is None:  # only future arrivals left: advance time
                sched.tick()
                continue
            self.step_calls += 1
            scrub, cow = self._pages(plan.scrub_pages, plan.cow_pages)
            tables = self._tensor(plan.page_tables)
            if isinstance(plan, DecodeRun):
                self.decode_run_calls += 1
                sampled, bad_at, cache = lm.paged_decode_loop(
                    self.params, cache, self._tensor(plan.tokens),
                    self._tensor(plan.positions), tables, plan.n_steps, self.cfg,
                    max_steps=self.scfg.decode_block, scrub_pages=scrub, cow_pages=cow,
                )
                sched.commit_run(plan, sampled.cpu().numpy(), bad_at=bad_at.cpu().numpy())
            else:
                logits, cache = lm.paged_step(
                    self.params, cache, self._tensor(plan.tokens),
                    self._tensor(plan.positions), tables, self.cfg,
                    scrub_pages=scrub, cow_pages=cow,
                )
                b = logits.shape[0]
                rows = logits[
                    torch.arange(b, device=self.device),
                    self._tensor(plan.sample_idx).long(), :v,
                ]
                tok = sample_tokens(rows)
                ok = torch.isfinite(rows).all(dim=-1)
                sched.commit(plan, tok.cpu().numpy(), ok=ok.cpu().numpy())
        cont["cache"] = cache
