"""Serving engine (port of ``repro.serve.engine``): prefill and seeded
sampled decode (greedy at ``temperature=0``) for the attention families.

``prefill_mode`` picks how prompts reach the cache, as in the reference:

* ``"batched"`` (what ``"auto"`` resolves to): :meth:`Engine.generate`
  prefills the whole prompt in one ``lm.prefill`` call over the ring
  cache, then decodes in lock step (``lm.decode_step``);
* ``"stepped"``: the prompt goes in one ``lm.decode_step`` a token;
* ``"continuous"``: :meth:`Engine.generate_requests` and
  :meth:`Engine.serve_requests` (every mode) serve requests of mixed
  lengths with staggered arrivals over the paged KV cache — the
  scheduler (``serve/scheduler.py``) plans each iteration,
  ``lm.paged_step`` runs mixed prefill/decode steps and
  ``lm.paged_decode_loop`` decode-only stretches, one host sync per step
  or run.

Every path samples with the one seeded sampler (``core/sampling.py``),
keyed on ``(seed, fed-stream position)``, so sampled output is
byte-identical across the modes.  ``pack_weights=True`` serves the
linears packed on the DBB wire: ``wire_dtype="native"`` (values in the
model dtype, kernels #1 and #4) or ``"int8"`` (kernels #2 and #3, with
per-row dynamic activation scales); otherwise the weights stay dense and
DAP (#5's dense form) prunes each linear's input before a plain matmul.
Every kernel sums a row in an order that does not depend on the batch,
so on packed weights a request's tokens never depend on what it is
batched with (MoE aside: expert capacity couples a step's tokens); the
library matmul that serves dense weights on CUDA promises no such
order.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: speculative decoding, snapshots, and the ssm, hybrid and encdec
families.  A kernel failure raises; there is no fallback path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sampling import (
    TOP_K_DISABLED,
    SamplingParams,
    device_sampling,
    sample_or_greedy,
    validate_sampling,
)
from repro_torch.models import common, lm
from repro_torch.serve import paged_cache
from repro_torch.serve.scheduler import (
    FINISH_LENGTH,
    FINISH_REJECTED_TOO_LARGE,
    FINISH_STOP,
    DecodeRun,
    Request,
    Scheduler,
)

# families whose ring cache lm.prefill fills exactly (attention only);
# the continuous path shares the set
BATCHED_PREFILL_FAMILIES = ("dense", "moe", "vlm")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs, with the reference's names, defaults and meanings.

    ``prefill_mode``: ``"auto"`` (``"batched"`` for the attention
    families), ``"batched"``, ``"stepped"`` or ``"continuous"`` (see the
    module docstring); ``generate_requests`` and ``serve_requests`` are
    continuous in every mode.  ``temperature``/``top_k``/``top_p``/``seed``
    are the engine-wide sampling defaults; continuous requests may
    override them with ``SamplingParams``.  ``pack_weights`` serves the
    DBB-eligible linears packed on ``wire_dtype`` (under a wdbb/awdbb
    sparsity mode); the int8 wire needs it.

    ``page_size``/``max_pages``/``max_batch``/``prefill_chunk`` shape the
    paged cache and the scheduler; ``decode_block`` caps the tokens a
    decode-only run emits per dispatch; ``prefix_cache`` keeps computed
    prompt pages for reuse across calls; ``max_queue``/``backpressure``/
    ``preempt_after`` bound overload (see ``serve/scheduler.py``).

    Every field of the reference is here, with its default and its
    validation: a config the reference refuses raises ``ValueError``
    here too.  ``paged_attn``: ``"auto"`` and ``"fused"`` both run the
    fused kernel (#6), ``"gather"`` materializes each request's window
    and attends in plain PyTorch.  ``snapshot_dir``/
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
    pack_weights: bool = False
    wire_dtype: str = "native"
    kv_dtype: str = "native"
    prefill_mode: str = "auto"
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
        if self.spec is not None:
            raise _not_ported("speculative decoding (spec)", "queue 1, item 8")
        if self.snapshot_every:
            raise _not_ported("snapshots (snapshot_every)", "queue 1, item 8")

    @property
    def sampling_params(self) -> SamplingParams:
        """The config's sampling defaults as per-request params."""
        return SamplingParams(temperature=self.temperature, top_k=self.top_k,
                              top_p=self.top_p, seed=self.seed)

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
    """Typed per-request outcome of :meth:`Engine.serve_requests` (and of
    the last :meth:`Engine.generate_requests` call, in
    ``Engine.last_results``).  ``finish_reason`` is ``"length"``,
    ``"stop"`` or a degraded outcome (``"rejected_too_large"``,
    ``"rejected_capacity"``, ``"deadline_exceeded"``, ``"cancelled"``,
    ``"numerical_error"``); ``tokens`` is ``prompt ‖ generated``.  The
    latency fields are host wall-clock seconds from the scheduler's
    ``time.monotonic`` stamps (enqueue -> first admission, enqueue ->
    first committed token, and generated tokens over enqueue -> finish),
    0.0 where the event never happened."""

    rid: int
    tokens: np.ndarray
    n_generated: int
    finish_reason: str
    preemptions: int = 0
    queue_time: float = 0.0
    time_to_first_token: float = 0.0
    tokens_per_second: float = 0.0

    @property
    def ok(self) -> bool:
        return self.finish_reason in (FINISH_LENGTH, FINISH_STOP)


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
    """The serving engine over dense or DBB-packed weights: one-shot and
    stepped :meth:`generate`, continuous :meth:`generate_requests` and
    :meth:`serve_requests`."""

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
        packing = scfg.pack_weights and cfg.sparsity.mode in ("wdbb", "awdbb")
        if scfg.wire_dtype != "native" and not packing:
            # never serve full precision while the caller believes the
            # int8 wire is active
            raise ValueError(
                "wire_dtype='int8' requires pack_weights=True and a wdbb/awdbb "
                f"sparsity mode (got pack_weights={scfg.pack_weights}, "
                f"mode={cfg.sparsity.mode!r})"
            )
        self.scfg = scfg
        params = _to_device(params, self.device)
        if packing:
            params = pack_params_for_serving(params, cfg, scfg.wire_dtype)
        self.params = params
        # the effective config every path shares: per-row (per-token)
        # activation scales on the int8 wire make the integer-exact
        # datapath batch-invariant (the native wire quantizes no
        # activation); the KV dtype; the paged read
        sp = dataclasses.replace(cfg.sparsity, kv_dtype=scfg.kv_dtype)
        if scfg.wire_dtype == "int8":
            sp = dataclasses.replace(sp, act_scale="per_row")
        if scfg.paged_attn != "auto":
            sp = dataclasses.replace(sp, paged_attn=scfg.paged_attn)
        self.cfg = dataclasses.replace(cfg, sparsity=sp)
        self.prefill_calls = 0  # one-shot prefills + stepped prompt tokens
        self.decode_calls = 0  # one-shot/stepped decode steps
        self.step_calls = 0  # continuous mixed steps + decode runs dispatched
        self.decode_run_calls = 0  # decode runs among them
        self.last_results: List[RequestResult] = []
        self._cont = None  # allocator, prefix cache, device cache
        self._rid = 0

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    # ------------------------------------------------ one-shot / stepped

    def _resolve_prefill_mode(self) -> str:
        mode = self.scfg.prefill_mode
        if mode == "auto":
            return "batched" if self.cfg.family in BATCHED_PREFILL_FAMILIES else "stepped"
        if mode not in ("batched", "stepped", "continuous"):
            raise ValueError(
                f"unknown prefill_mode {mode!r}; one of auto|batched|stepped|continuous"
            )
        if mode in ("batched", "continuous") and self.cfg.family not in BATCHED_PREFILL_FAMILIES:
            raise ValueError(
                f"prefill_mode={mode!r} unsupported for family {self.cfg.family!r}: "
                "lm cannot fill recurrent state exactly (use 'auto' or 'stepped')"
            )
        return mode

    def _prefill_batched(self, toks, cache):
        """Whole-prompt prefill: one call fills the ring and returns the
        logits of every prompt position."""
        self.prefill_calls += 1
        return lm.prefill(self.params, toks, self.cfg, cache=cache)

    def _prefill_stepped(self, toks, cache):
        """Per-token prefill through ``lm.decode_step``."""
        logits = None
        for t in range(toks.shape[1]):
            self.prefill_calls += 1
            logits, cache = lm.decode_step(self.params, cache, toks[:, t:t + 1], t, self.cfg)
        return logits, cache

    def _sampling_arrays(self, b: int) -> Optional[tuple]:
        """The config's sampling defaults for ``b`` rows (the one-shot and
        stepped paths apply one config to every row); None when greedy."""
        sp = self.scfg.sampling_params
        top_k = TOP_K_DISABLED if sp.top_k is None else sp.top_k
        return device_sampling(
            np.full((b,), sp.temperature, np.float32), np.full((b,), top_k, np.int32),
            np.full((b,), sp.top_p, np.float32), np.full((b,), sp.seed, np.uint32),
            self.device,
        )

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """``prompts [B, S0]`` int32 -> tokens ``[B, S0 + n_tokens]``.

        Decode samples with the config's ``temperature``/``top_k``/
        ``top_p``/``seed`` (greedy at ``temperature=0``); output token ``i``
        is keyed on its fed-stream position ``s0 - 1 + i``, so it equals
        the continuous path's under the same config.  The loop only
        enqueues device work; the tokens are read once at the end."""
        prompts = np.asarray(prompts, np.int32)
        b, s0 = prompts.shape
        mode = self._resolve_prefill_mode()
        if mode == "continuous":
            return np.stack(self.generate_requests([prompts[i] for i in range(b)], n_tokens))
        cache = lm.make_cache(self.cfg, b, self.scfg.max_seq, self.device)
        toks = self._tensor(prompts)
        if mode == "batched":
            logits, cache = self._prefill_batched(toks, cache)
        else:
            logits, cache = self._prefill_stepped(toks, cache)
        samp = self._sampling_arrays(b)
        v = self.cfg.vocab  # slice off vocab padding before sampling
        pos = torch.full((b,), s0 - 1, dtype=torch.int64, device=self.device)
        out = [toks]
        cur = sample_or_greedy(logits[:, -1, :v], samp, pos)[:, None]
        for i in range(n_tokens):
            out.append(cur)
            self.decode_calls += 1
            logits, cache = lm.decode_step(self.params, cache, cur, s0 + i, self.cfg)
            cur = sample_or_greedy(logits[:, -1, :v], samp, pos + (i + 1))[:, None]
        return torch.cat(out, dim=1).cpu().numpy()

    # -------------------------------------------------------- requests

    def _validate_request(self, i: int, prompt, n_tok: int, *,
                          check_size: bool = True) -> np.ndarray:
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
        if check_size and total > self.scfg.max_seq:
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
        """None (config defaults), one :class:`SamplingParams` for every
        request, or a per-request sequence (None entries: defaults)."""
        default = self.scfg.sampling_params
        if sampling is None:
            return [default] * n
        if isinstance(sampling, SamplingParams):
            return [sampling] * n
        out = [default if s is None else s for s in sampling]
        if len(out) != n:
            raise ValueError(f"sampling has {len(out)} entries for {n} prompts")
        for i, s in enumerate(out):
            if not isinstance(s, SamplingParams):
                raise ValueError(
                    f"request {i}: sampling must be SamplingParams or None, "
                    f"got {type(s).__name__}"
                )
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

    @staticmethod
    def _stream_list(on_token, n: int) -> List[Optional[Callable]]:
        """None (no streaming), one callable for every request, or a
        per-request sequence (None entries: no streaming)."""
        if on_token is None:
            return [None] * n
        if callable(on_token):
            return [on_token] * n
        try:
            out = list(on_token)
        except TypeError:
            raise ValueError(
                "on_token must be None, a callable, or a per-request sequence of "
                f"callables, got {type(on_token).__name__}"
            ) from None
        if len(out) != n:
            raise ValueError(f"on_token has {len(out)} entries for {n} prompts")
        for i, cb in enumerate(out):
            if cb is not None and not callable(cb):
                raise ValueError(
                    f"request {i}: on_token must be callable or None, got {type(cb).__name__}"
                )
        return out

    def generate_requests(self, prompts: Sequence[np.ndarray], n_tokens,
                          arrivals: Optional[Sequence[int]] = None, sampling=None,
                          stop_tokens=None, on_token=None) -> List[np.ndarray]:
        """Continuous-batched generation: ``prompts`` of mixed lengths,
        ``n_tokens`` one int or one per request, ``arrivals`` the scheduler
        iteration at which each request appears (default 0).  Returns
        ``prompt ‖ generated`` per request, in input order; the typed
        outcomes (finish reason, latency) land in :attr:`last_results`.
        The whole list is validated before any request is queued.  The
        paged cache, allocator and prefix cache persist across calls.

        ``sampling`` is None (config defaults), one ``SamplingParams`` or
        one per request; ``stop_tokens`` one flat id sequence or one per
        request (a sampled stop token ends the request and is kept).
        ``on_token`` streams committed output: None, one callable, or one
        per request, called as ``on_token(rid, tokens, start)`` with each
        newly committed run of ``tokens`` at offset ``start`` of the
        request's output; the concatenated stream equals the final
        output, across preemption and replay too."""
        n = len(prompts)
        n_list = self._per_request("n_tokens", n_tokens, n, None)
        arr_list = self._per_request("arrivals", arrivals, n, 0)
        samp_list = self._sampling_list(sampling, n)
        stop_list = self._stop_list(stop_tokens, n)
        cb_list = self._stream_list(on_token, n)
        clean = [self._validate_request(i, p, n_list[i]) for i, p in enumerate(prompts)]
        reqs = [
            Request(rid=self._next_rid(), prompt=p, max_new_tokens=n_list[i],
                    arrival=arr_list[i], sampling=samp_list[i], stop_tokens=stop_list[i],
                    on_token=cb_list[i])
            for i, p in enumerate(clean)
        ]
        self._serve(reqs)
        self.last_results = [_result(r) for r in reqs]
        return [r.tokens() for r in reqs]

    def serve_requests(self, prompts: Sequence[np.ndarray], n_tokens,
                       arrivals: Optional[Sequence[int]] = None,
                       deadlines: Optional[Sequence[Optional[int]]] = None,
                       cancel_at: Optional[Sequence[Optional[int]]] = None,
                       sampling=None, stop_tokens=None,
                       on_token=None) -> List[RequestResult]:
        """Robust continuous serving: every request gets a typed
        :class:`RequestResult`, never an engine exception.  Oversized
        requests (prompt + n_tokens beyond ``max_seq`` or the per-request
        page table) come back ``rejected_too_large`` without reaching the
        scheduler; ``deadlines``/``cancel_at`` are absolute scheduler
        iterations at which an unfinished request finishes
        ``deadline_exceeded``/``cancelled`` with what it generated; queue
        overflow under ``max_queue`` follows ``backpressure``.  The other
        arguments are :meth:`generate_requests`'."""
        scfg = self.scfg
        n = len(prompts)
        n_list = self._per_request("n_tokens", n_tokens, n, None)
        arr_list = self._per_request("arrivals", arrivals, n, 0)
        dl_list = self._per_request("deadlines", deadlines, n, None)
        cx_list = self._per_request("cancel_at", cancel_at, n, None)
        samp_list = self._sampling_list(sampling, n)
        stop_list = self._stop_list(stop_tokens, n)
        cb_list = self._stream_list(on_token, n)
        slots: List[Optional[Request]] = []
        results: List[Optional[RequestResult]] = []
        for i, prompt in enumerate(prompts):
            prompt = self._validate_request(i, prompt, n_list[i], check_size=False)
            total = prompt.shape[0] + n_list[i] - 1
            too_large = total > scfg.max_seq or paged_cache.pages_for(
                prompt.shape[0] + max(0, n_list[i] - 1), scfg.page_size
            ) > scfg.pages_per_request
            if too_large:
                slots.append(None)
                results.append(RequestResult(
                    rid=self._next_rid(), tokens=prompt, n_generated=0,
                    finish_reason=FINISH_REJECTED_TOO_LARGE,
                ))
                continue
            slots.append(Request(
                rid=self._next_rid(), prompt=prompt, max_new_tokens=n_list[i],
                arrival=arr_list[i], deadline=dl_list[i], cancel_at=cx_list[i],
                sampling=samp_list[i], stop_tokens=stop_list[i], on_token=cb_list[i],
            ))
            results.append(None)
        self._serve([r for r in slots if r is not None])
        for i, req in enumerate(slots):
            if req is not None:
                results[i] = _result(req)
        self.last_results = list(results)
        return results

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
            # the plan's knobs on the device, or None when no row samples
            # (decided on the host, from the plan's numpy arrays)
            samp = device_sampling(plan.samp_temp, plan.samp_top_k, plan.samp_top_p,
                                   plan.samp_seed, self.device)
            if isinstance(plan, DecodeRun):
                self.decode_run_calls += 1
                sampled, bad_at, cache = lm.paged_decode_loop(
                    self.params, cache, self._tensor(plan.tokens),
                    self._tensor(plan.positions), tables, plan.n_steps, self.cfg,
                    max_steps=self.scfg.decode_block, scrub_pages=scrub, cow_pages=cow,
                    sampling=samp,
                )
                sched.commit_run(plan, sampled.cpu().numpy(), bad_at=bad_at.cpu().numpy())
            else:
                positions = self._tensor(plan.positions)
                logits, cache = lm.paged_step(
                    self.params, cache, self._tensor(plan.tokens), positions, tables,
                    self.cfg, scrub_pages=scrub, cow_pages=cow,
                )
                # each row samples at its own last valid chunk index, keyed
                # on that index's fed-stream position
                rows_idx = torch.arange(logits.shape[0], device=self.device)
                idx = self._tensor(plan.sample_idx).long()
                rows = logits[rows_idx, idx, :v]
                tok = sample_or_greedy(rows, samp, positions[rows_idx, idx])
                ok = torch.isfinite(rows).all(dim=-1)
                sched.commit(plan, tok.cpu().numpy(), ok=ok.cpu().numpy())
        cont["cache"] = cache
