"""Serving engine (port of ``repro.serve.engine``): prefill and seeded
sampled decode (greedy at ``temperature=0``) for the decoder-only
families: the attention ones (dense, MoE, VLM) and the recurrent ones
(the mamba2 ``ssm``, the hymba ``hybrid``).

``prefill_mode`` picks how prompts reach the cache, as in the reference:

* ``"batched"`` (what ``"auto"`` resolves to for the attention
  families): :meth:`Engine.generate` prefills the whole prompt in one
  ``lm.prefill`` call over the ring cache, then decodes in lock step
  (``lm.decode_step``);
* ``"stepped"`` (what ``"auto"`` resolves to for ``ssm`` and
  ``hybrid``, whose recurrent state has no exact one-shot fill): the
  prompt goes in one ``lm.decode_step`` a token; ``"batched"`` and
  ``"continuous"`` raise for those families;
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

Also the reference's serving surface around the loop:

* self-speculative decoding (``ServeConfig(spec=SpecConfig(...))``): a
  draft on a cheaper rung of the DBB ladder proposes up to
  ``decode_block - 1`` greedy tokens over the target's paged cache
  (``lm.paged_decode_loop`` under the tightened config), one
  ``lm.paged_verify`` pass of the target checks the window, and the host
  keeps the longest agreeing prefix plus one token (:func:`spec_accept`):
  byte-identical to serving without it;
* seeded fault injection (:meth:`Engine.set_faults`, ``serve/faults.py``),
  the NaN watchdog's per-row quarantine, and :meth:`Engine.health` with
  the step-time percentiles and the hang watchdog (``runtime/monitor.py``);
* crash-consistent snapshots (``snapshot_every``, :meth:`Engine.snapshot`,
  :meth:`Engine.restore`, :meth:`Engine.resume`) through
  ``checkpoint/manager.py``.

A kernel failure raises.  The one fallback is the reference's: an
injected ``FusedKernelFault`` (which only the fault injector raises)
switches the engine to ``paged_attn="gather"`` for good and retries the
dispatch; any other error, a CUDA error or a shape #6 refuses included,
propagates.  The encdec family (whisper) is not a decoder-only LM: it
runs through ``models/encdec.py`` and the engine refuses it
(``NotImplementedError``, ``models/lm.py``).  ``kv_dtype="int8"`` on a
pure ``ssm`` model raises: it has no attention KV to quantize.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import manager as checkpoint
from repro_torch.core.sampling import (
    TOP_K_DISABLED,
    SamplingParams,
    device_sampling,
    sample_or_greedy,
    validate_sampling,
)
from repro_torch.models import common, lm
from repro_torch.runtime import monitor
from repro_torch.serve import faults, paged_cache
from repro_torch.serve.scheduler import (
    FINISH_LENGTH,
    FINISH_REJECTED_TOO_LARGE,
    FINISH_STOP,
    DecodeRun,
    Request,
    Scheduler,
)

logger = logging.getLogger(__name__)

# families whose ring cache lm.prefill fills exactly (attention only);
# the continuous path shares the set
BATCHED_PREFILL_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Greedy self-speculative decoding on the DBB density ladder.

    The draft model is the target's own weights on a cheaper rung:
    ``draft="nnz"`` tightens the activation bound to ``draft_nnz``
    (``SparsityConfig.tighten``; 2/8 proposals for a 4/8 target) and
    shares the target's parameters; ``draft="int8_wire"`` drafts on the
    int8 wire, a second, int8 copy of the weights packed at engine build
    when the target serves the native wire (on an int8 target the draft
    is the target).  The draft shares the target's cache layout, page
    tables and window (``ServeConfig.decode_block``).  Acceptance compares
    the target's own position-keyed tokens with the proposals, so the
    output is byte-identical to the target alone: a verified speedup, not
    a statistical one."""

    draft: str = "nnz"  # nnz | int8_wire (which ladder rung drafts)
    draft_nnz: int = 2  # activation bound of the "nnz" draft rung

    def __post_init__(self):
        if self.draft not in ("nnz", "int8_wire"):
            raise ValueError(f"unknown draft kind {self.draft!r}; nnz|int8_wire")
        if self.draft_nnz < 1:
            raise ValueError(f"draft_nnz must be >= 1, got {self.draft_nnz}")


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs, with the reference's names, defaults and meanings.

    ``prefill_mode``: ``"auto"`` (``"batched"`` for the attention
    families, ``"stepped"`` for ``ssm`` and ``hybrid``), ``"batched"``, ``"stepped"`` or ``"continuous"`` (see the
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
    here too.  ``paged_attn``: ``"fused"`` runs the fused kernel (#6),
    ``"gather"`` materializes each request's window and attends in plain
    PyTorch, and ``"auto"`` resolves per shape as the reference's does:
    the autotune cache, then fused on a CUDA device and gather elsewhere
    (``models/attention._paged_attn_impl``).  ``spec`` (a :class:`SpecConfig`,
    continuous mode only) turns decode-only runs into draft-then-verify
    rounds.  ``snapshot_every > 0`` publishes a snapshot to
    ``snapshot_dir`` every that many scheduler iterations (keeping
    ``snapshot_keep``); a step slower than ``hang_threshold`` x the
    rolling median trips the hang watchdog (``health()["slow_steps"]``).
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
    spec: Optional[SpecConfig] = None
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
        if self.spec is not None and self.prefill_mode != "continuous":
            raise ValueError(
                "speculative decoding requires prefill_mode='continuous', "
                f"got {self.prefill_mode!r}"
            )
        if self.max_pages is not None and self.max_pages < self.pages_per_request + 1:
            raise ValueError(
                f"max_pages={self.max_pages} cannot hold one max_seq={self.max_seq} "
                f"request: need >= {self.pages_per_request} data pages + 1 null page"
            )

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


def spec_accept(draft_row, target_row, k: int) -> int:
    """How many of the target's ``k`` verified tokens one row keeps (>= 1).

    The verify window fed ``[t_0, d_1, .., d_{k-1}]``; ``target_row[j]`` is
    the target's token at index ``j``, what solo decode emits after the
    first ``j`` proposals.  The kept prefix is the longest run where each
    proposal matched the target token before it, plus one: the target's
    token at the first divergent index is itself correct output.  ``k=1``
    keeps the one target token, plain decode."""
    a = 1
    while a < k and int(draft_row[a - 1]) == int(target_row[a - 1]):
        a += 1
    return a


def _native_packed(tree) -> bool:
    """Whether some linear of ``tree`` is packed on the native wire."""
    if isinstance(tree, list):
        return any(_native_packed(v) for v in tree)
    if isinstance(tree, dict):
        if "w_vals" in tree:
            return "w_scale" not in tree
        return any(_native_packed(v) for v in tree.values())
    return False


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
    :meth:`serve_requests` (speculative with ``ServeConfig.spec``), fault
    injection, health, and snapshot/restore/resume."""

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
        if scfg.kv_dtype != "native" and cfg.family == "ssm":
            # never let the caller believe a quantized cache is active when
            # the family has no attention KV at all (a hybrid's attention
            # ring quantizes; its recurrent state stays native)
            raise ValueError(
                f"kv_dtype={scfg.kv_dtype!r} has no effect on pure-SSM family "
                f"{cfg.family!r}: there is no attention KV cache to quantize "
                "(use kv_dtype='native')"
            )
        self.scfg = scfg
        raw = _to_device(params, self.device)
        self.params = pack_params_for_serving(raw, cfg, scfg.wire_dtype) if packing else raw
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
        # self-speculative decoding: the draft's params are fixed here, its
        # config derives from self.cfg (_derive_draft_cfg), so the gather
        # fallback moves the draft to the gather path too
        self._spec = scfg.spec
        self.draft_cfg = None
        self._draft_params = None
        if self._spec is not None:
            if self._spec.draft == "nnz":
                cfg.sparsity.tighten(self._spec.draft_nnz)  # validates draft_nnz
                self._draft_params = self.params
            elif scfg.wire_dtype == "int8":
                self._draft_params = self.params  # the target is the int8 rung
            else:
                if cfg.sparsity.mode not in ("wdbb", "awdbb"):
                    raise ValueError(
                        "SpecConfig(draft='int8_wire') needs a wdbb/awdbb sparsity mode "
                        f"to pack, got {cfg.sparsity.mode!r}"
                    )
                # the int8 copy is packed from the dense weights; the dense
                # device copy is dropped with `raw` (unless the target
                # serves it unpacked)
                self._draft_params = pack_params_for_serving(raw, cfg, "int8")
                if _native_packed(self._draft_params):
                    raise ValueError(
                        "SpecConfig(draft='int8_wire') packs its int8 copy from dense "
                        "weights: pass the unpacked params"
                    )
            self._derive_draft_cfg()
        del raw
        self.spec_runs = 0
        self.spec_proposed = 0  # draft tokens offered for verification
        self.spec_accepted = 0  # proposals the target agreed with
        self.spec_emitted = 0  # tokens committed by spec rounds (pre-stop)
        self.prefill_calls = 0  # one-shot prefills + stepped prompt tokens
        self.decode_calls = 0  # one-shot/stepped decode steps
        self.step_calls = 0  # continuous mixed steps + decode runs dispatched
        self.decode_run_calls = 0  # decode runs among them
        self.last_results: List[RequestResult] = []
        self._cont = None  # allocator, prefix cache, device cache
        self._rid = 0
        # distinct dispatch signatures of the continuous loop (the
        # reference's traced-compile count: paged_compiles)
        self._step_shapes = set()
        # robustness
        self._injector: Optional[faults.FaultInjector] = None
        self.fallbacks = 0  # fused -> gather switches
        self._health: Dict[str, float] = {}  # scheduler stats, accumulated
        # monitoring and durability
        self._step_timer = monitor.StepTimer(window=32)
        self._watchdog = monitor.HangWatchdog(threshold=scfg.hang_threshold)
        self._step_samples: collections.deque = collections.deque(maxlen=2048)
        self.slow_steps = 0  # watchdog trips
        self._slow_logged = False  # the first trip logs, the rest count
        self._snap_step = 0  # the next snapshot's step number
        self._last_snap_iter: Optional[int] = None
        # in-flight scheduler state staged by load_snapshot for resume();
        # while it is pending, _serve refuses new work
        self._resume_state: Optional[dict] = None

    def _derive_draft_cfg(self) -> None:
        """The draft's config from the target's: tightened to
        ``draft_nnz`` (``"nnz"``) or with per-row activation scales, as
        every int8 path has (``"int8_wire"``)."""
        sp = self.cfg.sparsity
        if self._spec.draft == "nnz":
            sp = sp.tighten(self._spec.draft_nnz)
        else:
            sp = dataclasses.replace(sp, act_scale="per_row")
        self.draft_cfg = dataclasses.replace(self.cfg, sparsity=sp)

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

    # ------------------------------------------------ robustness, health

    @property
    def paged_compiles(self) -> int:
        """Distinct dispatch signatures of the continuous loop: the
        reference's count of compiled traces.  2 for a plain engine (the
        fixed-shape mixed step and the decode run), 3 for a spec engine
        (mixed step, draft loop, verify pass; it dispatches no plain run)."""
        return len(self._step_shapes)

    def set_faults(self, fcfg: Optional[faults.FaultConfig]) -> None:
        """Arm (or with ``None`` disarm) seeded fault injection for later
        continuous serving (``serve/faults.py``): the allocator hook goes
        on the persistent page pool; the kernel-side hook is active only
        around this engine's own dispatches."""
        self._injector = None if fcfg is None else faults.FaultInjector(fcfg)
        if self._cont is not None:
            self._cont["allocator"].fault_hook = (
                None if self._injector is None else self._injector.alloc_hook
            )

    def health(self) -> Dict[str, float]:
        """Robustness counters accumulated over continuous serving:
        preemptions, quarantines, finish counts by reason, the queue's
        high-water mark, fused -> gather fallbacks, hang-watchdog trips, the
        serve steps' wall-time p50 and p99 (µs, each step including the
        host sync that reads its tokens), and the injected faults that
        fired when injection is armed."""
        out = dict(self._health)
        out["fused_fallbacks"] = self.fallbacks
        out["slow_steps"] = self.slow_steps
        if self._step_samples:
            xs = list(self._step_samples)
            out["step_p50_us"] = round(monitor.percentile(xs, 50) * 1e6, 1)
            out["step_p99_us"] = round(monitor.percentile(xs, 99) * 1e6, 1)
        inj = self._injector
        if inj is not None:
            out["injected_alloc_faults"] = inj.alloc_faults
            out["injected_fused_faults"] = inj.fused_faults
            out["injected_nan_poisons"] = inj.nan_poisons
            out["injected_draft_nan_poisons"] = inj.draft_nan_poisons
            out["injected_scribbles"] = inj.scribbles
            out["injected_kills"] = inj.kills
        return out

    def spec_stats(self) -> Dict[str, float]:
        """Speculative-decoding counters (zeros unless ``spec`` is set):
        rounds, proposals, accepted proposals, committed tokens (the
        always-kept bonus token included, before stop truncation) and the
        acceptance rate."""
        proposed = self.spec_proposed
        return {
            "spec_runs": self.spec_runs,
            "proposed": proposed,
            "accepted": self.spec_accepted,
            "emitted": self.spec_emitted,
            "acceptance_rate": self.spec_accepted / proposed if proposed else 0.0,
        }

    def _note_step_time(self, dt: float) -> None:
        """One serve step's wall time: into the health percentiles and the
        hang watchdog (only its first trip logs)."""
        self._step_samples.append(dt)
        if self._watchdog.note(dt):
            self.slow_steps += 1
            if not self._slow_logged:
                self._slow_logged = True
                logger.warning(
                    "slow serving step: %.1f ms (> %gx rolling median); further trips "
                    "counted in health()['slow_steps'] without logging",
                    dt * 1e3, self.scfg.hang_threshold,
                )

    def _merge_health(self, stats: Dict[str, int]) -> None:
        for key, val in stats.items():
            if key == "queue_high_water":
                self._health[key] = max(self._health.get(key, 0), val)
            else:
                self._health[key] = self._health.get(key, 0) + val

    def _fallback_to_gather(self, err: Exception) -> None:
        """The one-way fallback after an injected ``FusedKernelFault``:
        every later dispatch of this engine reads pages through the gather
        path.  A fault on the gather path itself re-raises."""
        if self.cfg.sparsity.paged_attn == "gather":
            raise err
        logger.warning("fused paged_attn kernel failed (%s); falling back to the gather "
                       "path one-way", err)
        self.fallbacks += 1
        sp = dataclasses.replace(self.cfg.sparsity, paged_attn="gather")
        self.cfg = dataclasses.replace(self.cfg, sparsity=sp)
        if self._spec is not None:
            self._derive_draft_cfg()

    def _guarded(self, inj, dispatch: Callable):
        """Run one dispatch with ``inj`` scoped; on an injected
        ``FusedKernelFault`` (and on nothing else) fall back to gather and
        run it again.

        The reference's fault fires at trace time, before any state
        changes.  Here the fault fires in the first layer's attention of
        the dispatch, after three in-place writes: the page maintenance
        (scrub, copy-on-write), the slot-position write and that layer's
        K/V write.  The retry leaves the cache as a fault-free run does:
        the scrub is idempotent; the copy-on-write copies its source page
        again (a shared page, never written) before the step rewrites its
        slots; the position and K/V writes repeat the same values (the
        int8 KV quantization is deterministic).  The injector fires once
        an engine, so the fault lands in the first layer of a dispatch,
        never inside a decode loop's later iterations."""
        try:
            with faults.scoped(inj):
                return dispatch()
        except faults.FusedKernelFault as err:
            self._fallback_to_gather(err)
            with faults.scoped(inj):
                return dispatch()

    def _scribble(self, cache, page: int) -> None:
        """Fault injection: finite garbage with valid-looking slot
        positions into free ``page`` (scrub-on-hand-out hides it)."""
        ps = self.scfg.page_size
        cache["pos"][page] = torch.arange(ps, dtype=torch.int32, device=self.device)
        for key in ("k", "v"):
            cache[key][:, page] = 7
        for key in ("k_scale", "v_scale"):
            if key in cache:
                cache[key][:, page] = 1e3

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
            if self._injector is not None:
                allocator.fault_hook = self._injector.alloc_hook
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
        if self._resume_state is not None:
            raise RuntimeError(
                "engine holds restored in-flight requests: call resume() to finish "
                "them before serving new work"
            )
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
        host sync per mixed step or decode run (reading its tokens), two
        per speculative round (the draft's tokens, the verify's).

        At each iteration boundary, the one point where device cache,
        allocator, scheduler and requests agree, the loop publishes a
        snapshot when ``snapshot_every`` is due, then visits the
        ``iteration`` kill point; the ``pre_commit`` kill point sits
        between each dispatch and its commit.  Each step is timed, its
        host sync included, for ``health()`` and the hang watchdog."""
        scfg = self.scfg
        cont = self._ensure_cont()
        inj = self._injector
        v = self.cfg.vocab
        # every serve or resume loop snapshots its first boundary, then
        # every snapshot_every iterations of this scheduler
        self._last_snap_iter = None
        try:
            while sched.has_work():
                if scfg.snapshot_every and (
                    self._last_snap_iter is None
                    or sched.iteration - self._last_snap_iter >= scfg.snapshot_every
                ):
                    self._snapshot_now(sched)
                    self._last_snap_iter = sched.iteration
                if inj is not None:
                    inj.maybe_kill("iteration")
                    page = inj.scribble_page(cont["allocator"].free_pages())
                    if page is not None:
                        self._scribble(cont["cache"], page)
                plan = sched.plan()
                if plan is None:  # only future arrivals left: advance time
                    sched.tick()
                    continue
                self.step_calls += 1
                self._step_timer.start()
                scrub, cow = self._pages(plan.scrub_pages, plan.cow_pages)
                tables = self._tensor(plan.page_tables)
                if isinstance(plan, DecodeRun):
                    self.decode_run_calls += 1
                    if self._spec is not None:
                        kept, sampled, bad = self._dispatch_spec(plan, inj, scrub, cow, tables)
                        if inj is not None:
                            inj.maybe_kill("pre_commit")
                        sched.commit_spec(plan, kept, sampled, bad_rows=bad)
                    else:
                        self._step_shapes.add(("run",))
                        # the plan's knobs on the device, or None when no
                        # row samples (decided on the host)
                        samp = device_sampling(plan.samp_temp, plan.samp_top_k,
                                               plan.samp_top_p, plan.samp_seed, self.device)
                        toks, pos = self._tensor(plan.tokens), self._tensor(plan.positions)
                        sampled, bad_at, _ = self._guarded(inj, lambda: lm.paged_decode_loop(
                            self.params, cont["cache"], toks, pos, tables, plan.n_steps,
                            self.cfg, max_steps=scfg.decode_block, scrub_pages=scrub,
                            cow_pages=cow, sampling=samp,
                        ))
                        sampled, bad_at = sampled.cpu().numpy(), bad_at.cpu().numpy()
                        if inj is not None:
                            inj.maybe_kill("pre_commit")
                        sched.commit_run(plan, sampled, bad_at=bad_at)
                else:
                    self._step_shapes.add(("step",) + plan.tokens.shape)
                    samp = device_sampling(plan.samp_temp, plan.samp_top_k, plan.samp_top_p,
                                           plan.samp_seed, self.device)
                    toks, positions = self._tensor(plan.tokens), self._tensor(plan.positions)
                    logits, _ = self._guarded(inj, lambda: lm.paged_step(
                        self.params, cont["cache"], toks, positions, tables, self.cfg,
                        scrub_pages=scrub, cow_pages=cow,
                    ))
                    if inj is not None:
                        mask = inj.poison_mask(plan.rows, plan.sample_mask)
                        if mask is not None:
                            poison = self._tensor(mask)[:, None, None]
                            logits = torch.where(poison, float("nan"), logits)
                    # each row samples at its own last valid chunk index,
                    # keyed on that index's fed-stream position
                    rows_idx = torch.arange(logits.shape[0], device=self.device)
                    idx = self._tensor(plan.sample_idx).long()
                    rows = logits[rows_idx, idx, :v]
                    tok = sample_or_greedy(rows, samp, positions[rows_idx, idx])
                    ok = torch.isfinite(rows).all(dim=-1)
                    tok, ok = tok.cpu().numpy(), ok.cpu().numpy()
                    if inj is not None:
                        inj.maybe_kill("pre_commit")
                    sched.commit(plan, tok, ok=ok)
                self._note_step_time(self._step_timer.stop())
        finally:
            # a SimulatedCrash abandons the loop; the engine is then dead by
            # contract, so recording the partial stats is harmless
            self._merge_health(sched.stats())

    def _dispatch_spec(self, plan: DecodeRun, inj, scrub, cow, tables):
        """One draft-then-verify round for a decode plan.

        The draft loop proposes ``k - 1`` greedy tokens on the cheap rung,
        writing its KV into the target's paged cache; it is dispatched even
        at ``k = 1`` so the run's scrub and copy-on-write happen once.  The
        host builds the verify feed from the draft's tokens (the first
        sync); one ``lm.paged_verify`` pass under the target config
        rewrites every window position and samples the target's own token
        at each index (the second sync).  Returns per-row kept counts, the
        ``[B, decode_block]`` target tokens and per-row quarantine
        verdicts; the scheduler commits the kept prefixes and rolls the
        rejected suffixes' pages back (``commit_spec``)."""
        scfg = self.scfg
        cache = self._cont["cache"]
        k = plan.n_steps
        b = plan.tokens.shape[0]
        n_draft = k - 1
        self.spec_runs += 1
        self._step_shapes.update((("draft",), ("verify",)))
        toks, pos = self._tensor(plan.tokens), self._tensor(plan.positions)
        draft_toks, draft_bad, _ = self._guarded(inj, lambda: lm.paged_decode_loop(
            self._draft_params, cache, toks, pos, tables, n_draft, self.draft_cfg,
            max_steps=scfg.decode_block, scrub_pages=scrub, cow_pages=cow,
        ))
        draft_toks, draft_bad = draft_toks.cpu().numpy(), draft_bad.cpu().numpy()
        if inj is not None and n_draft:
            mask = inj.draft_poison_mask(plan.rows)
            if mask is not None:
                # the draft loop's logits never leave its dispatch: force
                # its watchdog verdict bad at step 0
                draft_bad = np.where(mask, 0, draft_bad)
        # the verify feed: the committed last token at index 0, the
        # proposals at 1..k-1, positions p0..p0+k-1, padded to the
        # decode_block width with position -1 (the null page, inert)
        ver_toks = np.zeros((b, scfg.decode_block), np.int32)
        ver_pos = np.full((b, scfg.decode_block), -1, np.int32)
        for slot, req in enumerate(plan.rows):
            if req is None:
                continue
            ver_toks[slot, 0] = plan.tokens[slot, 0]
            ver_toks[slot, 1:k] = draft_toks[slot, :n_draft]
            p0 = int(plan.positions[slot])
            ver_pos[slot, :k] = np.arange(p0, p0 + k, dtype=np.int32)
        samp = device_sampling(plan.samp_temp, plan.samp_top_k, plan.samp_top_p,
                               plan.samp_seed, self.device)
        vt, vp = self._tensor(ver_toks), self._tensor(ver_pos)
        sampled, ok, _ = self._guarded(inj, lambda: lm.paged_verify(
            self.params, cache, vt, vp, tables, self.cfg, sampling=samp,
        ))
        sampled, ok = sampled.cpu().numpy(), ok.cpu().numpy()
        # acceptance and the watchdogs, on the host
        kept = np.zeros((b,), np.int32)
        bad = np.zeros((b,), bool)
        for slot, req in enumerate(plan.rows):
            if req is None:
                continue
            if n_draft and int(draft_bad[slot]) < n_draft:
                bad[slot] = True  # non-finite draft logits: trust nothing
                continue
            a = spec_accept(draft_toks[slot], sampled[slot], k)
            bad_idx = k
            for j in range(k):
                if not ok[slot, j]:
                    bad_idx = j
                    break
            if bad_idx < a:
                # non-finite target logits inside the kept prefix: keep the
                # clean tokens before them and quarantine the row
                bad[slot] = True
                kept[slot] = bad_idx
            else:
                kept[slot] = a
            self.spec_proposed += n_draft
            self.spec_accepted += a - 1
        self.spec_emitted += int(kept.sum())
        return kept, sampled, bad

    # ------------------------------------------------------- durability

    #: serve-config fields a snapshot does not pin: where and how often to
    #: snapshot and the watchdog threshold change no output byte
    _SNAP_FREE_KNOBS = ("snapshot_dir", "snapshot_every", "snapshot_keep", "hang_threshold")

    @staticmethod
    def _scfg_from_state(d: dict) -> ServeConfig:
        """The :class:`ServeConfig` of its JSON round-tripped ``asdict``
        form, the nested :class:`SpecConfig` included."""
        d = dict(d)
        spec = d.pop("spec", None)
        return ServeConfig(spec=None if spec is None else SpecConfig(**spec), **d)

    def _snapshot_now(self, sched: Optional[Scheduler], ckpt_dir=None) -> str:
        """Publish one crash-consistent snapshot (``checkpoint/manager.py``'s
        atomic rename): the live scheduler at an iteration boundary, or
        None between serve calls.  Returns the published directory."""
        scfg = self.scfg
        path = ckpt_dir or scfg.snapshot_dir
        if path is None:
            raise ValueError("no snapshot destination: set ServeConfig.snapshot_dir or "
                             "pass ckpt_dir")
        cont = self._ensure_cont()
        extra = {
            "snapshot_version": 1,
            "kind": "engine_snapshot",
            "serve_config": dataclasses.asdict(scfg),
            "engine": {"rid": self._rid, "fallbacks": self.fallbacks,
                       "health": dict(self._health)},
            "allocator": cont["allocator"].export_state(),
            "prefix": None if cont["prefix"] is None else cont["prefix"].export_state(),
            "scheduler": None if sched is None else sched.export_state(),
        }
        inj = self._injector
        step = self._snap_step
        self._snap_step += 1
        return checkpoint.save(
            path, step, lm.export_decode_state(cont["cache"]), extra=extra,
            keep=scfg.snapshot_keep,
            pre_publish_hook=None if inj is None else (lambda: inj.maybe_kill("mid_save")),
        )

    def snapshot(self, ckpt_dir: Optional[str] = None) -> str:
        """Publish a snapshot of the persistent continuous state (allocator,
        prefix cache, paged KV) between serve calls; in-flight snapshots
        are the serve loop's, with ``snapshot_every``.  Continuous mode
        only."""
        if self._resolve_prefill_mode() != "continuous":
            raise ValueError("snapshots capture paged serving state: requires "
                             "prefill_mode='continuous'")
        return self._snapshot_now(None, ckpt_dir)

    def load_snapshot(self, ckpt_dir: Optional[str] = None, step: Optional[int] = None) -> int:
        """Warm restore: load a published snapshot into this engine,
        replacing its continuous state (the weights stay: snapshots never
        hold them).  The snapshot's serve config must equal this engine's
        but for :data:`_SNAP_FREE_KNOBS`.  In-flight requests it held are
        finished by :meth:`resume`.  Returns the loaded step."""
        scfg = self.scfg
        path = ckpt_dir or scfg.snapshot_dir
        if path is None:
            raise ValueError("no snapshot source: set ServeConfig.snapshot_dir or pass ckpt_dir")
        manifest = checkpoint.load_manifest(path, step)
        extra = manifest["extra"]
        if extra.get("kind") != "engine_snapshot":
            raise checkpoint.CheckpointError(
                f"step {manifest['step']} in {path} is not an engine snapshot "
                f"(kind={extra.get('kind')!r})"
            )
        if extra.get("snapshot_version") != 1:
            raise checkpoint.CheckpointError(
                f"unsupported engine snapshot version {extra.get('snapshot_version')!r}"
            )
        saved = dict(extra["serve_config"])
        mine = dataclasses.asdict(scfg)
        for key in self._SNAP_FREE_KNOBS:
            saved.pop(key, None)
            mine.pop(key, None)
        if saved != mine:
            diff = sorted(k for k in set(saved) | set(mine) if saved.get(k) != mine.get(k))
            raise checkpoint.CheckpointError(
                f"snapshot serve config does not match this engine (differing keys: {diff}) "
                "— restore with the saved config (Engine.restore does this by default)"
            )
        like = lm.paged_cache_template(self.cfg, scfg.total_pages, scfg.page_size)
        host_cache, manifest = checkpoint.restore(path, like, step=manifest["step"])
        allocator = paged_cache.PageAllocator.from_state(extra["allocator"])
        if self._injector is not None:
            allocator.fault_hook = self._injector.alloc_hook
        prefix = (None if extra["prefix"] is None
                  else paged_cache.PrefixCache.from_state(allocator, extra["prefix"]))
        self._cont = {"allocator": allocator, "prefix": prefix,
                      "cache": lm.restore_decode_state(host_cache, self.device)}
        eng = extra["engine"]
        self._rid = int(eng["rid"])
        self.fallbacks = int(eng["fallbacks"])
        self._health = dict(eng["health"])
        self._resume_state = extra["scheduler"]  # None for a between-calls snapshot
        self._snap_step = int(manifest["step"]) + 1
        self._last_snap_iter = None
        return int(manifest["step"])

    @classmethod
    def restore(cls, ckpt_dir: str, params, cfg, scfg: Optional[ServeConfig] = None,
                step: Optional[int] = None, device=None) -> "Engine":
        """Cold restore: a fresh engine from the latest (or ``step``-th)
        published snapshot, its weights packed anew from the raw
        ``params``/``cfg`` the caller holds, its allocator, prefix cache
        and KV loaded, its in-flight requests staged for :meth:`resume`.
        ``scfg`` defaults to the snapshot's own; an override may change
        only the free knobs."""
        manifest = checkpoint.load_manifest(ckpt_dir, step)
        if scfg is None:
            scfg = cls._scfg_from_state(manifest["extra"]["serve_config"])
        engine = cls(params, cfg, scfg, device=device)
        engine.load_snapshot(ckpt_dir, step=manifest["step"])
        return engine

    def resume(self, on_token=None, delivered=None) -> List[RequestResult]:
        """Finish every in-flight request staged by :meth:`load_snapshot`/
        :meth:`restore`, byte-identical to the uninterrupted serve (replay
        re-derives every later token: keys depend on seed and fed-stream
        position only).  Returns results ordered by rid.

        ``on_token`` re-attaches streaming (one callable, or a ``{rid:
        callable}`` dict); ``delivered`` (``{rid: n}``) is how many output
        tokens the consumer received before the crash, so the stream
        resumes at the first undelivered token.  Without it, delivery
        resumes from the snapshot's count (at least once)."""
        if self._resume_state is None:
            raise RuntimeError("nothing to resume: the loaded snapshot held no in-flight "
                               "requests (or resume() already ran)")
        state = self._resume_state
        self._resume_state = None
        sched = self._make_scheduler()
        reqs = sched.load_state(state)
        for req in reqs:
            if callable(on_token):
                req.on_token = on_token
            elif on_token is not None:
                req.on_token = on_token.get(req.rid)
            if delivered is not None and req.rid in delivered:
                req.streamed = int(delivered[req.rid])
        self._run_loop(sched)
        results = [_result(r) for r in reqs]
        self.last_results = results
        return results
