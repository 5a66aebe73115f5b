"""One run of one cell: set-up, the measured window, the kernel-path
guard, the comparison with the reference, and the numbers the run
reports.

The window is a series of rounds, each one ``Engine.serve_requests``
call over ``round_size`` requests due at once; every round that starts
before ``seconds`` have passed is served whole and counted.  Spans are
taken in the benchmark's own wrappers around the scheduler's ``plan`` and
``commit``, ``lm.paged_step`` and ``lm.paged_decode_loop``: a few clock
reads a dispatch, in every run.  ``--trace 1`` adds the profiled slice
(``pb_trace``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
import types

import numpy as np
import torch

import pb_reference
import pb_roofline
import pb_trace
import pb_weights
from pb_traffic import Rounds, seed_bits

# the program's modules whose entry points the spans wrap
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import autotune, native, ops
from repro_torch.models import lm
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.scheduler import DecodeRun, Scheduler

JAX_MODULES = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


_IMPORTED = time.monotonic()


def port_config(cfg: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file."""
    m = dict(cfg["model"])
    mla = m.pop("mla", None)
    return ModelConfig(**m, mla=MLAConfig(**mla) if mla else None,
                       sparsity=SparsityConfig(**cfg["sparsity"]))


def serve_config(cfg: dict, mix: dict):
    e = mix["engine"]
    return engine_mod.ServeConfig(
        prefill_mode="continuous", pack_weights=True, wire_dtype=cfg["serve"]["wire_dtype"],
        kv_dtype=cfg["serve"]["kv_dtype"], max_seq=e["max_seq"], page_size=e["page_size"],
        max_batch=e["max_batch"], prefill_chunk=e["prefill_chunk"],
        decode_block=e["decode_block"], prefix_cache=e["prefix_cache"],
        paged_attn=e.get("paged_attn", "auto"))


def loaded_jax() -> list:
    """Top-level module names of JAX or the JAX package in this process."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(JAX_MODULES))


# ---------------------------------------------------------------- spans


class Recorder:
    """Dispatch records and host spans of the window.

    Each dispatch: its kind (``step`` or ``run``), rows computed (the
    plan's ``[max_batch, prefill_chunk]`` or ``max_batch x n_steps``),
    tokens fed, forward passes, tokens sampled, each real row's ``(first
    position, tokens)``, its start on the host clock, and the host
    seconds spent inside ``lm.paged_step``/``lm.paged_decode_loop``.
    Spans: ``(name, start, end, depth)``."""

    def __init__(self, device, slice_at=None):
        self.device = device
        self.dispatches = []
        self.spans = []
        self.depth = 0
        self.slice_at = slice_at  # (first dispatch, dispatches) or None
        self.slice = None
        self.slice_range = None
        self._saved = []

    @contextlib.contextmanager
    def span(self, name):
        self.depth += 1
        t0 = time.perf_counter()
        try:
            yield t0
        finally:
            self.depth -= 1
            if self.depth <= 1:
                self.spans.append((name, t0, time.perf_counter(), self.depth))

    def _slice_edge(self):
        if self.slice_at is None or not torch.cuda.is_available():
            return
        first, count = self.slice_at
        n = len(self.dispatches)
        if n == first and self.slice is None:
            self.slice = pb_trace.Slice()
            self.slice.start(self.device)
        elif n == first + count:
            self.close_slice()

    def close_slice(self):
        if self.slice is not None and self.slice.prof is not None:
            self.slice.stop(self.device)
            first = self.slice_at[0]
            self.slice_range = (first, len(self.dispatches))

    def _note_plan(self, plan, t0):
        if isinstance(plan, DecodeRun):
            n = plan.n_steps
            rows = [(int(p), n) for p in plan.positions if p >= 0]
            rec = dict(kind="run", computed=plan.positions.shape[0] * n, fed=n * len(rows),
                       passes=n, sampled=n * len(rows), rows=rows)
        else:
            b, c = plan.tokens.shape
            rows = [(int(plan.positions[r, 0]), int(k)) for r, k in enumerate(plan.n_new) if k > 0]
            rec = dict(kind="step", computed=b * c, fed=int(sum(plan.n_new)), passes=1,
                       sampled=int(plan.sample_mask.sum()), rows=rows)
        rec.update(t0=t0, host_s=0.0)
        self.dispatches.append(rec)

    def install(self):
        rec = self
        orig_plan, orig_commit, orig_commit_run = Scheduler.plan, Scheduler.commit, \
            Scheduler.commit_run
        orig_step, orig_loop = lm.paged_step, lm.paged_decode_loop

        def plan(sched):
            rec._slice_edge()
            with rec.span("plan") as t0:
                p = orig_plan(sched)
            if p is not None:
                rec._note_plan(p, t0)
            return p

        def commit(sched, *a, **k):
            with rec.span("commit"):
                return orig_commit(sched, *a, **k)

        def commit_run(sched, *a, **k):
            with rec.span("commit"):
                return orig_commit_run(sched, *a, **k)

        def timed(name, fn):
            def wrapper(*a, **k):
                outer = rec.depth == 1
                with rec.span(name) as t0:
                    out = fn(*a, **k)
                if outer and rec.dispatches:
                    rec.dispatches[-1]["host_s"] += time.perf_counter() - t0
                return out
            return wrapper

        self._saved = [(Scheduler, "plan", orig_plan), (Scheduler, "commit", orig_commit),
                       (Scheduler, "commit_run", orig_commit_run),
                       (lm, "paged_step", orig_step), (lm, "paged_decode_loop", orig_loop)]
        Scheduler.plan, Scheduler.commit, Scheduler.commit_run = plan, commit, commit_run
        lm.paged_step = timed("paged_step", orig_step)
        lm.paged_decode_loop = timed("paged_decode_loop", orig_loop)

    def uninstall(self):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        self._saved = []


# ---------------------------------------------------------------- the run


def build(cfg: dict, mix: dict, seed: int, device):
    """Set-up: the kernels built, the weights drawn, the engine built (it
    packs them), the two dispatch shapes of the cell warmed."""
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        native.build_all()
    log(f"kernels built or found at {process_age():.2f} s ({time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    params = pb_weights.draw(cfg["model"], seed, device)
    eng = engine_mod.Engine(params, port_config(cfg), serve_config(cfg, mix), device=device)
    del params
    gc.collect()
    log(f"weights drawn and engine built in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    # one mixed step and decode runs of decode_block steps, on a request
    # no round draws (its prompt is shorter than a page: nothing cached)
    n_out = mix["engine"]["decode_block"] + 2
    eng.serve_requests([np.arange(1, 3, dtype=np.int32)], [n_out])
    log(f"warm-up {time.perf_counter() - t:.2f} s")
    return eng


def kernel_guard(counters: dict, gather_calls: int, autotune_cache, cuda: bool) -> dict:
    """The window timed the kernels: no kernel took its plain version (on
    the card), no paged read was taken off kernel #6 by a cached
    ``"gather"`` verdict, and no autotune cache file was named (no cell
    sets one).  ``{check: (value, limit)}``."""
    checks = {}
    if cuda:
        checks["plain_calls"] = (sum(c.plain for c in counters.values()), 0)
    checks["gather_calls"] = (gather_calls, 0)
    checks["autotune_cache_env"] = (int(bool(autotune_cache)), 0)
    return checks


def sample_requests(reqs: list, served: int, seed: int) -> list:
    """The requests the comparison reads: the longest, then others drawn
    from the seed until ``served`` tokens are in."""
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i]["prompt"]) + reqs[i]["n_gen"])
    rng = np.random.default_rng(seed_bits(seed) ^ 0x5EED)
    picked, total = [longest], reqs[longest]["n_gen"]
    for i in rng.permutation(len(reqs)):
        if total >= served:
            break
        if int(i) != longest:
            picked.append(int(i))
            total += reqs[int(i)]["n_gen"]
    return [reqs[i] for i in picked]


def gap_stats(gaps: torch.Tensor, lengths: list) -> dict:
    """Numbers of the served tokens' gaps below the reference's best: the
    widest, the mean, the share (in %) of tokens more than 1 and 1.5
    below it, and the largest such share (1.5) of any one request, whose
    served tokens are the next ``lengths[i]`` gaps."""
    g = gaps.double()
    over = (g > 1.5).double()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "gap_over_1": 100.0 * float((g > 1.0).double().mean()),
            "gap_over_1.5": 100.0 * float(over.mean()),
            "worst_request_over_1.5": 100.0 * max(float(r.mean())
                                                  for r in over.split(lengths))}


def compared(readings: dict, limits: dict) -> dict:
    """``{name: (reading, limit)}`` of each number a cell's limits name."""
    return {name: (readings[name], lim) for name, lim in limits.items()}


def reference_gaps(cfg: dict, mix: dict, seed: int, device, sample: list, precisions=None,
                   controls=(), fault_one_request=False) -> dict:
    """The gap statistics (``gap_stats``) of the served tokens of
    ``sample`` below the reference's best; with ``controls`` (lists of
    precisions) also each control's, read at the tokens the control puts
    first, as ``control_<i>``; with ``fault_one_request`` also those of
    the served tokens with one request's answer altered (each token plus
    one; the shortest request of the sample, where the share over all
    tokens moves least), as ``fault_one_request``.  The dense weights are
    drawn again from the seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = pb_weights.draw(cfg["model"], seed, device)
    seqs, wanted, served = [], [], []
    for r in sample:
        full = np.concatenate([r["prompt"], r["out"][:-1]])
        p0 = len(r["prompt"])
        seqs.append(full)
        wanted.append(list(range(p0 - 1, p0 - 1 + len(r["out"]))))
        served.append(torch.as_tensor(r["out"], dtype=torch.long))
    page = mix["engine"]["page_size"]
    ref = pb_reference.Reference(cfg, params, **(precisions or pb_reference.stated(cfg)),
                                 page=page)
    logits = torch.cat(ref.logits(seqs, wanted))
    tokens = torch.cat(served).to(logits.device)
    lengths = [len(t) for t in served]
    out = gap_stats(pb_reference.served_gaps(logits, tokens), lengths)
    out["served"] = int(tokens.numel())
    out["requests"] = len(sample)
    if fault_one_request:
        short = min(range(len(lengths)), key=lambda i: lengths[i])
        a = sum(lengths[:short])
        bad = tokens.clone()
        bad[a:a + lengths[short]] = (bad[a:a + lengths[short]] + 1) % cfg["model"]["vocab"]
        out["fault_one_request"] = gap_stats(pb_reference.served_gaps(logits, bad), lengths)
    for i, prec in enumerate(controls):
        ctl = torch.cat(pb_reference.Reference(cfg, params, **prec, page=page).logits(seqs, wanted))
        out[f"control_{i}"] = gap_stats(pb_reference.served_gaps(logits, ctl.argmax(dim=-1)),
                                        lengths)
    del params, ref
    return out


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
             limits: dict, controls=(), fault_one_request=False) -> dict:
    """One run.  Returns ``{"data": RunData-like namespace, "checks":
    {name: (value, limit)}, "correct", "attempted", "failed", "device",
    "readings"}``; the caller computes the metrics from ``data``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    eng = build(cfg, mix, seed, device)
    rounds = Rounds(mix, cfg["model"]["vocab"], seed)
    slice_at = None
    if trace and cuda:
        pb_trace.Slice.warm(device)
        slice_at = (mix["trace"]["skip_dispatches"], mix["trace"]["dispatches"])
    rec = Recorder(device, slice_at)
    mem_setup = 0
    if cuda:
        torch.cuda.synchronize(dev)
        mem_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counters()
    gather0 = autotune.cuda_gather_calls()
    steps0 = eng.step_calls
    reqs = []
    rec.install()
    setup_s = process_age()
    t_open = time.perf_counter()
    try:
        while time.perf_counter() - t_open < seconds or not reqs:
            prompts, outs = rounds.next()
            stamps = {}

            def on_token(rid, tokens, start, stamps=stamps):
                now = time.perf_counter()
                first = stamps.get(rid, (now, now))[0]
                stamps[rid] = (first, now)

            n0, t_round = len(rec.dispatches), time.perf_counter()
            with rec.span("round"):
                results = eng.serve_requests(prompts, outs, on_token=on_token)
            runs = sum(d["kind"] == "run" for d in rec.dispatches[n0:])
            log(f"round {len(reqs) // len(prompts)}: {time.perf_counter() - t_round:.3f} s, "
                f"{len(rec.dispatches) - n0} dispatches ({runs} decode runs), "
                f"{sum(r.n_generated for r in results)} tokens")
            for prompt, n_req, r in zip(prompts, outs, results):
                first, last = stamps.get(r.rid, (0.0, 0.0))
                n = r.n_generated
                reqs.append(dict(
                    prompt=prompt, n_req=n_req, n_gen=n, out=r.tokens[len(prompt):],
                    ok=bool(r.ok and n == n_req),
                    ttft_s=r.time_to_first_token - r.queue_time,
                    tpot_s=(last - first) / (n - 1) if n >= 2 else None))
        if cuda:
            torch.cuda.synchronize(dev)
        t_close = time.perf_counter()
    finally:
        rec.close_slice()
        rec.uninstall()
    window_s = t_close - t_open
    starts = [d["t0"] for d in rec.dispatches] + [t_close]
    took = sorted(((b - a) * 1e3, i, d["kind"]) for i, (d, a, b) in
                  enumerate(zip(rec.dispatches, starts, starts[1:])))
    log("slowest dispatches (ms, index, kind): "
        + " ".join(f"{ms:.1f}/{i}/{k}" for ms, i, k in took[-8:][::-1])
        + f"; median {took[len(took) // 2][0]:.1f}" if took else "no dispatch")
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    checks = kernel_guard(ops.counters(), autotune.cuda_gather_calls() - gather0,
                          os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE"), cuda)
    step_calls = eng.step_calls - steps0
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    failed = sum(not r["ok"] for r in reqs)
    checks["unfinished"] = (failed, 0)
    sample = sample_requests([r for r in reqs if r["ok"]] or reqs, mix["check"]["served_tokens"],
                             seed)
    t = time.perf_counter()
    readings = reference_gaps(cfg, mix, seed, device, sample, controls=controls,
                              fault_one_request=fault_one_request)
    log("readings " + " ".join(f"{k} {v!r}" for k, v in readings.items()))
    log(f"reference over {len(sample)} requests, {readings['served']} served tokens: "
        f"{time.perf_counter() - t:.2f} s; setup peak {mem_setup} B, window peak {mem_peak} B")
    checks.update(compared(readings, limits))
    correct = all(v <= lim for v, lim in checks.values())
    data = types.SimpleNamespace(
        cfg=cfg, mix=mix, requests=reqs, window_s=window_s, setup_s=setup_s,
        gen_tokens=sum(r["n_gen"] for r in reqs), step_calls=step_calls,
        dispatches=rec.dispatches, spans=rec.spans, slice=rec.slice,
        slice_range=rec.slice_range, roofline=pb_roofline)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    return dict(data=data, checks=checks, correct=correct, attempted=len(reqs),
                failed=failed, device=device_info, readings=readings)


def breakdown(data) -> dict:
    """The traced slice's device operations that took most time and its
    idle time by what the host was doing."""
    sl = data.slice
    if sl is None or not sl.events:
        return {}
    spans = [s for s in data.spans if s[2] > sl.t0 and s[1] < sl.t1]
    return {"device_ops": pb_trace.top_ops(sl.events, sl.t0, sl.t1),
            "idle_gaps": pb_trace.idle_gaps(sl.events, sl.t0, sl.t1, spans)}
